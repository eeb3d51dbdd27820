"""The whole call's share of the card's bf16 peak (``mfu.train``,
``mfu.serve``, ``mfu.pass``): the operations of the window's work, as its
entry counts them (``window_flops``, from ``work.py``), over the window's
seconds and 989 TFLOP/s. %."""

from perfbench import work


def read(ctx):
    return 100.0 * ctx.entry.window_flops(ctx) / ctx.window["seconds"] / work.PEAK_FLOPS
