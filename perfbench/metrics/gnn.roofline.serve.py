"""Share of its roofline of the matcher (the GNN over the microbatch's
instance graphs and the K class graphs, and the similarities) in serving:
the least time of a call (``work.gnn_flops``, ``work.gnn_bytes``) over the
device time of the kernels launched in the ``perfbench.gnn`` ranges. %."""

from perfbench import work

RANGE = ("gnn", "Matcher")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, calls = ctx.trace.layer_device_s("gnn"), ctx.trace.calls("gnn")
    if not seconds or not calls:
        return None
    cfg, batch = ctx.config, ctx.traffic["microbatch"]
    nbytes = work.gnn_bytes(cfg, batch, cfg["serve_dtype"])
    least = work.least_seconds(work.gnn_flops(cfg, batch), nbytes)
    return 100.0 * least * calls / seconds
