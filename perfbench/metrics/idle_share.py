"""The device's idle share in the traced window (``idle_share.train``,
``.serve``, ``.pass``): one minus the union of the device operations'
intervals over the window's wall time. %."""


def read(ctx):
    share = ctx.trace.idle_share() if ctx.trace is not None else None
    return None if share is None else 100.0 * share
