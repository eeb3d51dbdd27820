"""95th percentile of every request's latency in the window, in ms: the
host clock from the call to ``predict`` to its numpy logits."""

import numpy as np


def read(ctx):
    lat = ctx.window.get("latencies_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
