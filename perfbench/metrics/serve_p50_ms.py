"""Median request latency in the window, in ms (the steadier statistic
beside ``serve_p95_ms``). Host clock."""

import numpy as np


def read(ctx):
    lat = ctx.window.get("latencies_s")
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
