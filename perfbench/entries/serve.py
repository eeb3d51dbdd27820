"""Serving: ``ServePredictor.predict`` in a closed loop of one client.

Set-up builds the predictor (the configuration's serving dtype, its graph
tensors at 'default') from the seeded weights and a pool of requests, each
``request`` host-resident float32 images, and serves two requests to warm up
the one microbatch shape. The window sends request after request, each
waiting for its numpy logits, until ``--seconds`` have passed; a request's
latency is the host clock from the call to its logits. After the window a
sample of the finished requests, drawn from the seed, is held against the
reference's logits.

The traffic file: ``request`` images a request (= ``microbatch``),
``pool_requests``, ``noise``, ``sample_requests`` compared.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from perfbench import check, program, weights, work
from perfbench.reference import model as ref
from perfbench.reference.precision import Precision

WARM_REQUESTS = 2


def _requests(cfg, seed, device, t):
    images, _ = weights.make_pool(cfg, seed, device, t["request"] * t["pool_requests"],
                                  t["noise"])
    return images.reshape(t["pool_requests"], t["request"], *images.shape[1:])


def setup(ctx):
    cfg, t = ctx.cell.config, ctx.cell.traffic
    srv = program.server(cfg, weights.make_weights(cfg, ctx.seed, ctx.device), ctx.device,
                         t["microbatch"])
    pool = [np.ascontiguousarray(r.cpu().numpy()) for r in _requests(cfg, ctx.seed, ctx.device, t)]
    for i in range(WARM_REQUESTS):
        srv.predict(pool[i])
    return {"server": srv, "pool": pool}


def window(st, ctx) -> dict:
    srv, pool = st["server"], st["pool"]
    served, latencies = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        i = len(served) % len(pool)
        s = time.perf_counter()
        logits = srv.predict(pool[i])
        latencies.append(time.perf_counter() - s)
        served.append((i, logits))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    seconds = time.perf_counter() - t0
    st["served"] = served
    n = len(served)
    return {"seconds": seconds, "requests": n, "images": n * ctx.cell.traffic["request"],
            "latencies_s": latencies, "attempted": n,
            "failed": sum(1 for _, lg in served if not np.isfinite(lg).all())}


def window_flops(ctx) -> float:
    """The window's operations: a microbatch's (``work.serve_flops``) a request."""
    return ctx.window["requests"] * work.serve_flops(ctx.config, ctx.traffic["microbatch"])


def sample(n_served: int, seed: int, count: int):
    """The finished requests compared: ``count`` of them, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(n_served), min(count, n_served)))


def compare(st, ctx) -> dict:
    cfg, t = ctx.cell.config, ctx.cell.traffic
    st.pop("server", None)
    st.pop("pool", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    chosen = [st["served"][j] for j in sample(len(st["served"]), ctx.seed, t["sample_requests"])]
    got = torch.from_numpy(np.concatenate([lg for _, lg in chosen])).to(ctx.device)
    want = reference_logits(cfg, ctx.seed, ctx.device, t, [i for i, _ in chosen],
                            ctx.reference_precision)
    return check.logit_gaps(got, want)


def reference_logits(cfg, seed, device, t, pool_ids, precision: str) -> torch.Tensor:
    """The reference's logits of the pool's requests ``pool_ids``, in order."""
    requests = _requests(cfg, seed, device, t)
    images = torch.cat([requests[i] for i in pool_ids])
    W = weights.make_weights(cfg, seed, device)
    return ref.serve_logits(W, cfg, images, Precision(precision))
