"""Stage 3: the atlas initialisation (``init_atlas`` as ``init_stage``
builds it: the fp32 frozen ViT with its head-mean probe, VQ over the
codebook, full-vocabulary vertex weights, the top-``V_max`` sort, the
class-limited edges, the per-class sums).

The loader cycles a seeded pool of device-resident batches: its first pass
ends once half of ``--seconds`` has passed, and its second pass replays the
first pass's batches, as both passes read one dataset. The window is the
whole ``init_stage`` call, ending with a synchronize. After it, the atlas
rows of a sample of classes, drawn from the seed, are held against the
reference's rows from the same images.

The traffic file: ``batch``, ``pool_batches``, ``noise``, ``warm_batches``
(each pass of the set-up call), ``sample_classes``.
"""

from __future__ import annotations

import time

import torch

from perfbench import check, program, weights, work
from perfbench.reference import model as ref
from perfbench.reference.precision import Precision



class PassLoader:
    """Batches of a pool: pass 1 until its deadline (at least one batch),
    pass 2 the same batches again; ``set_epoch(1)`` starts pass 2."""

    def __init__(self, pool, deadline_s=None, count=None):
        self.pool, self.deadline_s, self.count = pool, deadline_s, count
        self.epoch, self.taken = 0, []

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        if self.epoch:
            for i in list(self.taken):
                yield self.pool[i % len(self.pool)]
            return
        t0 = time.perf_counter()
        while not self.taken or self._more(t0):
            self.taken.append(len(self.taken))
            yield self.pool[(len(self.taken) - 1) % len(self.pool)]

    def _more(self, t0) -> bool:
        if self.count is not None:
            return len(self.taken) < self.count
        return time.perf_counter() - t0 < self.deadline_s


def pool(cfg, seed, device, t):
    """The traffic's device-resident batches."""
    images, labels = weights.make_pool(cfg, seed, device, t["batch"] * t["pool_batches"],
                                       t["noise"])
    return [{"image": images[i * t["batch"]:(i + 1) * t["batch"]],
             "label": labels[i * t["batch"]:(i + 1) * t["batch"]]}
            for i in range(t["pool_batches"])]


def setup(ctx):
    cfg, t = ctx.cell.config, ctx.cell.traffic
    bundle = program.bundle(cfg, weights.make_weights(cfg, ctx.seed, ctx.device))
    batches = pool(cfg, ctx.seed, ctx.device, t)
    program.init_stage(cfg, bundle, PassLoader(batches, count=t["warm_batches"]), ctx.seed,
                       ctx.device)
    return {"bundle": bundle, "pool": batches}


def window(st, ctx) -> dict:
    loader = PassLoader(st["pool"], deadline_s=ctx.seconds / 2)
    sync = (lambda: torch.cuda.synchronize(ctx.device)) if ctx.device.type == "cuda" else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    atlas = program.init_stage(ctx.cell.config, st["bundle"], loader, ctx.seed, ctx.device)
    sync()
    seconds = time.perf_counter() - t0
    st["atlas"], st["taken"] = atlas, loader.taken
    batches = len(loader.taken)
    images = 2 * batches * ctx.cell.traffic["batch"]
    return {"seconds": seconds, "images": images, "batches_a_pass": batches,
            "attempted": 2 * batches, "failed": 0}


def window_flops(ctx) -> float:
    """The window's operations: both passes' images (``work.pass_flops``)."""
    return work.pass_flops(ctx.config, ctx.window["images"])


def sample_classes(cfg: dict, seed: int, count: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(int(seed) % 2**63)
    return torch.randperm(cfg["num_classes"], generator=g)[:count].sort().values.to(device)


def compare(st, ctx) -> dict:
    cfg, t = ctx.cell.config, ctx.cell.traffic
    classes = sample_classes(cfg, ctx.seed, t["sample_classes"], ctx.device)
    atlas = st.pop("atlas")
    got = {"vertex_weights": atlas["params"]["vertex_weights"][classes].clone(),
           "edge_weights": atlas["params"]["edge_weights"][classes].clone(),
           "class_ingredients": atlas["class_ingredients"][classes].clone()}
    del atlas
    st.pop("bundle", None)
    st.pop("pool", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_atlas(cfg, ctx.seed, ctx.device, t, st["taken"], classes,
                           ctx.reference_precision)
    return check.atlas_gaps(got, want)


def reference_atlas(cfg, seed, device, t, taken, classes, precision: str) -> dict:
    """The reference's atlas rows of ``classes`` over the batches the
    passes took (pool indices, with repeats)."""
    batches_ = pool(cfg, seed, device, t)
    batches = [batches_[i % len(batches_)] for i in taken]
    W = weights.make_weights(cfg, seed, device)
    return ref.init_classes(W, cfg, [batches, batches], classes, Precision(precision))
