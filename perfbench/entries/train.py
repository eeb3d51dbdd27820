"""Stage-4 training: ``Trainer.train_iter`` back to back on one trainer.

Set-up builds the trainer (as ``schema_net_trainer`` does) from the seeded
weights and drives it through its first three steps on the pool's first
three batches, which warm up every shape and give the comparison its
readings: each step's loss, each trainable leaf's first gradient (its
``.grad`` after step 1's backward, ``FirstGradients``) and its change over
the three steps. The window then issues steps from the same trainer,
cycling the pool, until ``--seconds`` have passed, and ends with a
synchronize.

The traffic file: ``batch`` images a step, ``pool_batches`` device-resident
batches, ``noise`` of the images around their prototypes
(``weights.make_pool``), ``check_steps`` steps compared.
"""

from __future__ import annotations

import gc
import time

import torch

from perfbench import check, program, weights, work
from perfbench.reference import model as ref
from perfbench.reference.precision import Precision


def pool(cfg, seed, device, t):
    """The traffic's device-resident batches."""
    images, labels = weights.make_pool(cfg, seed, device, t["batch"] * t["pool_batches"],
                                       t["noise"])
    return [{"image": images[i * t["batch"]:(i + 1) * t["batch"]],
             "label": labels[i * t["batch"]:(i + 1) * t["batch"]]}
            for i in range(t["pool_batches"])]


class FirstGradients:
    """The norm of each trainable leaf's gradient as backward leaves it in
    ``.grad`` (the tensor the optimizer reads), taken by a hook on the leaf
    during the first step only: no reading of the optimizer's state, whose
    layout is the program's own."""

    def __init__(self, params: dict):
        self.norms = {}
        self.handles = [p.register_post_accumulate_grad_hook(self._hook(n))
                        for n, p in params.items()]

    def _hook(self, name):
        def hook(p):
            self.norms[name] = p.grad.detach().double().norm()
        return hook

    def remove(self) -> dict:
        for h in self.handles:
            h.remove()
        return self.norms


def setup(ctx):
    cfg, steps = ctx.cell.config, ctx.cell.traffic["check_steps"]
    batches = pool(cfg, ctx.seed, ctx.device, ctx.cell.traffic)
    tr = program.trainer(cfg, weights.make_weights(cfg, ctx.seed, ctx.device), ctx.device,
                         ctx.seed)
    names = [n for n, p in tr.model.named_parameters() if p.requires_grad]
    params = dict(tr.model.named_parameters())
    start = {n: params[n].detach().clone() for n in names}
    losses = []
    first = FirstGradients({n: params[n] for n in names})
    for i in range(steps):
        losses.append(tr.train_iter(dict(batches[i]))["loss"])
        if i == 0:  # a leaf that got no gradient reads 0
            got = first.remove()
            grad_norm = {n: got.get(n, 0.0) for n in names}
    change = {n: (params[n].detach().double() - start[n].double()).norm() for n in names}
    del start
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    readings = {"loss": [float(x) for x in losses],
                "grad_norm": {n: float(v) for n, v in grad_norm.items()},
                "change_norm": {n: float(v) for n, v in change.items()}}
    return {"trainer": tr, "pool": batches, "readings": readings, "names": names}


def window(st, ctx) -> dict:
    tr, batches = st["trainer"], st["pool"]
    steps0 = ctx.cell.traffic["check_steps"]
    sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda *a: None)
    sync(ctx.device)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < ctx.seconds:
        tr.train_iter(dict(batches[(steps0 + n) % len(batches)]))
        n += 1
    sync(ctx.device)
    seconds = time.perf_counter() - t0
    batch = ctx.cell.traffic["batch"]
    return {"seconds": seconds, "steps": n, "images": n * batch, "attempted": n, "failed": 0}


def window_flops(ctx) -> float:
    """The window's operations: its steps' (``work.train_step_flops``)."""
    return ctx.window["steps"] * work.train_step_flops(ctx.config, ctx.traffic["batch"])


def release(st) -> None:
    st.pop("trainer", None)
    st.pop("pool", None)


def reference_readings(cfg, seed, device, traffic, names, precision: str) -> dict:
    """The reference's readings of the first steps, from the same seed."""
    batches = pool(cfg, seed, device, traffic)[:traffic["check_steps"]]
    W = weights.make_weights(cfg, seed, device)
    return ref.train_steps(W, cfg, batches, Precision(precision), names)


def compare(st, ctx) -> dict:
    """The numbers compared, each against the cell's limit: the program's
    readings against the fp32 reference's."""
    release(st)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = ctx.cell.config
    want = reference_readings(cfg, ctx.seed, ctx.device, ctx.cell.traffic, st["names"],
                              ctx.reference_precision)
    return check.training_readings(st["readings"], want, ref.projected_rows(cfg))
