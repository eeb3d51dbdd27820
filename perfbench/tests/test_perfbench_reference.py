"""The plain reference against the port's CPU path (the kernels' plain
versions) at tiny widths, for each entry kind: the program's timed path and
the reference from the same seeded weights and inputs agree to fp32
round-off when the program too computes in fp32 (graphs at 'highest', fp32
moments)."""

from __future__ import annotations

import pytest
import torch

from perfbench import core
from perfbench.tests.tiny import Ctx, tiny_config

TRAIN = {"entry": "train", "batch": 4, "pool_batches": 4, "noise": 0.1, "check_steps": 3}
SERVE = {"entry": "serve", "request": 4, "microbatch": 4, "pool_requests": 3, "noise": 0.1,
         "sample_requests": 2}
INIT = {"entry": "init", "batch": 4, "pool_batches": 6, "noise": 0.1, "warm_batches": 2,
        "sample_classes": 3}
# fp32 round-off through three steps, a serving forward or two passes
TOL = {"loss": 1e-6, "grad_median_leaf": 1e-5, "grad_worst_leaf": 1e-4,
       "change_median_leaf": 1e-4, "change_worst_leaf": 1e-3, "change_rows_leaf": 1e-3,
       "logit": 1e-4, "top1_margin": 1e-4,
       "vertex": 1e-5, "ingredients": 0.0, "edge": 1e-5}


def entry(name: str):
    return core.load_file_module(core.BENCH_DIR / "entries" / f"{name}.py", f"test_entry_{name}")


def run_cell(name: str, traffic: dict, cfg: dict, seed: int = 7, seconds: float = 0.3) -> dict:
    mod = entry(name)
    ctx = Ctx(cfg, traffic, seed=seed, seconds=seconds)
    st = mod.setup(ctx)
    window = mod.window(st, ctx)
    assert window["attempted"] > 0 and window["failed"] == 0
    return {k: v["value"] for k, v in mod.compare(st, ctx).items()}


@pytest.mark.parametrize("name,traffic", [("train", TRAIN), ("serve", SERVE), ("init", INIT)])
def test_reference_agrees_with_the_port_in_fp32(name, traffic):
    torch.manual_seed(0)
    numbers = run_cell(name, traffic, tiny_config("float32"))
    for key, value in numbers.items():
        assert value <= TOL[key], (key, value)


def test_reference_sees_all_codes_when_v_is_m():
    """CIFAR's class graphs over the whole vocabulary (V_max null)."""
    numbers = run_cell("serve", SERVE, tiny_config("float32", v_max=None))
    assert numbers["logit"] <= TOL["logit"]
