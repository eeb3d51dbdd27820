"""The lower-precision control: the plain reference put in the program's
place, computed in the precision below the configuration's (fp8 under a
bf16 configuration, TF32 under fp32), must come out not correct.

On the CPU, at a tiny size: the control moves each entry kind's compared
numbers far above what a sound fp32 run reads there. On the card (marked
``cuda``), at each cell's own size on three seeds: the control fails the
cell's limits, as ``perfbench/controls.py`` read it for PERF.md."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import check, controls, core
from perfbench.tests.test_perfbench_reference import INIT, SERVE, TRAIN, run_cell
from perfbench.tests.tiny import tiny_config

ROOT = core.BENCH_DIR.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = {"train": TRAIN, "serve": SERVE, "init": INIT}


def limits(cell: str) -> dict:
    return json.loads((core.BENCH_DIR / "limits" / f"{cell}.json").read_text())


def tiny_cell(cell: str, dtype: str):
    c = core.resolve(ROOT, cell)
    c.config, c.traffic = tiny_config(dtype), TINY[c.entry]
    return c


@pytest.mark.parametrize("cell", CELLS)
def test_control_moves_the_compared_numbers(cell):
    entry = core.resolve(ROOT, cell).entry
    dtype = "float32" if entry == "init" else "bfloat16"
    precision = "tf32" if entry == "init" else "fp8"
    sound = run_cell(entry, TINY[entry], tiny_config("float32"))
    got = controls.readings(tiny_cell(cell, dtype), 5, torch.device("cpu"), precision, None, 8)
    compared = limits(cell)
    assert any(not got[k]["value"] <= 10 * max(sound[k], 1e-7) for k in compared), (got, sound)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    c = core.resolve(ROOT, cell)
    precision = "tf32" if c.entry == "init" else "fp8"
    for seed in (3000000001, 3000000002, 3000000003):
        got = controls.readings(c, seed, torch.device("cuda"), precision, None, 280)
        ok, rows = check.verdict(got, limits(cell))
        assert not ok, rows
