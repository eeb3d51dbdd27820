"""Without a card the benchmark fails and prints no result; it never falls
back to the CPU. Without the program beside it, it fails too."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import core

ROOT = core.BENCH_DIR.parent
ARGS = ["--workload", "in_small.train", "--seed", "2147483901", "--seconds", "1", "--trace", "0"]


def run(root, env=None):
    return subprocess.run([sys.executable, str(root / "perfbench" / "run.py"), *ARGS],
                          capture_output=True, text=True, cwd=root, timeout=300,
                          env={**os.environ, **(env or {})})


def test_no_card_no_result():
    out = run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == "" and "CUDA" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copytree(core.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_run_on_the_card_prints_a_result():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct"' in out.stdout.strip().splitlines()[-1]
