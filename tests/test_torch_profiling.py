"""The port's profiling helpers (``schemanet_torch/utils/profiling.py``)
beside the JAX package's (``schemanet_tpu/utils/profiling.py``): the same
names exported from ``utils``, a trace written into a directory on the CPU,
``block_tree`` returning its input as it came, and ``StepTimer``'s rates
equal to the JAX timer's on the same clock."""

import json
import os

import numpy as np
import pytest
import torch

import schemanet_torch.utils as port_utils
from schemanet_torch.utils import profiling as port_profiling
from schemanet_tpu.utils import profiling as jax_profiling


def test_utils_export_the_jax_names():
    for name in ("trace", "block_tree", "StepTimer"):
        assert name in port_utils.__all__ and hasattr(jax_profiling, name)
    assert port_utils.trace is port_profiling.trace
    assert port_utils.block_tree is port_profiling.block_tree


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with port_utils.trace(str(log_dir)):
        x = torch.randn(32, 32, generator=torch.Generator().manual_seed(0))
        (x @ x).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::mm") for e in events)


def test_trace_writes_even_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="inside"):
        with port_utils.trace(str(tmp_path)):
            raise RuntimeError("inside")
    assert len(os.listdir(tmp_path)) == 1


@pytest.mark.parametrize("tree", [
    {"a": [torch.ones(3), (torch.zeros(2, 2), 7)], "b": None, "c": "text"},
    [torch.arange(4), [torch.ones(1), {"d": (np.ones(2), 1.5)}]],
    (),
    torch.ones(2),
])
def test_block_tree_returns_its_input_unchanged(tree):
    before = repr(tree)
    assert port_utils.block_tree(tree) is tree
    assert repr(tree) == before


def test_block_tree_synchronises_each_cuda_device_once(monkeypatch):
    """CUDA tensors (faked on the CPU) each bring one synchronize of their
    device; CPU tensors bring none."""
    calls = []

    class FakeCuda:
        is_cuda = True

        def __init__(self, index):
            self.device = torch.device("cuda", index)

    monkeypatch.setattr(port_profiling.torch, "is_tensor",
                        lambda x: isinstance(x, (torch.Tensor, FakeCuda)))
    monkeypatch.setattr(port_profiling.torch.cuda, "synchronize", calls.append)
    tree = {"x": [FakeCuda(0), FakeCuda(1), (FakeCuda(0), torch.ones(1))]}
    assert port_utils.block_tree(tree) is tree
    assert sorted(d.index for d in calls) == [0, 1]


def test_step_timer_matches_the_jax_timer(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.25).tolist())
    times = list(clock)

    def run(module):
        ticks = iter(times)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
        timer = module.StepTimer(window=3)
        return [timer.step(n) for n in (8, 8, 16, 8, 4, 4, 4)]

    port, ref = run(port_profiling), run(jax_profiling)
    assert port == ref and port[3] is not None
