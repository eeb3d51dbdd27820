"""A run with the timed path broken underneath reads ``correct`` false under
each cell's own limits: the harness's look for a chip skipped, the rest of
the run (set-up, window, comparison with the reference) driven on the CPU
at a tiny size in fp32 (where a sound run reads fp32 round-off, so only the
fault can fail it), once for each fault the cell can have:

* training: a step that leaves its state unchanged; half of the batch left
  out, the loss's mean taken over the rest; and two wrong updates, every
  learning rate doubled and the atlas rows left unprojected;
* serving: an answer altered where it is produced; each class's logit
  served from its neighbour's graph (the class graphs off by one);
* stage 3: half of each batch left out, the sums taken over the rest; an
  answer (the atlas) altered where it is produced.

No cell runs across chips, so none can drop an exchange between them."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from perfbench import check, core
from perfbench.tests.test_perfbench_reference import INIT, SERVE, TRAIN, run_cell
from perfbench.tests.tiny import tiny_config

ROOT = core.BENCH_DIR.parent
CELLS = {w["name"]: w for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}


def limits(cell: str) -> dict:
    return json.loads((core.BENCH_DIR / "limits" / f"{cell}.json").read_text())


def cells_of(entry: str):
    return [c for c in sorted(CELLS) if core.resolve(ROOT, c).entry == entry]


def unchanged_state(monkeypatch):
    from schemanet_torch.train.trainer import Trainer

    def apply_updates(self):
        self.step += 1
    monkeypatch.setattr(Trainer, "apply_updates", apply_updates)


def half_batch_step(monkeypatch):
    from schemanet_torch.train.trainer import Trainer

    real = Trainer.forward_loss

    def forward_loss(self, batch):
        half = batch["image"].shape[0] // 2
        return real(self, {k: v[:half] for k, v in batch.items()})
    monkeypatch.setattr(Trainer, "forward_loss", forward_loss)


def doubled_lr(monkeypatch):
    from perfbench import program

    real = program.trainer

    def trainer(cfg, *args, **kwargs):
        cfg = copy.deepcopy(cfg)
        cfg["training"]["optimizer"]["lr"] *= 2
        return real(cfg, *args, **kwargs)
    monkeypatch.setattr(program, "trainer", trainer)


def unprojected_rows(monkeypatch):
    from schemanet_torch.ops.kernels import atlas_opt as ao

    for name in ("adamw_project_rows", "adamw_project_rows_reference"):
        real = getattr(ao, name)

        def update(*args, _real=real, **kwargs):
            return _real(*args, **dict(kwargs, project=False))
        monkeypatch.setattr(ao, name, update)
    monkeypatch.setattr(ao, "project_rows_", lambda p, remove_self_loop=False: p)


@pytest.mark.parametrize("cell", cells_of("train"))
@pytest.mark.parametrize("fault", [unchanged_state, half_batch_step, doubled_lr,
                                   unprojected_rows])
def test_training_faults_fail(cell, fault, monkeypatch):
    fault(monkeypatch)
    numbers = run_cell("train", TRAIN, tiny_config("float32"))
    ok, rows = check.verdict({k: {"value": v} for k, v in numbers.items()}, limits(cell))
    assert not ok, rows


def altered_answer(monkeypatch):
    from schemanet_torch.serve import ServePredictor

    real = ServePredictor.predict_tensor

    def predict_tensor(self, images):
        out = real(self, images)
        spread = out.amax(dim=1) - out.amin(dim=1)
        return out.index_add(1, torch.tensor([0], device=out.device), 4 * spread[:, None])
    monkeypatch.setattr(ServePredictor, "predict_tensor", predict_tensor)


def classes_off_by_one(monkeypatch):
    from schemanet_torch.serve import ServePredictor

    real = ServePredictor.predict_tensor

    def predict_tensor(self, images):
        return real(self, images).roll(1, dims=1)
    monkeypatch.setattr(ServePredictor, "predict_tensor", predict_tensor)


@pytest.mark.parametrize("cell", cells_of("serve"))
@pytest.mark.parametrize("fault", [altered_answer, classes_off_by_one])
def test_serving_fault_fails(cell, fault, monkeypatch):
    fault(monkeypatch)
    numbers = run_cell("serve", SERVE, tiny_config("float32"))
    ok, rows = check.verdict({k: {"value": v} for k, v in numbers.items()}, limits(cell))
    assert not ok, rows


def half_batch_pass(monkeypatch):
    from schemanet_torch.pipeline import init_schema_net as isn

    real = isn._batch

    def _batch(loader, batch, device):
        image, labels, valid = real(loader, batch, device)
        half = len(labels) // 2
        return image[:half], labels[:half], valid[:half]
    monkeypatch.setattr(isn, "_batch", _batch)


def altered_atlas(monkeypatch):
    from schemanet_torch.pipeline import init_schema_net as isn
    from schemanet_torch.pipeline import stages

    real = isn.init_atlas

    def init_atlas(*args, **kwargs):
        out = real(*args, **kwargs)
        out["params"]["vertex_weights"] = out["params"]["vertex_weights"].roll(1, dims=1)
        return out
    monkeypatch.setattr(stages, "init_atlas", init_atlas)


@pytest.mark.parametrize("cell", cells_of("init"))
@pytest.mark.parametrize("fault", [half_batch_pass, altered_atlas])
def test_stage3_faults_fail(cell, fault, monkeypatch):
    fault(monkeypatch)
    # a pass long enough to take every batch of the pool, however busy the host
    numbers = run_cell("init", INIT, tiny_config("float32"), seconds=2.0)
    ok, rows = check.verdict({k: {"value": v} for k, v in numbers.items()}, limits(cell))
    assert not ok, rows


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_tiny_run_passes(cell):
    entry = core.resolve(ROOT, cell).entry
    traffic = {"train": TRAIN, "serve": SERVE, "init": INIT}[entry]
    numbers = run_cell(entry, traffic, tiny_config("float32"))
    ok, rows = check.verdict({k: {"value": v} for k, v in numbers.items()}, limits(cell))
    assert ok, rows
