"""The port's epoch loop (``Trainer.__call__``: loaders, validation,
checkpoints, resume) and its workers, on the CPU.

* Against the JAX ``Trainer.__call__``: the same carried-across weights
  (the JAX init through ``from_jax_params``), each trainer on its own
  package's loaders over the same synthetic dataset (16^2 images at the
  model's size; ``tests/test_torch_data.py`` holds the loaders' order and
  images to the JAX ones), 2 epochs x 3 steps of batch 4, validation at the
  start, at iter 4 (mid-run, in epoch 1) and at the end, on 6 images (the
  last batch padded, 2 valid of 4). fp32, ``graph_precision`` 'highest'.
  Both models: stage 4's SchemaNet predictor (the CIFAR-100 config's
  optimizer groups, schedule and schema loss) and stage 0's ViT (the
  vanilla config's clipping and warm-up, no dropout: the two packages draw
  dropout masks from other generators). Per-step losses and validation
  losses within 1e-4 relative, as ``tests/test_torch_train.py`` holds the
  step; top-1/top-5 counts equal.
* Resume: a run stopped after epoch 1 (``request_stop``, what SIGTERM
  does) and resumed with ``resume="auto"`` gives the uninterrupted run's
  parameters, AdamW moments, generators and final validation bit for bit;
  stage 0 with dropout live, so the generators' states matter.
* The three workers from a YAML dict: ``backbone_worker`` and
  ``schema_net_worker`` train, validate and write checkpoints and
  ``meta.json`` with the JAX keys; ``eval_worker`` on their last checkpoint
  gives the final validation (counts equal, loss within 1e-6 relative).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.data import build_loaders
from schemanet_torch.models.port import from_jax_params
from schemanet_torch.models.vit import get_model as torch_get_model
from schemanet_torch.pipeline import save_atlas_init, save_bundle
from schemanet_torch.schema import build_predictor as torch_build_predictor
from schemanet_torch.schema import get_loss_fn as torch_get_loss_fn
from schemanet_torch.schema import init_parameters_
from schemanet_torch.schema.atlas import trunc_normal_unit
from schemanet_torch.train import (SCHEMA_NET_FROZEN, LaunchArgs, Trainer, TrainerConfig,
                                   backbone_worker, eval_worker, schema_net_worker)
from schemanet_tpu.data.loader import build_loaders as jax_build_loaders
from schemanet_tpu.models.vit import get_model as jax_get_model
from schemanet_tpu.ops import geometry as jax_geometry
from schemanet_tpu.parallel.mesh import make_mesh
from schemanet_tpu.schema import build_predictor as jax_build_predictor
from schemanet_tpu.schema.atlas import project_atlas_params as jax_project_atlas_params
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn
from schemanet_tpu.train.trainer import Trainer as JaxTrainer
from schemanet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from schemanet_tpu.utils.config import get_cfg

MODEL_CFG = {
    "name": "vit",
    "transformer": dict(embed_dim=32, num_encoder_layers=2, num_heads=2, dim_feedforward=64,
                        dropout=None, activation="gelu", final_norm=True, norm_eps=1e-6),
    "patch_embed": dict(img_size=16, patch_size=4, image_channels=3),
    "pos_encoding": dict(name="learnable"),
}
SCHEMA_CFG = {
    "matcher": {"similarity": "inner_product"},
    "gnn": {"embed_dim": 16, "num_layers": 2, "activation": "relu"},
    "ir_atlas": dict(class_max_vertices=None, dist_pow=2, feat_h=4, feat_w=4,
                     clamp_vertex_attn=-1.0, clamp_edge_attn=-1.0, remove_self_loop=False,
                     prune_node_threshold=0.001, graph_precision="highest"),
}
K, M, D, ENCODE_LAYER, BATCH = 5, 16, 32, 0, 4
DATA_CFG = {"name": "synthetic", "num_classes": K, "image_size": 16, "resize": 16,
            "train": {"num_samples": 12}, "val": {"num_samples": 6}}
LOOP = {"train_epochs": 2, "batch_size": BATCH, "val_interval": 4, "print_interval": 2,
        "num_workers": 2}
VAL_CFG = {"batch_size": BATCH, "num_workers": 2}
STAGE4 = get_cfg("configs/cifar_100/schema_net/deit_tiny-l9-M_1024.yaml")
STAGE0 = get_cfg("configs/cifar_100/vanilla/deit_tiny.yaml")
# the ImageNet stage-4 training block: bf16 Adam moments on the schema_net group
STAGE4_IMAGENET = get_cfg("configs/imagenet/schema_net/deit_small-l9-M_8000.yaml")


class _Recorder:
    """Wraps a trainer's ``train_iter`` and ``validate`` to keep each
    step's loss and each validation."""

    def __init__(self, trainer):
        self.losses, self.vals = [], []
        step, validate = trainer.train_iter, trainer.validate

        def train_iter(batch):
            out = step(batch)
            self.losses.append(float(out["loss"]))
            return out

        def recorded_validate():
            out = validate()
            self.vals.append(out)
            return out

        trainer.train_iter, trainer.validate = train_iter, recorded_validate


def _jax_trainer(kind, train_cfg, loss_cfg):
    loaders = jax_build_loaders(DATA_CFG, train_cfg, VAL_CFG, seed=0)
    mesh = make_mesh(devices=jax.devices()[:1])
    if kind.startswith("schema_net"):
        jax_geometry.pairwise_point_sim(4, 4, 1.0, 2.0)
        predictor = jax_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
        variables = jax.jit(lambda key, x: predictor.init(key, x, method="init_full"))(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
        params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
        buffers = jax.tree_util.tree_map(np.asarray, dict(variables["buffers"]))
        atlas_cfg = predictor.cfg.atlas
        trainer = JaxTrainer(
            cfg=JaxTrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN),
            apply_fn=lambda p, b, image, rng, train: predictor.apply(
                {"params": p, "buffers": b}, image),
            loss_fn=jax_get_loss_fn(loss_cfg), loss_weights=loss_cfg["weight_dict"],
            params=jax.tree_util.tree_map(jnp.asarray, params), buffers=buffers,
            train_loader=loaders[0], val_loader=loaders[1], mesh=mesh,
            project_params=lambda p: dict(p, schema_net=jax_project_atlas_params(
                p["schema_net"], atlas_cfg)), seed=0)
        return trainer, params, buffers
    model = jax_get_model(MODEL_CFG, K)
    params = jax.tree_util.tree_map(np.asarray, dict(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]))
    trainer = JaxTrainer(
        cfg=JaxTrainerConfig.from_cfg(train_cfg),
        apply_fn=lambda p, b, image, rng, train: model.apply({"params": p}, image,
                                                             deterministic=True),
        loss_fn=jax_get_loss_fn(loss_cfg), loss_weights=loss_cfg["weight_dict"],
        params=jax.tree_util.tree_map(jnp.asarray, params), buffers={},
        train_loader=loaders[0], val_loader=loaders[1], mesh=mesh, seed=0)
    return trainer, params, {}


def _port_model(kind, params, buffers, dropout=None):
    if kind.startswith("schema_net"):
        model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    else:
        cfg = dict(MODEL_CFG, transformer=dict(MODEL_CFG["transformer"], dropout=dropout))
        model = torch_get_model(cfg, K)
    model.load_state_dict(from_jax_params(params, buffers, model))
    return model


def _configs(kind):
    base = {"schema_net": STAGE4, "schema_net_bf16_moments": STAGE4_IMAGENET}.get(kind, STAGE0)
    frozen = SCHEMA_NET_FROZEN if kind.startswith("schema_net") else ()
    return dict(base["training"], **LOOP), base["loss"], frozen


def _port_trainer(kind, params, buffers, dropout=None, **kw):
    train_cfg, loss_cfg, frozen = _configs(kind)
    train_loader, val_loader, _ = build_loaders(DATA_CFG, train_cfg, VAL_CFG, seed=0)
    return Trainer(TrainerConfig.from_cfg(train_cfg, frozen_patterns=frozen),
                   _port_model(kind, params, buffers, dropout), torch_get_loss_fn(loss_cfg),
                   loss_cfg["weight_dict"], seed=0, device="cpu", train_loader=train_loader,
                   val_loader=val_loader, **kw)


@pytest.fixture(scope="module", params=["schema_net", "backbone"])
def loops(request):
    kind = request.param
    train_cfg, loss_cfg, _ = _configs(kind)
    jax_trainer, params, buffers = _jax_trainer(kind, train_cfg, loss_cfg)
    want = _Recorder(jax_trainer)
    want.final = jax_trainer()
    trainer = _port_trainer(kind, params, buffers)
    got = _Recorder(trainer)
    got.final = trainer()
    return kind, got, want, trainer


def test_loop_losses_match_jax(loops):
    kind, got, want, trainer = loops
    assert len(got.losses) == len(want.losses) == 6 and trainer.step == 6
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert len(set(got.losses)) == 6


def test_loop_validations_match_jax(loops):
    """Initial, mid-run (iter 4) and final validations: loss within 1e-4
    relative, top-1/top-5 counts over the 6 valid images equal."""
    kind, got, want, trainer = loops
    assert len(got.vals) == len(want.vals) == 3
    for g, w in zip(got.vals, want.vals):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        for k in (1, 5):
            assert round(g["acc"][k] * 6) == round(w["acc"][k] * 6)
        for term, v in w["loss_dict"].items():
            np.testing.assert_allclose(g["loss_dict"][term], v, rtol=1e-4, err_msg=term)
    assert got.final == got.vals[-1]


def _state_leaves(trainer):
    state = trainer.state_dict()
    leaves = {f"model/{k}": v for k, v in state["model"].items()}
    for pid, slot in state["optimizer"]["state"].items():
        leaves.update({f"opt/{pid}/{k}": v for k, v in slot.items()})
    for name, hot in state["hot"].items():
        leaves.update({f"hot/{name}/m": hot["m"], f"hot/{name}/v": hot["v"]})
    for gi, group in enumerate(state["optimizer"].get("lowmem", ())):
        for pi, slot in enumerate(group):
            leaves.update({f"lowmem/{gi}/{pi}/{k}": v for k, v in slot.items()})
    leaves.update({f"rng/{k}": v for k, v in state["rng"].items()})
    return leaves


@pytest.mark.parametrize("kind", ["schema_net", "backbone", "schema_net_bf16_moments"])
def test_resume_is_bitwise(kind, tmp_path):
    """A run stopped after epoch 1 and resumed ("auto") ends with the bits of
    the uninterrupted one: parameters, every moment in its dtype (the
    ImageNet training block's bf16 moments of the atlas, fused and plain
    alike), generators and the final validation."""
    _, params, buffers = _jax_trainer(kind, *_configs(kind)[:2])
    dropout = None if kind.startswith("schema_net") else 0.1
    full = _port_trainer(kind, params, buffers, dropout, ckpt_dir=str(tmp_path / "full"))
    final = full()

    first = _port_trainer(kind, params, buffers, dropout, ckpt_dir=str(tmp_path / "cut"))
    step = first.train_iter

    def stop_after_epoch_1(batch):
        out = step(batch)
        if first.step == first.steps_per_epoch:
            first.request_stop()
        return out

    first.train_iter = stop_after_epoch_1
    assert first() is None and first.step == 3
    meta = json.loads((tmp_path / "cut" / "meta.json").read_text())
    assert meta["epoch"] == 0 and meta["last_tag"] == "iter-3"
    resumed = _port_trainer(kind, params, buffers, dropout, ckpt_dir=str(tmp_path / "cut"),
                            resume="auto")
    assert resumed.start_epoch == 1 and resumed.step == 3
    assert resumed() == final
    want, got = _state_leaves(full), _state_leaves(resumed)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if torch.is_tensor(value):
            assert got[name].dtype == value.dtype and torch.equal(got[name], value), name
        else:
            assert got[name] == value, name
    if kind == "schema_net_bf16_moments":
        saved = resumed.ckpt.restore("iter-3")
        assert all(t.dtype == torch.bfloat16 for hot in saved["hot"].values() for t in hot.values())
        assert len(saved["optimizer"]["lowmem"][0]) == 2  # the two attribute weights
        assert all(t.dtype == torch.bfloat16 for slot in saved["optimizer"]["lowmem"][0]
                   for t in slot.values())


@pytest.fixture(scope="module")
def worker_files(tmp_path_factory):
    """A stage-1 bundle (a seeded 2-layer ViT and codebook) and a stage-3
    atlas init (seeded random weights and class ingredients)."""
    root = tmp_path_factory.mktemp("workers")
    backbone = torch_get_model(MODEL_CFG, K)
    init_parameters_(backbone, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    save_bundle(str(root / "bundle"), MODEL_CFG, ENCODE_LAYER, backbone.state_dict(),
                torch.rand(M, D, generator=g) * 2 - 1)
    save_atlas_init(str(root / "atlas_init.pt"), {
        "vertex_weights": trunc_normal_unit((K, M), g),
        "edge_weights": trunc_normal_unit((K, M, M), g),
        "vertex_attribute_weights": torch.full((2, 1), 0.5),
        "edge_attribute_weights": torch.full((2, 1), 0.5),
    }, torch.stack([torch.randperm(M, generator=g) for _ in range(K)]).int())
    return root


def _worker_cfg(kind, root):
    train_cfg, loss_cfg, _ = _configs(kind)
    cfg = {"dataset": dict(DATA_CFG, image_size=8), "training": train_cfg, "validation": VAL_CFG,
           "loss": loss_cfg}
    if kind == "schema_net":
        cfg["schema_net"] = dict(SCHEMA_CFG, bundle=str(root / "bundle"),
                                 initial_state_fp=str(root / "atlas_init.pt"))
    else:
        cfg["model"] = dict(MODEL_CFG, transformer=dict(MODEL_CFG["transformer"], dropout=0.1))
    return cfg


@pytest.mark.parametrize("kind", ["schema_net", "backbone"])
def test_worker_trains_saves_and_evaluates(kind, worker_files):
    """8^2 synthetic images resized to 16^2 on the way in; the worker writes
    meta.json with the JAX keys and iter-/best checkpoints, and eval_worker
    on the last checkpoint gives the final validation."""
    cfg = _worker_cfg(kind, worker_files)
    log_dir = worker_files / kind
    worker = schema_net_worker if kind == "schema_net" else backbone_worker
    out = worker(cfg, LaunchArgs(seed=0, log_dir=str(log_dir), device="cpu"))
    assert out["trainer"].step == 6 and np.isfinite(out["eval"]["loss"])
    assert all(0.0 <= v <= 1.0 for v in out["eval"]["acc"].values())
    meta = json.loads((log_dir / "ckpt" / "meta.json").read_text())
    assert sorted(meta) == ["best_acc", "best_iter", "epoch", "eval", "iter", "last_tag"]
    assert meta["iter"] == 6 and meta["epoch"] == 1 and meta["last_tag"] == "iter-6"
    assert {"best.pt", "iter-6.pt"} <= set(os.listdir(log_dir / "ckpt"))
    last = str(log_dir / "ckpt" / f"{meta['last_tag']}.pt")
    if kind == "backbone":  # eval_worker builds a plain model in the validation dtype
        cfg["validation"] = dict(VAL_CFG, dtype=cfg["training"]["dtype"])
    got = eval_worker(cfg, LaunchArgs(seed=0, resume=last, device="cpu"))
    want = out["eval"]
    assert {k: round(v * 6) for k, v in got["acc"].items()} == \
        {k: round(v * 6) for k, v in want["acc"].items()}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    if kind == "schema_net":
        assert sorted(got["cb"]) == ["acc", "acc_model", "acc_origin"]
        assert all(0.0 <= v <= 1.0 for v in got["cb"].values())


def test_workers_and_evaluators_default_to_cuda(worker_files, monkeypatch):
    """Without a GPU the workers and evaluation loops raise unless the
    caller asks for the CPU, as every entry point of the port."""
    from schemanet_torch.train import CBEvaluation, Evaluation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _worker_cfg("backbone", worker_files)
    for worker in (backbone_worker, eval_worker):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            worker(cfg, LaunchArgs(seed=0, log_dir=str(worker_files / "nogpu")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluation(lambda image: image, lambda out, target: {}, {}, [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CBEvaluation(lambda image, quantize: image, [])
