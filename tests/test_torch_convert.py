"""``tools/convert_checkpoints.py``: the JAX package's files into the port's
and back, on the CPU.

* A JAX bundle and a JAX checkpoint of a SchemaNet predictor, converted,
  serve through the port's ``load_serve_predictor`` the logits the JAX
  ``load_serve_predictor`` serves from the originals, fp32 within 1e-5 of
  their max; converted back, the bundle holds the original arrays bit for bit
  and serves the same logits in JAX.
* The atlas init converts both ways bit for bit.
* A JAX training checkpoint after 1 step (the CIFAR-100 config's AdamW
  groups, fp32), converted into the port's trainer: the port's next step
  equals JAX's (loss rtol 1e-4; the parameters by
  ``tests/test_torch_train.py``'s rule: rtol 1e-4 / atol 1e-6 where the
  step's gradient exceeds 1e-3 of its max, within 2 lr elsewhere), its
  step count JAX's.
* An optimizer state the tool does not convert (SGD's, or the port's on the
  way to JAX) raises; with ``--drop-optimizer`` the parameters, buffers and
  step convert alone, bit for bit.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models.port import from_jax_params, to_jax_params
from schemanet_torch.pipeline import bundle as torch_bundle
from schemanet_torch.schema import build_predictor as torch_build_predictor
from schemanet_torch.schema import get_loss_fn as torch_get_loss_fn
from schemanet_torch.serve import load_serve_predictor as torch_load_serve_predictor
from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig
from schemanet_tpu.ops import geometry as jax_geometry
from schemanet_tpu.parallel.mesh import make_mesh
from schemanet_tpu.pipeline import bundle as jax_bundle
from schemanet_tpu.schema import build_predictor as jax_build_predictor
from schemanet_tpu.schema.atlas import project_atlas_params as jax_project_atlas_params
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn
from schemanet_tpu.serve import load_serve_predictor as jax_load_serve_predictor
from schemanet_tpu.train.common import CheckpointManager as JaxCheckpointManager
from schemanet_tpu.train.trainer import Trainer as JaxTrainer
from schemanet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tests.test_torch_train import (BATCH, CIFAR, D, ENCODE_LAYER, MODEL_CFG, SCHEMA_CFG, K, M,
                                    _leaves, _Steps)

_spec = importlib.util.spec_from_file_location(
    "convert_checkpoints",
    pathlib.Path(__file__).resolve().parents[1] / "tools" / "convert_checkpoints.py")
conv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(conv)


@pytest.fixture(scope="module")
def jax_state():
    jax_geometry.pairwise_point_sim(4, 4, 1.0, 2.0)
    predictor = jax_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    variables = jax.jit(lambda key, x: predictor.init(key, x, method="init_full"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    buffers = jax.tree_util.tree_map(np.asarray, dict(variables["buffers"]))
    return predictor, params, buffers


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_bundle_and_checkpoint_serve_jax_logits(jax_state, tmp_path):
    _, params, buffers = jax_state
    jb, tb, jb2 = tmp_path / "jax_bundle", tmp_path / "torch_bundle", tmp_path / "jax_bundle2"
    jax_bundle.save_bundle(str(jb), MODEL_CFG, ENCODE_LAYER, params["backbone"],
                           params["ingredient_backbone"]["vocabulary"], {"note": 1})
    JaxCheckpointManager(str(tmp_path / "jax_ckpt")).save(
        "iter-0", {"params": params, "buffers": buffers, "step": np.int32(0)})
    jax_ckpt = str(tmp_path / "jax_ckpt" / "iter-0")
    images = np.random.default_rng(1).normal(size=(5, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jax_load_serve_predictor(str(jb), SCHEMA_CFG, jax_ckpt, K).predict(images))

    conv.main(["bundle", "--to", "torch", str(jb), str(tb)])
    conv.main(["orbax", "--to", "torch", jax_ckpt, str(tmp_path / "iter-0.pt")])
    port = torch_bundle.load_bundle(str(tb))
    assert port.encode_layer == ENCODE_LAYER and port.extra == {"note": 1}
    got = torch_load_serve_predictor(str(tb), SCHEMA_CFG, str(tmp_path / "iter-0.pt"), K,
                                     device="cpu").predict(images)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    conv.main(["bundle", "--to", "jax", str(tb), str(jb2)])
    back = jax_bundle.load_bundle(str(jb2))
    orig = jax_bundle.load_bundle(str(jb))
    flat_back, flat_orig = _flat(back.backbone_params), _flat(orig.backbone_params)
    assert sorted(flat_back) == sorted(flat_orig)
    for k, v in flat_orig.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=k)
    np.testing.assert_array_equal(np.asarray(back.codebook), np.asarray(orig.codebook))
    again = np.asarray(jax_load_serve_predictor(str(jb2), SCHEMA_CFG, jax_ckpt, K).predict(images))
    np.testing.assert_array_equal(again, want)


def test_atlas_init_both_ways(jax_state, tmp_path):
    _, params, buffers = jax_state
    atlas = params["schema_net"]
    ingredients = buffers["schema_net"]["class_ingredients"]
    jax_bundle.save_atlas_init(str(tmp_path / "a.msgpack"), atlas, ingredients)
    conv.main(["atlas", "--to", "torch", str(tmp_path / "a.msgpack"), str(tmp_path / "a.pt")])
    port = torch_bundle.load_atlas_init(str(tmp_path / "a.pt"))
    assert sorted(port["params"]) == sorted(atlas)
    for k, v in atlas.items():
        np.testing.assert_array_equal(port["params"][k].numpy(), v, err_msg=k)
    assert port["class_ingredients"].dtype == torch.int32
    np.testing.assert_array_equal(port["class_ingredients"].numpy(), ingredients)
    conv.main(["atlas", "--to", "jax", str(tmp_path / "a.pt"), str(tmp_path / "b.msgpack")])
    back = jax_bundle.load_atlas_init(str(tmp_path / "b.msgpack"))
    for k, v in atlas.items():
        np.testing.assert_array_equal(back["params"][k], v, err_msg=k)
    np.testing.assert_array_equal(back["class_ingredients"], ingredients)


def _jax_trainer(predictor, params, buffers, train_cfg, ckpt_dir):
    atlas_cfg = predictor.cfg.atlas

    def project(p):
        return dict(p, schema_net=jax_project_atlas_params(p["schema_net"], atlas_cfg))

    def apply_fn(p, b, image, rng, train):
        return predictor.apply({"params": p, "buffers": b}, image)

    loss_cfg = CIFAR["loss"]
    return JaxTrainer(
        cfg=JaxTrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN),
        apply_fn=apply_fn, loss_fn=jax_get_loss_fn(loss_cfg), loss_weights=loss_cfg["weight_dict"],
        params=jax.tree_util.tree_map(jnp.asarray, params), buffers=buffers,
        train_loader=_Steps(), val_loader=_Steps(), mesh=make_mesh(devices=jax.devices()[:1]),
        project_params=project, seed=0, ckpt_dir=ckpt_dir), project


def _port_trainer(train_cfg, seed=5):
    from schemanet_torch.schema import init_parameters_

    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    init_parameters_(model, torch.Generator().manual_seed(seed))  # overwritten by the checkpoint
    loss_cfg = CIFAR["loss"]
    return Trainer(TrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN), model,
                   torch_get_loss_fn(loss_cfg), loss_cfg["weight_dict"], 2, device="cpu")


def _save(jt, tag):
    jt.ckpt.save(tag, {"params": jt.full_params, "buffers": jt.state.buffers,
                       "opt_state": jt.state.opt_state, "step": jt.state.step})


def _batch(rng):
    return (rng.normal(size=(BATCH, 16, 16, 3)).astype(np.float32),
            rng.integers(0, K, size=BATCH).astype(np.int32))


def test_orbax_checkpoint_resumes_in_the_port(jax_state, tmp_path):
    predictor, params, buffers = jax_state
    train_cfg = CIFAR["training"]
    jt, project = _jax_trainer(predictor, params, buffers, train_cfg, str(tmp_path / "ckpt"))
    rng = np.random.default_rng(0)
    image, label = _batch(rng)
    jt.train_iter({"image": image, "label": label})
    _save(jt, "iter-1")

    trainer = _port_trainer(train_cfg)
    conv.load_orbax_into(trainer, conv.restore_orbax(str(tmp_path / "ckpt" / "iter-1")))
    assert trainer.step == 1
    # and through the file the tool writes: the port resumes from it
    conv.orbax_to_torch(str(tmp_path / "ckpt" / "iter-1"), str(tmp_path / "iter-1.pt"),
                        _port_trainer(train_cfg, seed=6))
    resumed = _port_trainer(train_cfg, seed=7)
    resumed.load_state_dict(torch.load(tmp_path / "iter-1.pt", weights_only=False))

    image, label = _batch(rng)
    want_loss = float(jt.train_iter({"image": image, "label": label})["loss"])
    want = _leaves(jax.device_get(project(jt.state.params)))
    batch = {"image": torch.from_numpy(image), "label": torch.from_numpy(label)}
    lr = float(train_cfg["optimizer"]["lr"])
    for tr in (trainer, resumed):
        grads = {}
        loss = float(tr.train_iter(dict(batch))["loss"])
        np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
        assert tr.step == 2
        for n, p in tr.model.named_parameters():
            if p.requires_grad:
                grads[n] = p.grad
        grads = _leaves(to_jax_params(grads))
        got = _leaves(to_jax_params({n: p for n, p in tr.model.named_parameters()
                                     if p.requires_grad}))
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            g = np.abs(grads[name])
            sure = g > 1e-3 * g.max()
            np.testing.assert_allclose(got[name][sure], w[sure], rtol=1e-4, atol=1e-6,
                                       err_msg=name)
            assert np.abs(got[name] - w).max() <= 2 * lr, name


def test_unconverted_optimizer_states_raise(jax_state, tmp_path):
    predictor, params, buffers = jax_state
    train_cfg = dict(CIFAR["training"], optimizer={"name": "sgd", "lr": 1e-3})
    jt, _ = _jax_trainer(predictor, params, buffers, train_cfg, str(tmp_path / "ckpt"))
    jt.train_iter(dict(zip(("image", "label"), _batch(np.random.default_rng(2)))))
    _save(jt, "iter-1")
    src = str(tmp_path / "ckpt" / "iter-1")
    with pytest.raises(NotImplementedError, match="not AdamW"):
        conv.orbax_to_torch(src, str(tmp_path / "x.pt"), _port_trainer(train_cfg))
    with pytest.raises(ValueError, match="optimizer state"):
        conv.orbax_to_torch(src, str(tmp_path / "x.pt"))
    conv.orbax_to_torch(src, str(tmp_path / "m.pt"), model_only=True)
    model_only = torch.load(tmp_path / "m.pt", weights_only=False)
    assert model_only["step"] == 1 and "optimizer" not in model_only

    # the port's own checkpoint: its optimizer state does not convert to optax's
    trainer = _port_trainer(CIFAR["training"])
    torch.save(trainer.state_dict(), tmp_path / "port.pt")
    with pytest.raises(ValueError, match="--drop-optimizer"):
        conv.torch_to_orbax(str(tmp_path / "port.pt"), str(tmp_path / "jax_out"))
    conv.main(["orbax", "--to", "jax", str(tmp_path / "port.pt"), str(tmp_path / "jax_out"),
               "--drop-optimizer"])
    restored = conv.restore_orbax(str(tmp_path / "jax_out"))
    assert sorted(restored) == ["buffers", "params", "step"]
    back = from_jax_params(restored["params"], restored["buffers"], trainer.model)
    for name, t in trainer.model.state_dict().items():
        assert torch.equal(back[name], t), name
