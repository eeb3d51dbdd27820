"""The port's SchemaNet training step against the JAX package's, on the CPU.

Both trainers start from the same variables (the JAX init, loaded into the
port through ``from_jax_params``) and take the same three batches, with the
CIFAR-100 config's optimizer, parameter groups, ``drop_remain``, schedule and
schema loss at the tiny model size of ``test_torch_serve.py``, fp32 with
``graph_precision='highest'``. The JAX reference is its ``Trainer`` as
``schema_net_worker`` builds it, on its default path: the atlas projection
before every step, the plain XLA ops (no Pallas kernel on the CPU). The port
keeps the atlas projected by the fused update instead, which gives the
gradient the same parameters (``tests/test_atlas_opt.py`` pins that for the
JAX package's own fused path).

Tolerances, and why:

* losses of the 3 steps, rtol 1e-4: the two frameworks add fp32 products in
  other orders (~1e-7 relative per op), amplified through the encoder, the
  graph build and a GNN whose unit-variance weights grow the features (the
  losses agree to ~1e-7);
* step-1 gradients leaf by leaf, rtol 1e-4 and atol 1e-4 * max|leaf|. Most
  leaves agree within 1e-5 of their max, but a few are sums of terms far
  larger than the result: the softmax cotangents of a logit row sum to zero,
  so the GNN fc bias and the attribute-weight gradients are differences of
  terms of the size of the (large) graph features. There the fp32 summation
  order alone moves the result by up to ~4e-5 of the leaf's max;
* parameters after 3 steps, rtol 1e-4 / atol 1e-6, on the entries whose
  step-1 JAX gradient exceeds 1e-3 * max|leaf|; elsewhere within
  2 * lr * steps. Adam's first step moves each entry by lr * sign(g) whenever
  |g| >> eps, so an entry whose first gradient is near zero may step either
  way in the two frameworks (later steps are weighted by that history), by
  at most about lr a step;
* Adam moments after 3 steps, rtol 1e-4 and atol 1e-4 of the largest value
  the moment could take, (1-b1) sum_t max|g_t| (first) or
  (1-b2) sum_t max|g_t|^2 (second): the first moment of the fc bias cancels
  across the steps as its gradient cancels within one.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models.port import from_jax_params, jax_name, to_jax_params
from schemanet_torch.schema import build_predictor as torch_build_predictor
from schemanet_torch.schema import get_loss_fn as torch_get_loss_fn
from schemanet_torch.schema import init_parameters_
from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig
from schemanet_tpu.ops import geometry as jax_geometry
from schemanet_tpu.parallel.mesh import make_mesh
from schemanet_tpu.schema import build_predictor as jax_build_predictor
from schemanet_tpu.schema.atlas import project_atlas_params as jax_project_atlas_params
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn
from schemanet_tpu.schema.loss import weighted_total as jax_weighted_total
from schemanet_tpu.train.common import merge_trees
from schemanet_tpu.train.trainer import Trainer as JaxTrainer
from schemanet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from schemanet_tpu.utils.config import get_cfg

MODEL_CFG = {
    "name": "vit",
    "transformer": dict(
        embed_dim=32, num_encoder_layers=3, num_heads=2, dim_feedforward=64,
        dropout=None, activation="gelu", final_norm=True, norm_eps=1e-6,
    ),
    "patch_embed": dict(img_size=16, patch_size=4, image_channels=3),
    "pos_encoding": dict(name="learnable"),
}
SCHEMA_CFG = {
    "matcher": {"similarity": "inner_product"},
    "gnn": {"embed_dim": 16, "num_layers": 2, "activation": "relu"},
    "ir_atlas": dict(
        class_max_vertices=None, dist_pow=2, feat_h=4, feat_w=4,
        clamp_vertex_attn=-1.0, clamp_edge_attn=-1.0, remove_self_loop=False,
        prune_node_threshold=0.001, graph_precision="highest",
    ),
}
K, M, D, ENCODE_LAYER = 5, 16, 32, 1
BATCH, STEPS, STEPS_PER_EPOCH = 4, 3, 2  # step 2 is in epoch 1: the schedule moves
CIFAR = get_cfg("configs/cifar_100/schema_net/deit_tiny-l9-M_1024.yaml")
HOT = ("vertex_weights", "edge_weights")


class _Steps:
    """What the JAX Trainer reads of a loader when stepped by hand."""

    def __len__(self):
        return STEPS_PER_EPOCH


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _leaves(tree):
    return {"/".join(path): value for path, value in _flatten(tree)}


def _adam_moments(opt_state, which):
    """{param path: moment} of an optax multi_transform AdamW state (fp32;
    adamw_lowmem's full nu, nested under "full", by its parameter's path)."""
    out = {}
    for path, value in jax.tree_util.tree_leaves_with_path(opt_state):
        key = jax.tree_util.keystr(path)
        if f".{which}[" in key:
            names = re.findall(r"\['([^']+)'\]", key.split(f".{which}", 1)[1])
            if names[-1] == "full":
                names = names[:-1]
            out["/".join(names)] = np.asarray(jnp.asarray(value, jnp.float32))
    return out


@pytest.fixture(scope="module")
def run():
    """Three steps of both trainers; everything the tests compare."""
    return _run_both(CIFAR, MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)


def _run_both(yaml_cfg, model_cfg, schema_cfg, K, M, D, encode_layer):
    """Three steps of both trainers under ``yaml_cfg``'s training and loss
    blocks; everything the tests compare."""
    jax_geometry.pairwise_point_sim(4, 4, 1.0, 2.0)
    predictor = jax_build_predictor(model_cfg, schema_cfg, K, M, D, encode_layer)
    variables = jax.jit(lambda key, x: predictor.init(key, x, method="init_full"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))
    )
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    buffers = jax.tree_util.tree_map(np.asarray, dict(variables["buffers"]))
    train_cfg, loss_cfg = yaml_cfg["training"], yaml_cfg["loss"]
    atlas_cfg = predictor.cfg.atlas

    def project(p):
        return dict(p, schema_net=jax_project_atlas_params(p["schema_net"], atlas_cfg))

    def apply_fn(p, b, image, rng, train):
        return predictor.apply({"params": p, "buffers": b}, image)

    jax_loss = jax_get_loss_fn(loss_cfg)
    jax_trainer = JaxTrainer(
        cfg=JaxTrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN),
        apply_fn=apply_fn, loss_fn=jax_loss, loss_weights=loss_cfg["weight_dict"],
        params=jax.tree_util.tree_map(jnp.asarray, params), buffers=buffers,
        train_loader=_Steps(), val_loader=_Steps(), mesh=make_mesh(devices=jax.devices()[:1]),
        project_params=project, seed=0,
    )

    @jax.jit
    def jax_grads(tp, image, label):
        def total(tp_):
            out = apply_fn(merge_trees(jax_trainer.frozen_params, tp_), buffers, image, None, True)
            return jax_weighted_total(jax_loss(out, {"label": label}), loss_cfg["weight_dict"])

        return jax.grad(total)(project(tp))

    model = torch_build_predictor(model_cfg, schema_cfg, K, M, D, encode_layer)
    model.load_state_dict(from_jax_params(params, buffers, model))
    trainer = Trainer(TrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN),
                      model, torch_get_loss_fn(loss_cfg), loss_cfg["weight_dict"], STEPS_PER_EPOCH,
                      device="cpu")

    rng = np.random.default_rng(0)
    result = {"jax_loss": [], "torch_loss": [], "jax_grads": []}
    for step in range(STEPS):
        image = rng.normal(size=(BATCH, 16, 16, 3)).astype(np.float32)
        label = rng.integers(0, K, size=BATCH).astype(np.int32)
        result["jax_grads"].append(_leaves(jax.device_get(
            jax_grads(jax_trainer.state.params, image, label))))
        result["jax_loss"].append(float(jax_trainer.train_iter({"image": image, "label": label})["loss"]))
        metrics = trainer.train_iter({"image": torch.from_numpy(image),
                                      "label": torch.from_numpy(label)})
        result["torch_loss"].append(float(metrics["loss"]))
        if step == 0:
            result["torch_grads"] = _leaves(to_jax_params(
                {n: p.grad for n, p in model.named_parameters() if p.requires_grad}))
            result["jax_params_1"] = _leaves(jax.device_get(project(jax_trainer.state.params)))
            result["torch_params_1"] = _leaves(to_jax_params(
                {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}))
    result["jax_params"] = _leaves(jax.device_get(project(jax_trainer.state.params)))
    result["torch_params"] = _leaves(to_jax_params(
        {n: p for n, p in model.named_parameters() if p.requires_grad}))
    opt = jax.device_get(jax_trainer.state.opt_state)
    result["jax_mu"], result["jax_nu"] = _adam_moments(opt, "mu"), _adam_moments(opt, "nu")
    torch_mu = {n: trainer.optimizer.optimizer.state[p]["exp_avg"]
                for n, p in model.named_parameters() if p in trainer.optimizer.optimizer.state}
    torch_nu = {n: trainer.optimizer.optimizer.state[p]["exp_avg_sq"]
                for n, p in model.named_parameters() if p in trainer.optimizer.optimizer.state}
    lowmem = trainer.optimizer.lowmem
    for (_, ps), states in zip(lowmem.groups, lowmem.state) if lowmem is not None else ():
        for p, st in zip(ps, states):
            name = next(n for n, q in model.named_parameters() if q is p)
            torch_mu[name], torch_nu[name] = st["m"], st["v"]
    for name, hot in trainer.hot.items():
        torch_mu[name], torch_nu[name] = hot.m, hot.v
    result["moment_dtypes"] = {n: (t.dtype, torch_nu[n].dtype) for n, t in torch_mu.items()}
    torch_mu = {n: t.float() for n, t in torch_mu.items()}
    torch_nu = {n: t.float() for n, t in torch_nu.items()}
    result["torch_mu"], result["torch_nu"] = (_leaves(to_jax_params(torch_mu)),
                                              _leaves(to_jax_params(torch_nu)))
    result["lr"] = float(train_cfg["optimizer"]["lr"])
    result["trainer"] = trainer
    return result


def test_losses_match_jax(run):
    np.testing.assert_allclose(run["torch_loss"], run["jax_loss"], rtol=1e-4)
    assert len(set(run["torch_loss"])) == STEPS  # the steps changed something


def test_step1_gradients_match_jax(run):
    want, got = run["jax_grads"][0], run["torch_grads"]
    assert sorted(got) == sorted(want)
    assert any(k.startswith("schema_net/") for k in want) and any(k.startswith("matcher/") for k in want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_params_after_three_steps_match_jax(run):
    want, got = run["jax_params"], run["torch_params"]
    assert sorted(got) == sorted(want)
    bound = 2 * run["lr"] * STEPS
    for name, w in want.items():
        g = np.abs(run["jax_grads"][0][name])
        sure = g > 1e-3 * g.max()
        assert sure.mean() > 0.5, name
        np.testing.assert_allclose(got[name][sure], w[sure], rtol=1e-4, atol=1e-6, err_msg=name)
        assert np.abs(got[name] - w).max() <= bound, name


@pytest.mark.parametrize("which,power,decay", [("mu", 1, 0.9), ("nu", 2, 0.999)])
def test_adam_moments_match_jax(run, which, power, decay):
    want, got = run[f"jax_{which}"], run[f"torch_{which}"]
    assert sorted(got) == sorted(want) == sorted(run["jax_params"])
    for name, w in want.items():
        bound = (1 - decay) * sum(np.abs(g[name]).max() ** power for g in run["jax_grads"])
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * bound, err_msg=name)


def test_trainer_groups_and_frozen_backbone(run):
    """The CIFAR groups: the atlas at weight decay 5e-4, the GNN at 0.05, the
    rest frozen (drop_remain), the backbone frozen in any case."""
    trainer = run["trainer"]
    for name, p in trainer.model.named_parameters():
        label = trainer.labels[name]
        assert p.requires_grad == (label != "frozen"), name
        want = ("group_0" if name.startswith("schema_net.") else
                "group_1" if name.startswith("matcher.") else "frozen")
        assert label == want, name
    assert set(trainer.hot) == {"schema_net.vertex_weights", "schema_net.edge_weights"}
    assert {h.weight_decay for h in trainer.hot.values()} == {5e-4}
    wds = {g["weight_decay"] for g in trainer.optimizer.optimizer.param_groups}
    assert wds == {5e-4, 0.05}
    assert trainer.step == STEPS


# ---------------------------------------------------------------------------
# The stage-4 step under the ImageNet DeiT-Small YAML's training block (bf16
# Adam moments on the schema_net group through adamw_lowmem, the matcher on
# AdamW, the rest frozen) at narrow widths: K=4, V_max=16, M=32, GNN 32 x 2,
# ViT of 2 layers (width 32), 16^2 images of patch 4. The tolerances of the
# CIFAR case, with two differences. The bf16 moments: within one bf16 ulp
# of JAX's beyond the CIFAR bound (a difference below the bound can flip a
# rounding). The parameters: the CIFAR tight rule (rtol 1e-4 / atol 1e-6
# where the step-1 gradient is above 1e-3 of its max) after the first step,
# and its other bound (2 * lr * steps) after three. Free-running steps carry
# the gradients' differences (up to 1e-4 of a tensor's max, so percents of
# a small entry) into Adam's later steps, which amplify them where the
# gradients of two steps nearly cancel in m: at these widths one matcher
# bias entry misses the tight rule after three steps, under this training
# block and under the CIFAR one alike. chip_smoke.py's phase 8 holds the
# tight rule in lock step for the same reason.
# ---------------------------------------------------------------------------
IMAGENET = get_cfg("configs/imagenet/schema_net/deit_small-l9-M_8000.yaml")
IN_MODEL_CFG = dict(MODEL_CFG, transformer=dict(MODEL_CFG["transformer"], num_encoder_layers=2))
IN_SCHEMA_CFG = {
    "matcher": dict(IMAGENET["schema_net"]["matcher"]),
    "gnn": dict(IMAGENET["schema_net"]["gnn"], embed_dim=32, num_layers=2),
    "ir_atlas": dict(IMAGENET["schema_net"]["ir_atlas"], class_max_vertices=16, feat_h=4,
                     feat_w=4, graph_precision="highest"),
}
IN_K, IN_M = 4, 32


@pytest.fixture(scope="module")
def run_imagenet():
    return _run_both(IMAGENET, IN_MODEL_CFG, IN_SCHEMA_CFG, IN_K, IN_M, D, ENCODE_LAYER)


def test_imagenet_step_matches_jax(run_imagenet):
    """Losses and step-1 gradients with the CIFAR case's checks; the
    parameters with its tight rule after one step and its bound after
    three."""
    run = run_imagenet
    test_losses_match_jax(run)
    test_step1_gradients_match_jax(run)
    assert sorted(run["torch_params"]) == sorted(run["jax_params"])
    for name, w in run["jax_params_1"].items():
        g = np.abs(run["jax_grads"][0][name])
        sure = g > 1e-3 * g.max()
        assert sure.mean() > 0.5, name
        np.testing.assert_allclose(run["torch_params_1"][name][sure], w[sure], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        assert np.abs(run["torch_params_1"][name] - w).max() <= 2 * run["lr"], name
    for name, w in run["jax_params"].items():
        assert np.abs(run["torch_params"][name] - w).max() <= 2 * run["lr"] * STEPS, name


@pytest.mark.parametrize("which,power,decay", [("mu", 1, 0.9), ("nu", 2, 0.999)])
def test_imagenet_adam_moments_match_jax(run_imagenet, which, power, decay):
    """Every moment, in the dtype its group asks for: bf16 for the four
    atlas tensors (schema_net: moment_dtype and nu_dtype bfloat16), fp32 for
    the matcher."""
    want, got = run_imagenet[f"jax_{which}"], run_imagenet[f"torch_{which}"]
    assert sorted(got) == sorted(want) == sorted(run_imagenet["jax_params"])
    for name, w in want.items():
        bound = (1 - decay) * sum(np.abs(g[name]).max() ** power for g in run_imagenet["jax_grads"])
        if name.startswith("schema_net/"):
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), np.finfo(np.float32).tiny))) - 7)
            assert (np.abs(got[name] - w) <= ulp + 1e-4 * bound).all(), name
        else:
            np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * bound, err_msg=name)


def test_imagenet_groups_keep_bf16_moments(run_imagenet):
    """All four atlas tensors keep bf16 m and v, the two hot ones through the
    fused update's bf16 variant; the matcher keeps fp32 on AdamW."""
    trainer = run_imagenet["trainer"]
    assert set(trainer.hot) == {"schema_net.vertex_weights", "schema_net.edge_weights"}
    assert all(h.fused for h in trainer.hot.values())
    for name, (m_dt, v_dt) in run_imagenet["moment_dtypes"].items():
        want = torch.bfloat16 if name.startswith("schema_net.") else torch.float32
        assert (m_dt, v_dt) == (want, want), name
    assert sum(name.startswith("schema_net.") for name in run_imagenet["moment_dtypes"]) == 4


def test_to_jax_params_inverts_from_jax_params():
    """from_jax_params(to_jax_params(sd)) is the identity on every leaf, and
    jax_name gives the JAX dotted names the parameter-group regexes see."""
    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    sd = model.state_dict()
    tree = to_jax_params(sd)
    assert tree["backbone"]["transformer"]["layers_1"]["attention"]["linear_qkv"]["kernel"].shape == (32, 96)
    assert tree["backbone"]["patch_embed"]["proj"]["kernel"].shape == (4, 4, 3, 32)  # HWIO
    back = from_jax_params(tree, {}, model)
    assert sorted(back) == sorted(sd)
    for name, value in sd.items():
        torch.testing.assert_close(back[name], value, rtol=0, atol=0, msg=name)
    assert jax_name("matcher.gnn.layers.0.g_conv.linear.weight", 2) == \
        "matcher.gnn.layers_0.g_conv.linear.kernel"
    assert jax_name("ingredient_backbone.backbone.transformer.norm.weight", 1) == \
        "backbone.transformer.norm.scale"


def test_schema_forward_unchanged_by_backbone_dropout():
    """The SchemaNet backbone stays deterministic under the Trainer whatever
    its ``dropout`` (the JAX schema path runs it with deterministic=True):
    the training forward gives the same loss terms bit for bit."""
    image = torch.from_numpy(np.random.default_rng(3).normal(size=(BATCH, 16, 16, 3)).astype(np.float32))
    label = torch.arange(BATCH) % K
    losses = []
    for dropout in (None, 0.1):
        cfg = dict(MODEL_CFG, transformer=dict(MODEL_CFG["transformer"], dropout=dropout))
        model = torch_build_predictor(cfg, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
        init_parameters_(model, torch.Generator().manual_seed(0))
        trainer = Trainer(TrainerConfig.from_cfg(CIFAR["training"], frozen_patterns=SCHEMA_NET_FROZEN),
                          model, torch_get_loss_fn(CIFAR["loss"]), CIFAR["loss"]["weight_dict"],
                          STEPS_PER_EPOCH, device="cpu")
        assert (model.ingredient_backbone.backbone.transformer.layers[0].drop is None) == (dropout is None)
        with torch.no_grad():
            losses.append(trainer.forward_loss({"image": image, "label": label})[1])
    assert sorted(losses[0]) == sorted(losses[1])
    for name in losses[0]:
        assert torch.equal(losses[0][name], losses[1][name]), name
