"""The port's SGD, Adam and factored AdamW (Adafactor) against the JAX
package's ``make_optimizer`` (optax), on the CPU.

* The optimizers alone: 5 updates of both on the same parameters and
  gradients, with lr groups, a frozen group and weight decay where the
  optimizer has it; the parameters within 1e-6 of each leaf's max (the
  frameworks' fp32 pow, rsqrt and means may differ in the last bit), the
  states within 1e-6 relative of optax's (bf16 moments within one bf16 ulp
  of JAX's beyond that).
* A SchemaNet stage-4 run of 2 steps under each optimizer against the JAX
  ``Trainer`` (the CIFAR-100 config's groups at the tiny size of
  ``tests/test_torch_train.py``, fp32): losses rtol 1e-4; the parameters by
  that file's rules (SGD and Adafactor move an entry continuously in its
  gradient, so every entry within rtol 1e-4 / atol 1e-6; Adam by the tight
  rule where the step-1 gradient exceeds 1e-3 of its max and within 2 lr a
  step elsewhere, as ``test_params_after_three_steps_match_jax``).
* ``state_dict`` round trip: a second optimizer loaded from the first's
  state takes the next update with the same bits.
* A 2-rank gloo grid (model 2) with the atlas sharded over its classes, the
  edge weights ``[130, 128, 128]`` so that Adafactor factors them over the
  class axis: the losses, the parameters and the (gathered) factored
  statistics of one process within 1e-5 relative (the ranks sum the class
  axis' means and the update's RMS in another order; measured 2.1e-6 for
  the statistics, 4.7e-7 of max for the edge weights), but for the leaves
  whose gradients cancel (``_CANCELLING``: measured 1.5e-3 relative on the
  GNN's fc bias), which stay within 2 lr a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from schemanet_torch.models.port import from_jax_params, to_jax_params
from schemanet_torch.schema import build_predictor as torch_build_predictor
from schemanet_torch.schema import get_loss_fn as torch_get_loss_fn
from schemanet_torch.schema import init_parameters_
from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig
from schemanet_torch.train.common import factored_dims, make_optimizer
from schemanet_tpu.ops import geometry as jax_geometry
from schemanet_tpu.parallel.mesh import make_mesh
from schemanet_tpu.schema import build_predictor as jax_build_predictor
from schemanet_tpu.schema.atlas import project_atlas_params as jax_project_atlas_params
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn
from schemanet_tpu.schema.loss import weighted_total as jax_weighted_total
from schemanet_tpu.train.common import make_optimizer as jax_make_optimizer
from schemanet_tpu.train.common import merge_trees
from schemanet_tpu.train.trainer import Trainer as JaxTrainer
from schemanet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tests._torch_grid_rank import run_grid, run_steps
from tests.test_torch_common import _Holder, _ulp_bf16
from tests.test_torch_train import (BATCH, CIFAR, ENCODE_LAYER, MODEL_CFG, SCHEMA_CFG, _leaves,
                                    _Steps)

_SHAPES = {("schema_net", "edge_weights"): (3, 130, 140), ("schema_net", "vertex_weights"): (3, 40),
           ("head", "bias"): (8,), ("head", "embedding"): (6, 5), ("frozen", "embedding"): (4, 4)}
_GROUPS = [{"pattern": "schema_net", "cfg": {"lr": 2e-3, "weight_decay": 5e-4}},
           {"pattern": "head"}]
_CASES = {
    "sgd": {"name": "sgd", "lr": 1e-3},
    "sgd_momentum_0.5": {"name": "sgd", "lr": 1e-3, "momentum": 0.5},
    "adam": {"name": "adam", "lr": 1e-3, "weight_decay": 0.05},
    "adam_bf16": {"name": "adam", "lr": 1e-3, "moment_dtype": "bfloat16"},
    "factored": {"name": "AdamW", "lr": 1e-3, "weight_decay": 0.05, "factored": True},
    "factored_no_decay": {"name": "AdamW", "lr": 1e-3, "factored": True},
}


def _tree(values, mods=("schema_net", "head", "frozen")):
    return {m: {leaf: jnp.asarray(values[(m, leaf)]) for (mm, leaf) in _SHAPES if mm == m}
            for m in mods}


def _jax_states(state):
    """{param dotted name: {state name: array}} of the optax states in a
    make_optimizer state (SGD's trace, Adam's mu and nu, Adafactor's
    v_row, v_col and v), skipping the masked-out leaves."""
    out = {}
    for path, value in jax.tree_util.tree_leaves_with_path(state):
        keys = [getattr(k, "name", None) or getattr(k, "key", None) or getattr(k, "idx", None)
                for k in path]
        keys = [str(k) for k in keys if k is not None]
        for field in ("trace", "mu", "nu", "v_row", "v_col", "v"):
            if field in keys:
                i = keys.index(field)
                name = ".".join(k for k in keys[i + 1:] if k != "full")
                # optax's Adafactor keeps a [1] placeholder for the layout it does not use
                if not (field.startswith("v") and np.shape(value) == (1,)):
                    out.setdefault(name, {})[field] = np.asarray(jnp.asarray(value, jnp.float32))
                break
    return out


_PORT_KEY = {"trace": "trace", "mu": "m", "nu": "v", "v_row": "v_row", "v_col": "v_col", "v": "v"}


@pytest.mark.parametrize("case", list(_CASES))
def test_optimizer_matches_optax(case):
    opt_cfg = _CASES[case]
    rng = np.random.default_rng(11)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in _SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 0)).astype(np.float32)
              for k, s in _SHAPES.items()} for _ in range(5)]

    def schedule(step):
        return opt_cfg["lr"] * (1.0 - 0.1 * step)

    jparams = _tree(init)
    tx, _ = jax_make_optimizer(jparams, opt_cfg, schedule, _GROUPS, drop_remain=True)
    jstate = tx.init(jparams)

    @jax.jit
    def step_fn(g, s, p):  # as the JAX trainer's step runs it: update and apply in one program
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    model = _Holder(init)
    opt, labels, hyper = make_optimizer(model, opt_cfg, schedule, _GROUPS, drop_remain=True)
    assert labels["frozen.embedding"] == "frozen"
    named = dict(model.named_parameters())
    for step, gr in enumerate(grads):
        jparams, jstate = step_fn(_tree(gr), jstate, jparams)
        for (m, leaf), g in gr.items():
            if named[f"{m}.{leaf}"].requires_grad:
                named[f"{m}.{leaf}"].grad = torch.from_numpy(g.copy())
        opt.step(step)
        for (m, leaf) in _SHAPES:
            want, got = np.asarray(jparams[m][leaf]), named[f"{m}.{leaf}"].detach().numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), (case, step, m, leaf)
    np.testing.assert_array_equal(named["frozen.embedding"].detach().numpy(),
                                  init[("frozen", "embedding")])

    port = {}
    for (hp, ps), states in zip(opt.lowmem.groups, opt.lowmem.state):
        for p, st in zip(ps, states):
            port[next(n for n, q in named.items() if q is p)] = st
    assert opt.optimizer is None and set(port) == {n for n in named if n != "frozen.embedding"}
    want_states = _jax_states(jstate)
    for name, st in port.items():
        jst = want_states[name]
        assert {_PORT_KEY[k] for k in jst} == set(st), (name, sorted(jst), sorted(st))
        for field, w in jst.items():
            t = st[_PORT_KEY[field]]
            got = t.float().numpy().reshape(w.shape)
            tol = 1e-6 * np.abs(w) + (_ulp_bf16(w) if t.dtype == torch.bfloat16 else 0)
            assert (np.abs(got - w) <= tol + 1e-30).all(), (case, name, field)
    edge = port["schema_net.edge_weights"]
    if case.startswith("factored"):  # factored over the two largest axes: 140 (d0) and 130 (d1)
        assert factored_dims((3, 130, 140)) == (1, 2)
        assert edge["v_row"].shape == (3, 130, 1) and edge["v_col"].shape == (3, 1, 140)
    assert "m" not in edge or (edge["m"].dtype == torch.bfloat16) == (case == "adam_bf16")


def test_state_dict_round_trip():
    """Each optimizer's state after 2 updates, loaded into a second one,
    gives the next update's bits."""
    rng = np.random.default_rng(5)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in _SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in _SHAPES.items()}
             for _ in range(3)]
    for case, opt_cfg in _CASES.items():
        a, b = _Holder(init), _Holder(init)
        opt_a, *_ = make_optimizer(a, opt_cfg, lambda s: 1e-3, _GROUPS, drop_remain=True)
        opt_b, *_ = make_optimizer(b, opt_cfg, lambda s: 1e-3, _GROUPS, drop_remain=True)
        for step, gr in enumerate(grads):
            if step == 2:
                opt_b.load_state_dict(opt_a.state_dict())
                b.load_state_dict(a.state_dict())
            for model in (a, b):
                for (m, leaf), g in gr.items():
                    p = getattr(getattr(model, m), leaf)
                    p.grad = torch.from_numpy(g.copy()) if p.requires_grad else None
            opt_a.step(step)
            if step == 2:
                opt_b.step(step)
        for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(pa, pb), (case, name)


# ---------------------------------------------------------------------------
# 2 stage-4 steps of the port's Trainer against the JAX Trainer
# ---------------------------------------------------------------------------
K, M, D = 5, 16, 32
STEPS = 2
_TRAINER_CASES = {
    "sgd": {"name": "sgd", "lr": 1e-3},
    "adam": {"name": "adam", "lr": 1e-3},
    "factored": {"name": "AdamW", "lr": 1e-3, "weight_decay": 0.05, "factored": True},
}


@pytest.fixture(scope="module")
def jax_init():
    jax_geometry.pairwise_point_sim(4, 4, 1.0, 2.0)
    predictor = jax_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    variables = jax.jit(lambda key, x: predictor.init(key, x, method="init_full"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    return (predictor, jax.tree_util.tree_map(np.asarray, dict(variables["params"])),
            jax.tree_util.tree_map(np.asarray, dict(variables["buffers"])))


def _train_cfg(opt_cfg):
    return dict(CIFAR["training"], optimizer=opt_cfg)


@pytest.mark.parametrize("case", list(_TRAINER_CASES))
def test_stage4_steps_match_jax_trainer(jax_init, case):
    predictor, params, buffers = jax_init
    train_cfg, loss_cfg = _train_cfg(_TRAINER_CASES[case]), CIFAR["loss"]
    atlas_cfg = predictor.cfg.atlas

    def project(p):
        return dict(p, schema_net=jax_project_atlas_params(p["schema_net"], atlas_cfg))

    def apply_fn(p, b, image, rng, train):
        return predictor.apply({"params": p, "buffers": b}, image)

    jax_loss = jax_get_loss_fn(loss_cfg)
    jt = JaxTrainer(
        cfg=JaxTrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN),
        apply_fn=apply_fn, loss_fn=jax_loss, loss_weights=loss_cfg["weight_dict"],
        params=jax.tree_util.tree_map(jnp.asarray, params), buffers=buffers,
        train_loader=_Steps(), val_loader=_Steps(), mesh=make_mesh(devices=jax.devices()[:1]),
        project_params=project, seed=0,
    )

    @jax.jit
    def jax_grads(tp, image, label):
        def total(tp_):
            out = apply_fn(merge_trees(jt.frozen_params, tp_), buffers, image, None, True)
            return jax_weighted_total(jax_loss(out, {"label": label}), loss_cfg["weight_dict"])

        return jax.grad(total)(project(tp))

    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    model.load_state_dict(from_jax_params(params, buffers, model))
    trainer = Trainer(TrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN),
                      model, torch_get_loss_fn(loss_cfg), loss_cfg["weight_dict"], 2,
                      device="cpu")
    rng = np.random.default_rng(0)
    jax_losses, torch_losses, grads0 = [], [], None
    for step in range(STEPS):
        image = rng.normal(size=(BATCH, 16, 16, 3)).astype(np.float32)
        label = rng.integers(0, K, size=BATCH).astype(np.int32)
        if step == 0:
            grads0 = _leaves(jax.device_get(jax_grads(jt.state.params, image, label)))
        jax_losses.append(float(jt.train_iter({"image": image, "label": label})["loss"]))
        torch_losses.append(float(trainer.train_iter({"image": torch.from_numpy(image),
                                                      "label": torch.from_numpy(label)})["loss"]))
    np.testing.assert_allclose(torch_losses, jax_losses, rtol=1e-4)
    assert len(set(torch_losses)) == STEPS
    # the hot atlas tensors took the group's update and the plain projection
    assert not any(h.fused for h in trainer.hot.values())
    want = _leaves(jax.device_get(project(jt.state.params)))
    got = _leaves(to_jax_params({n: p for n, p in model.named_parameters() if p.requires_grad}))
    assert sorted(got) == sorted(want)
    lr = _TRAINER_CASES[case]["lr"]
    for name, w in want.items():
        if case == "adam":
            g = np.abs(grads0[name])
            sure = g > 1e-3 * g.max()
            np.testing.assert_allclose(got[name][sure], w[sure], rtol=1e-4, atol=1e-6,
                                       err_msg=name)
            assert np.abs(got[name] - w).max() <= 2 * lr * STEPS, name
        else:
            np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# Adafactor on a model-2 grid, the atlas sharded over its classes
# ---------------------------------------------------------------------------
GRID_K, GRID_M = 130, 128
# the leaves whose gradient is a difference of terms far larger than itself
# (tests/test_torch_train.py): the ranks' other summation order moves it by
# up to ~1e-4 of its max, and Adafactor, which divides each entry by its own
# statistics, passes that relative error on to the update; within 2 lr a
# step, the bound chip_smoke.py's phase 41 puts on every trained tensor
_CANCELLING = ("matcher.gnn.fc.bias", "schema_net.vertex_attribute_weights",
               "schema_net.edge_attribute_weights")


def test_factored_state_on_a_model_grid_matches_one_process(tmp_path):
    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, GRID_K, GRID_M, D, ENCODE_LAYER)
    init_parameters_(model, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(6)
    batches = [(torch.from_numpy(rng.normal(size=(4, 16, 16, 3)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, GRID_K, 4))) for _ in range(2)]
    train_cfg = _train_cfg({"name": "AdamW", "lr": 1e-3, "weight_decay": 0.05, "factored": True})
    spec = dict(case="steps", kind="schema", model_cfg=MODEL_CFG, schema_cfg=SCHEMA_CFG,
                K=GRID_K, M=GRID_M, D=D, encode_layer=ENCODE_LAYER, train_cfg=train_cfg,
                loss_cfg=CIFAR["loss"], state=model.state_dict(), steps_per_epoch=2,
                batches=batches, grid=(1, 2))
    want = run_steps(dict(spec, grid=None), None)
    got = run_grid(spec, 2, tmp_path / "grid")
    for rank in got:
        np.testing.assert_allclose([s["loss"] for s in rank["losses"]],
                                   [s["loss"] for s in want["losses"]], rtol=1e-5)
    for name, w in want["state"]["model"].items():
        if not w.is_floating_point():
            continue
        g = got[0]["state"]["model"][name].numpy()
        if name in _CANCELLING:
            assert np.abs(g - w.numpy()).max() <= 2 * 1e-3 * len(batches), name
        else:
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
    edge = "schema_net.edge_weights"
    assert factored_dims((GRID_K, GRID_M, GRID_M)) == (2, 0)  # d0 the class axis, split
    for rank in got:
        for key in ("v_row", "v_col"):
            w, g = want["state"]["hot"][edge][key], rank["state"]["hot"][edge][key]
            assert g.shape == w.shape, key
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, err_msg=key)
    assert want["state"]["hot"][edge]["v_row"].shape == (1, GRID_M, GRID_M)
    assert want["state"]["hot"][edge]["v_col"].shape == (GRID_K, GRID_M, 1)
