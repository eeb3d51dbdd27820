"""The port's grid (``schemanet_torch/parallel``) against the JAX package's
mesh, on the CPU.

* The rules: on the names and shapes of the CIFAR-100 DeiT-Tiny and ImageNet
  DeiT-Small predictors (built on the meta device), and on the names of
  ``tests/test_parallel.py``'s rule test, every parameter gets the shard
  dimension JAX's ``param_shardings`` gives it on a ``(4, 2)`` mesh; and
  ``from_jax_params`` then ``shard_params`` gives each model index the slice
  JAX's ``shard_params`` puts on the matching device.
* The dropout of a data slice: the masks of items ``item0 ..`` (attention),
  rows ``row0 ..`` (FFN) and of ``DropoutRNG.rows`` (residual) are the global
  batch's masks for those rows.
* SchemaNet stage-4 steps on gloo ranks, one process each (``spawn_ranks``,
  a time limit a test): 3 steps of the CIFAR-100 config at the tiny size of
  ``tests/test_torch_train.py`` on a ``data 4`` grid and on a
  ``(data 2, model 2)`` grid (the atlas's 6 classes, the backbone's four
  weights split), each against the port's one process on the global batch
  and against the JAX ``Trainer`` on a ``make_mesh(data=4)`` and a
  ``(2, 2)`` mesh. Against JAX, ``tests/test_torch_train.py``'s tolerances
  (losses and step-1 gradients rtol 1e-4, parameters rtol 1e-4 / atol 1e-6
  where the step-1 gradient is large, else within 2 lr a step). Against the
  port's one process, tighter: the same code on the same batch, the sums
  split over the ranks. Measured on this CPU: losses equal, step-1
  gradients within 3.0e-5 of a leaf's max (the GNN's fc bias, a difference
  of large terms, as in ``tests/test_torch_train.py``), parameters within
  3.5e-7, the atlas's moments within 3.4e-7 of their max; bounds: losses
  rtol 1e-6, gradients 1e-4 of the max, parameters 2e-6, moments 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from schemanet_torch.models.port import from_jax_params, jax_name, to_jax_params
from schemanet_torch.models.layers import Dropout
from schemanet_torch.ops.kernels import attention as ak
from schemanet_torch.ops.kernels import mlp as mk
from schemanet_torch.parallel.mesh import Mesh, local_batch_slice, param_shardings, shard_params
from schemanet_torch.schema import build_predictor as torch_build_predictor
from schemanet_tpu.ops import geometry as jax_geometry
from schemanet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from schemanet_tpu.parallel.mesh import param_shardings as jax_param_shardings
from schemanet_tpu.parallel.mesh import shard_params as jax_shard_params
from schemanet_tpu.schema import build_predictor as jax_build_predictor
from schemanet_tpu.schema.atlas import project_atlas_params as jax_project_atlas_params
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn
from schemanet_tpu.schema.loss import weighted_total as jax_weighted_total
from schemanet_tpu.train.common import merge_trees
from schemanet_tpu.train.trainer import Trainer as JaxTrainer
from schemanet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from schemanet_tpu.utils.config import get_cfg
from tests._torch_grid_rank import run_grid, run_steps
from tests.test_torch_train import _leaves, _Steps

MODEL_CFG = {
    "name": "vit",
    "transformer": dict(embed_dim=32, num_encoder_layers=3, num_heads=2, dim_feedforward=64,
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
K, M, D, ENCODE_LAYER = 6, 16, 32, 1  # K even: the (2, 2) grid splits the atlas
BATCH, STEPS, STEPS_PER_EPOCH = 8, 3, 2
CIFAR = get_cfg("configs/cifar_100/schema_net/deit_tiny-l9-M_1024.yaml")


def _jax_dim(spec: P, jname: str, ndim: int):
    """A JAX PartitionSpec as the port's split dimension (None: replicated)."""
    dims = [i for i, axis in enumerate(spec) if axis == "model"]
    if not dims:
        return None
    return 1 - dims[0] if jname.endswith(".kernel") and ndim == 2 else dims[0]


def _jax_tree(named_shapes):
    """The JAX-layout tree of ``ShapeDtypeStruct`` leaves of port names and shapes."""
    tree = {}
    for name, shape in named_shapes:
        jname = jax_name(name, len(shape))
        if jname.endswith(".kernel") and len(shape) == 2:
            shape = shape[::-1]
        elif jname.endswith(".kernel") and len(shape) == 4:  # OIHW -> HWIO
            shape = (shape[2], shape[3], shape[1], shape[0])
        node = tree
        for seg in jname.split(".")[:-1]:
            node = node.setdefault(seg, {})
        node[jname.split(".")[-1]] = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
    return tree


def _assert_rules_match_jax(named_shapes):
    mesh = jax_make_mesh(data=4, model=2)
    specs = jax_param_shardings(mesh, _jax_tree(named_shapes))
    got = param_shardings(Mesh(data=4, model=2), named_shapes)
    sharded = 0
    for name, shape in named_shapes:
        node = specs
        jname = jax_name(name, len(shape))
        for seg in jname.split("."):
            node = node[seg]
        want = _jax_dim(node.spec, jname, len(shape))
        assert got[name] == want, (name, got[name], want)
        sharded += want is not None
    return sharded


def test_param_sharding_rules():
    """tests/test_parallel.py:24-50 on the port's names: the atlas over its
    classes, an embedding of 17 rows replicated (2 does not divide it), the
    attribute weights replicated, linear1's kernel over its output dim."""
    named = [
        ("schema_net.vertex_weights", (10, 16)),
        ("schema_net.edge_weights", (10, 16, 16)),
        ("schema_net.vertex_attribute_weights", (2, 1)),
        ("matcher.gnn.embedding", (17, 8)),
        ("ingredient_backbone.backbone.transformer.layers.0.mlp.linear1.weight", (32, 8)),
    ]
    got = param_shardings(Mesh(data=4, model=2), named)
    assert got == {"schema_net.vertex_weights": 0, "schema_net.edge_weights": 0,
                   "schema_net.vertex_attribute_weights": None, "matcher.gnn.embedding": None,
                   "ingredient_backbone.backbone.transformer.layers.0.mlp.linear1.weight": 0}
    assert _assert_rules_match_jax(named) == 3
    assert set(param_shardings(Mesh(data=8, model=1), named).values()) == {None}


@pytest.mark.parametrize("config, model, num_classes, codes", [
    ("configs/cifar_100/schema_net/deit_tiny-l9-M_1024.yaml",
     "configs/models/deit_tiny_patch16_224.yaml", 100, 1024),
    ("configs/imagenet/schema_net/deit_small-l9-M_8000.yaml",
     "configs/models/deit_small_patch16_224.yaml", 1000, 8000),
])
def test_rules_match_jax_on_the_predictors(config, model, num_classes, codes):
    """Every parameter of the config's predictor at its real shapes (on the
    meta device: the ImageNet atlas is 1.0 GB) gets JAX's split."""
    cfg = get_cfg(config)
    model_cfg = get_cfg(model)["model"]
    with torch.device("meta"):
        predictor = torch_build_predictor(model_cfg, cfg["schema_net"], num_classes, codes,
                                          model_cfg["transformer"]["embed_dim"], 9)
    named = [(n, tuple(p.shape)) for n, p in predictor.named_parameters()]
    # the atlas (2), and linear1's weight and bias, linear2's weight, qkv's
    # weight and bias, out's weight in each of 12 layers; the embedding of
    # M + 1 rows stays whole
    assert _assert_rules_match_jax(named) == 2 + 6 * 12


def test_shard_params_gives_jax_device_slices(rng):
    """``from_jax_params`` then ``shard_params`` on model index m is the
    shard JAX's ``shard_params`` puts on device (d, m) of a (4, 2) mesh."""
    predictor = jax_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    variables = predictor.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                               method="init_full")
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    buffers = jax.tree_util.tree_map(np.asarray, dict(variables["buffers"]))
    state = from_jax_params(params, buffers)
    mesh = jax_make_mesh(data=4, model=2)
    placed = _leaves_of(jax_shard_params(mesh, params))
    checked = 0
    for d in range(4):
        for m in range(2):
            local = shard_params(Mesh(data=4, model=2, rank=2 * d + m), state)
            mine = _leaves(to_jax_params({k: v for k, v in local.items()
                                          if k != "schema_net.class_ingredients"}))
            for path, arr in placed.items():
                shard = next(s for s in arr.addressable_shards if s.device == mesh.devices[d, m])
                np.testing.assert_array_equal(mine[path], np.asarray(shard.data), err_msg=path)
                checked += mine[path].shape != arr.shape
    assert checked == 8 * (2 + 6 * 3)  # the split leaves, on every device


def _leaves_of(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_data_slice_dropout_masks_are_the_global_ones():
    """Items 3.. of a batch of 7 (attention), their rows (FFN) and their
    residual masks: the global batch's masks for those rows."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(7, 9, 3 * 2 * 8, generator=g)
    full = ak.fused_mhsa_reference(qkv, 2, 0.3, 11)
    part = ak.fused_mhsa_reference(qkv[3:], 2, 0.3, 11, item0=3)
    torch.testing.assert_close(part, full[3:], rtol=0, atol=0)
    gg = torch.randn_like(full)
    torch.testing.assert_close(ak.fused_mhsa_bwd_reference(qkv[3:], gg[3:], 2, 0.3, 11, item0=3),
                               ak.fused_mhsa_bwd_reference(qkv, gg, 2, 0.3, 11)[3:],
                               rtol=0, atol=0)
    x = torch.randn(7, 9, 64, generator=g)
    w1, b1 = torch.randn(96, 64, generator=g) * 0.1, torch.randn(96, generator=g)
    w2, b2 = torch.randn(64, 96, generator=g) * 0.1, torch.randn(64, generator=g)
    full = mk.fused_mlp_reference(x, w1, b1, w2, b2, "gelu", 0.3, 5)
    part = mk.fused_mlp_reference(x[3:], w1, b1, w2, b2, "gelu", 0.3, 5, row0=3 * 9)
    torch.testing.assert_close(part, full[3:], rtol=0, atol=0)
    drop = Dropout(0.3)
    y = torch.ones(7, 9, 4)
    full = drop(y, torch.Generator().manual_seed(3))
    part = drop(y[3:], torch.Generator().manual_seed(3), rows=(3, 7))
    assert torch.equal(part, full[3:])


def test_make_mesh_one_rank_and_a_grid_that_does_not_match(monkeypatch):
    """Outside any rendezvous ``make_mesh`` makes a one-rank gloo grid on the
    CPU; a grid the world's one rank cannot fill raises; with torchrun's
    variables missing ``init_from_env`` names torchrun. The process group is
    left as it was found."""
    import torch.distributed as dist

    from schemanet_torch.parallel.mesh import RENDEZVOUS_KEYS, init_from_env, make_mesh

    for key in RENDEZVOUS_KEYS:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_from_env(device="cpu")
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.data, mesh.model, mesh.rank, mesh.backend) == (1, 1, 0, "gloo")
        assert (mesh.data_index, mesh.model_index, str(mesh.device)) == (0, 0, "cpu")
        with pytest.raises(ValueError, match="grid 2 x 1 does not match the world of 1"):
            make_mesh(data=2, device="cpu")
        with pytest.raises(ValueError, match="not divisible by model=2"):
            make_mesh(model=2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_local_batch_slice():
    assert [local_batch_slice(8, Mesh(data=4, model=2, rank=r)) for r in (0, 1, 6)] == [
        slice(0, 2), slice(0, 2), slice(6, 8)]


# -- stage-4 steps on gloo ranks ----------------------------------------------

def _jax_variables():
    jax_geometry.pairwise_point_sim(4, 4, 1.0, 2.0)  # its cache is filled outside a trace
    predictor = jax_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    variables = jax.jit(lambda key, x: predictor.init(key, x, method="init_full"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    buffers = jax.tree_util.tree_map(np.asarray, dict(variables["buffers"]))
    return predictor, params, buffers


def _batches():
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(BATCH, 16, 16, 3)).astype(np.float32),
             rng.integers(0, K, size=BATCH).astype(np.int64)) for _ in range(STEPS)]


def _jax_steps(predictor, params, buffers, batches, data, model):
    """The JAX Trainer's 3 steps on a (data, model) mesh: losses, step-1
    gradients and the (projected) parameters after them, as leaves."""
    train_cfg, loss_cfg = CIFAR["training"], CIFAR["loss"]
    atlas_cfg = predictor.cfg.atlas

    def project(p):
        return dict(p, schema_net=jax_project_atlas_params(p["schema_net"], atlas_cfg))

    def apply_fn(p, b, image, rng, train):
        return predictor.apply({"params": p, "buffers": b}, image)

    jax_loss = jax_get_loss_fn(loss_cfg)
    from schemanet_torch.train import SCHEMA_NET_FROZEN

    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    trainer = JaxTrainer(
        cfg=JaxTrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN),
        apply_fn=apply_fn, loss_fn=jax_loss, loss_weights=loss_cfg["weight_dict"],
        params=jax.tree_util.tree_map(jnp.asarray, params), buffers=buffers,
        train_loader=_Steps(), val_loader=_Steps(), mesh=mesh, project_params=project, seed=0)

    @jax.jit
    def grads(tp, image, label):
        def total(tp_):
            out = apply_fn(merge_trees(trainer.frozen_params, tp_), trainer.state.buffers
                           if hasattr(trainer.state, "buffers") else buffers, image, None, True)
            return jax_weighted_total(jax_loss(out, {"label": label}), loss_cfg["weight_dict"])

        return jax.grad(total)(project(tp))

    out = {"loss": []}
    for step, (image, label) in enumerate(batches):
        if step == 0:
            out["grads"] = _leaves(jax.device_get(grads(trainer.state.params, image,
                                                        label.astype(np.int32))))
        out["loss"].append(float(trainer.train_iter(
            {"image": image, "label": label.astype(np.int32)})["loss"]))
    out["params"] = _leaves(jax.device_get(project(trainer.state.params)))
    return out


@pytest.fixture(scope="module")
def stage4(tmp_path_factory):
    """The port on both grids and in one process, JAX on both meshes."""
    predictor, params, buffers = _jax_variables()
    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    state = from_jax_params(params, buffers, model)
    batches = _batches()
    spec = dict(case="steps", kind="schema", model_cfg=MODEL_CFG, schema_cfg=SCHEMA_CFG, K=K,
                M=M, D=D, encode_layer=ENCODE_LAYER, train_cfg=CIFAR["training"],
                loss_cfg=CIFAR["loss"], state=state, steps_per_epoch=STEPS_PER_EPOCH,
                batches=[(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches])
    out = {"one": run_steps(spec, None), "lr": float(CIFAR["training"]["optimizer"]["lr"])}
    for data, model_ in ((4, 1), (2, 2)):
        grid = dict(spec, grid=(data, model_))
        out[(data, model_)] = run_grid(grid, data * model_,
                                       tmp_path_factory.mktemp(f"grid{data}x{model_}"))
        out[("jax", data, model_)] = _jax_steps(predictor, params, buffers, batches, data, model_)
    return out


def _trainable(state):
    return {k: v for k, v in state["model"].items()
            if k.startswith(("schema_net.", "matcher.")) and k != "schema_net.class_ingredients"}


@pytest.mark.parametrize("grid", [(4, 1), (2, 2)])
def test_grid_step_matches_one_process(stage4, grid):
    one, ranks = stage4["one"], stage4[grid]
    for r in ranks[1:]:  # every rank holds the same whole state
        for k, v in ranks[0]["state"]["model"].items():
            assert torch.equal(v, r["state"]["model"][k]), k
    np.testing.assert_allclose([s["loss"] for s in ranks[0]["losses"]],
                               [s["loss"] for s in one["losses"]], rtol=1e-6)
    for name, want in one["grads"].items():
        got = ranks[0]["grads"][name]
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
    got, want = _trainable(ranks[0]["state"]), _trainable(one["state"])
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert float((got[name] - w).abs().max()) <= 2e-6, name
    # the moments of the whole atlas, gathered from its shards
    for name in ("schema_net.vertex_weights", "schema_net.edge_weights"):
        for key in ("m", "v"):
            w = one["state"]["hot"][name][key]
            g = ranks[0]["state"]["hot"][name][key]
            assert g.shape == w.shape
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), (name, key)


@pytest.mark.parametrize("grid", [(4, 1), (2, 2)])
def test_grid_step_matches_the_jax_mesh(stage4, grid):
    want, ranks = stage4[("jax",) + grid], stage4[grid]
    np.testing.assert_allclose([s["loss"] for s in ranks[0]["losses"]], want["loss"], rtol=1e-4)
    got_grads = _leaves(to_jax_params(ranks[0]["grads"]))
    assert sorted(got_grads) == sorted(want["grads"])
    for name, w in want["grads"].items():
        np.testing.assert_allclose(got_grads[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    got = _leaves(to_jax_params(_trainable(ranks[0]["state"])))
    bound = 2 * stage4["lr"] * STEPS
    for name, g in got.items():
        w = want["params"][name]
        grad = np.abs(want["grads"][name])
        sure = grad > 1e-3 * grad.max()
        np.testing.assert_allclose(g[sure], w[sure], rtol=1e-4, atol=1e-6, err_msg=name)
        assert np.abs(g - w).max() <= bound, name
