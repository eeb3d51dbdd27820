"""The port's serving slice against the JAX package's, on the CPU.

The same numpy images go through ``schemanet_tpu.serve.ServePredictor`` (with
the frozen forward on its Pallas block kernels in interpret mode) and through
``schemanet_torch.serve.ServePredictor`` loaded with the converted variables.
fp32 with ``graph_precision='highest'``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models.port import from_jax_params
from schemanet_torch.schema import build_predictor as torch_build_predictor
from schemanet_torch.schema import get_loss_fn, init_parameters_
from schemanet_torch.serve import ServePredictor as TorchServePredictor
from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig
from schemanet_tpu.ops import geometry as jax_geometry
from schemanet_tpu.ops import policy
from schemanet_tpu.schema import build_predictor as jax_build_predictor
from schemanet_tpu.serve import ServePredictor as JaxServePredictor

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


@pytest.fixture(autouse=True)
def _kernel_policy():
    # `attn` must be off xla too: the JAX predictor lets its frozen forward
    # fuse only then (schema/predictor.py _any_fused_backend)
    policy.reset_policy()
    policy.configure({"block": "interpret", "attn": "interpret", "graphconv": "interpret"})
    yield
    policy.reset_policy()


@pytest.fixture(scope="module")
def jax_variables():
    predictor = jax_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    # one jitted init instead of an eager op-by-op one (~3x faster); the
    # geometry table is a host-side cache, warmed outside the trace
    jax_geometry.pairwise_point_sim(4, 4, 1.0, 2.0)
    variables = jax.jit(lambda key, x: predictor.init(key, x, method="init_full"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))
    )
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    # nonzero GNN fc bias: per-sample pooling must be exact, not rescaled
    params["matcher"]["gnn"]["fc"]["bias"] = (
        np.random.default_rng(7).normal(size=(16,)).astype(np.float32)
    )
    buffers = jax.tree_util.tree_map(np.asarray, dict(variables["buffers"]))
    return predictor, params, buffers


def _torch_predictor(params, buffers):
    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    model.load_state_dict(from_jax_params(params, buffers, model), strict=True)
    return model


def test_from_jax_params_round_trip(jax_variables):
    """Every JAX leaf lands in the port, with its layout converted."""
    _, params, buffers = jax_variables
    model = _torch_predictor(params, buffers)
    sd = model.state_dict()
    n_leaves = len(jax.tree_util.tree_leaves(params)) + len(jax.tree_util.tree_leaves(buffers))
    assert len(sd) == n_leaves
    bb = params["backbone"]
    layer = bb["transformer"]["layers_2"]
    pre = "ingredient_backbone.backbone."
    np.testing.assert_array_equal(
        sd[pre + "transformer.layers.2.attention.linear_qkv.weight"].numpy(),
        layer["attention"]["linear_qkv"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        sd[pre + "patch_embed.proj.weight"].numpy(),
        bb["patch_embed"]["proj"]["kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        sd[pre + "transformer.norm.weight"].numpy(), bb["transformer"]["norm"]["scale"]
    )
    np.testing.assert_array_equal(
        sd["matcher.gnn.embedding"].numpy(), params["matcher"]["gnn"]["embedding"]
    )
    np.testing.assert_array_equal(
        sd["schema_net.class_ingredients"].numpy(),
        buffers["schema_net"]["class_ingredients"],
    )


def test_from_jax_params_rejects_unknown_and_missing(jax_variables):
    _, params, buffers = jax_variables
    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    extra = dict(params, stray={"momentum": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unconsumed"):
        from_jax_params(extra, buffers, model)
    missing = dict(params)
    missing.pop("schema_net")
    with pytest.raises(KeyError, match="unset"):
        from_jax_params(missing, buffers, model)


def test_serve_slice_matches_jax(jax_variables):
    """fp32, graph_precision='highest': VQ ids identical, logits within
    rtol 1e-4 / atol 1e-4 * max|logit|. The two frameworks sum fp32 products
    in different orders (~1e-7 relative per op); through 2 encoder layers, the
    graph build and a 2-layer GNN whose std-1 weights amplify the features,
    that stays under 1e-5 of the logit scale, so 1e-4 leaves a decade."""
    predictor, params, buffers = jax_variables
    images = np.random.default_rng(0).normal(size=(6, 16, 16, 3)).astype(np.float32)

    jax_server = JaxServePredictor(predictor, params, buffers, microbatch=4)
    want = jax_server.predict(images)
    want_ids = np.asarray(
        jax_server._explain(jnp.asarray(images[:4]))["ingredients"]
    ).reshape(4, -1)

    model = _torch_predictor(params, buffers)
    server = TorchServePredictor(model, microbatch=4, device="cpu")
    got = server.predict(images)
    got_ids = model.ingredient_backbone(torch.from_numpy(images[:4]))["ingredients"].numpy()

    np.testing.assert_array_equal(got_ids, want_ids)
    assert got.shape == want.shape == (6, K)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_array_equal(server.predict_labels(images), want.argmax(-1))


def _seeded_predictor():
    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    init_parameters_(model, torch.Generator().manual_seed(0))
    return model


def _trainer(model):
    train_cfg = {
        "optimizer": {"name": "AdamW", "lr": 0.001, "weight_decay": 0.05},
        "param_groups": [{"pattern": "schema_net", "cfg": {"weight_decay": 0.0005}},
                         {"pattern": "matcher"}],
        "drop_remain": True,
        "lr_schedule": {"name": "cosine_annealing", "T_max": 50, "eta_min": 1.0e-05},
        "train_epochs": 50,
    }
    return Trainer(TrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN), model,
                   get_loss_fn({"name": "schema_inference_loss"}),
                   {"cls": 1.0, "re_entropy_vertex": 0.5, "re_entropy_edge": 0.75},
                   steps_per_epoch=10, device="cpu")


def test_serving_leaves_the_callers_model_as_it_was():
    """A model wrapped by ServePredictor and used to serve keeps its config,
    its matcher's pooling and its training mode; a training step of it then
    gives exactly the loss and gradients of an identical model never wrapped
    (training pools by the batch max, serving by each sample's count)."""
    rng = np.random.default_rng(3)
    images = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(rng.integers(0, K, size=6))}
    wrapped, never = _seeded_predictor(), _seeded_predictor()
    cfg = wrapped.cfg
    assert wrapped.training and not cfg.per_sample_pooling
    server = TorchServePredictor(wrapped, microbatch=4, device="cpu")
    assert np.isfinite(server.predict(images)).all()
    assert wrapped.cfg == cfg and not wrapped.cfg.per_sample_pooling
    assert not wrapped.matcher.per_sample_pooling
    assert wrapped.training
    # the batch's live-slot counts differ, so the two poolings give other logits
    with torch.no_grad():
        by_max = never(batch["image"])["pred"]
        by_sample = never(batch["image"], per_sample_pooling=True)["pred"]
    assert not torch.equal(by_max, by_sample)
    torch.testing.assert_close(server.predict_tensor(batch["image"]), by_sample, rtol=0, atol=0)

    losses = [float(_trainer(m).train_iter(batch)["loss"]) for m in (wrapped, never)]
    assert losses[0] == losses[1]
    grads = [{n: p.grad for n, p in m.named_parameters() if p.requires_grad}
             for m in (wrapped, never)]
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def test_serve_batch_invariance():
    """predict(x[:n]) equals predict(x)[:n]: the last microbatch is padded by
    repeating its final image, and pooling is per sample."""
    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    init_parameters_(model, torch.Generator().manual_seed(0))
    server = TorchServePredictor(model, microbatch=4, device="cpu")
    images = np.random.default_rng(1).normal(size=(7, 16, 16, 3)).astype(np.float32)
    full = server.predict(images)
    assert full.shape == (7, K) and np.isfinite(full).all()
    np.testing.assert_allclose(server.predict(images[5:6]), full[5:6], rtol=1e-5, atol=1e-5)
