"""The port's evaluation loops (``schemanet_torch/train/evaluator.py``)
against the JAX package's, on the CPU, on the same carried-across weights
(the JAX init loaded into the port through ``from_jax_params``) and the same
seeded fp32 batches, the last one padded (``valid`` 1, 1, 0, 0).

The model: a 2-layer ViT of width 32, patch 4, on 16^2 images; the
SchemaNet predictor over it encodes at layer 0, M=16 codes, K=5 classes,
``graph_precision`` 'highest'. Tolerances: top-1/top-5 counts and the
codebook-agreement counts equal; loss and loss terms within 1e-5 relative
(the two frameworks add fp32 products in other orders, ~1e-7 relative per
op, through a short network).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models.port import from_jax_params
from schemanet_torch.models.vit import get_model as torch_get_model
from schemanet_torch.schema import build_predictor as torch_build_predictor
from schemanet_torch.schema import get_loss_fn as torch_get_loss_fn
from schemanet_torch.train import CBEvaluation, Evaluation, IncEvaluation
from schemanet_tpu.ops import geometry as jax_geometry
from schemanet_tpu.models.vit import get_model as jax_get_model
from schemanet_tpu.schema import build_predictor as jax_build_predictor
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn
from schemanet_tpu.train.evaluator import CBEvaluation as JaxCBEvaluation
from schemanet_tpu.train.evaluator import Evaluation as JaxEvaluation
from schemanet_tpu.train.evaluator import IncEvaluation as JaxIncEvaluation

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
SCHEMA_LOSS = {"name": "schema_inference_loss",
               "weight_dict": {"cls": 1.0, "re_entropy_vertex": 0.5, "re_entropy_edge": 0.75}}
CE_LOSS = {"name": "ce_loss", "weight_dict": {"cls": 1.0}}


def _batches(n_batches=3, valid_last=2, seed=0, labels=(0, K)):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        valid = np.ones(BATCH, np.float32)
        if b == n_batches - 1:
            valid[valid_last:] = 0.0
        out.append({"image": rng.normal(size=(BATCH, 16, 16, 3)).astype(np.float32),
                    "label": rng.integers(*labels, size=BATCH).astype(np.int32),
                    "valid": valid})
    return out


@pytest.fixture(scope="module")
def predictor():
    jax_geometry.pairwise_point_sim(4, 4, 1.0, 2.0)
    jax_model = jax_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    variables = jax.jit(lambda key, x: jax_model.init(key, x, method="init_full"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    buffers = jax.tree_util.tree_map(np.asarray, dict(variables["buffers"]))
    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    model.load_state_dict(from_jax_params(params, buffers, model))
    return jax_model, params, buffers, model.eval()


@pytest.fixture(scope="module")
def vit():
    jax_model = jax_get_model(MODEL_CFG, K)
    params = jax.tree_util.tree_map(np.asarray, jax_model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))["params"])
    model = torch_get_model(MODEL_CFG, K)
    model.load_state_dict(from_jax_params(params, {}, model))
    return jax_model, params, model.eval()


def _counts(result, batches):
    n = sum(float(b["valid"].sum()) for b in batches)
    return {k: round(v * n) for k, v in result["acc"].items()}


def _assert_evaluations_agree(got, want, batches):
    assert _counts(got, batches) == _counts(want, batches)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert sorted(got["loss_dict"]) == sorted(want["loss_dict"])
    for k, v in want["loss_dict"].items():
        np.testing.assert_allclose(got["loss_dict"][k], v, rtol=1e-5, err_msg=k)


def test_evaluation_of_predictor_matches_jax(predictor):
    jax_model, params, buffers, model = predictor
    batches = _batches()

    def apply_fn(p, b, image, train=False):
        return jax_model.apply({"params": p, "buffers": b}, image)

    want = JaxEvaluation(apply_fn, jax_get_loss_fn(SCHEMA_LOSS), SCHEMA_LOSS["weight_dict"],
                         batches, top_k=(1, 5))(params, buffers)
    got = Evaluation(model, torch_get_loss_fn(SCHEMA_LOSS), SCHEMA_LOSS["weight_dict"], batches,
                     top_k=(1, 5), device="cpu")()
    _assert_evaluations_agree(got, want, batches)
    assert got["acc"][5] == 1.0  # K = 5: every label is in the top 5


def test_evaluation_of_vit_matches_jax(vit):
    jax_model, params, model = vit
    batches = _batches(seed=1)

    def apply_fn(p, b, image, train=False):
        return jax_model.apply({"params": p}, image, deterministic=True)

    want = JaxEvaluation(apply_fn, jax_get_loss_fn(CE_LOSS), CE_LOSS["weight_dict"], batches,
                         top_k=(1, 3))(params, {})
    got = Evaluation(model, torch_get_loss_fn(CE_LOSS), CE_LOSS["weight_dict"], batches,
                     top_k=(1, 3), device="cpu")()
    _assert_evaluations_agree(got, want, batches)


def test_cb_evaluation_matches_jax(predictor):
    """The codebook agreement: the frozen ViT's logits with its layer-0 patch
    tokens quantised and not; the logits themselves within 1e-5 of max."""
    jax_model, params, buffers, model = predictor
    batches = _batches(seed=2)

    def classify_fn(p, b, image, quantize):
        return jax_model.apply({"params": p, "buffers": b}, image, quantize,
                               method=lambda m, img, q: m.ingredient_backbone.classify_discretized(
                                   img, q))

    want = JaxCBEvaluation(classify_fn, batches)(params, buffers)
    got = CBEvaluation(model.classify_discretized, batches, device="cpu")()
    n = sum(float(b["valid"].sum()) for b in batches)
    assert {k: round(v * n) for k, v in got.items()} == {k: round(v * n) for k, v in want.items()}
    image = batches[0]["image"]
    for quantize in (True, False):
        w = np.asarray(classify_fn(params, buffers, image, quantize))
        g = model.classify_discretized(torch.from_numpy(image), quantize).numpy()
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    # quantising the mid feature changes the logits
    assert not torch.equal(model.classify_discretized(torch.from_numpy(image), True),
                           model.classify_discretized(torch.from_numpy(image), False))


def test_inc_evaluation_matches_jax(vit):
    """Two tasks of 2 and 3 classes, each its own loader of labels in its range."""
    jax_model, params, model = vit
    loaders = [_batches(2, 3, seed=3, labels=(0, 2)), _batches(2, 1, seed=4, labels=(2, 5))]

    def apply_fn(p, b, image, task):
        return jax_model.apply({"params": p}, image, deterministic=True)

    want = JaxIncEvaluation(apply_fn, loaders, [2, 3])(params, {})
    got = IncEvaluation(lambda image, task: model(image), loaders, [2, 3], device="cpu")()
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=1e-12)
    for task in (0, 1):
        for key in ("acc_task", "acc_all"):
            np.testing.assert_allclose(got["per_task"][task][key], want["per_task"][task][key],
                                       rtol=1e-12)
