"""The port's stage-3 graph functions against the JAX package, on the CPU:
``vertex_attributes_full`` (NaN attention included), ``feat_to_full_vertices``
and ``class_limited_edges`` (with and without ``remove_self_loop``), on the
same numpy inputs, within 1e-5 (fp32; the one-hot products add the same
terms in another order). NaNs must sit at the same places."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.ops import geometry, graph
from schemanet_tpu.ops import geometry as jax_geometry
from schemanet_tpu.ops import graph as jax_graph

BS, H, W, V, K, V_MAX = 3, 4, 4, 20, 4, 12
L = H * W


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ingredients = rng.integers(0, V, size=(BS, L)).astype(np.int32)
    attn = rng.normal(size=(BS, L, L)).astype(np.float32)
    attn_cls = rng.normal(size=(BS, L)).astype(np.float32)
    labels = rng.integers(0, K, size=BS).astype(np.int32)
    class_ingredients = np.stack([rng.permutation(V)[:V_MAX] for _ in range(K)]).astype(np.int32)
    w = rng.random((2, 1)).astype(np.float32)
    return ingredients, attn, attn_cls, labels, class_ingredients, w


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_vertex_attributes_full_matches_jax_with_nan_attention():
    ingredients, _, attn_cls, *_ = _inputs()
    probs = np.exp(attn_cls) / np.exp(attn_cls).sum(axis=1, keepdims=True)
    probs[0, 3] = np.nan  # the code at position 3 keeps a NaN attention attribute
    probs[2] = np.nan  # an all-masked row
    want = jax_graph.vertex_attributes_full(jnp.asarray(ingredients), jnp.asarray(probs), V)
    got = graph.vertex_attributes_full(torch.from_numpy(ingredients), torch.from_numpy(probs), V)
    assert got.shape == (BS, V, 2)
    assert np.isnan(got.numpy()).sum() > 0
    _close(got, want)


@pytest.mark.parametrize("clamp", [None, -1.0])
def test_feat_to_full_vertices_matches_jax(clamp):
    ingredients, _, attn_cls, _, _, w = _inputs(1)
    attn_cls[1] = -5.0  # below the clamp everywhere: an all-masked row under clamp -1
    want = jax_graph.feat_to_full_vertices(jnp.asarray(ingredients), jnp.asarray(attn_cls), V,
                                           jnp.asarray(w), clamp)
    got = graph.feat_to_full_vertices(torch.from_numpy(ingredients), torch.from_numpy(attn_cls),
                                      V, torch.from_numpy(w), clamp)
    assert got.shape == (BS, V)
    _close(got, want)


@pytest.mark.parametrize("remove_self_loop", [False, True])
@pytest.mark.parametrize("clamp", [None, -1.0])
def test_class_limited_edges_matches_jax(remove_self_loop, clamp):
    ingredients, attn, _, labels, class_ingredients, w = _inputs(2)
    geo_j = jax_geometry.pairwise_point_sim(H, W, 1.0, 2.0)
    geo_t = geometry.pairwise_point_sim(H, W, 1.0, 2.0)
    want = jax_graph.class_limited_edges(
        jnp.asarray(ingredients), jnp.asarray(attn), geo_j, jnp.asarray(labels),
        jnp.asarray(class_ingredients), jnp.asarray(w), clamp_edge_attn=clamp,
        remove_self_loop=remove_self_loop,
    )
    got = graph.class_limited_edges(
        torch.from_numpy(ingredients), torch.from_numpy(attn), geo_t, torch.from_numpy(labels),
        torch.from_numpy(class_ingredients), torch.from_numpy(w), clamp_edge_attn=clamp,
        remove_self_loop=remove_self_loop,
    )
    assert got.shape == (BS, V_MAX, V_MAX) and got.dtype == torch.float32
    assert float(got.abs().sum()) > 0
    _close(got, want)
