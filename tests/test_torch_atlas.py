"""The port's atlas getters and projection against the JAX package's, on the
CPU in fp32.

The getters' gradients must match too: the JAX package detaches the row sum
(``normalize_sum_clamp(..., detach_sum=True)``) and ``jnp.maximum`` splits
the gradient of a tie with the clamp value in halves; projected rows hold
exact zeros, so both show. atol 1e-6 (values of order 1/V).

One deliberate difference: an edge row that clamps to all zeros (a pruned
vertex's row, or a row projected to zero) normalises to 0, and the JAX
package's gradient there is NaN (0/0 under ``where``); the port's is 0, the
gradient of the constant 0 the row holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.schema.atlas import AtlasConfig, SchemaAtlas
from schemanet_tpu.schema.atlas import AtlasConfig as JaxAtlasConfig
from schemanet_tpu.schema.atlas import SchemaAtlas as JaxSchemaAtlas
from schemanet_tpu.schema.atlas import project_atlas_params as jax_project_atlas_params

K, V = 3, 8
ATLAS_CFG = dict(num_vertices=V, num_classes=K, prune_node_threshold=0.05,
                 remove_self_loop=True)


def _params(rng):
    vw = rng.uniform(-0.2, 1.0, size=(K, V)).astype(np.float32)
    ew = rng.uniform(-0.2, 1.0, size=(K, V, V)).astype(np.float32)
    ew[1, 2] = -1.0  # a row that projects to zero
    return {"vertex_weights": vw, "edge_weights": ew,
            "vertex_attribute_weights": np.array([[0.001], [20.0]], np.float32),
            "edge_attribute_weights": np.array([[0.5], [-3.0]], np.float32)}


def _port_atlas(params):
    atlas = SchemaAtlas(AtlasConfig(**ATLAS_CFG))
    with torch.no_grad():
        for name, value in params.items():
            getattr(atlas, name).copy_(torch.from_numpy(np.array(value)))
    return atlas


def test_project_atlas_params_matches_jax():
    from schemanet_torch.schema.atlas import project_atlas_params

    params = _params(np.random.default_rng(0))
    want = jax_project_atlas_params({k: jnp.asarray(v) for k, v in params.items()},
                                    JaxAtlasConfig(**ATLAS_CFG))
    atlas = project_atlas_params(_port_atlas(params))
    for name, value in want.items():
        np.testing.assert_allclose(getattr(atlas, name).detach().numpy(), np.asarray(value),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("getter", ["get_class_vertices", "get_class_edges"])
def test_getter_values_and_gradients_match_jax(getter):
    """Fed projected parameters, as training feeds them."""
    rng = np.random.default_rng(1)
    params = {k: np.asarray(v) for k, v in jax_project_atlas_params(
        {k: jnp.asarray(v) for k, v in _params(rng).items()}, JaxAtlasConfig(**ATLAS_CFG)).items()}
    assert (params["edge_weights"] == 0).any()  # ties with the clamp value
    shape = (K, V) if getter == "get_class_vertices" else (K, V, V)
    cot = rng.normal(size=shape).astype(np.float32)
    module = JaxSchemaAtlas(JaxAtlasConfig(**ATLAS_CFG))
    buffers = {"class_ingredients": jnp.broadcast_to(jnp.arange(V, dtype=jnp.int32), (K, V))}

    def jax_fn(p):
        out = module.apply({"params": p, "buffers": buffers}, method=getattr(JaxSchemaAtlas, getter))
        return jnp.sum(out * cot), out

    (_, want), want_grad = jax.value_and_grad(jax_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})
    atlas = _port_atlas(params)
    out = getattr(atlas, getter)()
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for name in ("vertex_weights", "edge_weights"):
        grad = getattr(atlas, name).grad
        want_g = np.asarray(want_grad[name])
        got_g = np.zeros_like(want_g) if grad is None else grad.numpy()
        assert np.isfinite(got_g).all(), name
        if getter == "get_class_edges" and name == "edge_weights":
            pruned = np.isnan(want_g)
            assert pruned.any()  # the JAX package's NaN rows are there, and are 0 here
            assert not got_g[pruned].any()
            want_g = np.where(pruned, 0.0, want_g)
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-6, err_msg=name)
