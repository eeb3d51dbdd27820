"""The port's fused AdamW + atlas projection (plain version, CPU) against the
JAX package's Pallas ``adamw_project_rows`` in interpret mode, and against
``optax.adamw`` followed by the JAX ``project_atlas_params``.

rtol 1e-5 with a small atol on all three of p, m and v over 3 steps: the same
fp32 element-wise arithmetic, only the row sums add in another order.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from schemanet_torch.ops.kernels import atlas_opt as ao
from schemanet_tpu.ops.pallas.atlas_opt import adamw_project_rows as jax_adamw_project_rows
from schemanet_tpu.schema.atlas import AtlasConfig, project_atlas_params

HYPERS = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def _start(shape, rng):
    p = rng.normal(0.5, 0.2, size=shape).astype(np.float32)
    p[0, 0] = -1.0  # a row that projects to all zeros
    return p


def _project(p, remove_self_loop):
    cfg = AtlasConfig(num_vertices=p.shape[-1], num_classes=p.shape[0],
                      remove_self_loop=remove_self_loop)
    params = {"vertex_weights": jnp.zeros((1, 1)), "edge_weights": jnp.asarray(p),
              "vertex_attribute_weights": jnp.ones((2, 1)),
              "edge_attribute_weights": jnp.ones((2, 1))}
    return np.asarray(project_atlas_params(params, cfg)["edge_weights"])


@pytest.mark.parametrize("remove_self_loop", [False, True])
def test_matches_jax_kernel_and_optax_plus_projection(remove_self_loop):
    rng = np.random.default_rng(3)
    shape = (4, 24, 24)
    p0 = _project(_start(shape, rng), remove_self_loop)
    assert not p0[0, 0].any()
    p_t = torch.from_numpy(p0.copy())
    m_t, v_t = torch.zeros(shape), torch.zeros(shape)
    p_j, m_j, v_j = jnp.asarray(p0), jnp.zeros(shape), jnp.zeros(shape)
    tx = optax.adamw(HYPERS["lr"], b1=HYPERS["b1"], b2=HYPERS["b2"], eps=HYPERS["eps"],
                     weight_decay=HYPERS["weight_decay"])
    p_o, state = p0, tx.init(jnp.asarray(p0))
    for step in range(3):
        g = rng.normal(0.0, 0.05, size=shape).astype(np.float32)
        out = ao.adamw_project_rows(p_t, torch.from_numpy(g), m_t, v_t, step,
                                    remove_self_loop=remove_self_loop, **HYPERS)
        assert out[0] is p_t and out[1] is m_t and out[2] is v_t  # in place
        p_j, m_j, v_j = jax_adamw_project_rows(
            p_j, jnp.asarray(g), m_j, v_j, jnp.asarray(step, jnp.int32),
            remove_self_loop=remove_self_loop, interpret=True, **HYPERS)
        updates, state = tx.update(jnp.asarray(g), state, jnp.asarray(p_o))
        p_o = _project(np.asarray(optax.apply_updates(jnp.asarray(p_o), updates)),
                       remove_self_loop)
        for got, want in ((p_t, p_j), (m_t, m_j), (v_t, v_j), (p_t, p_o),
                          (m_t, state[0].mu), (v_t, state[0].nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9,
                                       err_msg=f"step {step}")
    if remove_self_loop:
        assert not torch.diagonal(p_t, dim1=-2, dim2=-1).any()


def test_all_zero_row_maps_to_zero():
    """A row driven entirely negative projects to 0/0, which maps to 0."""
    p = np.array([[-1.0, -2.0, -3.0, -4.0], [1.0, 1.0, 1.0, 1.0]], np.float32)
    z = np.zeros_like(p)
    want = jax_adamw_project_rows(jnp.asarray(p), z, z, z, jnp.asarray(0, jnp.int32), lr=0.0,
                                  weight_decay=0.0, interpret=True)[0]
    got = ao.adamw_project_rows(torch.from_numpy(p), *(torch.from_numpy(z.copy()) for _ in range(3)),
                                0, lr=0.0, weight_decay=0.0)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[0, 0, 0, 0], [0.25, 0.25, 0.25, 0.25]])


def test_vertex_rows_without_projection_are_plain_adamw():
    rng = np.random.default_rng(4)
    p0 = rng.random((5, 16), np.float32)
    g = rng.normal(size=(5, 16)).astype(np.float32)
    p_t = torch.from_numpy(p0.copy())
    ao.adamw_project_rows(p_t, torch.from_numpy(g), torch.zeros(5, 16), torch.zeros(5, 16), 0,
                          project=False, **HYPERS)
    tx = optax.adamw(HYPERS["lr"], weight_decay=HYPERS["weight_decay"])
    updates, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(p0)), jnp.asarray(p0))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(optax.apply_updates(jnp.asarray(p0), updates)),
                               rtol=1e-6, atol=1e-9)


def test_remove_self_loop_needs_square_blocks():
    z = torch.zeros(3, 4, 5)
    with pytest.raises(ValueError, match="V, V"):
        ao.adamw_project_rows(z, z, z, z, 0, lr=1e-3, remove_self_loop=True)
