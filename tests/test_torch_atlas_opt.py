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


@pytest.mark.parametrize("remove_self_loop", [False, True])
def test_bf16_moments_match_jax_adamw_lowmem_plus_projection(remove_self_loop):
    """bf16 m and v (a group with ``moment_dtype`` and ``nu_dtype`` bfloat16,
    as the ImageNet stage-4 YAML's schema_net group): the plain version
    against the JAX ``adamw_lowmem`` followed by ``project_atlas_params``,
    which is what the JAX package runs for such a group. 3 steps: p within
    1e-5 relative (the kernel's bias corrections as reciprocals, the row
    sums in another order), m and v within one bf16 ulp of JAX's (a last-bit
    fp32 difference in the update can flip a rounding), stored in bf16."""
    _bf16_moments_against_adamw_lowmem((4, 24, 24), remove_self_loop, seed=5)


# ImageNet's atlas width (V_max = 500): vertex rows [K, V], and edge rows
# [K, V, V] with their self loops removed, a few classes of each
@pytest.mark.parametrize("shape,remove_self_loop", [((6, 500), False), ((2, 500, 500), True)])
def test_bf16_moments_at_500_columns_match_jax_adamw_lowmem(shape, remove_self_loop):
    """The same rule as above at the row width of the ImageNet atlas, whose
    kernel route takes the rows in pieces of 4 columns. Each step starts
    from JAX's state: over 10^5-10^6 elements a few stored moments differ by
    their one ulp, and a later step carries that into p; within a step p
    uses the step's fp32 moments, so it holds 1e-5."""
    _bf16_moments_against_adamw_lowmem(shape, remove_self_loop, seed=7, resync=True)


def test_matches_jax_kernel_at_500_columns():
    """fp32 moments at 500 columns: the plain version against the JAX Pallas
    kernel in interpret mode, 2 steps, p, m, v within 1e-5."""
    rng = np.random.default_rng(8)
    shape = (6, 500)
    p0 = _project(_start(shape, rng)[None], False)[0]
    p_t, m_t, v_t = torch.from_numpy(p0.copy()), torch.zeros(shape), torch.zeros(shape)
    p_j, m_j, v_j = jnp.asarray(p0), jnp.zeros(shape), jnp.zeros(shape)
    for step in range(2):
        g = rng.normal(0.0, 0.05, size=shape).astype(np.float32)
        ao.adamw_project_rows(p_t, torch.from_numpy(g), m_t, v_t, step, **HYPERS)
        p_j, m_j, v_j = jax_adamw_project_rows(p_j, jnp.asarray(g), m_j, v_j,
                                               jnp.asarray(step, jnp.int32), interpret=True,
                                               **HYPERS)
        for got, want in ((p_t, p_j), (m_t, m_j), (v_t, v_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9,
                                       err_msg=f"step {step}")


F32, BF = torch.float32, torch.bfloat16


# (rows, C, m and v dtypes, byte offsets of p, g, m, v) -> route, bytes of a
# piece of p, g, m, v, pieces a lane: every atlas width the configs name
# (ImageNet V = 500, CIFAR V = 1024, as edge [K V, V] and vertex [K, V]
# rows), the scalar route of a width that is not a multiple of 4 (70) and
# of bases at 8- and 4-byte offsets, and the block route past 1024
@pytest.mark.parametrize("rows,c,mdt,offsets,route,piece,per", [
    (500_000, 500, BF, (0, 0, 0, 0), "vector", (16, 16, 8, 8), 4),
    (1000, 500, BF, (0, 0, 0, 0), "vector", (16, 16, 8, 8), 4),
    (102_400, 1024, F32, (0, 0, 0, 0), "vector", (16, 16, 16, 16), 8),
    (100, 1024, F32, (0, 0, 0, 0), "vector", (16, 16, 16, 16), 8),
    (12_800, 128, F32, (0, 0, 0, 0), "vector", (16, 16, 16, 16), 4),
    (10, 500, BF, (0, 0, 8, 8), "vector", (16, 16, 8, 8), 4),
    (10, 500, F32, (0, 0, 8, 0), "scalar", (4, 4, 4, 4), 16),
    (10, 500, BF, (0, 0, 4, 0), "scalar", (4, 4, 2, 2), 16),
    (10, 500, F32, (4, 0, 0, 0), "scalar", (4, 4, 4, 4), 16),
    (10, 1000, BF, (0, 16, 0, 8), "vector", (16, 16, 8, 8), 8),
    (10, 70, F32, (0, 0, 0, 0), "scalar", (4, 4, 4, 4), 16),
    (1, 513, BF, (0, 0, 0, 0), "scalar", (4, 4, 2, 2), 32),
    (10, 4096, F32, (0, 0, 0, 0), "block", (4, 4, 4, 4), None),
])
def test_adamw_plan(rows, c, mdt, offsets, route, piece, per):
    """The kernel's route and pieces from C and the pointers (csrc/
    atlas_opt.cu adamw_project_rows_launch): four columns a piece where C
    is a multiple of 4 and p, g and fp32 moments are 16-byte aligned, bf16
    moments 8-byte; one otherwise; a block a row past 1024 columns. The
    warp routes take a row a warp, 8 a block."""
    base = 1 << 20
    plan = ao.adamw_plan(rows, c, mdt, mdt, *(base + o for o in offsets))
    assert plan.route == route
    assert tuple(plan.piece_bytes[k] for k in "pgmv") == piece
    assert plan.pieces_per_lane == per
    if route == "block":
        assert plan.blocks == rows
    else:
        assert plan.values_per_lane * 32 >= c  # the lanes of a warp cover the row
        assert plan.blocks == -(-rows // 8)


def test_adamw_plan_rejects_what_no_route_takes():
    with pytest.raises(ValueError, match="columns"):
        ao.adamw_plan(4, 4097)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ao.adamw_plan(4, 16, torch.float16)


def _bf16_moments_against_adamw_lowmem(shape, remove_self_loop, seed, resync=False):
    from schemanet_tpu.train.common import adamw_lowmem

    rng = np.random.default_rng(seed)
    p0 = _project(_start(shape, rng), remove_self_loop)
    p_t = torch.from_numpy(p0.copy())
    m_t = torch.zeros(shape, dtype=torch.bfloat16)
    v_t = torch.zeros(shape, dtype=torch.bfloat16)
    tx = adamw_lowmem(HYPERS["lr"], b1=HYPERS["b1"], b2=HYPERS["b2"], eps=HYPERS["eps"],
                      weight_decay=HYPERS["weight_decay"], mu_dtype=jnp.bfloat16,
                      nu_dtype=jnp.bfloat16)
    p_o, state = p0, tx.init(jnp.asarray(p0))
    for step in range(3):
        g = rng.normal(0.0, 0.05, size=shape).astype(np.float32)
        if resync and step:
            p_t.copy_(torch.from_numpy(np.asarray(p_o)))
            for t, j in ((m_t, state[0].mu), (v_t, state[0].nu["full"])):
                t.copy_(torch.from_numpy(np.asarray(j.astype(jnp.float32))))
        ao.adamw_project_rows(p_t, torch.from_numpy(g), m_t, v_t, step,
                              remove_self_loop=remove_self_loop, **HYPERS)
        updates, state = tx.update(jnp.asarray(g), state, jnp.asarray(p_o))
        p_o = _project(np.asarray(optax.apply_updates(jnp.asarray(p_o), updates)),
                       remove_self_loop)
        np.testing.assert_allclose(p_t.numpy(), p_o, rtol=1e-5, atol=1e-9, err_msg=f"step {step}")
        adam = state[0]
        for got, want in ((m_t, adam.mu), (v_t, adam.nu["full"])):
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            w = np.asarray(want.astype(jnp.float32))
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), np.finfo(np.float32).tiny))) - 7)
            assert (np.abs(got.float().numpy() - w) <= ulp).all(), f"step {step}"
    if remove_self_loop:
        assert not torch.diagonal(p_t, dim1=-2, dim2=-1).any()
