"""The port's graph building and VQ against ``schemanet_tpu.ops`` and the
loop-based oracle in tests/oracle.py, on the same numpy inputs.

fp32 ('highest'): slot codes and order exact; weights within rtol 1e-5 of the
JAX ops (fp32 summation order) and 1e-4 of the float64 oracle (as
tests/test_graph_ops.py). bf16 ('default'): the one-hot contractions are exact
and only attention and geometry round to bf16, so 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch import ops
from schemanet_tpu import ops as jops
from tests import oracle

BS, L, V = 4, 24, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    ingredients = rng.integers(0, V, size=(BS, L)).astype(np.int32)
    attn_cls = rng.normal(size=(BS, L)).astype(np.float32)
    attn = rng.normal(size=(BS, L, L)).astype(np.float32)
    w_v = rng.uniform(0.1, 1.0, size=(2, 1)).astype(np.float32)
    w_e = rng.uniform(0.1, 1.0, size=(2, 1)).astype(np.float32)
    return ingredients, attn_cls, attn, w_v, w_e


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def test_compact_instance_slots_exact():
    ingredients = _inputs(0)[0]
    ingredients[0, :] = 3  # one distinct code
    ingredients[1, :] = np.arange(L) % V  # every code, in order
    got = ops.compact_instance_slots(torch.from_numpy(ingredients), num_codes=V)
    want = jops.compact_instance_slots(jnp.asarray(ingredients), num_codes=V)
    for name in ("codes", "pos_to_slot", "num_slots", "mask"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    for b in range(BS):  # ascending distinct codes, as the C++ std::map iterates
        n = int(got.num_slots[b])
        np.testing.assert_array_equal(got.codes[b, :n].numpy(), np.unique(ingredients[b]))
        assert (got.codes[b, n:] == V).all()


@pytest.mark.parametrize("clamp", [None, -1.0])
def test_instance_vertices(clamp):
    ingredients, attn_cls, _, w_v, _ = _inputs(1)
    slots = ops.compact_instance_slots(torch.from_numpy(ingredients), num_codes=V)
    got = ops.instance_vertices(slots, torch.from_numpy(attn_cls), torch.from_numpy(w_v), clamp)
    jslots = jops.compact_instance_slots(jnp.asarray(ingredients), num_codes=V)
    want = jops.instance_vertices(jslots, jnp.asarray(attn_cls), jnp.asarray(w_v), clamp)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    _, weights_ref = oracle.feat_to_instance_v_oracle(ingredients, attn_cls, w_v, clamp)
    for b in range(BS):
        n = len(weights_ref[b])
        np.testing.assert_allclose(_np(got)[b, :n], weights_ref[b], rtol=1e-4, atol=1e-6)
        assert (_np(got)[b, n:] == 0).all()


@pytest.mark.parametrize("clamp,self_loop", [(None, False), (-1.0, True)])
def test_instance_edges(clamp, self_loop):
    ingredients, _, attn, _, w_e = _inputs(2)
    geo = ops.pairwise_point_sim(4, 6)
    np.testing.assert_allclose(
        geo.numpy(), oracle.pairwise_point_sim_oracle(4, 6), rtol=1e-6, atol=1e-7
    )
    slots = ops.compact_instance_slots(torch.from_numpy(ingredients), num_codes=V)
    got = _np(ops.instance_edges(slots, torch.from_numpy(attn), geo, torch.from_numpy(w_e),
                                 clamp_edge_attn=clamp, remove_self_loop=self_loop))
    jslots = jops.compact_instance_slots(jnp.asarray(ingredients), num_codes=V)
    want = jops.instance_edges(
        jslots, jnp.asarray(attn), jnp.asarray(geo.numpy()), jnp.asarray(w_e),
        clamp_edge_attn=clamp, remove_self_loop=self_loop,
    )
    np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-6)
    ref = oracle.feat_to_instance_e_oracle(
        ingredients, attn, geo.numpy(), w_e, clamp, remove_self_loop=self_loop
    )
    for b in range(BS):
        n = ref[b].shape[0]
        np.testing.assert_allclose(got[b, :n, :n], ref[b], rtol=1e-4, atol=1e-6)
        assert (got[b, n:] == 0).all() and (got[b, :, n:] == 0).all()


def test_graph_ops_bf16_default_precision():
    ingredients, attn_cls, attn, w_v, w_e = _inputs(3)
    geo = ops.pairwise_point_sim(4, 6)
    slots = ops.compact_instance_slots(torch.from_numpy(ingredients), num_codes=V)
    jslots = jops.compact_instance_slots(jnp.asarray(ingredients), num_codes=V)
    verts = ops.instance_vertices(slots, torch.from_numpy(attn_cls), torch.from_numpy(w_v),
                                  -1.0, precision="default")
    jverts = jops.instance_vertices(jslots, jnp.asarray(attn_cls), jnp.asarray(w_v), -1.0,
                                    precision="default")
    edges = ops.instance_edges(slots, torch.from_numpy(attn), geo, torch.from_numpy(w_e),
                               clamp_edge_attn=-1.0, precision="default")
    jedges = jops.instance_edges(jslots, jnp.asarray(attn), jnp.asarray(geo.numpy()),
                                 jnp.asarray(w_e), clamp_edge_attn=-1.0, precision="default")
    assert verts.dtype == edges.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(verts), _np(jverts), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(edges), _np(jedges), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vq_assign_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 50, 8)).astype(np.float32)
    cb = rng.normal(size=(12, 8)).astype(np.float32)
    cb[5] = cb[3]  # an exact tie: the first minimum wins in both
    x[0, 0] = cb[3]
    got = ops.vq_assign(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(cb))
    want = jops.vq_assign(jnp.asarray(x, dtype), jnp.asarray(cb), backend="xla")
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0]) == 3
    q, ids = ops.vq_encode(torch.from_numpy(x), torch.from_numpy(cb))
    np.testing.assert_array_equal(q.numpy(), cb[ids.numpy()])
