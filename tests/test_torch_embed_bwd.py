"""The port's embedding-table gradient (plain version, CPU) and the GNN's
``embed_lookup`` backward against the JAX package's Pallas ``embed_grad`` in
interpret mode.

fp32: rtol 1e-5 / atol 1e-6 (fp32 summation order only; many duplicate ids).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.ops.kernels import embed_bwd as ek
from schemanet_torch.schema.gnn import embed_lookup
from schemanet_tpu.ops.pallas.embed_bwd import embed_grad as jax_embed_grad

NUM_ROWS, D = 33, 128  # the Pallas kernel takes D in multiples of 128


def _inputs(rng, shape=(6, 50)):
    ids = rng.integers(0, NUM_ROWS, size=shape).astype(np.int32)
    ids[0, :20] = 5  # one id many times over
    g = rng.normal(size=(*shape, D)).astype(np.float32)
    return ids, g


def test_embed_grad_reference_matches_jax():
    ids, g = _inputs(np.random.default_rng(0))
    want = np.asarray(jax_embed_grad(jnp.asarray(ids), jnp.asarray(g), NUM_ROWS, True))
    got = ek.embed_grad(torch.from_numpy(ids), torch.from_numpy(g), NUM_ROWS)
    assert got.dtype == torch.float32 and got.shape == (NUM_ROWS, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_embed_grad_reference_chunks_match_jax(monkeypatch):
    """The plain version's fixed chunks of rows (cut to 64 here, so the 300
    rows take five chunks, one of them partial) add up to JAX's sum."""
    monkeypatch.setattr(ek, "_SUM_CHUNK", 64)
    ids, g = _inputs(np.random.default_rng(5))
    want = np.asarray(jax_embed_grad(jnp.asarray(ids), jnp.asarray(g), NUM_ROWS, True))
    got = ek.embed_grad_reference(torch.from_numpy(ids), torch.from_numpy(g), NUM_ROWS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    again = ek.embed_grad_reference(torch.from_numpy(ids), torch.from_numpy(g), NUM_ROWS)
    assert torch.equal(got, again)


def test_embed_lookup_backward_matches_jax():
    ids, g = _inputs(np.random.default_rng(1), shape=(4, 9, 10))
    table = torch.from_numpy(
        np.random.default_rng(2).normal(size=(NUM_ROWS, D)).astype(np.float32)
    ).requires_grad_()
    out = embed_lookup(table, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), table.detach().numpy()[ids])
    out.backward(torch.from_numpy(g))
    want = np.asarray(jax_embed_grad(jnp.asarray(ids), jnp.asarray(g), NUM_ROWS, True))
    np.testing.assert_allclose(table.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_embed_lookup_backward_accumulates_bf16_in_fp32():
    """4,096 lookups of one id in bf16: one addend of 1 and 4,095 of 2^-10.
    Summed in bf16 every small addend is below half an ulp of the running sum
    (2^-8 at 1) and vanishes, leaving 1; summed in fp32 and rounded once, as
    the JAX package does, the gradient is 1 + 4095 / 1024 = 4.999 -> 5.0."""
    ids = torch.zeros(4096, dtype=torch.int32)
    g = torch.full((4096, 2), 2.0**-10, dtype=torch.bfloat16)
    g[0] = 1.0
    table = torch.zeros(3, 2, requires_grad=True)
    embed_lookup(table.to(torch.bfloat16), ids).backward(g)
    want = float(torch.tensor(1.0 + 4095 * 2.0**-10).to(torch.bfloat16))
    assert want == 5.0
    np.testing.assert_array_equal(table.grad.numpy(), [[want, want], [0, 0], [0, 0]])


def test_embed_grad_refuses_non_cuda_devices():
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ek.embed_grad(ids, torch.empty(4, 8, device="meta"), 3)


# ids of the plan tests: (ids, num_rows). A long segment (one id for 4,096
# rows), ids that no row takes, one table row, the class graphs' layout
# (every code once per class), and a table too large for 16-bit sort keys,
# each beside uniform ids
PLAN_CASES = {
    "uniform": (np.random.default_rng(3).integers(0, 40, size=(7, 30)), 40),
    "long_segment": (np.concatenate([np.zeros(4096, int), np.arange(300) % 9]), 9),
    "unused_ids": (np.random.default_rng(4).integers(0, 6, size=500) * 3, 17),
    "one_row": (np.zeros((3, 11), int), 1),
    "class_graphs": (np.tile(np.arange(64), (5, 1)), 65),
    "large_table": (np.random.default_rng(6).integers(0, 40_000, size=300), 40_000),  # 32-bit keys
}


def _chunked_sum(plan, g, chunk=ek._CHUNK, warps=8):
    """The CUDA kernels' order of addition, emulated in fp64 from a plan
    (csrc/embed_bwd.cu): runs of one id inside a chunk of ``chunk`` sorted
    positions, written whole or as one partial a chunk (slot 0 for the
    chunk's first run, 1 for its last); then every id that crossed a chunk
    edge summed from its partials by the combine's slot rule. Returns the
    table and how many times each row was written."""
    sorted_ids = plan.sorted_ids.long().tolist()
    rows, order = len(sorted_ids), plan.order.tolist()
    gd = g.reshape(rows, -1).double()
    out = torch.zeros(plan.num_rows, gd.shape[1], dtype=torch.float64)
    writes = [0] * plan.num_rows
    part = {}
    for s0 in range(0, rows, chunk):
        s1 = min(s0 + chunk, rows)
        before = sorted_ids[s0 - 1] if s0 else -1
        after = sorted_ids[s1] if s1 < rows else -1
        a = s0
        while a < s1:
            m, b = sorted_ids[a], a
            while b < s1 and sorted_ids[b] == m:
                b += 1
            acc = sum(gd[order[p]] for p in range(a, b))
            if (a > s0 or m != before) and (b < s1 or m != after):
                out[m] = acc
                writes[m] += 1
            else:
                part[(s0 // chunk, 0 if a == s0 else 1)] = acc
            a = b
    offsets = plan.offsets.tolist()
    for m in range(plan.num_rows):
        a, b = offsets[m], offsets[m + 1]
        if a == b:
            writes[m] += 1  # written as 0
            continue
        ca, cb = a // chunk, (b - 1) // chunk
        if ca == cb:
            continue
        per = -(-(cb - ca + 1) // warps)
        slices = [sum(part[(c, 1 if c == ca and a != ca * chunk else 0)]
                      for c in range(ca + w * per, min(cb + 1, ca + (w + 1) * per)))
                  for w in range(warps)]
        out[m] = sum(slices)
        writes[m] += 1
    return out, writes


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_sort_ids_plan(case):
    """The plan: a stable sort (each id's rows in row order), and offsets
    equal to ``torch.searchsorted`` of every id in [0, num_rows]."""
    ids_np, num_rows = PLAN_CASES[case]
    ids = torch.from_numpy(ids_np.astype(np.int32))
    plan = ek.sort_ids(ids, num_rows)
    flat = ids.reshape(-1)
    assert plan.num_rows == num_rows and plan.sorted_ids.dtype == torch.int32
    assert torch.equal(flat[plan.order], plan.sorted_ids)
    assert torch.equal(plan.sorted_ids, torch.sort(flat).values)
    for m in range(num_rows):  # stable: each id's rows ascending
        rows_m = plan.order[plan.sorted_ids == m]
        assert torch.equal(rows_m, torch.sort(rows_m).values)
    want = torch.searchsorted(plan.sorted_ids, torch.arange(num_rows + 1, dtype=torch.int32))
    assert plan.offsets.dtype == torch.int32 and torch.equal(plan.offsets.long(), want)


# the Pallas embed_grad takes no table of 40,000 rows
@pytest.mark.parametrize("case", [c for c in PLAN_CASES if c != "large_table"])
def test_chunked_order_matches_jax(case):
    """The kernels' chunks and combine, emulated from the plan in fp64, give
    the JAX sum, and write every table row exactly once: unused ids as exact
    zeros. Tolerance 1e-5 of max |sum|: JAX adds up to 4,096 addends in fp32."""
    ids_np, num_rows = PLAN_CASES[case]
    ids = ids_np.astype(np.int32)
    g = np.random.default_rng(7).normal(size=(*ids.shape, 128)).astype(np.float32)
    plan = ek.sort_ids(torch.from_numpy(ids), num_rows)
    got, writes = _chunked_sum(plan, torch.from_numpy(g))
    assert writes == [1] * num_rows
    want = np.asarray(jax_embed_grad(jnp.asarray(ids), jnp.asarray(g), num_rows, True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    unused = np.setdiff1d(np.arange(num_rows), ids)
    assert not got[torch.from_numpy(unused)].any()


@pytest.mark.parametrize("bad", [-1, 7, 2**15 + 3])
def test_sort_ids_rejects_ids_out_of_range(bad):
    ids = torch.tensor([0, 3, bad, 1], dtype=torch.int32)
    with pytest.raises(IndexError, match="ids must lie"):
        ek.sort_ids(ids, 7)
    with pytest.raises(TypeError):
        ek.sort_ids(ids.long(), 7)


def test_planned_ids_reuse_and_rebuild():
    """A plan is kept while the buffer is unchanged and rebuilt after an
    in-place write, for another tensor, and for another table size; an id
    written out of range raises at the rebuild."""
    buf = torch.arange(12, dtype=torch.int32).repeat(3)
    cache = ek.PlannedIds()
    first = cache.plan(buf, 13)
    assert cache.plan(buf, 13) is first
    buf[:4] = 11  # in place: the version counter moves
    second = cache.plan(buf, 13)
    assert second is not first
    assert torch.equal(second.offsets.long(),
                       torch.searchsorted(torch.sort(buf).values, torch.arange(14)))
    assert cache.plan(buf.clone(), 13) is not second
    assert cache.plan(buf, 14).num_rows == 14
    buf[0] = 13
    with pytest.raises(IndexError):
        cache.plan(buf, 13)
