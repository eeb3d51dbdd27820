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
