"""The port's VQ assignment against the JAX package, on the CPU.

``vq_assign_reference`` (the plain version of the streaming-argmin kernel)
against ``vq_assign_pallas`` in interpret mode with small tiles in fp32, and
against the JAX ``vq_assign(..., backend="xla")`` in bf16 (the Pallas kernel
casts bf16 to fp32, the port keeps the default path's bf16 codebook). Ids
must be equal: the scores differ only in fp32 summation order, and random
normal data has no near-ties at these sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch import ops
from schemanet_torch.ops.kernels import vq as vqk
from schemanet_tpu.ops.pallas.vq import vq_assign_pallas
from schemanet_tpu.ops.vq import vq_assign as jax_vq_assign


def _data(n, m, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


@pytest.mark.parametrize("n,m,d,tile_n,tile_m", [(100, 64, 32, 32, 16), (257, 130, 16, 64, 32)])
def test_plain_vq_matches_pallas_interpret_fp32(n, m, d, tile_n, tile_m):
    x, cb = _data(n, m, d, n)
    want = np.asarray(vq_assign_pallas(jnp.asarray(x), jnp.asarray(cb), tile_n=tile_n,
                                       tile_m=tile_m, interpret=True))
    got = vqk.vq_assign_reference(torch.from_numpy(x), torch.from_numpy(cb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,m,d", [(100, 64, 32), (257, 130, 16)])
def test_plain_vq_matches_jax_default_path_bf16(n, m, d):
    """bf16 x: the codebook rounds to bf16, the scores stay fp32."""
    x, cb = _data(n, m, d, n + 1)
    want = np.asarray(jax_vq_assign(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cb),
                                    backend="xla"))
    got = ops.vq_assign(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(cb))
    np.testing.assert_array_equal(got.numpy(), want)


def test_duplicated_codes_give_the_first_index():
    """Every code appears three times, in tiles of 4 codes: the first copy
    wins within a tile and across tiles (a later tile must be strictly
    smaller). Leading shape [4, 7]."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(5, 16)).astype(np.float32)
    cb = np.concatenate([base, base, base])  # code j + 5 r is code j
    x = (base[rng.integers(0, 5, size=(4, 7))]
         + 0.01 * rng.normal(size=(4, 7, 16))).astype(np.float32)
    got = ops.vq_assign(torch.from_numpy(x), torch.from_numpy(cb))
    want = np.asarray(vq_assign_pallas(jnp.asarray(x), jnp.asarray(cb), tile_n=8, tile_m=4,
                                       interpret=True))
    assert got.shape == (4, 7)
    assert int(got.max()) < 5
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_takes_the_plain_version_and_other_devices_raise():
    x, cb = _data(9, 6, 8, 0)
    before = vqk.vq_assign_kernel.launches
    got = vqk.vq_assign_kernel(torch.from_numpy(x), torch.from_numpy(cb))
    assert vqk.vq_assign_kernel.launches == before  # the plain version counts nothing
    assert torch.equal(got, vqk.vq_assign_reference(torch.from_numpy(x), torch.from_numpy(cb)))
    with pytest.raises(ValueError, match="CUDA"):
        vqk.vq_assign_kernel(torch.empty(9, 8, device="meta"), torch.empty(6, 8, device="meta"))
