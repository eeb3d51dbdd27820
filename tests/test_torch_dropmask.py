"""The port's plain ``hash_keep_mask`` against the JAX package's, bit for bit:
seeds near both ends of the int32 range, several streams, the attention and
FFN block shapes, row offsets, and two dropout rates. The CUDA kernels
compute the same function (``csrc/dropmask.cuh``); ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold them to these plain versions."""

import numpy as np
import pytest
import torch

from schemanet_torch.ops.kernels.dropmask import hash_keep_mask
from schemanet_tpu.ops.pallas.dropmask import hash_keep_mask as jax_hash_keep_mask

SEEDS = [0, 1, 123_456_789, 2**31 - 2, 2**31 - 1]
STREAMS = [0, 7, 191, 2**31 - 1]


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("shape,row_offset", [((17, 17), 0), ((197, 197), 0), ((64, 768), 0),
                                              ((64, 768), 12_544), ((17, 17), 5)])
def test_equals_jax_bit_for_bit(shape, row_offset, p):
    for seed in SEEDS:
        for stream in STREAMS:
            want = np.asarray(jax_hash_keep_mask(seed, stream, shape, p, row_offset=row_offset))
            got = hash_keep_mask(seed, stream, shape, p, row_offset=row_offset).numpy()
            assert got.dtype == np.bool_ and got.shape == shape
            np.testing.assert_array_equal(got, want, err_msg=f"seed {seed} stream {stream}")


def test_stream_tensor_leads_the_shape():
    """A tensor of streams gives one mask per stream, as the attention kernel's
    (item, head) streams."""
    streams = torch.arange(6).view(2, 3)
    got = hash_keep_mask(2**31 - 2, streams, (9, 9), 0.1)
    assert got.shape == (2, 3, 9, 9)
    for i in range(2):
        for j in range(3):
            want = np.asarray(jax_hash_keep_mask(2**31 - 2, 3 * i + j, (9, 9), 0.1))
            np.testing.assert_array_equal(got[i, j].numpy(), want)


def test_blocks_tile_one_mask_and_keep_rate():
    full = hash_keep_mask(42, 3, (64, 96), 0.3)
    tiles = [hash_keep_mask(42, 3, (16, 96), 0.3, row_offset=r0) for r0 in range(0, 64, 16)]
    assert torch.equal(torch.cat(tiles), full)
    for p in (0.1, 0.5):
        keep = hash_keep_mask(3, 11, (256, 256), p).float().mean().item()
        assert abs(keep - (1 - p)) < 0.01
