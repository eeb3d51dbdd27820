"""The port's VQ assignment against the JAX package, on the CPU.

``vq_assign_reference`` (the plain version of the streaming-argmin kernel)
against ``vq_assign_pallas`` in interpret mode with small tiles in fp32, and
against the JAX ``vq_assign(..., backend="xla")`` in bf16 (the Pallas kernel
casts bf16 to fp32, the port keeps the default path's bf16 codebook). Ids
must be equal: the scores differ only in fp32 summation order, and random
normal data has no near-ties at these sizes.

The fp32 kernel scores by the 3xTF32 split (``csrc/vq.cu``). Its numerical
design is held here in plain torch against the JAX ``vq_assign`` at
``Precision.HIGHEST``: each operand rounded to TF32 as ``cvt.rna.tf32.f32``
does (nearest, ties away from zero, 10 mantissa bits), ``x_lo c_lo`` dropped,
the rest summed in fp64 so that only the split's own error shows. Its
scores must lie within 1e-6 of each row's largest |score| of the exact ones
and its ids must equal JAX's except at near-ties (the rule ``chip_smoke.py``
holds the kernel to: the two codes' exact scores within 1e-5 of that
scale); one TF32 product alone misses the 1e-6.
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


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 does: to 10 mantissa bits,
    the nearest, ties away from zero (the carry may raise the exponent)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(t: torch.Tensor):
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _scores(x: torch.Tensor, cb: torch.Tensor, products: str) -> torch.Tensor:
    """fp64 scores ||c||^2 - 2 x.c with x.c as the kernel forms it: "exact",
    "split" (3xTF32: x_lo c_hi + x_hi c_lo + x_hi c_hi) or "tf32" (one
    product of TF32-rounded operands)."""
    if products == "exact":
        dots = x.double() @ cb.double().t()
    elif products == "split":
        (xh, xl), (ch, cl) = _split(x), _split(cb)
        dots = (xl.double() @ ch.double().t() + xh.double() @ cl.double().t()
                + xh.double() @ ch.double().t())
    else:
        dots = _tf32(x).double() @ _tf32(cb).double().t()
    return (cb.double() ** 2).sum(dim=-1)[None, :] - 2.0 * dots


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one_ulp = 2.0**-10  # of 1.0 in TF32
    x = torch.tensor([1.0 + 0.49 * one_ulp, 1.0 + 0.5 * one_ulp, -(1.0 + 0.5 * one_ulp),
                      1.0 + 1.51 * one_ulp, 3.0e-3, -7.25])
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0 + 2 * one_ulp,
                         float(np.float32(3.0e-3)), -7.25])
    got = _tf32(x)
    assert torch.equal(got[[0, 1, 2, 3, 5]], want[[0, 1, 2, 3, 5]])
    assert abs(got[4].item() - 3.0e-3) <= 3.0e-3 * 2.0**-11  # within half a TF32 ulp
    hi, lo = _split(x)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)  # both exact in TF32


@pytest.mark.parametrize("d", [192, 384])
def test_split_tf32_scores_hold_the_jax_highest_assignment(d):
    """The 3xTF32 scores against JAX's vq_assign at Precision.HIGHEST at the
    shipped widths: within 1e-6 of each row's scale of the exact scores, ids
    equal except at near-ties."""
    x, cb = _data(600, 300, d, d)
    xt, cbt = torch.from_numpy(x), torch.from_numpy(cb)
    want = np.asarray(jax_vq_assign(jnp.asarray(x), jnp.asarray(cb), backend="xla"))
    exact, split = _scores(xt, cbt, "exact"), _scores(xt, cbt, "split")
    scale = exact.abs().amax(dim=1)
    assert bool(((split - exact).abs().amax(dim=1) <= 1e-6 * scale).all())
    got = split.argmin(dim=1).numpy()
    rows = np.nonzero(got != want)[0]
    assert len(rows) <= 0.001 * len(got)
    gaps = (exact[rows, got[rows]] - exact[rows, want[rows]]).abs()
    assert bool((gaps <= 1e-5 * scale[rows]).all())


def test_one_tf32_product_misses_the_bound():
    """Why the split: scores from one TF32 product move beyond 1e-6 of the
    row's scale, the margin the split keeps."""
    x, cb = _data(600, 300, 192, 5)
    xt, cbt = torch.from_numpy(x), torch.from_numpy(cb)
    exact, tf32 = _scores(xt, cbt, "exact"), _scores(xt, cbt, "tf32")
    scale = exact.abs().amax(dim=1)
    assert bool(((tf32 - exact).abs().amax(dim=1) > 1e-6 * scale).any())


@pytest.mark.parametrize("dtype,d,route", [
    (torch.float32, 192, "split_tf32"),  # stage 1's k-means, CIFAR width
    (torch.float32, 384, "split_tf32"),  # the ImageNet vocabulary's width
    (torch.float32, 8, "split_tf32"),
    (torch.bfloat16, 192, "tensor_core"),  # serving, stage 3, the stage-4 step
    (torch.bfloat16, 768, "tensor_core"),
])
def test_vq_route(dtype, d, route):
    assert vqk.vq_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d,error", [
    (torch.float32, 100, ValueError),  # not a multiple of 8: no 16-byte pieces
    (torch.bfloat16, 12, ValueError),
    (torch.float32, 0, ValueError),
    (torch.float16, 192, TypeError),
    (torch.float64, 192, TypeError),
])
def test_vq_route_rejects(dtype, d, error):
    """No quiet fallback: what neither route takes raises."""
    with pytest.raises(error):
        vqk.vq_route(dtype, d)


@pytest.mark.parametrize("n,m,segments", [
    (1024, 1024, 8),  # a k-means minibatch: 16 row tiles, a segment a code tile
    (200_000, 1024, 1),  # a Lloyd step: enough row tiles alone
    (6272, 8000, 2),  # ImageNet's vocabulary at stage 3's batch
    (64 * 196, 1024, 1),  # serving's microbatch
    (10, 130, 2),  # fewer codes than segments wanted
])
def test_vq_segments(n, m, segments):
    """The code segments of a launch (csrc/vq.cu launches as many)."""
    assert vqk.segments(n, m) == segments
