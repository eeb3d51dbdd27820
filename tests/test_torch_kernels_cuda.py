"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small shapes whose edges are not multiples of the kernels' tiles.

Needs an NVIDIA GPU and nvcc: every test carries the ``cuda`` marker and skips
without a card. Imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances, relative to max |plain|: fp32 1e-5 (summation order only), bf16
2e-2 (a few bf16 ulps where roundings meet in another order).
"""

import pytest
import torch

from schemanet_torch.ops.kernels import encoder_block as eb
from schemanet_torch.ops.kernels import graphconv as gc

pytestmark = pytest.mark.cuda
TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(g, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(dev)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("bs,n,dim,heads", [(3, 37, 64, 2), (2, 70, 192, 3)])
def test_attn_block_kernel(dev, dtype, tol, bs, n, dim, heads):
    g = torch.Generator().manual_seed(0)
    x = _rnd(g, dev, bs, n, dim).to(dtype)
    args = (
        x, 1 + _rnd(g, dev, dim, scale=0.1), _rnd(g, dev, dim, scale=0.1),
        _rnd(g, dev, 3 * dim, dim, scale=dim**-0.5), _rnd(g, dev, 3 * dim, scale=0.1),
        _rnd(g, dev, dim, dim, scale=dim**-0.5), _rnd(g, dev, dim, scale=0.1), heads,
    )
    before = (eb.attn_block.launches, eb.attn_block.hmean_launches)
    out, hmean = eb.attn_block(*args, capture_hmean=True)
    plain_only = eb.attn_block(*args)
    want_out, want_hmean = eb.attn_block_reference(*args, capture_hmean=True)
    torch.cuda.synchronize()
    assert (eb.attn_block.launches, eb.attn_block.hmean_launches) == (before[0] + 2, before[1] + 1)
    assert out.dtype == hmean.dtype == dtype and hmean.shape == (bs, n, n)
    assert _rel(out, want_out) <= tol and _rel(hmean, want_hmean) <= tol
    assert torch.equal(plain_only, out)  # the head-mean output changes nothing else


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("rows,dim,f", [(45, 64, 96), (2 * 197, 192, 768)])
def test_ffn_block_kernel(dev, dtype, tol, rows, dim, f):
    g = torch.Generator().manual_seed(1)
    args = (
        _rnd(g, dev, 1, rows, dim).to(dtype), 1 + _rnd(g, dev, dim, scale=0.1),
        _rnd(g, dev, dim, scale=0.1), _rnd(g, dev, f, dim, scale=dim**-0.5),
        _rnd(g, dev, f, scale=0.1), _rnd(g, dev, dim, f, scale=f**-0.5), _rnd(g, dev, dim, scale=0.1),
    )
    got = eb.ffn_block(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rel(got, eb.ffn_block_reference(*args)) <= tol


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("k,v,d", [(2, 70, 40), (3, 196, 256)])
def test_sym_conv_kernel(dev, dtype, tol, k, v, d):
    g = torch.Generator().manual_seed(2)
    e = (torch.rand(k, v, v, generator=g) / v).to(dev, dtype)
    f = _rnd(g, dev, k, v, d).to(dtype)
    got = gc.sym_conv(e, f)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (k, v, d)
    assert _rel(got, gc.sym_conv_reference(e, f)) <= tol


def test_kernels_reject_bad_inputs(dev):
    x = torch.zeros(2, 5, 64, device=dev, dtype=torch.float16)
    w = torch.zeros(192, 64, device=dev)
    with pytest.raises(TypeError):
        eb.attn_block(x, w[0], w[0], w, w[:, 0], w[:64], w[0], 2)
    e = torch.zeros(2, 8, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        gc.sym_conv(e.transpose(1, 2), torch.zeros(2, 8, 4, device=dev))
