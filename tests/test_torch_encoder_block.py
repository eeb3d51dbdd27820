"""The port's encoder-half kernels (plain versions, CPU) against the JAX
package's Pallas ``attn_block`` / ``ffn_block`` in interpret mode.

Same numpy inputs on both sides; weights go to the port in ``nn.Linear``
layout. Tolerances as tests/test_encoder_block.py: fp32 rtol 2e-5 / atol 2e-6
(different fp32 summation orders), bf16 2e-2 (one bf16 ulp is 2^-8 ~ 4e-3
relative; a few roundings differ in order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.ops.kernels import encoder_block as eb
from schemanet_torch.ops.kernels import mlp as mk
from schemanet_tpu.ops.pallas import encoder_block as jeb
from schemanet_tpu.ops.pallas.mlp import _kernel_activation
from tests.test_torch_vq import _tf32

BS, N, DIM, HEADS, F = 2, 17, 32, 2, 64
TOLS = [("float32", 2e-5, 2e-6), ("bfloat16", 2e-2, 2e-2)]


def _weights(rng):
    def w(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(
        g=1.0 + w(DIM, scale=0.1), b=w(DIM, scale=0.1),
        wqkv=w(DIM, 3 * DIM, scale=DIM**-0.5), bqkv=w(3 * DIM, scale=0.1),
        wo=w(DIM, DIM, scale=DIM**-0.5), bo=w(DIM, scale=0.1),
        w1=w(DIM, F, scale=DIM**-0.5), b1=w(F, scale=0.1),
        w2=w(F, DIM, scale=F**-0.5), b2=w(DIM, scale=0.1),
    )


def _np(a):
    return np.asarray(a, np.float32) if not torch.is_tensor(a) else a.float().numpy()


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("capture_hmean", [False, True])
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
def test_attn_block_matches_jax(dtype, rtol, atol, capture_hmean):
    rng = np.random.default_rng(0)
    p = _weights(rng)
    x = rng.normal(size=(BS, N, DIM)).astype(np.float32)
    want = jeb.attn_block(
        jnp.asarray(x, dtype), jnp.asarray(p["g"]), jnp.asarray(p["b"]),
        jnp.asarray(p["wqkv"]), jnp.asarray(p["bqkv"]), jnp.asarray(p["wo"]),
        jnp.asarray(p["bo"]), HEADS, eps=1e-6, interpret=True, capture_hmean=capture_hmean,
    )
    got = eb.attn_block(
        _t(x).to(getattr(torch, dtype)), _t(p["g"]), _t(p["b"]), _t(p["wqkv"].T),
        _t(p["bqkv"]), _t(p["wo"].T), _t(p["bo"]), HEADS, eps=1e-6,
        capture_hmean=capture_hmean,
    )
    if not capture_hmean:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol)


def _ffn_inputs(rng, bs, n, dim, f):
    """x [bs, n, dim] and the FFN half's weights in the JAX layout ([in, out])."""
    def w(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return w(bs, n, dim), dict(g=1.0 + w(dim, scale=0.1), b=w(dim, scale=0.1),
                               w1=w(dim, f, scale=dim**-0.5), b1=w(f, scale=0.1),
                               w2=w(f, dim, scale=f**-0.5), b2=w(dim, scale=0.1))


def _jax_ffn(x, p, dtype="float32"):
    return jeb.ffn_block(
        jnp.asarray(x, dtype), jnp.asarray(p["g"]), jnp.asarray(p["b"]), jnp.asarray(p["w1"]),
        jnp.asarray(p["b1"]), jnp.asarray(p["w2"]), jnp.asarray(p["b2"]), activation="gelu",
        eps=1e-6, interpret=True,
    )


# the smallest width the kernels take; DeiT-Small; DeiT-Base (the two-product route)
@pytest.mark.parametrize("dim", [64, 384, 768])
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
def test_ffn_block_matches_jax(dtype, rtol, atol, dim):
    x, p = _ffn_inputs(np.random.default_rng(1), BS, N, dim, 4 * dim)
    want = _jax_ffn(x, p, dtype)
    got = eb.ffn_block(
        _t(x).to(getattr(torch, dtype)), _t(p["g"]), _t(p["b"]), _t(p["w1"].T), _t(p["b1"]),
        _t(p["w2"].T), _t(p["b2"]), eps=1e-6,
    )
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def test_ffn_gelu_is_the_tpu_kernels():
    """The plain ffn_block's gelu is the TPU kernel's (Abramowitz-Stegun erf),
    not torch's exact erf. An FFN whose LN2 is the constant e_0 (scale 0,
    bias e_0), W1 a column of grid points and W2 the identity returns gelu of
    the grid exactly. Against JAX's ``_kernel_activation("gelu")`` in fp32 on
    that grid across [-8, 8]: within 2^-22 of max(1, |x|), not bit for bit,
    since XLA's CPU exp and torch's differ in their last bit on some points
    (0.6-16% of a grid, by the run); the exact-erf gelu misses that bound
    (A&S's erf is off by up to 1.5e-7)."""
    grid = np.linspace(-8.0, 8.0, 2049, dtype=np.float32)
    n = len(grid)
    e0, zeros = torch.zeros(n), torch.zeros(n)
    e0[0] = 1.0
    w1 = torch.zeros(n, n)
    w1[:, 0] = torch.from_numpy(grid)
    got = eb.ffn_block_reference(torch.zeros(1, n), zeros, e0, w1, zeros, torch.eye(n), zeros)
    got = got[0].numpy()
    assert np.array_equal(got, eb.gelu_as(torch.from_numpy(grid)).numpy())
    want = np.asarray(_kernel_activation("gelu")(jnp.asarray(grid)))
    bound = 2.0**-22 * np.maximum(1.0, np.abs(grid))
    assert bool((np.abs(got - want) <= bound).all())
    exact = torch.nn.functional.gelu(torch.from_numpy(grid)).numpy()
    assert bool((np.abs(exact - want) > bound).any())


@pytest.mark.parametrize("dtype,dim,f,route", [
    *[(torch.bfloat16, dim, 4 * dim, "tensor_core") for dim in (64, 128, 192, 256, 384, 768)],
    (torch.bfloat16, 192, 96, "tensor_core"),  # f past a chunk of 32 and 64
    *[(torch.float32, dim, 4 * dim, "split_tf32") for dim in (64, 128, 192, 256)],
    (torch.float32, 192, 100, "split_tf32"),  # fp32 takes any f
    (torch.float32, 384, 1536, "split_tf32"),  # DeiT-Small: hidden chunks of 16
    (torch.float32, 768, 3072, "split_tf32"),  # DeiT-Base: the two-product route
])
def test_ffn_block_route(dtype, dim, f, route):
    """The kernel an ffn_block launch takes: bf16 the tensor cores, fp32 the
    split TF32, at every width."""
    assert eb.ffn_block_route(dtype, dim, f) == route


@pytest.mark.parametrize("dtype,dim,f,error,what", [
    (torch.float16, 192, 768, TypeError, "float16"),
    (torch.bfloat16, 96, 384, ValueError, "width in"),
    (torch.float32, 96, 384, ValueError, "width in"),
    (torch.bfloat16, 192, 100, ValueError, "multiple of 8"),
    (torch.bfloat16, 192, 0, ValueError, ">= 1"),
])
def test_ffn_block_route_rejects(dtype, dim, f, error, what):
    """No quiet fallback: what no ffn_block kernel takes raises."""
    with pytest.raises(error, match=what):
        eb.ffn_block_route(dtype, dim, f)


# (dtype, rows, dim) -> launches, scratch and tiles of ffn_block: DeiT-Tiny
# and DeiT-Small on the one-launch kernels; DeiT-Base's 768 in bf16 (the LN
# pass, fc1 on 192 x 128 tiles, fc2 on gemm_tile's) and fp32 (statistics,
# two split-TF32 products), at the serving microbatch's 12,608 rows and at 77
@pytest.mark.parametrize("dtype,rows,dim", [
    (torch.bfloat16, 12_608, 192), (torch.float32, 12_608, 192),
    (torch.bfloat16, 12_608, 384), (torch.float32, 12_608, 384),
    (torch.bfloat16, 12_608, 768), (torch.float32, 12_608, 768),
    (torch.bfloat16, 77, 768),
])
def test_ffn_plan(dtype, rows, dim):
    f = 4 * dim
    plan = eb.ffn_plan(dtype, rows, dim, f)
    assert plan.route == eb.ffn_block_route(dtype, dim, f)
    if dim <= 384:
        assert not plan.wide and plan.scratch == {} and plan.tiles == {}
        assert plan.launches == ["ffn_tc_kernel" if dtype == torch.bfloat16 else "ffn_tf32_kernel"]
    elif dtype == torch.bfloat16:
        assert plan.launches == ["ln_rows_bf16_kernel", "gemm_wg_kernel", "gemm_wg_kernel"]
        assert plan.scratch == {"ln": ((rows, dim), dtype), "hidden": ((rows, f), dtype)}
        assert plan.tiles["fc1"] == (-(-rows // 192), f // 128, 128)
        bm, bn = mk.gemm_tile(rows, dim, False)
        assert plan.tiles["fc2"] == (-(-rows // bm), -(-dim // bn), bn)
        if rows == 12_608:  # fc2 in one round of 132 persistent blocks
            assert plan.tiles["fc2"] == (66, 4, 192)
    else:
        assert plan.launches == ["ln_stats_kernel", "linear_tf32_kernel", "linear_tf32_kernel"]
        assert plan.scratch == {"ln": ((rows, 2), torch.float32), "hidden": ((rows, f), dtype)}


# widths: DeiT-Base's; the smallest the kernel takes; one not a multiple of
# a warp's 256 columns (pieces past the row's end masked)
@pytest.mark.parametrize("dim", [768, 8, 392])
def test_ln_rows_reference_is_the_layer_norm(dim):
    """The wide route's LN2 pass (plain emulation of the kernel's order of
    operations) against ``layer_norm`` and JAX's LN in bf16: within one bf16
    ulp everywhere (the statistics sum in another order), equal on all but
    a few elements."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0.3, 1.5, size=(64, dim)).astype(np.float32)).bfloat16()
    sc = torch.from_numpy(1 + 0.3 * rng.normal(size=dim).astype(np.float32))
    bi = torch.from_numpy(0.3 * rng.normal(size=dim).astype(np.float32))
    got = eb.ln_rows_reference(x, sc, bi, 1e-6)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(eb.ffn_ln_rows(x, sc, bi, 1e-6), got)  # the CPU dispatch
    want = eb.layer_norm(x, sc, bi, 1e-6).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert bool(((got.float() - want).abs() <= ulp).all())
    assert (got.float() != want).float().mean().item() <= 1e-3
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    ref64 = ((xf.double() - mean.double()) / torch.sqrt(var.double() + 1e-6) * sc.double()
             + bi.double())
    assert (got.double() - ref64).abs().max().item() <= 2.0**-7 * ref64.abs().max().item()


def test_wide_bf16_route_in_plain_holds_the_jax_ffn_block():
    """The bf16 route at 768 in plain arithmetic, launch by launch: the LN
    pass (``ln_rows_reference``), fc1 rounded once and b1 added in bf16,
    gelu rounded, fc2 rounded once, b2 and the residual in bf16: against
    JAX's bf16 ffn_block in interpret mode, the same tolerance as the
    wrapper's (2e-2)."""
    x, p = _ffn_inputs(np.random.default_rng(12), 2, 9, 768, 3072)
    want = _np(_jax_ffn(x, p, "bfloat16"))
    bf = torch.bfloat16
    xt = _t(x).to(bf)
    a = eb.ln_rows_reference(xt, _t(p["g"]), _t(p["b"]), 1e-6)
    h = (a.float() @ _t(p["w1"]).to(bf).float()).to(bf) + _t(p["b1"]).to(bf)
    hidden = eb.gelu_as(h)
    y = (hidden.float() @ _t(p["w2"]).to(bf).float()).to(bf) + _t(p["b2"]).to(bf)
    got = xt + y
    np.testing.assert_allclose(_np(got), want, rtol=2e-2, atol=2e-2)


def _split(t):
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _ffn_emulated(x, p, products):
    """fp32 ffn_block with each product formed as the kernel forms it, summed
    in fp64 and rounded once to fp32: "split" (3xTF32: x_lo w_hi + x_hi w_lo
    + x_hi w_hi) or "tf32" (one product of TF32-rounded operands)."""
    def matmul(a, w):  # a [rows, k] times w [k, n], both fp32
        if products == "tf32":
            return (_tf32(a).double() @ _tf32(w).double()).float()
        (ah, al), (wh, wl) = _split(a), _split(w)
        return (al.double() @ wh.double() + ah.double() @ wl.double()
                + ah.double() @ wh.double()).float()

    xt = _t(x).reshape(-1, x.shape[-1])
    ln = eb.layer_norm(xt, _t(p["g"]), _t(p["b"]), 1e-6)
    a = eb.gelu_as(matmul(ln, _t(p["w1"])) + _t(p["b1"]))
    return (xt + (matmul(a, _t(p["w2"])) + _t(p["b2"]))).reshape(x.shape)


@pytest.fixture(scope="module")
def serving_ffn():
    """One serving item ([2, 197, 192], f 768) and the JAX fp32 ffn_block on it."""
    x, p = _ffn_inputs(np.random.default_rng(4), 2, 197, 192, 768)
    return x, p, np.asarray(_jax_ffn(x, p))


def test_split_tf32_ffn_holds_the_jax_fp32_ffn_block(serving_ffn):
    """The split-TF32 route's arithmetic within 1e-5 of max of JAX's fp32
    ffn_block at the serving width: the split costs about fp32's accuracy."""
    x, p, want = serving_ffn
    got = _ffn_emulated(x, p, "split").numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_split_tf32_ffn_holds_at_deit_small_width():
    """The same at DeiT-Small's width (one item, [1, 197, 384], f 1536),
    which the split-TF32 kernel takes in hidden chunks of 16."""
    x, p = _ffn_inputs(np.random.default_rng(5), 1, 197, 384, 1536)
    want = np.asarray(_jax_ffn(x, p))
    got = _ffn_emulated(x, p, "split").numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_one_tf32_product_misses_the_fp32_bound(serving_ffn):
    """Why the split: one TF32 product a product (10-bit mantissa) misses the
    bound the split holds."""
    x, p, want = serving_ffn
    got = _ffn_emulated(x, p, "tf32").numpy()
    assert np.abs(got - want).max() > 1e-5 * np.abs(want).max()


def _attn_emulated(x, p, heads, products, capture_hmean):
    """fp32 attn_block as the split-TF32 kernels form it: the qkv, score,
    P V and out products each formed as ``_ffn_emulated``'s are ("split" or
    "tf32"), summed in fp64 and rounded once; the softmax online over chunks
    of 32 keys (the running max, the sums rescaled by exp(m_old - m), the
    division by the row's sum after the P V product), as the attention
    kernel runs it; the head-mean the sum of each head's scores in head
    order, scaled by 1/H."""
    def matmul(a, b):  # [..., m, k] @ [..., k, n], both fp32
        if products == "tf32":
            return (_tf32(a).double() @ _tf32(b).double()).float()
        (ah, al), (bh, bl) = _split(a), _split(b)
        return (al.double() @ bh.double() + ah.double() @ bl.double()
                + ah.double() @ bh.double()).float()

    bs, n, dim = x.shape
    d = dim // heads
    xt = _t(x)
    ln = eb.layer_norm(xt, _t(p["g"]), _t(p["b"]), 1e-6)
    qkv = (matmul(ln, _t(p["wqkv"])) + _t(p["bqkv"])).reshape(bs, n, 3, heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)  # [bs, H, n, d] each
    s = matmul(q * torch.tensor(1.0 / d**0.5, dtype=torch.float32), k.transpose(-1, -2))
    m = torch.full((bs, heads, n), -torch.inf)
    l, o = torch.zeros(bs, heads, n), torch.zeros(bs, heads, n, d)
    for j0 in range(0, n, 32):
        m_new = torch.maximum(m, s[..., j0:j0 + 32].amax(-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s[..., j0:j0 + 32] - m_new[..., None])
        l = l * alpha + e.sum(-1)
        o = o * alpha[..., None] + matmul(e, v[..., j0:j0 + 32, :])
        m = m_new
    mh = (o / l[..., None]).transpose(1, 2).reshape(bs, n, dim)
    out = xt + (matmul(mh, _t(p["wo"])) + _t(p["bo"]))
    if not capture_hmean:
        return (out,)
    hsum = s[:, 0]
    for h in range(1, heads):
        hsum = hsum + s[:, h]
    return out, hsum * (1.0 / heads)


@pytest.fixture(scope="module")
def serving_attn():
    """One serving pair of items ([2, 197, 192], 3 heads of 64), the weights
    in the JAX layout, and the JAX fp32 attn_block on them, both variants."""
    rng = np.random.default_rng(6)

    def w(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    bs, n, dim = 2, 197, 192
    x = w(bs, n, dim)
    p = dict(g=1.0 + w(dim, scale=0.1), b=w(dim, scale=0.1),
             wqkv=w(dim, 3 * dim, scale=dim**-0.5), bqkv=w(3 * dim, scale=0.1),
             wo=w(dim, dim, scale=dim**-0.5), bo=w(dim, scale=0.1))
    want = {}
    for capture_hmean in (False, True):
        got = jeb.attn_block(
            jnp.asarray(x), jnp.asarray(p["g"]), jnp.asarray(p["b"]), jnp.asarray(p["wqkv"]),
            jnp.asarray(p["bqkv"]), jnp.asarray(p["wo"]), jnp.asarray(p["bo"]), 3, eps=1e-6,
            interpret=True, capture_hmean=capture_hmean,
        )
        want[capture_hmean] = [np.asarray(a) for a in (got if capture_hmean else (got,))]
    return x, p, want


@pytest.mark.parametrize("capture_hmean", [False, True])
def test_split_tf32_attn_holds_the_jax_fp32_attn_block(serving_attn, capture_hmean):
    """The split-TF32 route's arithmetic (its online softmax included)
    within 1e-5 of max of JAX's fp32 attn_block at the serving width, the
    output and the head-mean each."""
    x, p, want = serving_attn
    got = _attn_emulated(x, p, 3, "split", capture_hmean)
    assert len(got) == len(want[capture_hmean])
    for g, w in zip(got, want[capture_hmean]):
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("capture_hmean", [False, True])
def test_one_tf32_attn_product_misses_the_fp32_bound(serving_attn, capture_hmean):
    """Why the split: one TF32 product a product misses the bound the split
    holds, on the output and on the head-mean."""
    x, p, want = serving_attn
    got = _attn_emulated(x, p, 3, "tf32", capture_hmean)
    for g, w in zip(got, want[capture_hmean]):
        assert np.abs(g.numpy() - w).max() > 1e-5 * np.abs(w).max()


def test_wrappers_refuse_non_cuda_devices():
    """Only a CPU tensor takes the plain version; any other device must reach
    the kernel path, which accepts CUDA tensors only."""
    p = {k: _t(v).to("meta") for k, v in _weights(np.random.default_rng(2)).items()}
    x = torch.empty(BS, N, DIM, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        eb.attn_block(x, p["g"], p["b"], p["wqkv"].T, p["bqkv"], p["wo"].T, p["bo"], HEADS)
    with pytest.raises(ValueError, match="CUDA"):
        eb.ffn_block(x, p["g"], p["b"], p["w1"].T, p["b1"], p["w2"].T, p["b2"])


@pytest.mark.parametrize("dtype,n,heads,head_dim,route", [
    (torch.bfloat16, 197, 3, 64, "tensor_core"),  # DeiT-Tiny (serving, stages 3 and 4)
    (torch.bfloat16, 197, 6, 64, "tensor_core"),  # DeiT-Small
    (torch.bfloat16, 197, 12, 64, "tensor_core"),  # DeiT-Base
    (torch.bfloat16, 65, 2, 32, "tensor_core"),  # one query row past a tile of 64
    (torch.bfloat16, 320, 3, 16, "tensor_core"),  # the limit of n
    (torch.float32, 197, 3, 64, "split_tf32"),  # fp32 serving checks, stages 1 and 3
    (torch.float32, 400, 2, 128, "split_tf32"),  # fp32 takes head_dim up to 128 at any n
    (torch.float32, 197, 6, 64, "split_tf32"),  # DeiT-Small
    (torch.float32, 65, 3, 32, "split_tf32"),  # head_dim padded to 32
    (torch.float32, 33, 3, 30, "split_tf32"),  # head_dim not a multiple of 4: 4-byte copies
    (torch.float32, 5, 1, 1, "split_tf32"),  # the smallest head_dim
    (torch.float32, 1000, 2, 65, "split_tf32"),  # head_dim padded to 128, n past any tile
])
def test_attn_block_route(dtype, n, heads, head_dim, route):
    """The CUDA kernels an attn_block launch takes: every shipped config's
    bf16 shape takes the tensor-core kernels, every fp32 shape the FMA
    kernels took (head_dim up to 128, any n) the split-TF32 kernels."""
    assert eb.attn_block_route(dtype, n, heads, head_dim) == route


@pytest.mark.parametrize("dtype,n,heads,head_dim,what", [
    (torch.bfloat16, 197, 2, 128, "multiple of 16 up to 64"),
    (torch.bfloat16, 197, 4, 40, "multiple of 16 up to 64"),
    (torch.bfloat16, 321, 3, 64, "n <= 320"),
    (torch.float32, 197, 1, 256, "head_dim <= 128"),
    (torch.float32, 197, 1, 129, "head_dim <= 128"),  # one past the split-TF32 kernels' padding
    (torch.float32, 197, 1, 0, "head_dim <= 128"),
    (torch.bfloat16, 0, 3, 64, "n >= 1"),
])
def test_attn_block_route_rejects(dtype, n, heads, head_dim, what):
    """No quiet fallback: a bf16 shape the tensor-core kernels do not take
    raises, and so does what the split-TF32 kernels do not take in fp32."""
    with pytest.raises(ValueError, match=what):
        eb.attn_block_route(dtype, n, heads, head_dim)


def test_attn_block_route_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        eb.attn_block_route(torch.float16, 197, 3, 64)


@pytest.mark.parametrize("dtype,d,offset,route", [
    (torch.bfloat16, 192, 0, "vector"), (torch.bfloat16, 256, 0, "vector"),
    (torch.bfloat16, 24, 0, "vector"), (torch.float32, 192, 0, "vector"),
    (torch.float32, 300, 0, "vector"), (torch.bfloat16, 300, 0, "scalar"),
    (torch.bfloat16, 12, 0, "scalar"), (torch.float32, 6, 0, "scalar"),
    (torch.bfloat16, 192, 4, "scalar"), (torch.bfloat16, 256, 2, "scalar"),
])
def test_piece_route(dtype, d, offset, route):
    """The LayerNorm backward's and embed_grad's route: 16-byte pieces where
    a row is a whole number of 16 bytes and the data is 16-byte aligned,
    scalar pieces otherwise."""
    x = torch.zeros(3 * d + 16, dtype=dtype)[offset:offset + 3 * d]
    assert eb.piece_route(dtype, d, x.data_ptr()) == route
    assert eb.piece_route(dtype, d, x.data_ptr(), torch.zeros(8, dtype=dtype).data_ptr()) == route
