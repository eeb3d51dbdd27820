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


@pytest.mark.parametrize("dim", [64, 384])  # the smallest width the kernels take; DeiT-Small
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
    *[(torch.bfloat16, dim, 4 * dim, "tensor_core") for dim in eb._FFN_DIMS],
    (torch.bfloat16, 192, 96, "tensor_core"),  # f past a chunk of 32 and 64
    *[(torch.float32, dim, 4 * dim, "split_tf32") for dim in (64, 128, 192, 256)],
    (torch.float32, 192, 100, "split_tf32"),  # fp32 takes any f
    (torch.float32, 384, 1536, "split_tf32"),  # DeiT-Small: hidden chunks of 16
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
    (torch.float32, 197, 3, 64, "fma"),  # fp32 serving checks, stages 1 and 3
    (torch.float32, 400, 2, 128, "fma"),  # fp32 takes head_dim up to 128 at any n
])
def test_attn_block_route(dtype, n, heads, head_dim, route):
    """The CUDA kernels an attn_block launch takes: every shipped config's
    bf16 shape takes the tensor-core kernels, fp32 keeps the FMA kernels."""
    assert eb.attn_block_route(dtype, n, heads, head_dim) == route


@pytest.mark.parametrize("dtype,n,heads,head_dim,what", [
    (torch.bfloat16, 197, 2, 128, "multiple of 16 up to 64"),
    (torch.bfloat16, 197, 4, 40, "multiple of 16 up to 64"),
    (torch.bfloat16, 321, 3, 64, "n <= 320"),
    (torch.float32, 197, 1, 256, "head_dim <= 128"),
    (torch.bfloat16, 0, 3, 64, "n >= 1"),
])
def test_attn_block_route_rejects(dtype, n, heads, head_dim, what):
    """No quiet fallback: a bf16 shape the tensor-core kernels do not take
    raises, and so does what the FMA kernels do not take in fp32."""
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
