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


@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
def test_ffn_block_matches_jax(dtype, rtol, atol):
    rng = np.random.default_rng(1)
    p = _weights(rng)
    x = rng.normal(size=(BS, N, DIM)).astype(np.float32)
    want = jeb.ffn_block(
        jnp.asarray(x, dtype), jnp.asarray(p["g"]), jnp.asarray(p["b"]),
        jnp.asarray(p["w1"]), jnp.asarray(p["b1"]), jnp.asarray(p["w2"]),
        jnp.asarray(p["b2"]), activation="gelu", eps=1e-6, interpret=True,
    )
    got = eb.ffn_block(
        _t(x).to(getattr(torch, dtype)), _t(p["g"]), _t(p["b"]), _t(p["w1"].T), _t(p["b1"]),
        _t(p["w2"].T), _t(p["b2"]), eps=1e-6,
    )
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


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
