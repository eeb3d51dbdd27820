"""The port's fused attention (plain versions, the CPU path of the kernels)
against the JAX package's ``fused_mhsa`` in interpret mode, forward and the
qkv gradient, with and without dropout, on the same numpy inputs and the same
int32 seed.

Tolerances, and why: fp32 forward rtol/atol 1e-5 and gradients 1e-4 (the
frameworks sum fp32 products in other orders; the softmax backward subtracts
a row sum of the size of its terms); bf16 2e-2 of max |ref| (a few bf16 ulps
where an fp32 difference in the last bit flips a rounding of the
probabilities or of dS). With dropout the two masks are the same bits
(``tests/test_torch_dropmask.py``), so the dropout-live case is a plain
comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.ops.kernels import attention as ak
from schemanet_tpu.ops.pallas.attention import fused_mhsa as jax_fused_mhsa

SEED = 123_456_789


def _case(dtype, bs=2, n=17, heads=3, d=16, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(bs, n, 3 * heads * d)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return qkv, jdt


def _jax_fwd_grad(qkv, heads, jdt, p):
    kw = dict(dropout_p=p, seed=SEED) if p else {}
    x = jnp.asarray(qkv).astype(jdt)

    def loss(q):
        return jnp.sum(jnp.sin(jax_fused_mhsa(q, heads, interpret=True, **kw).astype(jnp.float32)))

    out = jax_fused_mhsa(x, heads, interpret=True, **kw)
    grad = jax.grad(loss)(x)
    return np.asarray(out.astype(jnp.float32)), np.asarray(grad.astype(jnp.float32))


def _torch_fwd_grad(qkv, heads, dtype, p):
    x = torch.from_numpy(qkv).to(dtype).requires_grad_()
    out = ak.fused_mhsa(x, heads, dropout_p=p, seed=SEED if p else None)
    torch.sin(out.float()).sum().backward()
    return out.detach().float().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mhsa_matches_jax(dtype, p):
    qkv, jdt = _case(dtype)
    want_out, want_grad = _jax_fwd_grad(qkv, 3, jdt, p)
    got_out, got_grad = _torch_fwd_grad(qkv, 3, dtype, p)
    assert got_out.shape == (2, 17, 48) and got_grad.shape == qkv.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_grad, want_grad, rtol=1e-4, atol=1e-4)
    else:
        for got, want in ((got_out, want_out), (got_grad, want_grad)):
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_dropout_changes_the_output_and_the_seed_matters():
    qkv = torch.from_numpy(_case(torch.float32)[0])
    plain = ak.fused_mhsa_reference(qkv, 3)
    a = ak.fused_mhsa_reference(qkv, 3, 0.1, SEED)
    b = ak.fused_mhsa_reference(qkv, 3, 0.1, SEED + 1)
    assert not torch.equal(a, plain) and not torch.equal(a, b)
    torch.testing.assert_close(ak.fused_mhsa_reference(qkv, 3, 0.1, SEED), a, rtol=0, atol=0)
    with pytest.raises(ValueError, match="seed"):
        ak.fused_mhsa(qkv, 3, dropout_p=0.1)


@pytest.mark.parametrize("p", [0.0, 0.25])
def test_bwd_reference_is_the_gradient_of_the_forward(p):
    """The plain backward (the one the kernel is held against) equals
    autograd of the plain forward in fp32."""
    qkv = torch.from_numpy(_case(torch.float32, bs=3, n=9, heads=2, d=8, seed=1)[0])
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 9, 16)).astype(np.float32))
    x = qkv.clone().requires_grad_()
    ak.fused_mhsa_reference(x, 2, p, SEED).backward(g)
    got = ak.fused_mhsa_bwd_reference(qkv, g, 2, p, SEED)
    torch.testing.assert_close(got, x.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,n,d,route", [
    (torch.float32, 197, 64, "fma"),
    (torch.float32, 37, 40, "fma"),
    (torch.bfloat16, 197, 16, "tensor_core"),
    (torch.bfloat16, 65, 32, "tensor_core"),
    (torch.bfloat16, 197, 48, "tensor_core"),
    (torch.bfloat16, 320, 64, "tensor_core"),
])
def test_mhsa_route(dtype, n, d, route):
    """The CUDA kernels a launch takes: fp32 keeps the FMA kernels, bf16 the
    tensor-core ones."""
    assert ak.mhsa_route(dtype, n, d) == route


@pytest.mark.parametrize("dtype,n,d,what", [
    (torch.bfloat16, 197, 40, "head_dim"),
    (torch.bfloat16, 197, 128, "head_dim"),
    (torch.bfloat16, 197, 8, "head_dim"),
    (torch.bfloat16, 321, 64, "n <= 320"),
    (torch.float32, 197, 128, "head_dim"),
    (torch.float32, 321, 64, "n <= 320"),
])
def test_mhsa_route_rejects(dtype, n, d, what):
    """No quiet fallback: a bf16 head_dim the tensor-core kernels do not take
    raises, as does anything past the kernels' limits."""
    with pytest.raises(ValueError, match=what):
        ak.mhsa_route(dtype, n, d)


def test_mhsa_route_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        ak.mhsa_route(torch.float16, 197, 64)
