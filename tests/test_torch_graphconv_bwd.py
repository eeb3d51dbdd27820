"""The port's GraphConv gradient (plain versions, CPU) against ``jax.vjp`` of
the JAX package's Pallas ``sym_conv`` in interpret mode.

fp32: rtol 1e-5 / atol 1e-6 (fp32 summation order only). bf16: the E_sym
roundings are reproduced step for step and t = g f^T stays fp32 in both, so
only the accumulation order and the final rounding differ: 2e-2 of max|.|
(a few bf16 ulps).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.ops.kernels import graphconv as gc
from schemanet_tpu.ops.pallas.graphconv import sym_conv as jax_sym_conv


def _inputs(rng, k=3, v=20, d=8):
    e = rng.uniform(0.0, 1.0, size=(k, v, v)).astype(np.float32)
    f = rng.normal(size=(k, v, d)).astype(np.float32)
    g = rng.normal(size=(k, v, d)).astype(np.float32)
    return e, f, g


def _jax_vjp(e, f, g, dtype):
    _, vjp = jax.vjp(lambda e_, f_: jax_sym_conv(e_, f_, True),
                     jnp.asarray(e, dtype), jnp.asarray(f, dtype))
    return [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g, dtype))]


def _torch_grads(e, f, g, dtype):
    et = torch.from_numpy(e).to(dtype).requires_grad_()
    ft = torch.from_numpy(f).to(dtype).requires_grad_()
    gc.sym_conv(et, ft).backward(torch.from_numpy(g).to(dtype))
    assert et.grad.dtype == ft.grad.dtype == dtype
    return et.grad.float().numpy(), ft.grad.float().numpy()


def test_sym_conv_grad_matches_jax_fp32():
    e, f, g = _inputs(np.random.default_rng(0))
    want_de, want_df = _jax_vjp(e, f, g, jnp.float32)
    got_de, got_df = _torch_grads(e, f, g, torch.float32)
    np.testing.assert_allclose(got_de, want_de, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_df, want_df, rtol=1e-5, atol=1e-6)


def test_sym_conv_grad_matches_jax_bf16():
    e, f, g = _inputs(np.random.default_rng(1), k=2, v=33, d=16)
    want_de, want_df = _jax_vjp(e, f, g, jnp.bfloat16)
    got_de, got_df = _torch_grads(e, f, g, torch.bfloat16)
    for got, want in ((got_de, want_de), (got_df, want_df)):
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_sym_conv_gradcheck_float64():
    rng = np.random.default_rng(2)
    e = torch.from_numpy(rng.uniform(size=(2, 6, 6))).requires_grad_()
    f = torch.from_numpy(rng.normal(size=(2, 6, 3))).requires_grad_()
    assert torch.autograd.gradcheck(gc.sym_conv, (e, f))


def test_sym_conv_graph_survives_a_forward_without_grad_fn():
    """On the card the forward kernel writes a fresh buffer through a raw
    pointer, so its result carries no grad_fn: the gradient must come from the
    autograd function, whatever the forward returns."""
    e, f, g = _inputs(np.random.default_rng(3))
    want_de, want_df = _jax_vjp(e, f, g, jnp.float32)
    with mock.patch.object(gc, "_sym_conv_forward",
                           lambda e_, f_: gc.sym_conv_reference(e_, f_).detach()):
        got_de, got_df = _torch_grads(e, f, g, torch.float32)
    np.testing.assert_allclose(got_de, want_de, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_df, want_df, rtol=1e-5, atol=1e-6)


def test_sym_conv_bwd_skips_de_when_e_needs_no_grad():
    e, f, g = _inputs(np.random.default_rng(4))
    ft = torch.from_numpy(f).requires_grad_()
    with mock.patch.object(gc, "sym_conv_bwd", wraps=gc.sym_conv_bwd) as bwd:
        gc.sym_conv(torch.from_numpy(e), ft).backward(torch.from_numpy(g))
    assert bwd.call_args.kwargs["need_de"] is False
    assert gc.sym_conv_bwd_reference(torch.from_numpy(e), ft.detach(), torch.from_numpy(g),
                                     need_de=False)[0] is None
    np.testing.assert_allclose(ft.grad.numpy(), _jax_vjp(e, f, g, jnp.float32)[1],
                               rtol=1e-5, atol=1e-6)


def test_sym_conv_bwd_refuses_non_cuda_devices():
    e = torch.empty(2, 4, 4, device="meta")
    f = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gc.sym_conv_bwd(e, f, f)
