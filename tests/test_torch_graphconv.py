"""The port's GraphConv forward (plain version, CPU) against the JAX package's
Pallas ``sym_conv`` in interpret mode, and the port's ``GraphConv`` module.

fp32: rtol 1e-5 / atol 1e-6 (fp32 summation order only). bf16: the E_sym
roundings are reproduced step for step, so only the fp32 accumulation order
and the final rounding differ: 2e-2 (a few bf16 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.ops.kernels import graphconv as gc
from schemanet_torch.ops.kernels.graphconv import sym_conv, sym_conv_reference
from schemanet_torch.schema.gnn import GraphConv
from schemanet_tpu.ops.pallas.graphconv import sym_conv as jax_sym_conv
from schemanet_tpu.schema.gnn import _sym_conv as jax_xla_sym_conv


def _inputs(rng, k=3, v=20, d=8):
    e = rng.uniform(0.0, 1.0, size=(k, v, v)).astype(np.float32)
    f = rng.normal(size=(k, v, d)).astype(np.float32)
    return e, f


@pytest.mark.parametrize(
    "dtype,rtol,atol", [("float32", 1e-5, 1e-6), ("bfloat16", 2e-2, 2e-2)]
)
def test_sym_conv_matches_jax(dtype, rtol, atol):
    e, f = _inputs(np.random.default_rng(0))
    want = jax_sym_conv(jnp.asarray(e, dtype), jnp.asarray(f, dtype), True)
    got = sym_conv(torch.from_numpy(e).to(getattr(torch, dtype)),
                   torch.from_numpy(f).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=atol
    )
    # the wrapper took the plain version because the tensors lie on the CPU
    torch.testing.assert_close(
        got, sym_conv_reference(torch.from_numpy(e).to(got.dtype), torch.from_numpy(f).to(got.dtype)),
        rtol=0, atol=0,
    )


def test_graph_conv_module_matches_jax_conv_then_dense():
    """GraphConv = sym_conv then Linear, in fp32, against the JAX XLA conv."""
    rng = np.random.default_rng(1)
    e, f = _inputs(rng, d=16)
    w = rng.normal(size=(16, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    conv = GraphConv(16)
    with torch.no_grad():
        conv.linear.weight.copy_(torch.from_numpy(w.T))
        conv.linear.bias.copy_(torch.from_numpy(b))
        got = conv(torch.from_numpy(e), torch.from_numpy(f)).numpy()
    want = np.asarray(jax_xla_sym_conv(jnp.asarray(e), jnp.asarray(f))) @ w + b
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,v,d,route", [
    (torch.float32, 1024, 256, "fma"),
    (torch.float32, 70, 40, "fma"),
    (torch.float32, 33, 12, "fma"),  # fp32 takes any D
    (torch.bfloat16, 1024, 256, "tensor_core"),  # CIFAR class graphs
    (torch.bfloat16, 196, 256, "tensor_core"),  # instance graphs: rows 8-byte aligned
    (torch.bfloat16, 500, 1024, "tensor_core"),  # ImageNet class graphs
    (torch.bfloat16, 70, 40, "tensor_core"),  # rows 4-byte aligned
    (torch.bfloat16, 33, 8, "tensor_core"),  # odd V: plain loads
])
def test_conv_route(dtype, v, d, route):
    """The CUDA kernels a GraphConv launch takes: fp32 keeps the FMA kernels,
    bf16 the tensor-core ones at any V."""
    assert gc.conv_route(dtype, v, d) == route


@pytest.mark.parametrize("dtype,v,d,what", [
    (torch.bfloat16, 196, 12, "multiple of 8"),
    (torch.bfloat16, 1024, 100, "multiple of 8"),
    (torch.bfloat16, 0, 256, "V >= 1"),
    (torch.float32, 64, 0, "D >= 1"),
])
def test_conv_route_rejects(dtype, v, d, what):
    """No quiet fallback: a bf16 width the tensor-core kernels do not take
    raises."""
    with pytest.raises(ValueError, match=what):
        gc.conv_route(dtype, v, d)


def test_conv_route_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        gc.conv_route(torch.float16, 64, 64)


def test_sym_conv_refuses_non_cuda_devices():
    e = torch.empty(2, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sym_conv(e, torch.empty(2, 4, 8, device="meta"))
