"""The port's fused LayerNorm (+relu) against the JAX package, on the CPU.

``fused_layernorm_reference`` and its autograd, the port's
``fused_layernorm`` (its autograd Function with the plain forward and the
plain backward formula on the CPU) and ``fused_layernorm_bwd_reference``
against the JAX ``fused_layernorm(interpret=True)`` and its custom VJP, for
act none and relu, fp32 and bf16. Tolerances, relative to max |JAX|:
forward 1e-5 (fp32) and 2e-2 (bf16: a last-bit fp32 difference can flip a
bf16 rounding); dx 1e-4 (fp32; bf16 2e-2, rounded to bf16), dscale and
dbias 1e-4 (fp32 sums of the same products in another order).

``GNNLayer`` is held to the JAX ``GNNLayer`` with the fused LN+relu engaged
by ``SCHEMANET_GNN_LN_BACKEND=interpret``, the variable its ``gnn_ln`` site
reads (``SCHEMANET_LN_BACKEND`` gates the backbone's LN only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models.port import from_jax_params
from schemanet_torch.ops.kernels import layernorm as lnk
from schemanet_torch.schema.gnn import GNNLayer
from schemanet_tpu.ops.pallas.layernorm import fused_layernorm as jax_fused_layernorm
from schemanet_tpu.schema.gnn import GNNLayer as JaxGNNLayer

TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


def _close(got, want, tol, name):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got.astype(np.float32) - want).max() / np.abs(want).max()
    assert err <= tol, f"{name}: {err} > {tol}"


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 37, 48)).astype(np.float32) * 2 + 0.5
    scale = (1 + 0.3 * rng.normal(size=48)).astype(np.float32)
    bias = (0.3 * rng.normal(size=48)).astype(np.float32)
    g = rng.normal(size=(3, 37, 48)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jax_in = (jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(g, jdt))
    torch_in = (torch.from_numpy(x).to(tdt), torch.from_numpy(scale), torch.from_numpy(bias),
                torch.from_numpy(g).to(tdt))
    return jax_in, torch_in


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_forward_and_gradients_match_jax(dtype, act):
    (jx, js, jb, jg), (x, scale, bias, g) = _inputs(dtype)
    fwd_tol, dx_tol = TOLS[dtype]
    want, vjp = jax.vjp(lambda *a: jax_fused_layernorm(*a, 1e-6, interpret=True, act=act),
                        jx, js, jb)
    want_grads = vjp(jg)

    for fn in (lnk.fused_layernorm_reference, lnk.fused_layernorm, lnk.fused_layernorm_plain):
        xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))
        out = fn(xs, ss, bs, 1e-6, act)
        assert out.dtype == x.dtype and out.shape == x.shape
        _close(out, want, fwd_tol, f"{fn.__name__} forward")
        out.backward(g)
        for got, w, tol, name in zip((xs.grad, ss.grad, bs.grad), want_grads,
                                     (dx_tol, 1e-4, 1e-4), ("dx", "dscale", "dbias")):
            assert got.dtype == (x.dtype if name == "dx" else torch.float32)
            _close(got, w, tol, f"{fn.__name__} {name}")

    dx, dscale, dbias = lnk.fused_layernorm_bwd_reference(x, scale, bias, g, 1e-6, act)
    for got, w, tol, name in zip((dx, dscale, dbias), want_grads, (dx_tol, 1e-4, 1e-4),
                                 ("dx", "dscale", "dbias")):
        _close(got, w, tol, f"bwd_reference {name}")


def test_layernorm_rejects_unknown_activation_and_non_cuda_devices():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="act"):
        lnk.fused_layernorm(x, torch.ones(8), torch.zeros(8), 1e-6, "gelu")
    before = lnk.fused_layernorm.launches
    lnk.fused_layernorm(x, torch.ones(8), torch.zeros(8))
    assert lnk.fused_layernorm.launches == before  # the plain version counts nothing
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lnk.fused_layernorm(meta, torch.ones(8, device="meta"), torch.zeros(8, device="meta"))


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_gnn_layer_matches_jax_fused_gnn_ln(monkeypatch, activation):
    """Values and gradients (params, edges, feat) within 1e-4 of max: the
    JAX layer with its fused LN (+relu) in interpret mode, the port's
    through ``fused_layernorm`` (relu fused where the activation is relu)."""
    monkeypatch.setenv("SCHEMANET_GNN_LN_BACKEND", "interpret")
    rng = np.random.default_rng(1)
    k, v, d = 5, 12, 32
    edges = rng.random((k, v, v)).astype(np.float32)
    feat = rng.normal(size=(k, v, d)).astype(np.float32)
    mask = rng.random((k, v)) < 0.25
    layer_j = JaxGNNLayer(embed_dim=d, activation=activation)
    params = layer_j.init(jax.random.PRNGKey(0), jnp.asarray(edges), jnp.asarray(feat),
                          jnp.asarray(mask))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)

    def loss_j(p, e, f):
        return (layer_j.apply({"params": p}, e, f, jnp.asarray(mask)) ** 2).sum()

    out_j = layer_j.apply({"params": params}, jnp.asarray(edges), jnp.asarray(feat),
                          jnp.asarray(mask))
    g_p, g_e, g_f = jax.grad(loss_j, argnums=(0, 1, 2))(params, jnp.asarray(edges),
                                                         jnp.asarray(feat))

    layer = GNNLayer(d, activation)
    layer.load_state_dict(from_jax_params(params, {}, layer))
    e, f = (torch.from_numpy(a).requires_grad_() for a in (edges, feat))
    out = layer(e, f, torch.from_numpy(mask))
    _close(out, out_j, 1e-4, "forward")
    (out ** 2).sum().backward()
    _close(e.grad, g_e, 1e-4, "d edges")
    _close(f.grad, g_f, 1e-4, "d feat")
    want = {name: np.asarray(t) for name, t in from_jax_params(
        jax.tree_util.tree_map(np.asarray, g_p), {}).items()}
    for name, prm in layer.named_parameters():
        _close(prm.grad, want[name], 1e-4, f"d {name}")
