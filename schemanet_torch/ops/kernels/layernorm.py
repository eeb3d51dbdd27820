"""Fused LayerNorm with an optional relu, forward and backward: CUDA kernels
and their plain versions.

Port of ``schemanet_tpu/ops/pallas/layernorm.py`` ``fused_layernorm``; the
kernels are ``csrc/layernorm.cu``, whose header says what bounds them on the
card and how their design answers it.

``fused_layernorm(x, scale, bias, eps, act)`` is ``act(LN(x))`` over the last
axis of x [..., d] (d <= 1024), output in x.dtype: statistics in fp32 with
flax's fast variance ``max(E[x^2] - E[x]^2, 0)``, ``rsqrt(var + eps)``, fp32
scale and bias, relu (``act="relu"``) after the affine. It is a
``torch.autograd.Function`` whose backward is the second kernel: it
recomputes the statistics and y, gates the cotangent by ``y > 0`` for relu,
and returns dx in x.dtype and dscale, dbias in the parameters' dtype, summed
in fp32 over the rows in a fixed order (the same bits from run to run).

The backward is bound by bytes (x and g read, dx written). Its kernel moves
rows in 16-byte pieces a lane, two rows a warp in flight, on a grid sized to
what the card holds at once; each block writes one fp32 partial of dscale
and dbias and a second launch adds the partials, 32 columns a block, in a
fixed order. ``piece_route`` names the route: ``"vector"`` where a row is a
whole number of 16-byte pieces (d a multiple of 8 in bf16, of 4 in fp32) and
x, g and dx are 16-byte aligned, else ``"scalar"``, the same kernel with one
value a piece.

Dispatch: a CPU tensor takes the plain versions (``fused_layernorm_reference``
for the forward, ``fused_layernorm_bwd_reference`` for the backward); a CUDA
tensor launches the kernels or raises. ``fused_layernorm_plain`` takes the
plain versions on any device. ``fused_layernorm.launches`` and
``fused_layernorm_bwd.launches`` count the launches,
``fused_layernorm_bwd.vec_launches`` those of the backward's vector route,
and the two wrappers' ``shape_launches`` the launches by ``(rows, d)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .encoder_block import (VECTOR, _DTYPES, _check, _require_cuda, _stream, count_shape,
                            layer_norm, piece_route)

_ACTS = ("none", "relu")
_MAX_DIM = 1024  # csrc/layernorm.cu kLnMaxDim: up to 32 values a lane
_BWD_MAX_BLOCKS = 1024  # csrc/layernorm.cu kLnBwdMaxBlocks: the backward's blocks at most
_WARPS = 8  # csrc/layernorm.cu kLnWarps: a block has at least one row


def _check_act(act: str) -> None:
    if act not in _ACTS:
        raise ValueError(f"fused_layernorm takes act in {_ACTS}, got {act!r}")


def fused_layernorm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              eps: float = 1e-6, act: str = "none") -> torch.Tensor:
    """Plain PyTorch version of the forward, differentiable by autograd: the
    port's flax-semantics ``layer_norm``, then the activation."""
    _check_act(act)
    y = layer_norm(x, scale, bias, eps)
    return torch.relu(y) if act == "relu" else y


def fused_layernorm_bwd_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                  g: torch.Tensor, eps: float = 1e-6, act: str = "none"
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, the formula of the TPU kernel:
    (dx in x.dtype, fp32 dscale, fp32 dbias)."""
    _check_act(act)
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    sc = scale.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    r = torch.rsqrt(var + eps)
    xhat = (xf - mean) * r
    if act == "relu":  # gate by the recomputed y
        gf = torch.where(xhat * sc + bias.float() > 0, gf, torch.zeros_like(gf))
    ga = gf * sc
    dx = r * (ga - ga.mean(dim=-1, keepdim=True)
              - xhat * (ga * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype).reshape(x.shape), (gf * xhat).sum(dim=0), gf.sum(dim=0)


def check_width(dtype: torch.dtype, d: int, name: str = "fused_layernorm") -> None:
    """Raises unless the kernels take rows of this dtype and width d (float32
    or bfloat16, 1..1024)."""
    if dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dtype}")
    if not 0 < d <= _MAX_DIM:
        raise ValueError(f"{name} takes width 1..{_MAX_DIM}, got {d}")


def _check_ln(name: str, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, act: str):
    _require_cuda("x", x)
    _check_act(act)
    d = x.shape[-1]
    check_width(x.dtype, d, name)
    _check("x", x, x.dtype, x.shape)
    _check("scale", scale, torch.float32, (d,))
    _check("bias", bias, torch.float32, (d,))
    return x.numel() // d, d


def _ln_forward(x, scale, bias, eps, act):
    """The forward alone, fp32 scale and bias: the kernel on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return fused_layernorm_reference(x, scale, bias, eps, act)
    rows, d = _check_ln("fused_layernorm", x, scale, bias, act)
    y = torch.empty_like(x)
    err = _build.library().sn_layernorm_fwd(
        _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, d,
        float(eps), int(act == "relu"), _stream(),
    )
    _build.check(err, "fused_layernorm")
    _counted[0].launches += 1
    count_shape(_counted[0], (rows, d))
    return y


def fused_layernorm_bwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        g: torch.Tensor, eps: float = 1e-6, act: str = "none"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x.dtype, fp32 dscale, fp32 dbias) of ``fused_layernorm`` for the
    output cotangent g, fp32 scale and bias: the kernels on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return fused_layernorm_bwd_reference(x, scale, bias, g, eps, act)
    rows, d = _check_ln("fused_layernorm_bwd", x, scale, bias, act)
    _check("g", g, x.dtype, x.shape)
    dx = torch.empty_like(x)
    route = piece_route(x.dtype, d, x.data_ptr(), g.data_ptr(), dx.data_ptr())
    blocks = max(1, min(-(-rows // _WARPS), _BWD_MAX_BLOCKS))
    part = torch.empty((blocks, 2 * d), dtype=torch.float32, device=x.device)
    dparam = torch.empty(2 * d, dtype=torch.float32, device=x.device)
    err = _build.library().sn_layernorm_bwd(
        _DTYPES[x.dtype], int(route == VECTOR), x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        g.data_ptr(), dx.data_ptr(), part.data_ptr(), dparam.data_ptr(), rows, d, float(eps),
        int(act == "relu"), _stream(),
    )
    _build.check(err, "fused_layernorm_bwd")
    _counted[1].launches += 1
    count_shape(_counted[1], (rows, d))
    if route == VECTOR:
        _counted[1].vec_launches += 1
    return dx, dparam[:d], dparam[d:]


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, act, plain):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (eps, act)
        ctx.plain = plain
        if plain:
            return fused_layernorm_reference(x, scale, bias, eps, act)
        return _ln_forward(x, scale, bias, eps, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        bwd = fused_layernorm_bwd_reference if ctx.plain else fused_layernorm_bwd
        dx, dscale, dbias = bwd(x, scale, bias, g.contiguous(), *ctx.args)
        return dx, dscale, dbias, None, None, None


def _apply(x, scale, bias, eps, act, plain):
    return _FusedLayerNorm.apply(x.contiguous(), scale.float().contiguous(),
                                 bias.float().contiguous(), float(eps), act, plain)


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6, act: str = "none") -> torch.Tensor:
    """``act(LayerNorm(x))`` over the last axis of x [..., d] (float32 or
    bfloat16), in x.dtype; differentiable in x, scale and bias, whose
    gradients come back in their own dtype (through the cast to fp32)."""
    return _apply(x, scale, bias, eps, act, plain=False)


def fused_layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          eps: float = 1e-6, act: str = "none") -> torch.Tensor:
    """``fused_layernorm`` with both plain versions on any device: the
    forward ``fused_layernorm_reference``, the backward
    ``fused_layernorm_bwd_reference`` (the kernel's formula, not autograd of
    the forward's operations, which rounds elsewhere). What a run on the
    plain versions puts in the kernels' place."""
    return _apply(x, scale, bias, eps, act, plain=True)


fused_layernorm.launches = 0
fused_layernorm_bwd.launches = fused_layernorm_bwd.vec_launches = 0
fused_layernorm.shape_launches, fused_layernorm_bwd.shape_launches = {}, {}
# the counters are reached through these second names, so that a caller who
# wraps or replaces the wrappers in this module still counts into them
_counted = (fused_layernorm, fused_layernorm_bwd)
