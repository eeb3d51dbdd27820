"""Fused multi-head self-attention with in-kernel dropout: CUDA kernels and
their plain versions.

Port of ``schemanet_tpu/ops/pallas/attention.py`` ``fused_mhsa`` (forward and
backward); the kernels are ``csrc/attention.cu``, whose header says what
bounds them on the card and how their design answers it.

``fused_mhsa(qkv, num_heads, dropout_p, seed)`` computes
``softmax(q k^T / sqrt(d)) v`` for every head on the untouched output of the
fused qkv projection (``[bs, n, (3, H, d)]``) and returns ``[bs, n, H * d]``.
Attention dropout keeps element (i, j) of (item, head) by the hash mask of
``dropmask.py``, stream ``item * H + head``, so the backward regenerates the
forward's mask instead of storing it. It is a ``torch.autograd.Function``
whose backward is the backward kernel; it saves only qkv.

Numerics follow the TPU kernels: q scaled in its own dtype, scores and
softmax in fp32, dropout ``where(keep, s * fp32(1/(1-p)), 0)`` on the fp32
probabilities, which are then rounded to v's dtype for the fp32-accumulated
AV product. Backward: ``a_lp`` and ``ds`` rounded to the qkv dtype before
their products, ``dq`` scaled by the fp32 scale after its product, ``dk``
from the scaled q.

Dispatch: a CPU tensor takes the plain versions (``fused_mhsa_reference``,
``fused_mhsa_bwd_reference``); a CUDA tensor launches the kernels or raises.
``mhsa_route`` picks the kernels by dtype: fp32 takes the FMA kernels, bf16
the tensor-core ones (head_dim a multiple of 16 up to 64). ``fused_mhsa.launches``
and ``fused_mhsa_bwd.launches`` count the launches of both routes,
``fused_mhsa.tc_launches`` and ``fused_mhsa_bwd.tc_launches`` those of the
tensor-core route.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .dropmask import hash_keep_mask, kernel_dropout_args, keep_scale
from .encoder_block import _DTYPES, _check, _require_cuda, _stream

_MAX_HEAD_DIM = 64  # csrc/attention.cu kMhsaMaxHeadDim
_MAX_TOKENS = 320  # the FMA route's K, V and score rows, in fp32, fill a block's shared memory
FMA, TENSOR_CORE = "fma", "tensor_core"


def mhsa_route(dtype: torch.dtype, n: int, head_dim: int) -> str:
    """The kernels a CUDA launch of ``fused_mhsa`` takes for qkv of this dtype,
    sequence length and head_dim: ``"fma"`` (fp32: FMA on fp32 tiles, which
    keeps fp32's agreement where tensor cores would mean TF32) or
    ``"tensor_core"`` (bf16: ``mma`` on bf16 tiles, head_dim a multiple of 16
    up to 64). Raises on what neither takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"fused_mhsa takes float32 or bfloat16, got {dtype}")
    if n > _MAX_TOKENS:
        raise ValueError(f"fused_mhsa takes n <= {_MAX_TOKENS}, got {n}")
    if dtype == torch.float32:
        if head_dim > _MAX_HEAD_DIM:
            raise ValueError(f"fused_mhsa takes head_dim <= {_MAX_HEAD_DIM} in float32, "
                             f"got {head_dim}")
        return FMA
    if head_dim % 16 or not 16 <= head_dim <= _MAX_HEAD_DIM:
        raise ValueError(f"fused_mhsa takes a bfloat16 head_dim that is a multiple of 16 up to "
                         f"{_MAX_HEAD_DIM}, got {head_dim}")
    return TENSOR_CORE


def _split(qkv: torch.Tensor, num_heads: int):
    """(q, k, v) of the fused layout, each [bs, H, n, d], and the scale."""
    bs, n, three_hd = qkv.shape
    if three_hd % (3 * num_heads):
        raise ValueError(f"qkv width {three_hd} is not 3 x {num_heads} heads")
    d = three_hd // (3 * num_heads)
    x = qkv.reshape(bs, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2], 1.0 / d**0.5


def _keep_mask(seed: int, bs: int, num_heads: int, n: int, dropout_p: float, device):
    """[bs, H, n, n] keep mask of every (item, head) stream."""
    streams = torch.arange(bs * num_heads, dtype=torch.int64, device=device)
    return hash_keep_mask(seed, streams.view(bs, num_heads), (n, n), dropout_p)


def fused_mhsa_reference(qkv: torch.Tensor, num_heads: int, dropout_p: float = 0.0,
                         seed: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the ``fused_mhsa`` forward, differentiable by
    autograd: [bs, n, 3*H*d] -> [bs, n, H*d] in qkv.dtype."""
    q, k, v, scale = _split(qkv, num_heads)
    bs, heads, n, d = q.shape
    q = q * torch.tensor(scale, dtype=qkv.dtype)
    s = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)), dim=-1)
    if dropout_p:
        keep = _keep_mask(seed, bs, heads, n, dropout_p, qkv.device)
        s = torch.where(keep, s * torch.tensor(keep_scale(dropout_p), dtype=torch.float32), 0.0)
    out = torch.matmul(s.to(qkv.dtype).float(), v.float()).to(qkv.dtype)  # [bs, H, n, d]
    return out.transpose(1, 2).reshape(bs, n, heads * d)


def fused_mhsa_bwd_reference(qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                             dropout_p: float = 0.0, seed: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the ``fused_mhsa`` backward: dqkv
    [bs, n, 3*H*d] of the output cotangent ``g`` [bs, n, H*d], rounded where
    the TPU kernel rounds."""
    q, k, v, scale = _split(qkv, num_heads)
    bs, heads, n, d = q.shape
    dt = qkv.dtype
    q_s = q * torch.tensor(scale, dtype=dt)
    g_h = g.reshape(bs, n, heads, d).transpose(1, 2).float()
    s = torch.softmax(torch.matmul(q_s.float(), k.float().transpose(-1, -2)), dim=-1)
    da = torch.matmul(g_h, v.float().transpose(-1, -2))  # dattn_used
    if dropout_p:
        keep = _keep_mask(seed, bs, heads, n, dropout_p, qkv.device)
        inv = torch.tensor(keep_scale(dropout_p), dtype=torch.float32)
        a_lp = torch.where(keep, s * inv, 0.0).to(dt)
        da = torch.where(keep, da * inv, 0.0)
    else:
        a_lp = s.to(dt)
    dv = torch.matmul(a_lp.float().transpose(-1, -2), g_h)
    ds = (s * (da - (da * s).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, k.float()) * torch.tensor(scale, dtype=torch.float32)
    dk = torch.matmul(ds.transpose(-1, -2), q_s.float())
    dqkv = torch.stack([dq, dk, dv]).to(dt)  # [3, bs, H, n, d]
    return dqkv.permute(1, 3, 0, 2, 4).reshape(bs, n, 3 * heads * d)


def _check_qkv(name: str, qkv: torch.Tensor, num_heads: int):
    """(bs, n, d, route) of a qkv the kernels take; raises on any other."""
    _require_cuda("qkv", qkv)
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"{name} takes qkv [bs, n, 3 x {num_heads} x d], got {tuple(qkv.shape)}")
    bs, n, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    route = mhsa_route(qkv.dtype, n, d)
    _check("qkv", qkv, qkv.dtype, qkv.shape)
    if route == TENSOR_CORE and qkv.data_ptr() % 16:
        raise ValueError(f"{name}: the tensor-core kernels copy 16-byte rows; qkv is not 16-byte "
                         "aligned")
    return bs, n, d, route


def _mhsa_forward(qkv: torch.Tensor, num_heads: int, dropout_p: float, seed: Optional[int]):
    """The forward alone: the kernel on CUDA, the plain version on the CPU."""
    if qkv.device.type == "cpu":
        return fused_mhsa_reference(qkv, num_heads, dropout_p, seed)
    bs, n, d, route = _check_qkv("fused_mhsa", qkv, num_heads)
    out = torch.empty((bs, n, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    err = _build.library().sn_fused_mhsa(
        _DTYPES[qkv.dtype], qkv.data_ptr(), out.data_ptr(), bs, n, num_heads, d,
        1.0 / d**0.5, *kernel_dropout_args(dropout_p, seed), _stream(),
    )
    _build.check(err, "fused_mhsa")
    fused_mhsa.launches += 1
    if route == TENSOR_CORE:
        fused_mhsa.tc_launches += 1
    return out


def fused_mhsa_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, dropout_p: float = 0.0,
                   seed: Optional[int] = None) -> torch.Tensor:
    """dqkv [bs, n, 3*H*d] of ``fused_mhsa(qkv, ...)`` for the output
    cotangent ``g`` [bs, n, H*d]: the kernel on CUDA, the plain version on
    the CPU."""
    if qkv.device.type == "cpu":
        return fused_mhsa_bwd_reference(qkv, g, num_heads, dropout_p, seed)
    bs, n, d, route = _check_qkv("fused_mhsa_bwd", qkv, num_heads)
    _check("g", g, qkv.dtype, (bs, n, num_heads * d))
    if route == TENSOR_CORE and g.data_ptr() % 16:
        raise ValueError("fused_mhsa_bwd: g is not 16-byte aligned")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((bs, num_heads, n, 3), dtype=torch.float32, device=qkv.device)
    err = _build.library().sn_fused_mhsa_bwd(
        _DTYPES[qkv.dtype], qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        bs, n, num_heads, d, 1.0 / d**0.5, *kernel_dropout_args(dropout_p, seed), _stream(),
    )
    _build.check(err, "fused_mhsa_bwd")
    fused_mhsa_bwd.launches += 1
    if route == TENSOR_CORE:
        fused_mhsa_bwd.tc_launches += 1
    return dqkv


class _FusedMhsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, dropout_p, seed):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, dropout_p, seed)
        return _mhsa_forward(qkv, num_heads, dropout_p, seed)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return fused_mhsa_bwd(qkv, g.contiguous(), *ctx.args), None, None, None


def fused_mhsa(qkv: torch.Tensor, num_heads: int, dropout_p: float = 0.0,
               seed: Optional[int] = None) -> torch.Tensor:
    """Attention of every head on the fused qkv ``[bs, n, 3*H*d]`` (float32 or
    bfloat16) -> ``[bs, n, H*d]``; differentiable in qkv. With
    ``dropout_p > 0``, attention dropout keyed on the int32 ``seed``."""
    if dropout_p and seed is None:
        raise ValueError("fused_mhsa: dropout needs a seed")
    return _FusedMhsa.apply(qkv, num_heads, float(dropout_p), seed)


fused_mhsa.launches = fused_mhsa.tc_launches = 0
fused_mhsa_bwd.launches = fused_mhsa_bwd.tc_launches = 0
