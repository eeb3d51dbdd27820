"""GraphConv ``((E + E^T)/2 + I) @ f`` and its backward: CUDA kernels and
their plain versions.

Port of ``schemanet_tpu/ops/pallas/graphconv.py``: ``sym_conv`` (forward) and
``_sym_conv_bwd``. The kernels are in ``csrc/graphconv.cu``, whose header
says what bounds them on the card and how their design answers it. The TPU's
VMEM shape gate (``shape_fits_kernel``) has no meaning on Hopper and is not
ported: every GraphConv of the port, instance graphs and class graphs alike,
takes the kernels.

``sym_conv`` is a ``torch.autograd.Function``, like the JAX custom VJP: it
saves the raw ``e`` and ``f`` (never E_sym, which would be a second
``[K, V, V]`` tensor kept alive for the backward) and its backward is
``sym_conv_bwd``. The kernels write into fresh buffers through raw pointers,
so the gradient can only come from the Function.

Rounding follows the TPU kernels: ``e_ij + e_ji`` rounded to the dtype, times
0.5, plus the identity rounded to the dtype; each product accumulated in fp32
and rounded once. In the backward, ``df = E_sym g`` rounds like the forward,
and ``t = g f^T`` stays fp32 through ``dE = (t + t^T)/2``, rounded once.

Dispatch: a CPU tensor takes the plain version (``*_reference``); a CUDA
tensor launches the kernel or raises. ``sym_conv.launches`` and
``sym_conv_bwd.launches`` count the launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .encoder_block import _DTYPES, _check, _require_cuda, _stream


def symmetrize_edges(e: torch.Tensor) -> torch.Tensor:
    """E_sym = 0.5 (E + E^T) + I, every step rounded to e.dtype."""
    eye = torch.eye(e.shape[-1], dtype=e.dtype, device=e.device)
    return 0.5 * (e + e.transpose(-1, -2)) + eye


def sym_conv_reference(e: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``sym_conv``: E_sym materialised, one batched
    product in f.dtype (accumulated in fp32 and rounded once, as cuBLAS and
    the CPU kernels do for bf16). Differentiable by autograd."""
    return torch.matmul(symmetrize_edges(e), f)


def sym_conv_bwd_reference(
    e: torch.Tensor, f: torch.Tensor, g: torch.Tensor, need_de: bool = True
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of ``sym_conv_bwd``: ``(de, df)`` with
    df = E_sym g and de = (t + t^T)/2, t = g f^T in fp32; ``de`` is None
    when ``need_de`` is False."""
    df = torch.matmul(symmetrize_edges(e), g)
    if not need_de:
        return None, df
    t = torch.matmul(g.float(), f.float().transpose(-1, -2))
    return (0.5 * (t + t.transpose(-1, -2))).to(e.dtype), df


def _check_conv(name: str, e: torch.Tensor, f: torch.Tensor):
    _require_cuda("e", e)
    if f.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {f.dtype}")
    if f.ndim != 3:
        raise ValueError(f"{name} takes f of shape [K, V, D], got {tuple(f.shape)}")
    k, v, d = f.shape
    _check("e", e, f.dtype, (k, v, v))
    _check("f", f, f.dtype, (k, v, d))
    return k, v, d


def _sym_conv_forward(e: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The forward alone, no autograd: the kernel on CUDA, the plain version
    on the CPU."""
    if e.device.type == "cpu":
        return sym_conv_reference(e, f)
    k, v, d = _check_conv("sym_conv", e, f)
    out = torch.empty_like(f)
    err = _build.library().sn_sym_conv(
        _DTYPES[f.dtype], e.data_ptr(), f.data_ptr(), out.data_ptr(), k, v, d, _stream()
    )
    _build.check(err, "sym_conv")
    sym_conv.launches += 1
    return out


def sym_conv_bwd(
    e: torch.Tensor, f: torch.Tensor, g: torch.Tensor, need_de: bool = True
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Cotangents ``(de, df)`` of ``sym_conv(e, f)`` for the output cotangent
    ``g`` [K, V, D]; ``de`` [K, V, V] is skipped (None) when not needed."""
    if e.device.type == "cpu":
        return sym_conv_bwd_reference(e, f, g, need_de)
    k, v, d = _check_conv("sym_conv_bwd", e, f)
    _check("g", g, f.dtype, (k, v, d))
    df = torch.empty_like(g)
    de = torch.empty_like(e) if need_de else None
    err = _build.library().sn_sym_conv_bwd(
        _DTYPES[f.dtype], e.data_ptr(), f.data_ptr(), g.data_ptr(), df.data_ptr(),
        de.data_ptr() if de is not None else None, k, v, d, _stream(),
    )
    _build.check(err, "sym_conv_bwd")
    sym_conv_bwd.launches += 1
    return de, df


class _SymConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, f):
        ctx.save_for_backward(e, f)
        return _sym_conv_forward(e, f)

    @staticmethod
    def backward(ctx, g):
        e, f = ctx.saved_tensors
        de, df = sym_conv_bwd(e, f, g.contiguous(), need_de=ctx.needs_input_grad[0])
        return de, df


def sym_conv(e: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """((E + E^T)/2 + I) @ f per leading batch entry: e [K, V, V], f [K, V, D]
    of one dtype -> [K, V, D]. Differentiable in both arguments."""
    return _SymConv.apply(e, f)


sym_conv.launches = 0
sym_conv_bwd.launches = 0
