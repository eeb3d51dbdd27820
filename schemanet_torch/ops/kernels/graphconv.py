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
tensor launches the kernel or raises. ``conv_route`` picks the kernels by
dtype: fp32 takes the FMA kernels, bf16 the tensor-core ones (any V, D a
multiple of 8). ``sym_conv.launches`` and ``sym_conv_bwd.launches`` count
the launches of both routes, ``sym_conv.tc_launches`` and
``sym_conv_bwd.tc_launches`` those of the tensor-core route, and
``sym_conv.shape_launches`` and ``sym_conv_bwd.shape_launches`` the launches
by graph shape ``(K, V, D)``, which tells the class graphs from the instance
graphs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .encoder_block import _DTYPES, _check, _require_cuda, _stream, count_shape

FMA, TENSOR_CORE = "fma", "tensor_core"


def conv_route(dtype: torch.dtype, v: int, d: int) -> str:
    """The kernels a CUDA launch of ``sym_conv`` or ``sym_conv_bwd`` takes for
    graphs of this dtype, V vertices and width D: ``"fma"`` (fp32: FMA on
    fp32 tiles, which keeps fp32's agreement where tensor cores would mean
    TF32) or ``"tensor_core"`` (bf16: ``mma`` on bf16 tiles, any V, D a
    multiple of 8, since f's rows are copied in 16-byte chunks). Raises on
    what neither takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"sym_conv takes float32 or bfloat16, got {dtype}")
    if v < 1 or d < 1:
        raise ValueError(f"sym_conv takes graphs of V >= 1 and D >= 1, got V={v}, D={d}")
    if dtype == torch.float32:
        return FMA
    if d % 8:
        raise ValueError(f"sym_conv takes a bfloat16 width D that is a multiple of 8, got {d}")
    return TENSOR_CORE


def symmetrize_edges(e: torch.Tensor) -> torch.Tensor:
    """E_sym = 0.5 (E + E^T) + I, every step rounded to e.dtype."""
    eye = torch.eye(e.shape[-1], dtype=e.dtype, device=e.device)
    return 0.5 * (e + e.transpose(-1, -2)) + eye


def sym_conv_reference(e: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``sym_conv``: E_sym materialised, one batched
    product in f.dtype (accumulated in fp32 and rounded once, as cuBLAS and
    the CPU kernels do for bf16). Differentiable by autograd."""
    return torch.matmul(symmetrize_edges(e), f)


def sym_conv_two_reference(e: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The plain conv in the JAX package's ``symconv: two`` form: ``(E f +
    E^T f) / 2 + f``, two batched products and no E_sym. Differentiable by
    autograd."""
    return 0.5 * (torch.matmul(e, f) + torch.matmul(e.transpose(-1, -2), f)) + f


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


def _check_conv(name: str, e: torch.Tensor, f: torch.Tensor, *more: torch.Tensor):
    """(k, v, d, route) of graphs the kernels take; raises on any other.
    ``more``: further [K, V, D] operands (the backward's g)."""
    _require_cuda("e", e)
    if f.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {f.dtype}")
    if f.ndim != 3:
        raise ValueError(f"{name} takes f of shape [K, V, D], got {tuple(f.shape)}")
    k, v, d = f.shape
    route = conv_route(f.dtype, v, d)
    _check("e", e, f.dtype, (k, v, v))
    for label, t in (("f", f), *(("g", t) for t in more)):
        _check(label, t, f.dtype, (k, v, d))
    if route == TENSOR_CORE and any(t.data_ptr() % 16 for t in (e, f, *more)):
        raise ValueError(f"{name}: the tensor-core kernels copy 16-byte chunks; an operand is not "
                         "16-byte aligned")
    return k, v, d, route


def _sym_conv_forward(e: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The forward alone, no autograd: the kernel on CUDA, the plain version
    on the CPU."""
    if e.device.type == "cpu":
        return sym_conv_reference(e, f)
    k, v, d, route = _check_conv("sym_conv", e, f)
    out = torch.empty_like(f)
    err = _build.library().sn_sym_conv(
        _DTYPES[f.dtype], e.data_ptr(), f.data_ptr(), out.data_ptr(), k, v, d, _stream()
    )
    _build.check(err, "sym_conv")
    sym_conv.launches += 1
    count_shape(sym_conv, (k, v, d))
    if route == TENSOR_CORE:
        sym_conv.tc_launches += 1
    return out


def sym_conv_bwd(
    e: torch.Tensor, f: torch.Tensor, g: torch.Tensor, need_de: bool = True
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Cotangents ``(de, df)`` of ``sym_conv(e, f)`` for the output cotangent
    ``g`` [K, V, D]; ``de`` [K, V, V] is skipped (None) when not needed."""
    if e.device.type == "cpu":
        return sym_conv_bwd_reference(e, f, g, need_de)
    k, v, d, route = _check_conv("sym_conv_bwd", e, f, g)
    df = torch.empty_like(g)
    de = torch.empty_like(e) if need_de else None
    err = _build.library().sn_sym_conv_bwd(
        _DTYPES[f.dtype], e.data_ptr(), f.data_ptr(), g.data_ptr(), df.data_ptr(),
        de.data_ptr() if de is not None else None, k, v, d, _stream(),
    )
    _build.check(err, "sym_conv_bwd")
    sym_conv_bwd.launches += 1
    count_shape(sym_conv_bwd, (k, v, d))
    if route == TENSOR_CORE:
        sym_conv_bwd.tc_launches += 1
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


sym_conv.launches = sym_conv.tc_launches = 0
sym_conv_bwd.launches = sym_conv_bwd.tc_launches = 0
sym_conv.shape_launches, sym_conv_bwd.shape_launches = {}, {}
