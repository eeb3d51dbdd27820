"""GraphConv forward ``((E + E^T)/2 + I) @ f``: CUDA kernel and plain version.

Port of the forward of ``schemanet_tpu/ops/pallas/graphconv.py`` ``sym_conv``;
the kernel is ``csrc/graphconv.cu``, whose header says what bounds it on the
card and how its design answers it. The TPU's VMEM shape gate
(``shape_fits_kernel``) has no meaning on Hopper and is not ported: every
GraphConv of the port, instance graphs and class graphs alike, takes the
kernel. The backward is training work and waits for a later change.

Rounding follows the TPU kernel: ``e_ij + e_ji`` rounded to the dtype, times
0.5, plus the identity rounded to the dtype, then one fp32-accumulated product
rounded once to the dtype.

Dispatch: a CPU tensor takes ``sym_conv_reference``; a CUDA tensor launches
the kernel or raises. ``sym_conv.launches`` counts the launches.
"""

from __future__ import annotations

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
    the CPU kernels do for bf16)."""
    return torch.matmul(symmetrize_edges(e), f)


def sym_conv(e: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """((E + E^T)/2 + I) @ f per leading batch entry: e [K, V, V], f [K, V, D]
    of one dtype -> [K, V, D]."""
    if e.device.type == "cpu":
        return sym_conv_reference(e, f)
    _require_cuda("e", e)
    k, v, d = f.shape
    if f.dtype not in _DTYPES:
        raise TypeError(f"sym_conv takes float32 or bfloat16, got {f.dtype}")
    _check("e", e, f.dtype, (k, v, v))
    _check("f", f, f.dtype, (k, v, d))
    out = torch.empty_like(f)
    err = _build.library().sn_sym_conv(
        _DTYPES[f.dtype], e.data_ptr(), f.data_ptr(), out.data_ptr(), k, v, d, _stream()
    )
    _build.check(err, "sym_conv")
    sym_conv.launches += 1
    return out


sym_conv.launches = 0
