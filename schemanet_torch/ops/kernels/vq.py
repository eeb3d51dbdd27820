"""Nearest-code assignment (VQ): CUDA kernel and plain version.

Port of ``schemanet_tpu/ops/pallas/vq.py`` ``vq_assign_pallas``; the kernel is
``csrc/vq.cu``, whose header says what bounds it on the card and how its
design answers it (a streaming argmin: the ``[N, M]`` score matrix never
reaches device memory).

``ids = argmin_m (||c_m||^2 - 2 x . c_m)``, the first minimum on ties, int32
with the leading shape of x. The score follows the port's ``vq_assign``
(``schemanet_tpu/ops/vq.py``'s default path), not the Pallas kernel's
all-fp32 cast: bf16 inputs round the codebook to bf16 and score in fp32 (the
products of bf16 values are exact in fp32); any other input scores in fp32.
For fp32 inputs the two JAX functions agree.

The kernel sums each dot product in another order than the plain version's
matrix product, so where two codes' scores are within a few fp32 ulps of
each other the two may pick different codes; elsewhere they agree.

Dispatch: a CPU tensor takes ``vq_assign_reference``; a CUDA tensor launches
the kernel or raises. ``vq_assign_kernel.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .encoder_block import _DTYPES, _check, _require_cuda, _stream

_ROW_TILE, _CODE_TILE = 64, 64  # csrc/vq.cu kVqBN, kVqBM
_MIN_BLOCKS = 2 * 132  # two blocks for each SM of an H100


def _operands(x: torch.Tensor, codebook: torch.Tensor):
    """(x as [N, d], codebook) in the scoring dtype: bf16 for bf16 x, else fp32."""
    dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    return x.reshape(-1, x.shape[-1]).to(dt), codebook.to(dt)


def vq_assign_reference(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``vq_assign_kernel``: one fp32 score matrix
    and ``torch.argmin`` (the first minimum)."""
    flat, cb = _operands(x, codebook)
    flat, cb = flat.float(), cb.float()
    scores = (cb * cb).sum(dim=-1)[None, :] - 2.0 * (flat @ cb.t())
    return torch.argmin(scores, dim=-1).int().reshape(x.shape[:-1])


def score_gaps(x: torch.Tensor, codebook: torch.Tensor, ids_a: torch.Tensor,
               ids_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row where two assignments differ, how near a tie they are:
    ``(|s[a] - s[b]|, max_m |s[m]|)`` with the plain version's scores s of
    that row. Both empty when the assignments agree."""
    flat, cb = _operands(x, codebook)
    rows = (ids_a.reshape(-1) != ids_b.reshape(-1)).nonzero()[:, 0]
    sub, cb = flat[rows].float(), cb.float()
    scores = (cb * cb).sum(dim=-1)[None, :] - 2.0 * (sub @ cb.t())
    a = scores.gather(1, ids_a.reshape(-1)[rows].long()[:, None])[:, 0]
    b = scores.gather(1, ids_b.reshape(-1)[rows].long()[:, None])[:, 0]
    return (a - b).abs(), scores.abs().amax(dim=1)


def vq_assign_kernel(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-code ids (int32) of x [..., d] against codebook [M, d]."""
    if x.device.type == "cpu":
        return vq_assign_reference(x, codebook)
    _require_cuda("x", x)
    if codebook.ndim != 2 or codebook.shape[-1] != x.shape[-1]:
        raise ValueError(f"codebook must be [M, {x.shape[-1]}], got {tuple(codebook.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"vq_assign_kernel takes float32 or bfloat16 x, got {x.dtype}")
    flat, cb = _operands(x, codebook)
    flat, cb = flat.contiguous(), cb.contiguous()
    (n, d), m = flat.shape, cb.shape[0]
    if m == 0:
        raise ValueError("vq_assign_kernel: empty codebook")
    if n * d >= 2**31 or m * d >= 2**31:
        raise ValueError(f"vq_assign_kernel: shape [{n}, {d}] x [{m}, {d}] too large")
    _check("x", flat, flat.dtype, (n, d))
    _check("codebook", cb, flat.dtype, (m, d))
    row_tiles, code_tiles = -(-n // _ROW_TILE), -(-m // _CODE_TILE)
    segments = max(1, min(code_tiles, -(-_MIN_BLOCKS // max(row_tiles, 1))))
    dev = x.device
    cnorm = torch.empty(m, dtype=torch.float32, device=dev)
    part_s = torch.empty((segments, n), dtype=torch.float32, device=dev)
    part_i = torch.empty((segments, n), dtype=torch.int32, device=dev)
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    err = _build.library().sn_vq_assign(
        _DTYPES[flat.dtype], flat.data_ptr(), cb.data_ptr(), cnorm.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), ids.data_ptr(), n, m, d, segments, _stream(),
    )
    _build.check(err, "vq_assign")
    _counted.launches += 1
    return ids.reshape(x.shape[:-1])


vq_assign_kernel.launches = 0
# the counter is reached by this second name, so that a caller who wraps or
# replaces ``vq_assign_kernel`` in this module still counts into it
_counted = vq_assign_kernel
