"""Nearest-code assignment (VQ): CUDA kernel and plain version.

Port of ``schemanet_tpu/ops/pallas/vq.py`` ``vq_assign_pallas``; the kernel is
``csrc/vq.cu``, whose header says what bounds it on the card and how its
design answers it (a streaming argmin on the tensor cores: the ``[N, M]``
score matrix never reaches device memory).

``ids = argmin_m (||c_m||^2 - 2 x . c_m)``, the first minimum on ties, int32
with the leading shape of x. The score follows the port's ``vq_assign``
(``schemanet_tpu/ops/vq.py``'s default path), not the Pallas kernel's
all-fp32 cast: bf16 inputs round the codebook to bf16 and score in fp32 (the
products of bf16 values are exact in fp32); any other input scores in fp32.
For fp32 inputs the two JAX functions agree.

``vq_route`` names the kernel's route: fp32 takes the 3xTF32 split (each
fp32 product as three TF32 products, the smallest dropped: about fp32's
accuracy, where one TF32 product would move ids), bf16 the bf16 tensor-core
product. Either sums each dot product in another order than the plain
version's matrix product, so where two codes' scores are within a few fp32
ulps of each other the two may pick different codes; elsewhere they agree.

Dispatch: a CPU tensor takes ``vq_assign_reference``; a CUDA tensor launches
the kernel or raises. ``vq_assign_kernel.launches`` counts the launches,
``vq_assign_kernel.tc_launches`` those on the tensor-core routes (all of
them). A call launches once and allocates only its ids: the segments'
partials and tickets are a scratch kept per device and stream.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build
from .encoder_block import _DTYPES, _check, _require_cuda, _stream

_ROW_TILE, _CODE_TILE = 64, 128  # csrc/vq.cu kVqRows, kVqCodes
_BLOCKS = 2 * 132  # two resident blocks for each SM of an H100
SPLIT_TF32, TENSOR_CORE = "split_tf32", "tensor_core"
# (device, stream) -> (tickets, partials): the segments' scratch, grown as needed
_scratch: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def vq_route(dtype: torch.dtype, d: int) -> str:
    """The kernel route of a CUDA launch that scores in ``dtype`` at width
    ``d``: ``"split_tf32"`` (fp32: three TF32 products per fp32 product) or
    ``"tensor_core"`` (bf16). d must be a positive multiple of 8 (rows are
    copied in 16-byte pieces). Raises on anything else: there is no other
    kernel to fall back to."""
    if dtype == torch.float32:
        route = SPLIT_TF32
    elif dtype == torch.bfloat16:
        route = TENSOR_CORE
    else:
        raise TypeError(f"vq_assign_kernel scores in float32 or bfloat16, got {dtype}")
    if d < 8 or d % 8:
        raise ValueError(f"vq_assign_kernel takes a width that is a multiple of 8, got {d}")
    return route


def segments(n: int, m: int) -> int:
    """Code segments of a launch: enough (row tile, segment) blocks to fill
    the card twice over when the rows are few, whole code tiles each, the
    count ``csrc/vq.cu`` launches."""
    row_tiles, code_tiles = -(-n // _ROW_TILE), -(-m // _CODE_TILE)
    wanted = max(1, min(code_tiles, _BLOCKS // max(row_tiles, 1)))
    per_segment = -(-code_tiles // wanted)
    return -(-code_tiles // per_segment)


def _segment_scratch(dev: torch.device, n: int, segs: int):
    """(tickets, partials) of at least ceil(n / 64) int32 zeros and 2 segs n
    words, kept for this device and stream; each launch leaves the tickets
    zero again."""
    key = (dev, _stream())
    tickets, part = _scratch.get(key, (None, None))
    if tickets is None or tickets.numel() < -(-n // _ROW_TILE):
        tickets = torch.zeros(max(-(-n // _ROW_TILE), 64), dtype=torch.int32, device=dev)
    if part is None or part.numel() < 2 * segs * n:
        part = torch.empty(2 * segs * n, dtype=torch.int32, device=dev)
    _scratch[key] = (tickets, part)
    return tickets, part


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
    vq_route(flat.dtype, d)
    if m == 0:
        raise ValueError("vq_assign_kernel: empty codebook")
    if n * d >= 2**31 or m * d >= 2**31:
        raise ValueError(f"vq_assign_kernel: shape [{n}, {d}] x [{m}, {d}] too large")
    _check("x", flat, flat.dtype, (n, d))
    _check("codebook", cb, flat.dtype, (m, d))
    if flat.data_ptr() % 16 or cb.data_ptr() % 16:
        raise ValueError("vq_assign_kernel copies 16-byte pieces; x or the codebook is not "
                         "16-byte aligned")
    segs = segments(n, m)
    tickets, part = _segment_scratch(x.device, n, segs) if segs > 1 else (None, None)
    ids = torch.empty(n, dtype=torch.int32, device=x.device)
    err = _build.library().sn_vq_assign(
        _DTYPES[flat.dtype], flat.data_ptr(), cb.data_ptr(),
        None if tickets is None else tickets.data_ptr(), None if part is None else part.data_ptr(),
        ids.data_ptr(), n, m, d, segs, _stream(),
    )
    _build.check(err, "vq_assign")
    _counted.launches += 1
    _counted.tc_launches += 1
    return ids.reshape(x.shape[:-1])


vq_assign_kernel.launches = vq_assign_kernel.tc_launches = 0
# the counters are reached by this second name, so that a caller who wraps or
# replaces ``vq_assign_kernel`` in this module still counts into them
_counted = vq_assign_kernel
