"""Embedding-table gradient: CUDA kernels and plain version.

Port of ``schemanet_tpu/ops/pallas/embed_bwd.py`` ``embed_grad``; the kernels
are ``csrc/embed_bwd.cu``, whose header says what bounds them on the card and
how their design answers it. ``embed_grad(ids, g, num_rows)`` is the cotangent
of ``table[ids]``: ``out[m] = sum of g[r] over the rows r with ids[r] == m``,
accumulated in fp32 into a ``[num_rows, D]`` fp32 table whatever g's dtype.
Accumulating in g's dtype instead would let the many duplicate ids of one
code (each class-graph code is looked up once per class) swamp their small
addends in bf16.

Both versions add in a fixed order, so a gradient has the same bits on every
run. The kernels sort the ids with a stable sort, cut the sorted positions
into chunks of 32 (one warp each), add each id's rows in row order within a
chunk, and add the chunk partials of an id that crosses a chunk edge in a
fixed order; the plain version sums fixed chunks of rows by one-hot
products. ``index_add_`` would add with fp32 atomics on the card, in an order
that changes from run to run.

The sort, the ids' offsets and the range check make a plan (``IdPlan``,
built by ``sort_ids``). ``embed_grad`` builds one per call, with one wait for
the device (the range check reads the smallest and largest id); a caller
whose ids are a fixed buffer keeps a ``PlannedIds`` beside it and passes its
plan, which is rebuilt only when the buffer changes, so a planned call makes
no wait at all.

Dispatch: a CPU tensor takes ``embed_grad_reference``; a CUDA tensor launches
the kernels or raises. ``embed_grad.launches`` counts the calls that
launched them, ``embed_grad.vec_launches`` those on the 16-byte route
(``encoder_block.piece_route``), ``embed_grad.planned_launches`` those given a plan.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .encoder_block import VECTOR, _DTYPES, _check, _require_cuda, _stream, piece_route

_SUM_CHUNK = 16384  # rows of one one-hot product: [16384, 1025] fp32 is 67 MB
_CHUNK = 32  # csrc/embed_bwd.cu kEmbedChunk: sorted positions a warp
# (device, stream) -> the chunks' fp32 partials, grown as needed; a launch
# writes every partial it reads
_scratch: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def embed_grad_reference(ids: torch.Tensor, g: torch.Tensor, num_rows: int,
                         plan: Optional["IdPlan"] = None) -> torch.Tensor:
    """Plain PyTorch version of ``embed_grad``: fp32 one-hot products over
    fixed chunks of rows, added chunk after chunk (no atomics, so the same
    bits on every run). Takes a ``plan`` as ``embed_grad`` does, and needs
    none."""
    d = g.shape[-1]
    flat, rows = ids.reshape(-1).long(), g.reshape(-1, d).float()
    out = torch.zeros(num_rows, d, dtype=torch.float32, device=g.device)
    for start in range(0, flat.numel(), _SUM_CHUNK):
        onehot = F.one_hot(flat[start:start + _SUM_CHUNK], num_rows).to(torch.float32)
        out += onehot.t() @ rows[start:start + _SUM_CHUNK]
    return out


class IdPlan(NamedTuple):
    """The ids of a lookup in the order the kernels add them."""

    sorted_ids: torch.Tensor  # int32 [rows], ascending (a stable sort)
    order: torch.Tensor  # int64 [rows]: the row of each sorted position
    offsets: torch.Tensor  # int32 [num_rows + 1]: the first sorted position of each id
    num_rows: int


def sort_ids(ids: torch.Tensor, num_rows: int) -> IdPlan:
    """The plan of int32 ``ids`` for a table of ``num_rows`` rows: a stable
    sort, the range check (one wait for the device: raises ``IndexError`` on
    an id outside [0, num_rows)), and each id's first sorted position, by the
    offsets kernel on CUDA and by counting on the CPU."""
    if ids.dtype != torch.int32:
        raise TypeError(f"embed_grad takes int32 ids, got {ids.dtype}")
    if num_rows < 1:
        raise ValueError(f"embed_grad takes a table of at least one row, got {num_rows}")
    flat = ids.reshape(-1)
    if num_rows < 2**15 - 1:
        # the same stable order from 16-bit keys, which the card's radix sort
        # takes in half the passes; ids out of range are clamped to -1 or
        # num_rows first, so the range check below still sees them
        keys = flat.clamp(-1, num_rows).to(torch.int16)
        sorted_keys, order = torch.sort(keys, stable=True)  # each id's rows in row order
        sorted_ids = sorted_keys.int()
    else:
        sorted_ids, order = torch.sort(flat, stable=True)
    rows = sorted_ids.numel()
    if rows:
        lo, hi = torch.stack((sorted_ids[0], sorted_ids[-1])).tolist()  # one wait for the device
        if lo < 0 or hi >= num_rows:
            raise IndexError(f"embed_grad: ids must lie in [0, {num_rows}), got [{lo}, {hi}]")
    if ids.device.type == "cpu":
        counts = torch.bincount(sorted_ids.long(), minlength=num_rows)
        offsets = torch.cat((counts.new_zeros(1), counts.cumsum(0))).int()
        return IdPlan(sorted_ids, order, offsets, num_rows)
    _require_cuda("ids", ids)
    offsets = torch.empty(num_rows + 1, dtype=torch.int32, device=ids.device)
    err = _build.library().sn_embed_offsets(sorted_ids.data_ptr(), offsets.data_ptr(), rows,
                                            num_rows, _stream())
    _build.check(err, "embed_grad offsets")
    return IdPlan(sorted_ids, order, offsets, num_rows)


class PlannedIds:
    """The plan of one fixed id buffer, kept by the buffer's owner. ``plan``
    returns the plan it holds while the buffer is the same tensor with the
    same data pointer, shape and version counter (an in-place write bumps
    it), and the table has the same rows; otherwise it builds a new one."""

    def __init__(self):
        self._ids: Optional[torch.Tensor] = None
        self._key = None
        self._plan: Optional[IdPlan] = None

    def plan(self, ids: torch.Tensor, num_rows: int) -> IdPlan:
        key = (ids.data_ptr(), tuple(ids.shape), ids._version, num_rows)
        if self._ids is not ids or self._key != key:
            self._plan = sort_ids(ids, num_rows)
            self._ids, self._key = ids, key
        return self._plan


def embed_grad(ids: torch.Tensor, g: torch.Tensor, num_rows: int,
               plan: Optional[IdPlan] = None) -> torch.Tensor:
    """fp32 [num_rows, D] table gradient of a lookup ``table[ids]`` whose
    output cotangent is ``g`` [*ids.shape, D]. Raises on ids outside
    [0, num_rows). ``plan``: ``sort_ids(ids, num_rows)`` made beforehand (no
    wait for the device); without it, one is made here."""
    if g.device.type == "cpu":
        return embed_grad_reference(ids, g, num_rows)
    _require_cuda("g", g)
    if g.dtype not in _DTYPES:
        raise TypeError(f"embed_grad takes float32 or bfloat16 cotangents, got {g.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"embed_grad takes int32 ids, got {ids.dtype}")
    d = g.shape[-1]
    rows = ids.numel()
    _check("ids", ids, torch.int32, ids.shape)
    _check("g", g, g.dtype, (*ids.shape, d))
    planned = plan is not None
    if plan is None:
        plan = sort_ids(ids, num_rows)
    elif plan.num_rows != num_rows or plan.order.numel() != rows:
        raise ValueError(f"embed_grad: a plan of {plan.order.numel()} ids into {plan.num_rows} "
                         f"rows, for {rows} ids into {num_rows}")
    route = piece_route(g.dtype, d, g.data_ptr())
    out = torch.empty(num_rows, d, dtype=torch.float32, device=g.device)
    stream = _stream()
    key, need = (g.device, stream), 2 * -(-rows // _CHUNK) * d
    part = _scratch.get(key)
    if part is None or part.numel() < need:
        part = _scratch[key] = torch.empty(need, dtype=torch.float32, device=g.device)
    err = _build.library().sn_embed_grad(
        _DTYPES[g.dtype], int(route == VECTOR), plan.sorted_ids.data_ptr(),
        plan.order.data_ptr(), plan.offsets.data_ptr(), g.data_ptr(), out.data_ptr(),
        part.data_ptr(), rows, d, num_rows, stream,
    )
    _build.check(err, "embed_grad")
    embed_grad.launches += 1
    embed_grad.vec_launches += route == VECTOR
    embed_grad.planned_launches += planned
    return out


embed_grad.launches = embed_grad.vec_launches = embed_grad.planned_launches = 0
