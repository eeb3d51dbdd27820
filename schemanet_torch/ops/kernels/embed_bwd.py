"""Embedding-table gradient: CUDA kernel and plain version.

Port of ``schemanet_tpu/ops/pallas/embed_bwd.py`` ``embed_grad``; the kernel
is ``csrc/embed_bwd.cu``, whose header says what bounds it on the card and
how its design answers it. ``embed_grad(ids, g, num_rows)`` is the cotangent
of ``table[ids]``: ``out[m] = sum of g[r] over the rows r with ids[r] == m``,
accumulated in fp32 into a ``[num_rows, D]`` fp32 table whatever g's dtype.
Accumulating in g's dtype instead would let the many duplicate ids of one
code (each class-graph code is looked up once per class) swamp their small
addends in bf16.

Both versions add in a fixed order, so a gradient has the same bits on every
run: the kernel adds the rows of each id in row order (the TPU kernel's
order), after a stable sort of the ids; the plain version sums fixed chunks
of rows by one-hot products. ``index_add_`` would add with fp32 atomics on
the card, in an order that changes from run to run.

Dispatch: a CPU tensor takes ``embed_grad_reference``; a CUDA tensor launches
the kernel or raises. ``embed_grad.launches`` counts the launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .encoder_block import _DTYPES, _check, _require_cuda, _stream

_SUM_CHUNK = 16384  # rows of one one-hot product: [16384, 1025] fp32 is 67 MB


def embed_grad_reference(ids: torch.Tensor, g: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain PyTorch version of ``embed_grad``: fp32 one-hot products over
    fixed chunks of rows, added chunk after chunk (no atomics, so the same
    bits on every run)."""
    d = g.shape[-1]
    flat, rows = ids.reshape(-1).long(), g.reshape(-1, d).float()
    out = torch.zeros(num_rows, d, dtype=torch.float32, device=g.device)
    for start in range(0, flat.numel(), _SUM_CHUNK):
        onehot = F.one_hot(flat[start:start + _SUM_CHUNK], num_rows).to(torch.float32)
        out += onehot.t() @ rows[start:start + _SUM_CHUNK]
    return out


def embed_grad(ids: torch.Tensor, g: torch.Tensor, num_rows: int) -> torch.Tensor:
    """fp32 [num_rows, D] table gradient of a lookup ``table[ids]`` whose
    output cotangent is ``g`` [*ids.shape, D]. Raises on ids outside
    [0, num_rows)."""
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
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)  # each id's rows in row order
    if rows:
        lo, hi = torch.stack((sorted_ids[0], sorted_ids[-1])).tolist()  # one wait for the device
        if lo < 0 or hi >= num_rows:
            raise IndexError(f"embed_grad: ids must lie in [0, {num_rows}), got [{lo}, {hi}]")
    out = torch.empty(num_rows, d, dtype=torch.float32, device=g.device)
    err = _build.library().sn_embed_grad(
        _DTYPES[g.dtype], sorted_ids.data_ptr(), order.data_ptr(), g.data_ptr(), out.data_ptr(),
        rows, d, num_rows, _stream(),
    )
    _build.check(err, "embed_grad")
    embed_grad.launches += 1
    return out


embed_grad.launches = 0
