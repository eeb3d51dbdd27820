"""Counter-based dropout keep masks, shared by the fused attention and FFN
kernels.

Port of ``schemanet_tpu/ops/pallas/dropmask.py`` ``hash_keep_mask``. The keep
bit of logical element (row, col) of stream ``stream`` under ``seed`` is a
pure function of those integers, so a forward kernel and its backward kernel
regenerate the same mask whatever their blocking, and the plain PyTorch
version below gives the same bits as the CUDA device function
(``csrc/dropmask.cuh``) and as the JAX package:

    h0      = fmix32(seed * 0x9E3779B1 ^ stream * 0x85EBCA77)
    counter = (row_offset + r) * cols + c
    h       = fmix32(counter * 0xC2B2AE3D ^ h0)
    keep    = float32(h >> 8) / 2^24 >= p        (in fp32)

with every step in uint32, wrapping. PyTorch has little uint32 arithmetic on
the CPU, so the plain version holds each value in int64 in [0, 2^32) and
multiplies by splitting the 32-bit factor into 16-bit halves, which keeps
every product below 2^49 and the low 32 bits exact.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

_MASK32 = 0xFFFFFFFF
SEED_MUL, STREAM_MUL, COUNTER_MUL = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
SEED_HIGH = 2**31 - 1  # kernel seeds are drawn from [0, SEED_HIGH), like the JAX package's


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) and an int ``b``."""
    b &= _MASK32
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_keep_mask(
    seed: int,
    stream: Union[int, torch.Tensor],
    shape: Tuple[int, int],
    dropout_p: float,
    row_offset: int = 0,
    device=None,
) -> torch.Tensor:
    """Bernoulli(1 - dropout_p) keep mask (bool) of a ``(rows, cols)`` block.

    ``seed`` is an int32 value; ``stream`` an int32 value or an integer
    tensor of streams, whose shape then leads the result's
    (``[*stream.shape, rows, cols]``); ``row_offset`` is the absolute row of
    the block's first row, so blocks of any size tile one logical mask."""
    rows, cols = shape
    stream_t = torch.as_tensor(stream, dtype=torch.int64, device=device)
    device = stream_t.device
    seed_u = int(seed) & _MASK32
    h0 = _fmix32(_mul32(torch.full_like(stream_t, seed_u), SEED_MUL)
                 ^ _mul32(stream_t & _MASK32, STREAM_MUL))
    r = (torch.arange(rows, dtype=torch.int64, device=device) + row_offset) & _MASK32
    c = torch.arange(cols, dtype=torch.int64, device=device)
    counter = (_mul32(r, cols)[:, None] + c[None, :]) & _MASK32
    h = _fmix32(_mul32(counter, COUNTER_MUL) ^ h0[..., None, None])
    u = (h >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return u >= torch.tensor(dropout_p, dtype=torch.float32, device=device)


def keep_scale(dropout_p: float) -> float:
    """1 / (1 - p), the scale of kept values, as a Python float."""
    return 1.0 / (1.0 - dropout_p)


def kernel_dropout_args(dropout_p: float, seed: Optional[int]) -> Tuple[float, float, int]:
    """(p, 1/(1-p), seed) as the fused kernels take them; p = 0 turns
    dropout off."""
    if not dropout_p:
        return 0.0, 1.0, 0
    return float(dropout_p), keep_scale(dropout_p), int(seed)
