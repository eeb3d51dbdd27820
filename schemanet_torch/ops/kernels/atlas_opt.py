"""Fused AdamW + atlas row projection: CUDA kernel and plain version.

Port of ``schemanet_tpu/ops/pallas/atlas_opt.py`` ``adamw_project_rows``; the
kernel is ``csrc/atlas_opt.cu``, whose header says what bounds it on the card
and how its design answers it. One pass over fp32 ``[..., C]`` tensors, in
place:

* AdamW as ``optax.adamw(lr, b1, b2, eps, weight_decay)``:
  ``m = b1 m + (1-b1) g``, ``v = b2 v + (1-b2) g^2``, bias-corrected with the
  *incremented* count, ``p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)``;
* then, with ``project``, the row projection of ``project_atlas_params``:
  ``w = max(p, 0); p = w / sum(w)`` over the last axis, all-zero rows giving 0;
* then, with ``remove_self_loop``, the diagonal of each ``[V, V]`` block is
  zeroed (row r of the ``[K*V, V]`` view has its self-loop at column r mod V).

The moments ``m`` and ``v`` are each fp32 or bf16 (a group with
``moment_dtype`` / ``nu_dtype: bfloat16``, as the JAX package's
``adamw_lowmem`` stores them): the update runs in fp32 from the stored
moments and uses this step's fp32 moments; only their storage rounds, to
nearest even. With bf16 moments this is ``adamw_lowmem`` followed by
``project_atlas_params``, which is what the JAX package runs for such a
group.

Folding the projection into the update keeps the atlas projected from one
step to the next, so the gradient sees the same projected parameters as
under the projection before every step (``schemanet_tpu/ops/pallas/
atlas_opt.py`` docstring; ``train/trainer.py`` relies on it).

Dispatch: a CPU tensor takes ``adamw_project_rows_reference``; a CUDA tensor
launches the kernel or raises. ``adamw_plan`` names the kernel's route for a
call: rows up to 1024 wide take a warp a row (``"vector"``: four columns a
piece in all four arrays, where C is a multiple of 4, p and g are 16-byte
aligned and each moment 16-byte aligned in fp32, 8-byte in bf16;
``"scalar"``: one column a piece), wider rows a block a row (``"block"``).
``adamw_project_rows.launches`` counts the launches, ``.bf16_launches`` those
with a bf16 moment and ``.vec_launches`` those of the vector route.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import _build
from .encoder_block import _check, _require_cuda, _stream

_MAX_COLUMNS = 4096  # csrc/atlas_opt.cu: kThreads * kMaxPer
_WARP_MAX_COLUMNS = 1024  # csrc/atlas_opt.cu kWarpMaxC: a warp a row up to this width
_WARPS_PER_BLOCK = 8  # csrc/atlas_opt.cu kWarpsPerBlock
_MOMENT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DType
VECTOR, SCALAR, BLOCK = "vector", "scalar", "block"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class AdamWPlan:
    """The launch of one ``adamw_project_rows`` call on ``rows`` rows of
    ``c`` columns (csrc/atlas_opt.cu ``adamw_project_rows_launch``):

    * ``route``: ``"vector"`` or ``"scalar"`` (a warp a row, four columns or
      one a piece) up to 1024 columns, ``"block"`` (a block of 256 threads a
      row) past them;
    * ``piece_bytes``: the bytes of one piece of p, g, m and v;
    * ``pieces_per_lane``: the pieces a lane holds of a row on the warp
      routes (the kernel's instance: 4 or 8 of four columns, 16 or 32 of
      one), and ``values_per_lane``, the columns they cover;
    * ``blocks``: the grid, blocks of 8 warps with a row each on the warp
      routes, a block a row on the block route."""

    def __init__(self, rows: int, c: int, m_dtype: torch.dtype, v_dtype: torch.dtype,
                 p_ptr: int = 0, g_ptr: int = 0, m_ptr: int = 0, v_ptr: int = 0):
        if not 0 < c <= _MAX_COLUMNS:
            raise ValueError(f"adamw_project_rows takes rows of 1..{_MAX_COLUMNS} columns, "
                             f"got {c}")
        for name, dt in (("m", m_dtype), ("v", v_dtype)):
            if dt not in _MOMENT_DTYPES:
                raise TypeError(f"adamw_project_rows keeps {name} in float32 or bfloat16, got "
                                f"{dt}")
        self.rows, self.c = rows, c
        size = {"p": 4, "g": 4, "m": m_dtype.itemsize, "v": v_dtype.itemsize}
        ptrs = {"p": p_ptr, "g": g_ptr, "m": m_ptr, "v": v_ptr}
        if c > _WARP_MAX_COLUMNS:
            self.route = BLOCK
        elif c % 4 == 0 and all(ptrs[k] % (4 * size[k]) == 0 for k in ptrs):
            self.route = VECTOR
        else:
            self.route = SCALAR
        width = 4 if self.route == VECTOR else 1
        self.piece_bytes: Dict[str, int] = {k: width * size[k] for k in size}
        if self.route == BLOCK:
            self.pieces_per_lane = self.values_per_lane = None
            self.blocks = rows
        else:
            small = c <= 512  # the smaller instance: 16 columns a lane
            self.pieces_per_lane = (4 if small else 8) if width == 4 else (16 if small else 32)
            self.values_per_lane = width * self.pieces_per_lane
            self.blocks = _cdiv(rows, _WARPS_PER_BLOCK)


def adamw_plan(rows: int, c: int, m_dtype: torch.dtype = torch.float32,
               v_dtype: torch.dtype = torch.float32, *ptrs: int) -> AdamWPlan:
    """The launch plan of ``adamw_project_rows`` over ``rows`` rows of ``c``
    columns with moments of these dtypes; ``ptrs``: the data pointers of p,
    g, m and v (all 0: aligned). Raises on what the kernel does not take."""
    return AdamWPlan(rows, c, m_dtype, v_dtype, *ptrs)


def _bias_corrections(count: int, b1: float, b2: float) -> Tuple[float, float]:
    """1 / (1 - b^t) at t = count + 1, in fp32 like the JAX kernel's scalars."""
    t = np.float32(count + 1)
    one = np.float32(1.0)
    return (float(one / (one - np.float32(b1) ** t)), float(one / (one - np.float32(b2) ** t)))


def _self_loop_width(shape, remove_self_loop: bool) -> int:
    if not remove_self_loop:
        return 0
    if len(shape) < 2 or shape[-2] != shape[-1]:
        raise ValueError(f"remove_self_loop needs [..., V, V], got {tuple(shape)}")
    return shape[-1]


def adamw_project_rows_reference(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, count: int, *,
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 1e-4, project: bool = True, remove_self_loop: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``adamw_project_rows``; updates p, m, v in
    place and returns them."""
    loop_v = _self_loop_width(p.shape, remove_self_loop)
    bc1, bc2 = _bias_corrections(count, b1, b2)
    m32 = m.float().mul(b1).add_((1.0 - b1) * g)
    v32 = v.float().mul(b2).add_((1.0 - b2) * g * g)
    m.copy_(m32)  # stored in m's dtype, rounded to nearest even where bf16
    v.copy_(v32)
    pn = p - lr * ((m32 * bc1) / (torch.sqrt(v32 * bc2) + eps) + weight_decay * p)
    p.copy_(_projected(pn, project, loop_v))
    return p, m, v


def _projected(pn: torch.Tensor, project: bool, loop_v: int) -> torch.Tensor:
    if project:
        w = torch.clamp(pn, min=0.0)
        s = w.sum(dim=-1, keepdim=True)
        pn = torch.where(s > 0, w / s, torch.zeros_like(w))
    if loop_v:
        eye = torch.eye(loop_v, dtype=torch.bool, device=pn.device)
        pn = torch.where(eye, torch.zeros_like(pn), pn)
    return pn


@torch.no_grad()
def project_rows_(p: torch.Tensor, remove_self_loop: bool = False) -> torch.Tensor:
    """The kernel's row projection alone, plain, in place: for an atlas
    tensor whose update the kernel does not compute (a factored second
    moment), after the plain low-memory update."""
    return p.copy_(_projected(p, True, _self_loop_width(p.shape, remove_self_loop)))


def adamw_project_rows(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, count: int, *,
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 1e-4, project: bool = True, remove_self_loop: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused AdamW step + row projection over the last axis, in place.

    ``p/g/m/v`` are tensors of one shape ``[..., C]``, p and g fp32, m and v
    each fp32 or bf16; ``count`` is the number of updates already applied
    (optax's pre-increment convention). Returns ``(p, m, v)``, the same
    tensors."""
    if p.device.type == "cpu":
        return adamw_project_rows_reference(
            p, g, m, v, count, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            project=project, remove_self_loop=remove_self_loop,
        )
    _require_cuda("p", p)
    for name, t in (("p", p), ("g", g)):
        _check(name, t, torch.float32, p.shape)
    for name, t in (("m", m), ("v", v)):
        if t.dtype not in _MOMENT_DTYPES:
            raise TypeError(f"adamw_project_rows keeps {name} in float32 or bfloat16, got "
                            f"{t.dtype}")
        _check(name, t, t.dtype, p.shape)
    c = p.shape[-1]
    plan = adamw_plan(p.numel() // c, c, m.dtype, v.dtype, p.data_ptr(), g.data_ptr(),
                      m.data_ptr(), v.data_ptr())
    loop_v = _self_loop_width(p.shape, remove_self_loop)
    bc1, bc2 = _bias_corrections(count, b1, b2)
    err = _build.library().sn_adamw_project_rows(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), _MOMENT_DTYPES[m.dtype],
        _MOMENT_DTYPES[v.dtype], plan.rows, c, int(plan.route == VECTOR),
        int(project), loop_v, lr, b1, 1.0 - b1, b2, 1.0 - b2, bc1, bc2, eps, weight_decay,
        _stream(),
    )
    _build.check(err, "adamw_project_rows")
    adamw_project_rows.launches += 1
    adamw_project_rows.vec_launches += plan.route == VECTOR
    if torch.bfloat16 in (m.dtype, v.dtype):
        adamw_project_rows.bf16_launches += 1
    return p, m, v


adamw_project_rows.launches = adamw_project_rows.bf16_launches = 0
adamw_project_rows.vec_launches = 0
