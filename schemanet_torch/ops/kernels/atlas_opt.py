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

Folding the projection into the update keeps the atlas projected from one
step to the next, so the gradient sees the same projected parameters as
under the projection before every step (``schemanet_tpu/ops/pallas/
atlas_opt.py`` docstring; ``train/trainer.py`` relies on it).

Dispatch: a CPU tensor takes ``adamw_project_rows_reference``; a CUDA tensor
launches the kernel or raises. ``adamw_project_rows.launches`` counts the
launches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build
from .encoder_block import _check, _require_cuda, _stream

_MAX_COLUMNS = 4096  # csrc/atlas_opt.cu: kThreads * kMaxPer


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
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * g * g)
    pn = p - lr * ((m * bc1) / (torch.sqrt(v * bc2) + eps) + weight_decay * p)
    if project:
        w = torch.clamp(pn, min=0.0)
        s = w.sum(dim=-1, keepdim=True)
        pn = torch.where(s > 0, w / s, torch.zeros_like(w))
    if loop_v:
        eye = torch.eye(loop_v, dtype=torch.bool, device=p.device)
        pn = torch.where(eye, torch.zeros_like(pn), pn)
    p.copy_(pn)
    return p, m, v


def adamw_project_rows(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, count: int, *,
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 1e-4, project: bool = True, remove_self_loop: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused AdamW step + row projection over the last axis, in place.

    ``p/g/m/v`` are fp32 tensors of one shape ``[..., C]``; ``count`` is the
    number of updates already applied (optax's pre-increment convention).
    Returns ``(p, m, v)``, the same tensors."""
    if p.device.type == "cpu":
        return adamw_project_rows_reference(
            p, g, m, v, count, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            project=project, remove_self_loop=remove_self_loop,
        )
    _require_cuda("p", p)
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _check(name, t, torch.float32, p.shape)
    c = p.shape[-1]
    if not 0 < c <= _MAX_COLUMNS:
        raise ValueError(f"adamw_project_rows takes rows of 1..{_MAX_COLUMNS} columns, got {c}")
    loop_v = _self_loop_width(p.shape, remove_self_loop)
    bc1, bc2 = _bias_corrections(count, b1, b2)
    err = _build.library().sn_adamw_project_rows(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel() // c, c,
        int(project), loop_v, lr, b1, 1.0 - b1, b2, 1.0 - b2, bc1, bc2, eps, weight_decay,
        _stream(),
    )
    _build.check(err, "adamw_project_rows")
    adamw_project_rows.launches += 1
    return p, m, v


adamw_project_rows.launches = 0
