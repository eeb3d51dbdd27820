"""Normalisation primitives shared by graph building and the IR-Atlas.

Port of ``schemanet_tpu/ops/normalize.py``. NaN convention: after each
division NaN maps to 0 (the reference's ``nan_to_num(0)``), so all-zero rows
normalise to zero. Row sums accumulate in fp32 whatever the storage dtype.
"""

from __future__ import annotations

import torch


def zero_nans(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def normalize_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / x.sum(dim), NaN -> 0; the sum accumulates in fp32."""
    s = x.sum(dim=dim, keepdim=True, dtype=torch.float32).to(x.dtype)
    return zero_nans(x / s)


def normalize_max(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / x.max(dim), NaN -> 0."""
    m = x.amax(dim=dim, keepdim=True)
    return zero_nans(x / m)


def normalize_sum_clamp(x: torch.Tensor, dim: int = -1, min_val: float = 0.0) -> torch.Tensor:
    """clamp-min then sum-normalise."""
    return normalize_sum(torch.clamp(x, min=min_val), dim=dim)


def safe_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax whose all ``-inf`` rows give NaN (torch's own semantics, which
    the callers then map to 0), written out to match the JAX package's
    max-subtraction exactly."""
    m = x.amax(dim=dim, keepdim=True)
    e = torch.exp(x - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    return e / e.sum(dim=dim, keepdim=True)
