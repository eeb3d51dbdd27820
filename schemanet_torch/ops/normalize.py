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


def normalize_sum_clamp(x: torch.Tensor, dim: int = -1, detach_sum: bool = False,
                        min_val: float = 0.0) -> torch.Tensor:
    """clamp-min (``min_val >= 0``) then sum-normalise; the sum accumulates in
    fp32. With ``detach_sum`` no gradient flows through the denominator (the
    JAX package's ``stop_gradient`` on it).

    The clamp is ``torch.maximum``, whose gradient splits a tie between x and
    ``min_val`` in halves as ``jnp.maximum`` does (``torch.clamp`` would pass
    all of it): projected atlas rows hold exact zeros, which tie with
    ``min_val = 0``.

    A row that clamps to all zeros is set to 0 without dividing by its zero
    sum: the value is the 0 that 0/0 -> NaN -> 0 gives, and its gradient is
    0, where the JAX package's is NaN (``0 * (1/0)``). Class-edge rows of
    pruned vertices are such rows, so a NaN there would reach the optimizer
    and poison the whole atlas."""
    if min_val < 0:
        raise ValueError(f"normalize_sum_clamp takes min_val >= 0, got {min_val}")
    x = torch.maximum(x, torch.tensor(min_val, dtype=x.dtype, device=x.device))
    s = x.sum(dim=dim, keepdim=True, dtype=torch.float32).to(x.dtype)
    if detach_sum:
        s = s.detach()
    zero_row = s == 0
    out = x / torch.where(zero_row, torch.ones_like(s), s)
    return zero_nans(torch.where(zero_row, torch.zeros_like(out), out))


def safe_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax whose all ``-inf`` rows give NaN (torch's own semantics, which
    the callers then map to 0), written out to match the JAX package's
    max-subtraction exactly."""
    m = x.amax(dim=dim, keepdim=True)
    e = torch.exp(x - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    return e / e.sum(dim=dim, keepdim=True)
