"""Geometric token-grid similarity (port of ``schemanet_tpu/ops/geometry.py``).

``pairwise_point_sim(h, w)`` is the [h*w, h*w] matrix
``1 / (1 + ||p_i - p_j||_pow / alpha)`` over the 2-D patch grid, row-major
(h, w) flattening. It is a constant of the backbone, built once on the host
and kept per device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def pairwise_point_dist(h: int, w: int, pow: float = 2.0) -> np.ndarray:
    ii, jj = np.meshgrid(
        np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij"
    )
    p = np.stack([ii.reshape(-1), jj.reshape(-1)], axis=1)  # [h*w, 2]
    diff = np.abs(p[:, None, :] - p[None, :, :])
    return ((diff**pow).sum(-1) ** (1.0 / pow)).astype(np.float32)


@lru_cache(maxsize=16)
def _cached_sim(h: int, w: int, alpha: float, pow: float, device: str) -> torch.Tensor:
    if alpha < 0:
        raise ValueError(f"dist_alpha must be non-negative, got {alpha}")
    dist = pairwise_point_dist(h, w, pow) / np.float32(alpha)
    sim = (1.0 / (1.0 + dist)).astype(np.float32)
    return torch.from_numpy(sim).to(device)


def pairwise_point_sim(
    h: int, w: int, alpha: float = 1.0, pow: float = 2.0, device="cpu"
) -> torch.Tensor:
    """fp32 [h*w, h*w]; cached per (shape, alpha, pow, device). Read-only."""
    return _cached_sim(int(h), int(w), float(alpha), float(pow), str(torch.device(device)))
