"""Determinism helper (port of ``schemanet_tpu/utils/seed.py``; the
reference's ``make_deterministic``, called with ``seed + rank`` per process).

The port's randomness that matters for results flows through explicit
``torch.Generator``s; what this seeds is the host's global generators
(Python, numpy) and PyTorch's default generator, with the offset of this
process's rank in ``torch.distributed``.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .logging_utils import process_rank


def make_deterministic(seed: int, per_process: bool = True) -> int:
    """Seed Python's, numpy's and PyTorch's global generators; returns the
    effective seed, ``seed`` plus this process's rank when ``per_process``
    (the rank is 0 where ``torch.distributed`` is not initialised)."""
    eff = seed + (process_rank() if per_process else 0)
    random.seed(eff)
    np.random.seed(eff % (2**32))
    torch.manual_seed(eff)
    return eff
