"""Host-side metric meters and top-k accuracy (port of
``schemanet_tpu/utils/metrics.py``).

``sync(group)`` sums a meter over a process group: on a grid, its data
group (``Mesh.data_group``), since the ranks of a model group see the same
samples; without one, every process of ``torch.distributed`` when it is
initialised with more than one. A single process has nothing to sum.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Union

import torch
from torch import nn


def _group_size(group=None) -> int:
    dist = torch.distributed
    return (dist.get_world_size(group) if dist.is_available() and dist.is_initialized()
            else 1)


class AverageMeter:
    """Weighted running average with deferred accumulation like cv_lib's."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._count = 0.0
        self._accumulated = None

    def update(self, value, n: int = 1):
        self._sum += float(value) * n
        self._count += n

    def accumulate(self):
        self._accumulated = (self._sum, self._count)

    def sync(self, group=None):
        if self._accumulated is None:
            self.accumulate()
        if _group_size(group) > 1:
            both = torch.tensor(self._accumulated, dtype=torch.float64)
            torch.distributed.all_reduce(both, group=group)
            self._accumulated = (float(both[0]), float(both[1]))

    @property
    def count(self) -> float:
        """The weight accumulated (after ``sync``, over the group)."""
        return (self._accumulated if self._accumulated is not None
                else (self._sum, self._count))[1]

    def value(self) -> float:
        s, c = self._accumulated if self._accumulated is not None else (self._sum, self._count)
        return s / c if c > 0 else 0.0


class DictAverageMeter:
    def __init__(self):
        self._meters: Dict[str, AverageMeter] = {}

    def reset(self):
        self._meters.clear()

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self._meters.setdefault(k, AverageMeter()).update(v, n)

    def accumulate(self):
        for m in self._meters.values():
            m.accumulate()

    def sync(self, group=None):
        for m in self._meters.values():
            m.sync(group)

    def value(self) -> Dict[str, float]:
        return {k: m.value() for k, m in self._meters.items()}


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  top_k: Sequence[int] = (1,)) -> Dict[int, torch.Tensor]:
    """Top-k accuracy fractions in [0, 1] (reference cv_lib.metrics.accuracy),
    as device scalars."""
    _, pred = torch.topk(logits, max(top_k), dim=-1)  # [bs, max_k]
    correct = pred == labels[:, None]
    return {k: correct[:, :k].any(dim=1).float().mean() for k in top_k}


def tensor_dict_items(d: Dict[str, object], ndigits: int = 4) -> Dict[str, float]:
    """Round a dict of scalars or one-element tensors to python floats
    (cv_lib.tensor_dict_items)."""
    return {k: round(float(v), ndigits) for k, v in d.items()}


def count_parameters(params: Union[nn.Module, Iterable[torch.Tensor]],
                     include_frozen: bool = True) -> int:
    """Elements of a module's parameters (or of any tensors); without
    ``include_frozen`` only those that require a gradient."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    return sum(p.numel() for p in params if include_frozen or p.requires_grad)
