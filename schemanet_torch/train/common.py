"""Training substrate (port of ``schemanet_tpu/train/common.py``): the
per-epoch LR schedule, global-norm gradient clipping and AdamW over regex
parameter groups.

``make_optimizer`` keeps the JAX package's semantics with
``torch.optim.AdamW`` underneath:

* a parameter joins the first group whose ``pattern`` matches its JAX dotted
  name (``models/port.py`` ``jax_name``), else ``default``, or ``frozen``
  under ``drop_remain``; ``frozen_patterns`` freeze on top. Frozen
  parameters get ``requires_grad=False`` and no optimizer state;
* a group's ``cfg`` may override ``lr`` (as a scale of the base lr) and
  ``weight_decay``;
* AdamW as ``optax.adamw``: the decay is ``lr_t * wd * p`` (torch's
  ``p *= 1 - lr wd``), the bias correction uses the incremented count (torch's
  ``step`` starts at 1), and the schedule is read at the count before the
  update, which ``ScheduledAdamW.step(count)`` sets as each group's lr.

Not ported yet: ``moment_dtype`` (bf16 moments), ``factored`` and the
per-group ``adamw_lowmem`` keys, and the other optimizers; asking for them
raises. Checkpointing waits for the trainer's loaders.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.port import jax_name

_LOWMEM_KEYS = ("moment_dtype", "nu_dtype", "nu_factored_min_size", "factored")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, which the JAX package uses


def epoch_schedule(
    name: str,
    base_lr: float,
    steps_per_epoch: int,
    total_epochs: int,
    warmup_iters: int = 0,
    eta_min: float = 0.0,
    T_max: Optional[int] = None,
) -> Callable[[int], float]:
    """LR as a function of the global step, constant within each epoch (the
    cosine annealing is stepped once per epoch, warmup counted in epochs);
    the table is fp32, like the JAX package's."""
    t_max = T_max if T_max is not None else total_epochs

    def lr_at_epoch(e):
        if name in ("cosine_annealing", "cosine"):
            if warmup_iters and e < warmup_iters:
                return base_lr * (e + 1) / warmup_iters
            progress = min(max(e - warmup_iters, 0) / max(t_max - warmup_iters, 1), 1.0)
            return eta_min + (base_lr - eta_min) * 0.5 * (1 + np.cos(np.pi * progress))
        if name == "constant":
            return base_lr
        raise KeyError(f"unknown schedule {name!r}")

    table = np.asarray([lr_at_epoch(e) for e in range(total_epochs + 1)], dtype=np.float32)

    def schedule(step: int) -> float:
        return float(table[min(step // max(steps_per_epoch, 1), total_epochs)])

    return schedule


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: with the global norm
    ``sqrt(sum of g^2 over every gradient)`` at or above ``max_norm``, each
    gradient becomes ``(g / norm) * max_norm``; below it, none changes.
    Returns the norm as a device scalar (the test runs on the device, so the
    host does not wait). Not ``torch.nn.utils.clip_grad_norm_``, whose
    ``+ 1e-6`` in the divisor changes the numbers."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


@dataclasses.dataclass(frozen=True)
class GroupHyper:
    """A parameter group's hyperparameters: lr as a scale of the schedule."""

    lr_scale: float
    weight_decay: float


def param_labels(
    named: Iterable[Tuple[str, torch.Tensor]],
    param_groups: Sequence[Dict[str, Any]] = (),
    drop_remain: bool = False,
    frozen_patterns: Sequence[str] = (),
) -> Dict[str, str]:
    """``group_{i}``, ``default`` or ``frozen`` for each parameter name."""
    labels = {}
    for name, p in named:
        jname = jax_name(name, p.ndim)
        label = "frozen" if drop_remain else "default"
        for gi, group in enumerate(param_groups):
            if re.match(group["pattern"], jname):
                label = f"group_{gi}"
                break
        if any(re.match(pat, jname) for pat in frozen_patterns):
            label = "frozen"
        labels[name] = label
    return labels


class ScheduledAdamW:
    """``torch.optim.AdamW`` over the labelled groups, its lr set from the
    schedule at every step."""

    def __init__(self, params: Dict[str, List[nn.Parameter]], hyper: Dict[str, GroupHyper],
                 schedule: Callable[[int], float]):
        self.schedule = schedule
        groups = [
            {"params": ps, "lr": schedule(0) * hyper[label].lr_scale,
             "weight_decay": hyper[label].weight_decay, "lr_scale": hyper[label].lr_scale}
            for label, ps in params.items() if ps
        ]
        self.optimizer = (torch.optim.AdamW(groups, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS)
                          if groups else None)

    def zero_grad(self) -> None:
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=True)

    def step(self, count: int) -> None:
        """One update; ``count`` is the number of updates already applied."""
        if self.optimizer is None:
            return
        lr = self.schedule(count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.optimizer.step()


def make_optimizer(
    model: nn.Module,
    optimizer_cfg: Dict[str, Any],
    schedule: Callable[[int], float],
    param_groups: Optional[Sequence[Dict[str, Any]]] = None,
    drop_remain: bool = False,
    frozen_patterns: Sequence[str] = (),
    exclude: Sequence[str] = (),
) -> Tuple[ScheduledAdamW, Dict[str, str], Dict[str, GroupHyper]]:
    """AdamW over ``model``'s parameters by regex group. Freezes (sets
    ``requires_grad=False`` on) the frozen ones; ``exclude`` names trainable
    parameters that another update owns (the fused atlas tensors). Returns
    ``(optimizer, labels, hyper)``: the label of every parameter and the
    hyperparameters of every label but ``frozen``."""
    name = optimizer_cfg.get("name", "AdamW").lower()
    if name != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported (only AdamW)")
    asked = [k for k in _LOWMEM_KEYS if optimizer_cfg.get(k)]
    groups = list(param_groups or [])
    for group in groups:
        asked += [k for k in _LOWMEM_KEYS if k in (group.get("cfg") or {})]
    if asked:
        raise NotImplementedError(f"low-memory AdamW options {sorted(set(asked))} are not ported")
    base_lr = float(optimizer_cfg.get("lr", 1e-3))
    weight_decay = float(optimizer_cfg.get("weight_decay", 0.0))
    hyper = {"default": GroupHyper(1.0, weight_decay)}
    for gi, group in enumerate(groups):
        cfg = group.get("cfg") or {}
        hyper[f"group_{gi}"] = GroupHyper(
            float(cfg.get("lr", base_lr)) / base_lr, float(cfg.get("weight_decay", weight_decay))
        )
    named = list(model.named_parameters())
    labels = param_labels(named, groups, drop_remain, frozen_patterns)
    params: Dict[str, List[nn.Parameter]] = {label: [] for label in hyper}
    for pname, p in named:
        label = labels[pname]
        p.requires_grad_(label != "frozen")
        if label != "frozen" and pname not in exclude:
            params[label].append(p)
    return ScheduledAdamW(params, hyper, schedule), labels, hyper
