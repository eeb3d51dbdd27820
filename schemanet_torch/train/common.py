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

Low-memory moments, chosen as the JAX ``make_optimizer`` chooses them:

* a group whose ``cfg`` names any of ``moment_dtype``, ``nu_dtype`` or
  ``nu_factored_min_size`` takes ``adamw_lowmem`` (the port of
  ``scale_by_adam_lowmem`` + decoupled decay + the schedule): the moments
  are stored in ``moment_dtype`` (the group's, else the top-level one) and
  ``nu_dtype``; with ``nu_factored_min_size`` a parameter of >= 2 dims whose
  two trailing dims are both at least that size keeps fp32 row and column
  statistics of g^2 for each leading index instead of a full nu. The
  update runs in fp32 from the stored moments and uses this step's fp32
  moments; only the storage rounds, to nearest even;
* any other group under a top-level ``moment_dtype`` takes
  ``optax.adamw(mu_dtype=...)``: mu stored in that dtype, nu in the
  parameter's, and ``m = (1 - b1) g + b1' mu`` with ``b1' = b1`` rounded to
  mu's dtype (optax multiplies the stored mu by the weakly typed Python
  ``b1``, which JAX casts to mu's dtype; under ``jit`` XLA keeps the
  product in fp32);
* the rest take ``torch.optim.AdamW``.

The other optimizers, each as the JAX ``make_one`` builds it for a group
(the group's lr scale; the ``frozen`` label gets no update):

* ``adam``: ``optax.adam(mu_dtype=moment_dtype)``, the update of
  ``optax.adamw(mu_dtype)`` above without the decay;
* ``sgd``: ``optax.sgd(momentum=optimizer.momentum (0.9), nesterov=False)``:
  ``t = g + momentum t`` (fused, as XLA computes it), ``p -= lr t``; no decay;
* ``adamw`` with ``factored: true`` on a group without the low-memory keys:
  ``optax.adafactor(lr, multiply_by_parameter_scale=False)`` at optax
  0.2.6's defaults (``adafactor_step_``), then the JAX package's
  ``_scheduled_decay`` (``u -= lr_t wd p``). The group keys that route to
  ``adamw_lowmem`` do so only under ``adamw`` (factored or not).

The low-memory updates and the other optimizers are plain PyTorch
(``PlainUpdates``), as the JAX package runs them as plain XLA.

Checkpoints are torch-native: ``CheckpointManager`` writes one
``torch.save`` file a tag (``<ckpt_dir>/iter-<n>.pt``, the reference's
``ckpt/iter-<N>.pth``), keeps the newest ``max_keep`` of them and copies the
best to ``best.pt``; ``save_metadata`` writes ``meta.json`` with the JAX
package's keys. Reading or writing the JAX package's Orbax checkpoints is
not ported.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.port import jax_name
from ..parallel.mesh import Shard, all_reduce_, grid_shard

_GROUP_LOWMEM_KEYS = ("nu_dtype", "nu_factored_min_size", "moment_dtype")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, which the JAX package uses
# optax.adafactor's defaults (optax 0.2.6), which the JAX package's factored AdamW takes
FACTOR_MIN_DIM, FACTOR_DECAY, FACTOR_EPS, FACTOR_CLIP = 128, 0.8, 1e-30, 1.0
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


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


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        sharded: Optional[Sequence[bool]] = None, mesh=None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: with the global norm
    ``sqrt(sum of g^2 over every gradient)`` at or above ``max_norm``, each
    gradient becomes ``(g / norm) * max_norm``; below it, none changes.
    Returns the norm as a device scalar (the test runs on the device, so the
    host does not wait). Not ``torch.nn.utils.clip_grad_norm_``, whose
    ``+ 1e-6`` in the divisor changes the numbers. On a grid (``mesh``)
    ``sharded`` marks the gradients of parameters held as shards: their
    squares are summed over the model group, and the replicated ones, the
    same on every rank, count once."""
    if mesh is not None and sharded is not None and any(sharded):
        rep = sum(torch.sum(g * g) for g, s in zip(grads, sharded) if not s)
        part = sum(torch.sum(g * g) for g, s in zip(grads, sharded) if s)
        norm = torch.sqrt(rep + all_reduce_(part, mesh.model_group))
    else:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    if name is None:
        return None
    if name not in _DTYPES:
        raise ValueError(f"unknown moment dtype {name!r}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class Moments:
    """How a group stores its Adam moments: ``adamw_lowmem``'s knobs (None
    dtypes: the parameter's), or with ``optax_mu`` the update of
    ``optax.adamw(mu_dtype)``, whose b1 is rounded to mu's dtype."""

    mu_dtype: Optional[torch.dtype] = None
    nu_dtype: Optional[torch.dtype] = None
    factored_min_size: Optional[int] = None
    optax_mu: bool = False

    def factored(self, p: torch.Tensor) -> bool:
        """Row and column statistics in place of a full nu for ``p``."""
        return (self.factored_min_size is not None and p.ndim >= 2
                and min(p.shape[-2:]) >= self.factored_min_size)


@dataclasses.dataclass(frozen=True)
class GroupHyper:
    """A parameter group's hyperparameters: lr as a scale of the schedule;
    ``kind`` its optimizer: ``adamw`` (``moments`` None for
    ``torch.optim.AdamW`` with fp32 moments; ``adam`` is ``adamw`` with the
    optax mu and no decay), ``sgd`` (with ``momentum``) or ``adafactor``."""

    lr_scale: float
    weight_decay: float
    moments: Optional[Moments] = None
    kind: str = "adamw"
    momentum: float = 0.9


def _bias_correction(b: float, count: int) -> torch.Tensor:
    """1 - b^t at t = count + 1, in fp32 as optax computes it."""
    return torch.tensor(1.0, dtype=torch.float32) - torch.tensor(b, dtype=torch.float32) ** float(
        count + 1)


def _whole(shape, shard: Optional[Shard]) -> Tuple[int, ...]:
    """The whole parameter's shape of a ``shard``'s ``shape`` (None: not split)."""
    if shard is None:
        return tuple(shape)
    return tuple(n * shard.mesh.model if i == shard.dim else n for i, n in enumerate(shape))


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest axis, where the second largest is at least
    ``FACTOR_MIN_DIM``; None (a full second moment) otherwise."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < FACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def follows_split(key: str, p: torch.Tensor) -> bool:
    """Whether the state tensor ``key`` of ``p`` is split as ``p`` is: all
    but an Adafactor statistic reduced over ``p``'s split axis, which every
    rank of the model group holds whole."""
    shard = grid_shard(p)
    if shard is None or key not in ("v_row", "v_col"):
        return True
    d1, d0 = factored_dims(_whole(p.shape, shard))
    return (d0 if key == "v_row" else d1) != shard.dim


def optimizer_init(p: torch.Tensor, hyper: GroupHyper) -> Dict[str, torch.Tensor]:
    """Zero state of ``p`` under its group's optimizer: ``lowmem_init``'s
    for AdamW and Adam, ``trace`` for SGD, and for Adafactor ``v_row`` and
    ``v_col`` (``p``'s shape with a 1 at the axis each reduces, d0 and d1)
    or a full ``v``, in ``p``'s dtype, as optax keeps them."""
    if hyper.kind == "sgd":
        return {"trace": torch.zeros_like(p)}
    if hyper.kind == "adafactor":
        dims = factored_dims(_whole(p.shape, grid_shard(p)))
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"v_row": torch.zeros(_keep1(p.shape, d0), dtype=p.dtype, device=p.device),
                "v_col": torch.zeros(_keep1(p.shape, d1), dtype=p.dtype, device=p.device)}
    return lowmem_init(p, hyper.moments or Moments())


def _keep1(shape, dim: int) -> Tuple[int, ...]:
    return tuple(1 if i == dim else n for i, n in enumerate(shape))


def _mean(t: torch.Tensor, dim: Optional[int], shard: Optional[Shard]) -> torch.Tensor:
    """``t``'s mean over ``dim`` (kept, size 1), or over every element with
    ``dim`` None; on a shard, over the whole parameter: the sum over the
    split axis is summed over the model group."""
    split = shard is not None and (dim is None or dim == shard.dim)
    if not split:
        return t.mean() if dim is None else t.mean(dim, keepdim=True)
    total = t.sum() if dim is None else t.sum(dim, keepdim=True)
    all_reduce_(total, shard.mesh.model_group)
    count = t.numel() if dim is None else t.shape[dim]
    return total / (count * shard.mesh.model)


@torch.no_grad()
def sgd_step_(p: torch.Tensor, g: torch.Tensor, state: Dict[str, torch.Tensor], lr: float,
              momentum: float) -> None:
    """``optax.sgd(momentum, nesterov=False)``: ``t = g + momentum t``
    (one rounding, as XLA fuses it), ``p += -lr t``."""
    t = _fma(momentum, state["trace"], g.float()).to(state["trace"].dtype)
    state["trace"].copy_(t)
    p.add_(t * torch.tensor(-lr, dtype=torch.float32))


@torch.no_grad()
def adafactor_step_(p: torch.Tensor, g: torch.Tensor, state: Dict[str, torch.Tensor],
                    count: int, lr: float, weight_decay: float,
                    shard: Optional[Shard] = None) -> None:
    """``optax.adafactor(lr, multiply_by_parameter_scale=False)`` at optax
    0.2.6's defaults, then the JAX package's ``_scheduled_decay``: with
    ``s = g^2 + 1e-30`` and ``b = 1 - (count + 1)^-0.8``, the factored
    statistics ``r = b r + (1 - b) mean_d0(s)``, ``c = b c + (1 - b)
    mean_d1(s)``, ``u = g (r / mean_d1(r))^-1/2 c^-1/2`` (or ``v = b v + (1 -
    b) s``, ``u = g v^-1/2``), ``u / max(1, rms(u))``, then ``p += -lr u - lr
    wd p``. ``count`` updates were applied before. On a shard (``shard``)
    each mean over the split axis and the RMS are the whole parameter's."""
    decay = float(np.float32(1.0) - np.float32(count + 1) ** np.float32(-FACTOR_DECAY))
    gs = g * g + FACTOR_EPS
    if "v" in state:
        v = decay * state["v"] + (1.0 - decay) * gs
        state["v"].copy_(v)
        u = g * v.rsqrt()
    else:
        d1, d0 = factored_dims(_whole(p.shape, shard))
        r = decay * state["v_row"] + (1.0 - decay) * _mean(gs, d0, shard)
        c = decay * state["v_col"] + (1.0 - decay) * _mean(gs, d1, shard)
        state["v_row"].copy_(r)
        state["v_col"].copy_(c)
        u = g * (r / _mean(r, d1, shard)).rsqrt() * c.rsqrt()
    u = u / torch.clamp(torch.sqrt(_mean(u * u, None, shard)) / FACTOR_CLIP, min=1.0)
    lr32 = torch.tensor(lr, dtype=torch.float32)
    u = -(u * lr32)
    if weight_decay:
        u = u - (lr32 * weight_decay) * p
    p.add_(u)


def lowmem_init(p: torch.Tensor, moments: Moments) -> Dict[str, torch.Tensor]:
    """Zero moments of ``p`` as ``moments`` stores them: ``m``, and ``v`` or
    (factored) ``row`` [..., n] and ``col`` [..., m] in fp32."""
    state = {"m": torch.zeros_like(p, dtype=moments.mu_dtype or p.dtype)}
    if moments.factored(p):
        state["row"] = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
        state["col"] = torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                   device=p.device)
    else:
        state["v"] = torch.zeros_like(p, dtype=moments.nu_dtype or p.dtype)
    return state


def _fma(a: float, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a x + c`` in fp32 rounded once (``a`` taken as fp32), as XLA
    computes a moment's update ``b t + (1 - b) g``: it fuses the first
    product into the add (a fused multiply-add). The product of two fp32
    values is exact in fp64, so the sum is rounded to fp64 and then to fp32
    (the fused result but for a tie between the two roundings)."""
    return (x.double() * float(np.float32(a)) + c.double()).float()


@torch.no_grad()
def lowmem_adamw_step_(p: torch.Tensor, g: torch.Tensor, state: Dict[str, torch.Tensor],
                       count: int, lr: float, weight_decay: float, moments: Moments) -> None:
    """One AdamW update of ``p`` in place from gradient ``g``, its moments in
    ``state`` (``lowmem_init``) updated in place; ``count`` updates were
    applied before. ``adamw_lowmem`` of the JAX package
    (``schemanet_tpu/train/common.py``): ``m = b1 m + (1 - b1) g`` and ``n =
    b2 n + (1 - b2) g^2`` in fp32 from the stored moments, ``u = (m / bc1) /
    (sqrt(n / bc2) + eps)`` (factored: ``n / bc2`` replaced by ``r c^T /
    max(sum r, 1e-30) / bc2``), the moments stored rounded; then ``p += -lr
    (u + wd p)``, as optax's ``add_decayed_weights`` and
    ``scale_by_learning_rate``. With ``moments.optax_mu`` the b1 of ``b1 m``
    is rounded to m's dtype first, as ``optax.adamw(mu_dtype)`` computes
    it."""
    b1, b2 = ADAM_B1, ADAM_B2
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    g32 = g.float()
    mu = state["m"]
    g2 = g32 * g32
    if moments.optax_mu:  # optax's order: (1 - b) g^k + b t, b1 in mu's dtype
        b1_mu = torch.tensor(b1, dtype=mu.dtype).item()
        m32 = _fma(1.0 - b1, g32, b1_mu * mu.float())
    else:
        m32 = _fma(b1, mu.float(), (1.0 - b1) * g32)
    if "v" in state:
        v = state["v"].float()
        n32 = (_fma(1.0 - b2, g2, b2 * v) if moments.optax_mu
               else _fma(b2, v, (1.0 - b2) * g2))
        state["v"].copy_(n32)
        nu_hat = n32 / bc2
    else:
        r = _fma(b2, state["row"], (1.0 - b2) * g2.sum(-1))
        c = _fma(b2, state["col"], (1.0 - b2) * g2.sum(-2))
        state["row"].copy_(r)
        state["col"].copy_(c)
        denom = torch.clamp(r.sum(-1)[..., None, None], min=1e-30)
        nu_hat = (r[..., :, None] * c[..., None, :]) / denom / bc2
    mu.copy_(m32)
    u = ((m32 / bc1) / (torch.sqrt(nu_hat) + ADAM_EPS)).to(g.dtype)
    p.add_((u + weight_decay * p) * torch.tensor(-lr, dtype=torch.float32))


def group_step_(p: torch.Tensor, g: torch.Tensor, state: Dict[str, torch.Tensor], count: int,
                lr: float, hyper: GroupHyper) -> None:
    """One update of parameter ``p`` (its data changed in place) by its
    group's optimizer at the schedule's ``lr``; ``count`` updates were
    applied before."""
    lr = lr * hyper.lr_scale
    if hyper.kind == "sgd":
        sgd_step_(p.data, g, state, lr, hyper.momentum)
    elif hyper.kind == "adafactor":
        adafactor_step_(p.data, g, state, count, lr, hyper.weight_decay, grid_shard(p))
    else:
        lowmem_adamw_step_(p.data, g, state, count, lr, hyper.weight_decay, hyper.moments)


class PlainUpdates:
    """The groups of ``make_optimizer`` that ``torch.optim.AdamW`` does not
    update (moments in a narrow dtype or factored, Adam, SGD, Adafactor):
    ``group_step_`` on each of their parameters."""

    def __init__(self, params: Dict[str, List[nn.Parameter]], hyper: Dict[str, GroupHyper]):
        self.groups = [(hyper[label], ps) for label, ps in params.items() if ps]
        self.state = [[optimizer_init(p, hp) for p in ps] for hp, ps in self.groups]

    def step(self, count: int, lr: float) -> None:
        for (hp, ps), states in zip(self.groups, self.state):
            for p, st in zip(ps, states):
                if p.grad is not None:
                    group_step_(p, p.grad, st, count, lr, hp)

    def zero_grad(self) -> None:
        for _, ps in self.groups:
            for p in ps:
                p.grad = None

    def state_dict(self) -> List[List[Dict[str, torch.Tensor]]]:
        return self.state

    def load_state_dict(self, state) -> None:
        for mine, saved in zip(self.state, state):
            for st, sv in zip(mine, saved):
                for k, t in st.items():
                    t.copy_(sv[k])


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


def _torch_adamw(hyper: GroupHyper) -> bool:
    return hyper.kind == "adamw" and hyper.moments is None


class ScheduledAdamW:
    """``torch.optim.AdamW`` over the labelled AdamW groups with fp32
    moments and ``PlainUpdates`` over the others, their lr set from the
    schedule at every step. The state dict is torch's (``state``,
    ``param_groups``), with the plain groups' states under ``lowmem`` where
    there are any."""

    def __init__(self, params: Dict[str, List[nn.Parameter]], hyper: Dict[str, GroupHyper],
                 schedule: Callable[[int], float]):
        self.schedule = schedule
        groups = [
            {"params": ps, "lr": schedule(0) * hyper[label].lr_scale,
             "weight_decay": hyper[label].weight_decay, "lr_scale": hyper[label].lr_scale}
            for label, ps in params.items() if ps and _torch_adamw(hyper[label])
        ]
        self.optimizer = (torch.optim.AdamW(groups, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS)
                          if groups else None)
        lowmem = {label: ps for label, ps in params.items()
                  if ps and not _torch_adamw(hyper[label])}
        self.lowmem = PlainUpdates(lowmem, hyper) if lowmem else None

    def zero_grad(self) -> None:
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=True)
        if self.lowmem is not None:
            self.lowmem.zero_grad()

    def state_dict(self) -> Dict[str, Any]:
        state = self.optimizer.state_dict() if self.optimizer is not None else {}
        if self.lowmem is not None:
            state = {**state, "lowmem": self.lowmem.state_dict()}
        return state

    def map_state(self, state: Dict[str, Any], fn: Callable) -> Dict[str, Any]:
        """``state`` (of this optimizer's layout) with every moment tensor
        ``t`` of parameter ``p`` replaced by ``fn(t, p)``: a grid's trainer
        gathers shards' moments for a checkpoint and slices them back."""
        out = dict(state)
        if self.optimizer is not None:
            params = [p for g in self.optimizer.param_groups for p in g["params"]]
            out["state"] = {i: {k: fn(v, params[i]) if torch.is_tensor(v) and v.ndim else v
                                for k, v in st.items()}
                            for i, st in state["state"].items()}
        if self.lowmem is not None:
            out["lowmem"] = [[{k: fn(t, p) if follows_split(k, p) else t for k, t in st.items()}
                              for p, st in zip(ps, sts)]
                             for (_, ps), sts in zip(self.lowmem.groups, state["lowmem"])]
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        state = dict(state)
        lowmem = state.pop("lowmem", None)
        if self.optimizer is not None:
            self.optimizer.load_state_dict(state)
        if self.lowmem is not None:
            self.lowmem.load_state_dict(lowmem)

    def step(self, count: int) -> None:
        """One update; ``count`` is the number of updates already applied."""
        lr = self.schedule(count)
        if self.optimizer is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = lr * group["lr_scale"]
            self.optimizer.step()
        if self.lowmem is not None:
            self.lowmem.step(count, lr)


def make_optimizer(
    model: nn.Module,
    optimizer_cfg: Dict[str, Any],
    schedule: Callable[[int], float],
    param_groups: Optional[Sequence[Dict[str, Any]]] = None,
    drop_remain: bool = False,
    frozen_patterns: Sequence[str] = (),
    exclude: Sequence[str] = (),
) -> Tuple[ScheduledAdamW, Dict[str, str], Dict[str, GroupHyper]]:
    """AdamW, Adam, SGD or factored AdamW (Adafactor) over ``model``'s
    parameters by regex group. Freezes (sets ``requires_grad=False`` on) the
    frozen ones; ``exclude`` names trainable parameters that another update
    owns (the hot atlas tensors). Returns ``(optimizer, labels, hyper)``:
    the label of every parameter and the hyperparameters of every label but
    ``frozen``."""
    name = optimizer_cfg.get("name", "AdamW").lower()
    if name not in ("adamw", "adam", "sgd"):
        raise KeyError(f"unknown optimizer {name!r}")
    factored = bool(optimizer_cfg.get("factored", False))
    momentum = float(optimizer_cfg.get("momentum", 0.9))
    groups = list(param_groups or [])
    base_lr = float(optimizer_cfg.get("lr", 1e-3))
    weight_decay = float(optimizer_cfg.get("weight_decay", 0.0))
    moment_dtype = _dtype(optimizer_cfg.get("moment_dtype"))

    def make_one(lr_scale: float, wd: float, cfg: Dict[str, Any]) -> GroupHyper:
        """As the JAX make_one: under adamw, any group key -> adamw_lowmem,
        else factored -> Adafactor, else a top-level moment_dtype ->
        optax.adamw(mu_dtype), else fp32 AdamW; adam -> optax.adam(mu_dtype)
        (no decay); sgd -> optax.sgd (no decay)."""
        if name == "sgd":
            return GroupHyper(lr_scale, 0.0, kind="sgd", momentum=momentum)
        if name == "adam":
            return GroupHyper(lr_scale, 0.0, Moments(moment_dtype, optax_mu=True))
        if any(k in cfg for k in _GROUP_LOWMEM_KEYS):
            return GroupHyper(lr_scale, wd, Moments(
                _dtype(cfg.get("moment_dtype")) if "moment_dtype" in cfg else moment_dtype,
                _dtype(cfg.get("nu_dtype")), cfg.get("nu_factored_min_size")))
        if factored:
            return GroupHyper(lr_scale, wd, kind="adafactor")
        return GroupHyper(lr_scale, wd,
                          Moments(moment_dtype, optax_mu=True) if moment_dtype else None)

    hyper = {"default": make_one(1.0, weight_decay, {})}
    for gi, group in enumerate(groups):
        cfg = group.get("cfg") or {}
        hyper[f"group_{gi}"] = make_one(float(cfg.get("lr", base_lr)) / base_lr,
                                        float(cfg.get("weight_decay", weight_decay)), cfg)
    named = list(model.named_parameters())
    labels = param_labels(named, groups, drop_remain, frozen_patterns)
    params: Dict[str, List[nn.Parameter]] = {label: [] for label in hyper}
    for pname, p in named:
        label = labels[pname]
        p.requires_grad_(label != "frozen")
        if label != "frozen" and pname not in exclude:
            params[label].append(p)
    return ScheduledAdamW(params, hyper, schedule), labels, hyper


class CheckpointManager:
    """``iter-<n>`` checkpoints and a ``best`` copy in ``ckpt_dir``, one
    ``torch.save`` file a tag. ``max_keep`` keeps the newest N ``iter-*``
    files (``best`` and other tags are never pruned); None keeps all. One
    process writes: on a grid, rank 0 writes the gathered state, which is
    the file one process would write, so it restores on any grid."""

    def __init__(self, ckpt_dir: str, max_keep: Optional[int] = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_keep = max_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.ckpt_dir, f"{tag}.pt")

    def _prune(self) -> None:
        if self.max_keep is None:
            return
        iters = []
        for name in os.listdir(self.ckpt_dir):
            stem, ext = os.path.splitext(name)
            if stem.startswith("iter-") and ext == ".pt" and stem[5:].isdigit():
                iters.append((int(stem[5:]), name))
        iters.sort()
        for _, name in iters[: max(0, len(iters) - self.max_keep)]:
            os.remove(os.path.join(self.ckpt_dir, name))

    def save(self, tag: str, state: Mapping[str, Any], is_best: bool = False) -> None:
        """Write ``state`` under ``tag`` (through a temporary file, so a
        crash leaves the previous file whole); copy it to ``best`` when
        ``is_best``; prune."""
        path = self._path(tag)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        if is_best:
            shutil.copyfile(path, self._path("best") + ".tmp")
            os.replace(self._path("best") + ".tmp", self._path("best"))
        self._prune()

    def restore(self, tag_or_path: str) -> Dict[str, Any]:
        """The saved state of a tag, or of a file path, on the CPU."""
        path = tag_or_path if os.path.isabs(tag_or_path) else self._path(tag_or_path)
        return torch.load(path, map_location="cpu", weights_only=True)

    def exists(self, tag: str) -> bool:
        return os.path.isfile(self._path(tag))


def merge_restored(init: Mapping[str, Any], restored: Mapping[str, Any],
                   name: str = "ckpt") -> Dict[str, Any]:
    """Lax overlay of a restored (possibly nested) state dict onto a fresh
    one, as the reference's tolerant ``load_pretrain_model``
    (``utils/model.py:24-33``): keys in both with equal shapes come from the
    checkpoint; missing or other-shaped ones (a head for another class
    count) keep the local value and are logged."""
    logger = logging.getLogger("merge_restored")
    skipped = []

    def overlay(dst, src, path):
        if isinstance(dst, Mapping):
            out = {}
            for k, v in dst.items():
                if isinstance(src, Mapping) and k in src:
                    out[k] = overlay(v, src[k], f"{path}/{k}")
                else:
                    skipped.append(f"{path}/{k} (missing in {name})")
                    out[k] = v
            return out
        if tuple(np.shape(src)) != tuple(np.shape(dst)):
            skipped.append(f"{path} (shape {tuple(np.shape(src))} != {tuple(np.shape(dst))})")
            return dst
        return src

    merged = overlay(init, restored, "")
    for msg in skipped:
        logger.warning("keeping local init for %s", msg)
    return merged


def save_metadata(ckpt_dir: str, meta: Dict[str, Any]) -> None:
    """``meta.json`` in ``ckpt_dir`` (the JAX package's keys: epoch, iter,
    best_acc, best_iter, eval, last_tag)."""
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=float)


def load_metadata(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(ckpt_dir, "meta.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def checkpoint_file(path: str) -> str:
    """The file of a checkpoint named by ``path``: a ``<tag>.pt`` file; a
    tag's path without the extension (``run/ckpt/best``); or a checkpoint
    directory, whose ``best`` tag is taken where it exists, else the
    ``last_tag`` of its ``meta.json``."""
    path = os.path.abspath(os.path.expanduser(path))
    if os.path.isfile(path):
        return path
    if os.path.isfile(path + ".pt"):
        return path + ".pt"
    if os.path.isdir(path):
        tag = "best" if os.path.isfile(os.path.join(path, "best.pt")) else (
            (load_metadata(path) or {}).get("last_tag"))
        if tag and os.path.isfile(os.path.join(path, f"{tag}.pt")):
            return os.path.join(path, f"{tag}.pt")
    raise FileNotFoundError(f"no checkpoint at {path}")


def restore_model_state(path: str) -> Dict[str, Any]:
    """The model state dict of the checkpoint named by ``path``
    (``checkpoint_file``) on the CPU: its ``model`` entry, or the file's
    whole content where it has none."""
    file = checkpoint_file(path)
    restored = CheckpointManager(os.path.dirname(file), max_keep=None).restore(file)
    return restored.get("model", restored)
