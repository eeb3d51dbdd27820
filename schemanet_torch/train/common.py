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

The low-memory updates are plain PyTorch (``LowMemAdamW``), as the JAX
package runs them as plain XLA. Not ported: ``factored: true``
(``optax.adafactor``) and the ``adam`` and ``sgd`` optimizers; asking for
them raises ``NotImplementedError``.

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

_GROUP_LOWMEM_KEYS = ("nu_dtype", "nu_factored_min_size", "moment_dtype")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, which the JAX package uses
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
    ``moments`` None for ``torch.optim.AdamW`` (fp32 moments)."""

    lr_scale: float
    weight_decay: float
    moments: Optional[Moments] = None


def _bias_correction(b: float, count: int) -> torch.Tensor:
    """1 - b^t at t = count + 1, in fp32 as optax computes it."""
    return torch.tensor(1.0, dtype=torch.float32) - torch.tensor(b, dtype=torch.float32) ** float(
        count + 1)


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


class LowMemAdamW:
    """The groups of ``make_optimizer`` that store their moments in a narrow
    dtype or factored: ``lowmem_adamw_step_`` on each of their parameters."""

    def __init__(self, params: Dict[str, List[nn.Parameter]], hyper: Dict[str, GroupHyper]):
        self.groups = [(hyper[label], ps) for label, ps in params.items() if ps]
        self.state = [[lowmem_init(p, hp.moments) for p in ps] for hp, ps in self.groups]

    def step(self, count: int, lr: float) -> None:
        for (hp, ps), states in zip(self.groups, self.state):
            for p, st in zip(ps, states):
                if p.grad is not None:
                    lowmem_adamw_step_(p.data, p.grad, st, count, lr * hp.lr_scale,
                                       hp.weight_decay, hp.moments)

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


class ScheduledAdamW:
    """``torch.optim.AdamW`` over the labelled groups with fp32 moments and
    ``LowMemAdamW`` over the others (``GroupHyper.moments``), their lr set
    from the schedule at every step. The state dict is torch's (``state``,
    ``param_groups``), with the low-memory groups' moments under
    ``lowmem`` where there are any."""

    def __init__(self, params: Dict[str, List[nn.Parameter]], hyper: Dict[str, GroupHyper],
                 schedule: Callable[[int], float]):
        self.schedule = schedule
        groups = [
            {"params": ps, "lr": schedule(0) * hyper[label].lr_scale,
             "weight_decay": hyper[label].weight_decay, "lr_scale": hyper[label].lr_scale}
            for label, ps in params.items() if ps and hyper[label].moments is None
        ]
        self.optimizer = (torch.optim.AdamW(groups, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS)
                          if groups else None)
        lowmem = {label: ps for label, ps in params.items()
                  if ps and hyper[label].moments is not None}
        self.lowmem = LowMemAdamW(lowmem, hyper) if lowmem else None

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
    """AdamW over ``model``'s parameters by regex group. Freezes (sets
    ``requires_grad=False`` on) the frozen ones; ``exclude`` names trainable
    parameters that another update owns (the fused atlas tensors). Returns
    ``(optimizer, labels, hyper)``: the label of every parameter and the
    hyperparameters of every label but ``frozen``."""
    name = optimizer_cfg.get("name", "AdamW").lower()
    if name != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported (only AdamW)")
    if optimizer_cfg.get("factored"):
        raise NotImplementedError("factored: true (optax.adafactor) is not ported")
    groups = list(param_groups or [])
    base_lr = float(optimizer_cfg.get("lr", 1e-3))
    weight_decay = float(optimizer_cfg.get("weight_decay", 0.0))
    moment_dtype = _dtype(optimizer_cfg.get("moment_dtype"))

    def moments_of(cfg: Dict[str, Any]) -> Optional[Moments]:
        """As the JAX make_one: any group key -> adamw_lowmem; else a
        top-level moment_dtype -> optax.adamw(mu_dtype); else fp32 AdamW."""
        if any(k in cfg for k in _GROUP_LOWMEM_KEYS):
            return Moments(_dtype(cfg.get("moment_dtype")) if "moment_dtype" in cfg
                           else moment_dtype, _dtype(cfg.get("nu_dtype")),
                           cfg.get("nu_factored_min_size"))
        if moment_dtype is not None:
            return Moments(moment_dtype, optax_mu=True)
        return None

    hyper = {"default": GroupHyper(1.0, weight_decay, moments_of({}))}
    for gi, group in enumerate(groups):
        cfg = group.get("cfg") or {}
        hyper[f"group_{gi}"] = GroupHyper(
            float(cfg.get("lr", base_lr)) / base_lr, float(cfg.get("weight_decay", weight_decay)),
            moments_of(cfg),
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


class CheckpointManager:
    """``iter-<n>`` checkpoints and a ``best`` copy in ``ckpt_dir``, one
    ``torch.save`` file a tag. ``max_keep`` keeps the newest N ``iter-*``
    files (``best`` and other tags are never pruned); None keeps all. One
    process writes: the port's training runs in one."""

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
