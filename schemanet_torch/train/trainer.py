"""The SchemaNet training step (port of ``schemanet_tpu/train/trainer.py``,
its ``fused_atlas`` path, with ``schema_net_worker``'s model setup).

``Trainer(cfg, model, loss_fn, loss_weights, steps_per_epoch)`` projects the
atlas once (``project_atlas_params``); from then on ``train_iter(batch)``
takes one step:

1. clamp the attribute weights (the rest of the projection is kept by 4.);
2. forward, loss and backward (the frozen backbone runs without autograd);
3. AdamW on the trainable parameters other than the two hot atlas tensors;
4. ``adamw_project_rows`` on ``vertex_weights`` and ``edge_weights``: AdamW
   and the row projection in one pass, so they stay projected. The gradient
   therefore sees the same projected parameters as under the JAX package's
   default, the projection before every step (``ops/kernels/atlas_opt.py``).

Both updates read the schedule at the count before the update and use the
hyperparameters of the group their parameters fall in. The trainer takes
``steps_per_epoch`` in place of a loader; loaders, validation, checkpoints,
resume and gradient clipping are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..ops.kernels import atlas_opt as ao
from ..schema.atlas import clamp_attribute_weights_, project_atlas_params
from ..schema.loss import weighted_total
from ..schema.predictor import SchemaNetPredictor
from .common import epoch_schedule, make_optimizer

# the frozen patterns schema_net_worker adds to the YAML's parameter groups
SCHEMA_NET_FROZEN = (r"backbone\.", r"ingredient_backbone\.")
HOT_ATLAS = ("vertex_weights", "edge_weights")


@dataclasses.dataclass
class TrainerConfig:
    train_epochs: int
    clip_max_norm: Optional[float] = None
    optimizer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    lr_schedule: Dict[str, Any] = dataclasses.field(default_factory=dict)
    param_groups: Optional[Sequence[Dict[str, Any]]] = None
    drop_remain: bool = False
    frozen_patterns: Sequence[str] = ()

    @classmethod
    def from_cfg(cls, train_cfg: Dict[str, Any], **over):
        """From a YAML ``training`` block; keys this trainer does not read
        (batch size, loader and logging settings) are ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in train_cfg.items() if k in known}
        kwargs.update(over)
        return cls(**kwargs)


@dataclasses.dataclass
class _HotTensor:
    param: torch.nn.Parameter
    m: torch.Tensor
    v: torch.Tensor
    lr_scale: float
    weight_decay: float
    remove_self_loop: bool


class Trainer:
    """One SchemaNet training step at a time on ``model``'s device."""

    def __init__(self, cfg: TrainerConfig, model: SchemaNetPredictor, loss_fn: Callable,
                 loss_weights: Dict[str, float], steps_per_epoch: int):
        if cfg.clip_max_norm:
            raise NotImplementedError("gradient clipping is not ported yet")
        self.cfg, self.model = cfg, model
        self.loss_fn, self.loss_weights = loss_fn, dict(loss_weights)
        self.steps_per_epoch = max(steps_per_epoch, 1)
        sched = dict(cfg.lr_schedule)
        self.schedule = epoch_schedule(
            name=sched.pop("name", "cosine_annealing"),
            base_lr=float(cfg.optimizer.get("lr", 1e-3)),
            steps_per_epoch=self.steps_per_epoch,
            total_epochs=cfg.train_epochs,
            warmup_iters=int(sched.pop("warmup_iters", 0) or 0),
            eta_min=float(sched.pop("eta_min", 0.0) or 0.0),
            T_max=sched.pop("T_max", None),
        )
        atlas = model.schema_net
        project_atlas_params(atlas)  # from here on the fused update keeps it projected
        hot_names = [f"schema_net.{k}" for k in HOT_ATLAS] if atlas.cfg.apply_normalize else []
        self.optimizer, self.labels, hyper = make_optimizer(
            model, cfg.optimizer, self.schedule, cfg.param_groups, cfg.drop_remain,
            cfg.frozen_patterns, exclude=hot_names,
        )
        self.hot = {}
        for name in hot_names:
            label = self.labels[name]
            if label == "frozen":
                continue
            p = getattr(atlas, name.split(".", 1)[1])
            self.hot[name] = _HotTensor(
                p, torch.zeros_like(p), torch.zeros_like(p), hyper[label].lr_scale,
                hyper[label].weight_decay,
                name.endswith("edge_weights") and atlas.cfg.remove_self_loop,
            )
        self.step = 0  # updates applied

    def forward_loss(self, batch: Dict[str, torch.Tensor]):
        """(weighted total, loss dict) of the batch's forward."""
        out = self.model(batch["image"])
        loss_dict = self.loss_fn(out, {"label": batch["label"]})
        return weighted_total(loss_dict, self.loss_weights), loss_dict

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()
        for hot in self.hot.values():
            hot.param.grad = None

    def apply_updates(self) -> None:
        """AdamW on the rest, then the fused AdamW + projection of the hot
        atlas tensors; advances the step count."""
        self.optimizer.step(self.step)
        lr = self.schedule(self.step)
        for hot in self.hot.values():
            ao.adamw_project_rows(
                hot.param.data, hot.param.grad.contiguous(), hot.m, hot.v, self.step,
                lr=lr * hot.lr_scale, weight_decay=hot.weight_decay, project=True,
                remove_self_loop=hot.remove_self_loop,
            )
        self.step += 1

    def train_iter(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` (``image`` [B, H, W, 3] float, ``label`` [B]);
        returns the detached loss terms, ``loss`` their weighted total."""
        clamp_attribute_weights_(self.model.schema_net)
        total, loss_dict = self.forward_loss(batch)
        self.zero_grad()
        total.backward()
        self.apply_updates()
        return {"loss": total.detach(), **{k: v.detach() for k, v in loss_dict.items()}}
