"""The training step (port of ``schemanet_tpu/train/trainer.py``), generic
over the model as the JAX one is: the ViT/DeiT backbone of stage 0
(``backbone_worker``) or the SchemaNet predictor of stage 4
(``schema_net_worker``, its ``fused_atlas`` path).

``Trainer(cfg, model, loss_fn, loss_weights, steps_per_epoch, seed, device)``
moves the model to ``device`` (CUDA unless the caller passes ``"cpu"``) and,
for a SchemaNet predictor, projects the atlas once
(``project_atlas_params``); from then on ``train_iter(batch)`` takes one
step:

1. for a SchemaNet predictor, clamp the attribute weights (the rest of the
   projection is kept by 5.);
2. the training forward (``deterministic=False``: dropout live where the
   model has it, drawn from the trainer's ``DropoutRNG``), the loss and the
   backward (a SchemaNet predictor's frozen backbone runs without autograd);
3. with ``clip_max_norm``, ``clip_by_global_norm`` over every trainable
   gradient, the hot atlas tensors' included;
4. AdamW on the trainable parameters other than the two hot atlas tensors;
5. for a SchemaNet predictor, ``adamw_project_rows`` on ``vertex_weights``
   and ``edge_weights``: AdamW and the row projection in one pass, so they
   stay projected. The gradient therefore sees the same projected parameters
   as under the JAX package's default, the projection before every step
   (``ops/kernels/atlas_opt.py``).

Both updates read the schedule at the count before the update and use the
hyperparameters of the group their parameters fall in. Dropout randomness
comes from two generators the trainer owns, both seeded from ``seed``: a
CPU one for the int32 seeds of the in-kernel masks (drawn on the host, one
per kernel call, as JAX draws ``randint(make_rng("dropout"))``) and one on
the device for the residual and positional masks; nothing reads PyTorch's
global generator. The trainer takes ``steps_per_epoch`` in place of a
loader; loaders, validation, checkpoints and resume are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..device import resolve_device
from ..models.layers import DropoutRNG
from ..ops.kernels import atlas_opt as ao
from ..schema.atlas import clamp_attribute_weights_, project_atlas_params
from ..schema.loss import weighted_total
from .common import clip_by_global_norm, epoch_schedule, make_optimizer

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
        (batch size, dtype, loader and logging settings) are ignored."""
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
    """One training step at a time of ``model`` on ``device``."""

    def __init__(self, cfg: TrainerConfig, model: torch.nn.Module, loss_fn: Callable,
                 loss_weights: Dict[str, float], steps_per_epoch: int, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.cfg, self.model = cfg, model.to(self.device)
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
        self.atlas = getattr(model, "schema_net", None)
        hot_names = []
        if self.atlas is not None:
            project_atlas_params(self.atlas)  # from here on the fused update keeps it projected
            if self.atlas.cfg.apply_normalize:
                hot_names = [f"schema_net.{k}" for k in HOT_ATLAS]
        self.optimizer, self.labels, hyper = make_optimizer(
            model, cfg.optimizer, self.schedule, cfg.param_groups, cfg.drop_remain,
            cfg.frozen_patterns, exclude=hot_names,
        )
        self.hot = {}
        for name in hot_names:
            label = self.labels[name]
            if label == "frozen":
                continue
            p = getattr(self.atlas, name.split(".", 1)[1])
            self.hot[name] = _HotTensor(
                p, torch.zeros_like(p), torch.zeros_like(p), hyper[label].lr_scale,
                hyper[label].weight_decay,
                name.endswith("edge_weights") and self.atlas.cfg.remove_self_loop,
            )
        self.trainable = [p for p in model.parameters() if p.requires_grad]
        self.rng = DropoutRNG(torch.Generator().manual_seed(seed),
                              torch.Generator(device=self.device).manual_seed(seed))
        self.step = 0  # updates applied

    def forward_loss(self, batch: Dict[str, torch.Tensor]):
        """(weighted total, loss dict) of the batch's training forward."""
        out = self.model(batch["image"], deterministic=False, rng=self.rng)
        loss_dict = self.loss_fn(out, {"label": batch["label"]})
        return weighted_total(loss_dict, self.loss_weights), loss_dict

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()
        for hot in self.hot.values():
            hot.param.grad = None

    def clip_gradients(self) -> None:
        """``clip_by_global_norm`` over every trainable gradient, when the
        config asks for it."""
        if self.cfg.clip_max_norm:
            grads = [p.grad for p in self.trainable if p.grad is not None]
            clip_by_global_norm(grads, float(self.cfg.clip_max_norm))

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
        """One step on ``batch`` (``image`` [B, H, W, 3] float, ``label`` [B]),
        moved to the trainer's device; returns the detached loss terms,
        ``loss`` their weighted total."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        if self.atlas is not None:
            clamp_attribute_weights_(self.atlas)
        total, loss_dict = self.forward_loss(batch)
        self.zero_grad()
        total.backward()
        self.clip_gradients()
        self.apply_updates()
        return {"loss": total.detach(), **{k: v.detach() for k, v in loss_dict.items()}}
