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
   stay projected (the kernel's plain version where the policy's
   ``atlas_opt`` is plain, ``ops/policy.py``). The gradient therefore sees
   the same projected parameters as under the JAX package's default, the
   projection before every step
   (``ops/kernels/atlas_opt.py``). Their moments are stored as their group
   asks (``common.py`` ``Moments``): fp32, or bf16 under ``moment_dtype`` /
   ``nu_dtype`` (the kernel's bf16-moment variant: ``adamw_lowmem`` then the
   projection, as the JAX package computes it). A group whose update the
   kernel does not compute (a factored nu, or ``optax.adamw(mu_dtype)``'s b1
   rounded to bf16 under a top-level ``moment_dtype``) takes the plain
   low-memory update and then the plain projection, as the JAX package
   does. So does a hot tensor whose group's optimizer is not AdamW (Adam,
   SGD, Adafactor): its group's update, then ``project_rows_``; never the
   kernel. By the argument of ``schemanet_tpu/train/trainer.py``'s
   ``fused_atlas`` note, update-then-project equals the JAX package's
   projection before every step. The ImageNet YAMLs
   put every atlas tensor in the ``schema_net`` group, so all four
   (vertex, edge and both attribute weights) keep bf16 moments, where
   ``bench.py`` gave bf16 moments to two of them: the port follows the YAML
   the workers read.

Both updates read the schedule at the count before the update and use the
hyperparameters of the group their parameters fall in. Dropout randomness
comes from two generators the trainer owns, both seeded from ``seed``: a
CPU one for the int32 seeds of the in-kernel masks (drawn on the host, one
per kernel call, as JAX draws ``randint(make_rng("dropout"))``) and one on
the device for the residual and positional masks; nothing reads PyTorch's
global generator.

Images: ``train_iter`` resizes and normalises uint8 images on the device
with the training loader's ``prepare`` (``data/loader.py``); float images
pass as they are.

The loop (``__call__``), with a ``train_loader`` and a ``val_loader``, as
the JAX ``Trainer.__call__``: an initial validation, then for each epoch
from ``start_epoch`` the loader reshuffled by ``set_epoch``, its batches
prefetched to the device, one ``train_iter`` each, a log and TensorBoard
line every ``print_interval`` steps (and images/s of the host clock from a
``StepTimer``), ``validate_and_save`` every ``val_interval`` steps and at
the end. ``validate`` clamps a SchemaNet predictor's attribute weights
(the fused update keeps the hot tensors projected) and runs ``Evaluation``
(loss, top-1, top-5); ``validate_and_save`` keeps the best accuracy and,
with a ``ckpt_dir``, saves ``iter-<step>`` (``best`` too when it is the
best) and ``meta.json``. A
checkpoint holds the model's state dict (frozen parts included), the AdamW
state, the hot tensors' moments (in their dtypes), the step (the
schedule's position) and both dropout generators' states, so ``resume`` ("auto": the ``last_tag`` of
``meta.json``) continues at the epoch after the saved one with the bits of
an uninterrupted run. SIGTERM or SIGINT during the loop saves a checkpoint
at the next step's end and stops.

Several GPUs (``mesh``, a ``parallel.mesh.Mesh``; one process a rank): the
trainer shards the model by the grid's rules (``shard_module``: the atlas's
classes, the GNN embedding's rows and four backbone weights over ``model``),
so the moments of a sharded parameter are those of its shard and
``adamw_project_rows`` runs on the local atlas rows. Each rank takes its
data slice of the global batch and back-propagates its loss divided by
``model``; ``reduce_gradients`` then sums a replicated parameter's gradient
over the model group and averages every gradient over the data group, in
the parameters' order, so the update is the one-process update on the
global batch. The loss terms returned are the global batch's (averaged over
the data group). Dropout draws the global batch's masks for the rank's rows
(``DropoutRNG.rows``), from generators seeded from ``seed`` on every rank.
Validation sums over the data group. A checkpoint is the gathered state,
written by rank 0 behind a barrier: the file one process writes, so it
restores on any grid.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..data.loader import batch_to_device, device_prefetch, prepare_images
from ..device import resolve_device
from ..models.layers import DropoutRNG
from ..ops import policy
from ..ops.kernels import atlas_opt as ao
from ..parallel.mesh import (Mesh, all_reduce_, gather_like, gather_params, grid_shard,
                             shard_module, shard_params, slice_like)
from ..schema.atlas import clamp_attribute_weights_, project_atlas_params
from ..schema.loss import weighted_total
from ..utils.logging_utils import TBWriter, process_rank
from ..utils.metrics import tensor_dict_items
from ..utils.profiling import StepTimer
from .common import (CheckpointManager, GroupHyper, clip_by_global_norm, epoch_schedule,
                     follows_split, group_step_, load_metadata, make_optimizer, optimizer_init,
                     save_metadata)
from .evaluator import Evaluation

# the frozen patterns schema_net_worker adds to the YAML's parameter groups
SCHEMA_NET_FROZEN = (r"backbone\.", r"ingredient_backbone\.")
HOT_ATLAS = ("vertex_weights", "edge_weights")


@dataclasses.dataclass
class TrainerConfig:
    train_epochs: int
    print_interval: int = 20
    val_interval: int = 500
    batch_size: int = 64
    clip_max_norm: Optional[float] = None
    optimizer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    lr_schedule: Dict[str, Any] = dataclasses.field(default_factory=dict)
    param_groups: Optional[Sequence[Dict[str, Any]]] = None
    drop_remain: bool = False
    frozen_patterns: Sequence[str] = ()
    # the newest iter-* checkpoints kept (best is never pruned); None/0 keeps all
    max_keep: Optional[int] = 3

    @classmethod
    def from_cfg(cls, train_cfg: Dict[str, Any], **over):
        """From a YAML ``training`` block; keys this trainer does not read
        (dtype, loader settings) are ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in train_cfg.items() if k in known}
        kwargs.update(over)
        return cls(**kwargs)


@dataclasses.dataclass
class _HotTensor:
    param: torch.nn.Parameter
    state: Dict[str, torch.Tensor]  # optimizer_init's: m and v (AdamW), or the group's
    hyper: GroupHyper
    remove_self_loop: bool

    @property
    def lr_scale(self) -> float:
        return self.hyper.lr_scale

    @property
    def weight_decay(self) -> float:
        return self.hyper.weight_decay

    @property
    def m(self) -> torch.Tensor:
        return self.state["m"]

    @property
    def v(self) -> torch.Tensor:
        return self.state["v"]

    @property
    def fused(self) -> bool:
        """The kernel computes this tensor's update: AdamW with full (not
        factored) moments, each in fp32 or bf16, and adamw_lowmem's b1."""
        moments = self.hyper.moments
        return (self.hyper.kind == "adamw" and "v" in self.state
                and not (moments and moments.optax_mu))


class Trainer:
    """Training of ``model`` on ``device``: one step (``train_iter``) or the
    epoch loop over the loaders (``__call__``)."""

    def __init__(self, cfg: TrainerConfig, model: torch.nn.Module, loss_fn: Callable,
                 loss_weights: Dict[str, float], steps_per_epoch: Optional[int] = None,
                 seed: int = 0, device=None, *, train_loader=None, val_loader=None,
                 log_dir: Optional[str] = None, ckpt_dir: Optional[str] = None,
                 resume: str = "", buffer_guard: Optional[Callable] = None,
                 extra_scalars: Optional[Callable] = None, top_k: Sequence[int] = (1, 5),
                 name: str = "trainer", mesh: Optional[Mesh] = None):
        """``steps_per_epoch`` defaults to ``len(train_loader)``.
        ``buffer_guard(state_dict)`` checks a checkpoint's state before
        ``resume`` loads it; ``extra_scalars(model)`` gives the TensorBoard
        ``Weights`` scalars of each log line. ``mesh``: the grid this rank
        trains on (its device unless ``device`` is given); the loaders
        must give this rank's data slice."""
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.device
        self.shardings = shard_module(model, mesh) if mesh is not None else {}
        self.device = resolve_device(device)
        self.logger = logging.getLogger(name)
        self.cfg, self.model = cfg, model.to(self.device)
        self.loss_fn, self.loss_weights = loss_fn, dict(loss_weights)
        if steps_per_epoch is None:
            steps_per_epoch = len(train_loader)
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.train_loader, self.val_loader = train_loader, val_loader
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
                p, optimizer_init(p, hyper[label]), hyper[label],
                name.endswith("edge_weights") and self.atlas.cfg.remove_self_loop,
            )
        self.trainable = [p for p in model.parameters() if p.requires_grad]
        self.rng = DropoutRNG(torch.Generator().manual_seed(seed),
                              torch.Generator(device=self.device).manual_seed(seed))
        self.step = 0  # updates applied

        self.tb = TBWriter(log_dir)
        self.top_k, self.extra_scalars = tuple(top_k), extra_scalars
        self.evaluation = (Evaluation(self.model, loss_fn, loss_weights, val_loader, self.top_k,
                                      self.device, mesh) if val_loader is not None else None)
        self.epoch = self.start_epoch = 0
        self.best_acc, self.best_iter = 0.0, 0
        self.ckpt = CheckpointManager(ckpt_dir, max_keep=cfg.max_keep or None) if ckpt_dir else None
        self.buffer_guard = buffer_guard
        self._stop_requested = False
        if resume:
            self.resume(resume)

    def forward_loss(self, batch: Dict[str, torch.Tensor]):
        """(weighted total, loss dict) of the batch's training forward."""
        if self.mesh is not None:  # this rank's items of the global batch
            b = batch["image"].shape[0]
            self.rng.rows = (self.mesh.data_index * b, self.mesh.data * b)
        out = self.model(batch["image"], deterministic=False, rng=self.rng)
        loss_dict = self.loss_fn(out, {"label": batch["label"]})
        return weighted_total(loss_dict, self.loss_weights), loss_dict

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()
        for hot in self.hot.values():
            hot.param.grad = None

    def reduce_gradients(self) -> None:
        """On a grid: each replicated parameter's gradient summed over the
        model group, then every gradient averaged over the data group, one
        parameter after another in the model's order."""
        m = self.mesh
        if m is None:
            return
        for p in self.trainable:
            if p.grad is None:
                continue
            if m.model > 1 and grid_shard(p) is None:
                all_reduce_(p.grad, m.model_group)
            all_reduce_(p.grad, m.data_group)
            if m.data > 1:
                p.grad.div_(m.data)

    def clip_gradients(self) -> None:
        """``clip_by_global_norm`` over every trainable gradient, when the
        config asks for it (on a grid, the norm of the whole parameters)."""
        if self.cfg.clip_max_norm:
            live = [p for p in self.trainable if p.grad is not None]
            clip_by_global_norm([p.grad for p in live], float(self.cfg.clip_max_norm),
                                [grid_shard(p) is not None for p in live], self.mesh)

    def apply_updates(self) -> None:
        """The optimizer on the rest, then the hot atlas tensors' update and
        projection (``adamw_project_rows``, or its plain version where the
        policy's ``atlas_opt`` is plain; the group's update and
        ``project_rows_`` where the kernel does not compute it); advances
        the step count."""
        self.optimizer.step(self.step)
        lr = self.schedule(self.step)
        for hot in self.hot.values():
            if hot.fused:
                fused = (ao.adamw_project_rows if policy.routes().atlas_opt
                         else ao.adamw_project_rows_reference)
                fused(hot.param.data, hot.param.grad.contiguous(), hot.m, hot.v, self.step,
                      lr=lr * hot.lr_scale, weight_decay=hot.weight_decay, project=True,
                      remove_self_loop=hot.remove_self_loop)
            else:
                group_step_(hot.param, hot.param.grad, hot.state, self.step, lr, hot.hyper)
                ao.project_rows_(hot.param.data, hot.remove_self_loop)
        self.step += 1

    def train_iter(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` (``image`` [B, H, W, 3], uint8 or float,
        ``label`` [B]), moved to the trainer's device; returns the detached
        loss terms, ``loss`` their weighted total."""
        batch = batch_to_device(batch, self.device)
        batch["image"] = prepare_images(self.train_loader, batch["image"], batch.pop("crop", None))
        if self.atlas is not None:
            clamp_attribute_weights_(self.atlas)
        total, loss_dict = self.forward_loss(batch)
        self.zero_grad()
        model_ranks = self.mesh.model if self.mesh is not None else 1
        (total / model_ranks if model_ranks > 1 else total).backward()
        self.reduce_gradients()
        self.clip_gradients()
        self.apply_updates()
        metrics = {"loss": total.detach(), **{k: v.detach() for k, v in loss_dict.items()}}
        if self.mesh is not None:  # the global batch's: the mean over the data group
            stacked = all_reduce_(torch.stack([v.float() for v in metrics.values()]),
                                  self.mesh.data_group) / self.mesh.data
            metrics = dict(zip(metrics, stacked.unbind()))
        return metrics

    # -- validation, checkpoints, resume --------------------------------------

    @property
    def iter_count(self) -> int:
        return self.step

    def validate(self) -> Dict[str, Any]:
        """``Evaluation`` of the model over ``val_loader`` (deterministic
        forwards; a SchemaNet predictor's attribute weights clamped first,
        as the JAX eval step projects them)."""
        if self.atlas is not None:
            clamp_attribute_weights_(self.atlas)
        self.val_loader.set_epoch(0)
        return self.evaluation()

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs to continue with the same bits; on
        a grid with a model axis the shards gathered whole (a collective:
        every rank calls it), as one process would hold them."""
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        hot = {name: hot.state for name, hot in self.hot.items()}
        if self.mesh is not None and self.mesh.model > 1:
            model = gather_params(self.mesh, model, self.shardings)
            opt = self.optimizer.map_state(opt, gather_like)
            hot = {name: {k: gather_like(t, h.param) if follows_split(k, h.param) else t
                          for k, t in h.state.items()} for name, h in self.hot.items()}
        return {
            "model": model,
            "optimizer": opt,
            "hot": hot,
            "step": self.step,
            "rng": {"seeds": self.rng.seeds.get_state(), "masks": self.rng.masks.get_state()},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """A ``state_dict`` (whole, as any grid writes it) onto this trainer;
        on a grid each rank takes its shards."""
        opt = state["optimizer"]
        model = state["model"]
        if self.mesh is not None:
            model = shard_params(self.mesh, model, self.shardings)
            opt = self.optimizer.map_state(opt, slice_like)
        with torch.no_grad():
            self.model.load_state_dict(model)
            for name, hot in self.hot.items():
                for key, t in hot.state.items():
                    saved = state["hot"][name][key]
                    t.copy_(slice_like(saved, hot.param) if follows_split(key, hot.param)
                            else saved)
        self.optimizer.load_state_dict(opt)
        self.step = int(state["step"])
        self.rng.seeds.set_state(state["rng"]["seeds"])
        self.rng.masks.set_state(state["rng"]["masks"])

    def validate_and_save(self, show_tb: bool = True) -> Dict[str, Any]:
        """Validate, track the best top-1, and with a ``ckpt_dir`` save
        ``iter-<step>`` and ``meta.json``. ``validate`` clamps a SchemaNet
        predictor's attribute weights (the fused update keeps the rest of
        the atlas projected), so a checkpoint holds a projected atlas, as
        the JAX trainer's ``validate_and_save`` leaves it."""
        eval_dict = self.validate()
        acc = eval_dict["acc"][self.top_k[0]]
        it = self.iter_count
        if process_rank() == 0:
            self.logger.info("Validation loss: %.5f, acc: %.4f, loss dict: %s", eval_dict["loss"],
                             acc, tensor_dict_items(eval_dict["loss_dict"]))
            if show_tb:
                self.tb.add_scalar("Val/Loss", eval_dict["loss"], it)
                self.tb.add_scalar("Val/Acc", acc, it)
                self.tb.add_scalar("Val/Acc@1", acc, it)
                if 5 in eval_dict["acc"]:
                    self.tb.add_scalar("Val/Acc@5", eval_dict["acc"][5], it)
                self.tb.add_scalars("Val/Loss_dict", eval_dict["loss_dict"], it)
        is_best = acc > self.best_acc
        if is_best:
            self.best_acc, self.best_iter = float(acc), it
        if self.ckpt is not None:
            tag = f"iter-{it}"
            state = self.state_dict() if self.mesh is not None or process_rank() == 0 else None
            if process_rank() == 0:
                self.ckpt.save(tag, state, is_best=is_best)
                save_metadata(self.ckpt.ckpt_dir, {
                    "epoch": self.epoch,
                    "iter": it,
                    "best_acc": self.best_acc,
                    "best_iter": self.best_iter,
                    "eval": {str(k): v for k, v in eval_dict["acc"].items()},
                    "last_tag": tag,
                })
            if self.mesh is not None:  # the file is whole before any rank reads it
                torch.distributed.barrier()
        return eval_dict

    def resume(self, tag_or_path: str) -> None:
        """Load a checkpoint of ``ckpt_dir`` (a tag or a file path; "auto":
        ``meta.json``'s ``last_tag``, or a fresh start when there is none)
        and continue at the epoch after the one it was saved in."""
        if self.ckpt is None:
            raise ValueError("resume requires a ckpt_dir")
        if tag_or_path == "auto":
            tag_or_path = (load_metadata(self.ckpt.ckpt_dir) or {}).get("last_tag", "")
            if not tag_or_path or not self.ckpt.exists(tag_or_path):
                self.logger.info("resume=auto: no previous checkpoint found; fresh start")
                return
        state = self.ckpt.restore(tag_or_path)
        if self.buffer_guard is not None:
            self.buffer_guard(state["model"])
        self.load_state_dict(state)
        meta = load_metadata(self.ckpt.ckpt_dir) or {}
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        self.best_acc = float(meta.get("best_acc", 0.0))
        self.best_iter = int(meta.get("best_iter", 0))
        self.logger.info("Resumed from %s at epoch %d, iter %d", tag_or_path, self.start_epoch,
                         self.iter_count)

    def install_signal_handlers(self) -> None:
        """SIGTERM and SIGINT ask for a checkpoint and a stop at the next
        step's end (the reference loses the progress since its last
        checkpoint). ``restore_signal_handlers`` puts the previous ones back."""

        def handler(signum, frame):
            self.logger.warning("signal %s received; will checkpoint and stop", signum)
            self.request_stop()

        self._prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread: no handlers
                return

    def restore_signal_handlers(self) -> None:
        for sig, prev in getattr(self, "_prev_handlers", {}).items():
            signal.signal(sig, prev)
        self._prev_handlers = {}

    def request_stop(self) -> None:
        """What the signal handler does: checkpoint and stop after the
        current step."""
        self._stop_requested = True

    def _log_step(self, metrics, step: int, tput) -> None:
        it = self.iter_count
        if tput is not None:
            self.logger.info("throughput: %.1f img/s (%.1f steps/s)", tput["items_per_sec"],
                             tput["steps_per_sec"])
            self.tb.add_scalar("Train/ImagesPerSec", tput["items_per_sec"], it)
        if it % self.cfg.print_interval == 0:
            loss_items = tensor_dict_items({k: v for k, v in metrics.items() if k != "loss"})
            lr, loss = self.schedule(self.step), float(metrics["loss"])
            self.logger.info("Epoch %3d|%3d, step %4d|%4d, iter %6d, lr %.3e, loss %.5f, %s",
                             self.epoch, self.cfg.train_epochs, step, self.steps_per_epoch, it,
                             lr, loss, loss_items)
            self.tb.add_scalar("Train/Loss", loss, it)
            self.tb.add_scalars("Train/Loss_dict", loss_items, it)
            self.tb.add_scalar("Train/Lr", lr, it)
            if self.extra_scalars is not None:
                self.tb.add_scalars("Weights", self.extra_scalars(self.model), it)

    def __call__(self, initial_validation: bool = True) -> Optional[Dict[str, Any]]:
        """Train from ``start_epoch`` to ``train_epochs``; the final
        validation's result, or None when a signal stopped the run."""
        start = time.time()
        self._stop_requested = False
        self.install_signal_handlers()
        try:
            if initial_validation:
                self.logger.info("Initial testing")
                self.validate_and_save(show_tb=False)
            timer = StepTimer(window=max(self.cfg.print_interval, 2))
            for self.epoch in range(self.start_epoch, self.cfg.train_epochs):
                self.train_loader.set_epoch(self.epoch)
                for step, batch in enumerate(device_prefetch(iter(self.train_loader), self.device)):
                    metrics = self.train_iter(batch)
                    tput = timer.step(self.cfg.batch_size)
                    if process_rank() == 0:
                        self._log_step(metrics, step, tput)
                    if self.step > 0 and self.step % self.cfg.val_interval == 0:
                        self.validate_and_save()
                    if self._stop_requested:
                        self.logger.warning("stopping early on request; saving checkpoint")
                        self.validate_and_save()
                        return None
            self.logger.info("Final validation")
            final = self.validate_and_save()
            if process_rank() == 0:
                self.logger.info("Training time %.1fs; best acc %.4f @ iter %d",
                                 time.time() - start, self.best_acc, self.best_iter)
            return final
        finally:
            self.restore_signal_handlers()
            self.tb.flush()
