"""Evaluation loops (port of ``schemanet_tpu/train/evaluator.py``; the
reference's ``schema_inference/eval/evaluation.py``).

* ``Evaluation``: loss and top-k accuracy over a loader;
* ``IncEvaluation``: per-task and overall accuracy of a model whose classes
  are split into tasks (the reference's ``eval/inc_evaluation.py``);
* ``CBEvaluation``: the codebook agreement of the frozen backbone, run twice
  a batch with its mid feature quantised and not: ``acc`` (quantised
  correct), ``acc_model`` (quantised prediction == original prediction),
  ``acc_origin`` (original correct).

Each moves the loader's batches to the device ahead of use
(``device_prefetch``), resizes and normalises uint8 images there
(``prepare_images``), runs without autograd, masks padded rows with the
batch's ``valid`` and keeps its sums on the device: the host reads them
once an evaluation. On a grid (``mesh``; every rank calls the evaluation)
the sums are added over its data group only: the ranks of a model group
hold the same data slice, so a sum over every rank would count each sample
``model`` times. ``Evaluation``'s ``n`` is the count of samples
evaluated.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..data.loader import device_prefetch, prepare_images
from ..device import resolve_device
from ..parallel.mesh import Mesh, all_reduce_
from ..schema.loss import weighted_total


def _logits(out) -> torch.Tensor:
    pred = out["pred"]
    return pred["pred"] if isinstance(pred, dict) else pred


def _valid(batch, rows: int, device) -> torch.Tensor:
    valid = batch.get("valid")
    return torch.ones(rows, device=device) if valid is None else valid.float()


def _fetch(sums: torch.Tensor, mesh: Optional[Mesh] = None) -> list:
    """The one host read of an evaluation, summed first over the grid's
    data group."""
    if mesh is not None:
        all_reduce_(sums, mesh.data_group)
    return sums.double().tolist()


class Evaluation:
    """``apply_fn(image) -> output`` (a dict with ``pred``) over
    ``val_loader``: ``{"loss", "loss_dict", "acc": {k: fraction}, "n"}``, each
    the mean over the valid rows (a batch's loss weighted by its valid
    count), ``n`` their count."""

    def __init__(self, apply_fn: Callable, loss_fn: Callable, loss_weights: Dict[str, float],
                 val_loader, top_k: Sequence[int] = (1,), device=None,
                 mesh: Optional[Mesh] = None):
        self.apply_fn, self.loss_fn, self.mesh = apply_fn, loss_fn, mesh
        self.loss_weights = dict(loss_weights)
        self.val_loader, self.top_k = val_loader, tuple(top_k)
        self.device = resolve_device(device)

    def _batch_sums(self, batch: Dict[str, torch.Tensor]):
        """(loss-dict keys, [n, loss * n, acc counts..., loss terms * n]) of
        one batch, on the device."""
        out = self.apply_fn(prepare_images(self.val_loader, batch["image"], batch.get("crop")))
        label = batch["label"]
        loss_dict = self.loss_fn(out, {"label": label})
        total = weighted_total(loss_dict, self.loss_weights)
        pred = _logits(out)
        valid = _valid(batch, pred.shape[0], pred.device)
        max_k = min(max(self.top_k), pred.shape[-1])
        correct = (torch.topk(pred, max_k, dim=-1).indices == label[:, None].long()).float()
        counts = [(correct[:, : min(k, max_k)].amax(dim=1) * valid).sum() for k in self.top_k]
        n = valid.sum()
        row = [n, total * n, *counts, *(v.float() * n for v in loss_dict.values())]
        return list(loss_dict), torch.stack([r.float() for r in row])

    @torch.no_grad()
    def __call__(self) -> Dict[str, Any]:
        keys, sums = [], None
        for batch in device_prefetch(iter(self.val_loader), self.device):
            keys, row = self._batch_sums(batch)
            sums = row if sums is None else sums + row
        if sums is None:
            return {"loss": 0.0, "loss_dict": {}, "acc": {k: 0.0 for k in self.top_k}, "n": 0}
        n, loss, *rest = _fetch(sums, self.mesh)
        counts, terms = rest[: len(self.top_k)], rest[len(self.top_k):]
        count, n = int(n), max(n, 1.0)
        return {
            "loss": loss / n,
            "loss_dict": {k: v / n for k, v in zip(keys, terms)},
            "acc": {k: c / n for k, c in zip(self.top_k, counts)},
            "n": count,
        }


class IncEvaluation:
    """``apply_fn(image, task) -> output`` over one loader per task; task t
    covers the contiguous labels of ``classes_per_task[t]``. Returns
    ``{"per_task": {t: {"acc_task", "acc_all"}}, "acc"}``: accuracy within
    the task's slice of the head (labels offset into it) and over the whole
    head, and the overall accuracy."""

    def __init__(self, apply_fn: Callable, val_loaders, classes_per_task, device=None,
                 mesh: Optional[Mesh] = None):
        self.apply_fn, self.mesh = apply_fn, mesh
        self.val_loaders = list(val_loaders)
        self.offsets = [0]
        for n in classes_per_task:
            self.offsets.append(self.offsets[-1] + int(n))
        self.device = resolve_device(device)

    @torch.no_grad()
    def __call__(self) -> Dict[str, Any]:
        per_task, total_correct, total_n = {}, 0.0, 0.0
        for task, loader in enumerate(self.val_loaders):
            lo, hi = self.offsets[task], self.offsets[task + 1]
            sums = torch.zeros(3, device=self.device)
            for batch in device_prefetch(iter(loader), self.device):
                image = prepare_images(loader, batch["image"], batch.get("crop"))
                pred = _logits(self.apply_fn(image, task))
                label = batch["label"].long()
                valid = _valid(batch, pred.shape[0], pred.device)
                task_ok = (pred[:, lo:hi].argmax(dim=1) == label - lo).float()
                all_ok = (pred.argmax(dim=1) == label).float()
                sums += torch.stack([(task_ok * valid).sum(), (all_ok * valid).sum(),
                                     valid.sum()])
            t_correct, a_correct, n = _fetch(sums, self.mesh)
            per_task[task] = {"acc_task": t_correct / max(n, 1.0),
                              "acc_all": a_correct / max(n, 1.0)}
            total_correct += a_correct
            total_n += n
        return {"per_task": per_task, "acc": total_correct / max(total_n, 1.0)}


class CBEvaluation:
    """``classify_fn(image, quantize) -> logits`` over ``val_loader``:
    ``{"acc", "acc_model", "acc_origin"}`` fractions of the valid rows."""

    KEYS = ("acc", "acc_model", "acc_origin")

    def __init__(self, classify_fn: Callable, val_loader, device=None,
                 mesh: Optional[Mesh] = None):
        self.classify_fn, self.val_loader, self.mesh = classify_fn, val_loader, mesh
        self.device = resolve_device(device)

    def _batch_sums(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[acc, acc_model, acc_origin, n] counts of one batch, on the device."""
        image = prepare_images(self.val_loader, batch["image"], batch.get("crop"))
        pred_q = self.classify_fn(image, True).argmax(dim=1)
        pred_o = self.classify_fn(image, False).argmax(dim=1)
        gt = batch["label"].long()
        valid = _valid(batch, pred_q.shape[0], pred_q.device)
        return torch.stack([((pred_q == gt) * valid).sum(), ((pred_q == pred_o) * valid).sum(),
                            ((pred_o == gt) * valid).sum(), valid.sum()])

    @torch.no_grad()
    def __call__(self) -> Dict[str, float]:
        sums = torch.zeros(4, device=self.device)
        for batch in device_prefetch(iter(self.val_loader), self.device):
            sums += self._batch_sums(batch)
        *counts, n = _fetch(sums, self.mesh)
        return {k: c / max(n, 1.0) for k, c in zip(self.KEYS, counts)}
