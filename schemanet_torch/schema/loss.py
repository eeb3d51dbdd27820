"""Losses (port of ``schemanet_tpu/schema/loss.py``).

A loss function maps the predictor's output dict and a target dict to an
ordered dict of named scalar terms; ``weighted_total`` applies ``weight_dict``
by key prefix and sums. Terms absent from ``weight_dict`` (the raw
``entropy_vertex`` and ``entropy_edge``) are reported but not trained on.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy of fp32 logits against integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


def entropy(p: torch.Tensor, eps: float = 1e-7, dim: int = -1) -> torch.Tensor:
    """-(p * log(p + eps)).sum(dim)."""
    return -(p * torch.log(p + eps)).sum(dim=dim)


def rectify_linear(x: torch.Tensor, a: float = 0.0) -> torch.Tensor:
    """x if x > a else a - 1 + 1/(1 + a - x): a soft hinge that keeps a
    gradient below the target entropy a."""
    return torch.where(x > a, x, a - 1.0 + 1.0 / (1.0 + a - x))


def _logits(output: Dict[str, Any]) -> torch.Tensor:
    pred = output["pred"]
    return pred["pred"] if isinstance(pred, dict) else pred


def ce_loss(**kwargs) -> Callable:
    def loss_fn(output, target):
        return {"cls": cross_entropy(_logits(output), target["label"])}

    return loss_fn


def schema_inference_loss(re_a_vertex: float = 3.0, re_a_edge: float = 3.0, **kwargs) -> Callable:
    """Cross entropy plus the rectified-entropy sparsity terms of the atlas:

    entropy_vertex = max over classes of the vertex-row entropy;
    entropy_edge   = mean over classes of the max over rows of the edge-row
    entropy. Both run in fp32 whatever the getters emit. A max over ties
    spreads its gradient evenly (``amax``), as ``jnp.max`` does. Where the
    output holds a rank's classes of a grid, its ``class_gather`` makes the
    per-class entropies whole first."""

    def loss_fn(output, target):
        ret = {"cls": cross_entropy(_logits(output), target["label"])}
        per_vertex = entropy(output["class_vertices"].float())  # [K]
        per_edge = entropy(output["class_edges"].float()).amax(dim=1)  # [K]
        gather = output.get("class_gather")
        if gather is not None:
            per_vertex, per_edge = gather(torch.stack([per_vertex, per_edge], dim=1)).unbind(1)
        entropy_vertex = per_vertex.amax(dim=0)
        entropy_edge = per_edge.mean()
        ret["entropy_vertex"] = entropy_vertex
        ret["entropy_edge"] = entropy_edge
        ret["re_entropy_vertex"] = rectify_linear(entropy_vertex, a=re_a_vertex)
        ret["re_entropy_edge"] = rectify_linear(entropy_edge, a=re_a_edge)
        return ret

    return loss_fn


def distill_kl(T: float = 4.0, **kwargs) -> Callable:
    """KL distillation (the reference's ``base_loss.py:37-48``): T^2 times the
    batch mean of KL(softmax(teacher / T) || softmax(student / T)), the
    teacher's logits in ``target["teacher_pred"]``; fp32."""

    def loss_fn(output, target):
        p_s = F.log_softmax(_logits(output).float() / T, dim=1)
        p_t = F.softmax(target["teacher_pred"].float() / T, dim=1)
        kl = (p_t * (torch.log(torch.clamp(p_t, min=1e-12)) - p_s)).sum(dim=1).mean()
        return {"kl": kl * T**2}

    return loss_fn


LOSSES = {"ce_loss": ce_loss, "schema_inference_loss": schema_inference_loss,
          "distill_kl": distill_kl}


def get_loss_fn(loss_cfg: Dict[str, Any], **kwargs) -> Callable:
    """The loss named by ``loss_cfg['name']``, built with ``loss_cfg['loss_cfg']``."""
    name = loss_cfg["name"]
    if name not in LOSSES:
        raise KeyError(f"loss {name!r} is not ported (choose from {sorted(LOSSES)})")
    return LOSSES[name](**(loss_cfg.get("loss_cfg") or {}), **kwargs)


def weighted_total(loss_dict: Dict[str, torch.Tensor], weight_dict: Dict[str, float]):
    """Sum of the terms whose key prefix (before the first '.') is weighted."""
    total = 0.0
    for k, v in loss_dict.items():
        prefix = k.split(".")[0]
        if prefix in weight_dict:
            total = total + v * weight_dict[prefix]
    return total
