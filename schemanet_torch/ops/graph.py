"""Dense, fixed-shape IR-Graph building (port of ``schemanet_tpu/ops/graph.py``).

The reference builds ragged per-sample ``{code -> positions}`` maps in C++;
here each sample is compacted into ``L`` static slots holding its distinct
codes in ascending order (the C++ ``std::map`` iteration order), and the
all-pairs edge sums are the batched product ``P^T A P`` with the one-hot
position->slot projection ``P``. That product is a plain batched matmul, as
the JAX package leaves it to XLA.

Atlas initialisation (stage 3) takes two more functions: the full-vocabulary
vertex weights of a sample (``feat_to_full_vertices``) and the edges of a
sample restricted to its class's vertex set (``class_limited_edges``).

Precision modes: ``'highest'`` keeps every tensor fp32; ``'default'`` stores
graph tensors in bf16. The one-hot operands are exact in bf16 and every
contraction accumulates in fp32, so only attention and geometry round.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .normalize import normalize_max, normalize_sum, safe_softmax, zero_nans


def graph_dtype(precision: str) -> torch.dtype:
    """Storage dtype of graph tensors: bf16 under 'default', fp32 under 'highest'."""
    return torch.bfloat16 if precision == "default" else torch.float32


def clamp_softmax(attn: torch.Tensor, clamp: Optional[float], dim: int = -1) -> torch.Tensor:
    """Optional threshold-to--inf then softmax; logits below ``clamp`` are masked."""
    if clamp is not None:
        attn = torch.where(attn < clamp, torch.full_like(attn, float("-inf")), attn)
    return safe_softmax(attn, dim=dim)


class InstanceSlots(NamedTuple):
    """Per-sample compaction of up-to-L distinct codes into L static slots."""

    codes: torch.Tensor  # [bs, L] int32: ascending distinct codes, padded with num_codes
    pos_to_slot: torch.Tensor  # [bs, L] int64: slot index of each sequence position
    num_slots: torch.Tensor  # [bs] int32: number of distinct codes per sample
    mask: torch.Tensor  # [bs, L] bool: True for live slots


def compact_instance_slots(ingredients: torch.Tensor, num_codes: int) -> InstanceSlots:
    """Sorted-unique compaction with a fixed L-slot layout.

    Slot s holds the s-th smallest distinct code of the sample (stable sort,
    then a cumulative count of new values)."""
    bs, L = ingredients.shape
    sorted_codes, order = torch.sort(ingredients.long(), dim=1, stable=True)
    is_new = torch.ones_like(sorted_codes, dtype=torch.bool)
    is_new[:, 1:] = sorted_codes[:, 1:] != sorted_codes[:, :-1]
    slot_of_sorted = torch.cumsum(is_new.long(), dim=1) - 1  # [bs, L]
    num_slots = slot_of_sorted[:, -1] + 1
    pos_to_slot = torch.empty_like(slot_of_sorted).scatter_(1, order, slot_of_sorted)
    # every sorted position of slot s carries the same code, so the writes agree
    codes = torch.empty_like(sorted_codes).scatter_(1, slot_of_sorted, sorted_codes)
    mask = torch.arange(L, device=ingredients.device)[None, :] < num_slots[:, None]
    codes = torch.where(mask, codes, torch.full_like(codes, num_codes))
    return InstanceSlots(codes.int(), pos_to_slot, num_slots.int(), mask)


def _blend(attrs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """einsum('...a,ao->...') of a 2-attribute tensor with the [2, 1] weights."""
    return attrs @ weights.to(attrs.dtype)[:, 0]


def instance_vertices(
    slots: InstanceSlots,
    attn_cls: torch.Tensor,  # [bs, L] raw CLS attention
    vertex_attribute_weights: torch.Tensor,  # [2, 1]
    clamp_vertex_attn: Optional[float] = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Slot-space vertex weights [bs, L] in the graph dtype.

    Per sample: (count, mean attention) per live slot, each attribute divided
    by its max over slots, blended by W_v; padding slots are 0."""
    L = slots.pos_to_slot.shape[1]
    dt = graph_dtype(precision)
    attn_cls = zero_nans(clamp_softmax(attn_cls.float(), clamp_vertex_attn))
    proj = F.one_hot(slots.pos_to_slot, L).float()  # [bs, L, S], exact in any dtype
    count = proj.sum(dim=1)
    attn_sum = torch.einsum("bls,bl->bs", proj, attn_cls.to(dt).float())
    attn_val = attn_sum / torch.clamp(count, min=1.0)
    attrs = normalize_max(torch.stack([count, attn_val], dim=-1), dim=1)  # [bs, S, 2]
    w = _blend(attrs, vertex_attribute_weights)
    return torch.where(slots.mask, w, torch.zeros_like(w)).to(dt)


def _pair_mean_edges(
    proj: torch.Tensor,  # [bs, L, S] one-hot position->slot projection, fp32
    attn: torch.Tensor,  # [bs, L, L] softmaxed attention, fp32
    geo_sim: torch.Tensor,  # [L, L] fp32
    precision: str,
) -> torch.Tensor:
    """Mean over position pairs of (geo, attn) per slot pair: [bs, S, S, 2] in
    the graph dtype. Operands round to the graph dtype, products accumulate in
    fp32 (``P^T A P`` as batched matmuls)."""
    dt = graph_dtype(precision)
    pt = proj.transpose(1, 2)
    attn_e = pt @ attn.to(dt).float() @ proj
    geo_e = pt @ geo_sim.to(dt).float() @ proj
    counts = proj.sum(dim=1)  # [bs, S]
    pairs = counts[:, :, None] * counts[:, None, :]
    denom = torch.clamp(pairs, min=1.0)
    live = pairs > 0
    zero = torch.zeros_like(attn_e)
    attn_e = torch.where(live, attn_e / denom, zero)
    geo_e = torch.where(live, geo_e / denom, zero)
    return torch.stack([geo_e, attn_e], dim=-1).to(dt)


def instance_edges(
    slots: InstanceSlots,
    attn: torch.Tensor,  # [bs, L, L] raw attention
    geo_sim: torch.Tensor,  # [L, L]
    edge_attribute_weights: torch.Tensor,  # [2, 1]
    clamp_edge_attn: Optional[float] = None,
    remove_self_loop: bool = False,
    precision: str = "highest",
) -> torch.Tensor:
    """Slot-space instance adjacency [bs, L, L] in the graph dtype.

    Row-normalised over the second slot axis, optional zero diagonal, blended
    by W_e. Padding rows and columns are exactly zero."""
    L = slots.pos_to_slot.shape[1]
    dt = graph_dtype(precision)
    attn = zero_nans(clamp_softmax(attn.float(), clamp_edge_attn))
    proj = F.one_hot(slots.pos_to_slot, L).float()
    edges = normalize_sum(_pair_mean_edges(proj, attn, geo_sim.float(), precision), dim=2)
    if remove_self_loop:
        eye = torch.eye(L, dtype=torch.bool, device=edges.device)[None, :, :, None]
        edges = torch.where(eye, torch.zeros_like(edges), edges)
    out = _blend(edges, edge_attribute_weights)
    live = slots.mask[:, :, None] & slots.mask[:, None, :]
    return torch.where(live, out, torch.zeros_like(out)).to(dt)


def vertex_attributes_full(
    ingredients: torch.Tensor,  # [bs, L] int
    attn_cls: torch.Tensor,  # [bs, L] softmaxed CLS attention
    num_vertices: int,
) -> torch.Tensor:
    """Per-code (count, mean attention) attributes, dense [bs, V, 2] fp32;
    codes absent from a sample get (0, 0). A code whose positions
    carried NaN attention keeps a NaN attention attribute, as the reference's
    scatter does (a one-hot product would otherwise spread the NaN to every
    code)."""
    onehot = F.one_hot(ingredients.long(), num_vertices).float()  # [bs, L, V]
    count = onehot.sum(dim=1)
    attn_f = attn_cls.float()
    nan_in = torch.isnan(attn_f)
    attn_sum = torch.einsum("blv,bl->bv", onehot, torch.where(nan_in, torch.zeros_like(attn_f),
                                                               attn_f))
    nan_hit = torch.einsum("blv,bl->bv", onehot, nan_in.float()) > 0
    attn_sum = torch.where(nan_hit, torch.full_like(attn_sum, float("nan")), attn_sum)
    attn_val = torch.where(count > 0, attn_sum / torch.clamp(count, min=1.0),
                           torch.zeros_like(attn_sum))
    attn_val = torch.where(torch.isnan(attn_sum), attn_sum, attn_val)
    return torch.stack([count, attn_val], dim=-1)


def feat_to_full_vertices(
    ingredients: torch.Tensor,  # [bs, L] int
    attn_cls: torch.Tensor,  # [bs, L] raw (pre-softmax) CLS attention
    num_vertices: int,
    vertex_attribute_weights: torch.Tensor,  # [2, 1]
    clamp_vertex_attn: Optional[float] = None,
) -> torch.Tensor:
    """[bs, V] vertex weights over the full vocabulary: the max-normalised
    (count, mean attention) attributes of each sample, blended by W_v."""
    attn_cls = clamp_softmax(attn_cls, clamp_vertex_attn)
    attrs = normalize_max(vertex_attributes_full(ingredients, attn_cls, num_vertices), dim=1)
    return _blend(attrs, vertex_attribute_weights)


def class_limited_edges(
    ingredients: torch.Tensor,  # [bs, L] int
    attn: torch.Tensor,  # [bs, L, L] raw attention
    geo_sim: torch.Tensor,  # [L, L]
    labels: torch.Tensor,  # [bs] int
    class_ingredients: torch.Tensor,  # [K, V_max] global code id per class slot
    edge_attribute_weights: torch.Tensor,  # [2, 1]
    clamp_edge_attn: Optional[float] = None,
    remove_self_loop: bool = False,
    precision: str = "highest",
) -> torch.Tensor:
    """[bs, V_max, V_max] edges of each sample over its label's vertex set:
    position l maps to slot s iff its code is the class's s-th ingredient;
    the pair means are row-normalised over the second slot axis, the
    diagonal optionally zeroed, and blended by W_e. As in the JAX package the
    softmaxed attention keeps its NaNs (an all-masked row)."""
    attn = clamp_softmax(attn.float(), clamp_edge_attn)
    my_codes = class_ingredients[labels.long()].long()  # [bs, V_max]
    proj = (ingredients.long()[:, :, None] == my_codes[:, None, :]).float()  # [bs, L, V_max]
    edges = normalize_sum(_pair_mean_edges(proj, attn, geo_sim.float(), precision), dim=2)
    if remove_self_loop:
        eye = torch.eye(edges.shape[1], dtype=torch.bool, device=edges.device)[None, :, :, None]
        edges = torch.where(eye, torch.zeros_like(edges), edges)
    return _blend(edges, edge_attribute_weights).to(graph_dtype(precision))
