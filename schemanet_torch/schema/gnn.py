"""Graph matcher GNN (port of ``schemanet_tpu/schema/gnn.py``).

Semantics kept from the JAX package:

* the embedding table has ``num_codes + 1`` rows; the last is the padding row;
* GraphConv: feat <- ((E + E^T)/2 + I) @ feat, then Linear; every GraphConv,
  instance graphs and class graphs alike, runs the ``sym_conv`` kernel on CUDA
  (``ops/kernels/graphconv.py``);
* per layer: conv -> mask-fill padding to 0 -> LayerNorm (eps 1e-6, flax's
  default) -> activation;
* pooling: sum over the vertex axis of feat * vertex_weights divided by the
  pool size (per sample for serving, the batch max for training), then the
  final Linear ``fc``;
* the embedding lookup is ``embed_lookup``: a gather forward, and a backward
  that sums the cotangent rows of duplicate ids in fp32 (the ``embed_grad``
  kernel on CUDA) and rounds once to the cotangent's dtype, as the JAX
  ``_embed_lookup_bwd`` returns ``gt.astype(g.dtype)``. The instance graphs and
  the class graphs take the same function.

Not ported, being TPU workarounds with the same semantics as the fp32 sum:
the JAX package's one-hot and banded-product backward routes and its
``StaticIds`` trace-time class ids; nor ``remat_class_gnn``, which trades
recompute for TPU memory.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.layers import get_activation
from ..ops.kernels import embed_bwd as ek
from ..ops.kernels import encoder_block as eb
from ..ops.kernels import graphconv as gc

GNN_NORM_EPS = 1e-6  # flax nn.LayerNorm's default, which the JAX GNN uses


class _EmbedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return ek.embed_grad(ids, g.contiguous(), ctx.num_rows).to(g.dtype), None


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` ([M+1, D], int32 [...] -> [..., D]) whose backward
    accumulates duplicate ids in fp32 and rounds once to the cotangent dtype."""
    return _EmbedLookup.apply(table, ids.int().contiguous())


class GraphConv(nn.Module):
    def __init__(self, embed_dim: int, identity_proj: bool = False):
        super().__init__()
        self.linear = None if identity_proj else nn.Linear(embed_dim, embed_dim)

    def forward(self, edges: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        feat = gc.sym_conv(edges.to(feat.dtype).contiguous(), feat.contiguous())
        if self.linear is None:
            return feat
        return eb.dense(feat, self.linear.weight, self.linear.bias)


class GNNLayer(nn.Module):
    def __init__(self, embed_dim: int, activation: str = "relu", identity_proj: bool = False):
        super().__init__()
        self.activation = activation
        self.g_conv = GraphConv(embed_dim, identity_proj)
        self.norm = nn.LayerNorm(embed_dim, eps=GNN_NORM_EPS)

    def forward(self, edges, feat, feat_mask: Optional[torch.Tensor] = None):
        feat = self.g_conv(edges, feat)
        if feat_mask is not None:
            feat = torch.where(feat_mask[..., None], torch.zeros_like(feat), feat)
        feat = eb.layer_norm(feat, self.norm.weight, self.norm.bias, GNN_NORM_EPS)
        return get_activation(self.activation)(feat)


class GNN(nn.Module):
    """Shared graph embedder for instance graphs and the class atlas."""

    def __init__(self, num_codes: int, embed_dim: int, num_layers: int,
                 identity_proj: bool = False, activation: str = "relu", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(num_codes + 1, embed_dim))
        self.layers = nn.ModuleList(
            GNNLayer(embed_dim, activation, identity_proj) for _ in range(num_layers)
        )
        self.fc = nn.Linear(embed_dim, embed_dim)

    def forward(
        self,
        nodes: torch.Tensor,  # [bs, n] vertex weights
        edges: torch.Tensor,  # [bs, n, n]
        ingredients: torch.Tensor,  # [bs, n] code ids (num_codes = padding)
        feat_mask: Optional[torch.Tensor] = None,  # [bs, n] True = padding
        pool_size: Optional[torch.Tensor] = None,  # [bs] or scalar denominator
    ) -> torch.Tensor:
        # cast the table, not the gathered rows, so the backward's fp32 sum
        # rounds once to the compute dtype (a no-op in fp32)
        feat = embed_lookup(self.embedding.to(self.dtype), ingredients)
        for layer in self.layers:
            feat = layer(edges, feat, feat_mask)
        feat = feat * nodes[..., None].to(feat.dtype)
        if pool_size is None:
            denom = torch.tensor(feat.shape[1], dtype=feat.dtype, device=feat.device)
        else:
            denom = pool_size.to(feat.dtype)
        feat = feat.sum(dim=1) / (denom[..., None] if denom.ndim else denom)
        return eb.dense(feat, self.fc.weight, self.fc.bias)


def similarity_fn(name: str):
    """The matcher's similarity registry."""

    def cosine(a, b):
        num = (a * b).sum(dim=-1)
        den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)
        return (num / torch.clamp(den, min=1e-12) + 1) / 2

    def euclidean(a, b):
        return 1.0 / (1.0 + torch.linalg.norm(a - b, dim=-1))

    def inner_product(a, b):
        return (a * b).sum(dim=-1)

    return {"cosine": cosine, "euclidean": euclidean, "inner_product": inner_product}[name]


class Matcher(nn.Module):
    """Embeds the instance graphs and the K class graphs with one shared GNN;
    logits[b, k] = similarity(instance_b, class_k)."""

    def __init__(self, similarity: str, num_codes: int, embed_dim: int, num_layers: int,
                 identity_proj: bool = False, activation: str = "relu", ref_pooling: bool = True,
                 per_sample_pooling: bool = False, dtype=torch.float32):
        super().__init__()
        self.similarity = similarity
        self.ref_pooling, self.per_sample_pooling = ref_pooling, per_sample_pooling
        self.gnn = GNN(num_codes, embed_dim, num_layers, identity_proj, activation, dtype)

    def forward(self, instance: dict, atlas: dict) -> torch.Tensor:
        pool_size = None
        if self.ref_pooling and instance.get("num_slots") is not None:
            slots = torch.clamp(instance["num_slots"], min=1)
            # per-sample: each sample's own live-slot count (batch invariant);
            # otherwise the batch max, the reference's training semantics
            pool_size = slots if self.per_sample_pooling else slots.max()
        feat_instance = self.gnn(
            instance["instance_vertices"], instance["instance_edges"],
            instance["instance_ingredients"], instance.get("feat_mask"), pool_size,
        )  # [bs, D]
        feat_kg = self.gnn(
            atlas["class_vertices"], atlas["class_edges"], atlas["class_ingredients"]
        )  # [K, D]
        return similarity_fn(self.similarity)(feat_instance[:, None, :], feat_kg[None, :, :])
