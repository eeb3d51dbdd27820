"""Graph matcher GNN (port of ``schemanet_tpu/schema/gnn.py``, forward only).

Semantics kept from the JAX package:

* the embedding table has ``num_codes + 1`` rows; the last is the padding row;
* GraphConv: feat <- ((E + E^T)/2 + I) @ feat, then Linear; every GraphConv,
  instance graphs and class graphs alike, runs the ``sym_conv`` kernel on CUDA
  (``ops/kernels/graphconv.py``);
* per layer: conv -> mask-fill padding to 0 -> LayerNorm (eps 1e-6, flax's
  default) -> activation;
* pooling: sum over the vertex axis of feat * vertex_weights divided by the
  pool size (per sample for serving), then the final Linear ``fc``.

The JAX package's TPU workarounds for the embedding backward (one-hot and
banded products, static ids) have no counterpart: serving has no backward, so
the lookup is a plain gather.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.layers import get_activation
from ..ops.kernels import encoder_block as eb
from ..ops.kernels import graphconv as gc

GNN_NORM_EPS = 1e-6  # flax nn.LayerNorm's default, which the JAX GNN uses


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
        feat = self.embedding.to(self.dtype)[ingredients.long()]
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
