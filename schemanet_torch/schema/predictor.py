"""SchemaNet composite predictor (port of ``schemanet_tpu/schema/predictor.py``).

frozen ViT through layer ``encode_layer`` (with the layer's head-mean raw
attention captured) -> VQ of the patch tokens -> dense instance graphs ->
atlas match with the shared GNN -> logits. The backbone and its codebook are
frozen: they run under ``torch.no_grad`` and their parameters do not require
gradients (the JAX package's ``stop_gradient`` and optimizer masking), so
training differentiates the atlas and the GNN only.

Parameter names follow the JAX tree (``ingredient_backbone.backbone``,
``schema_net``, ``matcher.gnn``) so ``models/port.py`` maps one onto the other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch import nn

from ..models.vit import ViT, get_model
from ..ops.graph import graph_dtype
from ..ops.vq import vq_encode
from .atlas import AtlasConfig, SchemaAtlas
from .gnn import Matcher


class IngredientBackbone(nn.Module):
    """Frozen backbone + VQ producing the ingredient interface:

    cls_token [bs, P, d], feat [bs, L, d], feat_origin [bs, L, d],
    ingredients [bs, L], attn [bs, L, L], attn_cls [bs, L]

    ``attn`` is the head-mean of the raw pre-softmax attention at the encode
    layer, emitted in ``attn_dtype`` (the graph dtype)."""

    def __init__(self, backbone: ViT, num_codes: int, code_dim: int, encode_layer: int,
                 attn_dtype=torch.float32):
        super().__init__()
        self.backbone, self.encode_layer, self.attn_dtype = backbone, encode_layer, attn_dtype
        self.vocabulary = nn.Parameter(torch.zeros(num_codes, code_dim))

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        probe = f"layers_{self.encode_layer}.attn_hmean"
        mid_feat, captured = self.backbone.encode_until(
            img, end_layer=self.encode_layer + 1, capture=(probe,)
        )
        n_prefix = self.backbone.num_prefix_tokens
        patches = mid_feat[:, n_prefix:]
        q_patches, ingredients = vq_encode(patches, self.vocabulary)
        attn_mean = captured[probe].to(self.attn_dtype)  # [bs, n, n]
        return {
            "cls_token": mid_feat[:, :n_prefix],
            "feat": q_patches,
            "feat_origin": patches,
            "ingredients": ingredients,
            "attn": attn_mean[:, n_prefix:, n_prefix:],
            "attn_cls": attn_mean[:, 0, n_prefix:],
            "mid_feat": mid_feat,
        }


@dataclasses.dataclass(frozen=True)
class SchemaNetConfig:
    atlas: AtlasConfig
    gnn_embed_dim: int = 256
    gnn_num_layers: int = 2
    gnn_identity_proj: bool = False
    gnn_activation: str = "relu"
    similarity: str = "inner_product"
    # pool instance graphs by the live-slot count (reference semantics) ...
    ref_pooling: bool = True
    # ... of each sample rather than the batch max: batch invariant (serving)
    per_sample_pooling: bool = False


class SchemaNetPredictor(nn.Module):
    """frozen ingredient backbone -> instance graphs -> atlas match -> logits."""

    def __init__(self, backbone: ViT, cfg: SchemaNetConfig, encode_layer: int, num_codes: int,
                 code_dim: int, dtype=torch.float32):
        super().__init__()
        self.cfg, self.num_codes, self.dtype = cfg, num_codes, dtype
        self.ingredient_backbone = IngredientBackbone(
            backbone, num_codes, code_dim, encode_layer,
            attn_dtype=graph_dtype(cfg.atlas.graph_precision),
        )
        self.schema_net = SchemaAtlas(cfg.atlas)
        self.matcher = Matcher(
            cfg.similarity, num_codes, cfg.gnn_embed_dim, cfg.gnn_num_layers,
            cfg.gnn_identity_proj, cfg.gnn_activation, cfg.ref_pooling, cfg.per_sample_pooling,
            dtype,
        )
        self.ingredient_backbone.requires_grad_(False)

    def forward(self, img: torch.Tensor, deterministic: bool = True,
                rng=None) -> Dict[str, torch.Tensor]:
        """Logits and atlas of NHWC images. ``deterministic`` and ``rng`` are
        the trainer's training-forward arguments, which this model takes and
        ignores: its backbone is frozen and runs deterministic whatever its
        ``dropout``, as in the JAX package, and nothing else drops out."""
        with torch.no_grad():
            output = self.ingredient_backbone(img)
        instance = self.schema_net(output["ingredients"], output["attn"], output["attn_cls"])
        atlas = self.schema_net.get_atlas()
        return {"pred": self.matcher(instance, atlas), **atlas}


def build_predictor(
    model_cfg: Dict[str, Any],
    schema_cfg: Dict[str, Any],
    num_classes: int,
    num_codes: int,
    code_dim: int,
    encode_layer: int,
    dtype=torch.float32,
) -> SchemaNetPredictor:
    """Assemble from the same config blocks as the JAX ``build_predictor``.
    Parameters start at zero: load a state dict or call ``init_parameters_``."""
    backbone = get_model(model_cfg, num_classes, dtype=dtype)
    atlas_cfg = AtlasConfig.from_cfg(num_codes, num_classes, schema_cfg.get("ir_atlas", {}))
    gnn_cfg = schema_cfg.get("gnn", {})
    matcher_cfg = schema_cfg.get("matcher", {})
    cfg = SchemaNetConfig(
        atlas=atlas_cfg,
        gnn_embed_dim=gnn_cfg.get("embed_dim", 256),
        gnn_num_layers=gnn_cfg.get("num_layers", 2),
        gnn_identity_proj=gnn_cfg.get("identity_proj", False),
        gnn_activation=gnn_cfg.get("activation", "relu"),
        similarity=matcher_cfg.get("similarity", "inner_product"),
        ref_pooling=matcher_cfg.get("ref_pooling", True),
    )
    return SchemaNetPredictor(backbone, cfg, encode_layer, num_codes, code_dim, dtype)


def _trunc_normal_(t: torch.Tensor, std: float, lo: float, hi: float, g: torch.Generator):
    """Normal(0, std) truncated to [lo*std, hi*std], by redrawing."""
    t.copy_(torch.randn(t.shape, generator=g) * std)
    while True:
        bad = (t < lo * std) | (t > hi * std)
        if not bad.any():
            return t
        t[bad] = torch.randn(int(bad.sum()), generator=g) * std


def _xavier_uniform_(w: torch.Tensor, g: torch.Generator):
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * limit)


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random initialisation of a SchemaNet predictor or a bare
    ViT/DeiT after the JAX package's initialisers (their families and
    scales; not their numbers, since ``torch.Generator`` is not
    ``jax.random``). Parameters are made on the CPU; move the model to its
    device after."""
    g = generator
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("pos_embed.pos_embed"):
            _trunc_normal_(p, 0.02, -2.0, 2.0, g)
        elif leaf in ("cls_token", "dist_token"):
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
        elif name.endswith("patch_embed.proj.weight") or name.endswith("gnn.fc.weight"):
            p.copy_(torch.randn(p.shape, generator=g))
        elif name.endswith(("linear_qkv.weight", "linear_out.weight", "linear1.weight",
                            "linear2.weight", "g_conv.linear.weight")):
            _xavier_uniform_(p, g)
        elif name.endswith(("linear1.bias", "linear2.bias")):
            p.copy_(1e-6 + torch.randn(p.shape, generator=g))
        elif name.endswith("g_conv.linear.bias"):
            p.copy_(torch.randn(p.shape, generator=g))
        elif name.endswith(("cls_head.weight", "dist_head.weight")):
            _trunc_normal_(p, 1.0 / math.sqrt(p.shape[1]) / 0.87962566, -2.0, 2.0, g)
        elif name.endswith("vocabulary"):
            p.copy_(torch.rand(p.shape, generator=g) * 2 - 1)
        elif leaf in ("vertex_weights", "edge_weights"):
            x = torch.clamp(0.5 + _trunc_normal_(torch.empty(p.shape), 1 / 6, -3.0, 3.0, g), 0, 1)
            s = x.sum(dim=-1, keepdim=True)
            p.copy_(torch.where(s > 0, x / s, x))
        elif leaf == "embedding":
            _trunc_normal_(p, 1.0, -2.0, 2.0, g)
            p[-1] = 0.0  # padding row
        elif leaf == "weight" and p.ndim == 1:  # LayerNorm scales
            p.fill_(1.0)
        elif leaf == "bias":  # attention, conv, fc and LayerNorm biases
            p.zero_()
        elif not leaf.endswith("attribute_weights"):  # those keep their construction value
            raise KeyError(f"no initialiser for parameter {name}")
    return model
