"""ViT / DeiT backbones (port of ``schemanet_tpu/models/vit.py``).

Token layout matches the JAX package: [cls, patches...] for ViT and
[cls, dist, patches...] for DeiT, with the learnable positional table over the
full sequence. Inputs are NHWC images. The frozen backbone serves only
through ``encode_until``; the classifier heads hold their weights so that the
JAX variables map one to one, and run nowhere.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from .layers import LearnablePosEncoding, PatchEmbed
from .transformer import Transformer


class ViT(nn.Module):
    num_prefix_tokens = 1  # cls

    def __init__(self, num_classes: int, img_size=224, patch_size=16, image_channels=3,
                 embed_dim=192, num_encoder_layers=12, num_heads=3, dim_feedforward=768,
                 activation="gelu", final_norm=True, norm_eps=1e-6, pos_encoding="learnable",
                 dtype=torch.float32):
        super().__init__()
        if pos_encoding != "learnable":
            raise ValueError(f"pos_encoding {pos_encoding!r} is not ported")
        self.embed_dim, self.dtype = embed_dim, dtype
        self.patch_embed = PatchEmbed(img_size, patch_size, image_channels, embed_dim, dtype)
        self.pos_embed = LearnablePosEncoding(
            self.patch_embed.num_patches + self.num_prefix_tokens, embed_dim
        )
        self.transformer = Transformer(num_encoder_layers, num_heads, embed_dim,
                                       dim_feedforward, activation, final_norm, norm_eps)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.cls_head = nn.Linear(embed_dim, num_classes)

    def prefix_tokens(self, bs: int) -> torch.Tensor:
        return self.cls_token.expand(bs, 1, self.embed_dim).to(self.dtype)

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        seq = self.patch_embed(img)
        seq = torch.cat([self.prefix_tokens(seq.shape[0]), seq], dim=1)
        return self.pos_embed(seq)

    def encode_until(
        self, img: torch.Tensor, end_layer: int, capture: Tuple[str, ...] = ()
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Patchify + layers [0, end_layer): the mid feature is the output of
        ``layers_{end_layer-1}``."""
        return self.transformer.run(self.embed(img), capture=capture, end_layer=end_layer)


class DeiT(ViT):
    """Adds a distillation token (and its head's weights)."""

    num_prefix_tokens = 2  # cls + dist

    def __init__(self, num_classes: int, **kwargs):
        super().__init__(num_classes, **kwargs)
        self.dist_token = nn.Parameter(torch.zeros(1, 1, self.embed_dim))
        self.dist_head = nn.Linear(self.embed_dim, num_classes)

    def prefix_tokens(self, bs: int) -> torch.Tensor:
        cls = self.cls_token.expand(bs, 1, self.embed_dim)
        dist = self.dist_token.expand(bs, 1, self.embed_dim)
        return torch.cat([cls, dist], dim=1).to(self.dtype)


def _transformer_kwargs(model_cfg: Dict[str, Any]) -> Dict[str, Any]:
    t = model_cfg["transformer"]
    p = model_cfg.get("patch_embed", {})
    pos = model_cfg.get("pos_encoding", {"name": "learnable"})
    if t.get("dropout"):
        raise ValueError("the port's backbone is the frozen forward: dropout must be off")
    if not t.get("pre_norm", True):
        raise ValueError("post-norm transformers are not ported")
    return dict(
        img_size=p.get("img_size", 224),
        patch_size=p.get("patch_size", 16),
        image_channels=p.get("image_channels", 3),
        embed_dim=t["embed_dim"],
        num_encoder_layers=t.get("num_encoder_layers", 12),
        num_heads=t["num_heads"],
        dim_feedforward=t["dim_feedforward"],
        activation=t.get("activation", "relu"),
        final_norm=t.get("final_norm", True),
        norm_eps=t.get("norm_eps", 1e-5),
        pos_encoding=pos.get("name", "learnable"),
    )


MODEL_REGISTRY = {"vit": ViT, "deit": DeiT}


def get_model(model_cfg: Dict[str, Any], num_classes: int, dtype=torch.float32) -> ViT:
    """Name-dispatch model builder for the ported backbones (vit, deit)."""
    name = model_cfg["name"]
    if name not in MODEL_REGISTRY:
        raise KeyError(f"model {name!r} is not ported (choose from {sorted(MODEL_REGISTRY)})")
    return MODEL_REGISTRY[name](num_classes, dtype=dtype, **_transformer_kwargs(model_cfg))
