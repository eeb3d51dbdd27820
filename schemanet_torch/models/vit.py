"""ViT / DeiT backbones (port of ``schemanet_tpu/models/vit.py``).

Token layout matches the JAX package: [cls, patches...] for ViT and
[cls, dist, patches...] for DeiT, with the learnable positional table over the
full sequence. Inputs are NHWC images. The frozen SchemaNet backbone runs
``encode_until`` (deterministic); ``forward`` is the classifier that stage 0
fine-tunes, with ``deterministic=False`` for the training forward (dropout on
the positional encoding, the residuals and inside the fused kernels, drawn
from the caller's ``DropoutRNG``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.kernels.encoder_block import dense
from .layers import DropoutRNG, LearnablePosEncoding, PatchEmbed
from .transformer import Transformer


class ViT(nn.Module):
    num_prefix_tokens = 1  # cls

    def __init__(self, num_classes: int, img_size=224, patch_size=16, image_channels=3,
                 embed_dim=192, num_encoder_layers=12, num_heads=3, dim_feedforward=768,
                 activation="gelu", final_norm=True, norm_eps=1e-6, pos_encoding="learnable",
                 dropout: Optional[float] = None, dtype=torch.float32):
        super().__init__()
        if pos_encoding != "learnable":
            raise ValueError(f"pos_encoding {pos_encoding!r} is not ported")
        self.embed_dim, self.dtype = embed_dim, dtype
        self.patch_embed = PatchEmbed(img_size, patch_size, image_channels, embed_dim, dtype)
        # the transformer's dropout, as the JAX ViT passes it (pos_encoding's
        # own ``dropout`` key is read nowhere there)
        self.pos_embed = LearnablePosEncoding(
            self.patch_embed.num_patches + self.num_prefix_tokens, embed_dim, dropout
        )
        self.transformer = Transformer(num_encoder_layers, num_heads, embed_dim,
                                       dim_feedforward, activation, final_norm, norm_eps, dropout)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.cls_head = nn.Linear(embed_dim, num_classes)

    def prefix_tokens(self, bs: int) -> torch.Tensor:
        return self.cls_token.expand(bs, 1, self.embed_dim).to(self.dtype)

    def embed(self, img: torch.Tensor, deterministic: bool = True,
              rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        seq = self.patch_embed(img)
        seq = torch.cat([self.prefix_tokens(seq.shape[0]), seq], dim=1)
        return self.pos_embed(seq, deterministic, rng)

    def head(self, seq: torch.Tensor, deterministic: bool = True) -> Dict[str, torch.Tensor]:
        return {"pred": dense(seq[:, 0], self.cls_head.weight, self.cls_head.bias)}

    def forward(self, img: torch.Tensor, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        """Classify NHWC images: ``{"pred": logits [bs, num_classes]}``.
        ``deterministic=False`` is the training forward; with dropout it
        needs ``rng``."""
        seq, _ = self.transformer.run(self.embed(img, deterministic, rng),
                                      deterministic=deterministic, rng=rng)
        return self.head(seq, deterministic)

    def encode_until(
        self, img: torch.Tensor, end_layer: int, capture: Tuple[str, ...] = ()
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Patchify + layers [0, end_layer): the mid feature is the output of
        ``layers_{end_layer-1}``."""
        return self.transformer.run(self.embed(img), capture=capture, end_layer=end_layer)


class DeiT(ViT):
    """Adds a distillation token and its head: training forwards return both
    heads' logits (``pred``, ``dist``), deterministic ones their mean."""

    num_prefix_tokens = 2  # cls + dist

    def __init__(self, num_classes: int, **kwargs):
        super().__init__(num_classes, **kwargs)
        self.dist_token = nn.Parameter(torch.zeros(1, 1, self.embed_dim))
        self.dist_head = nn.Linear(self.embed_dim, num_classes)

    def prefix_tokens(self, bs: int) -> torch.Tensor:
        cls = self.cls_token.expand(bs, 1, self.embed_dim)
        dist = self.dist_token.expand(bs, 1, self.embed_dim)
        return torch.cat([cls, dist], dim=1).to(self.dtype)

    def head(self, seq: torch.Tensor, deterministic: bool = True) -> Dict[str, torch.Tensor]:
        prob = dense(seq[:, 0], self.cls_head.weight, self.cls_head.bias)
        dist = dense(seq[:, 1], self.dist_head.weight, self.dist_head.bias)
        if deterministic:
            return {"pred": (prob + dist) / 2}
        return {"pred": prob, "dist": dist}


def _transformer_kwargs(model_cfg: Dict[str, Any]) -> Dict[str, Any]:
    t = model_cfg["transformer"]
    p = model_cfg.get("patch_embed", {})
    pos = model_cfg.get("pos_encoding", {"name": "learnable"})
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
        dropout=t.get("dropout"),
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
