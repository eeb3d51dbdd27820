"""Backbone building blocks (port of ``schemanet_tpu/models/layers.py``).

Layouts follow the JAX package at the public surface: images are NHWC
``[bs, H, W, C]`` and sequences batch-major ``[bs, n, dim]``. Parameters are
stored in fp32 and cast to the module's compute dtype at use, like flax's
``dtype``/``param_dtype`` split.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.encoder_block import dense

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": F.gelu,  # exact (erf) gelu, as the JAX registry
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return ACTIVATIONS[name]


def pair(x) -> Tuple[int, int]:
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


class PatchEmbed(nn.Module):
    """Conv patchifier: NHWC image -> tokens [bs, N, dim], row-major (h, w).

    On the card cuDNN runs fp32 convolutions in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False; fp32 comparisons set it."""

    def __init__(self, img_size=224, patch_size=16, image_channels=3, embed_dim=768,
                 dtype=torch.float32):
        super().__init__()
        self.img_size, self.patch_size = pair(img_size), pair(patch_size)
        self.dtype = dtype
        self.proj = nn.Conv2d(image_channels, embed_dim, self.patch_size, self.patch_size)

    @property
    def grid_size(self) -> Tuple[int, int]:
        (ih, iw), (ph, pw) = self.img_size, self.patch_size
        return ih // ph, iw // pw

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        y = F.conv2d(x, self.proj.weight.to(self.dtype), None, self.patch_size)
        y = y + self.proj.bias.to(self.dtype)[None, :, None, None]  # bias after rounding
        return y.flatten(2).transpose(1, 2)  # [bs, gh*gw, dim], row-major (h, w)


class LearnablePosEncoding(nn.Module):
    """Additive learned positional table [1, n, dim]."""

    def __init__(self, num_tokens: int, embed_dim: int):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(1, num_tokens, embed_dim))

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        return seq + self.pos_embed.to(seq.dtype)


class MLP(nn.Module):
    """Transformer FFN: linear1 -> activation -> linear2 (dropout-free)."""

    def __init__(self, embed_dim: int, dim_feedforward: int, activation: str = "relu"):
        super().__init__()
        self.activation = activation
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = get_activation(self.activation)(dense(x, self.linear1.weight, self.linear1.bias))
        return dense(h, self.linear2.weight, self.linear2.bias)
