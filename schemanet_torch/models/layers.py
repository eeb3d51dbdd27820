"""Backbone building blocks (port of ``schemanet_tpu/models/layers.py``).

Layouts follow the JAX package at the public surface: images are NHWC
``[bs, H, W, C]`` and sequences batch-major ``[bs, n, dim]``. Parameters are
stored in fp32 and cast to the module's compute dtype at use, like flax's
``dtype``/``param_dtype`` split.

Dropout takes its randomness from a ``DropoutRNG`` that the caller owns and
passes in (the counterpart of flax's ``make_rng("dropout")``): nothing here
reads PyTorch's global generator. On a data-parallel grid the generator
is the same on every rank and ``DropoutRNG.rows`` says which rows of the
global batch this rank holds: masks are drawn for the global batch and each
rank takes its rows, so the grid drops what one process would.

Weights held as shards on a grid's model axis (``parallel/mesh.py``) are
gathered (``gathered``) before each use.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import policy
from ..ops.kernels import mlp as mk
from ..ops.kernels.dropmask import SEED_HIGH
from ..ops.kernels.encoder_block import dense
from ..ops.quant import int8_dense
from ..parallel.mesh import gathered

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": F.gelu,  # exact (erf) gelu, as the JAX registry
    "glu": F.glu,  # first half times the sigmoid of the second, on the last axis
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": lambda x: F.relu6(x + 3.0) / 6.0,  # flax's relu6(x + 3) / 6
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


@dataclasses.dataclass
class DropoutRNG:
    """The randomness of training forwards: the int32 seeds of the in-kernel
    dropout masks, drawn on the host from ``seeds`` (a CPU generator, so no
    layer waits for the device), and the residual and positional masks,
    drawn on the activations' device from ``masks``."""

    seeds: torch.Generator
    masks: torch.Generator
    # (first item, items of the global batch) of a data-parallel rank's
    # slice; None: the batch is the global one
    rows: Optional[Tuple[int, int]] = None

    @property
    def item0(self) -> int:
        return 0 if self.rows is None else self.rows[0]

    def kernel_seed(self) -> int:
        """A seed in [0, 2^31 - 1), as the JAX package draws one per kernel call."""
        return int(torch.randint(0, SEED_HIGH, (), generator=self.seeds))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep with probability 1 - rate, kept values
    divided by 1 - rate in x's dtype; the mask drawn from an explicit
    generator on x's device. With ``rows`` (``DropoutRNG.rows``) x holds
    items ``rows[0] ..`` of a batch of ``rows[1]``: the mask is drawn for the
    whole batch and x takes its rows."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        keep_prob = 1.0 - self.rate
        if rows is None:
            u = torch.rand(x.shape, generator=generator, device=x.device)
        else:
            u = torch.rand((rows[1], *x.shape[1:]), generator=generator, device=x.device)
            u = u[rows[0]:rows[0] + x.shape[0]]
        keep = u < keep_prob
        return torch.where(keep, x / torch.tensor(keep_prob, dtype=x.dtype), 0.0)


class LearnablePosEncoding(nn.Module):
    """Additive learned positional table [1, n, dim], then dropout when the
    forward is not deterministic."""

    def __init__(self, num_tokens: int, embed_dim: int, dropout: Optional[float] = None):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(1, num_tokens, embed_dim))
        self.drop = Dropout(dropout) if dropout else None

    def forward(self, seq: torch.Tensor, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        seq = seq + self.pos_embed.to(seq.dtype)
        if self.drop is not None and not deterministic:
            if rng is None:
                raise ValueError("a training forward with dropout needs a DropoutRNG")
            seq = self.drop(seq, rng.masks, rng.rows)
        return seq


class IdentityPosEncoding(nn.Module):
    """The ``identity`` positional encoding: no table, dropout only when the
    forward is not deterministic."""

    def __init__(self, dropout: Optional[float] = None):
        super().__init__()
        self.drop = Dropout(dropout) if dropout else None

    def forward(self, seq: torch.Tensor, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        if self.drop is not None and not deterministic:
            if rng is None:
                raise ValueError("a training forward with dropout needs a DropoutRNG")
            seq = self.drop(seq, rng.masks, rng.rows)
        return seq


class MLP(nn.Module):
    """Transformer FFN: linear1 -> activation -> dropout -> linear2."""

    def __init__(self, embed_dim: int, dim_feedforward: int, activation: str = "relu",
                 dropout: Optional[float] = None):
        super().__init__()
        self.activation, self.dropout = activation, dropout
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The plain deterministic path (frozen forwards on the CPU)."""
        l1, l2 = self.linear1, self.linear2
        h = get_activation(self.activation)(dense(x, gathered(l1.weight), gathered(l1.bias)))
        return dense(h, gathered(l2.weight), l2.bias)

    def fused(self, x: torch.Tensor, seed: Optional[int] = None, row0: int = 0) -> torch.Tensor:
        """The training path through ``fused_mlp`` (its plain version on the
        CPU); dropout live when a seed is given, x's rows being rows
        ``row0 ..`` of the global batch."""
        p = self.dropout if seed is not None else 0.0
        l1, l2 = self.linear1, self.linear2
        fn = mk.fused_mlp if policy.routes().mlp else mk.fused_mlp_reference
        return fn(x, gathered(l1.weight), gathered(l1.bias), gathered(l2.weight), l2.bias,
                  self.activation, p, seed, row0)

    def quant(self, x: torch.Tensor) -> torch.Tensor:
        """The W8A8 frozen forward (``ops/quant.py``): int8 fc1, the
        activation as the plain op in x's dtype (the JAX package applies it
        outside the int8 product too), int8 fc2."""
        l1, l2 = self.linear1, self.linear2
        h = get_activation(self.activation)(int8_dense(x, gathered(l1.weight), gathered(l1.bias)))
        return int8_dense(h, gathered(l2.weight), l2.bias)
