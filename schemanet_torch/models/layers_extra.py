"""The rest of the layer zoo (port of ``schemanet_tpu/models/layers_extra.py``),
NHWC as there: convolution helpers, ChannelNorm / LayerNorm2D and the norm
registry, BatchNorm and a NaN-tolerant BatchNorm, a 1x1-conv MLP and
Interpolate.

Modules take NHWC tensors ``[bs, H, W, C]``. A convolution views its input
as NCHW in the ``channels_last`` memory format (a permute, no copy), runs
``F.conv2d`` (cuDNN on the card) in the module's compute dtype and views the
result back as NHWC, so the layout stays NHWC in memory from end to end.
torch modules need their input width where flax infers it: the constructors
here take it as their first argument.

``BatchNorm`` has flax's semantics, not ``nn.BatchNorm2d``'s: statistics in
fp32 whatever the compute dtype, the variance as E[x^2] - E[x]^2 clipped at
0, the running update ``ra = momentum ra + (1 - momentum) batch`` with the
biased variance, no ``num_batches_tracked``, the result cast to the compute
dtype at the end. On a data-parallel grid (``join_grid``) the per-channel
sums of x and x^2 are summed over the data group before they normalise, and
their gradients in the backward (``parallel/mesh.py`` ``all_reduce_sum``):
the statistics of the global batch, as the JAX step computes them over a
data-sharded array.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import Mesh, all_reduce_sum
from .layers import Dropout, DropoutRNG, get_activation, pair


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC maps: ``features`` outputs, a square
    ``kernel``, ``stride`` and symmetric ``padding``; weight OIHW, the
    product in ``dtype`` (fp32 on the card takes TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False)."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.zeros(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC memory as channels_last NCHW
        w = self.weight.to(self.dtype).contiguous(memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding).permute(0, 2, 3, 1)


def conv_1x1(in_features: int, features: int, use_bias: bool = True) -> Conv:
    return Conv(in_features, features, 1, use_bias=use_bias)


def conv_3x3(in_features: int, features: int, use_bias: bool = True) -> Conv:
    return Conv(in_features, features, 3, padding=1, use_bias=use_bias)


def conv_out_shape(in_shape: Sequence[int], kernel: int, stride: int, padding: int
                   ) -> Tuple[int, ...]:
    return tuple((s + 2 * padding - kernel) // stride + 1 for s in in_shape)


def _layer_norm(x: torch.Tensor, dims: Tuple[int, ...], weight: torch.Tensor,
                bias: torch.Tensor, eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over ``dims``, scale and bias on the last axis:
    fp32 statistics (E[x^2] - E[x]^2, clipped at 0), the result in the
    promoted dtype of x and the fp32 parameters, as flax leaves it."""
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight)
    return (y + bias).to(torch.promote_types(x.dtype, weight.dtype))


class ChannelNorm(nn.Module):
    """LayerNorm over the channel axis of NHWC maps."""

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, (-1,), self.weight, self.bias, self.epsilon)


class LayerNorm2D(ChannelNorm):
    """LayerNorm over (H, W, C) of NHWC maps, its scale and bias over C
    alone (flax's ``feature_axes=-1``): not ``nn.LayerNorm([H, W, C])``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, (-3, -2, -1), self.weight, self.bias, self.epsilon)


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """flax's statistics dtype: x's promoted to at least fp32."""
    return torch.promote_types(x.dtype, torch.float32)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (see the module docstring):
    parameters ``weight`` (flax's ``scale``) and ``bias``, running buffers
    ``mean`` and ``var`` (flax's ``batch_stats``). ``use_running_average``
    is given at construction or at the call, as flax takes it."""

    def __init__(self, num_features: int, use_running_average: Optional[bool] = None,
                 momentum: float = 0.99, epsilon: float = 1e-5, dtype=None):
        super().__init__()
        self.use_running_average, self.momentum, self.epsilon = (use_running_average, momentum,
                                                                 epsilon)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.data_group, self.data = None, 1

    def join_grid(self, mesh: Mesh) -> None:
        """Statistics of the global batch: summed over the data group."""
        if mesh.data > 1:
            self.data_group, self.data = mesh.data_group, mesh.data

    def batch_stats(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var) of x over every axis but the last, in fp32 (fp64 for
        fp64 x); on a grid over the global batch."""
        xf = x.to(_stats_dtype(x))
        dims = tuple(range(x.ndim - 1))
        sums = torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims)])
        if self.data_group is not None:
            sums = all_reduce_sum(sums, self.data_group)
        mean, mean2 = (sums / float(x.numel() // x.shape[-1] * self.data)).chunk(2)
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    def forward(self, x: torch.Tensor, use_running_average: Optional[bool] = None
                ) -> torch.Tensor:
        use_ra = self.use_running_average if use_running_average is None else use_running_average
        if use_ra is None:
            raise ValueError("BatchNorm needs use_running_average, at construction or at the call")
        if use_ra:
            mean, var = self.mean, self.var
        else:
            mean, var = self.batch_stats(x)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        y = (x.to(_stats_dtype(x)) - mean) * (torch.rsqrt(var + self.epsilon) * self.weight)
        return (y + self.bias).to(self.dtype if self.dtype is not None else _stats_dtype(x))


NORM_REGISTRY = {
    "channel_norm": ChannelNorm,
    "layer_norm_2d": LayerNorm2D,
    # flax nn.LayerNorm: ChannelNorm's function, epsilon 1e-6 unless given
    "layer_norm": lambda num_features, epsilon=1e-6: ChannelNorm(num_features, epsilon),
    "batch_norm": BatchNorm,
    "none": lambda *a, **k: nn.Identity(),
}


def get_norm(name: str, num_features: int, **kwargs) -> nn.Module:
    """The norm registry (flax's keyword arguments: ``epsilon``, and for
    ``batch_norm`` ``use_running_average``, ``momentum``)."""
    return NORM_REGISTRY[name](num_features, **kwargs)


class NanBatchNorm(nn.Module):
    """BatchNorm whose statistics ignore non-finite entries: the mean and
    the (biased) variance over the finite values of each channel, in x's
    dtype; a NaN passes through, normalised by the finite statistics. The
    running statistics (fp32 ``mean`` and ``var``) move only in training."""

    def __init__(self, num_features: int, use_running_average: bool = True,
                 momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.use_running_average, self.momentum, self.epsilon = (use_running_average, momentum,
                                                                 epsilon)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, use_running_average: Optional[bool] = None
                ) -> torch.Tensor:
        use_ra = self.use_running_average if use_running_average is None else use_running_average
        if use_ra:
            mean, var = self.mean, self.var
        else:
            dims = tuple(range(x.ndim - 1))
            finite = torch.isfinite(x)
            cnt = torch.clamp(finite.sum(dim=dims), min=1)
            mean = torch.where(finite, x, 0.0).sum(dim=dims) / cnt
            var = torch.where(finite, (x - mean) ** 2, 0.0).sum(dim=dims) / cnt
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.weight + self.bias


class MLP2D(nn.Module):
    """1x1-conv MLP over NHWC maps of ``embed_dim`` channels: linear1 to
    round(embed_dim * dim_expand), the activation, dropout, linear2 to
    ``out_dim``."""

    def __init__(self, embed_dim: int, dim_expand: float, out_dim: int,
                 dropout: Optional[float] = None, activation: str = "relu"):
        super().__init__()
        hidden = round(embed_dim * dim_expand)
        self.activation = activation
        self.linear1 = conv_1x1(embed_dim, hidden)
        self.linear2 = conv_1x1(hidden, out_dim)
        self.drop = Dropout(dropout) if dropout else None

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        x = get_activation(self.activation)(self.linear1(x))
        if self.drop is not None and not deterministic:
            if rng is None:
                raise ValueError("a training forward with dropout needs a DropoutRNG")
            x = self.drop(x, rng.masks, rng.rows)
        return self.linear2(x)


# jax.image.resize's methods -> F.interpolate's modes: half-pixel centres, and
# antialiased when shrinking (torch's antialias filters are the triangle and
# Keys' a = -0.5 cubic, jax.image's kernels)
_RESIZE = {"bilinear": ("bilinear", True), "linear": ("bilinear", True),
           "bicubic": ("bicubic", True), "cubic": ("bicubic", True),
           "nearest": ("nearest-exact", False)}


class Interpolate(nn.Module):
    """Resize NHWC maps to ``size`` or by ``scale_factor`` (the output
    size ``int(h * scale_factor)``), as ``jax.image.resize`` does."""

    def __init__(self, scale_factor: Optional[float] = None,
                 size: Optional[Tuple[int, int]] = None, method: str = "bilinear"):
        super().__init__()
        if method not in _RESIZE:
            raise ValueError(f"Interpolate takes {sorted(_RESIZE)}, got {method!r}")
        self.scale_factor, self.size, self.method = scale_factor, size, method

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if self.size is not None:
            oh, ow = pair(self.size)
        else:
            oh, ow = int(h * self.scale_factor), int(w * self.scale_factor)
        mode, antialias = _RESIZE[self.method]
        kw = {"align_corners": False, "antialias": antialias} if mode != "nearest-exact" else {}
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode=mode, **kw)
        return y.permute(0, 2, 3, 1)
