"""ResNet-18/34/50, the ``official_models`` registry entry (port of
``schemanet_tpu/models/resnet.py``).

torchvision's architectures: ``BasicBlock`` and ``Bottleneck`` (the stride on
the 3x3, as torchvision v1.5), BatchNorm with running statistics, NHWC at the
model's boundary. The module names are the JAX package's (``conv1``, ``bn1``,
``layer1_0.conv1``, ``downsample_conv``, ``downsample_bn``, ``fc``), so
``models/port.py`` maps the variables both ways (``params`` and
``batch_stats``) and the optimizer's regex groups match as there.

The convolutions, the max pool and the mean pool are what the JAX package
leaves to XLA, with no Pallas kernel: here ``F.conv2d`` / cuDNN and the pools
in the compute dtype, on NHWC memory viewed as ``channels_last`` NCHW
(``layers_extra.Conv``). BatchNorm has flax's semantics
(``layers_extra.BatchNorm``, momentum 0.9, epsilon 1e-5): the training
forward (``deterministic=False``) normalises by the batch's statistics and
moves the running ones, a deterministic forward uses the running ones; on a
data-parallel grid the batch is the global one.

``forward(img, deterministic, rng, capture)`` returns ``{"pred": logits}``
and, with ``capture`` (probes ``layer{i}.out``, the output of stage i),
``"captured"``. ``rng`` is taken for the trainer's call and unused: a ResNet
has no dropout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.encoder_block import dense
from .layers import DropoutRNG
from .layers_extra import BatchNorm, Conv


def _norm(features: int, dtype) -> BatchNorm:
    return BatchNorm(features, momentum=0.9, epsilon=1e-5, dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(in_features, features, 3, strides, 1, use_bias=False, dtype=dtype)
        self.bn1 = _norm(features, dtype)
        self.conv2 = Conv(features, features, 3, 1, 1, use_bias=False, dtype=dtype)
        self.bn2 = _norm(features, dtype)
        if strides != 1 or in_features != features:
            self.downsample_conv = Conv(in_features, features, 1, strides, use_bias=False,
                                        dtype=dtype)
            self.downsample_bn = _norm(features, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        ra = not train
        y = F.relu(self.bn1(self.conv1(x), ra))
        y = self.bn2(self.conv2(y), ra)
        return F.relu(y + _shortcut(self, x, ra))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1, dtype=torch.float32):
        super().__init__()
        out = features * self.expansion
        self.conv1 = Conv(in_features, features, 1, use_bias=False, dtype=dtype)
        self.bn1 = _norm(features, dtype)
        self.conv2 = Conv(features, features, 3, strides, 1, use_bias=False, dtype=dtype)
        self.bn2 = _norm(features, dtype)
        self.conv3 = Conv(features, out, 1, use_bias=False, dtype=dtype)
        self.bn3 = _norm(out, dtype)
        if strides != 1 or in_features != out:
            self.downsample_conv = Conv(in_features, out, 1, strides, use_bias=False, dtype=dtype)
            self.downsample_bn = _norm(out, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        ra = not train
        y = F.relu(self.bn1(self.conv1(x), ra))
        y = F.relu(self.bn2(self.conv2(y), ra))
        y = self.bn3(self.conv3(y), ra)
        return F.relu(y + _shortcut(self, x, ra))


def _shortcut(block: nn.Module, x: torch.Tensor, ra: bool) -> torch.Tensor:
    """The residual: x, or its 1x1 projection where the shapes differ."""
    if not hasattr(block, "downsample_conv"):
        return x
    return block.downsample_bn(block.downsample_conv(x), ra)


class ResNet(nn.Module):
    def __init__(self, num_classes: int, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block: type = BasicBlock, dtype=torch.float32, img_size: int = 224,
                 image_channels: int = 3):
        super().__init__()
        self.stage_sizes, self.dtype = tuple(stage_sizes), dtype
        # kept for get_model's interface, as in the JAX package
        self.img_size, self.image_channels = img_size, image_channels
        self.conv1 = Conv(image_channels, 64, 7, 2, 3, use_bias=False, dtype=dtype)
        self.bn1 = _norm(64, dtype)
        features = 64
        for i, size in enumerate(self.stage_sizes):
            for j in range(size):
                strides = 2 if i > 0 and j == 0 else 1
                b = block(features, 64 * 2**i, strides, dtype)
                setattr(self, f"layer{i + 1}_{j}", b)
                features = 64 * 2**i * block.expansion
        self.fc = nn.Linear(features, num_classes)

    def forward(self, img: torch.Tensor, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None, capture: Tuple[str, ...] = ()
                ) -> Dict[str, Any]:
        """Classify NHWC images: ``{"pred": logits [bs, num_classes]}``, with
        ``"captured"`` when ``capture`` names stage outputs."""
        train = not deterministic
        x = F.relu(self.bn1(self.conv1(img), not train))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        captured: Dict[str, torch.Tensor] = {}
        for i, size in enumerate(self.stage_sizes):
            for j in range(size):
                x = getattr(self, f"layer{i + 1}_{j}")(x, train)
            if f"layer{i + 1}.out" in capture:
                captured[f"layer{i + 1}.out"] = x
        out: Dict[str, Any] = {"pred": dense(x.mean(dim=(1, 2)), self.fc.weight, self.fc.bias)}
        if capture:
            out["captured"] = captured
        return out


RESNET_SPECS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), block=BasicBlock),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), block=BasicBlock),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), block=Bottleneck),
}


def build_resnet(model_cfg: Dict[str, Any], num_classes: int, dtype=torch.float32) -> ResNet:
    """The ResNet of ``model_cfg``'s ``model_name`` (else its ``name``)."""
    name = model_cfg.get("model_name", model_cfg.get("name", "resnet18"))
    return ResNet(num_classes, dtype=dtype, **RESNET_SPECS[name])
