"""Dynamic W8A8 quantisation of the frozen backbone's projections (port of
``schemanet_tpu/ops/quant.py``).

The four projections of an encoder layer (qkv, out, fc1, fc2) run int8 x
int8 -> int32 with per-output-channel weight scales and per-token dynamic
activation scales: symmetric, no zero points, round half to even, scales
in fp32, the int32 sum rescaled in fp32 (``float(acc) * (x_scale *
w_scale)``), the bias added in fp32, the result cast to x's dtype. The
weights are quantised at each call, as the JAX package does inside its jit.

Weights are in ``nn.Linear`` layout ``[out, in]``: JAX's per-output-channel
quantisation of its ``[in, out]`` kernel is per-row quantisation here, so
one function (and one kernel) serves weights and activations. On a CUDA
tensor each step is a hand-written kernel (``ops/kernels/quant.py``:
``quantize_rows``, ``int8_gemm``), on a CPU tensor its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernels import quant as qk


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an ``nn.Linear`` weight [out, in]:
    (w_i8 [out, in], scale [out] fp32) with w ~= w_i8 * scale[:, None]. The
    weight is read in fp32, as JAX reads its fp32 parameters."""
    w_i8, scale = qk.quantize_rows(w.float().contiguous())
    return w_i8, scale.reshape(-1)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (per-token) symmetric int8 of x [..., in] (fp32 or bf16):
    (x_i8 [..., in], scale [..., 1] fp32) with x ~= x_i8 * scale."""
    return qk.quantize_rows(x.contiguous())


def int8_dot(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., in] times the dequantised weight, in x's dtype: x quantised a
    row at a time, the int8 x int8 -> int32 product, then the fp32 rescale
    and bias. w_i8 [out, in], w_scale [out]."""
    x_i8, x_scale = quantize_rows(x)
    lead, k = x.shape[:-1], x.shape[-1]
    y = qk.int8_gemm(x_i8.reshape(-1, k), w_i8, x_scale.reshape(-1), w_scale.reshape(-1),
                     None if bias is None else bias.float().contiguous(), x.dtype)
    return y.reshape(*lead, w_i8.shape[0])


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in int8 counterpart of ``dense(x, weight, bias)`` for an
    ``nn.Linear`` weight [out, in] and bias [out]."""
    w_i8, w_scale = quantize_weight(weight)
    return int8_dot(x, w_i8, w_scale, bias)
