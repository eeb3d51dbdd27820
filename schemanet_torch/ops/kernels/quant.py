"""W8A8 int8 projections: CUDA kernels and their plain versions.

Counterpart of ``schemanet_tpu/ops/quant.py``, which has no Pallas kernel:
there XLA's int8 ``dot_general`` runs on the TPU's matrix unit. On Hopper the
int8 tensor cores run at twice the bf16 rate (1,979 against 989 dense
TOP/s), and a product cast to floats would run none of that, so the two
steps are hand-written kernels (``csrc/quant.cu``, whose header says what
bounds them on the card and how their design answers it):

* ``quantize_rows(x)``: per-row symmetric int8 of fp32 or bf16 rows x
  [rows, k]: ``scale = max(absmax, 1e-12) / 127``, ``q = clip(rint(x /
  scale), -127, 127)`` (round half to even), scale in fp32. It serves the
  activations (a row a token) and the weights: per-output-channel
  quantisation of JAX's ``[in, out]`` kernel is per-row quantisation of the
  ``nn.Linear`` weight ``[out, in]``.
* ``int8_gemm(a, w, a_scale, w_scale, bias, out_dtype)``: ``y[r, c] =
  cast(float(sum_k a[r, k] w[c, k]) * (a_scale[r] * w_scale[c]) + bias[c])``
  with int8 a [rows, k] and w [n, k] (both K-major: ``nn.Linear``'s
  layout is already the ``col`` operand of ``mma.sync ... s8.s8.s32``), the
  sum exact in int32, the epilogue in fp32 in that order, the output in fp32
  or bf16.

Both kernels are bit for bit their plain versions: the codes come from the
same IEEE divisions and the same rounding, the int32 sums are exact, and the
epilogue repeats the same fp32 operations in the same order (the kernel's
``_rn`` intrinsics keep nvcc from contracting them into an FMA). The plain
int32 product is exact too: an int32 ``matmul`` on the CPU, a float64 one on
the card (exact below 2^53; never fp32, whose 2^24 a sum passes already at
DeiT-Small's fc2: 127^2 x 1536 > 2.4e7).

Dispatch: a CPU tensor takes the plain version (``*_reference``); a CUDA
tensor launches the kernel or raises. ``quantize_rows.launches`` and
``int8_gemm.launches`` count the launches, ``shape_launches`` of each the
launches by ``(rows, k)`` and ``(rows, n, k)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .encoder_block import _DTYPES, _check, _require_cuda, _stream, count_shape

QMAX = 127
SCALE_FLOOR = 1e-12
_MAX_ROW = 3072  # csrc/quant.cu kQuantMaxRow: a warp holds a row of up to 3072 values
_K_STEP = 32  # mma.sync m16n8k32: k in steps of 32 bytes


def quantize_rows_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``quantize_rows``: (int8 codes [..., k], fp32
    scale [..., 1]) of x [..., k]. The divisors are tensors on x's device: a
    Python-number divisor may be taken as a product by its reciprocal on
    the card, which rounds elsewhere."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(SCALE_FLOOR) / torch.full_like(absmax, float(QMAX))
    q = torch.round(xf / scale).clamp_(-QMAX, QMAX).to(torch.int8)  # half to even
    return q, scale


def int8_gemm_reference(a: torch.Tensor, w: torch.Tensor, a_scale: torch.Tensor,
                        w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                        out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of ``int8_gemm``: the int32 sums exact (int32
    ``matmul`` on the CPU, float64 on the card), each rounded to fp32 once,
    then ``* (a_scale * w_scale)`` and ``+ bias`` in fp32, cast to
    ``out_dtype``."""
    if a.device.type == "cpu":
        acc = torch.matmul(a.to(torch.int32), w.to(torch.int32).t()).float()
    else:
        acc = torch.matmul(a.double(), w.double().t()).float()
    y = acc * (a_scale.reshape(-1, 1).float() * w_scale.reshape(1, -1).float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def check_row_width(dtype: torch.dtype, k: int) -> None:
    """Raises unless ``quantize_rows``'s kernel takes rows of this dtype and
    width: float32 or bfloat16, k a multiple of 8 (whole 16-byte pieces of
    bf16, whole 8-byte pieces of codes) up to 3072."""
    if dtype not in _DTYPES:
        raise TypeError(f"quantize_rows takes float32 or bfloat16, got {dtype}")
    if k % 8 or not 0 < k <= _MAX_ROW:
        raise ValueError(f"quantize_rows takes a width that is a multiple of 8 up to {_MAX_ROW}, "
                         f"got {k}")


def check_k(k: int) -> None:
    """Raises unless ``int8_gemm``'s kernel takes this contraction width: a
    positive multiple of 32 (the ``mma`` k step)."""
    if k < 1 or k % _K_STEP:
        raise ValueError(f"int8_gemm takes k a multiple of {_K_STEP}, got {k}")


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes [..., k], fp32 scale [..., 1]) of fp32 or bf16 x [..., k]:
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return quantize_rows_reference(x)
    _require_cuda("x", x)
    k = x.shape[-1]
    check_row_width(x.dtype, k)
    _check("x", x, x.dtype, x.shape)
    if x.data_ptr() % 16:
        raise ValueError("quantize_rows loads 16-byte pieces; x is not 16-byte aligned")
    rows = x.numel() // k
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    err = _build.library().sn_quantize_rows(_DTYPES[x.dtype], x.data_ptr(), q.data_ptr(),
                                            scale.data_ptr(), rows, k, _stream())
    _build.check(err, "quantize_rows")
    quantize_rows.launches += 1
    count_shape(quantize_rows, (rows, k))
    return q, scale


def int8_gemm(a: torch.Tensor, w: torch.Tensor, a_scale: torch.Tensor, w_scale: torch.Tensor,
              bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """y [rows, n] in ``out_dtype`` (float32 or bfloat16) of int8 a [rows, k]
    and w [n, k] with fp32 scales a_scale [rows] (or [rows, 1]), w_scale [n]
    (or [n, 1]) and fp32 bias [n] or None: the kernel on CUDA tensors, the
    plain version on CPU ones. k a multiple of 32."""
    if a.device.type == "cpu":
        return int8_gemm_reference(a, w, a_scale, w_scale, bias, out_dtype)
    _require_cuda("a", a)
    if out_dtype not in _DTYPES:
        raise TypeError(f"int8_gemm writes float32 or bfloat16, got {out_dtype}")
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"int8_gemm takes a [rows, k] and w [n, k], got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    rows, k = a.shape
    n = w.shape[0]
    check_k(k)
    _check("a", a, torch.int8, (rows, k))
    _check("w", w, torch.int8, (n, k))
    a_scale, w_scale = a_scale.reshape(-1), w_scale.reshape(-1)
    _check("a_scale", a_scale, torch.float32, (rows,))
    _check("w_scale", w_scale, torch.float32, (n,))
    if bias is not None:
        _check("bias", bias, torch.float32, (n,))
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("int8_gemm copies 16-byte chunks; a or w is not 16-byte aligned")
    y = torch.empty((rows, n), dtype=out_dtype, device=a.device)
    err = _build.library().sn_int8_gemm(
        _DTYPES[out_dtype], a.data_ptr(), w.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(), rows, n, k, _stream())
    _build.check(err, "int8_gemm")
    int8_gemm.launches += 1
    count_shape(int8_gemm, (rows, n, k))
    return y


quantize_rows.launches = int8_gemm.launches = 0
quantize_rows.shape_launches, int8_gemm.shape_launches = {}, {}
