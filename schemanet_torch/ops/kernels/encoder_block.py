"""Frozen pre-norm encoder layer halves: CUDA kernels and their plain versions.

Port of ``schemanet_tpu/ops/pallas/encoder_block.py`` (``attn_block`` with its
``capture_hmean`` variant, and ``ffn_block``); the kernels are
``csrc/encoder_block.cu``, whose header says what bounds them on the card and
how their design answers it.

* ``attn_block``:  y = x + (MHSA(LN1(x) Wqkv + bqkv) Wo + bo)
* ``ffn_block``:   z = y + (gelu(LN2(y) W1 + b1) W2 + b2)

Weights are in ``nn.Linear`` layout (``[out, in]``); the fused qkv output is
ordered ``(3, H, d)`` like the JAX package's. Numerics follow the TPU kernels:
LN statistics in fp32 as E[x^2] - E[x]^2, products accumulated in fp32 and
rounded once to the compute dtype, bias added in the compute dtype, q scaled
in its own dtype, softmax in fp32, the head-mean of the pre-softmax scores
summed over heads in fp32.

Dispatch: a CPU tensor takes the plain version (``*_reference``); a CUDA
tensor launches the kernel or raises. ``attn_block_route`` picks
``attn_block``'s kernels by dtype: bf16 the tensor-core ones (``mma`` on bf16
tiles, head_dim a multiple of 16 up to 64, n <= 320), whose attention is
``fused_mhsa``'s kernel at p = 0; fp32 the split-TF32 ones (each product as
three TF32 ``mma`` products of split operands, about fp32's accuracy; head_dim
up to 128, any n), whose attention takes its softmax online over chunks of 32
keys. ``ffn_block_route`` picks ``ffn_block``'s: bf16 the tensor-core kernel
(f a multiple of 8), fp32 the split-TF32 kernel. Past width 384 (DeiT-Base's
768) the FFN half runs as separate launches, its intermediates in device
scratch: in bf16 an LN2 pass (``ln_rows_reference`` is its plain version,
bit for bit), fc1 with gelu and fc2 with the residual on the TMA-fed
``wgmma`` GEMM; ``ffn_plan`` gives the scratch, the tiles and the launches,
and the wrapper allocates from it. gelu is the TPU kernels' (``gelu_as``,
the Abramowitz-Stegun erf). Each wrapper counts its launches in a plain
integer attribute (``attn_block.launches``, ``attn_block.hmean_launches``,
``ffn_block.launches``, ``ffn_block.wide_launches``, ``ffn_ln_rows.launches``;
``attn_block.tc_launches`` and ``ffn_block.tc_launches`` count the launches
on the tensor cores: both routes of each).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import _build
from .gemm import heavy_tiles, light_tiles

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TENSOR_CORE, SPLIT_TF32 = "tensor_core", "split_tf32"
_TF32_MAX_HEAD_DIM = 128  # csrc/encoder_block.cu attn_tf32_kernel<128>: head_dim padded to 128
_TC_MAX_TOKENS = 320  # the tensor-core attention's K and V of one head fill its shared memory
_TC_MAX_WIDTH = 768  # csrc/encoder_block.cu kLinMaxK: a block stages 64 rows of A and W whole
_SQRT_HALF = 0.7071067811865476


def attn_block_route(dtype: torch.dtype, n: int, heads: int, head_dim: int) -> str:
    """The kernels a CUDA launch of ``attn_block`` takes for x of this dtype,
    n tokens and ``heads`` heads of ``head_dim``: ``"split_tf32"`` (fp32:
    each product as three TF32 ``mma`` products of split operands, which
    keeps about fp32's accuracy; head_dim up to 128, any n, any width) or
    ``"tensor_core"`` (bf16: ``mma`` on bf16 tiles, head_dim a multiple of 16
    up to 64, n <= 320). Raises on what neither takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"attn_block takes float32 or bfloat16, got {dtype}")
    if n < 1 or heads < 1:
        raise ValueError(f"attn_block takes n >= 1 and heads >= 1, got n={n}, heads={heads}")
    if dtype == torch.float32:
        if not 1 <= head_dim <= _TF32_MAX_HEAD_DIM:
            raise ValueError(f"attn_block takes head_dim <= {_TF32_MAX_HEAD_DIM} in float32, "
                             f"got {head_dim}")
        return SPLIT_TF32
    if head_dim % 16 or not 16 <= head_dim <= 64:
        raise ValueError(f"attn_block takes a bfloat16 head_dim that is a multiple of 16 up to 64, "
                         f"got {head_dim}")
    if n > _TC_MAX_TOKENS:
        raise ValueError(f"attn_block takes n <= {_TC_MAX_TOKENS} in bfloat16, got {n}")
    return TENSOR_CORE


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 rational erf of fp32 x, |error| <= 1.5e-7:
    the erf of the TPU kernels (not ``torch.erf``)."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    """gelu in fp32 with ``erf_as``, cast back to x.dtype."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + erf_as(xf * _SQRT_HALF))).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 LayerNorm with flax's fast variance (E[x^2] - E[x]^2, clamped at
    0), scale and bias in fp32, output in x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """flax Dense semantics in x.dtype: the product rounds once to x.dtype,
    then the bias is added in x.dtype. ``weight`` is [out, in]."""
    y = x @ weight.to(x.dtype).t()
    return y if bias is None else y + bias.to(x.dtype)


def attn_block_reference(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, num_heads, eps=1e-6,
                         capture_hmean=False):
    """Plain PyTorch version of ``attn_block`` (same numerics, same outputs)."""
    bs, n, dim = x.shape
    d = wqkv.shape[0] // (3 * num_heads)
    qkv = dense(layer_norm(x, ln_scale, ln_bias, eps), wqkv, bqkv)
    qkv = qkv.reshape(bs, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # [3, bs, H, n, d]
    q = qkv[0] * torch.tensor(1.0 / d**0.5, dtype=x.dtype)
    scores = torch.matmul(q.float(), qkv[1].float().transpose(-1, -2))  # [bs, H, n, n]
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    heads = torch.matmul(probs, qkv[2])  # fp32 accumulation, rounded once
    mh = heads.transpose(1, 2).reshape(bs, n, num_heads * d)
    out = x + dense(mh, wo, bo)
    if not capture_hmean:
        return out
    score_sum = scores[:, 0]
    for h in range(1, num_heads):
        score_sum = score_sum + scores[:, h]
    return out, (score_sum * (1.0 / num_heads)).to(x.dtype)


def ffn_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6):
    """Plain PyTorch version of ``ffn_block``: gelu in fp32 with the TPU
    kernels' Abramowitz-Stegun erf (``gelu_as``), cast back."""
    h = gelu_as(dense(layer_norm(x, ln_scale, ln_bias, eps), w1, b1))
    return x + dense(h, w2, b2)


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (or a CPU one, for the plain "
                         f"version), got {t.device}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    _require_cuda(name, t)
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


VECTOR, SCALAR = "vector", "scalar"


def piece_route(dtype: torch.dtype, d: int, *ptrs: int) -> str:
    """The route of a kernel that moves rows of ``d`` values of ``dtype`` in
    16-byte pieces a lane (the LayerNorm backward, ``embed_grad``'s
    gather): ``"vector"`` where a row is a whole number of 16 bytes and every
    data pointer in ``ptrs`` is 16-byte aligned, else ``"scalar"`` (one
    value a piece)."""
    if d * torch.finfo(dtype).bits // 8 % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        return VECTOR
    return SCALAR


def attn_block(
    x: torch.Tensor,  # [bs, n, dim]
    ln_scale: torch.Tensor,  # [dim]
    ln_bias: torch.Tensor,  # [dim]
    wqkv: torch.Tensor,  # [3*H*d, dim]
    bqkv: torch.Tensor,  # [3*H*d]
    wo: torch.Tensor,  # [dim, H*d]
    bo: torch.Tensor,  # [dim]
    num_heads: int,
    eps: float = 1e-6,
    capture_hmean: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x + MHSA half of a pre-norm encoder layer, [bs, n, dim] -> same.

    With ``capture_hmean`` also returns the head-mean of the pre-softmax
    scaled scores, [bs, n, n] in x.dtype (fp32-summed over heads)."""
    if x.device.type == "cpu":
        return attn_block_reference(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, num_heads, eps,
                                    capture_hmean)
    _require_cuda("x", x)
    bs, n, dim = x.shape
    hd3 = wqkv.shape[0]
    if hd3 % (3 * num_heads):
        raise ValueError(f"qkv width {hd3} is not 3 x {num_heads} heads")
    d = hd3 // (3 * num_heads)
    route = attn_block_route(x.dtype, n, num_heads, d)
    if route == TENSOR_CORE and (dim % 16 or num_heads * d % 16 or
                                 max(dim, num_heads * d) > _TC_MAX_WIDTH):
        raise ValueError(f"attn_block takes bfloat16 widths that are multiples of 16 up to "
                         f"{_TC_MAX_WIDTH}, got dim={dim}, H*d={num_heads * d}")
    dt = x.dtype
    wqkv, bqkv, wo, bo = (t.to(dt).contiguous() for t in (wqkv, bqkv, wo, bo))
    ln_scale, ln_bias = ln_scale.float().contiguous(), ln_bias.float().contiguous()
    _check("x", x, dt, (bs, n, dim))
    _check("ln_scale", ln_scale, torch.float32, (dim,))
    _check("ln_bias", ln_bias, torch.float32, (dim,))
    _check("wqkv", wqkv, dt, (3 * num_heads * d, dim))
    _check("bqkv", bqkv, dt, (3 * num_heads * d,))
    _check("wo", wo, dt, (dim, num_heads * d))
    _check("bo", bo, dt, (dim,))
    if route == TENSOR_CORE and any(t.data_ptr() % 16 for t in (wqkv, wo)):
        raise ValueError("attn_block: the tensor-core kernels copy 16-byte chunks; a weight is not "
                         "16-byte aligned")
    qkv = torch.empty((bs * n, hd3), dtype=dt, device=x.device)
    mh = torch.empty((bs * n, num_heads * d), dtype=dt, device=x.device)
    # LN1's (mean, rstd) a row, for the fp32 route's product blocks
    stats = torch.empty((bs * n, 2), dtype=torch.float32, device=x.device) \
        if route == SPLIT_TF32 else None
    out = torch.empty_like(x)
    hmean = torch.empty((bs, n, n), dtype=dt, device=x.device) if capture_hmean else None
    err = _build.library().sn_attn_block(
        _DTYPES[dt], x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), qkv.data_ptr(), mh.data_ptr(),
        stats.data_ptr() if stats is not None else None, out.data_ptr(),
        hmean.data_ptr() if hmean is not None else None,
        bs, n, dim, num_heads, d, float(eps), float(1.0 / d**0.5), _stream(),
    )
    _build.check(err, "attn_block")
    attn_block.launches += 1
    attn_block.tc_launches += 1  # both routes run on the tensor cores
    if capture_hmean:
        attn_block.hmean_launches += 1
        return out, hmean
    return out


attn_block.launches = attn_block.hmean_launches = attn_block.tc_launches = 0


# csrc/encoder_block.cu: the one-launch kernels' widths up to 384, then
# DeiT-Base's 768 on the wide route (LN2 and the hidden state in device memory)
_FFN_DIMS = (64, 128, 192, 256, 384, 768)
_FFN_FUSED_MAX = 384


def ffn_block_route(dtype: torch.dtype, dim: int, f: int) -> str:
    """The kernel a CUDA launch of ``ffn_block`` takes for x of this dtype,
    width ``dim`` and hidden width ``f``: ``"tensor_core"`` (bf16: ``mma``
    on bf16 tiles, f a multiple of 8, since the weights' hidden columns are
    copied in 16-byte chunks) or ``"split_tf32"`` (fp32: each product as
    three TF32 ``mma`` products of split operands, about fp32's accuracy).
    Raises on what neither takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"ffn_block takes float32 or bfloat16, got {dtype}")
    if dim not in _FFN_DIMS:
        raise ValueError(f"ffn_block takes width in {_FFN_DIMS}, got {dim}")
    if f < 1:
        raise ValueError(f"ffn_block takes a hidden width >= 1, got {f}")
    if dtype == torch.float32:
        return SPLIT_TF32
    if f % 8:
        raise ValueError(f"ffn_block takes a bfloat16 hidden width that is a multiple of 8, "
                         f"got {f}")
    return TENSOR_CORE


class FfnPlan:
    """The launches of one ``ffn_block`` call on ``rows`` rows of width
    ``dim``, hidden width ``f``: ``route`` (``ffn_block_route``), ``wide``
    (past width 384: a launch a step), ``launches`` (the kernels in order),
    ``scratch`` (``{name: (shape, dtype)}``, the wrapper's device scratch)
    and, on the bf16 wide route, ``tiles`` (``{product: (row tiles, column
    tiles, columns)}`` of the TMA-fed GEMM, csrc/gemm.cuh)."""

    def __init__(self, dtype: torch.dtype, rows: int, dim: int, f: int):
        self.route = ffn_block_route(dtype, dim, f)
        self.rows, self.dim, self.f = rows, dim, f
        self.wide = dim > _FFN_FUSED_MAX
        self.scratch, self.tiles = {}, {}
        if not self.wide:
            self.launches = ["ffn_tc_kernel" if self.route == TENSOR_CORE else "ffn_tf32_kernel"]
        elif self.route == TENSOR_CORE:  # LN2(x), then gelu's output
            self.launches = ["ln_rows_bf16_kernel", "gemm_wg_kernel", "gemm_wg_kernel"]
            self.scratch = {"ln": ((rows, dim), dtype), "hidden": ((rows, f), dtype)}
            self.tiles = {"fc1": heavy_tiles(rows, f), "fc2": light_tiles(rows, dim, False)}
        else:  # LN2's (mean, rstd) a row, then gelu's output
            self.launches = ["ln_stats_kernel", "linear_tf32_kernel", "linear_tf32_kernel"]
            self.scratch = {"ln": ((rows, 2), torch.float32), "hidden": ((rows, f), dtype)}


def ffn_plan(dtype: torch.dtype, rows: int, dim: int, f: int) -> FfnPlan:
    """The launch plan of ``ffn_block`` on ``rows`` rows of this dtype and
    width, hidden width ``f``; raises as ``ffn_block_route``."""
    return FfnPlan(dtype, rows, dim, f)


_LN_LANES, _LN_PIECE = 32, 8  # csrc/encoder_block.cu ln_rows_bf16_kernel: 8 values a piece


def ln_rows_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """The bf16 wide FFN route's LN2 pass in plain PyTorch, bit for bit
    (csrc/encoder_block.cu ``ln_rows_bf16_kernel``): x [..., dim] bf16 (dim a
    multiple of 8) to round_bf16(LN2(x)). Lane l of a row's warp sums its
    columns 8 (l + 32 i) + k in column order (s of v, s2 of v v: exact for
    a bf16 v), then the xor tree 16, 8, 4, 2, 1; every operation in fp32,
    each rounded on its own: computed in fp64 and rounded to fp32, which for
    +, -, x, / and sqrt is the correctly rounded fp32 result on any device
    (PyTorch's fp32 sqrt on the CPU is not). The same function as
    ``layer_norm``, its sums in another order."""
    dim = x.shape[-1]
    if dim % _LN_PIECE:
        raise ValueError(f"ln_rows_reference takes a width that is a multiple of 8, got {dim}")
    xf = x.reshape(-1, dim).float()
    rows, span = xf.shape[0], _LN_LANES * _LN_PIECE
    pad = -dim % span
    lanes = torch.nn.functional.pad(xf, (0, pad)).view(rows, -1, _LN_LANES, _LN_PIECE)
    lanes = lanes.permute(0, 2, 1, 3).reshape(rows, _LN_LANES, -1).double()  # a lane's columns

    def rn(t):  # an fp64 result rounded to fp32, held in fp64
        return t.float().double()

    s = torch.zeros(rows, _LN_LANES, dtype=torch.float64)
    s2 = torch.zeros(rows, _LN_LANES, dtype=torch.float64)
    for j in range(lanes.shape[-1]):
        v = lanes[..., j]
        s, s2 = rn(s + v), rn(s2 + v * v)  # v v: exact
    lane = torch.arange(_LN_LANES)
    for o in (16, 8, 4, 2, 1):
        s, s2 = rn(s + s[:, lane ^ o]), rn(s2 + s2[:, lane ^ o])
    # tensor divisors: a scalar one may be taken as a product by its reciprocal
    n = torch.full((rows, 1), float(dim), dtype=torch.float64)
    mean = rn(s[:, :1] / n)
    var = torch.clamp(rn(rn(s2[:, :1] / n) - rn(mean * mean)), min=0.0)
    eps32 = float(torch.tensor(eps, dtype=torch.float32))
    rstd = rn(torch.ones_like(var) / rn(torch.sqrt(rn(var + eps32))))
    y = rn(rn(rn(rn(xf.double() - mean) * rstd) * scale.double()) + bias.double())
    return y.to(torch.bfloat16).reshape(x.shape)


def ffn_ln_rows(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """The bf16 wide FFN route's LN2 pass alone, round_bf16(LN2(x)) of x
    [..., dim] bf16 (dim a multiple of 8 up to 1024): the kernel on a CUDA
    tensor, ``ln_rows_reference`` on a CPU one. ``ffn_block`` runs the same
    kernel into its scratch; this launch is counted apart
    (``ffn_ln_rows.launches``)."""
    if x.device.type == "cpu":
        return ln_rows_reference(x, ln_scale, ln_bias, eps)
    dim = x.shape[-1]
    ln_scale, ln_bias = ln_scale.float().contiguous(), ln_bias.float().contiguous()
    _check("x", x, torch.bfloat16, x.shape)
    _check("ln_scale", ln_scale, torch.float32, (dim,))
    _check("ln_bias", ln_bias, torch.float32, (dim,))
    if dim % 8 or dim > 1024 or any(t.data_ptr() % 16 for t in (x, ln_scale, ln_bias)):
        raise ValueError(f"ffn_ln_rows takes 16-byte aligned rows of a multiple of 8 up to 1024 "
                         f"values, got {dim}")
    out = torch.empty_like(x)
    err = _build.library().sn_ffn_ln_rows(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                                          out.data_ptr(), x.numel() // dim, dim, float(eps),
                                          _stream())
    _build.check(err, "ffn_ln_rows")
    ffn_ln_rows.launches += 1
    return out


ffn_ln_rows.launches = 0


def ffn_block(
    x: torch.Tensor,  # [bs, n, dim]
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,  # [f, dim]
    b1: torch.Tensor,  # [f]
    w2: torch.Tensor,  # [dim, f]
    b2: torch.Tensor,  # [dim]
    eps: float = 1e-6,
) -> torch.Tensor:
    """x + FFN half (gelu) of a pre-norm encoder layer, [bs, n, dim] -> same."""
    if x.device.type == "cpu":
        return ffn_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    _require_cuda("x", x)
    dim = x.shape[-1]
    f = w1.shape[0]
    ffn_block_route(x.dtype, dim, f)  # raises on what no kernel takes
    dt = x.dtype
    w1, b1, w2, b2 = (t.to(dt).contiguous() for t in (w1, b1, w2, b2))
    ln_scale, ln_bias = ln_scale.float().contiguous(), ln_bias.float().contiguous()
    _check("x", x, dt, x.shape)
    _check("ln_scale", ln_scale, torch.float32, (dim,))
    _check("ln_bias", ln_bias, torch.float32, (dim,))
    _check("w1", w1, dt, (f, dim))
    _check("b1", b1, dt, (f,))
    _check("w2", w2, dt, (dim, f))
    _check("b2", b2, dt, (dim,))
    plan = ffn_plan(dt, x.numel() // dim, dim, f)
    ln_pass = plan.wide and plan.route == TENSOR_CORE  # reads the LN parameters in 16 bytes
    loaded = (x, w1, w2) + ((ln_scale, ln_bias) if ln_pass else ())
    if any(t.data_ptr() % 16 for t in loaded):
        raise ValueError("ffn_block: the tensor-core kernels load 16-byte chunks; x, a weight or "
                         "an LN parameter is not 16-byte aligned")
    out = torch.empty_like(x)
    scratch = {name: torch.empty(shape, dtype=sdt, device=x.device)
               for name, (shape, sdt) in plan.scratch.items()}

    def ptr(name):
        return scratch[name].data_ptr() if name in scratch else None

    err = _build.library().sn_ffn_block(
        _DTYPES[dt], x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), ptr("hidden"), ptr("ln"),
        plan.rows, dim, f, float(eps), _stream(),
    )
    _build.check(err, "ffn_block")
    ffn_block.launches += 1
    ffn_block.tc_launches += 1  # both routes run on the tensor cores
    ffn_block.wide_launches += plan.wide
    return out


ffn_block.launches = ffn_block.tc_launches = ffn_block.wide_launches = 0
