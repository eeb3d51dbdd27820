"""Fused transformer FFN with in-kernel dropout: CUDA kernels and their plain
versions.

Port of ``schemanet_tpu/ops/pallas/mlp.py`` ``fused_mlp`` (forward and
backward); the kernels are ``csrc/mlp.cu``, whose header says what bounds
them on the card and how their design answers it.

``fused_mlp(x, w1, b1, w2, b2, activation, dropout_p, seed)`` computes
``drop(act(x W1^T + b1)) W2^T + b2`` on ``x [bs, n, dim]`` with weights in
``nn.Linear`` layout (``w1 [f, dim]``, ``w2 [dim, f]``). FFN dropout keeps
hidden element (row, col) by the hash mask of ``dropmask.py``, stream 0, the
absolute row of the flattened ``bs * n`` rows and ``cols = f``, so the
backward regenerates the forward's mask. It is a ``torch.autograd.Function``
whose backward is the backward kernel; the forward never stores the
``[rows, f]`` hidden state.

Numerics follow the TPU kernels: the weights are cast to x's dtype outside
the kernel (so their gradients reach fp32 parameters rounded to that dtype,
as in JAX); ``x W1`` accumulated in fp32 and rounded once, ``+ b1`` in the
compute dtype; gelu with the Abramowitz-Stegun erf in fp32, cast back;
dropout ``h * (1/(1-p))`` as a product in the compute dtype (JAX rounds the
weak-typed Python float to it); fc2 accumulated in fp32 and rounded once,
``+ b2`` in the compute dtype. Backward: ``da * (1/(1-p))`` in fp32,
``dh = da * gelu'(h)`` rounded to the compute dtype, weight and bias
gradients summed in fp32 and rounded to the weights' dtype.

Dispatch: a CPU tensor takes the plain versions (``fused_mlp_reference``,
``fused_mlp_bwd_reference``); a CUDA tensor launches the kernels or raises.
``mlp_route`` picks the kernels of both launches by dtype: fp32 takes the
FMA kernels, bf16 the tensor-core ones (the forward keeps its hidden chunk in
shared memory; the backward stores the hidden state ``dH`` and ``a_used``
once in a ``[rows, f]`` bf16 scratch each). Past width 256 (DeiT-Small's 384,
DeiT-Base's 768) both dtypes take the wide route of the same kernel family:
each product one launch over a fixed output tile (bf16: Hopper's TMA-fed
``wgmma``, the backward's h and dA in one launch; fp32: FMA), the hidden
state ``a_used`` (and in the backward ``dH``, and in fp32 ``dA``) in device
memory between them. ``mlp_plan`` gives every launch's scratch, row splits
and tiles, and the wrappers allocate from it. ``fused_mlp.launches`` and
``fused_mlp_bwd.launches`` count the launches, ``fused_mlp.tc_launches`` and
``fused_mlp_bwd.tc_launches`` those of the tensor-core route, and
``*.wide_launches`` those of the wide route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .dropmask import hash_keep_mask, kernel_dropout_args, keep_scale
from .encoder_block import _DTYPES, _SQRT_HALF, _check, _require_cuda, _stream, erf_as, gelu_as
from .gemm import _HG_BK, _HG_BM, _SMS, _cdiv, heavy_tiles, light_tiles
from .gemm import gemm_tile  # noqa: F401  (mlp.gemm_tile: the tile rule of the plan below)

# csrc/mlp.cu: the one-launch kernels' widths, and the wide route's (each
# product a launch, the hidden state in device memory) past them
_DIMS = (64, 128, 192, 256, 384, 768)
_WIDE = 256  # widths above this take the wide route
_SPLITS = 24  # row splits of the FMA weight-gradient kernel: ~2 blocks per SM at f = 768
_ROW_TILE = 32  # csrc/mlp.cu kMlpBM
# row splits of the narrow tensor-core weight-gradient kernel: 12 x 36 tiles
# at the stage-0 shape, ~3 blocks an SM; its rows go in steps of 32 (csrc/mlp.cu kWgK)
_TC_SPLITS, _TC_ROW_STEP = 12, 32
# the wide bf16 route's Hopper kernels (csrc/mlp.cu): the N tiles of the
# dual product and the weight gradients (their rows: gemm.py's _HG_BM)
_DUAL_N, _WGRAD_N = 128, 128
# the split rule's model: a 64-row step of a 128 x 128 weight-gradient tile
# at ~5 TFLOP/s an SM, and each split's fp32 partials written and read back
# at ~3 TB/s
_STEP_US = 2 * 128 * 128 * 64 / 5e12 * 1e6
_PART_US_PER_BYTE = 1e6 / 3e12
_MAX_SPLITS = 16
FMA, TENSOR_CORE = "fma", "tensor_core"
_INV_SQRT_2PI = 0.3989422804014327


def wgrad_splits(rows: int, dim: int, f: int) -> int:
    """Row splits of the bf16 wide route's weight gradients: fixed by the
    shape alone. At least enough that the units (2 products x its 128 x 128
    tiles x splits) cover the card where the rows allow it, no split empty,
    and of those the least modelled time: rounds of units over ``_SMS`` times
    the steps a split, plus the partials' traffic a split."""
    steps = _cdiv(rows, _HG_BK)
    tiles = 2 * (dim // _HG_BM) * _cdiv(f, _WGRAD_N)
    best, best_cost = None, None
    for s in range(min(steps, _cdiv(_SMS, tiles)), min(steps, _MAX_SPLITS) + 1):
        per = _cdiv(steps, s)
        if _cdiv(steps, per) < s:  # a split would be empty
            continue
        cost = (_cdiv(tiles * s, _SMS) * per * _STEP_US
                + s * 16 * dim * f * _PART_US_PER_BYTE)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best if best is not None else 1


class MlpPlan:
    """The launches of one ``fused_mlp`` / ``fused_mlp_bwd`` call: route,
    row splits of the weight gradients, the scratch of each direction as
    ``{name: (shape, dtype)}``, the tiles of each product of the bf16 wide
    route as ``{product: (m_tiles, n_tiles, n_tile)}`` (and ``units``, the
    weight gradients' blocks), and ``writes``: the elements each kernel writes into each
    backward scratch, from its grid and masks."""

    def __init__(self, dtype: torch.dtype, rows: int, dim: int, f: int):
        self.route = mlp_route(dtype, dim, f)
        self.rows, self.dim, self.f = rows, dim, f
        self.wide = dim > _WIDE
        bf16 = self.route == TENSOR_CORE
        count = 2 * f * dim + f + dim  # dW1, dW2, db1, db2
        if bf16 and self.wide:
            self.splits = wgrad_splits(rows, dim, f)
            self.split_rows = _cdiv(_cdiv(rows, _HG_BK), self.splits) * _HG_BK
        elif bf16:
            self.splits = max(1, min(_TC_SPLITS, _cdiv(rows, _TC_ROW_STEP)))
            self.split_rows = _cdiv(_cdiv(rows, _TC_ROW_STEP), self.splits) * _TC_ROW_STEP
        else:
            self.splits = max(1, min(_SPLITS, _cdiv(rows, _ROW_TILE)))
            self.split_rows = _cdiv(rows, self.splits)
        f32 = torch.float32
        self.fwd_scratch = {"hidden": ((rows, f), dtype)} if self.wide else {}
        self.bwd_scratch = {"part": ((self.splits, count), f32), "grads": ((count,), f32)}
        self.writes = {"part": self.splits * count, "grads": count}
        if bf16 or self.wide:  # dH, then a_used
            self.bwd_scratch["hidden"] = ((2, rows, f), dtype)
            self.writes["hidden"] = 2 * rows * f
        if self.wide and not bf16:  # the fp32 route's dA = g W2
            self.bwd_scratch["da"] = ((rows, f), f32)
            self.writes["da"] = rows * f
        self.tiles = {}
        if bf16 and self.wide:
            self.tiles["fc2"] = light_tiles(rows, dim, False)
            self.tiles["dx"] = light_tiles(rows, dim, True)
            self.tiles["fc1"] = heavy_tiles(rows, f)
            self.tiles["h_da"] = (_cdiv(rows, _HG_BM), _cdiv(f, _DUAL_N), _DUAL_N)
            wg = (dim // _HG_BM, _cdiv(f, _WGRAD_N), _WGRAD_N)
            self.tiles["wgrad"] = wg
            self.units = 2 * wg[0] * wg[1] * self.splits


def mlp_plan(dtype: torch.dtype, rows: int, dim: int, f: int) -> MlpPlan:
    """The launch plan of ``fused_mlp`` and ``fused_mlp_bwd`` on ``rows`` rows
    of this dtype and width, hidden width ``f``; raises as ``mlp_route``."""
    return MlpPlan(dtype, rows, dim, f)


def _scratch(spec: dict, device) -> dict:
    return {name: torch.empty(shape, dtype=dt, device=device)
            for name, (shape, dt) in spec.items()}


def gelu_as_grad(x: torch.Tensor) -> torch.Tensor:
    """d gelu / dx in fp32, for x in the compute dtype."""
    xf = x.float()
    cdf = 0.5 * (1.0 + erf_as(xf * _SQRT_HALF))
    return cdf + xf * (torch.exp(-0.5 * xf * xf) * _INV_SQRT_2PI)


def mlp_route(dtype: torch.dtype, dim: int, f: int) -> str:
    """The kernels a CUDA launch of ``fused_mlp`` (the forward) or
    ``fused_mlp_bwd`` takes for rows of this dtype, width ``dim`` and hidden
    width ``f``; both launches take the same route: ``"fma"`` (fp32: FMA on
    fp32 tiles, which keeps fp32's agreement where tensor cores would mean
    TF32) or ``"tensor_core"`` (bf16: ``mma`` on bf16 tiles, f a multiple of
    8, since the weights' hidden columns are copied in 16-byte chunks).
    Raises on what neither takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"fused_mlp takes float32 or bfloat16, got {dtype}")
    if dim not in _DIMS:
        raise ValueError(f"fused_mlp takes width in {_DIMS}, got {dim}")
    if dtype == torch.float32:
        return FMA
    if f < 1 or f % 8:
        raise ValueError(f"fused_mlp takes a bfloat16 hidden width that is a multiple of 8, "
                         f"got {f}")
    return TENSOR_CORE


def _keep_mask(seed: int, rows: int, f: int, dropout_p: float, device) -> torch.Tensor:
    return hash_keep_mask(seed, 0, (rows, f), dropout_p, device=device)


def _hidden(x2, w1, b1, activation):
    """(pre-activation h, activation a) of the rows x2 [rows, dim], in x's dtype."""
    if activation != "gelu":
        raise ValueError(f"the fused FFN kernels compute gelu, not {activation}")
    h = torch.matmul(x2.float(), w1.float().t()).to(x2.dtype) + b1
    return h, gelu_as(h)


def fused_mlp_reference(x, w1, b1, w2, b2, activation: str = "gelu", dropout_p: float = 0.0,
                        seed: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the ``fused_mlp`` forward, differentiable by
    autograd: x [..., dim] -> [..., dim] in x.dtype (weights cast to it)."""
    dt, dim = x.dtype, x.shape[-1]
    w1, b1, w2, b2 = (t.to(dt) for t in (w1, b1, w2, b2))
    x2 = x.reshape(-1, dim)
    _, a = _hidden(x2, w1, b1, activation)
    if dropout_p:
        keep = _keep_mask(seed, x2.shape[0], w1.shape[0], dropout_p, x.device)
        a = torch.where(keep, a * torch.tensor(keep_scale(dropout_p), dtype=dt), 0.0).to(dt)
    y = torch.matmul(a.float(), w2.float().t()).to(dt) + b2
    return y.reshape(x.shape)


def fused_mlp_bwd_reference(x, w1, b1, w2, g, activation: str = "gelu", dropout_p: float = 0.0,
                            seed: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the ``fused_mlp`` backward: (dx, dw1, db1,
    dw2, db2) for the output cotangent g; dx in x.dtype, the weight and bias
    gradients fp32 sums rounded to x.dtype. The weights are in x.dtype."""
    dt, dim = x.dtype, x.shape[-1]
    x2, g2 = x.reshape(-1, dim), g.reshape(-1, dim)
    h, a = _hidden(x2, w1, b1, activation)
    da = torch.matmul(g2.float(), w2.float())  # [rows, f]
    if dropout_p:
        keep = _keep_mask(seed, x2.shape[0], w1.shape[0], dropout_p, x.device)
        a = torch.where(keep, a * torch.tensor(keep_scale(dropout_p), dtype=dt), 0.0).to(dt)
        da = torch.where(keep, da * torch.tensor(keep_scale(dropout_p), dtype=torch.float32), 0.0)
    dh = (da * gelu_as_grad(h)).to(dt).float()
    dw2 = torch.matmul(g2.float().t(), a.float())
    dw1 = torch.matmul(dh.t(), x2.float())
    dx = torch.matmul(dh, w1.float()).to(dt)
    return (dx.reshape(x.shape), dw1.to(dt), dh.sum(dim=0).to(dt), dw2.to(dt),
            g2.float().sum(dim=0).to(dt))


def _check_mlp(name, x, w1, b1, w2, activation):
    _require_cuda("x", x)
    if activation != "gelu":
        raise ValueError(f"the fused FFN kernels compute gelu, not {activation}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    dim, f = x.shape[-1], w1.shape[0]
    if dim not in _DIMS:
        raise ValueError(f"{name} takes width in {_DIMS}, got {dim}")
    _check("x", x, x.dtype, x.shape)
    _check("w1", w1, x.dtype, (f, dim))
    _check("b1", b1, x.dtype, (f,))
    _check("w2", w2, x.dtype, (dim, f))
    return x.numel() // dim, dim, f


def _check_aligned(name, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the tensor-core kernels copy 16-byte chunks; an operand is "
                         f"not 16-byte aligned")


def _mlp_forward(x, w1, b1, w2, b2, activation, dropout_p, seed):
    """The forward alone, weights in x.dtype: the kernel on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2, activation, dropout_p, seed)
    rows, dim, f = _check_mlp("fused_mlp", x, w1, b1, w2, activation)
    plan = mlp_plan(x.dtype, rows, dim, f)
    _check("b2", b2, x.dtype, (dim,))
    if plan.route == TENSOR_CORE:
        _check_aligned("fused_mlp", x, w1, w2)
    out = torch.empty_like(x)
    hidden = _scratch(plan.fwd_scratch, x.device).get("hidden")  # the wide route's a_used
    err = _build.library().sn_fused_mlp(
        _DTYPES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), hidden.data_ptr() if hidden is not None else None, rows,
        dim, f, *kernel_dropout_args(dropout_p, seed), _stream(),
    )
    _build.check(err, "fused_mlp")
    fused_mlp.launches += 1
    if plan.route == TENSOR_CORE:
        fused_mlp.tc_launches += 1
    if plan.wide:
        fused_mlp.wide_launches += 1
    return out


def fused_mlp_bwd(x, w1, b1, w2, g, activation: str = "gelu", dropout_p: float = 0.0,
                  seed: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """(dx, dw1, db1, dw2, db2) of ``fused_mlp`` for the output cotangent g,
    weights in x.dtype: the kernels on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_reference(x, w1, b1, w2, g, activation, dropout_p, seed)
    rows, dim, f = _check_mlp("fused_mlp_bwd", x, w1, b1, w2, activation)
    plan = mlp_plan(x.dtype, rows, dim, f)
    _check("g", g, x.dtype, x.shape)
    if plan.route == TENSOR_CORE:
        _check_aligned("fused_mlp_bwd", x, w1, w2, g)
    dx = torch.empty_like(x)
    sc = _scratch(plan.bwd_scratch, x.device)
    hidden, da = sc.get("hidden"), sc.get("da")
    err = _build.library().sn_fused_mlp_bwd(
        _DTYPES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), g.data_ptr(),
        dx.data_ptr(), sc["part"].data_ptr(), sc["grads"].data_ptr(),
        hidden.data_ptr() if hidden is not None else None,
        da.data_ptr() if da is not None else None, rows, dim, f, plan.splits,
        *kernel_dropout_args(dropout_p, seed), _stream(),
    )
    _build.check(err, "fused_mlp_bwd")
    fused_mlp_bwd.launches += 1
    if plan.route == TENSOR_CORE:
        fused_mlp_bwd.tc_launches += 1
    if plan.wide:
        fused_mlp_bwd.wide_launches += 1
    dw1, dw2, db1, db2 = torch.split(sc["grads"], [f * dim, f * dim, f, dim])
    dt = x.dtype
    return dx, dw1.view(f, dim).to(dt), db1.to(dt), dw2.view(dim, f).to(dt), db2.to(dt)


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation, dropout_p, seed):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.args = (activation, dropout_p, seed)
        return _mlp_forward(x, w1, b1, w2, b2, activation, dropout_p, seed)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_mlp_bwd(x, w1, b1, w2, g.contiguous(), *ctx.args)
        return dx, dw1, db1, dw2, db2, None, None, None


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, activation: str = "gelu", dropout_p: float = 0.0,
              seed: Optional[int] = None) -> torch.Tensor:
    """``drop(gelu(x W1^T + b1)) W2^T + b2`` on x [..., dim] (float32 or
    bfloat16), weights in ``nn.Linear`` layout (w1 [f, dim], w2 [dim, f]) of
    any float dtype; differentiable in x and the weights. With
    ``dropout_p > 0``, FFN dropout keyed on the int32 ``seed``."""
    if dropout_p and seed is None:
        raise ValueError("fused_mlp: dropout needs a seed")
    # the weights in the compute dtype, outside the kernel, as flax Dense and
    # the JAX package cast them: their gradients come back through the cast
    w1, b1, w2, b2 = (t.to(x.dtype).contiguous() for t in (w1, b1, w2, b2))
    return _FusedMlp.apply(x, w1, b1, w2, b2, activation, float(dropout_p), seed)


fused_mlp.launches = fused_mlp.tc_launches = fused_mlp.wide_launches = 0
fused_mlp_bwd.launches = fused_mlp_bwd.tc_launches = fused_mlp_bwd.wide_launches = 0
