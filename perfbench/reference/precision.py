"""How the reference computes.

``fp32``: float32 with TF32 off (the reference). ``tf32``: the same code
with TF32 on for matrix products and convolutions (the control of an fp32
configuration); the operands of the products routed through ``mm``, ``lin``
and ``r`` are also rounded to TF32's 10-bit mantissa explicitly, so the
control rounds the same way on a CPU, which has no TF32. ``fp8``: float8
e4m3 under a per-tensor scale for every value the computation stores (the
control of a bf16 configuration): inside ``compute()`` every floating
result of every operation, forward and backward, is rounded to e4m3 (a bf16
program rounds the same results to bf16), and the products' operands,
weights included, are rounded as they enter (``r``, ``mm``, ``lin``); the
backward passes the operands' rounding straight through. Each operation
computes in fp32 before its result rounds, as a bf16 kernel accumulates in
fp32.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

E4M3_MAX = 448.0
NAMES = ("fp32", "tf32", "fp8")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (its largest finite
    magnitude at 448); non-finite values kept."""
    finite = torch.isfinite(x)
    amax = torch.where(finite, x.abs(), torch.zeros_like(x)).amax().float()
    scale = torch.clamp(amax, min=1e-30) / E4M3_MAX
    q = (torch.where(finite, x, torch.zeros_like(x)) / scale).to(torch.float8_e4m3fn)
    return torch.where(finite, (q.float() * scale).to(x.dtype), x)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to the nearest TF32 value (10 mantissa bits, ties to
    even)."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    out = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x.float()).to(x.dtype)


def _ste(x: torch.Tensor, rounding) -> torch.Tensor:
    with torch.no_grad():
        q = rounding(x.detach())
    return x + (q - x.detach())


def _stored(t):
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.dtype != torch.float8_e4m3fn and t.numel() > 0)


class _StoreFp8(TorchDispatchMode):
    """Every floating result of every operation rounded to e4m3: a new
    result as it is, a result written into an argument in place there; a
    view of an argument is left alone (its base is already rounded)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        if any(r.alias_info is not None for r in schema.returns):
            for i, a in enumerate(schema.arguments):
                if a.alias_info is not None and a.alias_info.is_write:
                    t = args[i] if i < len(args) else kwargs.get(a.name)
                    if _stored(t):
                        t.copy_(fp8_round(t))
            return out
        return tree_map(lambda t: fp8_round(t) if _stored(t) else t, out)


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in NAMES:
            raise ValueError(f"precision {name!r} not in {NAMES}")
        self.name = name

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, rounded as this precision stores it."""
        if self.name == "fp8":
            return _ste(x, fp8_round)
        if self.name == "tf32":
            return _ste(x, tf32_round)
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.r(a), self.r(b))

    def lin(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        y = torch.matmul(self.r(x), self.r(w).t())
        return y if b is None else y + b

    @contextlib.contextmanager
    def scope(self):
        """TF32 on only for ``tf32``; off otherwise, whatever it was."""
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    @contextlib.contextmanager
    def compute(self):
        """The model's forward and backward: under ``fp8`` every stored value
        rounds; a no-op otherwise."""
        if self.name != "fp8":
            yield self
            return
        with _StoreFp8():
            yield self
