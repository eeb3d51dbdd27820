"""The relu gate of the ``fused_mlp`` backward, for holding the kernels to
their plain versions.

relu' = (h > 0) is a step. Where the fp32 sum x W1^T lies within two
summation orders' rounding of the point where the gate opens, the kernel and
its plain version may set a hidden element's gate apart, and that element's
dH is dA on one side and 0 on the other: dx moves by |dA| |W1[j]|, far
beyond a rounding. So the relu backward is held to its plain version in
lock step, the plain version given the kernel's gate
(``fused_mlp_bwd_reference(..., gate=)``), with the plain tolerance; and
every gate the two set apart must be a candidate of ``gate_candidates``,
which a kernel that rounds h otherwise than the TPU kernel would break.

Used by ``chip_smoke.py`` phases 47 and 49 and by the card test
``test_ffn_kernels_relu``. Imports no JAX.
"""

from __future__ import annotations

import math

import torch

from schemanet_torch.ops.kernels import mlp as mk

EPS32 = torch.finfo(torch.float32).eps


def gate_candidates(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """The hidden elements [rows, f] whose gate two fp32 summation orders of
    x W1^T may set apart: the gate round(round(acc) + b1) > 0 (h as the
    kernels and the plain version round it, in x's dtype) differs between
    the two ends of [acc - e, acc + e], where acc is the fp64 sum and
    e = dim * eps32 * sum |x| |w1| bounds the error of any fp32 order
    (twice the recursive-summation bound n u, for tensor cores' truncating
    adds). The gate is monotone in acc, so the two ends decide."""
    dt, dim = x.dtype, x.shape[-1]
    x2, w = x.reshape(-1, dim).double(), w1.double()
    acc = x2 @ w.t()
    e = dim * EPS32 * (x2.abs() @ w.abs().t())
    lo = torch.nextafter((acc - e).float(), torch.tensor(-math.inf, device=x.device))
    hi = torch.nextafter((acc + e).float(), torch.tensor(math.inf, device=x.device))
    b = b1.to(dt)

    def gate(a):
        return (a.to(dt) + b) > 0

    return gate(lo) != gate(hi)


def plain_gate(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """The gate (h > 0) [rows, f] that ``fused_mlp_bwd_reference`` takes."""
    h, _ = mk._hidden(x.reshape(-1, x.shape[-1]), w1.to(x.dtype), b1.to(x.dtype), "relu")
    return h > 0


def kernel_gate(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor
                ) -> torch.Tensor:
    """The gate [rows, f] that the ``fused_mlp_bwd`` kernel takes on these
    inputs, read from its dW2 = g^T
    a_used: with a cotangent whose row r0 + c is e_c and whose other rows
    are 0, dW2[c] is a_used[r0 + c] exactly (one product by 1, the rest
    zeros), and a_used = relu(h) is above 0 where the gate is open. The
    kernel recomputes h on the same x, W1 and b1 at the same shape; the
    cotangent and the dropout, which it reads only after h, change. dim
    rows a call."""
    dim = x.shape[-1]
    rows, f = x.numel() // dim, w1.shape[0]
    eye = torch.eye(dim, dtype=x.dtype, device=x.device)
    g = torch.zeros(rows, dim, dtype=x.dtype, device=x.device)
    gate = torch.empty(rows, f, dtype=torch.bool, device=x.device)
    for r0 in range(0, rows, dim):
        n = min(dim, rows - r0)
        g.zero_()
        g[r0:r0 + n] = eye[:n]
        dw2 = mk.fused_mlp_bwd(x, w1, b1, w2, g.view(x.shape), "relu")[3]
        gate[r0:r0 + n] = dw2[:n] > 0
    return gate


def gate_flips(kernel: torch.Tensor, x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor
               ) -> dict:
    """The kernel's gate against the plain version's: how many elements the
    two set apart, how many candidates ``gate_candidates`` names, and how
    many of the set-apart elements are not candidates (0 when the kernel
    rounds h as the TPU kernel does)."""
    flips = kernel != plain_gate(x, w1, b1)
    cand = gate_candidates(x, w1, b1)
    return {"gate_flips": int(flips.sum()), "gate_candidates": int(cand.sum()),
            "flips_outside_candidates": int((flips & ~cand).sum())}
