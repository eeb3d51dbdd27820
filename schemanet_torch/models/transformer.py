"""Pre- or post-norm Transformer encoder with declarative activation capture.

Port of ``schemanet_tpu/models/transformer.py``, in three routes: the frozen
forward, its int8 (W8A8) variant and the training forward. Probe names:

    layers_{i}.out        — output sequence of encoder layer i
    layers_{i}.attn_hmean — head-mean of the pre-softmax scaled scores [bs, n, n]
    layers_{i}.attn       — softmax attention [bs, H, n, n]
    layers_{i}.attn_raw   — pre-softmax scaled scores [bs, H, n, n]
    layers_{i}.resid1     — the sequence after the attention residual
    layers_{i}.resid2     — the sequence after the FFN residual
                            (all but ``out``: deterministic forwards only)

A layer is pre-norm (``x + attn(LN1(x))``, then ``y + ffn(LN2(y))``) or,
with ``pre_norm=False``, post-norm (``x + LN1(attn(x))``, then ``y +
LN2(ffn(y))``); a post-norm stack applies its final norm first, at the
stack's start (``start_layer == 0``), and not at its end. ``attn_mask`` is
an additive float mask on every layer's scores.

Deterministic (frozen) forward, as serving and the SchemaNet backbone run it:
on CUDA every pre-norm mask-free layer takes the two hand-written kernels
(``ops/kernels/encoder_block.py``), and layer i's ``attn_hmean`` comes out of
the ``attn_block`` kernel itself. A layer with ``attn``, ``attn_raw``,
``resid1`` or ``resid2`` captured runs the plain per-op path instead (the
kernels keep none of them), and so does every pre-norm mask-free layer on
the CPU; there ``attn_hmean`` is the fp32 mean over heads of the raw scores.
Whole-layer fusion declines for post-norm and for a mask, as in the JAX
package: such a layer takes the per-op route with the port's kernels
(``fused_mhsa`` at p = 0, or the per-op attention where ``attn_hmean`` is
captured or a mask is given, since the attention kernels take no mask;
``fused_layernorm`` for both norms; ``fused_mlp``), their plain versions on
the CPU.

W8A8 frozen forward (``quant=True``: stage-1 extraction, serving, the
SchemaNet backbone under ``schema_net.quant_backbone``): as in the JAX
package the whole-layer kernels give way to the per-op route, with
``fused_layernorm`` for both norms, the four projections int8
(``ops/quant.py``: ``quantize_rows`` of x and of the weight, then
``int8_gemm``), ``fused_mhsa`` at p = 0 between qkv and out, the activation
as the plain op between fc1 and fc2. A layer with ``attn_hmean``, ``attn``
or ``attn_raw`` captured, or a mask, takes the plain per-op attention
between its int8 projections (the head-mean from ``attn_raw``); ``resid1``
and ``resid2`` come with every layer. On the CPU the kernels' plain
versions run.

Training forward (``deterministic=False``), as stage 0 runs it:
``fused_layernorm``, ``fused_mhsa`` (attention dropout in the kernel),
residual dropout, ``fused_layernorm``, ``fused_mlp`` (FFN dropout in the
kernel), residual dropout, in the layer's norm order; differentiable
through the kernels' backward kernels. A masked layer's attention is the
per-op one, its dropout on the probabilities. Dropout draws from the
caller's ``DropoutRNG``; on a data-parallel grid each rank's masks are the
global batch's for its items (the kernels' streams and rows offset by its
first item, the residual masks drawn for the global batch). The final norm
is ``fused_layernorm`` in both forwards.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import policy
from ..ops.kernels import encoder_block as eb
from ..ops.kernels import layernorm as lnk
from ..parallel.mesh import gathered
from .attention import MultiHeadSelfAttention
from .layers import MLP, Dropout, DropoutRNG

Parts = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor,
              torch.Tensor]


def layer_norm_site(x: torch.Tensor, ln: nn.LayerNorm, eps: float) -> torch.Tensor:
    """The backbone's LayerNorm: ``fused_layernorm``, or its plain version
    where the policy's ``ln`` is plain."""
    fn = lnk.fused_layernorm if policy.routes().ln else lnk.fused_layernorm_plain
    return fn(x, ln.weight, ln.bias, eps)


class EncoderLayer(nn.Module):
    def __init__(self, num_heads: int, embed_dim: int, dim_feedforward: int,
                 activation: str = "gelu", norm_eps: float = 1e-6,
                 dropout: Optional[float] = None, pre_norm: bool = True):
        super().__init__()
        self.num_heads, self.activation, self.norm_eps = num_heads, activation, norm_eps
        self.pre_norm = pre_norm
        self.attention = MultiHeadSelfAttention(num_heads, embed_dim, dropout)
        self.mlp = MLP(embed_dim, dim_feedforward, activation, dropout)
        self.norm1 = nn.LayerNorm(embed_dim, eps=norm_eps)
        self.norm2 = nn.LayerNorm(embed_dim, eps=norm_eps)
        self.drop = Dropout(dropout) if dropout else None

    def forward(self, seq: torch.Tensor, capture_hmean: bool = False, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None, plain: bool = False, quant: bool = False,
                attn_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(output, probes). ``plain`` asks for the per-op path of a frozen
        forward on any device, which alone gives the ``PLAIN_PROBES``; with
        ``quant`` (the W8A8 frozen forward) it asks for the per-op attention,
        which alone gives the attention maps."""
        if not deterministic:
            if capture_hmean or plain or quant:
                raise ValueError("the training forward has only the out probe, and no int8 route")
            out = self._train_forward(seq, rng, attn_mask)
            return out, {"out": out}
        if quant:
            return self._probes(*self._quant_forward(seq, plain or capture_hmean, attn_mask),
                                capture_hmean)
        if (not plain and seq.is_cuda and self.pre_norm and attn_mask is None
                and policy.routes().block):
            return self._block_forward(seq, capture_hmean)
        if not plain and (seq.is_cuda or not self.pre_norm):
            return self._probes(*self._kernel_forward(seq, capture_hmean, attn_mask),
                                capture_hmean)
        # the plain per-op path: probes, or the CPU's pre-norm forward
        parts = self._compose(seq, lambda x: self.attention(x, attn_mask),
                              lambda ln, x: eb.layer_norm(x, ln.weight, ln.bias, self.norm_eps),
                              self.mlp)
        return self._probes(*parts, capture_hmean)

    def _norm_kernel(self, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_site(x, ln, self.norm_eps)

    def _compose(self, seq: torch.Tensor, attend: Callable, norm: Callable, ffn: Callable,
                 drop: Optional[Callable] = None) -> Parts:
        """The layer from its parts, in its norm order: ``attend(x)`` ->
        (x, attn, attn_raw), ``norm(ln, x)``, ``ffn(x)``, and ``drop(x)``
        the residual dropout of a training forward. (out, attn, attn_raw,
        resid1, resid2); the residual probes are the sums before dropout."""
        n1, n2 = self.norm1, self.norm2
        if self.pre_norm:
            x, attn, attn_raw = attend(norm(n1, seq))
        else:
            x, attn, attn_raw = attend(seq)
            x = norm(n1, x)
        resid1 = seq + x
        seq = resid1 if drop is None else seq + drop(x)
        x = ffn(norm(n2, seq)) if self.pre_norm else norm(n2, ffn(seq))
        resid2 = seq + x
        seq = resid2 if drop is None else seq + drop(x)
        return seq, attn, attn_raw, resid1, resid2

    @staticmethod
    def _probes(out, attn, attn_raw, resid1, resid2, capture_hmean
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        probes = {"out": out, "resid1": resid1, "resid2": resid2}
        if attn_raw is not None:
            probes.update(attn=attn, attn_raw=attn_raw)
            if capture_hmean:
                probes["attn_hmean"] = attn_raw.float().mean(dim=1).to(attn_raw.dtype)
        return out, probes

    def _kernel_forward(self, seq: torch.Tensor, maps: bool,
                        attn_mask: Optional[torch.Tensor] = None) -> Parts:
        """The frozen per-op route on the port's kernels (a post-norm or a
        masked layer's): ``fused_mhsa`` at p = 0, or with ``maps`` or a mask
        the per-op attention, ``fused_layernorm``, ``fused_mlp`` at p = 0."""
        a = self.attention
        if maps or attn_mask is not None:
            attend = lambda x: a(x, attn_mask)  # noqa: E731
        else:
            attend = lambda x: (a.fused(x), None, None)  # noqa: E731
        return self._compose(seq, attend, self._norm_kernel, self.mlp.fused)

    def _train_forward(self, seq: torch.Tensor, rng: Optional[DropoutRNG],
                       attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The layer through the fused attention and FFN kernels and
        ``fused_layernorm``, with dropout in both kernels and on both
        residual branches when live; a mask takes the per-op attention
        (dropout on its probabilities)."""
        live = self.drop is not None
        if live and rng is None:
            raise ValueError("a training forward with dropout needs a DropoutRNG")
        item0 = rng.item0 if live else 0
        drop = (lambda x: self.drop(x, rng.masks, rng.rows)) if live else None

        def attend(x):
            if attn_mask is not None:
                return self.attention(x, attn_mask, drop)
            return self.attention.fused(x, rng.kernel_seed() if live else None, item0), None, None

        def ffn(x):
            return self.mlp.fused(x, rng.kernel_seed() if live else None, item0 * x.shape[1])

        return self._compose(seq, attend, self._norm_kernel, ffn, drop)[0]

    def _quant_forward(self, seq, maps, attn_mask) -> Parts:
        """The W8A8 layer: ``fused_layernorm`` for both norms, the int8
        attention half and the int8 FFN, in the layer's norm order; the
        attention maps (and ``attn_hmean``, their fp32 mean over heads)
        only where ``maps`` or a mask asks for the per-op attention."""
        return self._compose(seq, lambda x: self.attention.quant(x, maps, attn_mask),
                             self._norm_kernel, self.mlp.quant)

    def _block_forward(self, seq, capture_hmean):
        """Whole-layer fusion: the attention half and the FFN half are one
        hand-written kernel each."""
        a, m = self.attention, self.mlp
        out = eb.attn_block(
            seq, self.norm1.weight, self.norm1.bias, gathered(a.linear_qkv.weight),
            gathered(a.linear_qkv.bias), gathered(a.linear_out.weight), a.linear_out.bias,
            self.num_heads, eps=self.norm_eps, capture_hmean=capture_hmean,
        )
        probes = {}
        if capture_hmean:
            out, probes["attn_hmean"] = out
        out = eb.ffn_block(
            out, self.norm2.weight, self.norm2.bias,
            gathered(m.linear1.weight), gathered(m.linear1.bias), gathered(m.linear2.weight),
            m.linear2.bias, eps=self.norm_eps, activation=self.activation,
        )
        probes["out"] = out
        return out, probes


# the probes only the plain per-op path keeps
PLAIN_PROBES = ("attn", "attn_raw", "resid1", "resid2")
# the probes only the per-op attention keeps (the int8 route's choice)
MAP_PROBES = ("attn", "attn_raw", "attn_hmean")


class Transformer(nn.Module):
    """Pre- or post-norm encoder stack with an optional final LayerNorm."""

    def __init__(self, num_encoder_layers=12, num_heads=8, embed_dim=512, dim_feedforward=2048,
                 activation="gelu", final_norm=True, norm_eps=1e-6, dropout=None,
                 pre_norm=True):
        super().__init__()
        self.num_encoder_layers, self.norm_eps = num_encoder_layers, norm_eps
        self.pre_norm = pre_norm
        self.layers = nn.ModuleList(
            EncoderLayer(num_heads, embed_dim, dim_feedforward, activation, norm_eps, dropout,
                         pre_norm)
            for _ in range(num_encoder_layers)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=norm_eps) if final_norm else None

    def _final_norm(self, seq: torch.Tensor) -> torch.Tensor:
        return layer_norm_site(seq, self.norm, self.norm_eps)

    def run(
        self,
        seq: torch.Tensor,
        capture: Tuple[str, ...] = (),
        start_layer: int = 0,
        end_layer: Optional[int] = None,
        deterministic: bool = True,
        rng: Optional[DropoutRNG] = None,
        quant: bool = False,
        attn_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Layers [start_layer, end_layer); the final norm only when the stack
        runs to its end (pre-norm), or only from its start (post-norm).
        ``deterministic=False`` is the training forward, ``quant`` the W8A8
        frozen forward; ``attn_mask`` an additive mask on every layer's
        scores."""
        end_layer = self.num_encoder_layers if end_layer is None else end_layer
        captured: Dict[str, torch.Tensor] = {}
        if not self.pre_norm and self.norm is not None and start_layer == 0:
            seq = self._final_norm(seq)
        for i in range(start_layer, end_layer):
            kinds = MAP_PROBES if quant else PLAIN_PROBES
            plain = any(f"layers_{i}.{kind}" in capture for kind in kinds)
            seq, probes = self.layers[i](seq, f"layers_{i}.attn_hmean" in capture, deterministic,
                                         rng, plain, quant, attn_mask)
            for kind, value in probes.items():
                if f"layers_{i}.{kind}" in capture:
                    captured[f"layers_{i}.{kind}"] = value
        if self.pre_norm and self.norm is not None and end_layer == self.num_encoder_layers:
            seq = self._final_norm(seq)
        return seq, captured
