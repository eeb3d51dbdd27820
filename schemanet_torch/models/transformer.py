"""Pre-norm Transformer encoder with declarative activation capture.

Port of ``schemanet_tpu/models/transformer.py`` for the mask-free pre-norm
stack, in three routes: the frozen forward, its int8 (W8A8) variant and the
training forward. Probe names:

    layers_{i}.out        — output sequence of encoder layer i
    layers_{i}.attn_hmean — head-mean of the pre-softmax scaled scores [bs, n, n]
    layers_{i}.attn       — softmax attention [bs, H, n, n]
    layers_{i}.attn_raw   — pre-softmax scaled scores [bs, H, n, n]
    layers_{i}.resid1     — the sequence after the attention residual
    layers_{i}.resid2     — the sequence after the FFN residual
                            (all but ``out``: deterministic forwards only)

Deterministic (frozen) forward, as serving and the SchemaNet backbone run it:
on CUDA every layer takes the two hand-written kernels
(``ops/kernels/encoder_block.py``), and layer i's ``attn_hmean`` comes out of
the ``attn_block`` kernel itself. A layer with ``attn``, ``attn_raw``,
``resid1`` or ``resid2`` captured runs the plain per-op path instead, as in
the JAX package (the kernels keep none of them), and so does every layer on
the CPU; there ``attn_hmean`` is the fp32 mean over heads of the raw scores.

W8A8 frozen forward (``quant=True``: stage-1 extraction, serving, the
SchemaNet backbone under ``schema_net.quant_backbone``): as in the JAX
package the whole-layer kernels give way to the per-op route, with
``fused_layernorm`` for both norms, the four projections int8
(``ops/quant.py``: ``quantize_rows`` of x and of the weight, then
``int8_gemm``), ``fused_mhsa`` at p = 0 between qkv and out, gelu as the
plain op between fc1 and fc2. A layer with ``attn_hmean``, ``attn`` or
``attn_raw`` captured takes the plain per-op attention between its int8
projections (the head-mean from ``attn_raw``); ``resid1`` and ``resid2``
come with every layer. On the CPU the kernels' plain versions run.

Training forward (``deterministic=False``), as stage 0 runs it:
``fused_layernorm``, ``fused_mhsa`` (attention dropout in the kernel),
residual dropout, ``fused_layernorm``, ``fused_mlp`` (FFN dropout in the
kernel), residual dropout; differentiable through the kernels' backward
kernels. Dropout draws from the caller's ``DropoutRNG``; on a data-parallel
grid each rank's masks are the global batch's for its items (the kernels'
streams and rows offset by its first item, the residual masks drawn for the
global batch). The final norm is
``fused_layernorm`` in both forwards.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.kernels import encoder_block as eb
from ..ops.kernels import layernorm as lnk
from ..parallel.mesh import gathered
from .attention import MultiHeadSelfAttention
from .layers import MLP, Dropout, DropoutRNG


class EncoderLayer(nn.Module):
    def __init__(self, num_heads: int, embed_dim: int, dim_feedforward: int,
                 activation: str = "gelu", norm_eps: float = 1e-6,
                 dropout: Optional[float] = None):
        super().__init__()
        self.num_heads, self.activation, self.norm_eps = num_heads, activation, norm_eps
        self.attention = MultiHeadSelfAttention(num_heads, embed_dim, dropout)
        self.mlp = MLP(embed_dim, dim_feedforward, activation, dropout)
        self.norm1 = nn.LayerNorm(embed_dim, eps=norm_eps)
        self.norm2 = nn.LayerNorm(embed_dim, eps=norm_eps)
        self.drop = Dropout(dropout) if dropout else None

    def forward(self, seq: torch.Tensor, capture_hmean: bool = False, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None, plain: bool = False, quant: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(output, probes). ``plain`` asks for the per-op path of a frozen
        forward on any device, which alone gives the ``PLAIN_PROBES``; with
        ``quant`` (the W8A8 frozen forward) it asks for the per-op attention,
        which alone gives the attention maps."""
        if not deterministic:
            if capture_hmean or plain or quant:
                raise ValueError("the training forward has only the out probe, and no int8 route")
            out = self._train_forward(seq, rng)
            return out, {"out": out}
        if quant:
            return self._quant_forward(seq, capture_hmean, plain)
        if seq.is_cuda and not plain:
            return self._block_forward(seq, capture_hmean)
        n1, n2 = self.norm1, self.norm2
        x, attn, attn_raw = self.attention(eb.layer_norm(seq, n1.weight, n1.bias, self.norm_eps))
        seq = seq + x
        resid1 = seq
        seq = seq + self.mlp(eb.layer_norm(seq, n2.weight, n2.bias, self.norm_eps))
        probes = {"out": seq, "attn": attn, "attn_raw": attn_raw, "resid1": resid1,
                  "resid2": seq}
        if capture_hmean:
            probes["attn_hmean"] = attn_raw.float().mean(dim=1).to(attn_raw.dtype)
        return seq, probes

    def _train_forward(self, seq: torch.Tensor, rng: Optional[DropoutRNG]) -> torch.Tensor:
        """Pre-norm layer through the fused attention and FFN kernels, with
        dropout in both kernels and on both residual branches when live."""
        live = self.drop is not None
        if live and rng is None:
            raise ValueError("a training forward with dropout needs a DropoutRNG")
        n1, n2 = self.norm1, self.norm2
        item0 = rng.item0 if live else 0
        x = self.attention.fused(lnk.fused_layernorm(seq, n1.weight, n1.bias, self.norm_eps),
                                 rng.kernel_seed() if live else None, item0)
        seq = seq + (self.drop(x, rng.masks, rng.rows) if live else x)
        x = self.mlp.fused(lnk.fused_layernorm(seq, n2.weight, n2.bias, self.norm_eps),
                           rng.kernel_seed() if live else None, item0 * seq.shape[1])
        return seq + (self.drop(x, rng.masks, rng.rows) if live else x)

    def _quant_forward(self, seq, capture_hmean, maps):
        """The W8A8 layer: ``fused_layernorm``, the int8 attention half, the
        residual, ``fused_layernorm``, the int8 FFN, the residual; the
        attention maps (and ``attn_hmean``, their fp32 mean over heads) only
        where ``maps`` or ``capture_hmean`` asks for the per-op attention."""
        n1, n2 = self.norm1, self.norm2
        maps = maps or capture_hmean
        x, attn, attn_raw = self.attention.quant(
            lnk.fused_layernorm(seq, n1.weight, n1.bias, self.norm_eps), maps)
        seq = seq + x
        resid1 = seq
        seq = seq + self.mlp.quant(lnk.fused_layernorm(seq, n2.weight, n2.bias, self.norm_eps))
        probes = {"out": seq, "resid1": resid1, "resid2": seq}
        if maps:
            probes.update(attn=attn, attn_raw=attn_raw)
            probes["attn_hmean"] = attn_raw.float().mean(dim=1).to(attn_raw.dtype)
        return seq, probes

    def _block_forward(self, seq, capture_hmean):
        """Whole-layer fusion: the attention half and the FFN half are one
        hand-written kernel each."""
        if self.activation != "gelu":
            raise ValueError(f"the ffn_block kernel computes gelu, not {self.activation}")
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
            m.linear2.bias,
            eps=self.norm_eps,
        )
        probes["out"] = out
        return out, probes


# the probes only the plain per-op path keeps
PLAIN_PROBES = ("attn", "attn_raw", "resid1", "resid2")
# the probes only the per-op attention keeps (the int8 route's choice)
MAP_PROBES = ("attn", "attn_raw", "attn_hmean")


class Transformer(nn.Module):
    """Pre-norm encoder stack with an optional final LayerNorm."""

    def __init__(self, num_encoder_layers=12, num_heads=8, embed_dim=512, dim_feedforward=2048,
                 activation="gelu", final_norm=True, norm_eps=1e-6, dropout=None):
        super().__init__()
        self.num_encoder_layers, self.norm_eps = num_encoder_layers, norm_eps
        self.layers = nn.ModuleList(
            EncoderLayer(num_heads, embed_dim, dim_feedforward, activation, norm_eps, dropout)
            for _ in range(num_encoder_layers)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=norm_eps) if final_norm else None

    def run(
        self,
        seq: torch.Tensor,
        capture: Tuple[str, ...] = (),
        start_layer: int = 0,
        end_layer: Optional[int] = None,
        deterministic: bool = True,
        rng: Optional[DropoutRNG] = None,
        quant: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Layers [start_layer, end_layer); the final norm only when the stack
        runs to its end. ``deterministic=False`` is the training forward,
        ``quant`` the W8A8 frozen forward."""
        end_layer = self.num_encoder_layers if end_layer is None else end_layer
        captured: Dict[str, torch.Tensor] = {}
        for i in range(start_layer, end_layer):
            kinds = MAP_PROBES if quant else PLAIN_PROBES
            plain = any(f"layers_{i}.{kind}" in capture for kind in kinds)
            seq, probes = self.layers[i](seq, f"layers_{i}.attn_hmean" in capture, deterministic,
                                         rng, plain, quant)
            for kind, value in probes.items():
                if f"layers_{i}.{kind}" in capture:
                    captured[f"layers_{i}.{kind}"] = value
        if self.norm is not None and end_layer == self.num_encoder_layers:
            seq = lnk.fused_layernorm(seq, self.norm.weight, self.norm.bias, self.norm_eps)
        return seq, captured
