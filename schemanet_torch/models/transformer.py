"""Pre-norm Transformer encoder with declarative activation capture.

Port of ``schemanet_tpu/models/transformer.py`` for the mask-free pre-norm
stack, in its two forwards. Probe names:

    layers_{i}.out        — output sequence of encoder layer i
    layers_{i}.attn_hmean — head-mean of the pre-softmax scaled scores [bs, n, n]
                            (deterministic forwards only)

Deterministic (frozen) forward, as serving and the SchemaNet backbone run it:
on CUDA every layer takes the two hand-written kernels
(``ops/kernels/encoder_block.py``), and layer i's ``attn_hmean`` comes out of
the ``attn_block`` kernel itself. On the CPU a layer runs the plain per-op path
and the probe is the fp32 mean over heads of the raw scores.

Training forward (``deterministic=False``), as stage 0 runs it: flax-semantics
LayerNorm, ``fused_mhsa`` (attention dropout in the kernel), residual
dropout, LayerNorm, ``fused_mlp`` (FFN dropout in the kernel), residual
dropout; differentiable through the kernels' backward kernels. Dropout draws
from the caller's ``DropoutRNG``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.kernels import encoder_block as eb
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
                rng: Optional[DropoutRNG] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if not deterministic:
            if capture_hmean:
                raise ValueError("the training forward has no attn_hmean probe")
            out = self._train_forward(seq, rng)
            return out, {"out": out}
        if seq.is_cuda:
            return self._block_forward(seq, capture_hmean)
        n1, n2 = self.norm1, self.norm2
        x, _, attn_raw = self.attention(eb.layer_norm(seq, n1.weight, n1.bias, self.norm_eps))
        seq = seq + x
        seq = seq + self.mlp(eb.layer_norm(seq, n2.weight, n2.bias, self.norm_eps))
        probes = {"out": seq}
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
        x = self.attention.fused(eb.layer_norm(seq, n1.weight, n1.bias, self.norm_eps),
                                 rng.kernel_seed() if live else None)
        seq = seq + (self.drop(x, rng.masks) if live else x)
        x = self.mlp.fused(eb.layer_norm(seq, n2.weight, n2.bias, self.norm_eps),
                           rng.kernel_seed() if live else None)
        return seq + (self.drop(x, rng.masks) if live else x)

    def _block_forward(self, seq, capture_hmean):
        """Whole-layer fusion: the attention half and the FFN half are one
        hand-written kernel each."""
        if self.activation != "gelu":
            raise ValueError(f"the ffn_block kernel computes gelu, not {self.activation}")
        a, m = self.attention, self.mlp
        out = eb.attn_block(
            seq, self.norm1.weight, self.norm1.bias,
            a.linear_qkv.weight, a.linear_qkv.bias, a.linear_out.weight, a.linear_out.bias,
            self.num_heads, eps=self.norm_eps, capture_hmean=capture_hmean,
        )
        probes = {}
        if capture_hmean:
            out, probes["attn_hmean"] = out
        out = eb.ffn_block(
            out, self.norm2.weight, self.norm2.bias,
            m.linear1.weight, m.linear1.bias, m.linear2.weight, m.linear2.bias,
            eps=self.norm_eps,
        )
        probes["out"] = out
        return out, probes


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
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Layers [start_layer, end_layer); the final norm only when the stack
        runs to its end. ``deterministic=False`` is the training forward."""
        end_layer = self.num_encoder_layers if end_layer is None else end_layer
        captured: Dict[str, torch.Tensor] = {}
        for i in range(start_layer, end_layer):
            seq, probes = self.layers[i](seq, f"layers_{i}.attn_hmean" in capture, deterministic,
                                         rng)
            for kind, value in probes.items():
                if f"layers_{i}.{kind}" in capture:
                    captured[f"layers_{i}.{kind}"] = value
        if self.norm is not None and end_layer == self.num_encoder_layers:
            seq = eb.layer_norm(seq, self.norm.weight, self.norm.bias, self.norm_eps)
        return seq, captured
