"""Multi-head self-attention returning (output, attn, attn_raw).

Port of ``schemanet_tpu/models/attention.py``: the qkv projection is fused,
its output ordered ``(3, H, d)``; attention maps are ``[bs, H, n, n]``.
``forward`` is the plain per-op path of frozen forwards on the CPU (on CUDA
the frozen encoder layer runs the ``attn_block`` kernel instead,
models/transformer.py); ``fused`` is the training path, through the
``fused_mhsa`` kernel with its backward and in-kernel attention dropout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.kernels import attention as ak
from ..ops.kernels.encoder_block import dense


def dot_product_attention(
    q: torch.Tensor,  # [bs, H, n, d]
    k: torch.Tensor,
    v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out [bs, H, n, d], attn, attn_raw): q pre-scaled by 1/sqrt(d) in its
    own dtype, the softmax in fp32 and cast back."""
    d = q.shape[-1]
    q = q / torch.tensor(d**0.5, dtype=q.dtype)
    attn_raw = torch.matmul(q, k.transpose(-1, -2))
    attn = torch.softmax(attn_raw.float(), dim=-1).to(q.dtype)
    return torch.matmul(attn, v), attn, attn_raw


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, num_heads: int, embed_dim: int, dropout: Optional[float] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {num_heads} heads")
        self.num_heads, self.embed_dim, self.dropout = num_heads, embed_dim, dropout
        self.linear_qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.linear_out = nn.Linear(embed_dim, embed_dim)

    def forward(self, seq: torch.Tensor):
        bs, n, _ = seq.shape
        qkv = dense(seq, self.linear_qkv.weight, self.linear_qkv.bias)
        qkv = qkv.reshape(bs, n, 3, self.num_heads, self.embed_dim // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each [bs, H, n, d]
        out, attn, attn_raw = dot_product_attention(q, k, v)
        out = out.transpose(1, 2).reshape(bs, n, self.embed_dim)
        return dense(out, self.linear_out.weight, self.linear_out.bias), attn, attn_raw

    def fused(self, seq: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        """The training path: the qkv projection (flax Dense semantics), then
        ``fused_mhsa`` (its plain version on the CPU) on the untouched
        ``(3, H, d)`` layout, then the out projection; attention dropout live
        when a seed is given."""
        qkv = dense(seq, self.linear_qkv.weight, self.linear_qkv.bias)
        p = self.dropout if seed is not None else 0.0
        out = ak.fused_mhsa(qkv, self.num_heads, p, seed)
        return dense(out, self.linear_out.weight, self.linear_out.bias)
