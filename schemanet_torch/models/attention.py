"""Multi-head self-attention returning (output, attn, attn_raw).

Port of ``schemanet_tpu/models/attention.py``: the qkv projection is fused,
its output ordered ``(3, H, d)``; attention maps are ``[bs, H, n, n]``.
Three routes:

* ``forward``, the plain per-op path of frozen forwards on the CPU (on CUDA
  the frozen pre-norm encoder layer runs the ``attn_block`` kernel
  instead, models/transformer.py), and of every layer given an
  ``attn_mask`` (an additive float mask on the scores, as JAX's
  ``dot_product_attention``; the JAX package declines its kernels for a
  mask), the masked training forward included, with its attention dropout
  on the probabilities;
* ``fused``, the training path, through the ``fused_mhsa`` kernel with its
  backward and in-kernel attention dropout;
* ``quant``, the W8A8 frozen forward: int8 qkv and out projections
  (``ops/quant.py``: the ``quantize_rows`` and ``int8_gemm`` kernels on
  CUDA) around ``fused_mhsa`` at p = 0, or around the plain per-op
  attention where an attention map is asked for.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..ops import policy
from ..ops.kernels import attention as ak
from ..ops.kernels.encoder_block import dense
from ..ops.quant import int8_dense
from ..parallel.mesh import gathered


def dot_product_attention(
    q: torch.Tensor,  # [bs, H, n, d]
    k: torch.Tensor,
    v: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,  # additive, broadcast to [bs, H, n, n]
    drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out [bs, H, n, d], attn, attn_raw): q pre-scaled by 1/sqrt(d) in its
    own dtype, the mask added to the raw scores, the softmax in fp32 and
    cast back; ``drop`` (attention dropout) applied to the probabilities
    that multiply v, not to the returned ``attn``."""
    d = q.shape[-1]
    q = q / torch.tensor(d**0.5, dtype=q.dtype)
    attn_raw = torch.matmul(q, k.transpose(-1, -2))
    logits = attn_raw if attn_mask is None else attn_raw + attn_mask
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(attn if drop is None else drop(attn), v), attn, attn_raw


def mhsa_site():
    """``fused_mhsa``, or its plain version where the policy's ``attn`` is
    plain."""
    return ak.fused_mhsa if policy.routes().attn else ak.fused_mhsa_reference


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, num_heads: int, embed_dim: int, dropout: Optional[float] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {num_heads} heads")
        self.num_heads, self.embed_dim, self.dropout = num_heads, embed_dim, dropout
        self.linear_qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.linear_out = nn.Linear(embed_dim, embed_dim)

    def _per_op(self, qkv: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """(out [bs, n, dim], attn, attn_raw) of the plain per-op attention
        on the fused qkv output."""
        bs, n, _ = qkv.shape
        qkv = qkv.reshape(bs, n, 3, self.num_heads, self.embed_dim // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each [bs, H, n, d]
        out, attn, attn_raw = dot_product_attention(q, k, v, attn_mask, drop)
        return out.transpose(1, 2).reshape(bs, n, self.embed_dim), attn, attn_raw

    def forward(self, seq: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """The plain per-op route: (out, attn, attn_raw); ``drop`` is the
        attention dropout of a training forward."""
        qkv = dense(seq, gathered(self.linear_qkv.weight), gathered(self.linear_qkv.bias))
        out, attn, attn_raw = self._per_op(qkv, attn_mask, drop)
        return dense(out, gathered(self.linear_out.weight), self.linear_out.bias), attn, attn_raw

    def quant(self, seq: torch.Tensor, maps: bool = False,
              attn_mask: Optional[torch.Tensor] = None):
        """The W8A8 frozen forward: (out, attn, attn_raw). The qkv and out
        projections are int8 (``ops/quant.py``); between them ``fused_mhsa``
        at p = 0 (its plain version on the CPU), or with ``maps`` or a mask
        the plain per-op attention, which alone gives the maps (None
        otherwise)."""
        qkv = int8_dense(seq, gathered(self.linear_qkv.weight), gathered(self.linear_qkv.bias))
        if maps or attn_mask is not None:
            out, attn, attn_raw = self._per_op(qkv, attn_mask)
        else:
            out, attn, attn_raw = mhsa_site()(qkv, self.num_heads), None, None
        return (int8_dense(out, gathered(self.linear_out.weight), self.linear_out.bias), attn,
                attn_raw)

    def fused(self, seq: torch.Tensor, seed: Optional[int] = None, item0: int = 0
              ) -> torch.Tensor:
        """The training path: the qkv projection (flax Dense semantics), then
        ``fused_mhsa`` (its plain version on the CPU) on the untouched
        ``(3, H, d)`` layout, then the out projection; attention dropout live
        when a seed is given, the items being items ``item0 ..`` of the
        global batch."""
        qkv = dense(seq, gathered(self.linear_qkv.weight), gathered(self.linear_qkv.bias))
        p = self.dropout if seed is not None else 0.0
        out = mhsa_site()(qkv, self.num_heads, p, seed, item0)
        return dense(out, gathered(self.linear_out.weight), self.linear_out.bias)
