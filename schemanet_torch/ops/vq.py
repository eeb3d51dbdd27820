"""Visual-word quantisation (port of ``schemanet_tpu/ops/vq.py``).

``argmin_c ||x - c||^2 = argmin_c (||c||^2 - 2 x.c)``; the ``||x||^2`` term is
constant per row and dropped. Ties resolve to the lowest code id
(``torch.argmin`` returns the first minimum).

The score follows the input dtype: fp32 inputs score in full fp32; bf16
inputs round the codebook to bf16 and score with fp32 accumulation (the
products of bf16 values are exact in fp32), so the scores stay fp32 in both
modes. On the card the fp32 product needs ``allow_tf32`` off, which is
PyTorch's default for matmuls.
"""

from __future__ import annotations

from typing import Tuple

import torch


def vq_assign(
    x: torch.Tensor,  # [..., d]
    codebook: torch.Tensor,  # [M, d]
) -> torch.Tensor:
    """Nearest-code ids (int32) with the leading shape of ``x``."""
    compute_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    flat = x.reshape(-1, x.shape[-1]).to(compute_dtype).float()
    cb = codebook.to(compute_dtype).float()
    scores = (cb * cb).sum(dim=-1)[None, :] - 2.0 * (flat @ cb.t())
    return torch.argmin(scores, dim=-1).int().reshape(x.shape[:-1])


def vq_encode(
    x: torch.Tensor,  # [..., d]
    codebook: torch.Tensor,  # [M, d]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(quantised features in x.dtype, code ids). The serve path has no
    backward, so the JAX package's ``detach_input`` has nothing to do here."""
    ids = vq_assign(x, codebook)
    return codebook[ids.long()].to(x.dtype), ids
