"""Visual-word quantisation (port of ``schemanet_tpu/ops/vq.py``).

``argmin_c ||x - c||^2 = argmin_c (||c||^2 - 2 x.c)``; the ``||x||^2`` term is
constant per row and dropped. Ties resolve to the lowest code id.

The score follows the input dtype: fp32 inputs score in full fp32; bf16
inputs round the codebook to bf16 and score with fp32 accumulation (the
products of bf16 values are exact in fp32), so the scores stay fp32 in both
modes. On the card the assignment is the streaming-argmin kernel
(``ops/kernels/vq.py``, ``csrc/vq.cu``); on the CPU its plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import policy
from .kernels import vq as vqk


def vq_assign(
    x: torch.Tensor,  # [..., d]
    codebook: torch.Tensor,  # [M, d]
) -> torch.Tensor:
    """Nearest-code ids (int32) with the leading shape of ``x``; the plain
    version where the policy's ``vq`` is plain."""
    if not policy.routes().vq:
        return vqk.vq_assign_reference(x, codebook)
    return vqk.vq_assign_kernel(x, codebook)


def vq_encode(
    x: torch.Tensor,  # [..., d]
    codebook: torch.Tensor,  # [M, d]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(quantised features in x.dtype, code ids). The serve path has no
    backward, so the JAX package's ``detach_input`` has nothing to do here."""
    ids = vq_assign(x, codebook)
    return codebook[ids.long()].to(x.dtype), ids
