"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. There is no fallback from a kernel to its plain version on the card.
"""

from .atlas_opt import adamw_project_rows, adamw_project_rows_reference
from .attention import fused_mhsa, fused_mhsa_bwd, fused_mhsa_bwd_reference, fused_mhsa_reference
from .dropmask import hash_keep_mask
from .embed_bwd import PlannedIds, embed_grad, embed_grad_reference, sort_ids
from .encoder_block import (
    attn_block,
    attn_block_reference,
    ffn_block,
    ffn_block_reference,
)
from .graphconv import sym_conv, sym_conv_bwd, sym_conv_bwd_reference, sym_conv_reference
from .layernorm import (
    fused_layernorm,
    fused_layernorm_bwd,
    fused_layernorm_bwd_reference,
    fused_layernorm_plain,
    fused_layernorm_reference,
)
from .mlp import fused_mlp, fused_mlp_bwd, fused_mlp_bwd_reference, fused_mlp_reference
from .vq import vq_assign_kernel, vq_assign_reference

# (wrapper, attribute) of every launch counter, by kernel name
_COUNTERS = {
    "attn_block": (attn_block, "launches"),
    "attn_block_hmean": (attn_block, "hmean_launches"),
    "attn_block_tc": (attn_block, "tc_launches"),  # tensor cores: bf16 mma or split TF32
    "ffn_block": (ffn_block, "launches"),
    "ffn_block_tc": (ffn_block, "tc_launches"),  # tensor cores: bf16 mma or split TF32
    "sym_conv": (sym_conv, "launches"),
    "sym_conv_bwd": (sym_conv_bwd, "launches"),
    "sym_conv_tc": (sym_conv, "tc_launches"),  # the tensor-core route's share
    "sym_conv_bwd_tc": (sym_conv_bwd, "tc_launches"),
    "embed_grad": (embed_grad, "launches"),
    "embed_grad_vec": (embed_grad, "vec_launches"),  # the 16-byte route's share
    "embed_grad_planned": (embed_grad, "planned_launches"),  # calls given a plan
    "adamw_project_rows": (adamw_project_rows, "launches"),
    "fused_mhsa": (fused_mhsa, "launches"),
    "fused_mhsa_bwd": (fused_mhsa_bwd, "launches"),
    "fused_mhsa_tc": (fused_mhsa, "tc_launches"),  # the tensor-core route's share
    "fused_mhsa_bwd_tc": (fused_mhsa_bwd, "tc_launches"),
    "fused_mlp": (fused_mlp, "launches"),
    "fused_mlp_bwd": (fused_mlp_bwd, "launches"),
    "fused_mlp_tc": (fused_mlp, "tc_launches"),  # the tensor-core route's share
    "fused_mlp_bwd_tc": (fused_mlp_bwd, "tc_launches"),
    "vq_assign": (vq_assign_kernel, "launches"),
    "vq_assign_tc": (vq_assign_kernel, "tc_launches"),  # split TF32 or bf16 mma: all of them
    "fused_layernorm": (fused_layernorm, "launches"),
    "fused_layernorm_bwd": (fused_layernorm_bwd, "launches"),
    "fused_layernorm_bwd_vec": (fused_layernorm_bwd, "vec_launches"),  # 16-byte route's share
}


def launch_counts() -> dict:
    """Launch counters of every kernel wrapper, by kernel name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)
