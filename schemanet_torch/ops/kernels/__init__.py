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
    ffn_ln_rows,
)
from .imagepipe import crop_resize, crop_resize_reference, ycc_to_rgb, ycc_to_rgb_reference
from .graphconv import sym_conv, sym_conv_bwd, sym_conv_bwd_reference, sym_conv_reference
from .layernorm import (
    fused_layernorm,
    fused_layernorm_bwd,
    fused_layernorm_bwd_reference,
    fused_layernorm_plain,
    fused_layernorm_reference,
)
from .mlp import fused_mlp, fused_mlp_bwd, fused_mlp_bwd_reference, fused_mlp_reference
from .quant import int8_gemm, int8_gemm_reference, quantize_rows, quantize_rows_reference
from .vq import vq_assign_kernel, vq_assign_reference

# (wrapper, attribute) of every launch counter, by kernel name
_COUNTERS = {
    "attn_block": (attn_block, "launches"),
    "attn_block_hmean": (attn_block, "hmean_launches"),
    "attn_block_tc": (attn_block, "tc_launches"),  # tensor cores: bf16 mma or split TF32
    "ffn_block": (ffn_block, "launches"),
    "ffn_block_tc": (ffn_block, "tc_launches"),  # tensor cores: bf16 mma or split TF32
    "ffn_block_wide": (ffn_block, "wide_launches"),  # past width 384: a launch a step
    "ffn_ln_rows": (ffn_ln_rows, "launches"),  # the wide route's LN2 pass alone
    "ffn_block_relu": (ffn_block, "relu_launches"),  # the activation relu's share
    "sym_conv": (sym_conv, "launches"),
    "sym_conv_bwd": (sym_conv_bwd, "launches"),
    "sym_conv_tc": (sym_conv, "tc_launches"),  # the tensor-core route's share
    "sym_conv_bwd_tc": (sym_conv_bwd, "tc_launches"),
    "embed_grad": (embed_grad, "launches"),
    "embed_grad_vec": (embed_grad, "vec_launches"),  # the 16-byte route's share
    "embed_grad_planned": (embed_grad, "planned_launches"),  # calls given a plan
    "adamw_project_rows": (adamw_project_rows, "launches"),
    "adamw_project_rows_bf16": (adamw_project_rows, "bf16_launches"),  # a bf16 moment
    "adamw_project_rows_vec": (adamw_project_rows, "vec_launches"),  # 4-column pieces
    "fused_mhsa": (fused_mhsa, "launches"),
    "fused_mhsa_bwd": (fused_mhsa_bwd, "launches"),
    "fused_mhsa_tc": (fused_mhsa, "tc_launches"),  # the tensor-core route's share
    "fused_mhsa_bwd_tc": (fused_mhsa_bwd, "tc_launches"),
    "fused_mlp": (fused_mlp, "launches"),
    "fused_mlp_bwd": (fused_mlp_bwd, "launches"),
    "fused_mlp_tc": (fused_mlp, "tc_launches"),  # the tensor-core route's share
    "fused_mlp_bwd_tc": (fused_mlp_bwd, "tc_launches"),
    "fused_mlp_wide": (fused_mlp, "wide_launches"),  # past width 256: a launch a product
    "fused_mlp_bwd_wide": (fused_mlp_bwd, "wide_launches"),
    "fused_mlp_relu": (fused_mlp, "relu_launches"),  # the activation relu's share
    "fused_mlp_bwd_relu": (fused_mlp_bwd, "relu_launches"),
    "vq_assign": (vq_assign_kernel, "launches"),
    "vq_assign_tc": (vq_assign_kernel, "tc_launches"),  # split TF32 or bf16 mma: all of them
    "fused_layernorm": (fused_layernorm, "launches"),
    "fused_layernorm_bwd": (fused_layernorm_bwd, "launches"),
    "fused_layernorm_bwd_vec": (fused_layernorm_bwd, "vec_launches"),  # 16-byte route's share
    "crop_resize": (crop_resize, "launches"),
    "quantize_rows": (quantize_rows, "launches"),
    "int8_gemm": (int8_gemm, "launches"),
    "ycc_to_rgb": (ycc_to_rgb, "launches"),
}


# the wrappers that also count their launches by shape (``shape_launches``):
# GraphConv by (K, V, D), LayerNorm by (rows, d), so that the class graphs'
# launches are told from the instance graphs'; the int8 route's by (rows, k)
# and (rows, n, k), so that weights are told from activations
_SHAPE_COUNTERS = {"sym_conv": sym_conv, "sym_conv_bwd": sym_conv_bwd,
                   "fused_layernorm": fused_layernorm, "fused_layernorm_bwd": fused_layernorm_bwd,
                   "quantize_rows": quantize_rows, "int8_gemm": int8_gemm}


def launch_counts() -> dict:
    """Launch counters of every kernel wrapper, by kernel name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def launch_counts_by_shape() -> dict:
    """{kernel name: {shape: launches}} of the wrappers counted by shape."""
    return {name: dict(fn.shape_launches) for name, fn in _SHAPE_COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)
    for fn in _SHAPE_COUNTERS.values():
        fn.shape_launches.clear()
