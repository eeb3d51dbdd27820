"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. There is no fallback from a kernel to its plain version on the card.
"""

from .encoder_block import (
    attn_block,
    attn_block_reference,
    ffn_block,
    ffn_block_reference,
)
from .graphconv import sym_conv, sym_conv_reference


def launch_counts() -> dict:
    """Launch counters of every kernel wrapper, by kernel name."""
    return {
        "attn_block": attn_block.launches,
        "attn_block_hmean": attn_block.hmean_launches,
        "ffn_block": ffn_block.launches,
        "sym_conv": sym_conv.launches,
    }


def reset_launch_counts() -> None:
    attn_block.launches = 0
    attn_block.hmean_launches = 0
    ffn_block.launches = 0
    sym_conv.launches = 0
