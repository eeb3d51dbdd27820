"""The tile rule of ``csrc/gemm.cuh``'s TMA-fed ``wgmma`` GEMM, for the launch
plans of the wide FFN routes (``mlp.py`` ``mlp_plan``, ``encoder_block.py``
``ffn_plan``). The rule reads no device: it assumes an H100 SXM's SMs, so a
shape gives the same tiles, and the same bits, on any card."""

from __future__ import annotations

from typing import Tuple

# 128-row tiles of two consumer warpgroups, 64 of k a stage; the tiles
# gemm_tile chooses from (consumer warpgroups of 64 rows, columns), the tile
# of an epilogue-heavy product (fc1's gelu: 192 rows, 128 columns), and the
# SMs the rule assumes (csrc/gemm.cuh kSms)
_HG_BM, _HG_BK = 128, 64
_KMAJOR_TILES, _MNMAJOR_TILES = ((2, 96), (2, 192), (3, 192)), ((2, 128), (2, 192), (3, 192))
_HEAVY_BM, _HEAVY_N = 192, 128
_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_tile(rows: int, n: int, mn_major: bool) -> Tuple[int, int]:
    """csrc/gemm.cuh ``gemm_tile``: (rows, columns) of the tile of a bf16
    wide-route product with a light epilogue over ``rows`` x ``n`` (B read
    MN-major or K-major), the shape with the least rounds of persistent
    blocks times its rows times (columns + 32); a tie goes to the later.
    fc1 (gelu, and in ``fused_mlp`` the hash) takes ``_HEAVY_BM`` x ``_HEAVY_N``."""
    best, best_cost = None, None
    for nc, width in (_MNMAJOR_TILES if mn_major else _KMAJOR_TILES):
        bm = 64 * nc
        cost = _cdiv(_cdiv(rows, bm) * _cdiv(n, width), _SMS) * bm * (width + 32)
        if best_cost is None or cost <= best_cost:
            best, best_cost = (bm, width), cost
    return best


def heavy_tiles(rows: int, n: int) -> Tuple[int, int, int]:
    """(row tiles, column tiles, columns) of an epilogue-heavy product over
    ``rows`` x ``n``."""
    return _cdiv(rows, _HEAVY_BM), _cdiv(n, _HEAVY_N), _HEAVY_N


def light_tiles(rows: int, n: int, mn_major: bool) -> Tuple[int, int, int]:
    """(row tiles, column tiles, columns) of a light-epilogue product."""
    bm, width = gemm_tile(rows, n, mn_major)
    return _cdiv(rows, bm), _cdiv(n, width), width
