"""A model, in numpy, of how ``ycc_to_rgb``'s kernel library cuts images
into tiles (``csrc/imagepipe.cu`` ``ycc_tiling`` and ``ycc_prepare``, the
one owner of the tiling) and of the records it writes. The CPU tests hold
the model's properties (every pixel in one tile, no chroma row pair split);
``tests/test_torch_kernels_cuda.py::test_ycc_records_equal_the_tiling_model``
holds the library's records to the model word for word on the card."""

import numpy as np

from schemanet_torch.ops.kernels.imagepipe import YCC_META, YCC_REC

THREADS, COLS = 128, 2048  # csrc/imagepipe.cu kYccThreads, kYccCols


def tiling(w):
    """(chunks, chunk width, band rows) of images ``w`` wide (numpy arrays
    or ints): each row splits into the fewest chunks of at most ``COLS``
    columns, evenly, each a multiple of 16 wide; a thread takes 2 rows by 16
    columns, so a tile is a band of 2 * (128 // (chunk width / 16)) rows."""
    w = np.asarray(w, np.int64)
    chunks = -(-w // COLS)
    chunk_w = -(-(-(-w // chunks)) // 16) * 16
    return chunks, chunk_w, 2 * (THREADS // (chunk_w // 16))


def tile_counts(h, w) -> np.ndarray:
    """Each image's tiles, a block each."""
    chunks, _, band = tiling(w)
    return -(-np.asarray(h, np.int64) // band) * chunks


def tile_rect(h: int, w: int, local: int):
    """(first row, first column, rows, columns) of an image's tile ``local``
    (bands of rows, each cut into chunks, in row order), by the kernel's
    rule for reading its tile from its record."""
    chunks, chunk_w, band = (int(v) for v in tiling(w))
    y0, x0 = local // chunks * band, local % chunks * chunk_w
    return y0, x0, min(band, h - y0), min(chunk_w, w - x0)


def records(table: np.ndarray) -> np.ndarray:
    """The words the library writes for a checked table: each file's
    record (its 10 columns; chunks, chunk width, tc | tr << 16 with tc
    groups of 16 columns across a chunk and tr groups of 2 rows down a band,
    and 65536 // tc + 1, by which the kernel divides a thread's index by
    tc), then each file's first tile."""
    n = len(table)
    rec = np.zeros((n, YCC_REC), np.int64)
    chunks, chunk_w, band = tiling(table[:, 4])
    tc = chunk_w // 16
    rec[:, :YCC_META] = table
    rec[:, 10] = chunks
    rec[:, 11] = chunk_w
    rec[:, 12] = tc | (band // 2) << 16
    rec[:, 13] = 65536 // tc + 1
    counts = tile_counts(table[:, 3], table[:, 4])
    return np.concatenate([rec.reshape(-1), np.cumsum(counts) - counts])


def table_of(cases):
    """(table [n, 10], plane bytes, output bytes) of packed files ``cases``
    [(h, w, hs, vs)] ((0, 0): gray), with no planes made."""
    rows, at, out_at = [], 0, 0
    for h, w, hs, vs in cases:
        if hs == 0:
            rows.append((at, -1, -1, h, w, 0, 0, 1, 1, out_at))
            at += h * w
        else:
            cw, ch = -(-w // hs), -(-h // vs)
            rows.append((at, at + h * w, at + h * w + ch * cw, h, w, cw, ch, hs, vs, out_at))
            at += h * w + 2 * ch * cw
        out_at += h * w * 3
    return np.asarray(rows, np.int64), at, out_at
