"""The card's image pipeline, two CUDA kernels with their plain versions:
the crop, flip and antialiased resize of a ragged batch of decoded images
(``crop_resize``), and libjpeg's chroma upsampling and YCbCr-to-RGB
conversion of the component planes that nvJPEG decodes (``ycc_to_rgb``).

The kernel is ``csrc/imagepipe.cu``, the device counterpart of the host
pipeline's ``ip_process_sample_u8`` (``native/src/imagepipe.cpp:147``); it
ports no Pallas kernel. Its header gives the filter operation by operation
and what bounds it.

Input: ``pixels``, the batch's decoded uint8 RGB images packed in one 1-D
buffer, and ``crop`` [bs, 8] int64, a row a sample: (offset of the image in
``pixels``, h, w, top, left, crop_h, crop_w, flip); top and left may be
negative and the window may pass the image's edges (zeros there, CIFAR's
padding). Output: uint8 [bs, out, out, 3].

``crop_resize_reference`` repeats the kernel's operations in the same order
with each fp32 and fp64 operation rounded by itself (the taps in numpy
fp64, the sums in torch fp32), so the two agree bit for bit; both differ
from the JAX package's C++ filter (built with ``-ffast-math``, whose fused
multiply-adds round once) by one level at most, where the fp32 value before
truncation sits at a .5 tie.

Dispatch: CPU ``pixels`` take the plain version; CUDA ``pixels`` launch the
kernel or raise. The ``crop`` table is checked on the host (every window's
image inside ``pixels``) and copied to the device with the launch.
``crop_resize.launches`` counts the launches.

``ycc_to_rgb`` (``csrc/imagepipe.cu`` ``ycc_rgb_kernel``) finishes the
nvJPEG route's decode (``data/jpeg.py``): nvJPEG gives each file's Y, Cb
and Cr planes as decoded (chroma at its subsampled size), and the kernel
applies what libjpeg applies after its IDCT in the host route, operation
for operation (``jdsample.c``, ``jdcolor.c``): fancy upsampling (2h1v and
2h2v triangle filters with their 1/2 and 8/7 biases, edges replicated,
where the chroma plane is wider than 2; 1h2v's bias 1/2; plain replication
otherwise) and the fixed-point (16-bit) colour conversion. nvJPEG's own
upsampling is a plain replication, up to ~100 levels from libjpeg's at a
sharp colour edge. ``planes`` holds the planes packed; ``meta`` [n, 10]
int64 a file: (Y offset, Cb offset (-1: gray), Cr offset, h, w, chroma w,
chroma h, h factor, v factor, output offset). The kernel takes each image
in tiles (bands of an even number of rows from an even row by chunks of at
most 2,048 columns, so that a photo's band is whole rows, one contiguous
run of the output), a block each. The kernel library's host half owns the
tiling: one call checks the table, writes each file's record with its
tiling and first tile into a pinned buffer of a ring this module keeps (no
pinned allocation a call), uploads them and launches; ``ycc_records``
returns what it writes.
``ycc_to_rgb_reference`` gives libjpeg's bytes from libjpeg's own planes
(``tests/test_torch_imagepipe.py``), and the kernel's on the card.
``ycc_to_rgb.launches`` counts the launches.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import _build
from .encoder_block import _require_cuda, _stream

META = 8  # offset, h, w, top, left, crop_h, crop_w, flip
_INV255 = np.float32(1.0) / np.float32(255.0)


def _taps(start: int, crop: int, out: int):
    """(first tap [out], fp32 coefficients [out, T], valid [out, T]) of an
    axis: the C++ filter's taps, fp64 weights rounded to fp32 and
    renormalised by their fp64 sum, summed in tap order."""
    scale = float(crop) / float(out)
    support = max(scale, 1.0)
    center = start + (np.arange(out) + 0.5) * scale
    lo = np.maximum(np.floor(center - support + 0.5).astype(np.int64), start - 16)
    hi = np.minimum(np.floor(center + support + 0.5).astype(np.int64), start + crop + 16)
    width = max(int((hi - lo).max()), 1)
    j = lo[:, None] + np.arange(width)[None, :]
    valid = j < hi[:, None]
    x = ((j + 0.5) - center[:, None]) / support
    w = np.where(valid, np.maximum(np.where(x < 0, 1.0 + x, 1.0 - x), 0.0), 0.0)
    total = np.cumsum(w, axis=1)[:, -1:]  # in tap order, as the kernel adds them
    w32 = w.astype(np.float32)
    coef = np.where(total > 0, (w32.astype(np.float64) / np.where(total > 0, total, 1.0))
                    .astype(np.float32), w32)
    return j, coef, valid


def _check_crop(crop: np.ndarray, n_pixels: int, out: int) -> None:
    if crop.ndim != 2 or crop.shape[1] != META:
        raise ValueError(f"crop must be [bs, {META}], got {crop.shape}")
    off, h, w, _, _, ch, cw, flip = crop.T
    if (h < 1).any() or (w < 1).any() or (ch < 1).any() or (cw < 1).any():
        raise ValueError("crop_resize: an image or a crop window is empty")
    if (off < 0).any() or (off + h * w * 3 > n_pixels).any():
        raise ValueError("crop_resize: an image lies outside the pixel buffer")
    if not np.isin(flip, (0, 1)).all():
        raise ValueError("crop_resize: flip must be 0 or 1")
    if out < 1 or out > 65535 or len(crop) > 65535:
        raise ValueError(f"crop_resize: out {out} or batch {len(crop)} out of range")


def tap_bound(crop_len: np.ndarray, out: int) -> int:
    """A bound of the taps of any output along an axis of windows
    ``crop_len`` long resized to ``out``: the kernel's coefficient tables
    hold this many a column (a row). The span floor(c + s + .5) -
    floor(c - s + .5) is at most floor(2 s) + 2 with fp64's rounding of c
    +- s; the clamp to 16 pixels past the window caps it at crop + 32."""
    crop_len = np.asarray(crop_len, np.int64)
    support = np.maximum(crop_len.astype(np.float64) / out, 1.0)
    return int(np.minimum(np.floor(2 * support) + 3, crop_len + 32).max())


def _crop_table(crop) -> np.ndarray:
    if torch.is_tensor(crop):
        crop = crop.cpu().numpy()
    return np.ascontiguousarray(np.asarray(crop, np.int64))


def crop_resize_values(pixels: torch.Tensor, crop, out: int) -> torch.Tensor:
    """The fp32 value u = (acc / 255) * 255 + 0.5 of every output byte
    before it is truncated, [bs, out, out, 3], by the plain version's
    operations; on ``pixels``' device."""
    table = _crop_table(crop)
    _check_crop(table, pixels.numel(), out)
    dev = pixels.device
    inv255 = torch.tensor(_INV255, device=dev)
    result = torch.empty(len(table), out, out, 3, dtype=torch.float32, device=dev)
    for b, (off, h, w, top, left, ch, cw, flip) in enumerate(table.tolist()):
        img = pixels[off:off + h * w * 3].view(h, w, 3)
        jx, cx, vx = _taps(left, cw, out)
        if flip:
            jx, cx, vx = jx[::-1], cx[::-1], vx[::-1]
        # the horizontal pass over the window's rows: zeros outside the image
        rows = np.arange(top, top + ch)
        inside = ((rows >= 0) & (rows < h))[:, None, None] & (vx & (jx >= 0) & (jx < w))[None]
        gathered = img[torch.as_tensor(np.clip(rows, 0, h - 1), device=dev)[:, None, None],
                       torch.as_tensor(np.clip(jx, 0, w - 1).copy(), device=dev)[None]]
        pix = torch.where(torch.as_tensor(inside, device=dev)[..., None], gathered.float(),
                          torch.zeros((), device=dev))  # [ch, out, T, 3]
        cxt = torch.as_tensor(cx.copy(), device=dev)
        row = torch.zeros(ch, out, 3, device=dev)
        for t in range(cx.shape[1]):
            row = row + cxt[None, :, t, None] * pix[:, :, t]
        # the vertical pass: taps outside the window add nothing
        jy, cy, vy = _taps(top, ch, out)
        in_win = vy & (jy >= top) & (jy < top + ch)
        cyt = torch.as_tensor(np.where(in_win, cy, np.float32(0)), device=dev)
        idx = torch.as_tensor(np.clip(jy - top, 0, ch - 1), device=dev)
        acc = torch.zeros(out, out, 3, device=dev)
        for t in range(cy.shape[1]):
            acc = acc + cyt[:, t, None, None] * row[idx[:, t]]
        result[b] = (acc * inv255) * 255.0 + 0.5
    return result


def crop_resize_reference(pixels: torch.Tensor, crop, out: int) -> torch.Tensor:
    """Plain version of ``crop_resize``: uint8 [bs, out, out, 3]."""
    u = crop_resize_values(pixels, crop, out)
    return u.clamp(0.0, 255.0).to(torch.uint8)


def crop_resize(pixels: torch.Tensor, crop, out: int) -> torch.Tensor:
    """uint8 [bs, out, out, 3]: each sample's crop window of ``pixels``
    resized to ``out`` x ``out`` (mirrored where its flip is 1)."""
    if pixels.device.type == "cpu":
        return crop_resize_reference(pixels, crop, out)
    _require_cuda("pixels", pixels)
    if pixels.dtype != torch.uint8 or pixels.ndim != 1 or not pixels.is_contiguous():
        raise ValueError(f"pixels must be a contiguous 1-D uint8 tensor, got {pixels.dtype} "
                         f"{tuple(pixels.shape)}")
    table = _crop_table(crop)
    _check_crop(table, pixels.numel(), out)
    meta = torch.from_numpy(table).pin_memory().to(pixels.device, non_blocking=True)
    dst = torch.empty(len(table), out, out, 3, dtype=torch.uint8, device=pixels.device)
    err = _build.library().sn_crop_resize(pixels.data_ptr(), meta.data_ptr(), dst.data_ptr(),
                                          len(table), out, tap_bound(table[:, 6], out),
                                          tap_bound(table[:, 5], out), _stream())
    _build.check(err, "crop_resize")
    meta.record_stream(torch.cuda.current_stream(pixels.device))
    _counted.launches += 1
    return dst


crop_resize.launches = 0
_counted = crop_resize


YCC_META = 10  # y, cb, cr offsets, h, w, chroma w, chroma h, h factor, v factor, out offset
YCC_REC = 14  # int64 a file's record on the card (csrc/imagepipe.cu kYccRec): its columns,
#               then its tiling; after the n records, each file's first tile
_FIX_CR_R, _FIX_CB_B, _FIX_CR_G, _FIX_CB_G = 91881, 116130, 46802, 22554  # FIX(1.402) ...


def _fancy(hs: int, vs: int, cw: int) -> bool:
    """Whether libjpeg's fancy upsampler takes a plane (jdsample.c)."""
    return ((hs, vs) in ((2, 1), (2, 2)) and cw > 2) or (hs, vs) == (1, 2)


def _upsample(p: torch.Tensor, h: int, w: int, hs: int, vs: int) -> torch.Tensor:
    """libjpeg's upsampling of one chroma plane [ch, cw] (int64) to [h, w]."""
    ch, cw = p.shape
    if (hs, vs) == (1, 1):
        return p[:h, :w]
    if not _fancy(hs, vs, cw):
        return p.repeat_interleave(vs, 0).repeat_interleave(hs, 1)[:h, :w]
    up = p[(torch.arange(ch, device=p.device) - 1).clamp(min=0)]
    down = p[(torch.arange(ch, device=p.device) + 1).clamp(max=ch - 1)]
    if (hs, vs) == (1, 2):
        return torch.stack([(3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2], 1).reshape(
            2 * ch, cw)[:h, :w]

    def h2(s: torch.Tensor, one: int, bias_l: int, bias_r: int, shift: int) -> torch.Tensor:
        left = torch.cat([s[:, :1], s[:, :-1]], 1)
        right = torch.cat([s[:, 1:], s[:, -1:]], 1)
        return torch.stack([(one * s + left + bias_l) >> shift,
                            (one * s + right + bias_r) >> shift], 2).reshape(len(s), 2 * cw)

    if vs == 1:  # 2h1v: 3/4 nearer + 1/4 further, biases 1 and 2
        return h2(p, 3, 1, 2, 2)[:h, :w]
    # 2h2v: column sums of 3 nearer + 1 further row, then 3/4 + 1/4 across,
    # biases 8 and 7
    rows = torch.stack([h2(3 * p + up, 3, 8, 7, 4), h2(3 * p + down, 3, 8, 7, 4)], 1)
    return rows.reshape(2 * ch, 2 * cw)[:h, :w]


def ycc_image_reference(y: torch.Tensor, cb, cr, hs: int, vs: int) -> torch.Tensor:
    """uint8 [h, w, 3] from uint8 planes Y [h, w] and Cb, Cr [ch, cw] (None
    for a gray file) by libjpeg's upsampling and colour conversion."""
    yi = y.long()
    if cb is None:
        return y[..., None].expand(*y.shape, 3).contiguous()
    h, w = y.shape
    cbi = _upsample(cb.long(), h, w, hs, vs) - 128
    cri = _upsample(cr.long(), h, w, hs, vs) - 128
    r = yi + ((_FIX_CR_R * cri + 32768) >> 16)
    g = yi + ((-_FIX_CB_G * cbi + 32768 - _FIX_CR_G * cri) >> 16)
    b = yi + ((_FIX_CB_B * cbi + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


def _ycc_table(meta) -> np.ndarray:
    table = _crop_table(meta)
    if table.ndim != 2 or table.shape[1] != YCC_META or not len(table):
        raise ValueError(f"meta must be [n, {YCC_META}] with n >= 1, got {table.shape}")
    return table


def _check_ycc(table: np.ndarray, n_planes: int, total: int) -> None:
    yo, cbo, cro, h, w, cw, ch, hs, vs, oo = table.T
    gray = cbo < 0
    if (h < 1).any() or (w < 1).any() or (~gray & ((cw < 1) | (ch < 1))).any():
        raise ValueError("ycc_to_rgb: an empty image or plane")
    if (~gray & ((hs < 1) | (vs < 1) | (cw * hs < w) | (ch * vs < h))).any():
        raise ValueError("ycc_to_rgb: a chroma plane does not cover its image")
    plane = np.where(gray, 0, cw * ch)
    if ((yo < 0) | (yo + h * w > n_planes) | (~gray & ((cro < 0) | (cbo + plane > n_planes)
                                                     | (cro + plane > n_planes)))).any():
        raise ValueError("ycc_to_rgb: a plane lies outside the plane buffer")
    if ((oo < 0) | (oo + h * w * 3 > total)).any() or len(table) > 65535 or h.max() > 65535:
        raise ValueError("ycc_to_rgb: an image lies outside the output or too large")


def ycc_to_rgb_reference(planes: torch.Tensor, meta, total: int) -> torch.Tensor:
    """Plain version of ``ycc_to_rgb``: the packed uint8 RGB images, ``total``
    bytes."""
    table = _ycc_table(meta)
    _check_ycc(table, planes.numel(), total)
    out = torch.zeros(total, dtype=torch.uint8, device=planes.device)
    for yo, cbo, cro, h, w, cw, ch, hs, vs, oo in table.tolist():
        y = planes[yo:yo + h * w].view(h, w)
        cb = None if cbo < 0 else planes[cbo:cbo + cw * ch].view(ch, cw)
        cr = None if cbo < 0 else planes[cro:cro + cw * ch].view(ch, cw)
        out[oo:oo + h * w * 3] = ycc_image_reference(y, cb, cr, hs, vs).reshape(-1)
    return out


# the table's checks by code, as the kernel library's host half
# (csrc/imagepipe.cu ycc_prepare) returns them negated: _check_ycc's messages
_YCC_ERRORS = {
    1: "ycc_to_rgb: an empty image or plane",
    2: "ycc_to_rgb: a chroma plane does not cover its image",
    3: "ycc_to_rgb: a plane lies outside the plane buffer",
    4: "ycc_to_rgb: an image lies outside the output or too large",
    5: "ycc_to_rgb: more tiles than a launch takes",
}


def ycc_records(meta, n_planes: int, total: int):
    """(int64 words, tiles): what the kernel library's host half writes for
    the table ``meta`` (n records of ``YCC_REC`` words, then each file's
    first tile) and the batch's tiles, a block each; the library's own
    tiling, for the tests and chip_smoke.py. Needs the kernel library (nvcc)."""
    table = _ycc_table(meta)
    words = np.zeros(len(table) * (YCC_REC + 1), np.int64)
    tiles = _build.library().sn_ycc_prepare(table.ctypes.data, len(table), n_planes, total,
                                            words.ctypes.data)
    if tiles < 0:
        raise ValueError(_YCC_ERRORS[-tiles])
    return words, tiles


class _PinnedRing:
    """Pinned host buffers for the wrapper's one upload a launch: a slot is
    written again, or its buffer replaced by a larger one, only once the
    copy that last read it has completed (its event; the copy is the kernel
    library's own, so the caching host allocator knows nothing of it), so
    no call allocates pinned memory once the ring has grown to the batches'
    size. ``lock`` serialises the calls that fill and copy a slot."""

    def __init__(self, slots: int = 4):
        self._bufs = [None] * slots
        self._events = [None] * slots
        self._next = 0
        self.lock = threading.Lock()

    def take(self, nbytes: int):
        """(pinned uint8 buffer of at least ``nbytes``, slot); call under
        ``lock`` and ``done`` the slot once its copy is enqueued."""
        slot = self._next
        self._next = (slot + 1) % len(self._bufs)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        if self._bufs[slot] is None or self._bufs[slot].numel() < nbytes:
            self._bufs[slot] = torch.empty(max(nbytes, 4096) * 2, dtype=torch.uint8,
                                           pin_memory=True)
        return self._bufs[slot], slot

    def done(self, slot: int, stream) -> None:
        event = self._events[slot] = self._events[slot] or torch.cuda.Event()
        event.record(stream)


_ring = _PinnedRing()


def ycc_to_rgb(planes: torch.Tensor, meta, total: int) -> torch.Tensor:
    """The packed uint8 RGB HWC images (``total`` bytes, each at its output
    offset) of the files whose planes ``meta`` locates in ``planes``. On
    the card the table's checks, its records with their tiling and their
    upload are one call of the kernel library (``sn_ycc_to_rgb``), from a
    pinned slot of ``_ring``."""
    if planes.device.type == "cpu":
        return ycc_to_rgb_reference(planes, meta, total)
    _require_cuda("planes", planes)
    if planes.dtype != torch.uint8 or planes.ndim != 1 or not planes.is_contiguous():
        raise ValueError("planes must be a contiguous 1-D uint8 tensor")
    table = _ycc_table(meta)
    nbytes = len(table) * (YCC_REC + 1) * 8
    words = torch.empty(nbytes, dtype=torch.uint8, device=planes.device)
    out = torch.empty(total, dtype=torch.uint8, device=planes.device)
    stream = torch.cuda.current_stream(planes.device)
    with _ring.lock:
        host, slot = _ring.take(nbytes)
        err = _build.library().sn_ycc_to_rgb(
            planes.data_ptr(), table.ctypes.data, len(table), planes.numel(), total,
            host.data_ptr(), words.data_ptr(), out.data_ptr(), stream.cuda_stream)
        if err >= 0:
            _ring.done(slot, stream)
    if err < 0:
        raise ValueError(_YCC_ERRORS[-err])
    _build.check(err, "ycc_to_rgb")
    _counted_ycc.launches += 1
    return out


ycc_to_rgb.launches = 0
_counted_ycc = ycc_to_rgb
