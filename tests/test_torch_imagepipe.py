"""The port's JPEG decode (``data/jpeg.py``) and the plain versions of its
image-pipeline kernels (``ops/kernels/imagepipe.py``) against the JAX
package's native pipeline (``native/src/imagepipe.cpp`` through
``schemanet_tpu.data.native``), on the CPU, on the JPEG fixtures
(``tests/fixtures/jpeg/``: odd sizes, 4:2:0, 4:2:2 and 4:4:4 chroma,
grayscale, progressive scans, restart markers, a CMYK JPEG and a PNG named
``.JPEG``; ``pixels.npz`` holds the JAX native decode's pixels of the
decodable ones, ``tools/make_jpeg_fixtures.py`` wrote them).

* Host decode (libjpeg): bit for bit the JAX native decode and the
  committed pixels; the two refused files give None, raise
  ``RefusedImage`` naming the file without Pillow and equal the JAX
  dataset's PIL route with it.
* ``ycc_to_rgb_reference`` on libjpeg's own component planes gives
  libjpeg's RGB bytes, bit for bit, at every subsampling of the fixtures
  (so the card's nvJPEG route differs from libjpeg only by its IDCT).
* ``crop_resize_reference`` against ``native.process_sample_u8``: equal but
  for one level where the fp32 value before truncation lies within 1e-4
  of an integer (a .5 tie: the C++ filter, built with ``-ffast-math``,
  fuses multiply-adds that the port rounds twice), over the train (RRC +
  flip), val, identity and CIFAR padding parameters and boxes at the
  image's edges, and the card's band kernel's edges (outputs of 1, 129 and
  300, windows 16x the output, upscaled windows, windows past both edges,
  flips); its first cases measured 384 such bytes in 18.3M.
  ``tap_bound`` holds every tap count of the plain version's taps.

Decoding tests skip where libjpeg's header is missing; the JAX comparisons
need ``native/libimagepipe.so``.
"""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from schemanet_torch.data import datasets as port_datasets
from schemanet_torch.data import jpeg
from schemanet_torch.ops.kernels import imagepipe as ip
from schemanet_tpu.data import augment as jax_augment
from schemanet_tpu.data import datasets as jax_datasets
from tests import _torch_ycc_tiling as ycc_tiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".JPEG"))
REFUSED = ("cmyk_160x120.JPEG", "png_named_jpeg_130x90.JPEG")
TIE = 1e-4  # |u - round(u)| where the C++ filter's byte may differ by one


@pytest.fixture
def libjpeg():
    if jpeg.decode_route() != jpeg.LIBJPEG:
        pytest.skip("libjpeg's jpeglib.h is not installed: the host decode route is absent")


@pytest.fixture
def native():
    from schemanet_tpu.data import native as jax_native

    if not jax_native.jpeg_available():
        pytest.skip("native/libimagepipe.so (the JAX package's libjpeg route) is not built")
    return jax_native


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def test_fixtures_are_small_and_complete():
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert total < 2 * 2**20
    pixels = np.load(os.path.join(FIXTURES, "pixels.npz"))
    stems = {f[:-5] for f in FILES}
    assert set(pixels.files) <= stems and len(FILES) >= 45
    assert {f[:-5] for f in REFUSED} <= stems - set(pixels.files)


@pytest.mark.parametrize("name", FILES)
def test_host_decode_matches_jax_native(libjpeg, native, name):
    data = _read(name)
    got, want = jpeg.decode_jpeg(data), native.decode_jpeg(data)
    if name in REFUSED:
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got, want)
    assert jpeg.jpeg_header(data)[:2] == native.jpeg_dims(data)


def test_host_decode_matches_committed_pixels(libjpeg):
    pixels = np.load(os.path.join(FIXTURES, "pixels.npz"))
    for stem in pixels.files:
        np.testing.assert_array_equal(jpeg.decode_jpeg(_read(stem + ".JPEG")), pixels[stem],
                                      err_msg=stem)
    assert jpeg.jpeg_header(_read("cmyk_160x120.JPEG")) == (120, 160, 4)
    assert jpeg.jpeg_header(_read("png_named_jpeg_130x90.JPEG")) is None
    assert not any(jpeg.decodable(jpeg.jpeg_header(_read(f))) for f in REFUSED)


@pytest.mark.parametrize("name", REFUSED)
def test_refused_files_raise_without_pillow(libjpeg, tmp_path, monkeypatch, name):
    os.makedirs(tmp_path / "c")
    path = tmp_path / "c" / name
    path.write_bytes(_read(name))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(jpeg.RefusedImage, match=name):
        jpeg.read_image(str(path))
    ds = port_datasets.ImageFolderDataset(str(tmp_path))
    with pytest.raises(jpeg.RefusedImage, match=name):
        ds[0]


@pytest.mark.parametrize("name", REFUSED)
def test_refused_files_equal_jax_pil_route(libjpeg, tmp_path, name):
    os.makedirs(tmp_path / "c")
    (tmp_path / "c" / name).write_bytes(_read(name))
    got, label = port_datasets.ImageFolderDataset(str(tmp_path))[0]
    want, want_label = jax_datasets.ImageFolderDataset(str(tmp_path))[0]
    np.testing.assert_array_equal(got, want)
    assert label == want_label == 0


def test_read_image_decodes_jpegs_without_pillow(libjpeg, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    pixels = np.load(os.path.join(FIXTURES, "pixels.npz"))
    np.testing.assert_array_equal(jpeg.read_image(os.path.join(FIXTURES, "gray_140x105.JPEG")),
                                  pixels["gray_140x105"])


def test_decode_route_needs_a_library(monkeypatch):
    monkeypatch.setattr(jpeg, "_route", jpeg._route)  # both restored after the test
    monkeypatch.setattr(jpeg, "_route_known", False)
    monkeypatch.setattr(jpeg, "_has_jpeglib", lambda: False)
    monkeypatch.setattr(jpeg.torch.cuda, "is_available", lambda: False)
    assert jpeg.decode_route() is None
    with pytest.raises(RuntimeError, match="no JPEG decode"):
        jpeg.jpeg_header(_read(FILES[0]))


# ---------------------------------------------------------------------------
# ycc_to_rgb: libjpeg's upsampling and colour conversion
# ---------------------------------------------------------------------------


def _planes_table(names):
    """(packed planes, meta, total, libjpeg's RGB images) of fixtures, from
    libjpeg's own component planes."""
    planes, meta, images, at, out_at = [], [], [], 0, 0
    for name in names:
        data = _read(name)
        comps = jpeg.decode_planes(data)
        rgb = jpeg.decode_jpeg(data)
        h, w = comps[0][0].shape
        if len(comps) == 1:
            meta.append((at, -1, -1, h, w, 0, 0, 1, 1, out_at))
        else:
            (hy, vy), (hc, vc) = comps[0][1], comps[1][1]
            ch, cw = comps[1][0].shape
            meta.append((at, at + h * w, at + h * w + ch * cw, h, w, cw, ch, hy // hc, vy // vc,
                         out_at))
        for plane, _ in comps:
            planes.append(plane.reshape(-1))
            at += plane.size
        images.append(rgb)
        out_at += rgb.size
    return torch.from_numpy(np.concatenate(planes)), np.asarray(meta, np.int64), out_at, images


def test_ycc_to_rgb_reference_gives_libjpegs_bytes(libjpeg):
    names = [f for f in FILES if f not in REFUSED]
    planes, meta, total, images = _planes_table(names)
    factors = {tuple(m[7:9]) for m in meta if m[1] >= 0}
    assert {(1, 1), (2, 1), (2, 2)} <= factors
    assert any(m[1] >= 0 and m[5] <= 2 for m in meta)  # a chroma plane 2 wide or less
    out = ip.ycc_to_rgb(planes, meta, total)  # a CPU tensor: the plain version
    for name, m, rgb in zip(names, meta, images):
        np.testing.assert_array_equal(out[m[9]:m[9] + rgb.size].numpy().reshape(rgb.shape), rgb,
                                      err_msg=name)


def test_ycc_to_rgb_rejects_bad_tables():
    planes = torch.zeros(100, dtype=torch.uint8)
    good = np.array([[0, 16, 20, 4, 4, 2, 2, 2, 2, 0]], np.int64)
    assert ip.ycc_to_rgb(planes, good, 48).shape == (48,)
    for col, value in ((3, 0), (0, 90), (5, 1), (9, 1)):
        bad = good.copy()
        bad[0, col] = value
        with pytest.raises(ValueError):
            ip.ycc_to_rgb(planes, bad, 48)


def _tile_cover(h, w):
    """How many of each image's tiles cover each pixel, and the tiles."""
    cover = np.zeros((h, w), np.int32)
    rects = [ycc_tiles.tile_rect(h, w, k) for k in range(int(ycc_tiles.tile_counts(h, w)))]
    for y0, x0, nr, nc in rects:
        cover[y0:y0 + nr, x0:x0 + nc] += 1
    return cover, rects


@settings(max_examples=150, deadline=None)
@given(h=st.integers(1, 300), w=st.integers(1, 5000))
@example(h=1, w=1)
@example(h=3, w=5)
@example(h=7, w=5000)
@example(h=129, w=257)
@example(h=5, w=2049)
def test_ycc_tiles_cover_every_pixel_once(h, w):
    """The kernel's tiles of an image, by the tiling model
    (``tests/_torch_ycc_tiling.py``, a copy of the kernel library's host
    half, which the card test ``test_ycc_records_equal_the_tiling_model``
    holds to the library word for word): every pixel in exactly one tile;
    each tile a band from an even row whose rows are even but at the image's
    last row, so no 1h2v or 2h2v chroma row pair straddles two tiles; at
    most 2,048 columns and 128 groups of 2 x 16 pixels (a block's threads);
    a chunk spans whole rows unless the image is wider."""
    cover, rects = _tile_cover(h, w)
    assert (cover == 1).all()
    chunks, chunk_w, band = (int(v) for v in ycc_tiles.tiling(w))
    assert chunk_w % 16 == 0 and chunk_w <= ycc_tiles.COLS and band % 2 == 0
    assert (chunks == 1) == (w <= ycc_tiles.COLS)
    assert (band // 2) * (chunk_w // 16) <= ycc_tiles.THREADS
    for y0, x0, nr, nc in rects:
        assert y0 % 2 == 0 and (nr % 2 == 0 or y0 + nr == h)
        assert x0 % 16 == 0 and 1 <= nc <= ycc_tiles.COLS and nr >= 1


def test_ycc_tile_counts_sum_over_a_batch():
    """The tile prefix over ragged sizes: the counts are the tiles that
    ``tile_rect`` enumerates, image by image."""
    hs = np.array([1, 3, 375, 500, 2, 9000, 1])
    ws = np.array([1, 5, 500, 375, 5000, 3, 257])
    counts = ycc_tiles.tile_counts(hs, ws)
    for h, w, c in zip(hs.tolist(), ws.tolist(), counts.tolist()):
        cover, rects = _tile_cover(h, w)
        assert len(rects) == c and (cover == 1).all()


def test_ycc_records_hold_the_table_and_its_tiling():
    """The model's records over a ragged table of every mode: each is the
    file's 10 columns and its tiling, the tile prefix is exclusive, and
    65536 // tc + 1 divides every thread index of a block by tc exactly,
    for every tc a tiling gives."""
    from schemanet_torch.kernel_times import YCC_MODES, YCC_SIZES

    cases = [(h, w, hs, vs) for hs, vs in YCC_MODES for h, w in YCC_SIZES]
    table = ycc_tiles.table_of(cases)[0]
    n = len(table)
    words = ycc_tiles.records(table)
    assert words.shape == (n * (ip.YCC_REC + 1),)
    rec, starts = words[:n * ip.YCC_REC].reshape(n, ip.YCC_REC), words[n * ip.YCC_REC:]
    counts = ycc_tiles.tile_counts(table[:, 3], table[:, 4])
    np.testing.assert_array_equal(rec[:, :ip.YCC_META], table)
    np.testing.assert_array_equal(starts, np.cumsum(counts) - counts)
    chunks, chunk_w, band = ycc_tiles.tiling(table[:, 4])
    np.testing.assert_array_equal(rec[:, 10:12], np.stack([chunks, chunk_w], 1))
    tc, tr = rec[:, 12] & 0xFFFF, rec[:, 12] >> 16
    np.testing.assert_array_equal(tc, chunk_w // 16)
    np.testing.assert_array_equal(2 * tr, band)
    assert (tc * tr <= ycc_tiles.THREADS).all()
    t = np.arange(ycc_tiles.THREADS)
    for c in range(1, ycc_tiles.THREADS + 1):
        np.testing.assert_array_equal((t * (65536 // c + 1)) >> 16, t // c)


def test_ycc_to_rgb_rejects_an_empty_table():
    with pytest.raises(ValueError, match="n >= 1"):
        ip.ycc_to_rgb(torch.zeros(4, dtype=torch.uint8), np.zeros((0, 10), np.int64), 0)


# ---------------------------------------------------------------------------
# crop_resize against the JAX package's C++ filter
# ---------------------------------------------------------------------------


def _pack(images):
    offsets = np.cumsum([0] + [im.size for im in images])[:-1]
    flat = torch.from_numpy(np.concatenate([im.reshape(-1) for im in images]))
    return flat, offsets


def _edge_boxes(h, w):
    """Boxes at the image's edges and past them (CIFAR's padding)."""
    return [(0, 0, h, w, False), (0, 0, h, w, True), (h - max(1, h // 3), w - max(1, w // 2),
                                                      max(1, h // 3), max(1, w // 2), True),
            (-4, -4, h, w, False), (4, 3, h, w, True), (0, w - 1, h, 1, False),
            (h - 1, 0, 1, w, True), (-2, -3, h + 5, w + 7, False)]


def _crop_cases():
    pixels = np.load(os.path.join(FIXTURES, "pixels.npz"))
    names = sorted(pixels.files)
    fns = [jax_augment._params_rrc_train, jax_augment._params_imagenet_val,
           jax_augment._params_identity, jax_augment._params_cifar_train]
    cases = []
    for seed in range(24):
        rng = np.random.default_rng(seed)
        images = [pixels[names[(seed * 7 + k) % len(names)]] for k in range(3)]
        params = [fns[seed % 4](im.shape, rng) for im in images]
        cases.append((images, params, (224, 37, 64)[seed % 3]))
    for name in ("s420_500x375", "s420_odd_17x9", "s420_1x1", "gray_odd_57x43"):
        im = pixels[name]
        boxes = _edge_boxes(*im.shape[:2])
        cases.append(([im] * len(boxes), boxes, 45))
    # the card's band kernel at its edges: outputs of 1, 129 and 300 (a
    # partial column tile, a partial band), windows 16x the output, upscaled
    # windows, windows past both edges, flips
    photo, odd, tall = pixels["s420_500x375"], pixels["s420_odd_127x129"], pixels["s420_tall_75x240"]
    h, w = photo.shape[:2]
    rng = np.random.default_rng(99)
    rrc = [jax_augment._params_rrc_train(photo.shape, rng) for _ in range(2)]
    past = [(-7, -9, h + 14, w + 18, True), (-3, w - 40, 60, 70, False)]
    for out in (1, 129, 300):
        cases.append(([photo] * 4 + [odd], rrc + past + [(0, 0, 129, 127, out % 2 == 1)], out))
    cases.append(([photo, photo, tall], [(10, 30, 320, 320, True), (-30, -40, 320, 320, False),
                                         (-60, -100, 320, 320, True)], 20))  # 16x
    cases.append(([photo, odd, tall, photo],
                  [(100, 200, 30, 40, True), (0, 0, 129, 127, False), (5, 3, 11, 9, True),
                   (h - 20, w - 12, 28, 17, False)], 224))  # upscaled, past the far edges
    return cases


@pytest.mark.parametrize("case", range(33))
def test_crop_resize_reference_matches_jax_native(native, case):
    images, params, out = _crop_cases()[case]
    flat, offsets = _pack(images)
    crop = np.array([[o, im.shape[0], im.shape[1], t, l, ch, cw, int(f)]
                     for o, im, (t, l, ch, cw, f) in zip(offsets, images, params)], np.int64)
    got = ip.crop_resize(flat, crop, out).numpy()  # a CPU tensor: the plain version
    u = ip.crop_resize_values(flat, crop, out).numpy()
    for b, (im, (t, l, ch, cw, f)) in enumerate(zip(images, params)):
        want = native.process_sample_u8(im, t, l, ch, cw, f, (out, out))
        diff = got[b].astype(int) - want.astype(int)
        assert np.abs(diff).max() <= 1
        off = diff != 0
        assert (np.abs(u[b] - np.round(u[b]))[off] <= TIE).all(), "a difference off a .5 tie"


@pytest.mark.parametrize("out", [1, 2, 7, 37, 129, 224, 300])
def test_tap_bound_holds_every_count(out):
    """The kernel's coefficient tables hold ``tap_bound`` taps a column: at
    least every output's tap count of the plain version's taps (which are
    the kernel's), over windows from 1 pixel to 40x the output, at offsets
    past the image's edges."""
    rng = np.random.default_rng(out)
    crops = np.unique(np.concatenate([np.arange(1, 64), rng.integers(1, 40 * out + 2, 300),
                                      [out, 2 * out, 16 * out, 16 * out + 1]]))
    for crop in crops.tolist():
        start = int(rng.integers(-50, 50))
        j, _, valid = ip._taps(start, crop, out)
        assert valid.sum(axis=1).max() <= ip.tap_bound(np.array([crop]), out), (crop, start)
    assert ip.tap_bound(np.array([3, 900, 40]), 224) == ip.tap_bound(np.array([900]), 224)


def test_crop_resize_rejects_bad_tables():
    flat = torch.zeros(5 * 4 * 3, dtype=torch.uint8)
    good = np.array([[0, 5, 4, 0, 0, 5, 4, 0]], np.int64)
    assert ip.crop_resize(flat, good, 8).shape == (1, 8, 8, 3)
    for col, value in ((0, 1), (1, 0), (5, 0), (7, 2)):
        bad = good.copy()
        bad[0, col] = value
        with pytest.raises(ValueError):
            ip.crop_resize(flat, bad, 8)
    with pytest.raises(ValueError):
        ip.crop_resize(flat, good[:, :7], 8)
