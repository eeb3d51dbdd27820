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
  image's edges; its first cases measured 384 such bytes in 18.3M.

Decoding tests skip where libjpeg's header is missing; the JAX comparisons
need ``native/libimagepipe.so``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from schemanet_torch.data import datasets as port_datasets
from schemanet_torch.data import jpeg
from schemanet_torch.ops.kernels import imagepipe as ip
from schemanet_tpu.data import augment as jax_augment
from schemanet_tpu.data import datasets as jax_datasets

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
    return cases


@pytest.mark.parametrize("case", range(28))
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
