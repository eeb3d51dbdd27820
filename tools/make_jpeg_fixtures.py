"""Write the JPEG fixtures of the port's image-folder tests and
``chip_smoke.py`` (``tests/fixtures/jpeg/``), from a seed.

Each image is a seeded numpy picture (smooth colour fields, a few hard
edges and mild noise, as photographs have), saved by Pillow with the
encoder options the decode must take: odd sizes, 4:2:0, 4:2:2 and 4:4:4
chroma subsampling, grayscale, progressive scans, restart markers, a CMYK
JPEG (libjpeg has no CMYK to RGB conversion: the decode refuses it) and a
PNG named ``.JPEG`` (refused too). ``pixels.npz`` holds, for every file of
``SPECS``, the pixels that the JAX package's native libjpeg decode gives
(``schemanet_tpu.data.native.decode_jpeg``), keyed by file name without
its extension.

Needs Pillow, JAX's package tree and ``native/libimagepipe.so``
(``make -C native``); run from the repository root:

    python tools/make_jpeg_fixtures.py
"""

from __future__ import annotations

import io
import os
import sys

import numpy as np

OUT = os.path.join("tests", "fixtures", "jpeg")

# (name, (h, w), Pillow save options, mode): the decode's cases, whose
# libjpeg pixels go into pixels.npz
SPECS = [
    ("s420_500x375", (375, 500), {"subsampling": 2, "quality": 85}, "RGB"),
    ("s420_113x150", (150, 113), {"subsampling": 2, "quality": 85}, "RGB"),
    ("s420_odd_131x97", (97, 131), {"subsampling": 2, "quality": 80}, "RGB"),
    ("s420_odd_37x53", (53, 37), {"subsampling": 2, "quality": 90}, "RGB"),
    ("s420_odd_17x9", (9, 17), {"subsampling": 2, "quality": 90}, "RGB"),
    ("s420_odd_127x129", (129, 127), {"subsampling": 2, "quality": 75}, "RGB"),
    ("s420_wide_320x81", (81, 320), {"subsampling": 2, "quality": 80}, "RGB"),
    ("s420_tall_75x240", (240, 75), {"subsampling": 2, "quality": 80}, "RGB"),
    ("s420_1x1", (1, 1), {"subsampling": 2}, "RGB"),
    ("s420_224x224", (224, 224), {"subsampling": 2, "quality": 95}, "RGB"),
    ("s420_q50_120x90", (90, 120), {"subsampling": 2, "quality": 50}, "RGB"),
    ("s422_150x100", (100, 150), {"subsampling": 1, "quality": 85}, "RGB"),
    ("s422_odd_101x77", (77, 101), {"subsampling": 1, "quality": 85}, "RGB"),
    ("s422_odd_63x31", (31, 63), {"subsampling": 1, "quality": 90}, "RGB"),
    ("s444_160x120", (120, 160), {"subsampling": 0, "quality": 85}, "RGB"),
    ("s444_odd_99x121", (121, 99), {"subsampling": 0, "quality": 90}, "RGB"),
    ("s444_odd_13x200", (200, 13), {"subsampling": 0, "quality": 90}, "RGB"),
    ("gray_140x105", (105, 140), {"quality": 85}, "L"),
    ("gray_odd_57x43", (43, 57), {"quality": 90}, "L"),
    ("gray_progressive_96x120", (120, 96), {"quality": 85, "progressive": True}, "L"),
    ("prog_s420_160x120", (120, 160), {"subsampling": 2, "quality": 85, "progressive": True},
     "RGB"),
    ("prog_s444_odd_111x87", (87, 111), {"subsampling": 0, "quality": 85,
                                          "progressive": True}, "RGB"),
    ("prog_s422_odd_45x67", (67, 45), {"subsampling": 1, "quality": 90, "progressive": True},
     "RGB"),
    ("restart_s420_128x96", (96, 128), {"subsampling": 2, "quality": 85,
                                         "restart_marker_blocks": 4}, "RGB"),
    ("restart_rows_s444_101x83", (83, 101), {"subsampling": 0, "quality": 85,
                                              "restart_marker_rows": 1}, "RGB"),
    ("restart_prog_s420_90x70", (70, 90), {"subsampling": 2, "quality": 85,
                                            "progressive": True,
                                            "restart_marker_blocks": 8}, "RGB"),
    ("optimize_s420_120x90", (90, 120), {"subsampling": 2, "quality": 85, "optimize": True},
     "RGB"),
    # chroma planes 2 wide: libjpeg replicates instead of its fancy filter
    ("s420_odd_3x5", (5, 3), {"subsampling": 2, "quality": 90}, "RGB"),
    ("s422_4x7", (7, 4), {"subsampling": 1, "quality": 90}, "RGB"),
]
# 4:2:0 photograph-like files at ImageNet's usual sizes: what an image-folder
# tree is mostly made of (the loader's and stage 1's inputs); their pixels
# are left out of pixels.npz to keep the fixtures small (the CPU tests hold
# them to the JAX package's decode directly)
PHOTOS = [(f"photo_{_i:02d}_{_hw[1]}x{_hw[0]}", _hw, {"subsampling": 2,
                                                       "quality": 75 + (_i % 4) * 5}, "RGB")
          for _i, _hw in enumerate([(375, 500), (333, 500), (500, 375), (400, 500),
                                    (281, 500), (500, 333), (366, 500), (427, 640),
                                    (480, 640), (300, 450), (334, 500), (500, 500),
                                    (269, 350), (188, 250), (315, 420), (458, 500)])]


def picture(rng: np.random.Generator, h: int, w: int, noise: float = 1.0) -> np.ndarray:
    """uint8 [h, w, 3]: smooth colour fields, a few discs and bars with hard
    edges, and noise of a few levels."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for c in range(3):
        fx, fy, ph = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.uniform(0, 2 * np.pi)
        img[..., c] = 128 + 80 * np.sin(2 * np.pi * fx * xx / max(w, 1) + ph) * np.cos(
            2 * np.pi * fy * yy / max(h, 1))
    for _ in range(int(rng.integers(2, 6))):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.05, 0.3) * max(h, w)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 255, size=3)
    y0 = int(rng.integers(0, h))
    img[y0:y0 + max(1, h // 12)] = rng.uniform(0, 255, size=3)
    img += rng.normal(scale=noise, size=img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def main() -> None:
    from PIL import Image

    sys.path.insert(0, os.getcwd())
    from schemanet_tpu.data import native

    if not native.jpeg_available():
        sys.exit("needs native/libimagepipe.so with its libjpeg decode (make -C native)")
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(20261018)
    pixels = {}
    for name, (h, w), opts, mode in SPECS + PHOTOS:
        rgb = picture(rng, h, w, noise=0.0 if name.startswith("photo_") else 1.0)
        im = Image.fromarray(rgb)
        if mode == "L":
            im = im.convert("L")
        path = os.path.join(OUT, f"{name}.JPEG")
        im.save(path, "JPEG", **opts)
        with open(path, "rb") as f:
            decoded = native.decode_jpeg(f.read())
        if decoded is None:
            sys.exit(f"the native decode refused {path}")
        if not name.startswith("photo_"):
            pixels[name] = decoded
    # refused by libjpeg's decode to RGB: a CMYK JPEG and a PNG named .JPEG
    cmyk = Image.fromarray(picture(rng, 120, 160)).convert("CMYK")
    cmyk.save(os.path.join(OUT, "cmyk_160x120.JPEG"), "JPEG", quality=85)
    buf = io.BytesIO()
    Image.fromarray(picture(rng, 90, 130)).save(buf, "PNG")
    with open(os.path.join(OUT, "png_named_jpeg_130x90.JPEG"), "wb") as f:
        f.write(buf.getvalue())
    for name in ("cmyk_160x120", "png_named_jpeg_130x90"):
        with open(os.path.join(OUT, f"{name}.JPEG"), "rb") as f:
            if native.decode_jpeg(f.read()) is not None:
                sys.exit(f"the native decode took {name}, which it should refuse")
    np.savez_compressed(os.path.join(OUT, "pixels.npz"), **pixels)
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"{len(os.listdir(OUT)) - 1} files and pixels.npz in {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
