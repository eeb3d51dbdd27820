"""JPEG decode for the image-folder datasets: on the host with libjpeg, or on
the card with nvJPEG (the counterpart of the decode half of
``schemanet_tpu/data/native.py``).

Two routes, chosen once by what the machine has installed (``decode_route``):

* ``"libjpeg"``: where the host's C++ compiler finds ``jpeglib.h``. The
  port's copy of ``ip_jpeg_dims``/``ip_decode_jpeg``
  (``native/src/imagepipe.cpp``), ``csrc/host/jpeg.cpp``, is built at first
  use into ``_build/libschemanet_jpeg_<hash>.so``, a library of its own (the
  CUDA kernels' never links libjpeg). Same libjpeg, same bytes as the JAX
  package's native decode.
* ``"nvjpeg"``: where libjpeg is missing and the CUDA toolkit has nvJPEG
  and a card is present. ``csrc/host/nvjpeg.cpp``, built by ``nvcc`` at
  first use, decodes each file's component planes into device memory and
  ``ops/kernels/imagepipe.py`` ``ycc_to_rgb`` upsamples and converts them
  as libjpeg does (``decode_to_device``); the loader reads only the
  headers on the host. nvJPEG's IDCT is not libjpeg's, so its pixels differ
  from libjpeg's by a few levels.

The route never changes because a decode failed. A file the route refuses
(libjpeg cannot read a PNG named ``.JPEG`` or convert a CMYK JPEG to RGB;
the nvJPEG route refuses the same two by their headers) goes to Pillow
where Pillow is importable, as the JAX loader does, and otherwise raises,
naming the file. No sample is skipped.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
_HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
LIBJPEG, NVJPEG = "libjpeg", "nvjpeg"

_lock = threading.Lock()
_route: Optional[str] = None
_route_known = False
_libs = {}


class RefusedImage(RuntimeError):
    """A file that no installed decode route can read (and Pillow is absent)."""


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


def _has_jpeglib() -> bool:
    """Whether the host's C++ compiler finds ``jpeglib.h``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    probe = "#include <cstdio>\n#include <jpeglib.h>\n"
    proc = subprocess.run([cxx, "-fsyntax-only", "-x", "c++", "-"], input=probe, text=True,
                          capture_output=True)
    return proc.returncode == 0


def _has_nvjpeg() -> bool:
    home = _cuda_home()
    libs = [home / "lib64", home / "targets" / "x86_64-linux" / "lib"]
    return ((home / "include" / "nvjpeg.h").exists()
            and any((d / "libnvjpeg.so").exists() for d in libs)
            and torch.cuda.is_available())


def decode_route() -> Optional[str]:
    """``"libjpeg"`` where the host has libjpeg's header, else ``"nvjpeg"``
    where the CUDA toolkit has nvJPEG and a card is present, else None
    (every decode then raises). Decided once a process."""
    global _route, _route_known
    with _lock:
        if not _route_known:
            _route = LIBJPEG if _has_jpeglib() else NVJPEG if _has_nvjpeg() else None
            _route_known = True
        return _route


def _build(name: str, src: Path, cmd_for) -> ctypes.CDLL:
    """Compile ``src`` into ``_build/lib<name>_<hash>.so`` unless that build
    exists, and load it."""
    digest = hashlib.sha256(src.read_bytes() + Path(__file__).read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(cmd_for(str(tmp)), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src.name} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def _library(route: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(route)
        if lib is not None:
            return lib
        _P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        if route == LIBJPEG:
            cxx = shutil.which("g++") or shutil.which("c++")
            src = _HOST_SRC / "jpeg.cpp"
            lib = _build("schemanet_jpeg", src, lambda out: [
                cxx, "-O2", "-fPIC", "-shared", "-std=c++17", str(src), "-ljpeg", "-o", out])
            lib.sn_jpeg_dims.argtypes = [_P, _L, _P, _P, _P]
            lib.sn_decode_jpeg.argtypes = [_P, _L, _P]
            lib.sn_jpeg_planes.argtypes = [_P, _L, _P, _L, _P]
        else:
            nvcc = shutil.which("nvcc") or str(_cuda_home() / "bin" / "nvcc")
            src = _HOST_SRC / "nvjpeg.cpp"
            lib = _build("schemanet_nvjpeg", src, lambda out: [
                nvcc, "-O2", "-std=c++17", "-Xcompiler", "-fPIC", "-shared", str(src),
                "-lnvjpeg", "-o", out])
            lib.sn_nvjpeg_info.argtypes = [_P, _L] + [_P] * 6
            lib.sn_nvjpeg_decode.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P]
        for fn in ("sn_jpeg_dims", "sn_decode_jpeg", "sn_jpeg_planes", "sn_nvjpeg_info",
                   "sn_nvjpeg_decode"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
        _libs[route] = lib
        return lib


def _require_route() -> str:
    route = decode_route()
    if route is None:
        raise RuntimeError("no JPEG decode is installed: the host route needs libjpeg's "
                           "jpeglib.h and a C++ compiler, the card's route nvJPEG "
                           f"({_cuda_home()}/include/nvjpeg.h) and a CUDA device")
    return route


def _buffer(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


# nvJPEG's chroma subsampling codes -> (h factor, v factor) of the chroma
# planes: the ones whose libjpeg upsampling ycc_to_rgb reproduces
_NVJPEG_FACTORS = {0: (1, 1), 1: (2, 1), 2: (2, 2), 3: (1, 2), 4: (4, 1), 5: (4, 2)}
_NVJPEG_GRAY = 6


def _nvjpeg_info(data: bytes):
    """(h, w, components, subsampling code, chroma h, chroma w), or None."""
    buf = _buffer(data)
    vals = [ctypes.c_int() for _ in range(6)]
    rc = _library(NVJPEG).sn_nvjpeg_info(buf.ctypes.data, len(buf),
                                         *(ctypes.byref(v) for v in vals))
    return None if rc != 0 else tuple(v.value for v in vals)


def jpeg_header(data: bytes) -> Optional[Tuple[int, int, int]]:
    """(h, w, components) from the header of ``data`` on this machine's
    route, or None where the route cannot read it. On the nvJPEG route the
    components read 0 where the chroma subsampling is not one whose libjpeg
    upsampling the route reproduces."""
    route = _require_route()
    if route == NVJPEG:
        info = _nvjpeg_info(data)
        if info is None or info[0] <= 0 or info[1] <= 0:
            return None
        h, w, comps, ss = info[:4]
        known = (comps == 1 and ss == _NVJPEG_GRAY) or (comps == 3 and ss in _NVJPEG_FACTORS)
        return h, w, comps if known else 0
    buf = _buffer(data)
    h, w, comps = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _library(route).sn_jpeg_dims(buf.ctypes.data, len(buf), ctypes.byref(h),
                                      ctypes.byref(w), ctypes.byref(comps))
    if rc != 0 or h.value <= 0 or w.value <= 0:
        return None
    return h.value, w.value, comps.value


def decodable(header: Optional[Tuple[int, int, int]]) -> bool:
    """Whether a file with this header decodes to RGB on either route: one
    gray or three colour components (libjpeg has no CMYK to RGB
    conversion, and the nvJPEG route refuses what libjpeg refuses)."""
    return header is not None and header[2] in (1, 3)


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 [h, w, 3] RGB by libjpeg on the host, or None
    where libjpeg refuses them (the JAX package's ``native.decode_jpeg``).
    The host route only."""
    if _require_route() != LIBJPEG:
        raise RuntimeError("decode_jpeg is the host route's; this machine decodes with nvJPEG "
                           "(decode_to_device)")
    header = jpeg_header(data)
    if header is None:
        return None
    h, w, _ = header
    out = np.empty((h, w, 3), np.uint8)
    buf = _buffer(data)
    if _library(LIBJPEG).sn_decode_jpeg(buf.ctypes.data, len(buf), out.ctypes.data) != 0:
        return None
    return out


def decode_planes(data: bytes):
    """Host route: libjpeg's component planes before its upsampling and
    colour conversion, as ``[(plane uint8 [h, w], (h_samp, v_samp))]``, or
    None where refused. For the tests of ``ycc_to_rgb``."""
    header = jpeg_header(data)
    if header is None:
        return None
    dims = np.zeros(12, np.int32)
    cap = header[0] * header[1] * 3 + 64
    out = np.empty(cap, np.uint8)
    buf = _buffer(data)
    nc = _library(LIBJPEG).sn_jpeg_planes(buf.ctypes.data, len(buf), out.ctypes.data, cap,
                                          dims.ctypes.data)
    if nc < 0:
        return None
    planes, at = [], 0
    for c in range(nc):
        w, h, hf, vf = dims[4 * c:4 * c + 4]
        planes.append((out[at:at + w * h].reshape(h, w).copy(), (int(hf), int(vf))))
        at += w * h
    return planes


def decode_to_device(blobs: Sequence[bytes], device, names: Optional[Sequence[str]] = None
                     ) -> Tuple[torch.Tensor, List[int]]:
    """nvJPEG route: decode ``blobs`` (each ``decodable``) on the card, on
    the current stream, into one packed uint8 buffer of RGB HWC images;
    returns it with each image's offset. nvJPEG decodes the component
    planes, ``ycc_to_rgb`` (one launch) upsamples and converts them as
    libjpeg does. A file nvJPEG fails on raises ``RefusedImage`` naming it
    (``names``: the files' paths, else their places in ``blobs``)."""
    from ..ops.kernels.imagepipe import YCC_META, ycc_to_rgb

    if _require_route() != NVJPEG:
        raise RuntimeError("decode_to_device is the nvJPEG route's; this machine decodes "
                           "on the host with libjpeg")
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the nvJPEG route decodes on a CUDA device")
    n = len(blobs)
    names = list(names) if names is not None else [f"image {i} of the batch" for i in range(n)]
    meta = np.zeros((n, YCC_META), np.int64)
    plane_off = np.zeros((n, 3), np.int64)
    pitch = np.zeros((n, 3), np.int32)
    gray = np.zeros(n, np.int32)
    at = out_at = 0
    for i, data in enumerate(blobs):
        info = _nvjpeg_info(data)
        if info is None:
            raise RefusedImage(f"{names[i]}: nvJPEG cannot read its header")
        h, w, comps, ss, chh, cw = info
        if comps == 1:
            gray[i] = 1
            plane_off[i] = (at, -1, -1)
            pitch[i] = (w, 0, 0)
            meta[i] = (at, -1, -1, h, w, 0, 0, 1, 1, out_at)
            at += h * w
        else:
            hs, vs = _NVJPEG_FACTORS[ss]
            plane_off[i] = (at, at + h * w, at + h * w + chh * cw)
            pitch[i] = (w, cw, cw)
            meta[i] = (*plane_off[i], h, w, cw, chh, hs, vs, out_at)
            at += h * w + 2 * chh * cw
        out_at += h * w * 3
    planes = torch.empty(max(at, 1), dtype=torch.uint8, device=device)
    packed = np.concatenate([_buffer(b) for b in blobs]) if blobs else np.zeros(0, np.uint8)
    byte_off = np.concatenate([[0], np.cumsum([len(b) for b in blobs])]).astype(np.int64)
    failed = ctypes.c_int(-1)
    with torch.cuda.device(device):
        rc = _library(NVJPEG).sn_nvjpeg_decode(
            n, packed.ctypes.data, byte_off.ctypes.data, plane_off.ctypes.data,
            pitch.ctypes.data, gray.ctypes.data, planes.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream, ctypes.byref(failed))
        if rc != 0:
            raise RefusedImage(f"{names[failed.value]}: nvJPEG failed (status {rc})")
        out = ycc_to_rgb(planes, meta, out_at)
    return out, [int(o) for o in meta[:, 9]]


def pillow_rgb(path: str) -> np.ndarray:
    """uint8 [h, w, 3] of an image file through Pillow (the JAX loader's PIL
    route), or ``RefusedImage`` naming the file where Pillow is absent."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise RefusedImage(f"{path}: the {decode_route()} route cannot decode this file and "
                           "Pillow, which could, is not installed") from exc
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def is_jpeg_name(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def read_image(path: str, device=None) -> np.ndarray:
    """uint8 [h, w, 3] RGB of one image file: a JPEG through this machine's
    route (nvJPEG decodes on ``device``, default the current CUDA device,
    and the pixels come back to the host), any other file or a refused one
    through Pillow (``RefusedImage`` naming the file without it)."""
    if not is_jpeg_name(path):
        return pillow_rgb(path)
    with open(path, "rb") as f:
        data = f.read()
    route = _require_route()
    if route == LIBJPEG:
        img = decode_jpeg(data)
        return pillow_rgb(path) if img is None else img
    header = jpeg_header(data)
    if not decodable(header):
        return pillow_rgb(path)
    out, _ = decode_to_device([data], device if device is not None else "cuda", [path])
    return out.view(header[0], header[1], 3).cpu().numpy()
