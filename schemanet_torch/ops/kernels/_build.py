"""Build and load the hand-written CUDA kernels at first use.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all started
together, and the objects link into ONE shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds, not minutes). The library lands in ``schemanet_torch/_build/``, named
by a hash of the sources, so an edited source builds anew and an unchanged one
is reused. Nothing here runs at import: the build starts when a CUDA tensor
first reaches a kernel, and a machine without ``nvcc`` fails there, loudly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
# C signatures of the launchers (csrc/*.cu, extern "C"); every one returns the
# cudaError_t of its launch, except where noted
_SIGNATURES = {
    "sn_attn_block": [_I] + [_P] * 12 + [_I] * 5 + [_F, _F, _P],
    "sn_ffn_block": [_I] + [_P] * 8 + [_I] * 3 + [_F, _P],
    "sn_sym_conv": [_I, _P, _P, _P, _I, _I, _I, _P],
    "sn_sym_conv_bwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "sn_embed_offsets": [_P, _P, _L, _I, _P],
    "sn_embed_grad": [_I, _I] + [_P] * 6 + [_L, _I, _I, _P],
    "sn_adamw_project_rows": [_P] * 4 + [_L, _I, _I, _I] + [_F] * 9 + [_P],
    "sn_fused_mhsa": [_I, _P, _P] + [_I] * 4 + [_F] * 3 + [_I, _P],
    "sn_fused_mhsa_bwd": [_I] + [_P] * 4 + [_I] * 4 + [_F] * 3 + [_I, _P],
    "sn_fused_mlp": [_I] + [_P] * 6 + [_I] * 3 + [_F, _F, _I, _P],
    "sn_fused_mlp_bwd": [_I] + [_P] * 9 + [_I] * 4 + [_F, _F, _I, _P],
    "sn_vq_assign": [_I] + [_P] * 5 + [_I] * 4 + [_P],
    "sn_layernorm_fwd": [_I] + [_P] * 4 + [_L, _I, _F, _I, _P],
    "sn_layernorm_bwd": [_I, _I] + [_P] * 7 + [_L, _I, _F, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last compile, None if reused


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    digest = hashlib.sha256()
    for path in cu + cuh + [Path(__file__)]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libschemanet_kernels_{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_seconds
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    # one nvcc per source, all at once: the build takes as long as its slowest file
    procs = [
        subprocess.Popen(
            [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(cu, objects)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        failed = [(src.name, proc.returncode, log) for src, proc, log in zip(cu, procs, logs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        link = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    # the ptxas register/shared-memory report of every source, kept beside the library
    out.with_suffix(".log").write_text(
        "\n".join(f"== {src.name}\n{log}" for src, log in zip(cu, logs)))


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if this source hash has no build."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
