"""Variants of three port kernels, timed side by side on the card.

Each variant is a copy of a ``schemanet_torch/csrc`` source with text
replacements, built alone by nvcc into a library of its own under
``schemanet_torch/_build/variants/`` and timed through its C launcher (CUDA
events over 50 calls after 5) on the shapes of its kernel's table rows:

* ``int8``: ``int8_gemm`` (``csrc/quant.cu``) at the 12 projections of
  DeiT-Tiny, -Small and -Base on 12,608 rows (bf16 out, with bias), beside
  ``torch._int_mm`` on the same operands (the int32 product alone) and the
  bound. Variants: ``kernel`` as built; ``no_stores``, the finished tiles
  never written to y (the stores' share); ``products_only``, no epilogue
  and no stores (the TMA ring and the products alone).
* ``crop``: ``crop_resize`` (``csrc/imagepipe.cu``) on chip_smoke.py phase
  34's batch (64 photo-sized images, training crops, 224^2). Variants:
  ``kernel`` as built (x coefficients in registers); ``tables``, the shared
  x table instead; ``one_tap``, a row's horizontal sum over its first tap
  alone (the horizontal taps' share).
* ``ycc``: ``ycc_to_rgb`` (``csrc/imagepipe.cu``) on chip_smoke.py phase
  34's batch (64 photo-sized 4:2:0 files, planes packed as
  ``decode_to_device`` lays them out). Variants: ``kernel`` as built (6
  blocks an SM, 80 registers); ``blocks5``, 5 blocks an SM (96
  registers); ``blocks8``, the register cap of 8 blocks an SM (64 registers);
  ``threads256``, blocks of 256 threads (tiles of 8,192 pixels);
  ``late_down``, the 2h2v group's lower chroma rows loaded after its upper
  row is written (fewer live registers), and ``late_down8`` with 64;
  ``no_near``, the 2h2v filter's 3 x column sum + bias not kept a column;
  ``gray_only``, every file taken as gray (Y read, RGB written: the loads
  and stores without the chroma); ``no_writeout``, the tile staged but
  never written (the loads and arithmetic alone). Each call is the
  launcher's host half, the records' upload and the kernel, so these times
  run ~0.01 ms over the profiler's kernel time.

Outputs of a variant that drops work differ from the kernel's (noted, not
checked). Run on the card from the repository's root:

    python tools/kernel_variants_torch.py int8 crop ycc

Prints the card's name and power limit, each variant's registers and
spills from ptxas, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "schemanet_torch", "csrc")
OUT = os.path.join(ROOT, "schemanet_torch", "_build", "variants")
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long

INT8 = {
    "kernel": [],
    "no_stores": [("    if (r >= rows || c >= n) return;\n    const uint8_t* src",
                   "    if (r >= rows || c >= n || i >= 0) return;\n    const uint8_t* src")],
    "products_only": [("    wg_fence_regs(acc);\n\n    // the epilogue",
                       "    wg_fence_regs(acc);\n    if (acc[0] != 123456789) continue;\n\n"
                       "    // the epilogue")],
}
CROP = {
    "kernel": [],
    "tables": [("  if (tx_max <= kRegTaps && table_y <= (size_t)kCropTable)", "  if (false)")],
    "one_tap": [("        for (int j = 0; j < kRegTaps; ++j) {\n          const int sx = mine.lo + j;",
                 "        for (int j = 0; j < 1; ++j) {\n          const int sx = mine.lo + j;")],
}

YCC = {
    "kernel": [],
    "blocks5": [("constexpr int kYccBlocks = 6;", "constexpr int kYccBlocks = 5;")],
    "blocks8": [("constexpr int kYccBlocks = 6;", "constexpr int kYccBlocks = 8;")],
    "threads256": [("constexpr int kYccThreads = 128;", "constexpr int kYccThreads = 256;"),
                   ("constexpr int kYccCols = 2048;", "constexpr int kYccCols = 4096;"),
                   ("constexpr int kYccStage = 12320;", "constexpr int kYccStage = 24608;"),
                   ("constexpr int kYccBlocks = 6;", "constexpr int kYccBlocks = 3;")],
    "late_down": [
        ("      const Chroma10 bd = load10(cbp + down, xs >> 1, cw);\n", ""),
        ("      const Chroma10 rd = load10(crp + down, xs >> 1, cw);\n", ""),
        ("      if (two) {\n        const H2V2 b(bm, bd), c(rm, rd);",
         "      if (two) {\n        const Chroma10 bd = load10(cbp + down, xs >> 1, cw);\n"
         "        const Chroma10 rd = load10(crp + down, xs >> 1, cw);\n"
         "        const H2V2 b(bm, bd), c(rm, rd);")],
    "late_down8": [("constexpr int kYccBlocks = 6;", "constexpr int kYccBlocks = 8;"),
                   ("      const Chroma10 bd = load10(cbp + down, xs >> 1, cw);\n", ""),
                   ("      const Chroma10 rd = load10(crp + down, xs >> 1, cw);\n", ""),
                   ("      if (two) {\n        const H2V2 b(bm, bd), c(rm, rd);",
                    "      if (two) {\n        const Chroma10 bd = load10(cbp + down, xs >> 1, cw);\n"
                    "        const Chroma10 rd = load10(crp + down, xs >> 1, cw);\n"
                    "        const H2V2 b(bm, bd), c(rm, rd);")],
    "no_near": [("      near[k] = 3 * cs[k] + 8;\n", ""),
                ("    return (l & 1) ? (near[i] + cs[i + 1] - 1) >> 4 : (near[i] + cs[i - 1]) >> 4;",
                 "    return (l & 1) ? (3 * cs[i] + cs[i + 1] + 7) >> 4 : (3 * cs[i] + cs[i - 1] + 8) >> 4;")],
    "gray_only": [("  const int mode = m[1] < 0 ", "  const int mode = true ")],
    "no_writeout": [("  if (r < runs) {\n", "  if (r < runs && tile < 0) {\n")],
}


def build(tag: str, source: str, patches: list):
    text = open(os.path.join(CSRC, source)).read()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"variant {tag}: its patch no longer applies to {source}")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, f"{tag}.cu"), os.path.join(OUT, f"lib{tag}.so")
    with open(cu, "w") as f:
        f.write(text)
    return subprocess.Popen(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
                             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def build_all(specs: dict) -> dict:
    """{tag: loaded library}, every variant built at once."""
    procs = {tag: build(tag, source, patches) for tag, (source, patches) in specs.items()}
    libs = {}
    for tag, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {tag} failed to build:\n{log[-4000:]}")
        print(tag, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln],
              flush=True)
        libs[tag] = ctypes.CDLL(so)
    return libs


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def int8_rows(dev) -> dict:
    libs = build_all({f"int8_{tag}": ("quant.cu", p) for tag, p in INT8.items()})
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows, out = 64 * 197, {}
    for d in (192, 384, 768):
        for name, n, k in (("qkv", 3 * d, d), ("out", d, d), ("fc1", 4 * d, d),
                           ("fc2", d, 4 * d)):
            a = torch.randint(-127, 128, (rows, k), generator=g, dtype=torch.int8).to(dev)
            w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(dev)
            a_s, w_s, b = (torch.rand(rows, generator=g).to(dev), torch.rand(n, generator=g).to(dev),
                           torch.rand(n, generator=g).to(dev))
            y = torch.empty(rows, n, dtype=torch.bfloat16, device=dev)
            row = {}
            for tag, lib in libs.items():
                fn = lib.sn_int8_gemm
                fn.argtypes = [I] + [P] * 6 + [L, I, I, P]
                args = (1, a.data_ptr(), w.data_ptr(), a_s.data_ptr(), w_s.data_ptr(),
                        b.data_ptr(), y.data_ptr(), rows, n, k, stream)
                if fn(*args) != 0:
                    raise SystemExit(f"{tag} refused {rows} x {n} x {k}")
                row[tag.removeprefix("int8_")] = time_ms(lambda: fn(*args))
            row["int_mm"] = time_ms(lambda: torch._int_mm(a, w.t()))
            row["bound"] = max(2 * rows * n * k / 1979e12,
                               (rows * k + n * k + 2 * rows * n) / 3.35e12) * 1e3
            out[f"int8_gemm_{name}_d{d}"] = row
            print(f"{name}_d{d}", row, flush=True)
    return out


def crop_rows(dev) -> dict:
    from schemanet_torch.kernel_times import photo_batch
    from schemanet_torch.ops.kernels import imagepipe as ipk

    libs = build_all({f"crop_{tag}": ("imagepipe.cu", p) for tag, p in CROP.items()})
    _, crop, total = photo_batch()
    g = torch.Generator().manual_seed(34)
    pixels = torch.randint(0, 256, (total,), generator=g, dtype=torch.uint8).to(dev)
    meta = torch.from_numpy(crop).to(dev)
    dst = torch.empty(len(crop), 224, 224, 3, dtype=torch.uint8, device=dev)
    tx, ty = ipk.tap_bound(crop[:, 6], 224), ipk.tap_bound(crop[:, 5], 224)
    stream = torch.cuda.current_stream().cuda_stream
    row, want = {}, None
    for tag, lib in libs.items():
        fn = lib.sn_crop_resize
        fn.argtypes = [P, P, P, I, I, I, I, P]
        args = (pixels.data_ptr(), meta.data_ptr(), dst.data_ptr(), len(crop), 224, tx, ty, stream)
        if fn(*args) != 0:
            raise SystemExit(f"{tag} refused the batch")
        torch.cuda.synchronize()
        want = dst.clone() if want is None else want
        row[tag.removeprefix("crop_")] = {"ms": time_ms(lambda: fn(*args)),
                                          "same_bytes": bool(torch.equal(dst, want))}
    row["bound"] = (int((crop[:, 5] * crop[:, 6] * 3).sum()) + dst.numel()) / 3.35e12 * 1e3
    print("crop_resize", row, flush=True)
    return {"crop_resize": row}


def ycc_rows(dev) -> dict:
    import numpy as np

    from schemanet_torch.kernel_times import photo_batch, ycc_batch
    from schemanet_torch.ops.kernels.imagepipe import YCC_REC

    libs = build_all({f"ycc_{tag}": ("imagepipe.cu", p) for tag, p in YCC.items()})
    sizes, _, _ = photo_batch()
    meta, n_planes, total = ycc_batch(sizes)
    table = np.ascontiguousarray(np.asarray(meta, np.int64))
    g = torch.Generator().manual_seed(34)
    planes = torch.randint(0, 256, (n_planes,), generator=g, dtype=torch.uint8).to(dev)
    host = torch.empty(len(table) * (YCC_REC + 1) * 8, dtype=torch.uint8, pin_memory=True)
    words = torch.empty(host.numel(), dtype=torch.uint8, device=dev)
    dst = torch.empty(total, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    row, want = {}, None
    for tag, lib in libs.items():
        fn = lib.sn_ycc_to_rgb
        fn.argtypes = [P, P, I, L, L, P, P, P, P]
        args = (planes.data_ptr(), table.ctypes.data, len(table), n_planes, total,
                host.data_ptr(), words.data_ptr(), dst.data_ptr(), stream)
        dst.zero_()
        if fn(*args) != 0:
            raise SystemExit(f"{tag} refused the batch")
        torch.cuda.synchronize()
        want = dst.clone() if want is None else want
        row[tag.removeprefix("ycc_")] = {"ms": time_ms(lambda: fn(*args)),
                                        "same_bytes": bool(torch.equal(dst, want))}
    row["bound"] = (n_planes + total) / 3.35e12 * 1e3
    print("ycc_to_rgb", row, flush=True)
    return {"ycc_to_rgb": row}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants_torch: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev, rows = torch.device("cuda"), {}
    picked = sys.argv[1:] or ["int8", "crop", "ycc"]
    if "int8" in picked:
        rows.update(int8_rows(dev))
    if "crop" in picked:
        rows.update(crop_rows(dev))
    if "ycc" in picked:
        rows.update(ycc_rows(dev))
    print(json.dumps({"kernel_variants": rows, "card": smi.splitlines()[0]}), flush=True)


if __name__ == "__main__":
    main()
