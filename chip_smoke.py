"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU (H100).

Drives ``schemanet_torch.ServePredictor.predict`` at the CIFAR-100-scale
serving configuration (DeiT-Tiny at full width, 224^2 input, layers 0-9 of 12,
M=1024 codes, K=100 classes, V_max=1024, GNN width 256 x 2 layers,
microbatch 64; as ``tools/bench_serve.py``) with seeded random weights, and
checks every hand-written CUDA kernel on the path:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: compiles ``schemanet_torch/csrc/*.cu`` (seconds taken);
3. each kernel against its plain PyTorch version at the serving shapes, in
   bf16 and fp32: max |kernel - plain| / max |plain| <= 2e-2 (bf16), 1e-4 (fp32);
4. the slice in fp32 (graph_precision 'highest') on 100 images (two
   microbatches, the second padded) against the same model with the plain
   versions called in place of the kernels: VQ ids agree on >= 99.9% of
   tokens, logits within 1e-3 * max |logit|;
5. the slice in bf16 (graph_precision 'default'): finite [n, 100] logits for
   1, 64 and 100 images; ``predict(x[:5]) == predict(x)[:5]`` bit for bit;
   every kernel's launch counter advanced as the path implies (per
   microbatch: 10 attn_block, one of them with the head-mean, 10 ffn_block,
   4 sym_conv);
6. timings (CUDA events after warm-up): each kernel beside its plain version,
   and the p50/p99 latency and images/s of one microbatch of 64.

Any failed check raises, so the script exits non-zero. Without a GPU it fails
at once. Its last line is ``{"ok": true, "device": {...}}``; the line before
it lists the kernels with their launches, errors and times.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

BF16_TOL, FP32_TOL = 2e-2, 1e-4
DEVICE = "cuda"
MICROBATCH = 64
N_IMAGES = 100  # two microbatches, the second padded
TIME_ITERS, LATENCY_ITERS = 20, 30
EMBED_DIM, FFN_DIM, HEADS, IMG, PATCH, GNN_DIM = 192, 768, 3, 224, 16, 256
MODEL_CFG = {
    "name": "vit",
    "transformer": dict(
        embed_dim=EMBED_DIM, num_encoder_layers=12, num_heads=HEADS, dim_feedforward=FFN_DIM,
        dropout=None, activation="gelu", final_norm=True, norm_eps=1e-6,
    ),
    "patch_embed": dict(img_size=IMG, patch_size=PATCH, image_channels=3),
    "pos_encoding": dict(name="learnable"),
}
SCHEMA_CFG = {
    "matcher": {"similarity": "inner_product"},
    "gnn": {"embed_dim": GNN_DIM, "num_layers": 2, "activation": "relu"},
    "ir_atlas": dict(
        class_max_vertices=None, dist_pow=2, feat_h=IMG // PATCH, feat_w=IMG // PATCH,
        clamp_vertex_attn=-1.0, clamp_edge_attn=-1.0, remove_self_loop=False,
        prune_node_threshold=0.001,
    ),
}
NUM_CLASSES, NUM_CODES, ENCODE_LAYER = 100, 1024, 9
FROZEN_LAYERS = ENCODE_LAYER + 1
GNN_CONVS = 2 * SCHEMA_CFG["gnn"]["num_layers"]  # instance + class graphs per layer


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures the GPU and nothing else")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from schemanet_torch.ops.kernels import _build
    except ImportError as exc:
        sys.exit(f"chip_smoke: run from the repository root ({exc})")
    from schemanet_torch.ops.kernels import encoder_block as eb
    from schemanet_torch.ops.kernels import graphconv as gc
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts
    from schemanet_torch.schema import build_predictor, init_parameters_
    from schemanet_torch.serve import ServePredictor

    # fp32 comparisons need full fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{kind} ({smi.split(',')[-1].strip()} limit)"
    print(smi, flush=True)
    phase("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          compile_seconds=_build.build_seconds, library=str(_build.library_path().name))

    # 3. each kernel against its plain version at the serving shapes
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    d, f, heads = EMBED_DIM, FFN_DIM, HEADS
    v_inst = (IMG // PATCH) ** 2
    n = v_inst + 1  # patches + cls
    w = dict(
        g1=1 + rnd(d, scale=0.1), b1=rnd(d, scale=0.1),
        wqkv=rnd(3 * d, d, scale=d**-0.5), bqkv=rnd(3 * d, scale=0.1),
        wo=rnd(d, d, scale=d**-0.5), bo=rnd(d, scale=0.1),
        w1=rnd(f, d, scale=d**-0.5), fb1=rnd(f, scale=0.1),
        w2=rnd(d, f, scale=f**-0.5), fb2=rnd(d, scale=0.1),
    )
    x_seq = rnd(MICROBATCH, n, d)
    e_class = torch.rand(NUM_CLASSES, NUM_CODES, NUM_CODES, generator=g).to(dev) / NUM_CODES
    f_class = rnd(NUM_CLASSES, NUM_CODES, GNN_DIM)
    e_inst = torch.rand(MICROBATCH, v_inst, v_inst, generator=g).to(dev) / v_inst
    f_inst = rnd(MICROBATCH, v_inst, GNN_DIM)

    def attn_args(x):
        return (x, w["g1"], w["b1"], w["wqkv"], w["bqkv"], w["wo"], w["bo"], heads)

    def ffn_args(x):
        return (x, w["g1"], w["b1"], w["w1"], w["fb1"], w["w2"], w["fb2"])

    cases = {
        "attn_block": lambda dt: (eb.attn_block, eb.attn_block_reference,
                                  attn_args(x_seq.to(dt)), {}),
        "attn_block_hmean": lambda dt: (eb.attn_block, eb.attn_block_reference,
                                        attn_args(x_seq.to(dt)), {"capture_hmean": True}),
        "ffn_block": lambda dt: (eb.ffn_block, eb.ffn_block_reference, ffn_args(x_seq.to(dt)), {}),
        "sym_conv": lambda dt: (gc.sym_conv, gc.sym_conv_reference,
                                (e_class.to(dt), f_class.to(dt)), {}),
        "sym_conv_instance": lambda dt: (gc.sym_conv, gc.sym_conv_reference,
                                         (e_inst.to(dt), f_inst.to(dt)), {}),
    }
    errors = {}
    for name, case in cases.items():
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            kernel, plain, args, kw = case(dt)
            got, want = kernel(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            rels = [rel_err(a, b) for a, b in zip(got, want)]
            abss = [abs_err(a, b) for a, b in zip(got, want)]
            phase("compare", kernel=name, dtype=str(dt).split(".")[-1],
                  shape=list(args[0].shape), rel_err=rels, max_abs_err=abss, tol=tol)
            require(all(r <= tol for r in rels), f"{name} {dt}: rel err {rels} > {tol}")
            if dt == torch.bfloat16:
                errors[name] = max(abss)

    # the model, seeded random weights (made on the host, then moved)
    def model(dtype, precision):
        schema = dict(SCHEMA_CFG, ir_atlas=dict(SCHEMA_CFG["ir_atlas"], graph_precision=precision))
        return build_predictor(MODEL_CFG, schema, NUM_CLASSES, NUM_CODES, EMBED_DIM,
                               ENCODE_LAYER, dtype=dtype)

    t0 = time.perf_counter()
    m32 = model(torch.float32, "highest")
    init_parameters_(m32, torch.Generator().manual_seed(0))
    m16 = model(torch.bfloat16, "default")
    m16.load_state_dict(m32.state_dict())
    phase("init", seconds=round(time.perf_counter() - t0, 3),
          parameters=sum(p.numel() for p in m32.parameters()))
    images = np.random.default_rng(0).normal(size=(N_IMAGES, IMG, IMG, 3)).astype(np.float32)
    x_dev = torch.from_numpy(images).to(dev)

    plain_versions = [
        mock.patch.object(eb, "attn_block", eb.attn_block_reference),
        mock.patch.object(eb, "ffn_block", eb.ffn_block_reference),
        mock.patch.object(gc, "sym_conv", gc.sym_conv_reference),
    ]

    def with_plain(fn):
        for p in plain_versions:
            p.start()
        try:
            return fn()
        finally:
            for p in plain_versions:
                p.stop()

    # 4. the slice in fp32 against the plain versions
    s32 = ServePredictor(m32, microbatch=MICROBATCH, device=dev)
    with torch.no_grad():
        logits_k = s32.predict_tensor(x_dev)
        ids_k = s32.predictor.ingredient_backbone(x_dev[:MICROBATCH])["ingredients"]
        logits_p = with_plain(lambda: s32.predict_tensor(x_dev))
        ids_p = with_plain(lambda: s32.predictor.ingredient_backbone(x_dev[:MICROBATCH]))[
            "ingredients"]
    torch.cuda.synchronize()
    agree = (ids_k == ids_p).float().mean().item()
    scale = logits_p.abs().max().item()
    logit_err = (logits_k - logits_p).abs().max().item()
    phase("slice_fp32", images=N_IMAGES, vq_id_agreement=agree, logit_max_abs_err=logit_err,
          logit_scale=scale, tol=1e-3 * scale)
    require(tuple(logits_k.shape) == (N_IMAGES, NUM_CLASSES), f"fp32 logits {tuple(logits_k.shape)}")
    require(agree >= 0.999, f"fp32 VQ ids agree on {agree:.5f} < 0.999 of tokens")
    require(logit_err <= 1e-3 * scale, f"fp32 logits differ by {logit_err} > 1e-3 * {scale}")
    del s32, m32
    torch.cuda.empty_cache()

    # 5. the slice in bf16: the main path, counted
    s16 = ServePredictor(m16, microbatch=MICROBATCH, device=dev)
    reset_launch_counts()
    logits = s16.predict(images)  # the user's entry point: numpy in, numpy out
    launches = launch_counts()
    mbs = -(-len(images) // MICROBATCH)
    expected = {"attn_block": FROZEN_LAYERS * mbs, "attn_block_hmean": mbs,
                "ffn_block": FROZEN_LAYERS * mbs, "sym_conv": GNN_CONVS * mbs}
    phase("slice_bf16_launches", microbatches=mbs, launches=launches, expected=expected)
    require(launches == expected, f"launch counts {launches} != {expected}")
    for count in (1, MICROBATCH, N_IMAGES):
        out = s16.predict(images[:count])
        require(out.shape == (count, NUM_CLASSES), f"bf16 logits {out.shape} for {count}")
        require(bool(np.isfinite(out).all()), f"bf16 logits not finite for {count} images")
    head = s16.predict(images[:5])
    invariant = bool(np.array_equal(head, logits[:5]))
    phase("slice_bf16", finite=True, batch_invariant=invariant,
          logit_scale=float(np.abs(logits).max()))
    require(invariant, "predict(x[:5]) != predict(x)[:5]")

    # 6. timings, bf16 at the serving shapes
    card_note = {"card": card}
    times = {}
    for name, case in cases.items():
        kernel, plain, args, kw = case(torch.bfloat16)
        times[name] = (time_ms(lambda: kernel(*args, **kw), TIME_ITERS),
                       time_ms(lambda: plain(*args, **kw), TIME_ITERS))
        phase("kernel_time", kernel=name, dtype="bfloat16", shape=list(args[0].shape),
              ms=times[name][0], plain_ms=times[name][1], **card_note)
    xb = x_dev[:MICROBATCH]
    for _ in range(3):
        s16.predict_tensor(xb)
    torch.cuda.synchronize()
    lat = []
    for _ in range(LATENCY_ITERS):
        t0 = time.perf_counter()
        s16.predict_tensor(xb)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    plain_lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        with_plain(lambda: s16.predict_tensor(xb))
        torch.cuda.synchronize()
        plain_lat.append((time.perf_counter() - t0) * 1e3)
    phase("serve_latency", microbatch=MICROBATCH, dtype="bfloat16", p50_ms=p50, p99_ms=p99,
          images_per_s=MICROBATCH / (p50 / 1e3),
          plain_versions_p50_ms=float(np.percentile(plain_lat, 50)),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, **card_note)

    replaces = {
        "attn_block": "schemanet_tpu/ops/pallas/encoder_block.py:240",
        "attn_block_hmean": "schemanet_tpu/ops/pallas/encoder_block.py:240",
        "ffn_block": "schemanet_tpu/ops/pallas/encoder_block.py:286",
        "sym_conv": "schemanet_tpu/ops/pallas/graphconv.py:68",
    }
    sources = {"sym_conv": "schemanet_torch/csrc/graphconv.cu"}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": sources.get(name, "schemanet_torch/csrc/encoder_block.cu"),
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": errors[name] if name != "sym_conv"
            else max(errors["sym_conv"], errors["sym_conv_instance"]),
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        for name in replaces
    ]
    require(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
