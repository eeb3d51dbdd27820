"""Card times of the frozen ``attn_block`` (with and without the head-mean),
``ffn_block`` (bf16 and fp32), the ``fused_mlp`` forward and backward, ``embed_grad``,
``adamw_project_rows`` and ``vq_assign`` at the shapes of their paths, each
beside a PyTorch yardstick where one is named, in bf16 unless said.

* ``attn_block`` at serving's microbatch (x [64, 197, 192], 3 heads), beside
  ``F.layer_norm`` + ``F.linear`` + SDPA (p = 0) + ``F.linear`` and the
  residual at the same shape: the same function by library calls, a note,
  not one library call; and in fp32 (stages 1 and 3) beside the same calls
  in fp32 with TF32 off (``attn_block_fp32_torch_calls``, with the SDPA
  backend that ran, read from the profiled kernel names), and its fp32
  head-mean variant at stage 3's batch (x [32, 197, 192]);
* ``ffn_block`` at serving's microbatch (x [64, 197, 192], f 768) in bf16
  and in fp32 (stages 1 and 3), each beside ``F.layer_norm`` + ``F.linear``
  + ``F.gelu`` + ``F.linear`` and the residual in the same dtype (fp32 with
  TF32 off): the same function by library calls, a note, not one library
  call; and in fp32 at DeiT-Small's width (x [64, 197, 384], f 1536), with
  the same note;
* the ``fused_mlp`` forward at stage 0's shape (12,608 rows, 192 -> 768 ->
  192) at p = 0.1 and p = 0, beside its two products alone by bf16
  ``torch.matmul`` (x W1^T, a W2^T on bf16 operands made beforehand): a
  note, not one library call;
* ``fused_mlp_bwd`` at the same shape at p = 0.1 and p = 0, beside the five
  products alone by bf16 ``torch.matmul`` (x W1^T, g W2, dH W1, dH^T x,
  g^T a on bf16 operands made beforehand);
* ``embed_grad`` on the class graphs' lookup (ids [100, 1024], cotangents
  [100, 1024, 256]) and on the stage-4 step's instance lookup (the
  ``compact_instance_slots`` codes [64, 196] of the VQ ids that the
  DeiT-Tiny ingredient backbone, seeded random weights, gives 64 seeded
  random images: ``instance_ids``; each sample's unused slots hold the
  padding id), each as one call and, where the checkout has plans
  (``sort_ids``), as a planned call, beside ``index_add_`` of the same
  cotangents made fp32 beforehand; with the device time split by kernel;
* the ``fused_layernorm`` forward and backward at stage 0's shape
  ([12,608, 192], no activation) and the GNN class graphs' ([102,400, 256],
  relu) in bf16 and fp32, beside ``F.layer_norm`` and ATen's
  ``native_layer_norm_backward`` (which has no relu gate: a note at the GNN
  shape) on the same inputs;
* ``adamw_project_rows`` on the class graphs' edge weights ([102,400, 1024]
  fp32), alone;
* ``vq_assign`` at a k-means minibatch ([1024, 192] x 1024, fp32), a Lloyd
  step ([200,000, 192] x 1024, fp32; 5 calls a window) and serving's
  microbatch ([12,544, 192] x 1024, bf16), each beside the plain scores by
  ``torch.matmul`` (fp32, TF32 off) and ``torch.argmin``: a note.

Each gets ``ms``, CUDA events around one window of 20 calls after warm-up,
and ``device_ms``, the ``torch.profiler`` device time of a call (and, for
``embed_grad``, the LayerNorm backward and the fp32 ``attn_block`` and its
yardstick, ``by_kernel``, that time split by kernel name). fp32 products run
with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` False). Uses only
the kernels' public wrappers, so the same file times an older checkout of
the port: from that checkout's root, ``python -m schemanet_torch.kernel_times``.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

ITERS = 20
SEED = 2**31 - 2  # stage 0's dropout seed in chip_smoke.py
# the DeiT-Tiny model and schema blocks of chip_smoke.py (CIFAR-100, M = 1024,
# encode layer 9), for the instance lookup's ids
MODEL_CFG = {
    "name": "vit",
    "transformer": dict(embed_dim=192, num_encoder_layers=12, num_heads=3, dim_feedforward=768,
                        dropout=None, activation="gelu", final_norm=True, norm_eps=1e-6),
    "patch_embed": dict(img_size=224, patch_size=16, image_channels=3),
    "pos_encoding": dict(name="learnable"),
}
SCHEMA_CFG = {
    "matcher": {"similarity": "inner_product"},
    "gnn": {"embed_dim": 256, "num_layers": 2, "activation": "relu"},
    "ir_atlas": dict(class_max_vertices=None, dist_pow=2, feat_h=14, feat_w=14,
                     clamp_vertex_attn=-1.0, clamp_edge_attn=-1.0, remove_self_loop=False,
                     prune_node_threshold=0.001, graph_precision="highest"),
}


def time_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Mean ms a call: CUDA events around one window of ``iters`` calls."""
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


def device_ms(fn, iters: int = ITERS) -> float:
    """Device ms a call: every device event of ``iters`` calls under the
    profiler, user annotations excluded. A session that comes back without
    device events is taken again; five in a row raise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(evt.time_range.elapsed_us() for evt in prof.events()
                       if evt.device_type == DeviceType.CUDA
                       and not getattr(evt, "is_user_annotation", False))
        if total_us:
            return total_us / iters / 1e3
    raise RuntimeError("the profiler recorded no device event in five profiles in a row")


def _both(fn) -> dict:
    return {"ms": time_ms(fn), "device_ms": device_ms(fn)}


def device_by_kernel(fn, iters: int = ITERS) -> dict:
    """Device ms a call by kernel name (the first 60 characters), from one
    profile of ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            key = evt.name[:60]
            out[key] = out.get(key, 0.0) + evt.time_range.elapsed_us() / iters / 1e3
    return out


def _split(fn) -> dict:
    return {**_both(fn), "by_kernel": device_by_kernel(fn)}


def sdpa_backend(by_kernel: dict) -> str:
    """The SDPA backend whose kernels a profile's names show: "flash",
    "efficient" (memory-efficient, CUTLASS's fmha), "cudnn", or "math"
    (plain products and a softmax)."""
    names = " ".join(by_kernel).lower()
    for backend, marks in (("flash", ("flash",)), ("efficient", ("fmha", "efficient")),
                           ("cudnn", ("cudnn",))):
        if any(mark in names for mark in marks):
            return backend
    return "math"


def instance_ids(dev: torch.device, batch: int = 64, seed: int = 0) -> torch.Tensor:
    """The stage-4 step's instance-lookup ids: ``compact_instance_slots`` of
    the VQ ids that the fp32 DeiT-Tiny ingredient backbone (layers 0-9,
    M = 1024 codes), with weights from ``init_parameters_`` seeded by
    ``seed``, gives ``batch`` standard-normal NHWC images from
    ``numpy.random.default_rng(seed)``: chip_smoke.py's model and images."""
    from .ops.graph import compact_instance_slots
    from .schema import build_predictor, init_parameters_

    model = build_predictor(MODEL_CFG, SCHEMA_CFG, 100, 1024, 192, 9)
    init_parameters_(model, torch.Generator().manual_seed(seed))
    backbone = model.ingredient_backbone.to(dev)
    images = np.random.default_rng(seed).normal(size=(batch, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        codes = backbone(torch.from_numpy(images).to(dev))["ingredients"]
    return compact_instance_slots(codes, 1024).codes


def measure(dev: torch.device, inst_ids=None) -> dict:
    """{row: {timing: {"ms", "device_ms"}}} of the kernels and yardsticks.
    ``inst_ids``: the instance lookup's ids, ``instance_ids(dev)`` if None."""
    from .ops.kernels import atlas_opt as ao
    from .ops.kernels import embed_bwd as ek
    from .ops.kernels import encoder_block as eb
    from .ops.kernels import layernorm as lnk
    from .ops.kernels import mlp as mk
    from .ops.kernels import vq as vqk

    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    bs, n, d, heads, f = 64, 197, 192, 3, 768
    x = rnd(bs, n, d)
    ln_g, ln_b = 1 + rnd(d, scale=0.1, dtype=torch.float32), rnd(d, scale=0.1, dtype=torch.float32)
    wqkv, bqkv = rnd(3 * d, d, scale=d**-0.5), rnd(3 * d, scale=0.1)
    wo, bo = rnd(d, d, scale=d**-0.5), rnd(d, scale=0.1)
    attn_args = (x, ln_g, ln_b, wqkv, bqkv, wo, bo, heads)
    ln_g16, ln_b16 = ln_g.to(bf), ln_b.to(bf)

    def attn_torch():
        y = F.layer_norm(x, (d,), ln_g16, ln_b16, 1e-6)
        qkv = F.linear(y, wqkv, bqkv).view(bs, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return x + F.linear(o.transpose(1, 2).reshape(bs, n, d), wo, bo)

    torch.backends.cuda.matmul.allow_tf32 = False
    x32, w32 = x.float(), [t.float() for t in (wqkv, bqkv, wo, bo)]
    attn_fp32 = (x32, ln_g, ln_b, *w32, heads)
    attn_fp32_s3 = (x32[:32].contiguous(), ln_g, ln_b, *w32, heads)  # stage 3's batch

    def attn_torch_fp32():
        y = F.layer_norm(x32, (d,), ln_g, ln_b, 1e-6)
        qkv = F.linear(y, w32[0], w32[1]).view(bs, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return x32 + F.linear(o.transpose(1, 2).reshape(bs, n, d), w32[2], w32[3])

    out = {
        "attn_block": _both(lambda: eb.attn_block(*attn_args)),
        "attn_block_hmean": _both(lambda: eb.attn_block(*attn_args, capture_hmean=True)),
        "attn_block_torch_calls": _both(attn_torch),
        "attn_block_fp32": _split(lambda: eb.attn_block(*attn_fp32)),
        "attn_block_fp32_hmean": _split(lambda: eb.attn_block(*attn_fp32_s3, capture_hmean=True)),
        "attn_block_fp32_torch_calls": _split(attn_torch_fp32),
    }
    out["attn_block_fp32_torch_calls"]["sdpa_backend"] = sdpa_backend(
        out["attn_block_fp32_torch_calls"]["by_kernel"])
    del x32, w32, attn_fp32, attn_fp32_s3

    rows = bs * n
    x2, g2 = rnd(rows, d), rnd(rows, d)
    w1, b1, w2 = rnd(f, d, scale=d**-0.5), rnd(f, scale=0.1), rnd(d, f, scale=f**-0.5)
    dh, act = rnd(rows, f, scale=0.01), rnd(rows, f)

    def products():
        return (x2 @ w1.t(), g2 @ w2, dh @ w1, dh.t() @ x2, g2.t() @ act)

    b2 = rnd(d, scale=0.1)
    for dt, key in ((bf, "ffn_block"), (torch.float32, "ffn_block_fp32")):
        xf, lg, lb = x.to(dt), ln_g.to(dt), ln_b.to(dt)
        w1f, b1f, w2f, b2f = (t.to(dt) for t in (w1, b1, w2, b2))

        def ffn_torch():
            y = F.layer_norm(xf, (d,), lg, lb, 1e-6)
            return xf + F.linear(F.gelu(F.linear(y, w1f, b1f)), w2f, b2f)

        out[key] = _both(lambda: eb.ffn_block(xf, ln_g, ln_b, w1f, b1f, w2f, b2f))
        out[f"{key}_torch_calls"] = _both(ffn_torch)
    ds, fs, f32 = 384, 1536, torch.float32  # DeiT-Small, fp32
    xs, gs = rnd(bs, n, ds, dtype=f32), 1 + rnd(ds, scale=0.1, dtype=f32)
    bs_ = rnd(ds, scale=0.1, dtype=f32)
    w1s, b1s = rnd(fs, ds, scale=ds**-0.5, dtype=f32), rnd(fs, scale=0.1, dtype=f32)
    w2s, b2s = rnd(ds, fs, scale=fs**-0.5, dtype=f32), rnd(ds, scale=0.1, dtype=f32)

    def ffn_torch_d384():
        y = F.layer_norm(xs, (ds,), gs, bs_, 1e-6)
        return xs + F.linear(F.gelu(F.linear(y, w1s, b1s)), w2s, b2s)

    out["ffn_block_fp32_d384"] = _both(lambda: eb.ffn_block(xs, gs, bs_, w1s, b1s, w2s, b2s))
    out["ffn_block_fp32_d384_torch_calls"] = _both(ffn_torch_d384)
    out["fused_mlp"] = _both(lambda: mk.fused_mlp(x2, w1, b1, w2, b2, "gelu", 0.1, SEED))
    out["fused_mlp_p0"] = _both(lambda: mk.fused_mlp(x2, w1, b1, w2, b2, "gelu", 0.0))
    out["fused_mlp_matmul_products"] = _both(lambda: (x2 @ w1.t(), act @ w2.t()))
    out["fused_mlp_bwd"] = _both(lambda: mk.fused_mlp_bwd(x2, w1, b1, w2, g2, "gelu", 0.1, SEED))
    out["fused_mlp_bwd_p0"] = _both(lambda: mk.fused_mlp_bwd(x2, w1, b1, w2, g2, "gelu", 0.0))
    out["fused_mlp_bwd_matmul_products"] = _both(products)

    classes, codes, width = 100, 1024, 256
    ids = torch.arange(codes, dtype=torch.int32).expand(classes, codes).contiguous().to(dev)
    cot = rnd(classes, codes, width)
    ids_long, cot32 = ids.reshape(-1).long(), cot.reshape(-1, width).float()
    table = torch.zeros(codes + 1, width, device=dev)
    out["embed_grad"] = _split(lambda: ek.embed_grad(ids, cot, codes + 1))
    out["embed_grad_index_add"] = _both(lambda: table.index_add_(0, ids_long, cot32))
    inst = instance_ids(dev) if inst_ids is None else inst_ids
    cot_i = rnd(*inst.shape, width)
    ids_i, cot_i32 = inst.reshape(-1).long(), cot_i.reshape(-1, width).float()
    out["embed_grad_instance"] = _split(lambda: ek.embed_grad(inst, cot_i, codes + 1))
    out["embed_grad_instance_index_add"] = _both(lambda: table.index_add_(0, ids_i, cot_i32))
    out["embed_grad_instance_ids"] = {"rows": inst.numel(),
                                      "padding_rows": int((inst == codes).sum()),
                                      "padding_per_sample": (inst == codes).sum(1).tolist()}
    if hasattr(ek, "sort_ids"):  # checkouts with plans: the calls without the sort and wait
        plan, plan_i = ek.sort_ids(ids, codes + 1), ek.sort_ids(inst, codes + 1)
        out["embed_grad_planned"] = _split(lambda: ek.embed_grad(ids, cot, codes + 1, plan=plan))
        out["embed_grad_instance_planned"] = _split(
            lambda: ek.embed_grad(inst, cot_i, codes + 1, plan=plan_i))
    del table, cot, cot32, cot_i, cot_i32

    for tag, (rows_ln, w_ln, act_ln) in {"stage0": (bs * n, d, "none"),
                                         "gnn": (classes * codes, width, "relu")}.items():
        x_ln = rnd(rows_ln, w_ln, dtype=torch.float32) * 2 + 0.5
        sc = 1 + rnd(w_ln, scale=0.3, dtype=torch.float32)
        bi = rnd(w_ln, scale=0.3, dtype=torch.float32)
        g_ln = rnd(rows_ln, w_ln, dtype=torch.float32)
        for dt, sfx in ((bf, ""), (torch.float32, "_fp32")):
            xx, gg, w_t, b_t = x_ln.to(dt), g_ln.to(dt), sc.to(dt), bi.to(dt)
            _, mean, rstd = torch.ops.aten.native_layer_norm(xx, [w_ln], w_t, b_t, 1e-6)
            out[f"layernorm_{tag}{sfx}"] = _both(lambda: lnk.fused_layernorm(xx, sc, bi, 1e-6,
                                                                            act_ln))
            out[f"layernorm_{tag}{sfx}_F_layer_norm"] = _both(
                lambda: F.layer_norm(xx, (w_ln,), w_t, b_t, 1e-6))
            out[f"layernorm_bwd_{tag}{sfx}"] = _split(
                lambda: lnk.fused_layernorm_bwd(xx, sc, bi, gg, 1e-6, act_ln))
            out[f"layernorm_bwd_{tag}{sfx}_native"] = _both(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    gg, xx, [w_ln], mean, rstd, w_t, b_t, [True, True, True]))
        del x_ln, g_ln, xx, gg

    f32 = torch.float32
    shape = (classes * codes, codes)
    prm, grad = torch.rand(shape, device=dev) / codes, rnd(*shape, scale=1e-3, dtype=f32)
    m, v = rnd(*shape, scale=1e-4, dtype=f32), torch.rand(shape, device=dev) * 1e-8
    out["adamw_project_rows"] = _both(
        lambda: ao.adamw_project_rows(prm, grad, m, v, 2, lr=1e-3, weight_decay=5e-4))
    del prm, grad, m, v

    cb = rnd(codes, d, dtype=f32)
    for case, (n_rows, dt, iters) in {"minibatch": (1024, f32, ITERS),
                                      "lloyd": (200_000, f32, 5),
                                      "serve_bf16": (64 * 196, bf, ITERS)}.items():
        xv = rnd(n_rows, d, dtype=dt)
        cbv = cb.to(dt)

        def scores_argmin():
            c32 = cbv.float()
            return torch.argmin((c32 * c32).sum(-1)[None] - 2 * (xv.float() @ c32.t()), dim=-1)

        out[f"vq_assign_{case}"] = {"ms": time_ms(lambda: vqk.vq_assign_kernel(xv, cb), iters),
                                    "device_ms": device_ms(lambda: vqk.vq_assign_kernel(xv, cb),
                                                           iters)}
        out[f"vq_assign_{case}_matmul_argmin"] = {"ms": time_ms(scores_argmin, iters),
                                                  "device_ms": device_ms(scores_argmin, iters)}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"kernel_times": measure(torch.device("cuda")),
                      "card": smi.splitlines()[0]}), flush=True)


if __name__ == "__main__":
    main()
