"""Card times of the frozen ``attn_block`` (with and without the head-mean),
``ffn_block`` (bf16 and fp32), the ``fused_mlp`` forward and backward, ``embed_grad``,
``adamw_project_rows``, ``vq_assign``, at ImageNet's shapes ``sym_conv``, and
the int8 route's ``quantize_rows`` and ``int8_gemm``, at the shapes of their paths, each beside a PyTorch yardstick where one is
named, in bf16 unless said.

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
  ``torch.matmul`` (fp32, TF32 off) and ``torch.argmin``: a note;
* where the checkout takes them, the DeiT-Small, DeiT-Base and ImageNet
  widths: ``ffn_block`` at [64, 197, 384] f 1536 and at [64, 197, 768] f
  3072 (split by kernel), beside the library calls as above; ``attn_block``
  at [64, 197, 384] (6 heads) and [64, 197, 768] (12 heads), split by
  kernel, beside LN + linear + SDPA + linear; the ``fused_mlp`` forward
  and backward at 12,608 rows of 384 -> 1536 and of 768 -> 3072 (p = 0.1),
  each split by kernel, beside their products by ``torch.matmul``; the
  LayerNorm forward and backward (relu) on the
  ImageNet class graphs ([500,000, 1024]) beside ``F.layer_norm`` and
  ``native_layer_norm_backward`` (no gate: notes);
  ``adamw_project_rows`` with bf16 moments on the ImageNet edge weights
  ([500,000, 500]); ``sym_conv`` and ``sym_conv_bwd`` on the ImageNet class
  graphs ([1000, 500, 500] x [1000, 500, 1024]) beside ``torch.bmm`` on a
  pre-formed E_sym (the products alone, a note);
* where the checkout has the int8 route (``ops/kernels/quant.py``), its two
  kernels at the four projections of a serving microbatch (12,608 rows;
  qkv, out, fc1, fc2) at DeiT-Small's width (``--quant``: also DeiT-Tiny's
  and DeiT-Base's), bf16 activations: ``quantize_rows`` of the activation
  and of the fp32 weight, and ``int8_gemm`` with its epilogue, each beside
  its plain version, the product beside ``torch._int_mm`` on the same int8
  operands (the int32 product alone, without the epilogue: a note) and
  beside the bf16 ``F.linear`` it stands in for (a note).

Each gets ``ms``, CUDA events around one window of 20 calls after warm-up,
and ``device_ms``, the ``torch.profiler`` device time of a call (and, for
``embed_grad``, the LayerNorm backward, the fp32 ``attn_block`` and its
yardstick and the wide ``fused_mlp`` forward and backward, ``by_kernel``,
that time split by kernel name). fp32 products run
with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` False). Uses only
the kernels' public wrappers, so the same file times an older checkout of
the port: from that checkout's root, ``python -m schemanet_torch.kernel_times``
(``--widths``: only the FFN rows at 384 and 768; ``--quant``: only the
int8 route's rows; ``--ffn``: only the FFN kernels with gelu and relu at
192, 384 and 768; ``--notes``: ``embed_grad`` beside ``index_add_`` at a
model-2 rank's ImageNet class lookup and the fp32 ``attn_block`` at 384
beside its library calls; ``--imagepipe``: ``crop_resize`` and
``ycc_to_rgb`` on chip_smoke.py phase 34's batch of 64 photo-sized images,
``ycc_to_rgb`` with its host microseconds beside a ``copy_`` of as many
bytes; flags add up). To time a change beside its parent in one call, unpack the
parent with ``git archive`` into a directory that ``.gitignore`` lists,
copy this file into its ``schemanet_torch/``, and run the module from each
root in turns (parent, change, change, parent). Prints the card's name and
power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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
    if 768 in getattr(mk, "_DIMS", ()) and getattr(lnk, "_MAX_DIM", 0) >= 1024:
        out.update(_imagenet_widths(dev, rnd))
    else:
        out["adamw_project_rows"] = _adamw_rows(dev, rnd)["adamw_project_rows"]
    if _has_quant():
        out.update(_quant_rows(dev, rnd, widths=(384,)))
    return out


def _has_quant() -> bool:
    import importlib.util

    return importlib.util.find_spec(f"{__package__}.ops.kernels.quant") is not None


def projections(d: int):
    """(name, out, in) of an encoder layer's four projections at width d."""
    return (("qkv", 3 * d, d), ("out", d, d), ("fc1", 4 * d, d), ("fc2", d, 4 * d))


def _quant_rows(dev: torch.device, rnd, widths=(192, 384, 768)) -> dict:
    """The int8 route's kernels at each projection of a serving microbatch
    (12,608 rows, bf16 activations, fp32 weights) at these widths:
    ``quantize_rows`` of x and of the weight, ``int8_gemm`` (bf16 out, with
    bias), each beside its plain version; the product beside
    ``torch._int_mm`` on the same int8 operands (no epilogue) and the bf16
    ``F.linear`` it stands in for (notes)."""
    from .ops.kernels import quant as qk

    out, rows = {}, 64 * 197
    for d in widths:
        for name, n, k in projections(d):
            tag = f"{name}_d{d}"
            x = rnd(rows, k)
            w, b = rnd(n, k, scale=k**-0.5, dtype=torch.float32), rnd(n, dtype=torch.float32)
            xq, xs = qk.quantize_rows(x)
            wq, ws = qk.quantize_rows(w)
            wt, w16, b16 = wq.t(), w.to(torch.bfloat16), b.to(torch.bfloat16)
            out[f"quantize_rows_{tag}"] = _both(lambda: qk.quantize_rows(x))
            out[f"quantize_rows_{tag}_plain"] = {"ms": time_ms(
                lambda: qk.quantize_rows_reference(x))}
            out[f"quantize_rows_weight_{tag}"] = _both(lambda: qk.quantize_rows(w))
            out[f"int8_gemm_{tag}"] = _both(
                lambda: qk.int8_gemm(xq, wq, xs, ws, b, torch.bfloat16))
            out[f"int8_gemm_{tag}_plain"] = {"ms": time_ms(
                lambda: qk.int8_gemm_reference(xq, wq, xs, ws, b, torch.bfloat16))}
            out[f"int8_gemm_{tag}_int_mm"] = {"ms": time_ms(lambda: torch._int_mm(xq, wt))}
            out[f"int8_gemm_{tag}_bf16_linear"] = {"ms": time_ms(lambda: F.linear(x, w16, b16))}
            del x, w, xq, wq
    return out


FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                        "fixtures", "jpeg")


def photo_batch(batch: int = 64):
    """(image sizes [(h, w)], crop table [batch, 8], packed bytes) of
    chip_smoke.py phase 34's timed batch: ``batch`` images of the photo
    fixtures' sizes (their names, cycled in order), packed, each with
    ImageNet's training crop (RandomResizedCrop and flip) drawn by
    ``numpy.random.default_rng(1000 + j)``."""
    from .data.augment import get_crop_params_fn

    photos = sorted(f for f in os.listdir(FIXTURES) if f.startswith("photo_"))
    sizes = [tuple(int(v) for v in photos[i % len(photos)][:-5].split("_")[-1].split("x"))[::-1]
             for i in range(batch)]
    offsets = np.cumsum([0] + [h * w * 3 for h, w in sizes])
    rrc = get_crop_params_fn("imagenet", "train")
    crop = np.asarray([(offsets[j], h, w, *rrc((h, w, 3), np.random.default_rng(1000 + j)))
                       for j, (h, w) in enumerate(sizes)], np.int64)
    return sizes, crop, int(offsets[-1])


def ycc_batch(sizes):
    """(meta [n, 10], plane bytes, output bytes) of 4:2:0 files of these
    sizes, packed as nvJPEG's planes are: ``ycc_to_rgb``'s timed input."""
    meta, at, out_at = [], 0, 0
    for h, w in sizes:
        ch, cw = -(-h // 2), -(-w // 2)
        meta.append((at, at + h * w, at + h * w + ch * cw, h, w, cw, ch, 2, 2, out_at))
        at, out_at = at + h * w + 2 * ch * cw, out_at + h * w * 3
    return meta, at, out_at


# (h factor, v factor) of every chroma mode ycc_to_rgb takes ((0, 0): gray),
# and sizes at its tiles' edges: a pixel, a row, odd sizes, a 16-column
# group's edge, rows of 17 and 38 groups, a row in two chunks (4000)
YCC_MODES = ((1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (0, 0))
YCC_SIZES = ((37, 53), (38, 52), (1, 1), (1, 300), (5, 3), (7, 4), (17, 33), (33, 16),
             (20, 257), (3, 600), (2, 4000))


def ycc_random_batch(cases, seed: int):
    """(planes uint8 on the CPU, meta [n, 10], output bytes) of files
    ``cases`` [(h, w, hs, vs)], random packed planes from ``seed``. The
    outputs are packed, at offsets that are mostly not 16-byte aligned."""
    meta, at, out_at = [], 0, 0
    for h, w, hs, vs in cases:
        if hs == 0:
            meta.append((at, -1, -1, h, w, 0, 0, 1, 1, out_at))
            at += h * w
        else:
            cw, ch = -(-w // hs), -(-h // vs)
            meta.append((at, at + h * w, at + h * w + ch * cw, h, w, cw, ch, hs, vs, out_at))
            at += h * w + 2 * ch * cw
        out_at += h * w * 3
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (max(at, 1),), generator=g, dtype=torch.uint8), meta, out_at


def host_us(fn, iters: int = ITERS) -> float:
    """Host microseconds a call takes to return, the device idle before
    each call (the wrapper's checks, table and upload: no queue behind)."""
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e6


def _imagepipe_rows(dev: torch.device, rnd) -> dict:
    """The image pipeline's kernels on phase 34's batch (``photo_batch``,
    random pixels): ``crop_resize`` to 224^2 and ``ycc_to_rgb`` of the same
    sizes' 4:2:0 planes, with the wrapper's host microseconds, beside a
    ``copy_`` that reads and writes as many bytes as it moves (a practical
    ceiling)."""
    from .ops.kernels import imagepipe as ipk

    g = torch.Generator().manual_seed(34)
    sizes, crop, total = photo_batch()
    pixels = torch.randint(0, 256, (total,), generator=g, dtype=torch.uint8).to(dev)
    meta, n_planes, out_at = ycc_batch(sizes)
    meta = np.asarray(meta, np.int64)  # as decode_to_device passes it
    planes = torch.randint(0, 256, (n_planes,), generator=g, dtype=torch.uint8).to(dev)
    half = (n_planes + out_at) // 2
    src, dst = torch.empty(half, dtype=torch.uint8, device=dev), torch.empty(
        half, dtype=torch.uint8, device=dev)
    return {"crop_resize": {**_both(lambda: ipk.crop_resize(pixels, crop, 224)),
                            "window_bytes": int((crop[:, 5] * crop[:, 6] * 3).sum())},
            "ycc_to_rgb": {**_split(lambda: ipk.ycc_to_rgb(planes, meta, out_at)),
                           "host_us": host_us(lambda: ipk.ycc_to_rgb(planes, meta, out_at)),
                           "bytes": n_planes + out_at},
            "ycc_copy_same_bytes": {**_both(lambda: dst.copy_(src)), "bytes": 2 * half}}


def _adamw_rows(dev: torch.device, rnd, bf16_rows: bool = False) -> dict:
    """``adamw_project_rows`` on the CIFAR class graphs' edge weights
    ([102,400, 1024], fp32 moments), and with ``bf16_rows`` on the ImageNet
    ones ([500,000, 500], bf16 moments)."""
    from .ops.kernels import atlas_opt as ao

    out, f32 = {}, torch.float32
    cases = {"adamw_project_rows": ((100 * 1024, 1024), f32)}
    if bf16_rows:
        cases["adamw_project_rows_bf16"] = ((1000 * 500, 500), torch.bfloat16)
    for key, (shape, mdt) in cases.items():
        prm = torch.rand(shape, device=dev) / shape[1]
        grad = rnd(*shape, scale=1e-3, dtype=f32)
        m, v = rnd(*shape, scale=1e-4, dtype=mdt), (torch.rand(shape, device=dev) * 1e-8).to(mdt)
        out[key] = _both(lambda: ao.adamw_project_rows(prm, grad, m, v, 2, lr=1e-3,
                                                       weight_decay=5e-4))
        del prm, grad, m, v
    return out


def _width_rows(dev: torch.device, rnd) -> dict:
    """The rows ``--widths`` times: the bf16 frozen layer halves at
    DeiT-Small's and DeiT-Base's widths (``ffn_block`` at [64, 197, 384] f
    1536 and at [64, 197, 768] f 3072, the latter split by kernel;
    ``attn_block`` at [64, 197, 384] 6 heads and [64, 197, 768] 12 heads),
    each beside the same function by library calls (LN + linear + gelu +
    linear; LN + linear + SDPA + linear); the wide ``fused_mlp`` forward and
    backward at 12,608 rows of 384 -> 1536 and of 768 -> 3072 (p = 0.1),
    split by kernel, beside their products by ``torch.matmul``; and
    ``adamw_project_rows`` (fp32 moments at CIFAR's [102,400, 1024], bf16
    at ImageNet's [500,000, 500])."""
    from .ops.kernels import encoder_block as eb
    from .ops.kernels import mlp as mk

    out, bf, f32 = {}, torch.bfloat16, torch.float32
    rows = 64 * 197
    for d, f, heads in ((384, 1536, 6), (768, 3072, 12)):
        x = rnd(64, 197, d)
        lg, lb = 1 + rnd(d, scale=0.1, dtype=f32), rnd(d, scale=0.1, dtype=f32)
        w1, b1, w2, b2 = (rnd(f, d, scale=d**-0.5), rnd(f, scale=0.1), rnd(d, f, scale=f**-0.5),
                          rnd(d, scale=0.1))
        wqkv, bqkv = rnd(3 * d, d, scale=d**-0.5), rnd(3 * d, scale=0.1)
        wo, bo = rnd(d, d, scale=d**-0.5), rnd(d, scale=0.1)
        lg16, lb16 = lg.to(bf), lb.to(bf)

        def attn_torch():
            y = F.layer_norm(x, (d,), lg16, lb16, 1e-6)
            qkv = F.linear(y, wqkv, bqkv).view(64, 197, 3, heads, d // heads)
            qkv = qkv.permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
            return x + F.linear(o.transpose(1, 2).reshape(64, 197, d), wo, bo)

        timing = _split if d == 768 else _both
        out[f"ffn_block_d{d}"] = timing(lambda: eb.ffn_block(x, lg, lb, w1, b1, w2, b2))
        out[f"ffn_block_d{d}_torch_calls"] = _both(
            lambda: x + F.linear(F.gelu(F.linear(F.layer_norm(x, (d,), lg16, lb16, 1e-6), w1,
                                                 b1)), w2, b2))
        out[f"attn_block_d{d}"] = _split(
            lambda: eb.attn_block(x, lg, lb, wqkv, bqkv, wo, bo, heads))
        out[f"attn_block_d{d}_torch_calls"] = _split(attn_torch)
        out[f"attn_block_d{d}_torch_calls"]["sdpa_backend"] = sdpa_backend(
            out[f"attn_block_d{d}_torch_calls"]["by_kernel"])
        del x
    for d, f in ((384, 1536), (768, 3072)):
        x2, g2 = rnd(rows, d), rnd(rows, d)
        w1, b1, w2, b2 = (rnd(f, d, scale=d**-0.5), rnd(f, scale=0.1), rnd(d, f, scale=f**-0.5),
                          rnd(d, scale=0.1))
        dh, act = rnd(rows, f, scale=0.01), rnd(rows, f)
        out[f"fused_mlp_d{d}"] = _split(lambda: mk.fused_mlp(x2, w1, b1, w2, b2, "gelu", 0.1, SEED))
        out[f"fused_mlp_d{d}_matmul_products"] = _both(lambda: (x2 @ w1.t(), act @ w2.t()))
        out[f"fused_mlp_bwd_d{d}"] = _split(
            lambda: mk.fused_mlp_bwd(x2, w1, b1, w2, g2, "gelu", 0.1, SEED))
        out[f"fused_mlp_bwd_d{d}_matmul_products"] = _both(
            lambda: (x2 @ w1.t(), g2 @ w2, dh @ w1, dh.t() @ x2, g2.t() @ act))
        del x2, g2, dh, act
    out.update(_adamw_rows(dev, rnd, bf16_rows=True))
    return out


def _activation_rows(dev: torch.device, rnd) -> dict:
    """The rows ``--ffn`` times: ``ffn_block`` at [64, 197, d] (bf16, and
    fp32 at 192 and 384) and the ``fused_mlp`` forward and backward at
    12,608 rows of d (p = 0.1, bf16) at d = 192, 384 and 768 (f = 4 d),
    with gelu and, where the checkout's kernels take an activation, with
    relu (a checkout that refuses relu records ``"refused"``)."""
    from .ops.kernels import encoder_block as eb
    from .ops.kernels import mlp as mk

    out, bf, f32 = {}, torch.bfloat16, torch.float32
    for d in (192, 384, 768):
        f = 4 * d
        x = rnd(64, 197, d)
        lg, lb = 1 + rnd(d, scale=0.1, dtype=f32), rnd(d, scale=0.1, dtype=f32)
        w1, b1, w2, b2 = (rnd(f, d, scale=d**-0.5), rnd(f, scale=0.1), rnd(d, f, scale=f**-0.5),
                          rnd(d, scale=0.1))
        g = rnd(64, 197, d)
        weights = {bf: (w1, b1, w2, b2), f32: tuple(t.float() for t in (w1, b1, w2, b2))}
        for act in ("gelu", "relu"):
            kw = {} if act == "gelu" else {"activation": act}
            cases = {f"ffn_block_{act}_d{d}": lambda: eb.ffn_block(x, lg, lb, *weights[bf], **kw),
                     f"fused_mlp_{act}_d{d}": lambda: mk.fused_mlp(x, *weights[bf], act, 0.1, SEED),
                     f"fused_mlp_bwd_{act}_d{d}": lambda: mk.fused_mlp_bwd(
                         x, *weights[bf][:3], g, act, 0.1, SEED)}
            if d <= 384:
                cases[f"ffn_block_fp32_{act}_d{d}"] = lambda: eb.ffn_block(
                    x.float(), lg, lb, *weights[f32], **kw)
            for name, fn in cases.items():
                try:
                    fn()
                except (TypeError, ValueError):  # a checkout whose kernels take gelu alone
                    out[name] = "refused"
                    continue
                out[name] = _both(fn)
        del x, g
    return out


def _imagenet_widths(dev: torch.device, rnd) -> dict:
    """The rows of the DeiT-Small, DeiT-Base and ImageNet widths:
    ``_width_rows``, then the LayerNorm and GraphConv at the ImageNet class
    graphs."""
    from .ops.kernels import graphconv as gc
    from .ops.kernels import layernorm as lnk

    out, bf, f32 = _width_rows(dev, rnd), torch.bfloat16, torch.float32
    n_rows, width = 1000 * 500, 1024
    x_ln = rnd(n_rows, width) * 2 + 0.5
    g_ln = rnd(n_rows, width)
    sc, bi = 1 + rnd(width, scale=0.3, dtype=f32), rnd(width, scale=0.3, dtype=f32)
    sc16, bi16 = sc.to(bf), bi.to(bf)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x_ln, [width], sc16, bi16, 1e-6)
    out["layernorm_gnn_imagenet"] = _both(lambda: lnk.fused_layernorm(x_ln, sc, bi, 1e-6, "relu"))
    out["layernorm_gnn_imagenet_F_layer_norm"] = _both(
        lambda: F.layer_norm(x_ln, (width,), sc16, bi16, 1e-6))
    out["layernorm_bwd_gnn_imagenet"] = _split(
        lambda: lnk.fused_layernorm_bwd(x_ln, sc, bi, g_ln, 1e-6, "relu"))
    out["layernorm_bwd_gnn_imagenet_native"] = _both(
        lambda: torch.ops.aten.native_layer_norm_backward(
            g_ln, x_ln, [width], mean, rstd, sc16, bi16, [True, True, True]))
    del x_ln, g_ln, mean, rstd
    e = (torch.rand(1000, 500, 500, device=dev) / 500).to(bf)
    feat, cot = rnd(1000, 500, width), rnd(1000, 500, width)
    e_sym = (0.5 * (e + e.transpose(1, 2)) + torch.eye(500, device=dev, dtype=bf)).contiguous()
    out["sym_conv_imagenet"] = _both(lambda: gc.sym_conv(e, feat))
    out["sym_conv_imagenet_bmm"] = _both(lambda: torch.bmm(e_sym, feat))
    out["sym_conv_bwd_imagenet"] = _split(lambda: gc.sym_conv_bwd(e, feat, cot))
    out["sym_conv_bwd_imagenet_bmm"] = _both(
        lambda: (torch.bmm(e_sym, cot), torch.bmm(cot, feat.transpose(1, 2))))
    return out


def _note_rows(dev: torch.device, rnd) -> dict:
    """The rows ``--notes`` times: ``embed_grad`` on a model-2 rank's class
    lookup at ImageNet's scale (ids [500, 500], 500 distinct codes a class
    out of 8,000, cotangents [500, 500, 1024] bf16, a table of 8,001 rows),
    one call and planned, beside ``index_add_`` of the same cotangents made
    fp32 beforehand, the one PyTorch call that computes its function; and
    the fp32 ``attn_block`` at DeiT-Small's width (x [64, 197, 384], 6
    heads; stage 1 at ImageNet) and its head-mean variant at stage 3's
    batch (x [32, 197, 384]), each beside ``F.layer_norm`` + ``F.linear`` +
    SDPA + ``F.linear`` and the residual in fp32 with TF32 off (a note: the
    head-mean is not among the calls)."""
    from .ops.kernels import embed_bwd as ek
    from .ops.kernels import encoder_block as eb

    out, f32 = {}, torch.float32
    g = torch.Generator().manual_seed(41)
    codes, width = 8000, 1024
    ids = torch.stack([torch.randperm(codes, generator=g)[:500] for _ in range(500)]).to(
        dev, torch.int32)
    cot = rnd(500, 500, width)
    ids_long, cot32 = ids.reshape(-1).long(), cot.reshape(-1, width).float()
    table = torch.zeros(codes + 1, width, device=dev)
    out["embed_grad_shard"] = _split(lambda: ek.embed_grad(ids, cot, codes + 1))
    plan = ek.sort_ids(ids, codes + 1)
    out["embed_grad_shard_planned"] = _split(
        lambda: ek.embed_grad(ids, cot, codes + 1, plan=plan))
    out["embed_grad_shard_index_add"] = _both(lambda: table.index_add_(0, ids_long, cot32))
    del table, cot, cot32
    d, heads = 384, 6
    lg, lb = 1 + rnd(d, scale=0.1, dtype=f32), rnd(d, scale=0.1, dtype=f32)
    w = [rnd(3 * d, d, scale=d**-0.5, dtype=f32), rnd(3 * d, scale=0.1, dtype=f32),
         rnd(d, d, scale=d**-0.5, dtype=f32), rnd(d, scale=0.1, dtype=f32)]
    for bs, key, hmean in ((64, "attn_block_fp32_d384", False),
                           (32, "attn_block_fp32_hmean_d384", True)):
        x = rnd(bs, 197, d, dtype=f32)

        def calls():
            y = F.layer_norm(x, (d,), lg, lb, 1e-6)
            qkv = F.linear(y, w[0], w[1]).view(bs, 197, 3, heads, d // heads)
            qkv = qkv.permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
            return x + F.linear(o.transpose(1, 2).reshape(bs, 197, d), w[2], w[3])

        out[key] = _split(lambda: eb.attn_block(x, lg, lb, *w, heads, capture_hmean=hmean))
        out[f"{key}_torch_calls"] = _split(calls)
        out[f"{key}_torch_calls"]["sdpa_backend"] = sdpa_backend(
            out[f"{key}_torch_calls"]["by_kernel"])
        del x
    return out


def main() -> None:
    """``python -m schemanet_torch.kernel_times [--widths] [--quant] [--ffn]
    [--notes] [--imagepipe]``:
    every row, or with ``--widths`` only ``_width_rows`` (the frozen layer
    halves at 384 and 768, the wide ``fused_mlp`` forward and backward, both
    ``adamw_project_rows`` rows), which a copy of this file dropped into an
    older checkout times there too, with ``--quant`` only the int8 route's
    rows at widths 192, 384 and 768, or with ``--ffn`` only the FFN kernels
    with gelu and relu at 192, 384 and 768 (``_activation_rows``; an older
    checkout's refuse relu), or with ``--notes`` only ``_note_rows``
    (``embed_grad`` beside ``index_add_`` at a model-2 rank's ImageNet class
    lookup, the fp32 ``attn_block`` at 384 beside its library calls), with
    ``--imagepipe`` only ``crop_resize`` and ``ycc_to_rgb`` on chip_smoke.py
    phase 34's batch; flags add up."""
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda")
    chosen = {"--widths": _width_rows, "--quant": _quant_rows, "--ffn": _activation_rows,
              "--notes": _note_rows, "--imagepipe": _imagepipe_rows}
    picked = [flag for flag in chosen if flag in sys.argv[1:]]
    if picked:
        g = torch.Generator().manual_seed(0)

        def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

        rows = {}
        for flag in picked:
            rows.update(chosen[flag](dev, rnd))
    else:
        rows = measure(dev)
    print(json.dumps({"kernel_times": rows, "card": smi.splitlines()[0]}), flush=True)


if __name__ == "__main__":
    main()
