"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): the serving path,
the SchemaNet training step, stage 0 (fine-tuning the backbone), stage 1
(codebook extraction), stage 3 (IR-Atlas initialisation), the
loader-driven workers (training with validation, checkpoints and resume,
and evaluation), and the ImageNet DeiT-Small configuration (serving, the
stage-4 step and stage 0) with DeiT-Base's widths.

Both run the CIFAR-100 DeiT-Tiny configuration at full width (224^2 input,
patch 16, 197 tokens, d=192, 3 heads, FFN 768, layers 0-9 of 12 frozen,
M=1024 codes, K=100 classes, V_max=1024, GNN width 256 x 2 layers,
inner-product matcher) with seeded random weights, and check every
hand-written CUDA kernel on the two paths.

Serving (``schemanet_torch.ServePredictor.predict``, microbatch 64, as
``tools/bench_serve.py``):

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: compiles ``schemanet_torch/csrc/*.cu``, one nvcc per file at once;
   prints the registers and spills of the tensor-core kernels (attention
   and its head-mean variant, GraphConv, the FFN forward and backward,
   attn_block's bf16 products, its split-TF32 products, attention and LN
   statistics, ffn_block's bf16 and split-TF32 kernels, VQ's two routes, the
   LayerNorm backward's 12 and its parameter sum, embed_grad's 6, the wide
   FFN route's Hopper kernels: TMA-fed wgmma GEMMs, the dual product, the
   weight gradients; the wide ffn_block's LN pass and its two GEMMs;
   adamw_project_rows' warp-a-row and block-a-row kernels) from the ptxas
   log, and fails if one is missing or spills;
3. each serving kernel against its plain PyTorch version at the serving
   shapes, in bf16 and fp32: max |kernel - plain| / max |plain| <= 2e-2
   (bf16), 1e-4 (fp32); ``sym_conv`` also at rows of E that are 4-byte
   (V = 70) and 8-byte (V = 500) aligned (``CONV_EDGES``), ``attn_block``
   (both variants) also one row past a tile of 64 and at DeiT-Small's 6
   heads of width 384 (``ATTN_EDGES``), every fp32 ``attn_block`` call
   counted on the split-TF32 route and equal bit for bit over two calls,
   ``ffn_block`` also at 1,000 rows
   (past a row tile), f = 96, widths 64, 128, 256 and 384, and f = 104 at
   384 (past fp32's hidden chunk of 16 there) (``FFN_EDGES``);
4. the slice in fp32 (graph_precision 'highest') on 100 images (two
   microbatches, the second padded) against the same model with the plain
   versions called in place of the kernels: VQ ids agree on >= 99.9% of
   tokens, logits within 1e-3 * max |logit|; the kernel run's 10
   attn_block launches a microbatch (one with the head-mean) all on the
   split-TF32 route;
5. the slice in bf16 (graph_precision 'default'): finite [n, 100] logits for
   1, 64 and 100 images; ``predict(x[:5]) == predict(x)[:5]`` bit for bit;
   every kernel's launch counter advanced as the path implies (per
   microbatch: 10 attn_block on the tensor-core route, one of them with the
   head-mean, 10 ffn_block,
   one vq_assign, 4 sym_conv, all on the tensor-core routes, 4
   fused_layernorm (the GNN's LN+relu), and no training kernel);
6. timings (CUDA events after warm-up): each kernel beside its plain version
   (``ffn_block`` in bf16 and fp32, ``attn_block`` in bf16 and fp32, its
   fp32 head-mean at stage 3's batch of 32), and the p50/p99 latency and
   images/s of one microbatch of 64.

Training (``schemanet_torch.train.Trainer.train_iter``, batch 64, the CIFAR
config's AdamW groups, schedule and schema loss, the atlas kept projected by
the fused update):

7. each training kernel (``sym_conv_bwd`` on class and instance graphs,
   ``embed_grad`` for the class and instance lookups, ``adamw_project_rows``
   on the edge and vertex weights) against its plain version at the
   training shapes, bf16 and fp32 (``adamw_project_rows``: fp32, its only
   dtype), same tolerances as 3; ``sym_conv_bwd`` also at ``CONV_EDGES``;
   bf16 dE exactly symmetric at every shape. ``embed_grad``'s instance
   lookup takes the ids the stage-4 step makes (``compact_instance_slots``
   of phase 4's VQ ids, each sample's unused slots padded); it is also
   compared at uniform ids, one id taking 4,500 rows, one id spanning many
   chunks, ids no row takes (whose rows must be exactly 0) and a table of one
   row; it and its plain version equal bit for bit over two calls at every
   one of those; the class lookup with the plan of its buffer runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host wait) with the
   unplanned call's bits, and an in-place write to the buffer rebuilds the
   plan;
8. the step in fp32 (graph_precision 'highest') against the same trainer
   with every kernel replaced by its plain version, fed the kernel run's VQ
   ids (the plain VQ's own ids must agree with them on >= 99.9% of tokens,
   near-ties apart: one other code changes a graph). 3 steps run free:
   losses within 1e-4 relative, the edge and vertex weights within
   2 * lr * steps. 3 steps in lock step (each from the kernel trainer's
   state): losses within 1e-4 relative, the atlas gradients' difference
   reported, the updated edge and vertex weights within rtol 1e-4 / atol 1e-6
   where the step's plain gradient exceeds 1e-3 * its max, within
   2 * lr * steps elsewhere (Adam moves an entry by about lr * sign(g),
   which may flip where g is near zero, and the row projection rescales). Free-running steps amplify rounding where the
   atlas is not smooth (the prune threshold, exact zeros), so the tight rule
   holds step by step. The first lock step is taken twice from one saved
   state on each side (``run_to_run_bitwise``): every loss, VQ id,
   gradient, parameter and moment must have the same bits both times.
   Every attn_block launch of the kernel side's free run (10 a step, one
   with the head-mean) is on the split-TF32 route;
9. the step in bf16 (graph_precision 'default', the training default): 5
   finite losses, and the launch counters advanced as the path implies (per
   step: 10 attn_block and 10 ffn_block on the tensor-core routes, one
   attn_block with the head-mean, one vq_assign,
   4 sym_conv and 4 sym_conv_bwd, all on the tensor-core routes, 4
   fused_layernorm and 4 fused_layernorm_bwd on the 16-byte route, 2
   embed_grad on the 16-byte route, one of them (the class lookup) with the
   atlas's plan, 2 adamw_project_rows);
10. timings: each training kernel beside its plain version; the device time
    of ``sym_conv``, ``sym_conv_bwd`` and ``embed_grad`` (``torch.profiler``;
    ``embed_grad`` unplanned, planned and at the instance ids, beside
    ``index_add_``) beside ``torch.bmm`` on a pre-formed E_sym (the products
    alone, a note);
    the bf16 step's
    ms and images/s beside the step with every plain version and with the
    plain LayerNorm alone; the step split
    into frozen forward, graph build + GNN forward + loss, backward and
    optimizer (CUDA events); the device's idle share over 3 steps
    (``torch.profiler``) and the peak device memory.

Stage 0 (``schemanet_torch.train.backbone_trainer(...).train_iter``, the
``backbone_worker`` step of ``configs/cifar_100/vanilla/deit_tiny.yaml``: ViT
at DeiT-Tiny width, 12 layers, dropout 0.1, AdamW lr 1e-4 with warmup,
``clip_max_norm`` 0.1, cross entropy, batch 64; seeded random weights):

11. the fused attention and FFN kernels, forward and backward, against their
    plain versions at the stage-0 shapes (qkv [64, 197, 576]; 12,608 rows of
    192 -> 768 -> 192), bf16 and fp32, dropout off and at p = 0.1 with the
    same seed (equal masks, so a wrong mask shows as an O(1) error); the
    tolerances of 3. The attention kernels also at the edges of their tiling
    (``MHSA_EDGES``: n = 65, one row past a tile of 64; n = 320, the limit;
    head_dim 32 over several waves of blocks), the FFN forward and backward
    past their tiles (``MLP_EDGES``: 1,000 rows, past a tile of 64; f = 96,
    past a chunk of 64 and the forward's chunk of 32), and the backward's
    bf16 dW1, dW2, db1 and db2 equal bit for bit over two calls at every one
    of those shapes;
12. the step in fp32 with dropout live: 3 steps against the same trainer
    with every kernel replaced by its plain version, from the same generator
    seeds (so the same masks); losses within 1e-4 relative, the parameters
    within the rule of 8;
13. the step in bf16 (the config's dtype): 5 finite losses; per step 12
    launches each of fused_mhsa, fused_mhsa_bwd, fused_mlp and fused_mlp_bwd,
    every attention and FFN launch on the tensor-core route, 25 of
    fused_layernorm
    and of fused_layernorm_bwd (two a layer and the final norm; every
    backward on the 16-byte route), and none of
    the serving or SchemaNet kernels;
14. timings: each stage-0 kernel beside its plain version, and
    ``scaled_dot_product_attention`` at p = 0 (forward, backward alone, and
    both) beside the attention kernels at p = 0 and 0.1, CUDA events over 20
    calls and, for SDPA and the kernels, the profiler's device time of a
    call; ``schemanet_torch/kernel_times.py``: events and device time of
    attn_block (both variants) beside F.layer_norm + F.linear + SDPA +
    F.linear, of ffn_block in bf16 and fp32 beside F.layer_norm + F.linear
    + F.gelu + F.linear, of the FFN forward and backward beside their two
    and five products by torch.matmul, of embed_grad (class and instance
    lookups, planned where the checkout has plans) beside index_add_, of the
    LayerNorm forward and backward at stage 0's and the GNN's shapes in both
    dtypes beside F.layer_norm and native_layer_norm_backward, of
    adamw_project_rows, and of vq_assign at the minibatch, Lloyd and bf16
    serving shapes beside matmul + argmin; the bf16 step's ms and images/s beside the
    step with every plain version and with the plain LayerNorm alone; its split into forward, backward, and
    clipping plus AdamW; the idle share over 3 steps and the peak memory.

Stages 1 and 3 (``schemanet_torch.pipeline.extract_stage`` and
``init_stage``, from ``configs/cifar_100/ingredient/deit_tiny-l9-M_1024.yaml``
and the atlas block of ``configs/cifar_100/schema_net/deit_tiny-l9-M_1024.yaml``,
fp32, seeded random weights and images made on the card):

15. the VQ kernel against its plain version at [1024, 192] x 1024 (a k-means
    minibatch) and [200,000, 192] x 1024 (a Lloyd step) in fp32, [6,272, 192]
    x 1024 in bf16 (stage 3's batch of 32), [6,272, 384] x 8,000 in fp32
    (the ImageNet vocabulary), rows past a row tile of 64 and codes past a
    code tile of 128 in both dtypes (``VQ_EDGES``), and duplicated codes
    (fp32 takes the split-TF32 route, bf16 the bf16 one): ids equal on >= 99.9%
    of rows, every mismatch a near-tie (the plain scores of the two codes
    within 1e-5 of the row's largest |score|), duplicates give the first
    index exactly. The LayerNorm kernels, forward and backward, at
    [12,608, 192] (stage 0, act none) and [102,400, 256] (the GNN's class
    graphs, relu; no cotangent where y is within 1e-5 of max |y| of 0, a
    tie of the relu gate) in bf16 and fp32: the tolerances of 3 (backward
    fp32 1e-4), dscale and dbias equal bit for bit over two runs; in fp32 both
    the kernels and the plain versions beside an fp64 LayerNorm. The
    backward also at ``LN_EDGES`` (rows past a warp's and a block's rows,
    widths on the scalar route), dscale and dbias bitwise over two runs;
16. ``stage1_fp32``: the whole stage at the CLI's defaults (batch 64,
    1,000,000 features from 80 batches, M = 1024, k-means++ from the first
    4,096 features, minibatches of 1,024, 10 Lloyd iterations over the first
    200,000), its launches (one vq_assign a minibatch and a Lloyd step, and
    10 attn_block and 10 ffn_block a batch, all on the split-TF32 routes);
    features/s of the collection, ms a minibatch step and a Lloyd step, the
    final inertia; held against the plain versions: the first two batches'
    features within 1e-4, then 50 minibatch steps and 2 Lloyd steps in lock
    step (each step from the kernel run's state, once with the kernel and
    once with every plain version): ids >= 99.9% equal, mismatches near-ties
    only, the updated centers within 1e-4 of max apart from the centers a
    mismatched row moved;
17. ``stage3_fp32``: ``init_stage`` at K = 100, V_max = 1024, batch 32, on
    64 batches a pass (2,048 of CIFAR's 50,000 images: a cut, with the
    extrapolated full-dataset time), its launches (every attn_block, the
    head-mean too, and every ffn_block on the split-TF32 routes) and peak
    memory; against
    the plain versions fed the kernel run's VQ ids (their own ids' agreement
    reported): class_ingredients equal, vertex and edge weights within 1e-5
    of max. Then the bundle and the atlas init go to files, and a stage-4
    ``Trainer`` (``schema_net_trainer``) takes one bf16 step from them;
18. timings of the new kernels beside their plain versions and, for the
    LayerNorm, ``F.layer_norm`` and ATen's ``native_layer_norm_backward``
    (at the GNN's relu shape a note: it has no gate), the backward also in
    fp32, each with its bound;
    CUDA events over 20 calls, and the device time of a call from
    ``torch.profiler``; for VQ, the bound of each case.

The loader-driven workers (``schemanet_torch.train.schema_net_worker``,
``backbone_worker`` and ``eval_worker`` with the stage-4 and stage-0
configs above, bf16, on the ``synthetic`` dataset at CIFAR-100's 32^2 source
shape, 640 training and 160 validation images; checkpoints under a
temporary directory):

19. the loader on the card: a batch of 64 shipped as uint8 at 32^2, resized
    to 224^2 and normalised on the card, against the plain numpy version
    (``resize_normalize_reference``) within 1e-5 x max; the validation
    batches' valid rows (64, 64, 32); images/s of an epoch of the training
    set through ``device_prefetch`` and the resize (host clock, two
    epochs), and with CIFAR's random crop and flip on the host;
20. ``schema_net_worker`` from phase 17's bundle and atlas-init files: 2
    epochs of 10 steps, validation at the start, at iter 15 (mid-epoch) and
    at the end; finite losses, acc@1 and acc@5 in [0, 1], the launch
    counters as the path implies (per training step as 9, per validation
    batch the serving forward's of 5), ``meta.json`` with the JAX keys and
    a ``best`` checkpoint; the loop's images/s (host clock, and without its
    validations and checkpoint writes), the device idle share over the loop
    (the profiler's device time over the host's wall time, device activity
    only), each validation's and checkpoint write's seconds, a
    checkpoint's bytes;
21. resume: the same run stopped after epoch 1 (``request_stop``, what
    SIGTERM does) and resumed with ``resume="auto"`` gives phase 20's
    parameters, AdamW moments (the hot atlas tensors' too), generators and
    final validation bit for bit;
22. phase 20's predictor validated in fp32 (``graph_precision`` 'highest')
    against the same predictor with the plain versions called in place of
    the kernels, fed the kernel run's VQ ids: every sample whose top-1 or
    top-5 correctness, or whose quantised or original codebook-evaluation
    prediction, differs must have its two deciding logits within 1e-3 x max
    |logit| (those samples are reported); the loss within 1e-4 relative;
23. ``backbone_worker``: one epoch of 5 steps at dropout 0.1 with the launch
    counters as the path implies (per step as 13, per validation batch 12
    attn_block, 12 ffn_block and the final LayerNorm), then ``eval_worker``
    on its last checkpoint: top-1/top-5 counts equal to the worker's final
    validation, the loss within 1e-6 relative.

ImageNet (``imagenet_phases``): ``configs/imagenet/schema_net/deit_small-l9-M_8000.yaml``
with its model ``configs/models/deit_small_patch16_224.yaml`` (224^2, patch
16, 197 tokens, d=384, 6 heads of 64, FFN 1536, layers 0-9 of 12 frozen,
M=8000 codes, K=1000 classes, V_max=500, GNN 1024 x 2, inner-product
matcher, bf16, bf16 AdamW moments on the schema_net group, batch 64) and
``configs/imagenet/vanilla/deit_{small,base}.yaml`` for stage 0, on the
dataset block ``{name: synthetic, num_classes: 1000, image_size: 224}``
with seeded random weights (a seeded DeiT-Small bundle with a random
codebook; class ingredients drawn distinct a class from the 8000 codes):

24. the kernels at the new widths against their plain versions (the
    tolerances of 3), each bitwise over two calls and counted on its route:
    ``ffn_block`` at [64, 197, 768] f 3072 and at 1,000 and 77 rows in both
    dtypes (the wide route), in bf16 its LN pass (``ffn_ln_rows``) bit for
    bit its plain emulation ``ln_rows_reference`` and the profiled kernel
    names of a call at [64, 197, 768]: the LN pass and two ``gemm_wg_kernel``,
    no ``linear_tc_kernel`` and no cuBLAS, CUTLASS or cuDNN kernel;
    ``attn_block`` at [64, 197, 384] (6 heads) and [64, 197, 768] (12
    heads) and ``ffn_block`` at [64, 197, 384] f 1536, bf16, timed;
    ``fused_mlp`` forward and backward at
    [64, 197, 384] and [64, 197, 768], p = 0 and 0.1, both dtypes (the wide
    route); ``fused_layernorm`` forward and backward at [500,000, 1024] relu
    (the class graphs; no cotangent at a gate tie, as 15) and
    [12,608, 384 | 768]; ``adamw_project_rows`` with bf16 moments on the
    [1000, 500, 500] edge and [1000, 500] vertex tensors against the plain
    low-memory update plus the projection (p within 1e-4, m and v within one
    bf16 ulp); their times beside the plain versions' and their bounds; the
    profiled kernel names of ``fused_mlp`` and ``fused_mlp_bwd`` at 384 in
    bf16, none of them a cuBLAS, CUTLASS or cuDNN kernel and some of them
    the library's own;
25. ImageNet serving, bf16 (the stage-4 trainer's predictor through
    ``ServePredictor``): finite [100, 1000] logits from two microbatches
    (the second padded), ``predict(x[:5]) == predict(x)[:5]`` bit for bit,
    the launch counters as 5 (384 wide: ``ffn_block`` on its one-launch
    kernel), p50/p99 latency of a microbatch of 64;
26. ImageNet serving in fp32 against the plain versions, the rule of 4.
    Cut: K = 100 classes (the plain GraphConv's E_sym and a second
    predictor at K = 1000 beside the first would crowd the card's memory);
27. the ImageNet stage-4 step in bf16 (``schema_net_trainer``): 5 finite
    losses, the counters as 9 plus 2 ``adamw_project_rows`` with bf16
    moments a step, both on the 4-column route, the moments' dtypes (bf16 for all four atlas tensors),
    step ms and images/s, device-busy ms and idle share (profiler, 2
    steps), the peak device memory; ``sym_conv`` and ``sym_conv_bwd`` at
    [1000, 500, 1024] against their plain versions and timed (run after 25,
    before 26);
28. the ImageNet stage-4 step in fp32 against the plain versions with
    phase 8's rules (``stage4_fp32_vs_plain``: free run, lock step,
    ``run_to_run_bitwise``), the YAML's bf16 moments kept, except that the
    tight rule is reported, not gated: the rows' projection ties each edge
    weight to its row's sum, and entries whose |g| is below the two sides'
    gradient difference may take either sign of Adam's g / (|g| + eps),
    moving whole rows past rtol 1e-4 within the bound; and from the second
    step the LayerNorm's E[x^2] - E[x]^2 variance at the GNN's 1024-wide
    features leaves the edge weights' fp32 gradient known to ~1e-3 of its
    max. Gated in its place: the first lock step's atlas gradients within
    1e-5 of the plain versions', and the atlas gradient after 2 steps,
    kernels and plain versions in fp32 against the plain versions in fp64:
    the kernels' no more than 10% farther. Cut: K = 100;
29. DeiT-Small stage 0 (``backbone_trainer``, 1000 classes): 3 fp32 steps
    against the plain versions with phase 12's rules, then 5 bf16 steps:
    finite losses, 12 launches each of the four stage-0 kernels a step,
    every FFN launch on the wide route, 25 LayerNorm forward and backward;
    step ms; the profiler's device ms a step and idle share over 2 steps;
30. DeiT-Base: one bf16 serving microbatch of 64 (K cut to 100) with its 10
    ``attn_block`` launches and 10 ``ffn_block`` launches on the wide route
    at 768, finite logits, p50/p99 latency of a microbatch and the
    profiler's device ms a microbatch;
    2 bf16 stage-0 steps with ``fused_mlp`` at 768 on the wide route,
    finite losses, step ms, device ms a step and idle share. Depth not cut.

Each of 24-30 prints its seconds (``phase_seconds``; ``imagenet_seconds``
sums them).

Any failed check raises, so the script exits non-zero. Without a GPU it fails
at once. Its last line is ``{"ok": true, "device": {...}}``; the line before
it lists every kernel with its launches on its path (training for the
SchemaNet kernels, stage 0 for the fused attention and FFN kernels), its
error against its plain version, its time, the plain version's, its bound on
the card and, where one PyTorch call computes the same function, that
call's time, and its launches in the workers' runs (phases 20 and 23); the
instantiations of phases 24-30 follow (``attn_block_d384``,
``attn_block_d768``, ``ffn_block_d384``, ``ffn_block_d768``,
``fused_mlp[_bwd]_d384`` and ``_d768``, ``fused_layernorm[_bwd]_d1024``,
``adamw_project_rows_bf16``, ``sym_conv[_bwd]_imagenet``), each with the
launches of the path that runs it. The VQ kernel's launches are stage 1's and the LayerNorm
kernels' stage 0's; its error is the largest plain-score difference between
the kernel's code and the plain version's. ``ffn_block_fp32`` is
``ffn_block`` in fp32 (the split-TF32 kernel): stage 1's launches, the fp32
error and times, its bound by three TF32 products a product.
``attn_block_fp32`` is ``attn_block`` in fp32 (the split-TF32 kernels) the
same way, at serving's microbatch shape; ``attn_block_fp32_hmean`` its
head-mean variant: stage 3's launches, timed at stage 3's batch of 32.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# the training block of configs/cifar_100/schema_net/deit_tiny-l9-M_1024.yaml
# (optimizer, param_groups, drop_remain, lr_schedule, train_epochs) and its
# loss weights; CIFAR-100 has 50,000 training images
TRAIN_CFG = {
    "optimizer": {"name": "AdamW", "lr": 0.001, "weight_decay": 0.05},
    "param_groups": [{"pattern": "schema_net", "cfg": {"weight_decay": 0.0005}},
                     {"pattern": "matcher"}],
    "drop_remain": True,
    "lr_schedule": {"name": "cosine_annealing", "T_max": 50, "eta_min": 1.0e-05},
    "train_epochs": 50,
    "batch_size": 64,
}
LOSS_CFG = {"name": "schema_inference_loss"}
LOSS_WEIGHTS = {"cls": 1.0, "re_entropy_vertex": 0.5, "re_entropy_edge": 0.75}
BATCH = TRAIN_CFG["batch_size"]
STEPS_PER_EPOCH = 50_000 // BATCH
FP32_STEPS, BF16_STEPS, STEP_TIME_ITERS = 3, 5, 10
# configs/cifar_100/vanilla/deit_tiny.yaml (stage 0), as backbone_trainer reads it
STAGE0_CFG = {
    "dataset": {"name": "cifar_100"},
    "training": {
        "dtype": "bfloat16",
        "optimizer": {"name": "AdamW", "lr": 0.0001, "weight_decay": 0.05},
        "lr_schedule": {"name": "cosine_annealing", "T_max": 50, "warmup_iters": 10},
        "train_epochs": 50, "batch_size": 64, "clip_max_norm": 0.1,
    },
    "model": {
        "name": "vit",
        "transformer": dict(embed_dim=EMBED_DIM, num_encoder_layers=12, num_heads=HEADS,
                            dim_feedforward=FFN_DIM, dropout=0.1, activation="gelu",
                            final_norm=True, norm_eps=1e-06),
        "patch_embed": dict(name="vit_like", img_size=IMG, patch_size=PATCH, image_channels=3),
        "pos_encoding": {"name": "learnable", "dropout": None},
    },
    "loss": {"name": "ce_loss", "weight_dict": {"cls": 1.0}},
}
S0_LAYERS = STAGE0_CFG["model"]["transformer"]["num_encoder_layers"]
S0_DROPOUT, S0_SEED = STAGE0_CFG["model"]["transformer"]["dropout"], 2**31 - 2
# (bs, n, heads, head_dim) of the attention compares beside the stage-0 shape
MHSA_EDGES = {"n65": (5, 65, 2, 64), "n320": (2, 320, 3, 64), "d32": (96, 100, 4, 32)}
# (bs, n, dim, heads) of the attn_block compares beside the serving shape: one
# query row past a tile of 64; DeiT-Small's width and 6 heads
ATTN_EDGES = {"n65": (5, 65, EMBED_DIM, HEADS), "deit_small": (16, 197, 384, 6)}
# (rows, dim, f) of the ffn_block compares beside the serving shape: rows past
# a row tile (64 in bf16 and fp32 up to 192, 32 beyond), f past a hidden
# chunk of 32 (f96) and of fp32's 16 at 384 (d384_f104), and every other
# width the kernels take (384: DeiT-Small)
FFN_EDGES = {"rows1000": (1000, EMBED_DIM, FFN_DIM), "f96": (45, 64, 96),
             "d128": (130, 128, 512), "d256": (1000, 256, 1024), "d384": (394, 384, 1536),
             "d384_f104": (45, 384, 104)}
# (rows, dim, f) of the fused_mlp_bwd compares beside the stage-0 shape (whose
# 12,608 rows are a multiple of the tensor-core row tile of 64): rows past a
# tile, and f past a hidden chunk of 64
MLP_EDGES = {"rows1000": (1000, EMBED_DIM, FFN_DIM), "f96": (45, 64, 96)}
# (rows, width, codes, dtype) of the VQ compares beside the path's shapes:
# rows past a row tile of 64 and codes past a code tile of 128
VQ_EDGES = {"odd_fp32": (1037, EMBED_DIM, 1000, torch.float32),
            "odd_bf16": (777, EMBED_DIM, 1000, torch.bfloat16)}
# (rows, width, act) of the LayerNorm backward compares beside the path's
# shapes: rows that are not a multiple of the rows a warp takes at a time (2)
# or a block (16), and widths on the scalar route (bf16 300, and 6 in both
# dtypes: rows not a whole number of 16-byte pieces)
LN_EDGES = {"rows_odd": (12_607, EMBED_DIM, "none"), "rows_odd_gnn": (1_001, GNN_DIM, "relu"),
            "d300": (777, 300, "none"), "d6": (33, 6, "relu")}
# (graphs, V, D) of the GraphConv compares beside the path's shapes: rows of E
# 4-byte aligned (V = 70), 8-byte aligned (V = 500, ImageNet's class graphs)
CONV_EDGES = {"v70": (4, 70, 40), "v500": (16, 500, 1024)}
# stage 1: configs/cifar_100/ingredient/deit_tiny-l9-M_1024.yaml (its model
# is configs/models/deit_tiny_patch16_224.yaml, the ViT above) at the CLI's
# defaults (batch 64, max_features 1,000,000, fp32, 10 Lloyd iterations over
# 200,000 held features)
STAGE1_CFG = {
    "dataset": {"name": "cifar_100"},
    "model": dict(STAGE0_CFG["model"]),
    "discretization": {"vocabulary": {"size": NUM_CODES, "dim": EMBED_DIM},
                       "encoder_layer": f"module.transformer.layers.{ENCODE_LAYER}"},
}
S1_BATCH, S1_BATCHES, S1_FEATURES, S1_LLOYD, S1_LLOYD_ITERS = 64, 80, 1_000_000, 200_000, 10
S1_CHECK_MINIBATCHES, S1_CHECK_LLOYD = 50, 2
# stage 3: the schema_net block of configs/cifar_100/schema_net/deit_tiny-l9-M_1024.yaml
# at the CLI's init batch of 32; 64 batches a pass cut CIFAR-100's 50,000
STAGE3_CFG = {
    "dataset": {"name": "cifar_100"},
    "training": dict(TRAIN_CFG, dtype="bfloat16"),
    "schema_net": SCHEMA_CFG,
    "loss": dict(LOSS_CFG, weight_dict=LOSS_WEIGHTS),
}
S3_BATCH, S3_BATCHES, CIFAR_TRAIN = 32, 64, 50_000
# the loader-driven workers (phases 19-23): the stage-4 and stage-0 configs
# above on the synthetic dataset at CIFAR-100's 32^2 source shape, resized to
# 224^2 on the card; 640 training images (10 steps an epoch, so iter 15 of 2
# epochs is mid-epoch) and 160 validation images (the last batch 32 valid of 64)
WORKER_DATA = {"name": "synthetic", "num_classes": NUM_CLASSES, "image_size": 32, "resize": IMG,
               "train": {"num_samples": 640}, "val": {"num_samples": 160}}
W_EPOCHS, W_VAL_INTERVAL, W_PRINT, S0W_STEPS = 2, 15, 5, 5
# ImageNet (phases 24-30): configs/imagenet/schema_net/deit_small-l9-M_8000.yaml
# with its model configs/models/deit_small_patch16_224.yaml, and
# configs/imagenet/vanilla/deit_{small,base}.yaml, as the workers read them
# (inline: the card's machine has no PyYAML); the dataset block
# {name: synthetic, num_classes: 1000, image_size: 224} (no ImageNet file is
# in the repository: 224^2 images shipped as they are, no resize)
IN_CLASSES, IN_CODES, IN_VMAX, IN_GNN, IN_FP32_CLASSES = 1000, 8000, 500, 1024, 100
IN_DATA = {"name": "synthetic", "num_classes": IN_CLASSES, "image_size": IMG}


def vit_cfg(dim: int, heads: int, dropout) -> dict:
    """configs/models/deit_{small,base}_patch16_224.yaml (12 layers, patch 16, FFN 4 d)."""
    return {"name": "vit",
            "transformer": dict(embed_dim=dim, num_encoder_layers=12, num_heads=heads,
                                dim_feedforward=4 * dim, dropout=dropout, activation="gelu",
                                final_norm=True, norm_eps=1e-06),
            "patch_embed": dict(name="vit_like", img_size=IMG, patch_size=PATCH, image_channels=3),
            "pos_encoding": {"name": "learnable", "dropout": None}}


IN_SCHEMA_CFG = {  # configs/imagenet/schema_net/deit_small-l9-M_8000.yaml
    "dataset": IN_DATA,
    "training": {
        "dtype": "bfloat16",
        "optimizer": {"name": "AdamW", "lr": 0.001, "weight_decay": 0.05},
        "param_groups": [{"pattern": "schema_net",
                          "cfg": {"weight_decay": 0.0005, "moment_dtype": "bfloat16",
                                  "nu_dtype": "bfloat16"}},
                         {"pattern": "matcher"}],
        "drop_remain": True,
        "lr_schedule": {"name": "cosine_annealing", "T_max": 50, "eta_min": 1.0e-05},
        "train_epochs": 50, "batch_size": 64,
    },
    "schema_net": {
        "matcher": {"similarity": "inner_product"},
        "gnn": {"embed_dim": IN_GNN, "num_layers": 2, "identity_proj": False,
                "activation": "relu"},
        "ir_atlas": dict(class_max_vertices=IN_VMAX, dist_pow=2, feat_h=IMG // PATCH,
                         feat_w=IMG // PATCH, constant_vertex_attr=None, constant_edge_attr=None,
                         clamp_vertex_attn=-1.0, clamp_edge_attn=-1.0, remove_self_loop=False,
                         prune_node_threshold=0.001, apply_normalize=True, clamp_weights=True),
    },
    "loss": {"name": "schema_inference_loss", "weight_dict": LOSS_WEIGHTS},
}


def vanilla_cfg(dim: int, heads: int) -> dict:
    """configs/imagenet/vanilla/deit_{small,base}.yaml (stage 0)."""
    return {
        "dataset": IN_DATA,
        "training": {
            "dtype": "bfloat16",
            "optimizer": {"name": "AdamW", "lr": 0.0001, "weight_decay": 0.05},
            "lr_schedule": {"name": "cosine_annealing", "T_max": 50, "warmup_iters": 10},
            "train_epochs": 50, "batch_size": 64, "clip_max_norm": 0.1,
        },
        "model": vit_cfg(dim, heads, 0.1),
        "loss": {"name": "ce_loss", "weight_dict": {"cls": 1.0}},
    }


IN_STEPS_PER_EPOCH = 1_281_167 // BATCH  # ImageNet-1k's training images
# H100 SXM data sheet, dense: bf16 and TF32 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 494.7e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


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


def least_ms(flops: float, moved: float, dtype: str):
    """(least ms on the card, what bounds it): the larger of the operations
    over the peak rate of their type and the bytes moved over the memory
    rate."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS[dtype] * 1e3, moved / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def vq_work(x, cb):
    """(operations, bytes, type) of a vq_assign call, reckoned for the work
    as the kernel does it: fp32 by the 3xTF32 split, three TF32 products per
    fp32 product on the TF32 tensor cores; bf16 one bf16 product."""
    (rows, width), codes = x.shape, cb.shape[0]
    flops = 2 * rows * codes * width
    moved = nbytes(x, cb) + rows * 4  # int32 ids out
    if x.dtype == torch.float32:
        return 3 * flops, moved, "tfloat32"
    return flops, moved, "bfloat16"


def ln_work(x, bwd=False):
    """(operations, bytes) of a fused_layernorm call on x [rows, d] in x's
    dtype (statistics and affine in fp32): the forward reads x and writes y;
    the backward reads x and g and writes dx; scale, bias in, dscale, dbias
    out in fp32."""
    params = 2 * x.shape[-1] * 4
    if bwd:
        return 14 * x.numel(), 3 * nbytes(x) + 2 * params
    return 8 * x.numel(), 2 * nbytes(x) + params


def embed_work(args):
    """(operations, bytes) of an embed_grad call: one add a cotangent value;
    the ids and cotangents read once, the fp32 table written once."""
    ids, g_, rows_ = args
    return g_.numel(), nbytes(ids, g_) + rows_ * g_.shape[-1] * 4


def device_time_by_name(prof) -> dict:
    """Device microseconds by kernel name in a profile: the CUDA events,
    without the user annotations that span kernels already counted (such as
    ``Optimizer.step#AdamW.step``)."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            out[evt.name] = out.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    return out


# marks of library GEMM kernels in profiled names: cuBLAS (and cuBLASLt's
# nvjet), CUTLASS, cuDNN
LIBRARY_KERNEL_MARKS = ("cublas", "cutlass", "xmma", "nvjet", "cudnn", "gemv", "sm90_", "sm80_")


def kernel_names(fn, iters: int = 5) -> list:
    """The distinct device kernel names of ``iters`` calls of fn, in launch
    order, from the profiler (a session without device events is taken
    again; a session of one call has come back without the library's
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        names = [evt.name for evt in prof.events() if evt.device_type == DeviceType.CUDA
                 and not getattr(evt, "is_user_annotation", False)]
        if names:
            return list(dict.fromkeys(names))
    return []


def ptxas_report(log: str, source: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} of one
    source's section of the build's ``nvcc -Xptxas -v`` log."""
    section = log.split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    out = {}
    for block in section.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        out[name] = (int(regs.group(1)) if regs else None,
                     *(tuple(map(int, spills.groups())) if spills else (None, None)))
    return out


def compare(name, kernel, plain, args, kw, dtype, tol, errors) -> None:
    """Kernel against plain version on the same inputs; records the max
    absolute error of the working dtype (bf16, or fp32 where that is the
    kernel's only dtype)."""
    got, want = kernel(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rels = [rel_err(a, b) for a, b in zip(got, want)]
    abss = [abs_err(a, b) for a, b in zip(got, want)]
    shape = next(a for a in args if torch.is_tensor(a)).shape
    phase("compare", kernel=name, dtype=str(dtype).split(".")[-1], shape=list(shape),
          rel_err=rels, max_abs_err=abss, tol=tol)
    require(all(r <= tol for r in rels), f"{name} {dtype}: rel err {rels} > {tol}")
    if dtype == torch.bfloat16 or name not in errors:
        errors[name] = max(abss)


def stage4_fp32_vs_plain(make_trainer, batches, lr: float, frozen_layers: int, helpers: dict,
                         label: str = "train_fp32", tight: bool = True, **fields):
    """Phase 8 (and phase 28 at ImageNet's shapes): the stage-4 step in fp32
    (``make_trainer()``, graph_precision 'highest') against the same trainer
    with every kernel replaced by its plain version, fed the kernel run's VQ
    ids: ``len(batches)`` steps run free, then as many in lock step, the
    first of them twice from one saved state on each side
    (``run_to_run_bitwise``). Fails on any rule of phase 8; returns the
    kernel side's free-run launch counts and the lock step's report.
    ``tight`` False (phase 28): the tight rule is reported for every step
    (``sure_ok_steps``), not gated; the bound gates every entry."""
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts

    with_plain, recording_vq = helpers["with_plain"], helpers["recording_vq"]
    replaying_vq, replay_report = helpers["replaying_vq"], helpers["replay_report"]
    steps = len(batches)
    hot_names = ("schema_net.vertex_weights", "schema_net.edge_weights")

    def fp32_run():
        tr = make_trainer()
        losses = [tr.train_iter(batch)["loss"].item() for batch in batches]
        hot = {k: tr.hot[k].param.detach().clone() for k in hot_names}
        del tr
        torch.cuda.empty_cache()
        return losses, hot

    # free running: 3 steps each, the kernels against the plain versions
    s4_ids, s4_vq = [], {"rows": 0, "mismatches": 0, "near_ties_only": True}
    reset_launch_counts()
    with recording_vq(s4_ids):
        losses_k, hot_k = fp32_run()
    s4_launches = launch_counts()
    want_attn = {"attn_block": frozen_layers * steps, "attn_block_tc": frozen_layers * steps,
                 "attn_block_hmean": steps}
    require({k: s4_launches[k] for k in want_attn} == want_attn,
            f"fp32 stage-4 attn_block launches {s4_launches} != {want_attn}: an fp32 launch "
            "missed the split-TF32 route")

    def plain_fp32_run():
        with replaying_vq(s4_ids, s4_vq):
            return fp32_run()

    losses_p, hot_p = with_plain(plain_fp32_run)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    bound = 2 * lr * steps
    free = {k: (hot_k[k] - hot_p[k]).abs().max().item() for k in hot_names}
    del hot_k, hot_p

    # lock step: each step from the kernel trainer's state, once on the
    # kernels and once on the plain versions. Run free, a rounding
    # difference anywhere upstream of the atlas grows over the steps where
    # the atlas is not smooth: a vertex weight crossing prune_node_threshold
    # (the random init's weights cluster at 1/V_max, next to 0.001), a
    # projected entry leaving its exact 0
    def trainer_state(tr):
        """A copy of all a step reads and writes: the parameters, the AdamW
        state (deep: ``load_state_dict`` keeps the tensors it is given, so a
        shallow copy would let two trainers update one state; the
        low-memory groups' moments with it), the atlas moments and the step
        count."""
        return ({k: v.detach().clone() for k, v in tr.model.state_dict().items()},
                copy.deepcopy(tr.optimizer.state_dict()),
                {k: {n: t.clone() for n, t in h.state.items()} for k, h in tr.hot.items()},
                tr.step)

    def load_trainer_state(tr, state):
        params, opt, hot, step = state
        tr.model.load_state_dict(params)
        tr.optimizer.load_state_dict(copy.deepcopy(opt))
        for k, moments in hot.items():
            for n, t in moments.items():
                tr.hot[k].state[n].copy_(t)
        tr.step = step

    def step_result(tr, loss, ids=()):
        """The loss, every parameter, gradient and atlas moment after a step,
        and the step's VQ ids."""
        out = {"loss": torch.tensor(loss), **{f"vq ids {i}": t.clone() for i, t in enumerate(ids)}}
        for k, p in tr.model.named_parameters():
            out[f"param {k}"] = p.detach().clone()
            if p.grad is not None:
                out[f"grad {k}"] = p.grad.detach().clone()
        for k, h in tr.hot.items():
            out.update({f"{n} {k}": t.clone() for n, t in h.state.items()})
        for gi, group in enumerate(tr.optimizer.state_dict().get("lowmem", ())):
            for pi, slot in enumerate(group):
                out.update({f"lowmem {gi}/{pi} {n}": t.clone() for n, t in slot.items()})
        return out

    def differing(a, b):
        return sorted(k for k in a if not torch.equal(a[k], b[k]))

    tk, tp = make_trainer(), make_trainer()
    lock_vq = {"rows": 0, "mismatches": 0, "near_ties_only": True}
    lock = {k: {"sure_share": [], "sure_ok": True, "max_abs_diff_sure": 0.0, "max_abs_diff": 0.0,
                "grad_rel_err": 0.0} for k in hot_names}
    lock_loss_rel = 0.0
    run_to_run = {}
    for i, batch in enumerate(batches):
        state = trainer_state(tk)
        load_trainer_state(tp, state)
        step_ids = []

        def kernel_step():
            step_ids.clear()
            with recording_vq(step_ids):
                return tk.train_iter(batch)["loss"].item()

        def plain_step():
            with replaying_vq(step_ids, lock_vq):
                return tp.train_iter(batch)["loss"].item()

        loss_k = kernel_step()
        if i == 0:  # the first lock step twice from one state, on each side
            first = step_result(tk, loss_k, step_ids)
            load_trainer_state(tk, state)
            loss_k = kernel_step()
            run_to_run["kernel"] = differing(first, step_result(tk, loss_k, step_ids))
            first = step_result(tp, with_plain(plain_step))
            load_trainer_state(tp, state)
            loss_p = with_plain(plain_step)
            run_to_run["plain"] = differing(first, step_result(tp, loss_p))
            del first
            torch.cuda.empty_cache()
        else:
            loss_p = with_plain(plain_step)
        del state
        lock_loss_rel = max(lock_loss_rel, abs(loss_k - loss_p) / abs(loss_p))
        for k in hot_names:
            pk, pp = tk.hot[k].param, tp.hot[k].param
            grad = pp.grad.abs()
            sure = grad > 1e-3 * grad.max()
            diff = (pk.detach() - pp.detach()).abs()
            r = lock[k]
            r["sure_share"].append(sure.float().mean().item())
            ok = bool((diff[sure] <= 1e-6 + 1e-4 * pp.detach().abs()[sure]).all())
            r.setdefault("sure_ok_steps", []).append(ok)
            r["sure_ok"] &= ok
            r["max_abs_diff_sure"] = max(r["max_abs_diff_sure"], diff[sure].max().item())
            r["max_abs_diff"] = max(r["max_abs_diff"], diff.max().item())
            r.setdefault("grad_rel_err_steps", []).append(rel_err(pk.grad, pp.grad))
            r["grad_rel_err"] = max(r["grad_rel_err_steps"])
    del tk, tp
    torch.cuda.empty_cache()
    phase(label, steps=steps, batch=len(batches[0]["label"]), losses=losses_k,
          plain_losses=losses_p,
          loss_rel_err=loss_rel, free_run_max_abs_diff=free, bound=bound,
          lock_step_loss_rel_err=lock_loss_rel, lock_step=lock,
          tol={"loss": 1e-4, "sure": "rtol 1e-4 / atol 1e-6"},
          **replay_report(s4_vq), lock_step_vq=replay_report(lock_vq),
          run_to_run_bitwise={side: not names for side, names in run_to_run.items()},
          attn_launches={k: s4_launches[k] for k in want_attn},
          run_to_run_differs={side: names[:20] for side, names in run_to_run.items()}, **fields)
    for side, names in run_to_run.items():
        require(not names, f"fp32 lock step, {side} side: a step from one state twice differs in "
                           f"{names[:20]}")
    require(loss_rel <= 1e-4 and lock_loss_rel <= 1e-4,
            f"fp32 train losses differ by {loss_rel} (free) / {lock_loss_rel} (lock step)")
    for k in hot_names:
        r = lock[k]
        require(free[k] <= bound, f"fp32 {k}: differs by {free[k]} > {bound} after the free run")
        require(r["sure_ok"] or not tight, f"fp32 {k}: a step differs beyond rtol 1e-4 / atol "
                                           "1e-6 where |g| is large")
        require(r["max_abs_diff"] <= bound, f"fp32 {k}: a step differs by {r['max_abs_diff']}")
    return s4_launches, lock



def imagenet_phases(dev, card_note: dict, helpers: dict) -> dict:
    """Phases 24-30: the kernels at the DeiT-Small, DeiT-Base and ImageNet
    widths against their plain versions; the ImageNet DeiT-Small
    configuration's serving (bf16, counted and timed; fp32 against the plain
    versions), its stage-4 step (bf16, counted, timed, profiled; fp32 in lock
    step against the plain versions) and its stage 0 (fp32 against the plain
    versions, bf16 counted); DeiT-Base's serving microbatch and stage-0
    steps. ``helpers``: main's ``with_plain``, ``recording_vq``,
    ``replaying_vq`` and ``replay_report``. Returns the rows of the kernels
    line for the new instantiations, and each phase's seconds."""
    from torch.profiler import ProfilerActivity, profile

    from schemanet_torch.models.vit import get_model
    from schemanet_torch.ops.kernels import atlas_opt as ao
    from schemanet_torch.ops.kernels import encoder_block as eb
    from schemanet_torch.ops.kernels import graphconv as gc
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts
    from schemanet_torch.ops.kernels import layernorm as lnk
    from schemanet_torch.ops.kernels import mlp as mk
    from schemanet_torch.pipeline.bundle import Bundle
    from schemanet_torch.schema import build_predictor, get_loss_fn, init_parameters_
    from schemanet_torch.serve import ServePredictor
    from schemanet_torch.train import (SCHEMA_NET_FROZEN, Trainer, TrainerConfig, backbone_trainer,
                                       schema_net_trainer)

    with_plain = helpers["with_plain"]
    seconds, rows, errors = {}, {}, {}
    g = torch.Generator().manual_seed(24)
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = now - t_phase
        t_phase = now
        phase("phase_seconds", phase_name=name, seconds=seconds[name], **card_note)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    def twice_equal(fn):
        a, b = fn(), fn()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def row(name, work, ms, plain_ms, library_ms=None, **extra):
        bound_ms, bound_by = least_ms(*work)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, **extra)
        phase("kernel_time", kernel=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=library_ms, **extra, **card_note)

    iters = 5  # events over 5 calls: these calls take milliseconds each
    vit_rows = BATCH * ((IMG // PATCH) ** 2 + 1)  # a batch of 64 at 197 tokens: 12,608 rows

    # 24. the kernels at the new widths against their plain versions, each
    # bitwise over two calls, each counted on its route
    ffn_cases = {"d768": (vit_rows, 768, 3072), "d768_rows1000": (1000, 768, 3072),
                 "d768_rows77": (77, 768, 3072)}
    for tag, (rows_, d_, f_) in ffn_cases.items():
        args = (rnd(1, rows_, d_), 1 + rnd(d_, scale=0.1), rnd(d_, scale=0.1),
                rnd(f_, d_, scale=d_**-0.5), rnd(f_, scale=0.1), rnd(d_, f_, scale=f_**-0.5),
                rnd(d_, scale=0.1))
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            a = (args[0].to(dt), *args[1:])
            before = eb.ffn_block.wide_launches
            label = f"ffn_block_{tag}" if dt == torch.bfloat16 else f"ffn_block_fp32_{tag}"
            compare(label, eb.ffn_block, eb.ffn_block_reference, a, {}, dt, tol, errors)
            same = twice_equal(lambda: eb.ffn_block(*a))
            phase("compare", kernel=label, run_to_run_bitwise=same,
                  wide_launches=eb.ffn_block.wide_launches - before)
            require(same and eb.ffn_block.wide_launches - before == 3,
                    f"{label}: two calls differ, or a call missed the wide route")
            if dt == torch.bfloat16:
                # the LN pass alone, bit for bit its plain emulation (on the CPU)
                ln = eb.ffn_ln_rows(*a[:3])
                ln_same = torch.equal(ln.cpu(), eb.ln_rows_reference(
                    *(t.cpu() for t in a[:3]), 1e-6))
                phase("compare", kernel=f"ffn_ln_rows_{tag}", bitwise_plain=ln_same,
                      plan=eb.ffn_plan(dt, rows_, d_, f_).launches)
                require(ln_same, f"ffn_block {tag}: the LN pass differs from ln_rows_reference")
                del ln
            if tag == "d768" and dt == torch.bfloat16:
                # only the repo's kernels, and none of the first design's
                # linear_tc_kernel: no cuBLAS, CUTLASS or cuDNN name
                with torch.no_grad():
                    names = kernel_names(lambda: eb.ffn_block(*a))
                library = [n for n in names
                           if any(mark in n.lower() for mark in LIBRARY_KERNEL_MARKS)]
                phase("kernel_names", kernel="ffn_block", dim=d_, dtype="bfloat16", names=names,
                      library=library)
                require(not library and any("ln_rows_bf16" in n for n in names)
                        and sum("gemm_wg_kernel" in n for n in names) == 2
                        and not any("linear_tc" in n for n in names),
                        f"ffn_block at 768 ran library kernels or not its three: {names}")
            if tag == "d768":
                x_, g1, b1, w1, fb1, w2, fb2 = a
                flops = 4 * x_.numel() * f_ * (3 if dt == torch.float32 else 1)
                moved = 2 * nbytes(x_) + nbytes(g1, b1, w1, fb1, w2, fb2)
                name = "ffn_block_d768" if dt == torch.bfloat16 else "ffn_block_fp32_d768"
                with torch.no_grad():
                    row(name, (flops, moved, "tfloat32" if dt == torch.float32 else "bfloat16"),
                        time_ms(lambda: eb.ffn_block(*a), iters),
                        time_ms(lambda: eb.ffn_block_reference(*a), iters), shape=list(x_.shape))
    # the frozen layer halves at DeiT-Small's and DeiT-Base's widths in bf16,
    # the instantiations ImageNet serving, stage 4 and DeiT-Base serving run
    for d_, heads_, f_ in ((384, 6, 1536), (768, 12, 3072)):
        x_ = rnd(BATCH, vit_rows // BATCH, d_).to(torch.bfloat16)
        g1, b1 = 1 + rnd(d_, scale=0.1), rnd(d_, scale=0.1)
        wqkv, bqkv = rnd(3 * d_, d_, scale=d_**-0.5), rnd(3 * d_, scale=0.1)
        wo, bo = rnd(d_, d_, scale=d_**-0.5), rnd(d_, scale=0.1)
        attn_a = (x_, g1, b1, wqkv, bqkv, wo, bo, heads_)
        compare(f"attn_block_d{d_}", eb.attn_block, eb.attn_block_reference, attn_a, {},
                torch.bfloat16, BF16_TOL, errors)
        n_ = x_.shape[1]
        flops = 2 * vit_rows * d_ * 4 * d_ + 4 * BATCH * n_ * n_ * d_
        moved = 2 * nbytes(x_) + nbytes(g1, b1, *(t.to(torch.bfloat16) for t in (wqkv, bqkv, wo,
                                                                                  bo)))
        with torch.no_grad():
            row(f"attn_block_d{d_}", (flops, moved, "bfloat16"),
                time_ms(lambda: eb.attn_block(*attn_a), iters),
                time_ms(lambda: eb.attn_block_reference(*attn_a), iters), shape=list(x_.shape),
                heads=heads_)
        if d_ == 384:
            ffn_a = (x_, g1, b1, rnd(f_, d_, scale=d_**-0.5), rnd(f_, scale=0.1),
                     rnd(d_, f_, scale=f_**-0.5), rnd(d_, scale=0.1))
            compare("ffn_block_d384", eb.ffn_block, eb.ffn_block_reference, ffn_a, {},
                    torch.bfloat16, BF16_TOL, errors)
            moved = 2 * nbytes(x_) + nbytes(g1, b1, *(t.to(torch.bfloat16) for t in ffn_a[3:]))
            with torch.no_grad():
                row("ffn_block_d384", (4 * x_.numel() * f_, moved, "bfloat16"),
                    time_ms(lambda: eb.ffn_block(*ffn_a), iters),
                    time_ms(lambda: eb.ffn_block_reference(*ffn_a), iters), shape=list(x_.shape))
            del ffn_a
        del x_, attn_a
    mlp_same = {}
    for d_ in (384, 768):
        f_, rows_ = 4 * d_, vit_rows
        x_, g_ = rnd(rows_, d_), rnd(rows_, d_)
        w_ = (rnd(f_, d_, scale=d_**-0.5), rnd(f_, scale=0.1), rnd(d_, f_, scale=f_**-0.5))
        b2_ = rnd(d_, scale=0.1)
        for p in (0.0, S0_DROPOUT):
            seed = S0_SEED if p else None
            for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
                w_dt = tuple(t.to(dt) for t in w_)
                fwd = (x_.to(dt), *w_dt, b2_.to(dt), "gelu", p, seed)
                bwd = (x_.to(dt), *w_dt, g_.to(dt), "gelu", p, seed)
                suffix = f"d{d_}" + ("" if p else "_p0") + ("" if dt == torch.bfloat16 else "_fp32")
                before = (mk.fused_mlp.wide_launches, mk.fused_mlp_bwd.wide_launches)
                with torch.no_grad():
                    compare(f"fused_mlp_{suffix}", mk.fused_mlp, mk.fused_mlp_reference, fwd, {},
                            dt, tol, errors)
                compare(f"fused_mlp_bwd_{suffix}", mk.fused_mlp_bwd, mk.fused_mlp_bwd_reference,
                        bwd, {}, dt, tol, errors)
                with torch.no_grad():
                    mlp_same[suffix] = (twice_equal(lambda: mk.fused_mlp(*fwd))
                                        and twice_equal(lambda: mk.fused_mlp_bwd(*bwd)))
                require((mk.fused_mlp.wide_launches, mk.fused_mlp_bwd.wide_launches) ==
                        (before[0] + 3, before[1] + 3),
                        f"fused_mlp {suffix}: not on the wide route")
                if dt == torch.bfloat16 and p and d_ == 384:
                    # the wide route launches only the repo's kernels: none of
                    # the profiled names is a cuBLAS or CUTLASS library kernel
                    with torch.no_grad():
                        names = {"fused_mlp": kernel_names(lambda: mk.fused_mlp(*fwd)),
                                 "fused_mlp_bwd": kernel_names(lambda: mk.fused_mlp_bwd(*bwd))}
                    library = [n for v in names.values() for n in v
                               if any(mark in n.lower() for mark in LIBRARY_KERNEL_MARKS)]
                    ours = {k: [n for n in v if "sn::" in n] for k, v in names.items()}
                    phase("kernel_names", dim=d_, dtype="bfloat16", names=names, library=library)
                    require(not library and all(ours.values()),
                            f"the wide route ran library kernels, or none of its own: {names}")
                if dt == torch.bfloat16 and p:
                    mlp = 2 * rows_ * d_ * f_
                    wbytes = nbytes(*w_dt)
                    with torch.no_grad():
                        row(f"fused_mlp_d{d_}", (2 * mlp, 2 * nbytes(fwd[0]) + wbytes + nbytes(
                            fwd[4]), "bfloat16"), time_ms(lambda: mk.fused_mlp(*fwd), iters),
                            time_ms(lambda: mk.fused_mlp_reference(*fwd), iters),
                            shape=list(fwd[0].shape), dropout=p)
                    row(f"fused_mlp_bwd_d{d_}", (5 * mlp, 3 * nbytes(fwd[0]) + 2 * wbytes,
                                                  "bfloat16"),
                        time_ms(lambda: mk.fused_mlp_bwd(*bwd), iters),
                        time_ms(lambda: mk.fused_mlp_bwd_reference(*bwd), iters),
                        shape=list(fwd[0].shape), dropout=p)
    phase("compare", kernel="fused_mlp_wide", run_to_run_bitwise=mlp_same)
    require(all(mlp_same.values()), f"fused_mlp at 384/768: two calls differ: {mlp_same}")
    del x_, g_, w_, fwd, bwd
    torch.cuda.empty_cache()

    # the LayerNorm at the ImageNet class graphs (relu) and the ViT widths
    ln_same = {}
    for tag, (rows_, d_, act) in {"d1024": (IN_CLASSES * IN_VMAX, IN_GNN, "relu"),
                                  "d384": (vit_rows, 384, "none"),
                                  "d768": (vit_rows, 768, "none")}.items():
        x32 = rnd(rows_, d_)
        sc, bi = 1 + rnd(d_, scale=0.1), rnd(d_, scale=0.1)
        cot32 = rnd(rows_, d_)
        if act == "relu":  # no cotangent at a gate tie (|y| <= 1e-5 max |y|), as phase 15
            y = lnk.fused_layernorm_reference(x32, sc, bi, 1e-6, act)
            cot32 = torch.where(y.abs() <= 1e-5 * y.abs().max(), 0.0, cot32)
            for dt in (torch.bfloat16,):
                yk = lnk.fused_layernorm_reference(x32.to(dt), sc, bi, 1e-6, act).float()
                cot32 = torch.where(yk.abs() <= 1e-5 * yk.abs().max(), 0.0, cot32)
            del y, yk
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            xx, cc = x32.to(dt), cot32.to(dt)
            label = f"fused_layernorm_{tag}" + ("" if dt == torch.bfloat16 else "_fp32")
            compare(label, lnk.fused_layernorm, lnk.fused_layernorm_reference,
                    (xx, sc, bi, 1e-6, act), {}, dt, tol, errors)
            compare(label.replace("layernorm", "layernorm_bwd"), lnk.fused_layernorm_bwd,
                    lnk.fused_layernorm_bwd_reference, (xx, sc, bi, cc, 1e-6, act), {}, dt, tol,
                    errors)
            ln_same[label] = twice_equal(lambda: lnk.fused_layernorm_bwd(xx, sc, bi, cc, 1e-6,
                                                                         act)[1:])
            if tag == "d1024" and dt == torch.bfloat16:
                row("fused_layernorm_d1024", (*ln_work(xx), "float32"),
                    time_ms(lambda: lnk.fused_layernorm(xx, sc, bi, 1e-6, act), iters),
                    time_ms(lambda: lnk.fused_layernorm_reference(xx, sc, bi, 1e-6, act), iters),
                    shape=list(xx.shape), act=act)
                row("fused_layernorm_bwd_d1024", (*ln_work(xx, bwd=True), "float32"),
                    time_ms(lambda: lnk.fused_layernorm_bwd(xx, sc, bi, cc, 1e-6, act), iters),
                    time_ms(lambda: lnk.fused_layernorm_bwd_reference(xx, sc, bi, cc, 1e-6, act),
                            iters), shape=list(xx.shape), act=act)
        del x32, cot32, xx, cc
        torch.cuda.empty_cache()
    phase("compare", kernel="fused_layernorm_wide", dparams_run_to_run_bitwise=ln_same)
    require(all(ln_same.values()), f"fused_layernorm_bwd dscale/dbias differ: {ln_same}")

    # adamw_project_rows with bf16 moments on the ImageNet edge and vertex
    # tensors, against the plain low-memory update plus the projection
    adam_report = {}
    atlas_shapes = {"edge": (IN_CLASSES, IN_VMAX, IN_VMAX), "vertex": (IN_CLASSES, IN_VMAX)}
    for tag, shape in atlas_shapes.items():
        p0 = torch.rand(*shape, generator=g).to(dev)
        p0 /= p0.sum(-1, keepdim=True)
        grad = rnd(*shape, scale=1e-4)
        m0 = rnd(*shape, scale=1e-5).to(torch.bfloat16)
        v0 = (rnd(*shape, scale=1e-5) ** 2).to(torch.bfloat16)
        hyper = dict(lr=1e-3, weight_decay=5e-4, project=True)
        outs = []
        for fn in (ao.adamw_project_rows, ao.adamw_project_rows, ao.adamw_project_rows_reference):
            p_, m_, v_ = p0.clone(), m0.clone(), v0.clone()
            fn(p_, grad, m_, v_, 3, **hyper)
            outs.append((p_, m_, v_))
        (pk, mk_, vk), (pk2, mk2, vk2), (pp, mp, vp) = outs

        def within_ulp(got, want, terms):
            """|got - want| <= one bf16 ulp of the larger, beyond the fp32
            rounding of the moment's sum b t + (1 - b) x (2^-22 of its
            terms' magnitudes: where the two terms cancel, the kernel's fused
            multiply-add and the plain version's two roundings leave
            different fp32 residues); the worst offender for the report."""
            big = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
            tol = torch.exp2(torch.floor(torch.log2(big)) - 7) + 2.0**-22 * terms
            excess = (got.float() - want.float()).abs() - tol
            i = int(excess.flatten().argmax())
            return bool((excess <= 0).all()), [got.flatten()[i].item(), want.flatten()[i].item()]

        m_ok, m_worst = within_ulp(mk_, mp, 0.9 * m0.float().abs() + 0.1 * grad.abs())
        v_ok, v_worst = within_ulp(vk, vp, 0.999 * v0.float().abs() + 0.001 * grad * grad)
        adam_report[tag] = {
            "p_rel_err": rel_err(pk, pp),
            "m_within_1_ulp": m_ok, "v_within_1_ulp": v_ok, "m_worst": m_worst,
            "v_worst": v_worst,
            "m_equal_share": (mk_ == mp).float().mean().item(),
            "run_to_run_bitwise": all(torch.equal(a, b) for a, b in
                                      ((pk, pk2), (mk_, mk2), (vk, vk2))),
            "moment_dtypes": [str(mk_.dtype), str(vk.dtype)]}
        errors[f"adamw_project_rows_bf16_{tag}"] = abs_err(pk, pp)
        r = adam_report[tag]
        require(r["p_rel_err"] <= FP32_TOL and r["m_within_1_ulp"] and r["v_within_1_ulp"]
                and r["run_to_run_bitwise"], f"adamw_project_rows bf16 moments {tag}: {r}")
        if tag == "edge":
            p_, m_, v_ = p0.clone(), m0.clone(), v0.clone()
            prm = p0.numel()
            # p and g read and p written in fp32, m and v read and written in bf16
            row("adamw_project_rows_bf16", (15 * prm, 3 * 4 * prm + 4 * 2 * prm, "float32"),
                time_ms(lambda: ao.adamw_project_rows(p_, grad, m_, v_, 3, **hyper), iters),
                time_ms(lambda: ao.adamw_project_rows_reference(p_, grad, m_, v_, 3, **hyper),
                        iters), shape=list(shape))
        del p0, grad, m0, v0, outs, pk, mk_, vk, pk2, mk2, vk2, pp, mp, vp
        torch.cuda.empty_cache()
    phase("compare", kernel="adamw_project_rows_bf16",
          tol={"p": FP32_TOL, "m, v": "1 bf16 ulp beyond the fp32 rounding of the sum"},
          **adam_report)
    lap("24_kernels_at_new_widths")

    # 25. ImageNet DeiT-Small serving, bf16: the stage-4 trainer's predictor
    # (schema_net_trainer from a seeded bundle: DeiT-Small, M = 8000 codes),
    # K = 1000 class graphs of V_max = 500, class ingredients drawn distinct
    # a class from the 8000 codes
    small = vit_cfg(384, 6, None)
    vit = get_model(small, IN_CLASSES)
    init_parameters_(vit, torch.Generator().manual_seed(0))
    bundle = Bundle(model_cfg=small, encode_layer=ENCODE_LAYER, img_size=IMG,
                    backbone_state={k: v.clone() for k, v in vit.state_dict().items()},
                    codebook=torch.rand(IN_CODES, 384, generator=g) * 2 - 1, extra={})
    del vit
    ingredients = torch.stack([torch.randperm(IN_CODES, generator=g)[:IN_VMAX]
                               for _ in range(IN_CLASSES)]).to(torch.int32)
    tr = schema_net_trainer(IN_SCHEMA_CFG, bundle, None, IN_STEPS_PER_EPOCH, seed=0, device=dev)
    with torch.no_grad():
        tr.model.schema_net.class_ingredients.copy_(ingredients)
    serve = ServePredictor(tr.model, microbatch=MICROBATCH, device=dev)
    images = torch.from_numpy(np.random.default_rng(25).normal(
        size=(N_IMAGES, IMG, IMG, 3)).astype(np.float32)).to(dev)
    reset_launch_counts()
    logits = serve.predict_tensor(images)
    torch.cuda.synchronize()
    serve_launches = launch_counts()
    mbs = -(-N_IMAGES // MICROBATCH)
    convs = 2 * IN_SCHEMA_CFG["schema_net"]["gnn"]["num_layers"]
    expected = {name: 0 for name in serve_launches}
    expected.update({"attn_block": FROZEN_LAYERS * mbs, "attn_block_hmean": mbs,
                     "attn_block_tc": FROZEN_LAYERS * mbs, "ffn_block": FROZEN_LAYERS * mbs,
                     "ffn_block_tc": FROZEN_LAYERS * mbs, "vq_assign": mbs, "vq_assign_tc": mbs,
                     "sym_conv": convs * mbs, "sym_conv_tc": convs * mbs,
                     "fused_layernorm": convs * mbs})
    head = serve.predict_tensor(images[:5])
    invariant = torch.equal(head, logits[:5])
    finite = bool(torch.isfinite(logits).all())
    lat = []
    for _ in range(LATENCY_ITERS):
        t0 = time.perf_counter()
        serve.predict_tensor(images[:MICROBATCH])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    phase("imagenet_serve_bf16", images=N_IMAGES, microbatches=mbs, logits=list(logits.shape),
          finite=finite, batch_invariant=invariant, launches=serve_launches, expected=expected,
          p50_ms=p50, p99_ms=p99, images_per_s=MICROBATCH / p50 * 1e3, classes=IN_CLASSES,
          codes=IN_CODES, v_max=IN_VMAX, gnn=IN_GNN, **card_note)
    require(tuple(logits.shape) == (N_IMAGES, IN_CLASSES) and finite,
            f"ImageNet bf16 logits {tuple(logits.shape)}, finite {finite}")
    require(invariant, "ImageNet serving: predict(x[:5]) != predict(x)[:5]")
    require(serve_launches == expected, f"ImageNet serving launches {serve_launches} != {expected}")
    lap("25_imagenet_serve_bf16")

    # 27. the ImageNet stage-4 step in bf16: the main path, counted, timed
    rng = np.random.default_rng(27)
    batches = [{"image": torch.from_numpy(rng.integers(0, 256, size=(BATCH, IMG, IMG, 3),
                                                        dtype=np.uint8)).to(dev),
                "label": torch.from_numpy(rng.integers(0, IN_CLASSES, size=BATCH)).to(dev)}
               for _ in range(BF16_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [tr.train_iter(b)["loss"].item() for b in batches]
    first_steps_s = time.perf_counter() - t0
    train_launches = launch_counts()
    expected = {name: 0 for name in train_launches}
    expected.update({"attn_block": FROZEN_LAYERS * BF16_STEPS, "attn_block_hmean": BF16_STEPS,
                     "attn_block_tc": FROZEN_LAYERS * BF16_STEPS,
                     "ffn_block": FROZEN_LAYERS * BF16_STEPS,
                     "ffn_block_tc": FROZEN_LAYERS * BF16_STEPS, "vq_assign": BF16_STEPS,
                     "vq_assign_tc": BF16_STEPS,
                     **{name: convs * BF16_STEPS for name in (
                         "sym_conv", "sym_conv_bwd", "sym_conv_tc", "sym_conv_bwd_tc",
                         "fused_layernorm", "fused_layernorm_bwd", "fused_layernorm_bwd_vec")},
                     "embed_grad": 2 * BF16_STEPS, "embed_grad_vec": 2 * BF16_STEPS,
                     "embed_grad_planned": BF16_STEPS,
                     "adamw_project_rows": 2 * BF16_STEPS,  # the hot atlas tensors, on
                     "adamw_project_rows_bf16": 2 * BF16_STEPS,  # the 4-column route
                     "adamw_project_rows_vec": 2 * BF16_STEPS})
    moments = {name: {k: str(t.dtype) for k, t in h.state.items()} for name, h in tr.hot.items()}
    moments.update({f"lowmem {gi}/{pi}": {k: str(t.dtype) for k, t in slot.items()}
                    for gi, group in enumerate(tr.optimizer.lowmem.state)
                    for pi, slot in enumerate(group)})
    step_ms = []
    for b in batches[:3]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_iter(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for attempt in range(1, 6):  # a session without device events is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[:2]:
                tr.train_iter(b)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = device_time_by_name(prof)
        busy_us = sum(busy.values())
        if busy_us:
            break
        phase("profile_empty", attempt=attempt, iters=2)
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    step_p50 = float(np.median(step_ms))
    phase("imagenet_train_bf16", steps=BF16_STEPS, batch=BATCH, losses=losses,
          launches=train_launches, expected=expected, moment_dtypes=moments,
          first_steps_s=first_steps_s, step_ms=step_ms, p50_ms=step_p50,
          images_per_s=BATCH / step_p50 * 1e3, device_busy_ms_a_step=busy_us / 2e3,
          idle_share=1 - busy_us / wall_us if busy_us else None,
          top_device_ms_a_step={k: v / 2e3 for k, v in top}, peak_memory_gb=peak_gb,
          **card_note)
    require(all(np.isfinite(losses)), f"ImageNet bf16 stage-4 losses not finite: {losses}")
    require(train_launches == expected, f"ImageNet stage-4 launches {train_launches} != {expected}")
    require(all(t == "torch.bfloat16" for m in moments.values() for t in m.values()),
            f"an atlas tensor's moment is not bf16: {moments}")
    require(busy_us > 0, "the ImageNet stage-4 profile holds no device time")
    launches_path = {"ffn_block_d384": train_launches["ffn_block"],
                     "attn_block_d384": train_launches["attn_block"],
                     "fused_layernorm_d1024": train_launches["fused_layernorm"],
                     "fused_layernorm_bwd_d1024": train_launches["fused_layernorm_bwd"],
                     "adamw_project_rows_bf16": train_launches["adamw_project_rows_bf16"],
                     "sym_conv_imagenet": train_launches["sym_conv"],
                     "sym_conv_bwd_imagenet": train_launches["sym_conv_bwd"]}
    # the class graphs' GraphConv at [1000, 500, 1024], beside its plain version
    e16 = tr.model.schema_net.edge_weights.detach().to(torch.bfloat16)
    f16 = rnd(IN_CLASSES, IN_VMAX, IN_GNN).to(torch.bfloat16)
    compare("sym_conv_imagenet", gc.sym_conv, gc.sym_conv_reference, (e16, f16), {},
            torch.bfloat16, BF16_TOL, errors)
    gout = rnd(IN_CLASSES, IN_VMAX, IN_GNN).to(torch.bfloat16)
    compare("sym_conv_bwd_imagenet", gc.sym_conv_bwd, gc.sym_conv_bwd_reference,
            (e16, f16, gout), {}, torch.bfloat16, BF16_TOL, errors)
    conv_flops = 2 * IN_CLASSES * IN_VMAX * IN_VMAX * IN_GNN + 2 * IN_CLASSES * IN_VMAX * IN_VMAX
    with torch.no_grad():
        row("sym_conv_imagenet", (conv_flops, nbytes(e16, f16, f16), "bfloat16"),
            time_ms(lambda: gc.sym_conv(e16, f16), iters),
            time_ms(lambda: gc.sym_conv_reference(e16, f16), iters), shape=list(f16.shape))
        row("sym_conv_bwd_imagenet", (2 * conv_flops, nbytes(e16, f16, gout, e16, f16),
                                      "bfloat16"),
            time_ms(lambda: gc.sym_conv_bwd(e16, f16, gout), iters),
            time_ms(lambda: gc.sym_conv_bwd_reference(e16, f16, gout), iters),
            shape=list(f16.shape))
    del e16, f16, gout, tr, serve, batches, images
    torch.cuda.empty_cache()
    lap("27_imagenet_train_bf16")

    # 26 and 28 in fp32 against the plain versions, K cut to 100 classes (two
    # trainers and the plain GraphConv's E_sym at K = 1000 pass 80 GB)
    def fp32_model(dtype=torch.float32):
        schema = dict(IN_SCHEMA_CFG["schema_net"], ir_atlas=dict(
            IN_SCHEMA_CFG["schema_net"]["ir_atlas"], graph_precision="highest"))
        return build_predictor(small, schema, IN_FP32_CLASSES, IN_CODES, 384, ENCODE_LAYER,
                               dtype=dtype)

    m32 = fp32_model()
    init_parameters_(m32, torch.Generator().manual_seed(0))
    with torch.no_grad():  # the bundle's backbone; its 1000-class head is not on the path
        m32.ingredient_backbone.backbone.load_state_dict(
            {k: v for k, v in bundle.backbone_state.items() if not k.startswith("cls_head.")},
            strict=False)
        m32.ingredient_backbone.vocabulary.copy_(bundle.codebook)
        m32.schema_net.class_ingredients.copy_(ingredients[:IN_FP32_CLASSES])
    host_state = {k: v.clone() for k, v in m32.state_dict().items()}
    s32 = ServePredictor(m32, microbatch=MICROBATCH, device=dev)
    images = torch.from_numpy(np.random.default_rng(26).normal(
        size=(N_IMAGES, IMG, IMG, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        reset_launch_counts()
        logits_k = s32.predict_tensor(images)
        fp32_launches = launch_counts()
        ids_k = s32.predictor.ingredient_backbone(images[:MICROBATCH])["ingredients"]
        logits_p = with_plain(lambda: s32.predict_tensor(images))
        ids_p = with_plain(lambda: s32.predictor.ingredient_backbone(images[:MICROBATCH]))[
            "ingredients"]
    torch.cuda.synchronize()
    agree = (ids_k == ids_p).float().mean().item()
    scale = logits_p.abs().max().item()
    logit_err = (logits_k - logits_p).abs().max().item()
    want_attn = {"attn_block": FROZEN_LAYERS * mbs, "attn_block_tc": FROZEN_LAYERS * mbs,
                 "attn_block_hmean": mbs}
    phase("imagenet_serve_fp32", images=N_IMAGES, classes=IN_FP32_CLASSES,
          vq_id_agreement=agree, logit_max_abs_err=logit_err, logit_scale=scale,
          tol=1e-3 * scale, attn_launches={k: fp32_launches[k] for k in want_attn})
    require({k: fp32_launches[k] for k in want_attn} == want_attn,
            "ImageNet fp32 serving: an attn_block launch missed the split-TF32 route")
    require(tuple(logits_k.shape) == (N_IMAGES, IN_FP32_CLASSES), "ImageNet fp32 logits shape")
    require(agree >= 0.999, f"ImageNet fp32 VQ ids agree on {agree:.5f} < 0.999 of tokens")
    require(logit_err <= 1e-3 * scale, f"ImageNet fp32 logits differ by {logit_err}")
    del s32, m32, logits_k, logits_p, images
    torch.cuda.empty_cache()
    lap("26_imagenet_serve_fp32")

    rng = np.random.default_rng(28)
    batches = [{"image": torch.from_numpy(rng.normal(size=(BATCH, IMG, IMG, 3)).astype(
        np.float32)).to(dev),
                "label": torch.from_numpy(rng.integers(0, IN_FP32_CLASSES, size=BATCH)).to(dev)}
               for _ in range(FP32_STEPS)]
    trainer_cfg = TrainerConfig.from_cfg(IN_SCHEMA_CFG["training"],
                                         frozen_patterns=SCHEMA_NET_FROZEN)
    loss_fn = get_loss_fn(IN_SCHEMA_CFG["loss"])

    def fp32_trainer():
        mdl = fp32_model()
        mdl.load_state_dict(host_state)
        return Trainer(trainer_cfg, mdl, loss_fn, LOSS_WEIGHTS, IN_STEPS_PER_EPOCH, device=dev)

    # The tight rule is reported here, not gated. The rows' projection ties
    # every edge weight of a row to its row's sum, and where |g| is below the
    # two sides' gradient difference, Adam's step g / (|g| + eps) may take
    # either sign: a whole row then moves beyond rtol 1e-4 while each entry
    # keeps the bound. From the second step on, the GNN's 1024-wide
    # activations also give the LayerNorm's E[x^2] - E[x]^2 variance (flax's,
    # as the TPU kernels and both of the port's versions compute it) a
    # cancellation, which leaves the edge weights' fp32 gradient known to
    # ~1e-3 of its max. Gated instead: the first lock step's gradients (from
    # the fresh model, where fp32 holds them) within 1e-5, and the fp64 check
    # below (the kernels' gradient no farther from fp64 than the plain one's).
    _, lock = stage4_fp32_vs_plain(
        fp32_trainer, batches, IN_SCHEMA_CFG["training"]["optimizer"]["lr"], FROZEN_LAYERS,
        helpers, label="imagenet_train_fp32", tight=False, classes=IN_FP32_CLASSES,
        moments="bf16 (the schema_net group's)")
    first = {k: r["grad_rel_err_steps"][0] for k, r in lock.items()}
    require(all(v <= 1e-5 for v in first.values()),
            f"ImageNet fp32 lock step: the first step's atlas gradients differ by {first}")

    # the step's atlas gradient after 2 kernel steps: kernels and plain
    # versions in fp32 against the plain versions in fp64; the kernels may
    # not be the farther from fp64 (by more than 10%)
    tr = fp32_trainer()
    for b in batches[:2]:
        tr.train_iter(b)
    stepped = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    del tr

    def step_grads(plain: bool, dtype=torch.float32):
        mdl = fp32_model(dtype).to(dtype)
        mdl.load_state_dict(stepped)
        t = Trainer(trainer_cfg, mdl, loss_fn, LOSS_WEIGHTS, IN_STEPS_PER_EPOCH, device=dev)
        batch = {"image": batches[2]["image"].to(dtype), "label": batches[2]["label"]}

        def run():
            t.zero_grad()
            t.forward_loss(batch)[0].backward()
            return {k: getattr(t.model.schema_net, k).grad.double() for k in (
                "edge_weights", "vertex_weights")}

        return with_plain(run) if plain else run()

    ids = []
    with helpers["recording_vq"](ids):
        g_k = step_grads(False)
    vq_ids = list(ids)
    stats = {"rows": 0, "mismatches": 0, "near_ties_only": True}
    with helpers["replaying_vq"](list(vq_ids), stats):
        g_p = step_grads(True)
    with helpers["replaying_vq"](list(vq_ids), dict(stats)):
        g_64 = step_grads(True, torch.float64)
    cond = {k: {"kernel_vs_plain": rel_err(g_k[k], g_p[k]),
                "kernel_vs_fp64": rel_err(g_k[k], g_64[k]),
                "plain_vs_fp64": rel_err(g_p[k], g_64[k])} for k in g_k}
    phase("imagenet_grad_vs_fp64", after_steps=2, **cond)
    require(all(c["kernel_vs_fp64"] <= 1.1 * c["plain_vs_fp64"] + 1e-6 for c in cond.values()),
            f"the kernels' fp32 atlas gradient is farther from fp64 than the plain one: {cond}")
    del g_k, g_p, g_64, stepped
    del batches, host_state
    torch.cuda.empty_cache()
    lap("28_imagenet_train_fp32")

    # 29. DeiT-Small stage 0 (configs/imagenet/vanilla/deit_small.yaml):
    # 3 fp32 steps against the plain versions (phase 12's rules), then 5 bf16
    # steps counted
    def stage0(dim, heads, dtype, n_classes=IN_CLASSES):
        cfg = vanilla_cfg(dim, heads)
        cfg["training"] = dict(cfg["training"], dtype=dtype)
        return backbone_trainer(cfg, IN_STEPS_PER_EPOCH, seed=0, device=dev,
                                num_classes=n_classes)

    rng = np.random.default_rng(29)
    s0_batches = [{"image": torch.from_numpy(rng.normal(size=(BATCH, IMG, IMG, 3)).astype(
        np.float32)).to(dev),
                   "label": torch.from_numpy(rng.integers(0, IN_CLASSES, size=BATCH)).to(dev)}
                  for _ in range(BF16_STEPS)]

    def s0_fp32_run(track_sure):
        tr0 = stage0(384, 6, "float32")
        out_losses, sure = [], {}
        for b in s0_batches[:FP32_STEPS]:
            out_losses.append(tr0.train_iter(b)["loss"].item())
            if track_sure and not sure:
                for k, prm in tr0.model.named_parameters():
                    gr = prm.grad.abs()
                    sure[k] = gr > 1e-3 * gr.max()
        params = {k: prm.detach().clone() for k, prm in tr0.model.named_parameters()}
        del tr0
        torch.cuda.empty_cache()
        return out_losses, params, sure

    losses_k, params_k, _ = s0_fp32_run(False)
    losses_p, params_p, sure = with_plain(lambda: s0_fp32_run(True))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    bound_step = 2 * vanilla_cfg(384, 6)["training"]["optimizer"]["lr"] * FP32_STEPS
    worst = {"max_abs_diff": 0.0, "max_abs_diff_sure": 0.0, "sure_ok": True}
    for k in params_p:
        diff = (params_k[k] - params_p[k]).abs()
        worst["max_abs_diff"] = max(worst["max_abs_diff"], diff.max().item())
        if sure[k].any():
            worst["max_abs_diff_sure"] = max(worst["max_abs_diff_sure"],
                                             diff[sure[k]].max().item())
            worst["sure_ok"] &= bool((diff[sure[k]] <= 1e-6 + 1e-4 * params_p[k].abs()[
                sure[k]]).all())
    phase("imagenet_stage0_fp32", model="deit_small", steps=FP32_STEPS, batch=BATCH,
          losses=losses_k, plain_losses=losses_p, loss_rel_err=loss_rel, tol=1e-4,
          bound=bound_step, **worst)
    require(loss_rel <= 1e-4, f"DeiT-Small stage-0 fp32 losses differ by {loss_rel}")
    require(worst["sure_ok"], "DeiT-Small stage-0 fp32 parameters differ beyond rtol 1e-4 / "
                              "atol 1e-6 where |g| is large")
    require(worst["max_abs_diff"] <= bound_step, f"DeiT-Small stage-0 fp32: {worst}")
    del params_k, params_p, sure

    def counted_steps(tr0, steps, layers):
        torch.cuda.synchronize()
        reset_launch_counts()
        out_losses = [tr0.train_iter(b)["loss"].item() for b in s0_batches[:steps]]
        torch.cuda.synchronize()
        got = launch_counts()
        want = {name: 0 for name in got}
        want.update({name: layers * steps for name in (
            "fused_mhsa", "fused_mhsa_bwd", "fused_mlp", "fused_mlp_bwd", "fused_mhsa_tc",
            "fused_mhsa_bwd_tc", "fused_mlp_tc", "fused_mlp_bwd_tc", "fused_mlp_wide",
            "fused_mlp_bwd_wide")})
        want.update({name: (2 * layers + 1) * steps for name in (
            "fused_layernorm", "fused_layernorm_bwd", "fused_layernorm_bwd_vec")})
        ms = []
        for b in s0_batches[:2]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr0.train_iter(b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out_losses, got, want, ms

    def profiled_steps(tr0, steps=2):
        """The profiler's device ms a step (device activity only), the idle
        share of the steps' host wall time, and the top kernels a step."""
        return profiled_calls(lambda i: tr0.train_iter(s0_batches[i]), steps)

    def profiled_calls(fn, steps):
        """``profiled_steps`` of ``steps`` calls fn(0), fn(1), ..."""
        for attempt in range(1, 6):  # a session without device events is taken again
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(steps):
                    fn(i)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            by_kernel = device_time_by_name(prof)
            busy_us = sum(by_kernel.values())
            if busy_us:
                break
            phase("profile_empty", attempt=attempt, iters=steps)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        return dict(device_ms_a_step=busy_us / steps / 1e3,
                    wall_ms_a_step=wall_us / steps / 1e3,
                    idle_share=(1 - busy_us / wall_us) if busy_us else None,
                    top_device_ms_a_step={k[:80]: v / steps / 1e3 for k, v in top})

    tr0 = stage0(384, 6, "bfloat16")
    losses0, got, want, ms = counted_steps(tr0, BF16_STEPS, 12)
    phase("imagenet_stage0_bf16", model="deit_small", steps=BF16_STEPS, batch=BATCH,
          losses=losses0, launches=got, expected=want, step_ms=ms,
          images_per_s=BATCH / float(np.median(ms)) * 1e3, **profiled_steps(tr0), **card_note)
    require(all(np.isfinite(losses0)), f"DeiT-Small stage-0 bf16 losses: {losses0}")
    require(got == want, f"DeiT-Small stage-0 launches {got} != {want}")
    launches_path.update({"fused_mlp_d384": got["fused_mlp"], "fused_mlp_bwd_d384": got[
        "fused_mlp_bwd"]})
    del tr0
    torch.cuda.empty_cache()
    lap("29_deit_small_stage0")

    # 30. DeiT-Base (configs/imagenet/*/deit_base*): one bf16 serving
    # microbatch (K cut to 100 classes) with ffn_block at 768 counted, and 2
    # bf16 stage-0 steps with fused_mlp at 768 counted; depth not cut
    base = vit_cfg(768, 12, None)
    schema = dict(IN_SCHEMA_CFG["schema_net"], ir_atlas=dict(
        IN_SCHEMA_CFG["schema_net"]["ir_atlas"], graph_precision="default"))
    mb = build_predictor(base, schema, IN_FP32_CLASSES, IN_CODES, 768, ENCODE_LAYER,
                         dtype=torch.bfloat16)
    init_parameters_(mb, torch.Generator().manual_seed(0))
    with torch.no_grad():
        mb.schema_net.class_ingredients.copy_(ingredients[:IN_FP32_CLASSES])
    serve = ServePredictor(mb, microbatch=MICROBATCH, device=dev)
    images = torch.from_numpy(np.random.default_rng(30).normal(
        size=(MICROBATCH, IMG, IMG, 3)).astype(np.float32)).to(dev)
    reset_launch_counts()
    logits = serve.predict_tensor(images)
    torch.cuda.synchronize()
    base_serve = launch_counts()
    finite = bool(torch.isfinite(logits).all())
    lat = []
    for _ in range(LATENCY_ITERS):
        t0 = time.perf_counter()
        serve.predict_tensor(images)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    phase("deit_base_serve_bf16", classes=IN_FP32_CLASSES, logits=list(logits.shape),
          finite=finite, ffn_block_wide=base_serve["ffn_block_wide"],
          attn_block=base_serve["attn_block"], p50_ms=float(np.percentile(lat, 50)),
          p99_ms=float(np.percentile(lat, 99)),
          **profiled_calls(lambda i: serve.predict_tensor(images), 2), **card_note)
    require(finite and tuple(logits.shape) == (MICROBATCH, IN_FP32_CLASSES),
            "DeiT-Base bf16 logits not finite")
    require(base_serve["ffn_block_wide"] == base_serve["ffn_block"] == FROZEN_LAYERS
            == base_serve["attn_block"], f"DeiT-Base serving: launches {base_serve}")
    launches_path["ffn_block_d768"] = base_serve["ffn_block_wide"]
    launches_path["attn_block_d768"] = base_serve["attn_block"]
    del serve, mb, images, logits
    torch.cuda.empty_cache()
    tr0 = stage0(768, 12, "bfloat16")
    losses_b, got, want, ms = counted_steps(tr0, 2, 12)
    phase("deit_base_stage0_bf16", steps=2, batch=BATCH, losses=losses_b,
          fused_mlp_wide=got["fused_mlp_wide"], fused_mlp_bwd_wide=got["fused_mlp_bwd_wide"],
          step_ms=ms, **profiled_steps(tr0), **card_note)
    require(all(np.isfinite(losses_b)), f"DeiT-Base stage-0 losses: {losses_b}")
    require(got == want, f"DeiT-Base stage-0 launches {got} != {want}")
    launches_path.update({"fused_mlp_d768": got["fused_mlp"],
                          "fused_mlp_bwd_d768": got["fused_mlp_bwd"]})
    del tr0
    torch.cuda.empty_cache()
    lap("30_deit_base")

    for name, r in rows.items():
        r["launches"] = launches_path.get(name, 0)
        r["max_abs_err"] = max(errors.get(name, 0.0), errors.get(f"{name}_p0", 0.0),
                               errors.get(f"{name}_edge", 0.0), errors.get(f"{name}_vertex", 0.0))
    return {"rows": rows, "seconds": seconds}


def worker_phases(dev, work_dir: str, bundle_dir: str, atlas_path: str, card_note: dict,
                  helpers: dict) -> dict:
    """Phases 19-23: the loader on the card, ``schema_net_worker`` (counted,
    timed, profiled), its resume, its validation in fp32 against the plain
    versions, and ``backbone_worker`` with ``eval_worker`` on its checkpoint.
    ``helpers``: main's ``with_plain``, ``recording_vq``, ``replaying_vq`` and
    ``replay_report``. Returns each worker's launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from schemanet_torch.data import build_loaders, device_prefetch
    from schemanet_torch.data.augment import get_augmentation, resize_normalize_reference
    from schemanet_torch.data.loader import DataLoader
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts
    from schemanet_torch.pipeline import load_bundle
    from schemanet_torch.schema import build_predictor, get_loss_fn
    from schemanet_torch.train import (CBEvaluation, CheckpointManager, Evaluation, LaunchArgs,
                                       Trainer, backbone_worker, eval_worker, load_metadata,
                                       schema_net_worker)

    s4_cfg = {
        "dataset": WORKER_DATA,
        "training": dict(TRAIN_CFG, dtype="bfloat16", train_epochs=W_EPOCHS,
                         val_interval=W_VAL_INTERVAL, print_interval=W_PRINT, num_workers=8),
        "validation": {"batch_size": BATCH, "num_workers": 8},
        "schema_net": dict(SCHEMA_CFG, bundle=bundle_dir, initial_state_fp=atlas_path),
        "loss": dict(LOSS_CFG, weight_dict=LOSS_WEIGHTS),
    }
    jax_meta_keys = ["best_acc", "best_iter", "epoch", "eval", "iter", "last_tag"]

    # 19. the loader: the device-side resize and normalisation against their
    # plain version, and images/s over an epoch of the training set
    t_phase = time.perf_counter()
    train_loader, val_loader, n_cls = build_loaders(s4_cfg["dataset"], s4_cfg["training"],
                                                    s4_cfg["validation"], seed=0)
    host = next(iter(train_loader))
    got = train_loader.prepare(torch.from_numpy(host["image"]).to(dev))
    want = torch.from_numpy(resize_normalize_reference(host["image"], IMG, train_loader.mean,
                                                       train_loader.std))
    resize_err = rel_err(got.cpu(), want)
    val_valid = [float(b["valid"].sum()) for b in val_loader]
    cifar_aug = DataLoader(train_loader.dataset, BATCH, "train", seed=0, resize=IMG,
                           transform=get_augmentation("cifar_100", "train"), num_workers=8)

    def epoch_images_per_s(loader):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in device_prefetch(iter(loader), dev):
            loader.prepare(batch["image"])
        torch.cuda.synchronize()
        return len(loader) * BATCH / (time.perf_counter() - t0)

    loader_ips = [epoch_images_per_s(train_loader) for _ in range(2)]
    cifar_ips = [epoch_images_per_s(cifar_aug) for _ in range(2)]
    phase("loader", batch=BATCH, source_shape=list(host["image"].shape), out_shape=list(got.shape),
          bytes_shipped_per_batch=host["image"].nbytes, bytes_at_224_fp32=got.numel() * 4,
          resize_normalize_rel_err=resize_err, tol=1e-5, val_valid_per_batch=val_valid,
          images_per_s=loader_ips, images_per_s_cifar_crop_flip=cifar_ips,
          seconds=time.perf_counter() - t_phase, **card_note)
    require(resize_err <= 1e-5, f"device resize + normalise differ by {resize_err} of max")
    require(val_valid[-1] == BATCH // 2 and len(val_valid) == 3,
            f"validation batches' valid rows {val_valid}")
    require(n_cls == NUM_CLASSES, f"{n_cls} classes")

    # 20. schema_net_worker: 2 epochs with validation and checkpoints, counted,
    # timed by the host clock, its loop profiled on the device
    t_phase = time.perf_counter()
    stats = {"validate_s": [], "save_s": [], "losses": []}
    real_call, real_iter = Trainer.__call__, Trainer.train_iter
    real_validate, real_save = Trainer.validate, CheckpointManager.save

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stats[key].append(time.perf_counter() - t0)
            return out

        return run

    def profiled_call(self, *args, **kw):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_call(self, *args, **kw)
            torch.cuda.synchronize()
            stats["loop_s"] = time.perf_counter() - t0
        stats["busy_us"] = sum(device_time_by_name(prof).values())
        return out

    def recorded_iter(self, batch):
        out = real_iter(self, batch)
        stats["losses"].append(out["loss"])
        return out

    full_dir = os.path.join(work_dir, "s4_full")
    reset_launch_counts()
    with mock.patch.object(Trainer, "__call__", profiled_call), \
            mock.patch.object(Trainer, "train_iter", recorded_iter), \
            mock.patch.object(Trainer, "validate", timed(real_validate, "validate_s")), \
            mock.patch.object(CheckpointManager, "save", timed(real_save, "save_s")):
        run_a = schema_net_worker(s4_cfg, LaunchArgs(seed=0, log_dir=full_dir, device=str(dev)))
    s4_launches = launch_counts()
    steps = W_EPOCHS * len(train_loader)
    fwd = steps + 3 * len(val_loader)  # training forwards and 3 validations' batches
    expected = {name: 0 for name in s4_launches}  # no stage-0 kernel
    expected.update({"attn_block": FROZEN_LAYERS * fwd, "attn_block_hmean": fwd,
                     "attn_block_tc": FROZEN_LAYERS * fwd, "ffn_block": FROZEN_LAYERS * fwd,
                     "ffn_block_tc": FROZEN_LAYERS * fwd, "vq_assign": fwd, "vq_assign_tc": fwd,
                     "sym_conv": GNN_CONVS * fwd, "sym_conv_tc": GNN_CONVS * fwd,
                     "sym_conv_bwd": GNN_CONVS * steps, "sym_conv_bwd_tc": GNN_CONVS * steps,
                     "fused_layernorm": GNN_CONVS * fwd, "fused_layernorm_bwd": GNN_CONVS * steps,
                     "fused_layernorm_bwd_vec": GNN_CONVS * steps,
                     "embed_grad": 2 * steps, "embed_grad_vec": 2 * steps,
                     "embed_grad_planned": steps, "adamw_project_rows": 2 * steps,
                     "adamw_project_rows_vec": 2 * steps})
    losses = [float(loss) for loss in stats["losses"]]
    final = run_a["eval"]
    ckpt_dir = os.path.join(full_dir, "ckpt")
    meta = load_metadata(ckpt_dir) or {}
    ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"{meta.get('last_tag')}.pt"))
    overhead = sum(stats["validate_s"]) + sum(stats["save_s"])
    phase("schema_net_worker", epochs=W_EPOCHS, steps=steps, batch=BATCH, dtype="bfloat16",
          val_interval=W_VAL_INTERVAL, losses=losses, final_validation=final, meta=meta,
          launches=s4_launches, expected=expected, loop_s=stats["loop_s"],
          loop_images_per_s=steps * BATCH / stats["loop_s"],
          train_images_per_s=steps * BATCH / (stats["loop_s"] - overhead),
          device_busy_s=stats["busy_us"] / 1e6,
          idle_share=(1 - stats["busy_us"] / 1e6 / stats["loop_s"]) if stats["busy_us"] else None,
          validation_s=stats["validate_s"], checkpoint_save_s=stats["save_s"],
          checkpoint_bytes=ckpt_bytes, ckpt_files=sorted(os.listdir(ckpt_dir)),
          seconds=time.perf_counter() - t_phase, **card_note)
    require(len(losses) == steps and all(np.isfinite(losses)), f"losses {losses}")
    require(np.isfinite(final["loss"]) and all(0.0 <= v <= 1.0 for v in final["acc"].values())
            and sorted(final["acc"]) == [1, 5], f"final validation {final}")
    require(s4_launches == expected, f"schema_net_worker launches {s4_launches} != {expected}")
    require(sorted(meta) == jax_meta_keys and meta["iter"] == steps,
            f"meta.json {meta} lacks the JAX keys")
    require(os.path.isfile(os.path.join(ckpt_dir, "best.pt")), "no best checkpoint")
    require(len(stats["validate_s"]) == 3, f"{len(stats['validate_s'])} validations, not 3")
    shutil.rmtree(full_dir)  # ~1.3 GB a checkpoint: the atlas and its AdamW moments

    # 21. resume: a run stopped after epoch 1, resumed with resume="auto",
    # against the uninterrupted run, bit for bit
    t_phase = time.perf_counter()

    def stop_after_epoch_1(self, batch):
        out = real_iter(self, batch)
        if self.step == self.steps_per_epoch:
            self.request_stop()
        return out

    cut_dir = os.path.join(work_dir, "s4_cut")
    with mock.patch.object(Trainer, "train_iter", stop_after_epoch_1):
        cut = schema_net_worker(s4_cfg, LaunchArgs(seed=0, log_dir=cut_dir, device=str(dev)))
    cut_steps, cut_eval = cut["trainer"].step, cut["eval"]
    del cut
    resumed = schema_net_worker(s4_cfg, LaunchArgs(seed=0, log_dir=cut_dir, resume="auto",
                                                   device=str(dev)))
    want_state, got_state = run_a["trainer"].state_dict(), resumed["trainer"].state_dict()

    def leaves(state):
        out = {f"model/{k}": v for k, v in state["model"].items()}
        for pid, slot in state["optimizer"]["state"].items():
            out.update({f"adamw/{pid}/{k}": v for k, v in slot.items()})
        for name, hot in state["hot"].items():
            out.update({f"hot/{name}/m": hot["m"], f"hot/{name}/v": hot["v"]})
        out.update({f"rng/{k}": v for k, v in state["rng"].items()})
        return out

    want_leaves, got_leaves = leaves(want_state), leaves(got_state)
    differ = sorted(k for k in want_leaves
                    if k not in got_leaves or not torch.equal(got_leaves[k], want_leaves[k]))
    same_eval = resumed["eval"] == final
    phase("resume", stopped_at_step=cut_steps, stopped_eval=cut_eval,
          resumed_start_epoch=resumed["trainer"].start_epoch, leaves=len(want_leaves),
          differ=differ[:20], final_validation_equal=same_eval, steps=resumed["trainer"].step,
          seconds=time.perf_counter() - t_phase)
    require(cut_steps == len(train_loader) and cut_eval is None, "the run did not stop at epoch 1")
    require(not differ and len(got_leaves) == len(want_leaves),
            f"the resumed run's state differs in {differ[:20]}")
    require(same_eval, f"resumed validation {resumed['eval']} != {final}")
    del resumed, want_state, got_state, want_leaves, got_leaves
    shutil.rmtree(cut_dir)
    torch.cuda.empty_cache()

    # 22. validation in fp32 ('highest') against the plain versions, the
    # plain run fed the kernel run's VQ ids
    t_phase = time.perf_counter()
    bundle = load_bundle(bundle_dir)
    schema32 = dict(SCHEMA_CFG, ir_atlas=dict(SCHEMA_CFG["ir_atlas"], graph_precision="highest"))
    m32 = build_predictor(bundle.model_cfg, schema32, NUM_CLASSES, NUM_CODES, EMBED_DIM,
                          ENCODE_LAYER, dtype=torch.float32)
    m32.load_state_dict({k: v.cpu() for k, v in run_a["trainer"].model.state_dict().items()})
    m32.to(dev)
    del run_a
    torch.cuda.empty_cache()
    loss_fn = get_loss_fn(s4_cfg["loss"])
    labels = np.concatenate([b["label"] for b in val_loader])
    valid = np.concatenate([b["valid"] for b in val_loader]) > 0

    def evaluate(store):
        def forward(img):
            out = m32(img)
            store["pred"].append(out["pred"].float())
            return out

        def classify(img, quantize):
            logits = m32.classify_discretized(img, quantize)
            store["q" if quantize else "o"].append(logits.float())
            return logits

        ev = Evaluation(forward, loss_fn, LOSS_WEIGHTS, val_loader, top_k=(1, 5), device=dev)()
        cb = CBEvaluation(classify, val_loader, device=dev)()
        return ev, cb, {k: torch.cat(v).cpu().numpy() for k, v in store.items()}

    recorded, vq_stats = [], {"rows": 0, "mismatches": 0, "near_ties_only": True}
    with helpers["recording_vq"](recorded):
        ev_k, cb_k, logits_k = evaluate({"pred": [], "q": [], "o": []})

    def plain_eval():
        with helpers["replaying_vq"](recorded, vq_stats):
            return evaluate({"pred": [], "q": [], "o": []})

    ev_p, cb_p, logits_p = helpers["with_plain"](plain_eval)

    def gaps(logits, k):
        """The gap between the k-th and (k+1)-th largest logit of each row
        (infinite where every class is in the top k)."""
        if k >= logits.shape[1]:
            return np.full(len(logits), np.inf)
        top = -np.sort(-logits, axis=1)
        return top[:, k - 1] - top[:, k]

    flips, near = {}, {}
    for key, k in (("pred", 1), ("pred", 5), ("q", 1), ("o", 1)):
        scale = np.abs(logits_p[key][valid]).max()
        tie = gaps(logits_p[key], k) <= 1e-3 * scale
        near[f"{key}@{k}"] = [int(i) for i in np.flatnonzero(tie & valid)]
        if key == "pred":
            topk_k = np.argsort(-logits_k[key], axis=1)[:, :k]
            topk_p = np.argsort(-logits_p[key], axis=1)[:, :k]
            diff = (topk_k == labels[:, None]).any(1) != (topk_p == labels[:, None]).any(1)
        else:
            diff = logits_k[key].argmax(1) != logits_p[key].argmax(1)
        flips[f"{key}@{k}"] = [(int(i), bool(tie[i])) for i in np.flatnonzero(diff & valid)]
    n_val = int(valid.sum())
    counts = {side: {k: round(v * n_val) for k, v in ev["acc"].items()}
              for side, ev in (("kernel", ev_k), ("plain", ev_p))}
    cb_counts = {side: {k: round(v * n_val) for k, v in cb.items()}
                 for side, cb in (("kernel", cb_k), ("plain", cb_p))}
    loss_rel = abs(ev_k["loss"] - ev_p["loss"]) / abs(ev_p["loss"])
    phase("validation_fp32_vs_plain", images=n_val, acc_counts=counts, cb_counts=cb_counts,
          loss=ev_k["loss"], plain_loss=ev_p["loss"], loss_rel_err=loss_rel,
          logit_max_abs_err={k: float(np.abs(logits_k[k] - logits_p[k])[valid].max())
                             for k in logits_k},
          logit_scale={k: float(np.abs(logits_p[k])[valid].max()) for k in logits_p},
          near_tie_samples=near, flipped_samples_and_near_tie=flips,
          tol={"loss": 1e-4, "near_tie": "top two logits within 1e-3 x max |logit|"},
          **helpers["replay_report"](vq_stats), seconds=time.perf_counter() - t_phase)
    require(vq_stats["rows"] > 0, "the plain validation took no recorded VQ ids")
    require(loss_rel <= 1e-4, f"fp32 validation loss differs by {loss_rel} relative")
    # the counts and rates differ by the flipped samples alone, so this holds them too
    require(all(tie for fl in flips.values() for _, tie in fl),
            f"a sample's prediction differs beyond a near-tie: {flips}")
    del m32, bundle
    torch.cuda.empty_cache()

    # 23. backbone_worker: one epoch of 5 steps at dropout 0.1, then
    # eval_worker on its last checkpoint
    t_phase = time.perf_counter()
    s0_cfg = {
        "dataset": dict(WORKER_DATA, train={"num_samples": S0W_STEPS * BATCH}),
        "training": dict(STAGE0_CFG["training"], train_epochs=1, num_workers=8),
        # eval_worker builds the model in the validation dtype: the training one
        "validation": {"batch_size": BATCH, "num_workers": 8,
                       "dtype": STAGE0_CFG["training"]["dtype"]},
        "model": STAGE0_CFG["model"],
        "loss": STAGE0_CFG["loss"],
    }
    s0_dir = os.path.join(work_dir, "s0")
    reset_launch_counts()
    run_b = backbone_worker(s0_cfg, LaunchArgs(seed=0, log_dir=s0_dir, device=str(dev)))
    s0w_launches = launch_counts()
    fwd = 2 * len(val_loader)  # the initial and the final validation
    layer = S0_LAYERS
    expected = {name: 0 for name in s0w_launches}  # no SchemaNet kernel
    expected.update({**{name: layer * S0W_STEPS for name in (
        "fused_mhsa", "fused_mhsa_tc", "fused_mhsa_bwd", "fused_mhsa_bwd_tc", "fused_mlp",
        "fused_mlp_tc", "fused_mlp_bwd", "fused_mlp_bwd_tc")},
        "fused_layernorm": (2 * layer + 1) * S0W_STEPS + fwd,
        "fused_layernorm_bwd": (2 * layer + 1) * S0W_STEPS,
        "fused_layernorm_bwd_vec": (2 * layer + 1) * S0W_STEPS,
        **{name: layer * fwd for name in ("attn_block", "attn_block_tc", "ffn_block",
                                          "ffn_block_tc")}})
    b_meta = load_metadata(os.path.join(s0_dir, "ckpt")) or {}
    last = os.path.join(s0_dir, "ckpt", f"{b_meta.get('last_tag')}.pt")
    reset_launch_counts()
    evaluated = eval_worker(s0_cfg, LaunchArgs(seed=0, resume=last, device=str(dev)))
    eval_launches = {k: v for k, v in launch_counts().items() if v}
    b_final = run_b["eval"]
    b_counts = {side: {k: round(v * n_val) for k, v in r["acc"].items()}
                for side, r in (("worker", b_final), ("eval_worker", evaluated))}
    b_rel = abs(evaluated["loss"] - b_final["loss"]) / abs(b_final["loss"])
    phase("backbone_worker", steps=run_b["trainer"].step, dropout=S0_DROPOUT, dtype="bfloat16",
          final_validation=b_final, eval_worker=evaluated, acc_counts=b_counts,
          loss_rel_err=b_rel, tol=1e-6, meta=b_meta, launches=s0w_launches, expected=expected,
          eval_worker_launches=eval_launches, seconds=time.perf_counter() - t_phase, **card_note)
    require(run_b["trainer"].step == S0W_STEPS, f"{run_b['trainer'].step} stage-0 steps")
    require(s0w_launches == expected, f"backbone_worker launches {s0w_launches} != {expected}")
    require(sorted(b_meta) == jax_meta_keys, f"meta.json {b_meta} lacks the JAX keys")
    require(b_counts["worker"] == b_counts["eval_worker"] and b_rel <= 1e-6,
            f"eval_worker {evaluated} != the worker's final validation {b_final}")
    del run_b
    torch.cuda.empty_cache()
    return {"schema_net_worker": s4_launches, "backbone_worker": s0w_launches}


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures the GPU and nothing else")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from schemanet_torch.ops.kernels import _build
    except ImportError as exc:
        sys.exit(f"chip_smoke: run from the repository root ({exc})")
    from schemanet_torch.ops.kernels import atlas_opt as ao
    from schemanet_torch.ops.kernels import attention as ak
    from schemanet_torch.ops.kernels import embed_bwd as ek
    from schemanet_torch.ops.kernels import encoder_block as eb
    from schemanet_torch.ops.kernels import graphconv as gc
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts
    from schemanet_torch.ops.kernels import layernorm as lnk
    from schemanet_torch.ops.kernels import mlp as mk
    from schemanet_torch.ops.kernels import vq as vqk
    from schemanet_torch.models.vit import get_model
    from schemanet_torch.ops import kmeans
    from schemanet_torch.ops.graph import compact_instance_slots
    from schemanet_torch.pipeline import (collect_mid_features, extract_stage, init_stage,
                                          load_atlas_init, load_bundle, save_atlas_init,
                                          save_bundle)
    from schemanet_torch.schema import build_predictor, get_loss_fn, init_parameters_
    from schemanet_torch.schema.atlas import clamp_attribute_weights_
    from schemanet_torch.serve import ServePredictor
    from schemanet_torch.train import (SCHEMA_NET_FROZEN, Trainer, TrainerConfig, backbone_trainer,
                                       schema_net_trainer)

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
    card_note = {"card": card}
    print(smi, flush=True)
    phase("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          compile_seconds=_build.build_seconds, library=str(_build.library_path().name))
    # registers and spills of the tensor-core kernels, from ptxas: 16
    # attention kernels (4 head_dims x forward, dq, dk/dv, head-mean
    # forward), 8 GraphConv kernels (4 row widths of E x forward, dE), 9 FFN
    # kernels (4 widths of the forward, 4 of dH and dx, one of the weight
    # gradients), 2 of attn_block's products (LN + qkv, out projection +
    # residual) in bf16 and 2 in split TF32, its split-TF32 attention (3
    # head_dim paddings) and LN statistics, ffn_block's 5 bf16 and 5
    # split-TF32 widths, VQ's 2
    # (split TF32, bf16); the LayerNorm backward's 12 (2 dtypes x 4 widths of
    # 16-byte pieces, 2 x 2 of scalar pieces) and its parameter sum;
    # embed_grad's 6 (the chunks' 2 dtypes x 2 piece widths, the combine, the
    # offsets)
    build_log = _build.library_path().with_suffix(".log").read_text()
    # Phase 24's widths add: mlp.cu's wide route, in bf16 the Hopper
    # kernels (TMA-fed wgmma): 7 gemm_wg_kernel (fc1 at 192 x 128; fc2 at
    # 128 x 96, 128 x 192 and 192 x 192; dx at 128 x 128, 128 x 192 and
    # 192 x 192) and mlp_wgrad_wg_kernel (8 "_wg_kernel"), gemm_dual_kernel
    # (h and dA); in fp32 5 gemm_fma_kernel and col_sum_kernel;
    # encoder_block.cu's wide ffn_block: in bf16 the LN pass
    # (ln_rows_bf16_kernel) and 4 gemm_wg_kernel (fc1 + gelu at 192 x 128,
    # fc2 + residual at the 3 light tiles), in fp32 linear_tf32's gelu
    # epilogue (3 linear_tf32 in all); attn_block's 2 linear_tc;
    # layernorm.cu's backward at 1024 (18 in all: 16-byte pieces 4 and 8 a
    # lane, scalar 32, in both dtypes). mlp.cu's 9 "tc_kernel" are the
    # one-launch route's (4 widths of the forward, 4 of dH and dx, the
    # weight gradients). atlas_opt.cu: adamw_rows_warp_kernel for rows up to
    # 1024 wide (4 moment-type pairs x 4-column pieces at 4 and 8 a lane,
    # 1-column pieces at 16 and 32) and adamw_rows_block_kernel past them
    # (4 pairs).
    for source, tag, count in (("attention.cu", "mhsa_tc", 16), ("graphconv.cu", "tc_kernel", 8),
                               ("mlp.cu", "tc_kernel", 9), ("mlp.cu", "_wg_kernel", 8),
                               ("mlp.cu", "gemm_dual", 1), ("mlp.cu", "gemm_fma", 5),
                               ("mlp.cu", "col_sum", 1), ("encoder_block.cu", "linear_tc", 2),
                               ("encoder_block.cu", "linear_tf32", 3),
                               ("encoder_block.cu", "gemm_wg", 4),
                               ("encoder_block.cu", "ln_rows_bf16", 1),
                               ("encoder_block.cu", "attn_tf32", 3),
                               ("encoder_block.cu", "ln_stats", 1),
                               ("encoder_block.cu", "ffn_tc_kernel", 5),
                               ("encoder_block.cu", "ffn_tf32_kernel", 5), ("vq.cu", "vq_tc", 2),
                               ("layernorm.cu", "ln_bwd_kernel", 18),
                               ("layernorm.cu", "ln_param_sum", 1), ("embed_bwd.cu", "embed_", 6),
                               ("atlas_opt.cu", "adamw_rows_warp", 16),
                               ("atlas_opt.cu", "adamw_rows_block", 4)):
        tc_ptxas = {name: dict(zip(("registers", "spill_stores", "spill_loads"), r))
                    for name, r in ptxas_report(build_log, source).items() if tag in name}
        phase("ptxas", source=source, tag=tag, kernels=tc_ptxas)
        require(len(tc_ptxas) == count,
                f"ptxas reported {len(tc_ptxas)} {tag} kernels in {source}, not {count}")
        require(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in tc_ptxas.values()),
                f"a kernel of {source} ({tag}) spills to local memory")

    # 3. each serving kernel against its plain version at the serving shapes
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

    def fp32_label(name):
        """fp32 attn_block and ffn_block are kernels of their own (split
        TF32): their errors and times apart."""
        return name.replace("_block", "_block_fp32", 1) if "_block" in name else name

    def fp32_attn_route(label, args, kw):
        """An fp32 attn_block call is counted on the split-TF32 route and
        gives the same bits twice."""
        before = (eb.attn_block.launches, eb.attn_block.tc_launches)
        first, again = eb.attn_block(*args, **kw), eb.attn_block(*args, **kw)
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        again = again if isinstance(again, tuple) else (again,)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        phase("compare", kernel=label, dtype="float32", route=eb.attn_block_route(
            torch.float32, args[0].shape[1], args[-1], args[3].shape[0] // (3 * args[-1])),
            run_to_run_bitwise=same)
        require((eb.attn_block.launches, eb.attn_block.tc_launches) ==
                (before[0] + 2, before[1] + 2), f"{label}: not counted on the split-TF32 route")
        require(same, f"{label}: two calls differ")

    for name, case in cases.items():
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            label = fp32_label(name) if dt == torch.float32 else name
            compare(label, *case(dt), dt, tol, errors)
            if dt == torch.float32 and name.startswith("attn_block"):
                fp32_attn_route(label, *case(dt)[2:])
    # the GraphConv kernels at rows of E aligned to 4 bytes (V = 70) and 8
    # bytes (V = 500, the ImageNet class graphs' width, cut to 16 graphs)
    conv_edges = {tag: (torch.rand(k_, v_, v_, generator=g).to(dev) / v_, rnd(k_, v_, d_),
                        rnd(k_, v_, d_)) for tag, (k_, v_, d_) in CONV_EDGES.items()}
    for tag, (e_, f_, _) in conv_edges.items():
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            compare(f"sym_conv_{tag}", gc.sym_conv, gc.sym_conv_reference, (e_.to(dt), f_.to(dt)),
                    {}, dt, tol, errors)

    # attn_block at its edges: one query row past a tile of 64 (the
    # tensor-core attention's), and DeiT-Small's width with 6 heads
    for tag, (bs_, n_, d_, h_) in ATTN_EDGES.items():
        args_e = (rnd(bs_, n_, d_), 1 + rnd(d_, scale=0.1), rnd(d_, scale=0.1),
                  rnd(3 * d_, d_, scale=d_**-0.5), rnd(3 * d_, scale=0.1),
                  rnd(d_, d_, scale=d_**-0.5), rnd(d_, scale=0.1), h_)
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            for kw, name in (({}, "attn_block"), ({"capture_hmean": True}, "attn_block_hmean")):
                label = f"{fp32_label(name) if dt == torch.float32 else name}_{tag}"
                args_dt = (args_e[0].to(dt), *args_e[1:])
                compare(label, eb.attn_block, eb.attn_block_reference, args_dt, kw, dt, tol, errors)
                if dt == torch.float32:
                    fp32_attn_route(label, args_dt, kw)
    del args_e
    # ffn_block at its edges, each dtype on its tensor-core route, counted
    for tag, (rows_, d_, f_) in FFN_EDGES.items():
        args_e = (rnd(1, rows_, d_), 1 + rnd(d_, scale=0.1), rnd(d_, scale=0.1),
                  rnd(f_, d_, scale=d_**-0.5), rnd(f_, scale=0.1), rnd(d_, f_, scale=f_**-0.5),
                  rnd(d_, scale=0.1))
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            before = (eb.ffn_block.launches, eb.ffn_block.tc_launches)
            label = f"ffn_block_{tag}" if dt == torch.bfloat16 else f"ffn_block_fp32_{tag}"
            compare(label, eb.ffn_block, eb.ffn_block_reference, (args_e[0].to(dt), *args_e[1:]),
                    {}, dt, tol, errors)
            require((eb.ffn_block.launches, eb.ffn_block.tc_launches) ==
                    (before[0] + 1, before[1] + 1),
                    f"ffn_block {tag} {dt}: not counted on its route")
    del args_e

    # the model, seeded random weights (made on the host, then moved)
    def model(dtype, precision):
        schema = dict(SCHEMA_CFG, ir_atlas=dict(SCHEMA_CFG["ir_atlas"], graph_precision=precision))
        return build_predictor(MODEL_CFG, schema, NUM_CLASSES, NUM_CODES, EMBED_DIM,
                               ENCODE_LAYER, dtype=dtype)

    t0 = time.perf_counter()
    m32 = model(torch.float32, "highest")
    init_parameters_(m32, torch.Generator().manual_seed(0))
    host_state = {k: v.clone() for k, v in m32.state_dict().items()}
    m16 = model(torch.bfloat16, "default")
    m16.load_state_dict(host_state)
    phase("init", seconds=round(time.perf_counter() - t0, 3),
          parameters=sum(p.numel() for p in m32.parameters()))
    images = np.random.default_rng(0).normal(size=(N_IMAGES, IMG, IMG, 3)).astype(np.float32)
    x_dev = torch.from_numpy(images).to(dev)

    plain_versions = [
        mock.patch.object(eb, "attn_block", eb.attn_block_reference),
        mock.patch.object(eb, "ffn_block", eb.ffn_block_reference),
        mock.patch.object(gc, "sym_conv", gc.sym_conv_reference),  # autograd of plain torch
        mock.patch.object(ek, "embed_grad", ek.embed_grad_reference),
        mock.patch.object(ao, "adamw_project_rows", ao.adamw_project_rows_reference),
        mock.patch.object(ak, "fused_mhsa", ak.fused_mhsa_reference),  # autograd of plain torch
        mock.patch.object(mk, "fused_mlp", mk.fused_mlp_reference),
        mock.patch.object(vqk, "vq_assign_kernel", vqk.vq_assign_reference),
        mock.patch.object(lnk, "fused_layernorm", lnk.fused_layernorm_plain),
    ]

    def with_plain(fn):
        for p in plain_versions:
            p.start()
        try:
            return fn()
        finally:
            for p in plain_versions:
                p.stop()

    def plain_layernorm(fn):
        """fn with the plain LayerNorm in place of the kernels, the rest as is."""
        with mock.patch.object(lnk, "fused_layernorm", lnk.fused_layernorm_plain):
            return fn()

    def median(xs):
        return float(np.percentile(xs, 50))

    # A run on the kernels against one on the plain versions: where two codes'
    # scores nearly tie, the VQ kernel and its plain version may pick either,
    # and one other code changes a graph and its gradients. So the plain run
    # takes the kernel run's ids in the same order, and the plain VQ's own
    # ids on the plain run's features are held to them apart from near-ties.
    def recording_vq(store):
        kernel_vq = vqk.vq_assign_kernel

        def record(x, cb):
            ids = kernel_vq(x, cb)
            store.append(ids)
            return ids

        return mock.patch.object(vqk, "vq_assign_kernel", record)

    def replaying_vq(store, stats):
        replay = iter(store)

        def replayed(x, cb):
            ids = next(replay)
            gaps, scale = vqk.score_gaps(x, cb, ids, vqk.vq_assign_reference(x, cb))
            stats["rows"] += ids.numel()
            stats["mismatches"] += len(gaps)
            stats["near_ties_only"] &= bool((gaps <= 1e-5 * scale).all())
            return ids

        return mock.patch.object(vqk, "vq_assign_kernel", replayed)

    def replay_report(stats):
        agree = 1 - stats["mismatches"] / max(stats["rows"], 1)
        require(agree >= 0.999 and stats["near_ties_only"],
                f"plain VQ ids disagree with the kernel's beyond near-ties: {stats}")
        return {"plain_vq_id_agreement": agree, "plain_vq_mismatches": stats["mismatches"],
                "plain_vq_near_ties_only": stats["near_ties_only"]}

    # 4. the slice in fp32 against the plain versions
    s32 = ServePredictor(m32, microbatch=MICROBATCH, device=dev)
    with torch.no_grad():
        reset_launch_counts()
        logits_k = s32.predict_tensor(x_dev)
        fp32_launches = launch_counts()
        ids_k = s32.predictor.ingredient_backbone(x_dev[:MICROBATCH])["ingredients"]
        logits_p = with_plain(lambda: s32.predict_tensor(x_dev))
        ids_p = with_plain(lambda: s32.predictor.ingredient_backbone(x_dev[:MICROBATCH]))[
            "ingredients"]
    torch.cuda.synchronize()
    agree = (ids_k == ids_p).float().mean().item()
    scale = logits_p.abs().max().item()
    logit_err = (logits_k - logits_p).abs().max().item()
    mbs = -(-N_IMAGES // MICROBATCH)
    want_attn = {"attn_block": FROZEN_LAYERS * mbs, "attn_block_tc": FROZEN_LAYERS * mbs,
                 "attn_block_hmean": mbs}
    phase("slice_fp32", images=N_IMAGES, vq_id_agreement=agree, logit_max_abs_err=logit_err,
          logit_scale=scale, tol=1e-3 * scale, launches=fp32_launches, expected_attn=want_attn)
    require({k: fp32_launches[k] for k in want_attn} == want_attn,
            f"fp32 serving attn_block launches {fp32_launches} != {want_attn}: an fp32 launch "
            "missed the split-TF32 route")
    require(tuple(logits_k.shape) == (N_IMAGES, NUM_CLASSES), f"fp32 logits {tuple(logits_k.shape)}")
    require(agree >= 0.999, f"fp32 VQ ids agree on {agree:.5f} < 0.999 of tokens")
    require(logit_err <= 1e-3 * scale, f"fp32 logits differ by {logit_err} > 1e-3 * {scale}")
    del s32, m32
    torch.cuda.empty_cache()

    # 5. the slice in bf16: the serving path, counted
    s16 = ServePredictor(m16, microbatch=MICROBATCH, device=dev)
    reset_launch_counts()
    logits = s16.predict(images)  # the user's entry point: numpy in, numpy out
    serve_launches = launch_counts()
    mbs = -(-len(images) // MICROBATCH)
    expected = {name: 0 for name in serve_launches}  # no training kernel
    expected.update({"attn_block": FROZEN_LAYERS * mbs, "attn_block_hmean": mbs,
                     "attn_block_tc": FROZEN_LAYERS * mbs,
                     "ffn_block": FROZEN_LAYERS * mbs, "ffn_block_tc": FROZEN_LAYERS * mbs,
                     "vq_assign": mbs, "vq_assign_tc": mbs,
                     "sym_conv": GNN_CONVS * mbs, "sym_conv_tc": GNN_CONVS * mbs,
                     "fused_layernorm": GNN_CONVS * mbs})
    phase("slice_bf16_launches", microbatches=mbs, launches=serve_launches, expected=expected)
    require(serve_launches == expected, f"launch counts {serve_launches} != {expected}")
    require(serve_launches["vq_assign_tc"] == serve_launches["vq_assign"] > 0,
            "a vq_assign launch of serving missed the tensor-core kernel")
    require(serve_launches["sym_conv_tc"] == serve_launches["sym_conv"] > 0,
            "a bf16 GraphConv launch of serving missed the tensor-core kernel")
    require(serve_launches["attn_block_tc"] == serve_launches["attn_block"] > 0,
            "a bf16 attn_block launch of serving missed the tensor-core kernels")
    require(serve_launches["ffn_block_tc"] == serve_launches["ffn_block"] > 0,
            "a bf16 ffn_block launch of serving missed the tensor-core kernel")
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
    times = {}
    for name, case in cases.items():
        kernel, plain, args, kw = case(torch.bfloat16)
        times[name] = (time_ms(lambda: kernel(*args, **kw), TIME_ITERS),
                       time_ms(lambda: plain(*args, **kw), TIME_ITERS))
        phase("kernel_time", kernel=name, dtype="bfloat16", shape=list(args[0].shape),
              ms=times[name][0], plain_ms=times[name][1], **card_note)
    kernel, plain, args, kw = cases["ffn_block"](torch.float32)  # the split-TF32 kernel
    times["ffn_block_fp32"] = (time_ms(lambda: kernel(*args, **kw), TIME_ITERS),
                               time_ms(lambda: plain(*args, **kw), TIME_ITERS))
    phase("kernel_time", kernel="ffn_block", dtype="float32", shape=list(args[0].shape),
          ms=times["ffn_block_fp32"][0], plain_ms=times["ffn_block_fp32"][1], **card_note)
    # fp32 attn_block (the split-TF32 kernels): serving's microbatch, and the
    # head-mean at stage 3's batch of 32
    attn32 = {"attn_block_fp32": (attn_args(x_seq), {}),
              "attn_block_fp32_hmean": (attn_args(x_seq[:S3_BATCH].contiguous()),
                                        {"capture_hmean": True})}
    for name, (args, kw) in attn32.items():
        times[name] = (time_ms(lambda: eb.attn_block(*args, **kw), TIME_ITERS),
                       time_ms(lambda: eb.attn_block_reference(*args, **kw), TIME_ITERS))
        phase("kernel_time", kernel=name, dtype="float32", shape=list(args[0].shape),
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
    del s16, m16, x_dev
    torch.cuda.empty_cache()

    # 7. each training kernel against its plain version at the training shapes
    g_class = rnd(NUM_CLASSES, NUM_CODES, GNN_DIM)
    e_tr = torch.rand(BATCH, v_inst, v_inst, generator=g).to(dev) / v_inst
    f_tr, g_tr = rnd(BATCH, v_inst, GNN_DIM), rnd(BATCH, v_inst, GNN_DIM)
    ids_class = torch.arange(NUM_CODES, dtype=torch.int32).expand(NUM_CLASSES, NUM_CODES)
    ids_class = ids_class.contiguous().to(dev)  # the class_ingredients buffer
    ids_uniform = torch.randint(0, NUM_CODES + 1, (BATCH, v_inst), generator=g,
                                dtype=torch.int32).to(dev)
    # the instance lookup's ids as the stage-4 step makes them: the slots of
    # phase 4's VQ ids of 64 images, each sample's unused slots padded with
    # the id NUM_CODES (one long segment after the sort)
    ids_inst = compact_instance_slots(ids_k, NUM_CODES).codes
    rows_edge = NUM_CLASSES * NUM_CODES
    atlas_state = {
        "edge": [torch.rand(rows_edge, NUM_CODES, generator=g).to(dev) / NUM_CODES,
                 rnd(rows_edge, NUM_CODES, scale=1e-3), rnd(rows_edge, NUM_CODES, scale=1e-4),
                 torch.rand(rows_edge, NUM_CODES, generator=g).to(dev) * 1e-8],
        "vertex": [torch.rand(NUM_CLASSES, NUM_CODES, generator=g).to(dev) / NUM_CODES,
                   rnd(NUM_CLASSES, NUM_CODES, scale=1e-3), rnd(NUM_CLASSES, NUM_CODES, scale=1e-4),
                   torch.rand(NUM_CLASSES, NUM_CODES, generator=g).to(dev) * 1e-8],
    }
    adamw_kw = dict(lr=1e-3, weight_decay=5e-4)

    def fresh_update(fn, which):
        """fn on fresh copies of the atlas state (the update is in place)."""
        _, grad, m0, v0 = atlas_state[which]
        return lambda p0: fn(p0.clone(), grad, m0.clone(), v0.clone(), 2, **adamw_kw)

    train_cases = {
        "sym_conv_bwd": lambda dt: (gc.sym_conv_bwd, gc.sym_conv_bwd_reference,
                                    (e_class.to(dt), f_class.to(dt), g_class.to(dt)), {}),
        "sym_conv_bwd_instance": lambda dt: (gc.sym_conv_bwd, gc.sym_conv_bwd_reference,
                                             (e_tr.to(dt), f_tr.to(dt), g_tr.to(dt)), {}),
        "embed_grad": lambda dt: (ek.embed_grad, ek.embed_grad_reference,
                                  (ids_class, f_class.to(dt), NUM_CODES + 1), {}),
        "embed_grad_instance": lambda dt: (ek.embed_grad, ek.embed_grad_reference,
                                           (ids_inst, g_tr.to(dt), NUM_CODES + 1), {}),
    }
    for name, case in train_cases.items():
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            compare(name, *case(dt), dt, tol, errors)
    for tag, (e_, f_, g_) in conv_edges.items():
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            compare(f"sym_conv_bwd_{tag}", gc.sym_conv_bwd, gc.sym_conv_bwd_reference,
                    (e_.to(dt), f_.to(dt), g_.to(dt)), {}, dt, tol, errors)
    # bf16 dE: the upper triangle of tiles, mirrored, so exactly symmetric;
    # both versions of embed_grad add in a fixed order, so the same bits twice
    bwd_bf16 = {name: train_cases[name](torch.bfloat16)[2]
                for name in ("sym_conv_bwd", "sym_conv_bwd_instance")}
    bwd_bf16.update({f"sym_conv_bwd_{tag}": tuple(t.to(torch.bfloat16) for t in args)
                     for tag, args in conv_edges.items()})
    symmetric, embed_same = {}, {}
    for name, args in bwd_bf16.items():
        de_ = gc.sym_conv_bwd(*args)[0]
        symmetric[name] = bool(torch.equal(de_, de_.transpose(1, 2)))
        del de_
    # embed_grad at its edges (EMBED_EDGES): (ids, cotangent width, rows)
    embed_edges = {
        "uniform": (ids_uniform, GNN_DIM, NUM_CODES + 1),
        "long_id": (torch.cat([torch.zeros(4500, dtype=torch.int32),
                               torch.randint(1, 9, (500,), generator=g, dtype=torch.int32)]),
                    GNN_DIM, 9),
        "spanning": (torch.randint(0, 3, (700,), generator=g, dtype=torch.int32), 40, 3),
        "unused": (torch.randint(0, 5, (300,), generator=g, dtype=torch.int32) * 3, 24, 16),
        "one_row": (torch.zeros(77, dtype=torch.int32), 6, 1),
    }
    embed_edges = {tag: (ids_.to(dev), rnd(*ids_.shape, w_), rows_)
                   for tag, (ids_, w_, rows_) in embed_edges.items()}
    unused_zero = {}
    for tag, (ids_, cot_, rows_) in embed_edges.items():
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            compare(f"embed_grad_{tag}", ek.embed_grad, ek.embed_grad_reference,
                    (ids_, cot_.to(dt), rows_), {}, dt, tol, errors)
        taken = torch.zeros(rows_, dtype=torch.bool, device=dev)
        taken[ids_.long()] = True
        unused_zero[tag] = not ek.embed_grad(ids_, cot_, rows_)[~taken].any().item()
    for name in ("embed_grad", "embed_grad_instance"):
        for dt in (torch.bfloat16, torch.float32):
            _, _, args, _ = train_cases[name](dt)
            embed_same[f"{name}_{str(dt).split('.')[-1]}"] = [
                bool(torch.equal(fn(*args), fn(*args)))
                for fn in (ek.embed_grad, ek.embed_grad_reference)]
    for tag, (ids_, cot_, rows_) in embed_edges.items():
        for dt in (torch.bfloat16, torch.float32):
            args = (ids_, cot_.to(dt), rows_)
            embed_same[f"embed_grad_{tag}_{str(dt).split('.')[-1]}"] = [
                bool(torch.equal(fn(*args), fn(*args)))
                for fn in (ek.embed_grad, ek.embed_grad_reference)]
    # the class lookup with the plan of its fixed buffer: no host wait (the
    # sync debug mode raises on one), the unplanned call's bits; after an
    # in-place write to the buffer the plan is rebuilt
    buf = ids_class.clone()
    plans = ek.PlannedIds()
    cot16 = f_class.to(torch.bfloat16)
    unplanned = ek.embed_grad(buf, cot16, NUM_CODES + 1)
    plan0 = plans.plan(buf, NUM_CODES + 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        planned = ek.embed_grad(buf, cot16, NUM_CODES + 1, plan=plans.plan(buf, NUM_CODES + 1))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    planned_same = bool(torch.equal(planned, unplanned))
    buf[:7] = NUM_CODES  # in place: seven classes' graphs now all padding
    rebuilt = plans.plan(buf, NUM_CODES + 1) is not plan0
    after = ek.embed_grad(buf, cot16, NUM_CODES + 1, plan=plans.plan(buf, NUM_CODES + 1))
    after_err = rel_err(after, ek.embed_grad_reference(buf, cot16, NUM_CODES + 1))
    embed_same["embed_grad_planned_after_write_bfloat16"] = [
        bool(torch.equal(after, ek.embed_grad(buf, cot16, NUM_CODES + 1,
                                              plan=plans.plan(buf, NUM_CODES + 1))))]
    padding = (ids_inst == NUM_CODES).sum(1)
    phase("compare", kernel="sym_conv_bwd", dtype="bfloat16", de_exactly_symmetric=symmetric,
          embed_grad_run_to_run_bitwise_kernel_plain=embed_same,
          embed_grad_unused_ids_zero=unused_zero, embed_grad_planned_without_host_wait=True,
          embed_grad_planned_equals_unplanned=planned_same,
          embed_grad_plan_rebuilt_after_write=rebuilt, embed_grad_after_write_rel_err=after_err,
          instance_ids_padding_rows=int(padding.sum()),
          instance_ids_padding_per_sample=[int(padding.min()), int(padding.max())])
    require(all(symmetric.values()), f"bf16 dE not exactly symmetric: {symmetric}")
    require(all(all(v) for v in embed_same.values()),
            f"embed_grad differs between two calls: {embed_same}")
    require(all(unused_zero.values()), f"embed_grad: an unused id is not 0: {unused_zero}")
    require(planned_same and rebuilt and after_err <= BF16_TOL,
            f"embed_grad plan: equal {planned_same}, rebuilt {rebuilt}, error {after_err}")
    del embed_edges, buf, plans, plan0, planned, unplanned, after
    del conv_edges, bwd_bf16
    for name, which in (("adamw_project_rows", "edge"), ("adamw_project_rows_vertex", "vertex")):
        compare(name, fresh_update(ao.adamw_project_rows, which),
                fresh_update(ao.adamw_project_rows_reference, which), (atlas_state[which][0],), {},
                torch.float32, FP32_TOL, errors)
    # the adamw rows' self-loop variant: rows of one [K*V, V] view, diagonal zeroed
    edge3 = [t.view(NUM_CLASSES, NUM_CODES, NUM_CODES) for t in atlas_state["edge"]]
    got = ao.adamw_project_rows(edge3[0].clone(), edge3[1], edge3[2].clone(), edge3[3].clone(), 2,
                                remove_self_loop=True, **adamw_kw)
    want = ao.adamw_project_rows_reference(edge3[0].clone(), edge3[1], edge3[2].clone(),
                                           edge3[3].clone(), 2, remove_self_loop=True, **adamw_kw)
    torch.cuda.synchronize()
    loop_err = max(rel_err(a, b) for a, b in zip(got, want))
    phase("compare", kernel="adamw_project_rows_self_loop", dtype="float32",
          shape=list(edge3[0].shape), rel_err=loop_err, tol=FP32_TOL)
    require(loop_err <= FP32_TOL, f"adamw_project_rows self loop: rel err {loop_err}")
    del got, want, edge3

    # 8. the training step in fp32 against the same trainer on the plain versions
    trainer_cfg = TrainerConfig.from_cfg(TRAIN_CFG, frozen_patterns=SCHEMA_NET_FROZEN)
    loss_fn = get_loss_fn(LOSS_CFG)
    rng = np.random.default_rng(1)
    batches = [
        {"image": torch.from_numpy(
            rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)).to(dev),
         "label": torch.from_numpy(rng.integers(0, NUM_CLASSES, size=BATCH)).to(dev)}
        for _ in range(BF16_STEPS)
    ]

    def trainer(dtype, precision):
        mdl = model(dtype, precision)
        mdl.load_state_dict(host_state)
        return Trainer(trainer_cfg, mdl, loss_fn, LOSS_WEIGHTS, STEPS_PER_EPOCH, device=dev)

    hot_names = ("schema_net.vertex_weights", "schema_net.edge_weights")
    s4_launches, _ = stage4_fp32_vs_plain(
        lambda: trainer(torch.float32, "highest"), batches[:FP32_STEPS],
        TRAIN_CFG["optimizer"]["lr"], FROZEN_LAYERS,
        {"with_plain": with_plain, "recording_vq": recording_vq, "replaying_vq": replaying_vq,
         "replay_report": replay_report})

    # 9. the training step in bf16: the main path, counted
    tr16 = trainer(torch.bfloat16, "default")
    torch.cuda.synchronize()
    reset_launch_counts()
    metrics = [tr16.train_iter(batch) for batch in batches]
    torch.cuda.synchronize()
    train_launches = launch_counts()
    losses16 = [m["loss"].item() for m in metrics]
    expected = {name: 0 for name in train_launches}  # no stage-0 kernel
    expected.update({"attn_block": FROZEN_LAYERS * BF16_STEPS, "attn_block_hmean": BF16_STEPS,
                     "attn_block_tc": FROZEN_LAYERS * BF16_STEPS,
                     "ffn_block": FROZEN_LAYERS * BF16_STEPS,
                     "ffn_block_tc": FROZEN_LAYERS * BF16_STEPS, "vq_assign": BF16_STEPS,
                     "vq_assign_tc": BF16_STEPS,
                     **{name: GNN_CONVS * BF16_STEPS for name in (
                         "sym_conv", "sym_conv_bwd", "sym_conv_tc", "sym_conv_bwd_tc")},
                     "fused_layernorm": GNN_CONVS * BF16_STEPS,
                     "fused_layernorm_bwd": GNN_CONVS * BF16_STEPS,
                     "fused_layernorm_bwd_vec": GNN_CONVS * BF16_STEPS,
                     "embed_grad": 2 * BF16_STEPS, "embed_grad_vec": 2 * BF16_STEPS,
                     "embed_grad_planned": BF16_STEPS,  # the class lookup, from the atlas's plan
                     "adamw_project_rows": 2 * BF16_STEPS,
                     "adamw_project_rows_vec": 2 * BF16_STEPS})  # V = 1024: 4-column pieces
    phase("train_bf16", steps=BF16_STEPS, batch=BATCH, losses=losses16,
          launches=train_launches, expected=expected)
    require(all(np.isfinite(losses16)), f"bf16 train losses not finite: {losses16}")
    require(train_launches == expected, f"train launch counts {train_launches} != {expected}")
    require(all(train_launches[f"{name}_tc"] == train_launches[name] > 0
                for name in ("sym_conv", "sym_conv_bwd", "attn_block", "ffn_block", "vq_assign")),
            "a bf16 GraphConv, attn_block, ffn_block or vq_assign launch of the stage-4 step "
            "missed the tensor-core kernels")

    # 10. timings: training kernels, the step, its split, idle share, memory
    for name, case in train_cases.items():
        kernel, plain, args, kw = case(torch.bfloat16)
        times[name] = (time_ms(lambda: kernel(*args, **kw), TIME_ITERS),
                       time_ms(lambda: plain(*args, **kw), TIME_ITERS))
        phase("kernel_time", kernel=name, dtype="bfloat16", shape=list(args[1].shape),
              ms=times[name][0], plain_ms=times[name][1], **card_note)
    for name, which in (("adamw_project_rows", "edge"), ("adamw_project_rows_vertex", "vertex")):
        p0, grad, m0, v0 = (t.clone() for t in atlas_state[which])
        times[name] = (
            time_ms(lambda: ao.adamw_project_rows(p0, grad, m0, v0, 2, **adamw_kw), TIME_ITERS),
            time_ms(lambda: ao.adamw_project_rows_reference(p0, grad, m0, v0, 2, **adamw_kw),
                    TIME_ITERS),
        )
        phase("kernel_time", kernel=name, dtype="float32", shape=list(p0.shape),
              ms=times[name][0], plain_ms=times[name][1], **card_note)

    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn, iters=TIME_ITERS):
        """Device ms of one call of fn: every device event of `iters` calls
        under the profiler. The profiler now and then returns a session with
        no device event at all, whatever was launched (twice in a row once);
        each such session is printed as a phase of its own and taken again,
        and five in a row fail."""
        fn()
        torch.cuda.synchronize()
        for attempt in range(1, 6):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            total_us = sum(device_time_by_name(prof).values())
            if total_us:
                return total_us / iters / 1e3
            phase("profile_empty", attempt=attempt, iters=iters)
        raise AssertionError("the profiler recorded no device event in five profiles in a row")

    # the GraphConv kernels' and embed_grad's device time at the class-graph
    # shapes; beside them, as a note, torch.bmm on an E_sym formed beforehand:
    # the products alone (no single PyTorch call symmetrises and multiplies)
    conv_args = cases["sym_conv"](torch.bfloat16)[2]
    bwd_args = train_cases["sym_conv_bwd"](torch.bfloat16)[2]
    esym = gc.symmetrize_edges(conv_args[0])
    f16, g16 = bwd_args[1], bwd_args[2]

    def bwd_products():
        return torch.bmm(esym, g16), torch.bmm(g16, f16.transpose(1, 2))

    # embed_grad's class lookup as the stage-4 step calls it: with the plan
    # of the fixed class_ingredients buffer (no sort, no host wait)
    class_args = train_cases["embed_grad"](torch.bfloat16)[2]
    inst_args = train_cases["embed_grad_instance"](torch.bfloat16)[2]
    class_plan = ek.sort_ids(ids_class, NUM_CODES + 1)

    def embed_planned():
        return ek.embed_grad(*class_args, plan=class_plan)

    times["embed_grad_planned"] = (time_ms(embed_planned, TIME_ITERS), times["embed_grad"][1])
    conv_device = {
        "sym_conv": device_ms(lambda: gc.sym_conv(*conv_args)),
        "sym_conv_bwd": device_ms(lambda: gc.sym_conv_bwd(*bwd_args)),
        "embed_grad": device_ms(lambda: ek.embed_grad(*class_args)),
        "embed_grad_planned": device_ms(embed_planned),
        "embed_grad_instance": device_ms(lambda: ek.embed_grad(*inst_args)),
    }
    phase("kernel_time", kernel="sym_conv_device", dtype="bfloat16", shape=list(f16.shape),
          device_ms=conv_device, ms={k: times[k][0] for k in conv_device},
          note="bmm_*: torch.bmm on a pre-formed E_sym, the products alone; not library_ms",
          bmm_fwd_ms=time_ms(lambda: torch.bmm(esym, f16), TIME_ITERS),
          bmm_fwd_device_ms=device_ms(lambda: torch.bmm(esym, f16)),
          bmm_bwd_ms=time_ms(bwd_products, TIME_ITERS), bmm_bwd_device_ms=device_ms(bwd_products),
          **card_note)
    del esym, conv_args, bwd_args, f16, g16
    # the one PyTorch call that computes embed_grad's function: index_add_
    # into an fp32 table, of the same cotangents made fp32 beforehand
    ids_long = ids_class.reshape(-1).long()
    g_fp32 = f_class.to(torch.bfloat16).reshape(-1, GNN_DIM).float()
    inst_long, inst_fp32 = ids_inst.reshape(-1).long(), inst_args[1].reshape(-1, GNN_DIM).float()
    table = torch.zeros(NUM_CODES + 1, GNN_DIM, device=dev)
    library = {"embed_grad": time_ms(lambda: table.index_add_(0, ids_long, g_fp32), TIME_ITERS)}
    inst_index_add_ms = time_ms(lambda: table.index_add_(0, inst_long, inst_fp32), TIME_ITERS)
    embed_bounds = {name: least_ms(*embed_work(args), "float32")
                    for name, args in (("class", class_args), ("instance", inst_args))}
    phase("kernel_time", kernel="embed_grad_vs_index_add", dtype="bfloat16",
          ms=times["embed_grad"][0], planned_ms=times["embed_grad_planned"][0],
          instance_ms=times["embed_grad_instance"][0], index_add_ms=library["embed_grad"],
          instance_index_add_ms=inst_index_add_ms,
          index_add_device_ms=device_ms(lambda: table.index_add_(0, ids_long, g_fp32)),
          instance_index_add_device_ms=device_ms(
              lambda: table.index_add_(0, inst_long, inst_fp32)),
          bound_ms={k: v[0] for k, v in embed_bounds.items()}, **card_note)
    # the kernels line gives the class lookup as the step runs it: planned
    times["embed_grad"] = times["embed_grad_planned"]
    atlas_bytes = {k: v[0].numel() for k, v in atlas_state.items()}
    del atlas_state, ids_long, g_fp32, table, inst_long, inst_fp32, class_plan
    torch.cuda.empty_cache()

    def step_ms(iters, plain=False):
        out = []
        for i in range(iters):
            batch = batches[i % len(batches)]
            t0 = time.perf_counter()
            if plain:
                with_plain(lambda: tr16.train_iter(batch))
            else:
                tr16.train_iter(batch)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    step_ms(2)
    torch.cuda.reset_peak_memory_stats()
    steps = step_ms(STEP_TIME_ITERS)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    step_ms(1, plain=True)
    plain_steps = step_ms(STEP_TIME_ITERS // 2, plain=True)
    # the LayerNorm kernels' share: the plain LayerNorm alone, then the kernels again
    ln_plain_steps = plain_layernorm(lambda: step_ms(STEP_TIME_ITERS))
    again = step_ms(STEP_TIME_ITERS)
    step_p50 = median(steps)
    phase("train_step", batch=BATCH, dtype="bfloat16", p50_ms=step_p50,
          min_ms=min(steps), max_ms=max(steps), images_per_s=BATCH / (step_p50 / 1e3),
          plain_versions_p50_ms=median(plain_steps),
          plain_versions_images_per_s=BATCH / (median(plain_steps) / 1e3),
          plain_layernorm_p50_ms=median(ln_plain_steps), kernels_again_p50_ms=median(again),
          peak_mem_gb=peak_gb, **card_note)

    split = {"frozen_forward": [], "graph_build_gnn_forward_loss": [], "backward": [],
             "optimizer": []}
    for batch in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        clamp_attribute_weights_(tr16.model.schema_net)
        ev[0].record()
        with torch.no_grad():
            tr16.model.ingredient_backbone(batch["image"])
        ev[1].record()
        total, _ = tr16.forward_loss(batch)
        ev[2].record()
        tr16.zero_grad()
        total.backward()
        ev[3].record()
        tr16.apply_updates()
        ev[4].record()
        torch.cuda.synchronize()
        frozen = ev[0].elapsed_time(ev[1])
        split["frozen_forward"].append(frozen)
        split["graph_build_gnn_forward_loss"].append(ev[1].elapsed_time(ev[2]) - frozen)
        split["backward"].append(ev[2].elapsed_time(ev[3]))
        split["optimizer"].append(ev[3].elapsed_time(ev[4]))
    phase("train_split", ms={k: float(np.median(v)) for k, v in split.items()},
          note="forward_loss runs the frozen forward again; its time is subtracted",
          **card_note)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[:3]:
            tr16.train_iter(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = device_time_by_name(prof)
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    phase("train_profile", steps=3, wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
          idle_share=(1 - busy_us / wall_us) if busy_us else None,
          top_device_ms_per_step={k[:80]: v / 3e3 for k, v in top}, **card_note)

    del tr16, batches
    torch.cuda.empty_cache()

    # 11. the stage-0 kernels against their plain versions at the stage-0 shapes
    rows0 = BATCH * n
    s0 = dict(qkv=rnd(BATCH, n, 3 * d), g_att=rnd(BATCH, n, d), x=rnd(BATCH, n, d),
              g_ffn=rnd(BATCH, n, d), w1=rnd(f, d, scale=d**-0.5), b1=rnd(f, scale=0.1),
              w2=rnd(d, f, scale=f**-0.5), b2=rnd(d, scale=0.1))

    def s0_case(name, dt, p):
        seed = S0_SEED if p else None
        t = {k: v.to(dt) for k, v in s0.items()}
        weights = (t["w1"], t["b1"], t["w2"], t["b2"])
        return {
            "fused_mhsa": (ak.fused_mhsa, ak.fused_mhsa_reference, (t["qkv"], heads, p, seed)),
            "fused_mhsa_bwd": (ak.fused_mhsa_bwd, ak.fused_mhsa_bwd_reference,
                               (t["qkv"], t["g_att"], heads, p, seed)),
            "fused_mlp": (mk.fused_mlp, mk.fused_mlp_reference, (t["x"], *weights, "gelu", p, seed)),
            "fused_mlp_bwd": (mk.fused_mlp_bwd, mk.fused_mlp_bwd_reference,
                              (t["x"], *weights[:3], t["g_ffn"], "gelu", p, seed)),
        }[name]

    s0_kernels = ("fused_mhsa", "fused_mhsa_bwd", "fused_mlp", "fused_mlp_bwd")
    for name in s0_kernels:
        for p in (0.0, S0_DROPOUT):
            for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
                kernel, plain, args = s0_case(name, dt, p)
                compare(name if p else f"{name}_p0", kernel, plain, args, {}, dt, tol, errors)
    # the attention kernels at the edges of their tiling: one row past a tile
    # of 64, the limit n = 320, head_dim 32 over several waves of blocks
    for tag, (bs_, n_, h_, d_) in MHSA_EDGES.items():
        qkv_e, g_e = rnd(bs_, n_, 3 * h_ * d_), rnd(bs_, n_, h_ * d_)
        for p in (0.0, S0_DROPOUT):
            seed = S0_SEED if p else None
            for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
                suffix = f"{tag}" if p else f"{tag}_p0"
                compare(f"fused_mhsa_{suffix}", ak.fused_mhsa, ak.fused_mhsa_reference,
                        (qkv_e.to(dt), h_, p, seed), {}, dt, tol, errors)
                compare(f"fused_mhsa_bwd_{suffix}", ak.fused_mhsa_bwd, ak.fused_mhsa_bwd_reference,
                        (qkv_e.to(dt), g_e.to(dt), h_, p, seed), {}, dt, tol, errors)
    del qkv_e, g_e
    # the FFN forward and backward past their tiles (rows past a tile of 64,
    # f past a chunk of 64), and the bf16 weight and bias gradients of the
    # stage-0 shape and the edges equal bit for bit over two calls (no atomics)
    mlp_same = {}
    for tag, (rows_, d_, f_) in {"stage0": (rows0, d, f), **MLP_EDGES}.items():
        x_e, g_e = rnd(1, rows_, d_), rnd(1, rows_, d_)
        w_e = (rnd(f_, d_, scale=d_**-0.5), rnd(f_, scale=0.1), rnd(d_, f_, scale=f_**-0.5))
        b2_e = rnd(d_, scale=0.1)
        for p in (0.0, S0_DROPOUT):
            seed = S0_SEED if p else None
            for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
                args_e = (x_e.to(dt), *(t.to(dt) for t in w_e), g_e.to(dt), "gelu", p, seed)
                if tag != "stage0":
                    suffix = tag if p else f"{tag}_p0"
                    compare(f"fused_mlp_{suffix}", mk.fused_mlp, mk.fused_mlp_reference,
                            (*args_e[:4], b2_e.to(dt), *args_e[5:]), {}, dt, tol, errors)
                    compare(f"fused_mlp_bwd_{suffix}", mk.fused_mlp_bwd,
                            mk.fused_mlp_bwd_reference, args_e, {}, dt, tol, errors)
                if dt == torch.bfloat16:
                    runs = [mk.fused_mlp_bwd(*args_e)[1:] for _ in range(2)]
                    mlp_same[f"{tag}_p{p}"] = all(torch.equal(a, b) for a, b in zip(*runs))
    phase("compare", kernel="fused_mlp_bwd", dtype="bfloat16",
          dparams_run_to_run_bitwise=mlp_same)
    require(all(mlp_same.values()), f"bf16 fused_mlp_bwd dW1/dW2/db1/db2 differ between two "
                                    f"calls: {mlp_same}")
    del x_e, g_e, w_e, b2_e, args_e, runs

    # 12. the stage-0 step in fp32, dropout live, against the plain versions
    def s0_cfg(dtype):
        return dict(STAGE0_CFG, training=dict(STAGE0_CFG["training"], dtype=dtype))

    rng = np.random.default_rng(2)
    s0_batches = [
        {"image": torch.from_numpy(
            rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)).to(dev),
         "label": torch.from_numpy(rng.integers(0, NUM_CLASSES, size=BATCH)).to(dev)}
        for _ in range(BF16_STEPS)
    ]

    def s0_fp32_run(track_sure):
        tr = backbone_trainer(s0_cfg("float32"), STEPS_PER_EPOCH, seed=0, device=dev)
        losses, sure = [], {}
        for batch in s0_batches[:FP32_STEPS]:
            losses.append(tr.train_iter(batch)["loss"].item())
            if track_sure and not sure:  # the step-1 (clipped) gradient
                for k, prm in tr.model.named_parameters():
                    grad = prm.grad.abs()
                    sure[k] = grad > 1e-3 * grad.max()
        params = {k: prm.detach().clone() for k, prm in tr.model.named_parameters()}
        del tr
        torch.cuda.empty_cache()
        return losses, params, sure

    losses_k, params_k, _ = s0_fp32_run(False)
    losses_p, params_p, sure = with_plain(lambda: s0_fp32_run(True))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    bound_step = 2 * STAGE0_CFG["training"]["optimizer"]["lr"] * FP32_STEPS
    worst = {"max_abs_diff": 0.0, "max_abs_diff_sure": 0.0, "sure_ok": True}
    for k in params_p:
        diff = (params_k[k] - params_p[k]).abs()
        worst["max_abs_diff"] = max(worst["max_abs_diff"], diff.max().item())
        if sure[k].any():
            worst["max_abs_diff_sure"] = max(worst["max_abs_diff_sure"], diff[sure[k]].max().item())
            worst["sure_ok"] &= bool((diff[sure[k]] <= 1e-6 + 1e-4 * params_p[k].abs()[sure[k]]).all())
    sure_share = sum(v.sum().item() for v in sure.values()) / sum(v.numel() for v in sure.values())
    phase("stage0_fp32", steps=FP32_STEPS, batch=BATCH, dropout=S0_DROPOUT, losses=losses_k,
          plain_losses=losses_p, loss_rel_err=loss_rel, tol=1e-4, sure_share=sure_share,
          bound=bound_step, **worst)
    require(loss_rel <= 1e-4, f"stage-0 fp32 losses differ by {loss_rel} relative")
    require(worst["sure_ok"], "stage-0 fp32 parameters differ beyond rtol 1e-4 / atol 1e-6 "
                              "where |g| is large")
    require(worst["max_abs_diff"] <= bound_step,
            f"stage-0 fp32 parameters differ by {worst['max_abs_diff']} > {bound_step}")
    del params_k, params_p, sure

    # 13. the stage-0 step in bf16: the main path, counted
    tr0 = backbone_trainer(s0_cfg("bfloat16"), STEPS_PER_EPOCH, seed=0, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    metrics = [tr0.train_iter(batch) for batch in s0_batches]
    torch.cuda.synchronize()
    s0_launches = launch_counts()
    losses0 = [m["loss"].item() for m in metrics]
    expected = {name: 0 for name in s0_launches}
    # every attention and FFN launch of the bf16 step on the tensor-core route
    expected.update({name: S0_LAYERS * BF16_STEPS
                     for name in (*s0_kernels, "fused_mhsa_tc", "fused_mhsa_bwd_tc",
                                  "fused_mlp_tc", "fused_mlp_bwd_tc")})
    expected.update({name: (2 * S0_LAYERS + 1) * BF16_STEPS
                     for name in ("fused_layernorm", "fused_layernorm_bwd",
                                  "fused_layernorm_bwd_vec")})
    phase("stage0_bf16", steps=BF16_STEPS, batch=BATCH, losses=losses0, launches=s0_launches,
          expected=expected)
    require(all(np.isfinite(losses0)), f"stage-0 bf16 losses not finite: {losses0}")
    require(s0_launches == expected, f"stage-0 launch counts {s0_launches} != {expected}")
    require(all(s0_launches[f"{name}_tc"] == s0_launches[name] > 0
                for name in ("fused_mhsa", "fused_mhsa_bwd", "fused_mlp", "fused_mlp_bwd")),
            "a bf16 attention or FFN launch of stage 0 missed the tensor-core kernels")

    # 14. timings: the stage-0 kernels beside their plain versions and SDPA, the step
    for name in s0_kernels:
        for p in (0.0, S0_DROPOUT):
            kernel, plain, args = s0_case(name, torch.bfloat16, p)
            key = name if p else f"{name}_p0"
            with torch.no_grad():
                times[key] = (time_ms(lambda: kernel(*args), TIME_ITERS),
                              time_ms(lambda: plain(*args), TIME_ITERS))
            phase("kernel_time", kernel=name, dtype="bfloat16", dropout=p,
                  shape=list(args[0].shape), ms=times[key][0], plain_ms=times[key][1], **card_note)
    qkv16, g16 = s0["qkv"].to(torch.bfloat16), s0["g_att"].to(torch.bfloat16)
    q, k, v = qkv16.view(BATCH, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        sdpa_ms = time_ms(lambda: sdpa(q, k, v), TIME_ITERS)
        sdpa_device = {"fwd": device_ms(lambda: sdpa(q, k, v))}
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    g_heads = g16.view(BATCH, n, heads, d // heads).transpose(1, 2)
    sdpa_fb_ms = time_ms(lambda: sdpa(qg, kg, vg).backward(g_heads), TIME_ITERS)
    # SDPA's backward alone: the same dq, dk, dv from one saved forward
    sdpa_out = sdpa(qg, kg, vg)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), g_heads, retain_graph=True)

    sdpa_bwd_ms = time_ms(sdpa_bwd, TIME_ITERS)
    sdpa_device["bwd"] = device_ms(sdpa_bwd)
    xg = qkv16.detach().clone().requires_grad_()
    fused_fb_ms = time_ms(lambda: ak.fused_mhsa(xg, heads).backward(g16), TIME_ITERS)
    attn_device = {}
    for name in ("fused_mhsa", "fused_mhsa_bwd"):
        for p in (0.0, S0_DROPOUT):
            kernel, _, args = s0_case(name, torch.bfloat16, p)
            attn_device[name if p else f"{name}_p0"] = device_ms(lambda: kernel(*args))
    # kernel over SDPA at p = 0 (SDPA has no hash dropout): CUDA events, and
    # the profiler's device time, which the host's per-call work does not reach
    phase("kernel_time", kernel="fused_mhsa_vs_sdpa", dtype="bfloat16",
          fused_fwd_ms=times["fused_mhsa_p0"][0], fused_fwd_p01_ms=times["fused_mhsa"][0],
          sdpa_fwd_ms=sdpa_ms, fused_bwd_ms=times["fused_mhsa_bwd_p0"][0],
          fused_bwd_p01_ms=times["fused_mhsa_bwd"][0], sdpa_bwd_ms=sdpa_bwd_ms,
          fused_fwd_bwd_ms=fused_fb_ms, sdpa_fwd_bwd_ms=sdpa_fb_ms, device_ms=attn_device,
          sdpa_device_ms=sdpa_device,
          fwd_over_sdpa=times["fused_mhsa_p0"][0] / sdpa_ms,
          bwd_over_sdpa=times["fused_mhsa_bwd_p0"][0] / sdpa_bwd_ms,
          fwd_over_sdpa_device=attn_device["fused_mhsa_p0"] / sdpa_device["fwd"],
          bwd_over_sdpa_device=attn_device["fused_mhsa_bwd_p0"] / sdpa_device["bwd"],
          **card_note)
    del sdpa_out
    library["fused_mhsa"] = sdpa_ms
    library["fused_mhsa_bwd"] = sdpa_bwd_ms
    # events and device time of the kernels schemanet_torch/kernel_times.py
    # lists, beside their PyTorch yardsticks
    from schemanet_torch import kernel_times
    phase("kernel_times", script="schemanet_torch/kernel_times.py",
          rows=kernel_times.measure(dev, ids_inst), **card_note)

    def s0_step_ms(iters, plain=False):
        out = []
        for i in range(iters):
            batch = s0_batches[i % len(s0_batches)]
            t0 = time.perf_counter()
            if plain:
                with_plain(lambda: tr0.train_iter(batch))
            else:
                tr0.train_iter(batch)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    s0_step_ms(2)
    torch.cuda.reset_peak_memory_stats()
    steps = s0_step_ms(STEP_TIME_ITERS)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    s0_step_ms(1, plain=True)
    plain_steps = s0_step_ms(STEP_TIME_ITERS // 2, plain=True)
    ln_plain_steps = plain_layernorm(lambda: s0_step_ms(STEP_TIME_ITERS))
    again = s0_step_ms(STEP_TIME_ITERS)
    step_p50, plain_p50 = median(steps), median(plain_steps)
    phase("stage0_step", batch=BATCH, dtype="bfloat16", layers=S0_LAYERS, p50_ms=step_p50,
          min_ms=min(steps), max_ms=max(steps), images_per_s=BATCH / (step_p50 / 1e3),
          plain_versions_p50_ms=plain_p50, plain_versions_images_per_s=BATCH / (plain_p50 / 1e3),
          plain_layernorm_p50_ms=median(ln_plain_steps), kernels_again_p50_ms=median(again),
          peak_mem_gb=peak_gb, **card_note)

    split = {"forward": [], "backward": [], "clip_adamw": []}
    for batch in s0_batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total, _ = tr0.forward_loss(batch)
        ev[1].record()
        tr0.zero_grad()
        total.backward()
        ev[2].record()
        tr0.clip_gradients()
        tr0.apply_updates()
        ev[3].record()
        torch.cuda.synchronize()
        for key, (a, b) in zip(split, ((0, 1), (1, 2), (2, 3))):
            split[key].append(ev[a].elapsed_time(ev[b]))
    phase("stage0_split", ms={k: float(np.median(v)) for k, v in split.items()}, **card_note)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in s0_batches[:3]:
            tr0.train_iter(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = device_time_by_name(prof)
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
    phase("stage0_profile", steps=3, wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
          idle_share=(1 - busy_us / wall_us) if busy_us else None,
          top_device_ms_per_step={k[:80]: v / 3e3 for k, v in top},
          top_host_self_ms_per_step={e.key[:60]: e.self_cpu_time_total / 3e3 for e in host},
          **card_note)

    del tr0, s0_batches
    torch.cuda.empty_cache()

    # 15. the VQ and LayerNorm kernels against their plain versions
    def vq_compare(case, x, cb, first_of=None):
        got, want = vqk.vq_assign_kernel(x, cb), vqk.vq_assign_reference(x, cb)
        torch.cuda.synchronize()
        agree = (got == want).float().mean().item()
        gaps, scale = vqk.score_gaps(x, cb, got, want)
        near = bool((gaps <= 1e-5 * scale).all())
        fields = dict(kernel="vq_assign", case=case, dtype=str(x.dtype).split(".")[-1],
                      shape=list(x.shape), codes=cb.shape[0], id_agreement=agree,
                      mismatches=len(gaps), near_ties_only=near,
                      max_gap_over_scale=(gaps / scale).max().item() if len(gaps) else 0.0)
        if first_of is not None:  # duplicated codes: the first copy, exactly
            fields["first_index"] = bool(torch.equal(got, vqk.vq_assign_reference(x, first_of)))
        phase("compare", **fields)
        require(agree >= 0.999, f"vq_assign {case}: ids agree on {agree} < 0.999")
        require(near, f"vq_assign {case}: a mismatch is no near-tie")
        require(fields.get("first_index", True), f"vq_assign {case}: not the first copy")
        errors["vq_assign"] = max(errors.get("vq_assign", 0.0),
                                  gaps.max().item() if len(gaps) else 0.0)

    v_s3 = S3_BATCH * v_inst
    vq_shapes = {"minibatch": (1024, d, NUM_CODES, torch.float32),
                 "lloyd": (S1_LLOYD, d, NUM_CODES, torch.float32),
                 "stage3_bf16": (v_s3, d, NUM_CODES, torch.bfloat16),
                 "imagenet_vocabulary": (v_s3, 384, 8000, torch.float32), **VQ_EDGES}
    vq_inputs = {case: (rnd(rows, width).to(dt), rnd(codes, width))
                 for case, (rows, width, codes, dt) in vq_shapes.items()}
    for case, (x, cb) in vq_inputs.items():
        vq_compare(case, x, cb)
    base = rnd(512, d)
    vq_compare("duplicated_codes", base[torch.randint(0, 512, (v_s3,), generator=g).to(dev)]
               + rnd(v_s3, d, scale=0.01), torch.cat([base, base, base]), first_of=base)

    def ln_fp64(x, sc, bi, cot, act):
        """(y, dx, dscale, dbias) of the LayerNorm in fp64 (two-pass variance)."""
        xd, gd, scd = x.double(), cot.double(), sc.double()
        mean = xd.mean(dim=-1, keepdim=True)
        r = torch.rsqrt(((xd - mean) ** 2).mean(dim=-1, keepdim=True) + 1e-6)
        xhat = (xd - mean) * r
        y = xhat * scd + bi.double()
        if act == "relu":
            gd = torch.where(y > 0, gd, torch.zeros_like(gd))
            y = y.clamp(min=0)
        ga = gd * scd
        dx = r * (ga - ga.mean(dim=-1, keepdim=True)
                  - xhat * (ga * xhat).mean(dim=-1, keepdim=True))
        return y, dx, (gd * xhat).sum(dim=0), gd.sum(dim=0)

    def ln_case(rows, width, act, name):
        """(x fp32, scale, bias, cotangent, act). For relu: the gate y > 0 is a
        tie where y is a few ulps from 0: the kernel's and the plain version's
        roundings of y may fall on either side, and one element gated apart
        moves dx by ~r g scale. No cotangent sits there (y of the fp32 and of
        the bf16 x)."""
        x32 = rnd(rows, width) * 2 + 0.5
        sc, bi, cot = 1 + rnd(width, scale=0.3), rnd(width, scale=0.3), rnd(rows, width)
        if act == "relu":
            ties = torch.zeros_like(cot, dtype=torch.bool)
            for dt in (torch.float32, torch.bfloat16):
                y = lnk.fused_layernorm_reference(x32.to(dt), sc, bi, 1e-6, "none").float()
                ties |= y.abs() <= 1e-5 * y.abs().max()
            cot = torch.where(ties, torch.zeros_like(cot), cot)
            phase("compare", kernel=name, relu_ties_zeroed=int(ties.sum()))
        return x32, sc, bi, cot, act

    ln_shapes = {"fused_layernorm": (BATCH * n, d, "none"),
                 "fused_layernorm_gnn": (NUM_CLASSES * NUM_CODES, GNN_DIM, "relu")}
    ln_inputs = {}
    for name, (rows, width, act) in ln_shapes.items():
        ln_inputs[name] = ln_case(rows, width, act,
                                  name.replace("fused_layernorm", "fused_layernorm_bwd"))
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            x, sc, bi, cot, _ = ln_inputs[name]
            x, cot = x.to(dt), cot.to(dt)
            compare(name, lnk.fused_layernorm, lnk.fused_layernorm_reference,
                    (x, sc, bi, 1e-6, act), {}, dt, 1e-5 if dt == torch.float32 else tol, errors)
            bwd = name.replace("fused_layernorm", "fused_layernorm_bwd")
            compare(bwd, lnk.fused_layernorm_bwd, lnk.fused_layernorm_bwd_reference,
                    (x, sc, bi, cot, 1e-6, act), {}, dt, tol, errors)
            if dt == torch.float32:  # both against the same formula in fp64
                want = ln_fp64(x, sc, bi, cot, act)
                got_k = (lnk.fused_layernorm(x, sc, bi, 1e-6, act),
                         *lnk.fused_layernorm_bwd(x, sc, bi, cot, 1e-6, act))
                got_p = (lnk.fused_layernorm_reference(x, sc, bi, 1e-6, act),
                         *lnk.fused_layernorm_bwd_reference(x, sc, bi, cot, 1e-6, act))
                phase("compare", kernel=f"{name}_vs_fp64", outputs=["y", "dx", "dscale", "dbias"],
                      kernel_rel_err=[rel_err(a, b) for a, b in zip(got_k, want)],
                      plain_rel_err=[rel_err(a, b) for a, b in zip(got_p, want)])
            runs = [lnk.fused_layernorm_bwd(x, sc, bi, cot, 1e-6, act)[1:] for _ in range(2)]
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            phase("compare", kernel=bwd, dtype=str(dt).split(".")[-1], dparam_run_to_run=same,
                  route=eb.piece_route(dt, x.shape[-1], x.data_ptr(), cot.data_ptr()))
            require(same, f"{bwd} {dt}: dscale/dbias differ between two runs")
    # the backward at its edges, each dtype on the route its width takes
    for tag, (rows, width, act) in LN_EDGES.items():
        bwd = f"fused_layernorm_bwd_{tag}"
        x32, sc, bi, cot, _ = ln_case(rows, width, act, bwd)
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            x, c = x32.to(dt), cot.to(dt)
            compare(bwd, lnk.fused_layernorm_bwd, lnk.fused_layernorm_bwd_reference,
                    (x, sc, bi, c, 1e-6, act), {}, dt, tol, errors)
            runs = [lnk.fused_layernorm_bwd(x, sc, bi, c, 1e-6, act)[1:] for _ in range(2)]
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            phase("compare", kernel=bwd, dtype=str(dt).split(".")[-1], dparam_run_to_run=same,
                  route=eb.piece_route(dt, width, x.data_ptr(), c.data_ptr()))
            require(same, f"{bwd} {dt}: dscale/dbias differ between two runs")

    class DeviceImages:
        """A re-iterable loader of seeded random NHWC images and labels made
        on the card; ``seconds`` holds each pass's time, to its last batch's
        end on the device."""

        def __init__(self, batches, batch, seed):
            self.batches, self.batch, self.seed, self.seconds = batches, batch, seed, []

        def __iter__(self):
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(self.batches):
                yield {"image": torch.randn(self.batch, IMG, IMG, 3, generator=gen, device=dev),
                       "label": torch.randint(0, NUM_CLASSES, (self.batch,), generator=gen,
                                              device=dev)}
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)

    # 16. stage 1: codebook extraction, counted, then against the plain versions
    s1_loader = DeviceImages(S1_BATCHES, S1_BATCH, 3)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    bundle = extract_stage(STAGE1_CFG, s1_loader, seed=0, device=dev)
    torch.cuda.synchronize()
    s1_seconds = time.perf_counter() - t0
    s1_launches = launch_counts()
    per_batch = S1_BATCH * v_inst
    chunks = [min(per_batch, S1_FEATURES - i * per_batch) for i in range(-(-S1_FEATURES // per_batch))]
    minibatches = sum(-(-c // 1024) for c in chunks)
    require(len(chunks) <= S1_BATCHES, "stage 1: too few batches for its features")
    expected = {name: 0 for name in s1_launches}
    expected.update({"attn_block": FROZEN_LAYERS * len(chunks),
                     "attn_block_tc": FROZEN_LAYERS * len(chunks),
                     "ffn_block": FROZEN_LAYERS * len(chunks),
                     "ffn_block_tc": FROZEN_LAYERS * len(chunks),
                     "vq_assign": minibatches + S1_LLOYD_ITERS,
                     "vq_assign_tc": minibatches + S1_LLOYD_ITERS})
    require(s1_launches == expected, f"stage-1 launch counts {s1_launches} != {expected}")
    require(s1_launches["vq_assign_tc"] == s1_launches["vq_assign"] > 0,
            "a vq_assign launch of stage 1 missed the split-TF32 kernel")
    require(s1_launches["ffn_block_tc"] == s1_launches["ffn_block"] > 0,
            "an ffn_block launch of stage 1 missed the split-TF32 kernel")
    require(s1_launches["attn_block_tc"] == s1_launches["attn_block"] > 0,
            "an attn_block launch of stage 1 missed the split-TF32 kernels")
    require(bool(torch.isfinite(bundle.codebook).all())
            and tuple(bundle.codebook.shape) == (NUM_CODES, EMBED_DIM), "stage-1 codebook")
    backbone = get_model(STAGE1_CFG["model"], NUM_CLASSES)
    backbone.load_state_dict(bundle.backbone_state)
    backbone.requires_grad_(False).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = collect_mid_features(backbone, s1_loader, ENCODE_LAYER, S1_FEATURES)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    held = feats[:S1_LLOYD]
    inertia = kmeans.kmeans_inertia(bundle.codebook, held).item()
    init_state = kmeans.kmeans_init(torch.Generator().manual_seed(0), feats[:4096], NUM_CODES)
    mb = feats[:1024]
    minibatch_ms = time_ms(lambda: kmeans.minibatch_step(init_state, mb), TIME_ITERS)
    lloyd_ms = time_ms(lambda: kmeans.lloyd_step(bundle.codebook, held), 3, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kmeans.kmeans_init(torch.Generator().manual_seed(0), feats[:4096], NUM_CODES)
    torch.cuda.synchronize()
    plusplus_ms = (time.perf_counter() - t0) * 1e3
    phase("stage1_fp32", features=len(feats), batches=len(chunks), batch=S1_BATCH,
          codes=NUM_CODES, seconds=s1_seconds, launches=s1_launches, expected=expected,
          collect_features_per_s=len(feats) / collect_s, collect_seconds=collect_s,
          minibatch_steps=minibatches, minibatch_step_ms=minibatch_ms,
          lloyd_iterations=S1_LLOYD_ITERS, lloyd_step_ms=lloyd_ms, kmeans_pp_ms=plusplus_ms,
          final_inertia=inertia, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
          **card_note)
    require(np.isfinite(inertia), f"stage-1 inertia {inertia}")

    plain_feats = with_plain(lambda: collect_mid_features(
        backbone, DeviceImages(2, S1_BATCH, 3), ENCODE_LAYER, 2 * per_batch))
    feat_err = rel_err(feats[:len(plain_feats)], plain_feats)
    require(feat_err <= FP32_TOL, f"stage-1 features differ by {feat_err} of max")
    del plain_feats
    lock = {"steps": 0, "rows": 0, "mismatches": 0, "near_ties_only": True,
            "center_err": 0.0, "centers_moved_by_mismatch": 0}

    def lock_step(ids_fn, step_fn, data):
        """One k-means step from the kernel run's state, with the kernel and
        with every plain version: ids and the updated centers compared."""
        ids_k = vqk.vq_assign_kernel(data, ids_fn())
        ids_p = vqk.vq_assign_reference(data, ids_fn())
        gaps, scale = vqk.score_gaps(data, ids_fn(), ids_k, ids_p)
        nxt_k, nxt_p = step_fn(), with_plain(step_fn)
        c_k, c_p = nxt_k[0], nxt_p[0]  # the centers of a KMeansState or a Lloyd step
        moved = torch.zeros(NUM_CODES, dtype=torch.bool, device=dev)
        mis = ids_k != ids_p
        moved[ids_k[mis].long()] = True
        moved[ids_p[mis].long()] = True
        err = (c_k - c_p).abs()[~moved].max() / c_p.abs().max()
        lock["steps"] += 1
        lock["rows"] += len(data)
        lock["mismatches"] += int(mis.sum())
        lock["near_ties_only"] &= bool((gaps <= 1e-5 * scale).all())
        lock["center_err"] = max(lock["center_err"], err.item())
        lock["centers_moved_by_mismatch"] += int(moved.sum())
        return nxt_k

    state = init_state
    for i in range(S1_CHECK_MINIBATCHES):
        batch_i = feats[i * 1024:(i + 1) * 1024]
        state = lock_step(lambda: state.centers,
                          lambda: kmeans.minibatch_step(state, batch_i), batch_i)
    centers = state.centers
    for _ in range(S1_CHECK_LLOYD):
        centers = lock_step(lambda: centers, lambda: kmeans.lloyd_step(centers, held), held)[0]
    agree = 1 - lock["mismatches"] / lock["rows"]
    phase("stage1_fp32_vs_plain", feature_rel_err=feat_err, id_agreement=agree,
          tol={"features": FP32_TOL, "ids": 0.999, "near_tie": 1e-5, "centers": 1e-4}, **lock)
    require(agree >= 0.999, f"stage-1 k-means ids agree on {agree} < 0.999")
    require(lock["near_ties_only"], "stage-1 k-means: a mismatch is no near-tie")
    require(lock["center_err"] <= 1e-4, f"stage-1 centers differ by {lock['center_err']}")
    del feats, held, backbone, init_state, state, centers, mb
    torch.cuda.empty_cache()

    # 17. stage 3: the IR-Atlas init, counted, then against the plain versions
    s3_loader = DeviceImages(S3_BATCHES, S3_BATCH, 4)
    recorded = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recording_vq(recorded):
        atlas = init_stage(STAGE3_CFG, bundle, s3_loader, device=dev)
    torch.cuda.synchronize()
    s3_seconds = time.perf_counter() - t0
    s3_peak = torch.cuda.max_memory_allocated() / 2**30
    s3_launches = launch_counts()
    passes = 2 * S3_BATCHES
    expected = {name: 0 for name in s3_launches}
    expected.update({"attn_block": FROZEN_LAYERS * passes, "attn_block_hmean": passes,
                     "attn_block_tc": FROZEN_LAYERS * passes,
                     "ffn_block": FROZEN_LAYERS * passes, "ffn_block_tc": FROZEN_LAYERS * passes,
                     "vq_assign": passes, "vq_assign_tc": passes})
    require(s3_launches == expected, f"stage-3 launch counts {s3_launches} != {expected}")
    require(s3_launches["vq_assign_tc"] == s3_launches["vq_assign"] > 0,
            "a vq_assign launch of stage 3 missed the tensor-core kernels")
    require(s3_launches["ffn_block_tc"] == s3_launches["ffn_block"] > 0,
            "an ffn_block launch of stage 3 missed the split-TF32 kernel")
    require(s3_launches["attn_block_tc"] == s3_launches["attn_block"] > 0,
            "an attn_block launch of stage 3 missed the split-TF32 kernels")
    replay_stats = {"rows": 0, "mismatches": 0, "near_ties_only": True}

    def plain_init():
        with replaying_vq(recorded, replay_stats):
            return init_stage(STAGE3_CFG, bundle, DeviceImages(S3_BATCHES, S3_BATCH, 4),
                              device=dev)

    atlas_p = with_plain(plain_init)
    same_ingredients = bool(torch.equal(atlas["class_ingredients"], atlas_p["class_ingredients"]))
    atlas_err = {k: rel_err(atlas["params"][k], atlas_p["params"][k]) for k in atlas["params"]}
    ips = [S3_BATCHES * S3_BATCH / sec for sec in s3_loader.seconds]
    del atlas_p
    torch.cuda.empty_cache()

    # the stage-3 atlas to files (which phases 19-23 read), and a stage-4 step
    # from them
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    save_bundle(os.path.join(run_dir, "bundle"), bundle.model_cfg, bundle.encode_layer,
                bundle.backbone_state, bundle.codebook, bundle.extra)
    save_atlas_init(os.path.join(run_dir, "atlas_init.pt"), atlas["params"],
                    atlas["class_ingredients"])
    tr4 = schema_net_trainer(STAGE3_CFG, load_bundle(os.path.join(run_dir, "bundle")),
                             load_atlas_init(os.path.join(run_dir, "atlas_init.pt")),
                             STEPS_PER_EPOCH, seed=0, device=dev)
    from_atlas = bool(torch.equal(tr4.model.schema_net.class_ingredients,
                                  atlas["class_ingredients"].to(dev)))
    step_loss = tr4.train_iter(next(iter(DeviceImages(1, BATCH, 5))))["loss"].item()
    phase("stage3_fp32", classes=NUM_CLASSES, v_max=NUM_CODES, batch=S3_BATCH,
          batches_per_pass=S3_BATCHES, seconds=s3_seconds,
          cut=f"{S3_BATCHES * S3_BATCH} of CIFAR-100's {CIFAR_TRAIN} training images a pass",
          images_per_s_per_pass=ips,
          full_dataset_seconds_extrapolated=sum(CIFAR_TRAIN / r for r in ips),
          launches=s3_launches, expected=expected, peak_mem_gb=s3_peak,
          class_ingredients_equal=same_ingredients, param_rel_err=atlas_err,
          **replay_report(replay_stats), stage4_trainer_from_saved_atlas=from_atlas, stage4_step_loss=step_loss,
          tol={"params": 1e-5, "ids": 0.999}, **card_note)
    require(same_ingredients, "stage-3 class_ingredients differ from the plain versions'")
    require(all(err <= 1e-5 for err in atlas_err.values()), f"stage-3 atlas differs: {atlas_err}")
    require(from_atlas and np.isfinite(step_loss), "stage-4 step from the saved atlas")
    del tr4, atlas, bundle, recorded
    torch.cuda.empty_cache()

    # 18. timings of the VQ and LayerNorm kernels; the device time of a call
    # beside the CUDA-event time, which the host's per-call work bounds for
    # the small launches
    for case, (x, cb) in vq_inputs.items():
        # the events of 3 Lloyd calls; the device time of 20 (profiles of 3
        # have read a third or two thirds of the events' time)
        iters = 3 if case == "lloyd" else TIME_ITERS
        key = "vq_assign" if case == "minibatch" else f"vq_assign_{case}"
        times[key] = (time_ms(lambda: vqk.vq_assign_kernel(x, cb), iters),
                      time_ms(lambda: vqk.vq_assign_reference(x, cb), iters))
        flops, moved, ops_type = vq_work(x, cb)
        bound_ms, bound_by = least_ms(flops, moved, ops_type)
        phase("kernel_time", kernel="vq_assign", case=case, dtype=str(x.dtype).split(".")[-1],
              shape=list(x.shape), codes=cb.shape[0], ms=times[key][0], plain_ms=times[key][1],
              device_ms=device_ms(lambda: vqk.vq_assign_kernel(x, cb)),
              bound_ms=bound_ms, bound_by=bound_by, bound_ops=ops_type, **card_note)
    for name, (x, sc, bi, cot, act) in ln_inputs.items():
        x, cot = x.to(torch.bfloat16), cot.to(torch.bfloat16)
        bwd = name.replace("fused_layernorm", "fused_layernorm_bwd")
        times[name] = (time_ms(lambda: lnk.fused_layernorm(x, sc, bi, 1e-6, act), TIME_ITERS),
                       time_ms(lambda: lnk.fused_layernorm_reference(x, sc, bi, 1e-6, act),
                               TIME_ITERS))
        times[bwd] = (time_ms(lambda: lnk.fused_layernorm_bwd(x, sc, bi, cot, 1e-6, act),
                              TIME_ITERS),
                      time_ms(lambda: lnk.fused_layernorm_bwd_reference(x, sc, bi, cot, 1e-6, act),
                              TIME_ITERS))
        w16, b16 = sc.to(torch.bfloat16), bi.to(torch.bfloat16)
        library[name] = time_ms(lambda: torch.nn.functional.layer_norm(
            x, (x.shape[-1],), w16, b16, 1e-6), TIME_ITERS)
        # one ATen call computes the backward of a plain LayerNorm; it has no
        # relu gate, so at the GNN's shape it is a note, not library_ms
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [x.shape[-1]], w16, b16, 1e-6)

        def ln_bwd_library():
            return torch.ops.aten.native_layer_norm_backward(
                cot, x, [x.shape[-1]], mean, rstd, w16, b16, [True, True, True])

        bwd_library_ms = time_ms(ln_bwd_library, TIME_ITERS)
        if act == "none":
            library[bwd] = bwd_library_ms
        x32_, cot32_ = x.float(), cot.float()  # the same values in fp32
        phase("kernel_time", kernel=name, dtype="bfloat16", shape=list(x.shape), act=act,
              ms=times[name][0], plain_ms=times[name][1], layer_norm_ms=library[name],
              bwd_ms=times[bwd][0], bwd_plain_ms=times[bwd][1],
              native_layer_norm_backward_ms=bwd_library_ms,
              native_layer_norm_backward_device_ms=device_ms(ln_bwd_library),
              bwd_bound_ms=least_ms(*ln_work(x, bwd=True), "float32")[0],
              bwd_fp32_ms=time_ms(lambda: lnk.fused_layernorm_bwd(x32_, sc, bi, cot32_, 1e-6, act),
                                  TIME_ITERS),
              bwd_fp32_device_ms=device_ms(
                  lambda: lnk.fused_layernorm_bwd(x32_, sc, bi, cot32_, 1e-6, act)),
              bwd_fp32_bound_ms=least_ms(*ln_work(x32_, bwd=True), "float32")[0],
              device_ms=device_ms(lambda: lnk.fused_layernorm(x, sc, bi, 1e-6, act)),
              bwd_device_ms=device_ms(lambda: lnk.fused_layernorm_bwd(x, sc, bi, cot, 1e-6, act)),
              layer_norm_device_ms=device_ms(lambda: torch.nn.functional.layer_norm(
                  x, (x.shape[-1],), w16, b16, 1e-6)), **card_note)

    # 19-23. the loader-driven workers
    try:
        worker_launches = worker_phases(
            dev, run_dir, os.path.join(run_dir, "bundle"), os.path.join(run_dir, "atlas_init.pt"),
            card_note, {"with_plain": with_plain, "recording_vq": recording_vq,
                        "replaying_vq": replaying_vq, "replay_report": replay_report})
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    # 24-30. ImageNet: the kernels at the new widths, DeiT-Small's serving,
    # stage-4 step and stage 0, DeiT-Base's serving and stage 0
    torch.cuda.empty_cache()
    imagenet = imagenet_phases(dev, card_note, {"with_plain": with_plain,
                                                "recording_vq": recording_vq,
                                                "replaying_vq": replaying_vq,
                                                "replay_report": replay_report})

    # the least time the card could take for the timed work of each kernel
    def attn_work(args, hmean=False):
        """(operations, bytes[, type]) of an attn_block call: fp32 as its
        kernels do it, three TF32 products a product."""
        x, g1, b1, wqkv, bqkv, wo, bo, h = args
        bs_, n_, dim = x.shape
        rows, hd = bs_ * n_, wqkv.shape[0] // 3
        flops = 2 * rows * dim * 3 * hd + 4 * bs_ * n_ * n_ * hd + 2 * rows * hd * dim
        out = 2 * x.numel() * x.element_size() + (bs_ * n_ * n_ * x.element_size() if hmean else 0)
        moved = out + nbytes(g1, b1, *(t.to(x.dtype) for t in (wqkv, bqkv, wo, bo)))
        if x.dtype == torch.float32:
            return 3 * flops, moved, "tfloat32"
        return flops, moved

    def ffn_work(args):
        """(operations, bytes[, type]) of an ffn_block call: fp32 as its
        kernel does it, three TF32 products a product."""
        x, g1, b1, w1, fb1, w2, fb2 = args
        flops = 4 * x.numel() * w1.shape[0]
        moved = 2 * nbytes(x) + nbytes(g1, b1, w1.to(x.dtype), fb1.to(x.dtype), w2.to(x.dtype),
                                       fb2.to(x.dtype))
        if x.dtype == torch.float32:
            return 3 * flops, moved, "tfloat32"
        return flops, moved

    def conv_work(args, bwd=False):
        e, f_ = args[0], args[1]
        kk, vv, dd = f_.shape
        flops = (4 if bwd else 2) * kk * vv * vv * dd + 2 * kk * vv * vv
        io = nbytes(*args) + (nbytes(e, f_) if bwd else nbytes(f_))
        return flops, io

    def adamw_work(which):
        prm = atlas_bytes[which]
        return 15 * prm, 7 * 4 * prm  # p, g, m, v read; p, m, v written; fp32

    def s0_work(name):
        t = {k: v.to(torch.bfloat16) for k, v in s0.items()}
        att = 2 * BATCH * heads * n * n * (d // heads)
        mlp = 2 * rows0 * d * f
        weights = nbytes(t["w1"], t["b1"], t["w2"])
        return {
            "fused_mhsa": (2 * att, nbytes(t["qkv"], t["g_att"])),
            "fused_mhsa_bwd": (5 * att, 2 * nbytes(t["qkv"]) + nbytes(t["g_att"])),
            "fused_mlp": (2 * mlp, 2 * nbytes(t["x"]) + weights + nbytes(t["b2"])),
            "fused_mlp_bwd": (5 * mlp, 3 * nbytes(t["x"]) + 2 * weights + nbytes(t["b2"])),
        }[name]

    work = {
        "attn_block": attn_work(cases["attn_block"](torch.bfloat16)[2]),
        "attn_block_hmean": attn_work(cases["attn_block"](torch.bfloat16)[2], hmean=True),
        "attn_block_fp32": attn_work(attn32["attn_block_fp32"][0]),
        "attn_block_fp32_hmean": attn_work(attn32["attn_block_fp32_hmean"][0], hmean=True),
        "ffn_block": ffn_work(cases["ffn_block"](torch.bfloat16)[2]),
        "ffn_block_fp32": ffn_work(cases["ffn_block"](torch.float32)[2]),
        "sym_conv": conv_work(cases["sym_conv"](torch.bfloat16)[2]),
        "sym_conv_bwd": conv_work(train_cases["sym_conv_bwd"](torch.bfloat16)[2], bwd=True),
        "embed_grad": embed_work(train_cases["embed_grad"](torch.bfloat16)[2]),
        "adamw_project_rows": adamw_work("edge"),
        **{name: s0_work(name) for name in s0_kernels},
        "vq_assign": vq_work(*vq_inputs["minibatch"]),
        # timed in bf16
        "fused_layernorm": ln_work(ln_inputs["fused_layernorm"][0].to(torch.bfloat16)),
        "fused_layernorm_bwd": ln_work(ln_inputs["fused_layernorm"][0].to(torch.bfloat16),
                                       bwd=True),
    }
    replaces = {
        "attn_block": "schemanet_tpu/ops/pallas/encoder_block.py:240",
        "attn_block_hmean": "schemanet_tpu/ops/pallas/encoder_block.py:240",
        "attn_block_fp32": "schemanet_tpu/ops/pallas/encoder_block.py:240",
        "attn_block_fp32_hmean": "schemanet_tpu/ops/pallas/encoder_block.py:240",
        "ffn_block": "schemanet_tpu/ops/pallas/encoder_block.py:286",
        "ffn_block_fp32": "schemanet_tpu/ops/pallas/encoder_block.py:286",
        "sym_conv": "schemanet_tpu/ops/pallas/graphconv.py:68",
        "sym_conv_bwd": "schemanet_tpu/ops/pallas/graphconv.py:100",
        "embed_grad": "schemanet_tpu/ops/pallas/embed_bwd.py:161",
        "adamw_project_rows": "schemanet_tpu/ops/pallas/atlas_opt.py:133",
        "fused_mhsa": "schemanet_tpu/ops/pallas/attention.py:162",
        "fused_mhsa_bwd": "schemanet_tpu/ops/pallas/attention.py:216",
        "fused_mlp": "schemanet_tpu/ops/pallas/mlp.py:230",
        "fused_mlp_bwd": "schemanet_tpu/ops/pallas/mlp.py:271",
        "vq_assign": "schemanet_tpu/ops/pallas/vq.py:79",
        "fused_layernorm": "schemanet_tpu/ops/pallas/layernorm.py:119",
        "fused_layernorm_bwd": "schemanet_tpu/ops/pallas/layernorm.py:151",
    }
    sources = {"sym_conv": "graphconv.cu", "sym_conv_bwd": "graphconv.cu",
               "embed_grad": "embed_bwd.cu", "adamw_project_rows": "atlas_opt.cu",
               "fused_mhsa": "attention.cu", "fused_mhsa_bwd": "attention.cu",
               "fused_mlp": "mlp.cu", "fused_mlp_bwd": "mlp.cu", "vq_assign": "vq.cu",
               "fused_layernorm": "layernorm.cu", "fused_layernorm_bwd": "layernorm.cu"}
    variants = {"sym_conv": "sym_conv_instance", "sym_conv_bwd": "sym_conv_bwd_instance",
                "embed_grad": "embed_grad_instance",
                "adamw_project_rows": "adamw_project_rows_vertex",
                "fused_layernorm": "fused_layernorm_gnn",
                "fused_layernorm_bwd": "fused_layernorm_bwd_gnn",
                **{name: f"{name}_p0" for name in s0_kernels}}
    # each kernel's launches on the path that runs it most: stage 4 for the
    # SchemaNet kernels, stage 0 for the fused ViT kernels and the LayerNorm,
    # stage 1 for VQ and fp32 ffn_block and attn_block, stage 3 for the fp32
    # head-mean
    launches = {**train_launches,
                **{name: s0_launches[name] for name in (*s0_kernels, "fused_layernorm",
                                                        "fused_layernorm_bwd")},
                "vq_assign": s1_launches["vq_assign"], "ffn_block_fp32": s1_launches["ffn_block"],
                "attn_block_fp32": s1_launches["attn_block"],
                "attn_block_fp32_hmean": s3_launches["attn_block_hmean"]}
    kernels = []
    for name in replaces:
        # the operations' type: where the work does not name it (VQ's does),
        # fp32 for the kernels that compute outside the tensor cores on fp32
        # data (or with fp32 statistics), else bf16
        fp32_ops = ("adamw_project_rows", "fused_layernorm", "fused_layernorm_bwd")
        flops, moved, *ops_type = work[name]
        dtype = ops_type[0] if ops_type else "float32" if name in fp32_ops else "bfloat16"
        bound_ms, bound_by = least_ms(flops, moved, dtype)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "schemanet_torch/csrc/" + sources.get(name, "encoder_block.cu"),
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(errors[name], errors.get(variants.get(name), 0.0)),
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library.get(name),
            # the loader-driven workers' launches (phases 20 and 23), fp32 variants apart
            "worker_launches": {worker: counts[name] for worker, counts in worker_launches.items()
                                if name in counts and counts[name]},
        })
    # the instantiations of phases 24-30, launches from their paths: DeiT-Small
    # and DeiT-Base stage 0 (fused_mlp at 384, 768), DeiT-Base serving
    # (ffn_block at 768), the ImageNet stage-4 step (the rest)
    new_rows = {
        "attn_block_d384": ("encoder_block.cu", "encoder_block.py:240"),
        "attn_block_d768": ("encoder_block.cu", "encoder_block.py:240"),
        "ffn_block_d384": ("encoder_block.cu", "encoder_block.py:286"),
        "ffn_block_d768": ("encoder_block.cu", "encoder_block.py:286"),
        "fused_mlp_d384": ("mlp.cu", "mlp.py:230"), "fused_mlp_bwd_d384": ("mlp.cu", "mlp.py:271"),
        "fused_mlp_d768": ("mlp.cu", "mlp.py:230"), "fused_mlp_bwd_d768": ("mlp.cu", "mlp.py:271"),
        "fused_layernorm_d1024": ("layernorm.cu", "layernorm.py:119"),
        "fused_layernorm_bwd_d1024": ("layernorm.cu", "layernorm.py:151"),
        "adamw_project_rows_bf16": ("atlas_opt.cu", "atlas_opt.py:133"),
        "sym_conv_imagenet": ("graphconv.cu", "graphconv.py:68"),
        "sym_conv_bwd_imagenet": ("graphconv.cu", "graphconv.py:100"),
    }
    for name, (source, tpu_site) in new_rows.items():
        r = imagenet["rows"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "schemanet_torch/csrc/" + source,
            "replaces": "schemanet_tpu/ops/pallas/" + tpu_site, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "worker_launches": {},
        })
    require(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
    phase("imagenet_seconds", total=sum(imagenet["seconds"].values()), **imagenet["seconds"])
    phase("total", seconds=time.perf_counter() - t_start, **card_note)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
