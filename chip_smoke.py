"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): the serving path,
the SchemaNet training step, stage 0 (fine-tuning the backbone), stage 1
(codebook extraction), stage 3 (IR-Atlas initialisation), the
loader-driven workers (training with validation, checkpoints and resume,
and evaluation), the ImageNet DeiT-Small configuration (serving with its
explanations, the stage-4 step and stage 0) with DeiT-Base's widths, the
command line's stage chain, the pretrained-weight loader, several
ranks (``parallel/mesh.py``: a one-rank grid, then two ranks with the atlas
split over its classes and with the batch split over the data axis), the
int8 route, and the model zoo (the FFN kernels' activations, a relu and a
post-norm DeiT-Small, ResNet-50 and ResNet-18).

Both run the CIFAR-100 DeiT-Tiny configuration at full width (224^2 input,
patch 16, 197 tokens, d=192, 3 heads, FFN 768, layers 0-9 of 12 frozen,
M=1024 codes, K=100 classes, V_max=1024, GNN width 256 x 2 layers,
inner-product matcher) with seeded random weights, and check every
hand-written CUDA kernel on the two paths.

Serving (``schemanet_torch.ServePredictor.predict``, microbatch 64, as
``tools/bench_serve.py``):

1. device: name, count, ``nvidia-smi`` name and power limit, and whether
   networkx is present (phase 32's GraphML export needs it);
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
   atlas's plan, 2 adamw_project_rows); the GraphConv and LayerNorm
   launches by shape (``launch_counts_by_shape``): 2 a step at the class
   graphs' [100, 1024, 256] (rows 102,400 x 256) and 2 at the instance
   graphs' [64, 196, 256] (rows 12,544 x 256), none at any other shape;
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
    (``torch.profiler``), where the profile's ``sym_conv_tc_kernel``,
    ``sym_conv_de_tc_kernel``, ``ln_fwd_kernel`` and ``ln_bwd_kernel``
    launches must equal what the wrappers' launches by shape over the same
    steps imply (a ``sym_conv_bwd`` is one dF product and one dE kernel),
    and the peak device memory; the instance graphs' GraphConv device time
    beside ``torch.bmm`` on a pre-formed E_sym (a note).

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
    max. Gated in its place, the atlas gradients of the kernels and the
    plain versions in fp32 against the plain versions in fp64, from the
    fresh model and after 2 steps: the kernels' no more than 10% farther
    (after 2 steps always; at the first step where the two sides' gradients
    differ by more than 1e-5 of max, which other data showed for the edge
    weights: 1.5e-4 apart, both 1.1e-3 from fp64). Cut: K = 100;
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
    finite losses, step ms, device ms a step and idle share. Depth not cut;
31. ``ServePredictor.explain_tensor`` on phase 25's predictor (bf16, K =
    1000, M = 8000, V_max = 500), one microbatch of 64 (run after 25):
    ``pred`` equal to ``predict_tensor``'s bit for bit, ``ingredients`` the
    VQ ids of the same forward, the attribution bit for bit a gather of the
    [K, M+1] table summed apart on the CPU in fp64 and rounded to fp32,
    every output the same bits over two calls, the launch counts one predict
    microbatch's; explain p50/p99 beside predict's p50. In fp32 at K = 100
    (phase 26's predictor, run with 26): against the plain versions, ids >=
    99.9% equal, ``pred`` within 1e-3 x max, the attribution equal wherever
    the two sides' ids are.
    Phase 27 also counts the GraphConv and LayerNorm launches by shape (class
    graphs [1000, 500, 1024], rows 500,000 x 1024; instance graphs [64, 196,
    1024], rows 12,544 x 1024), holds them to the profile as phase 10 does,
    and times the instance graphs' GraphConv (beside ``torch.bmm`` on a
    pre-formed E_sym, a note) and LayerNorm against their plain versions.

Each of 24-31 prints its seconds (``phase_seconds``; ``imagenet_seconds``
sums them).

The command line and the pretrained loader (``cli_phase``,
``pretrained_phase``):

32. the stage chain through ``schemanet_torch.cli`` at CIFAR DeiT-Tiny's full
    width (12 layers, d 192, M 1024, K 100) on the synthetic dataset (128
    training images, 64 validation), configs written as JSON (``get_cfg``'s
    JSON route; phase 56 reads the shipped YAML): ``train --worker
    backbone_worker`` from a reference-named ``.pth`` made from a seed
    (1000-class head, the head in
    ``lax_names``; the worker must log the load), ``extract``, ``export``,
    ``init``, ``train --worker schema_net_worker`` (one epoch of 2 steps,
    ``max_keep`` 1), each through ``cli.main`` in this process, exit code 0
    and its stage's kernels counted; then ``serve --explain --out`` (with
    ``--graph-sample 0`` where networkx is present) as ``python -m
    schemanet_torch.cli`` in a subprocess: exit 0, a top-k line an image, and
    its ``.npz`` bit for bit ``load_serve_predictor(...).predict`` and
    ``.explain`` in this process (with the subprocess's PyTorch defaults:
    cuDNN in TF32), whose launches show the serving kernels;
33. the pretrained loader at DeiT-Small's real shape: a reference-named
    ``.pth`` from a seed (12 layers, d 384, 1000 classes) into a 100-class
    ``backbone_trainer`` with the head in ``lax_names``: every loaded tensor
    bit for bit the file's after the layout change (``pos_embed`` [n, 1, d]
    -> [1, n, d]), the head its local initialisation, one bf16 step finite.

ImageNet from folders of JPEGs (``imagefolder_phases``; the JPEG fixtures
of ``tests/fixtures/jpeg/``; the decode route is named on each line):

34. the decode route (libjpeg on the host where ``jpeglib.h`` is installed,
    else nvJPEG on the card with ``ycc_to_rgb``): the fixtures against their
    committed libjpeg pixels (bit for bit on the host route; within 3
    levels, mean under 0.2 a file, on nvJPEG), ``ycc_to_rgb`` bit for bit
    its plain version, the decode bit for bit from run to run, the CMYK
    JPEG and the PNG named ``.JPEG`` through Pillow where it is installed,
    else raising with the file's name; a batch of 64 ImageNet-sized photos'
    decode ms;
35. ``crop_resize`` against its plain version on that batch at 224^2, with
    train (RandomResizedCrop + flip), val, identity and edge boxes (windows
    past the image's edges): every differing byte one level off at a .5
    tie (counted), the same bits over two calls; its time;
36. the image-folder loader on a fake ImageNet tree (1000 class folders of
    6 training and 1 validation photo, hard links in a temporary
    directory): images/s of 20 training batches (two epochs) and of the
    validation split through ``device_prefetch`` and ``prepare``, one
    ``crop_resize`` (and on nvJPEG one ``ycc_to_rgb``) launch a batch;
37. ``stage1_imagenet_fp32``: ``extract_stage`` of
    ``configs/imagenet/ingredient/deit_small-l9-M_8000.yaml`` from the
    tree at the CLI's defaults (batch 64, 1,000,000 features, M 8000, d 384,
    k-means++ from 32,000), phase 16's launch counts (plus the image
    kernels), features/s, ms a minibatch and a Lloyd step, inertia, peak
    memory, and phase 16's checks against the plain versions;
38. ``stage3_imagenet_fp32``: ``init_stage`` at K 1000, V_max 500, M 8000
    on 2,000 of the tree's images (batch 32; extrapolated to ImageNet's
    1,281,167), peak memory, and phase 17's checks against the plain
    versions;
39. 2 bf16 steps of ``schema_net_worker`` from the tree on that bundle and
    atlas (training cut to 128 images), one validation, one checkpoint.

Several ranks (``parallel/mesh.py``; ``grid_phases``), after phase 39, on
the cards present: with two or more, NCCL with one card a rank; with one,
gloo with both ranks on ``cuda:0`` (NCCL refuses two ranks on one device),
the kernels on the card and the collectives through the host. A
``grid_setup`` line names the backend and the card count first.

40. ``mesh_one_rank``: a one-rank NCCL grid in this process, 2 bf16 steps of
    the ImageNet DeiT-Small stage-4 trainer of phase 27 through the grid's
    code path, every parameter, moment and loss bit for bit those of the
    trainer without a grid;
41. ``mesh_model2``: two ranks (``python3 chip_smoke.py --grid-rank DIR``,
    spawned with a wall-clock limit; a rank that fails or hangs fails the
    run), model 2 on the same configuration: each rank holds 500 classes of
    the atlas and their bf16 moments and runs their class graphs. One fp32
    step (graph_precision 'highest') from the seeded state against one
    process on the same batch by phase 8's rules (loss rtol 1e-4; the
    gathered atlas within rtol 1e-4 / atol 1e-6 where the one-process
    gradient is large; every trained tensor within 2 lr; the gradients the
    update reads, gathered, by phase 28's first-step rule: each leaf within
    1e-5 of its max of the one process's, else no farther from the plain
    versions' fp64 gradient than the one process's, by more than 10%; taken
    after the reduction, before any clip),
    and taken twice from one saved state on each rank, bit for bit
    (``run_to_run_bitwise``); then 2 bf16 steps, finite, each kernel's
    launches at the shard's shapes (GraphConv at ``[500, 500, 1024]``, the
    GNN's LayerNorm at 250,000 rows), the peak memory a rank and the ms a
    step (through gloo on one card: no measure of NCCL), then a third step
    profiled (device ms, idle share, top kernels);
42. ``mesh_data2_stage0``: two ranks, data 2: 2 fp32 DeiT-Small stage-0
    steps with dropout live, each rank on its 32 images, against one process
    on the 64 by phase 29's rules, the first step's gradients (the mean over
    the data group, before the clip) by phase 28's rule as in 41; 12 launches of
    each fused kernel a step on each rank.

The int8 (W8A8) route of the frozen backbone (``ops/quant.py``;
``quant_phases``), after phase 42:

43. ``quant_vs_plain``: ``quantize_rows`` (activations in bf16 and fp32, the
    fp32 weights) and ``int8_gemm`` (with bias, bf16 and fp32 out) against
    their plain versions, bit for bit, at every projection of DeiT-Tiny,
    -Small and -Base (in and out 192/576/768, 384/1152/1536, 768/2304/3072)
    on 12,608 and 1,000 rows, with ``max |int8 route - dense| / max
    |dense|`` a case as a note; then each projection of DeiT-Small timed in
    bf16 beside its plain version, its bound, ``torch._int_mm`` on the same
    operands (the int32 product alone) and the bf16 ``F.linear`` (notes);
44. ``imagenet_serve_int8``: phase 25's stage-4 predictor (K 1000, M 8000,
    V_max 500, GNN 1024 x 2) through ``ServePredictor(quant_int8=True)``:
    a microbatch of 64 is 40 ``int8_gemm``, 80 ``quantize_rows``, 20 + 4
    (GNN) ``fused_layernorm``, 9 ``fused_mhsa`` (the encode layer takes the
    per-op attention for its head-mean) and no ``attn_block``/``ffn_block``;
    finite at 1, 64 and 100 images, batch invariant; p50/p99 and images/s
    in turns with the unquantised route, each route's microbatch profiled
    (device ms, idle share, top kernels); the drift against that route under
    tests/test_quant.py's bounds (mid-feature relative error < 0.05,
    per-token cosine > 0.99; the ViT classifier's argmax agreement >=
    0.875 in fp32, as that file gates it, and reported in bf16 beside
    bf16's own agreement with fp32; the SchemaNet logits' argmax agreement
    and their near-ties reported); the caller's config unchanged;
45. ``imagenet_serve_int8_fp32``: the same route in fp32 at K 100 and
    DeiT-Base's microbatch (fc2's k 3072), each against the plain versions:
    free running, phase 4's rule (VQ ids >= 99.9% equal, logits within
    1e-3 of max) and the share of int8 codes that differ, reported (a code
    flipped at a .5 tie moves its projection by a quantisation step and
    the runs part layer by layer); gated in lock step, each layer on the
    kernel run's input to it, by tests/test_torch_quant.py's whole-layer
    bounds (codes differing <= 1e-4, each by 1; output within 2e-3 of
    max);
46. ``stage1_int8``: phase 16's stage 1 with ``quant``: seconds and
    features/s beside phase 16's, its launches, the centers' drift
    (inertia on phase 16's held sample, nearest fp32 center) and the
    features' drift under phase 44's bounds. Phase 32 also runs
    ``extract --quant-int8`` and ``serve --quant-int8`` (its logits bit
    for bit the in-process ``load_serve_predictor(..., quant_int8=True)``).

The model zoo (``zoo_phases``), after phase 46:

47. ``ffn_activations``: ``ffn_block`` and the ``fused_mlp`` forward and
    backward with relu against their plain versions at DeiT-Tiny's, -Small's
    and -Base's widths (192, 384, 768; 12,608 rows, f = 4 d; dropout 0.1 in
    ``fused_mlp``), bf16 and fp32, each launch counted by ``relu_launches``;
    the relu backward in lock step, its plain version given the kernel's
    relu gate (read back from the kernel's dW2,
    ``tests/_torch_relu_gates.py``) within the tolerance of 3, the gates
    the two set apart counted and each a candidate of ``gate_candidates``
    (within the fp32 summation-error bound of the point where the gate
    switches, h rounded as the TPU kernel rounds it); ``swish``,
    ``sigmoid``, ``hard_sigmoid`` and ``none`` forward at 384, both dtypes,
    each pair counted one ``ffn_block`` and one ``fused_mlp`` launch; the relu rows
    timed at DeiT-Small's 12,608 x 384 in bf16 beside their plain versions,
    ``ffn_block_relu`` and ``fused_mlp_relu`` also beside the library calls
    (F.layer_norm + F.linear + F.relu + F.linear) as a note;
48. ``relu_deit_small``: ``vanilla_cfg(384, 6)`` naming no activation
    (relu, the packages' default): 2 bf16 stage-0 steps, 12 launches a step
    of each fused kernel and of ``fused_mlp[_bwd]_relu``, and a frozen
    forward: 12 ``attn_block``, 12 ``ffn_block`` (``ffn_block_relu``);
49. ``post_norm_stage0``: that DeiT-Small post-norm (``pre_norm: false``)
    with the identity position encoding, with gelu and with relu: 3 fp32
    steps with dropout 0.1 live against the plain versions by phase 12's
    rules (relu: the plain run in lock step, each backward given the
    kernel run's relu gate, as phase 8 gives the VQ ids; the free-running
    plain run reported beside it, not gated) and its fp32 frozen forward
    within 1e-4 of max; with relu 3 bf16 steps and a bf16 frozen forward
    counted, every layer on the per-op route (``fused_mhsa``,
    ``fused_layernorm`` for both norms and the final norm, applied first,
    ``fused_mlp``) and no ``attn_block`` or ``ffn_block``; one masked
    post-norm layer (a causal mask, [8, 197, 384], fp32) on the card within
    1e-5 of max of the CPU's, through 2 ``fused_layernorm`` and 1
    ``fused_mlp`` launch and no attention or whole-layer kernel (the JAX
    package declines those two for a mask);
50. ``resnet50``: ``official_models``/``resnet50`` at 224^2 and 1000 classes
    under the ImageNet vanilla block's training: one step on the card
    against the CPU at batch 8, in fp32 (TF32 off: a deterministic
    forward's logits, the loss and the running statistics after the step
    within 1e-4; the gradients reported, each run's distance from fp64
    too: fp32 resolves them to a few % of a leaf's max, where a ReLU input
    lies within two runs' rounding of 0) and in fp64 (the loss fp32, as in
    both packages: logits, loss and statistics within 1e-6, each gradient
    leaf within 1e-5 of its max); then bf16 stage 0 at batch
    ``RN_BATCH``: p50 step ms over 10 steps after 2 warm-up steps, images/s,
    peak memory, one step profiled (device ms, idle share, the top eight
    device entries), and no hand-written kernel launched (the JAX package
    runs a ResNet in XLA, with no Pallas kernel);
51. ``resnet18_worker``: ``backbone_worker`` with ``resnet18`` on the
    synthetic dataset (64 images of 32^2 resized to 224^2, batch 32, cuDNN
    deterministic): two epochs, and one epoch resumed ("auto") for the
    second, equal bit for bit (parameters, the running statistics, the
    AdamW state, the final validation).

52. ``mesh_data2_resnet50`` (with phases 40-42, also under ``--grid``): two
    ranks, data 2: 2 ResNet-50 stage-0 steps in fp64 (the loss fp32, as in
    both packages; fp32 resolves these gradients to a few % only, phase
    50), each rank on 8 of 16 images, against one process on the 16: losses
    within 1e-6, the running statistics within 1e-6 of max after the first
    step and 1e-5 after the second, the first step's gradients (the mean
    over the data group, before the clip) within 1e-5 of each leaf's max,
    the parameters by phase 29's rules, no hand-written kernel launched.

The kernel policy, the optimizers and the feature dump (each phase where
its path already runs):

53. ``kernel_policy`` (``schemanet_torch/ops/policy.py``): after phase 2, the
    resolved policy, all 13 fields, on a line of its own (a stray
    ``SCHEMANET_*`` variable shows); after phases 10 and 14, from one state
    of the CIFAR stage-4 bf16 step and of the stage-0 bf16 step, one step
    with each kernel field alone plain (``POLICY_PLAIN``): its kernels launch
    0 times and every other kernel as in the default run (``block`` plain:
    the frozen layers' per-op route adds its ``fused_mhsa``,
    ``fused_layernorm`` and ``fused_mlp``); with every field plain no kernel
    launches, and the loss and the updated state are bit for bit those of
    ``with_plain`` from the same state (the stage-4 side with ``block: xla``
    on both). Phase 32 adds a stage-4 worker run with ``--override
    kernels.graphconv=xla``: no ``sym_conv`` launch;
54. ``optimizers``: after phase 27, the ImageNet DeiT-Small stage-4 step at
    full width (K 1000, bf16, the YAML's groups) under AdamW, SGD, Adam and
    factored AdamW (the groups without their low-memory keys, which would
    keep the atlas on ``adamw_lowmem``), 3 steps each: finite losses, p50
    step ms and peak memory beside AdamW's, no ``adamw_project_rows`` launch
    but under AdamW, the other kernels as under AdamW; after phase 28, each
    of the three in fp32 at K 100 against the plain versions by phase 8's
    rules (``run_to_run_bitwise`` gated, the tight rule reported as in 28),
    then resumed from step 2 through a checkpoint bit for bit; in the grid
    ranks (``mesh_model2_factored``), one fp32 factored step at model 2, the
    Adafactor statistics of the split edge weights (summed over the model
    group) within 1e-4 of one process's, the atlas within 1e-5;
55. ``saved_features``: after phase 16, ``cluster_features`` of its
    1,000,000 x 192 fp32 features on the card (one ``vq_assign`` a
    minibatch and a Lloyd step), its seconds, and in lock step against the
    plain versions by phase 16's rules; whether h5py is importable (its own
    line) and, where it is, the dump's round trip (its absence is no
    failure).

The project's own runs (``gate_phases``, after phase 51):

56. ``yaml_configs``: every ``configs/**/*.yaml`` read by the port's reader
    (``schemanet_torch/utils/config.py``) with PyYAML refused in this
    process, as on a machine without it: each parses to a mapping; the
    count;
57. ``gates``: ``sh tools/ab_graph_precision_torch.sh`` then ``sh
    tools/ab_atlas_moments_torch.sh`` as subprocesses at the JAX gates'
    recipe (CIFAR-100-scale synthetic data: stage 0 from scratch, 3 epochs
    at batch 256; stage 1 at 400,000 features, bf16; export; init; stage 4
    at batch 64, 3 epochs, 96 steps an arm, seed 0; ``training.max_keep``
    1, so an arm keeps two 1.29 GB checkpoints, and the graph-precision
    gate's checkpoint files go before the moments gate runs) under a work
    directory deleted afterwards: exit code 0 for every stage and script,
    every artifact the scripts check, top-1 ``|default - highest| <=
    0.005``, ``|bf16 - fp32| <= 0.005`` (fp32: the ``default`` arm), the
    ``default`` arm at least 0.10 top-1, ``eval_worker`` on the ``default``
    arm's best checkpoint equal to its final eval's counts; the factored
    arm reported. A line an arm (top-1, top-5, steps, stage-4 seconds) and
    one with the seconds of stages 0-3. No kernel is added: the stages
    launch those phase 32 counts, in their own processes.

The kernels line gains ``ffn_block_relu``, ``fused_mlp_relu`` and
``fused_mlp_bwd_relu`` (phase 47's times, phase 48's launches).

The kernels line gains ``quantize_rows`` and ``int8_gemm`` (replacing XLA's
int8 ``dot_general``, no Pallas kernel), timed at DeiT-Small's qkv
projection of a serving microbatch, launches from phase 44, ``library_ms``
of ``int8_gemm`` the ``torch._int_mm`` product.

The kernels line adds the class graphs' kernels at a model-2 rank's shard:
``sym_conv[_bwd]_shard``, ``fused_layernorm[_bwd]_shard_d1024``,
``embed_grad_shard`` (the class lookup's 250,000 ids) and
``adamw_project_rows_shard`` (the ``[500, 500, 500]`` edge shard, bf16
moments), each timed beside its plain version, with phase 41's launches.

The kernels line gains ``crop_resize`` and ``ycc_to_rgb`` (ported from the
host pipeline, ``native/src/imagepipe.cpp``, not from a Pallas kernel),
``attn_block_fp32_d384``, ``attn_block_fp32_hmean_d384``,
``ffn_block_fp32_d384``, ``vq_assign_fp32_m8000[_lloyd]`` (launches from
phases 37-38) and ``fused_mhsa[_bwd]_d384`` / ``_d768`` (launches from
phases 29-30, SDPA at p = 0 as ``library_ms``).

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
``adamw_project_rows_bf16``, ``sym_conv[_bwd]_imagenet``, and the instance
graphs' ``sym_conv[_bwd]_instance_imagenet`` and
``fused_layernorm[_bwd]_instance_d1024``), each with the launches of the
path that runs it. The GraphConv and the GNN's LayerNorm rows count their
own shape's launches only: ``sym_conv[_bwd]`` and
``fused_layernorm[_bwd]_gnn`` the class graphs', ``*_instance`` the
instance graphs'. The VQ kernel's launches are stage 1's and the ViT's
LayerNorm (``fused_layernorm[_bwd]``) stage 0's; its error is the largest
plain-score difference between
the kernel's code and the plain version's. ``ffn_block_fp32`` is
``ffn_block`` in fp32 (the split-TF32 kernel): stage 1's launches, the fp32
error and times, its bound by three TF32 products a product.
``attn_block_fp32`` is ``attn_block`` in fp32 (the split-TF32 kernels) the
same way, at serving's microbatch shape; ``attn_block_fp32_hmean`` its
head-mean variant: stage 3's launches, timed at stage 3's batch of 32.

Usage: python3 chip_smoke.py; ``python3 chip_smoke.py --grid`` runs phases
1-2, 40-42 and 52 alone, on the cards present (a rank of phases 41-42 and 52
runs it as ``chip_smoke.py --grid-rank DIR``); ``python3 chip_smoke.py
--gates`` runs phases 1-2, 56 and 57 alone
"""

from __future__ import annotations

import copy
import functools
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
L_INST = (IMG // PATCH) ** 2  # patch tokens: the slots of an instance graph
# the kernels line's rows of the GNN's GraphConv and LayerNorm: (counter,
# shape) of the class graphs [K, V_max, D] and of the instance graphs of a
# batch [64, L, D]; LayerNorm by (rows, D)
GNN_ROWS = {
    "sym_conv": ("sym_conv", (NUM_CLASSES, NUM_CODES, GNN_DIM)),
    "sym_conv_instance": ("sym_conv", (BATCH, L_INST, GNN_DIM)),
    "sym_conv_bwd": ("sym_conv_bwd", (NUM_CLASSES, NUM_CODES, GNN_DIM)),
    "sym_conv_bwd_instance": ("sym_conv_bwd", (BATCH, L_INST, GNN_DIM)),
    "fused_layernorm_gnn": ("fused_layernorm", (NUM_CLASSES * NUM_CODES, GNN_DIM)),
    "fused_layernorm_gnn_instance": ("fused_layernorm", (BATCH * L_INST, GNN_DIM)),
    "fused_layernorm_bwd_gnn": ("fused_layernorm_bwd", (NUM_CLASSES * NUM_CODES, GNN_DIM)),
    "fused_layernorm_bwd_gnn_instance": ("fused_layernorm_bwd", (BATCH * L_INST, GNN_DIM)),
}
# stage 0's LayerNorm rows: the ViT's [64, 197, 192]
S0_LN_ROWS = {"fused_layernorm": ("fused_layernorm", (BATCH * (L_INST + 1), EMBED_DIM)),
              "fused_layernorm_bwd": ("fused_layernorm_bwd", (BATCH * (L_INST + 1), EMBED_DIM))}
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
# (inline); the dataset block
# {name: synthetic, num_classes: 1000, image_size: 224} (no ImageNet file is
# in the repository: 224^2 images shipped as they are, no resize)
IN_CLASSES, IN_CODES, IN_VMAX, IN_GNN, IN_FP32_CLASSES = 1000, 8000, 500, 1024, 100
IN_DATA = {"name": "synthetic", "num_classes": IN_CLASSES, "image_size": IMG}
# the ImageNet step's GraphConv and LayerNorm rows, as GNN_ROWS
IN_GNN_ROWS = {
    "sym_conv_imagenet": ("sym_conv", (IN_CLASSES, IN_VMAX, IN_GNN)),
    "sym_conv_instance_imagenet": ("sym_conv", (BATCH, L_INST, IN_GNN)),
    "sym_conv_bwd_imagenet": ("sym_conv_bwd", (IN_CLASSES, IN_VMAX, IN_GNN)),
    "sym_conv_bwd_instance_imagenet": ("sym_conv_bwd", (BATCH, L_INST, IN_GNN)),
    "fused_layernorm_d1024": ("fused_layernorm", (IN_CLASSES * IN_VMAX, IN_GNN)),
    "fused_layernorm_instance_d1024": ("fused_layernorm", (BATCH * L_INST, IN_GNN)),
    "fused_layernorm_bwd_d1024": ("fused_layernorm_bwd", (IN_CLASSES * IN_VMAX, IN_GNN)),
    "fused_layernorm_bwd_instance_d1024": ("fused_layernorm_bwd", (BATCH * L_INST, IN_GNN)),
}


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
# H100 SXM data sheet, dense: bf16, TF32 and int8 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 494.7e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def plain_patches() -> list:
    """Each kernel wrapper of the paths patched to its plain version."""
    from schemanet_torch.ops.kernels import atlas_opt as ao
    from schemanet_torch.ops.kernels import attention as ak
    from schemanet_torch.ops.kernels import embed_bwd as ek
    from schemanet_torch.ops.kernels import encoder_block as eb
    from schemanet_torch.ops.kernels import graphconv as gc
    from schemanet_torch.ops.kernels import layernorm as lnk
    from schemanet_torch.ops.kernels import mlp as mk
    from schemanet_torch.ops.kernels import quant as qk
    from schemanet_torch.ops.kernels import vq as vqk

    return [
        mock.patch.object(eb, "attn_block", eb.attn_block_reference),
        mock.patch.object(eb, "ffn_block", eb.ffn_block_reference),
        mock.patch.object(gc, "sym_conv", gc.sym_conv_reference),  # autograd of plain torch
        mock.patch.object(ek, "embed_grad", ek.embed_grad_reference),
        mock.patch.object(ao, "adamw_project_rows", ao.adamw_project_rows_reference),
        mock.patch.object(ak, "fused_mhsa", ak.fused_mhsa_reference),  # autograd of plain torch
        mock.patch.object(mk, "fused_mlp", mk.fused_mlp_reference),
        mock.patch.object(vqk, "vq_assign_kernel", vqk.vq_assign_reference),
        mock.patch.object(lnk, "fused_layernorm", lnk.fused_layernorm_plain),
        mock.patch.object(qk, "quantize_rows", qk.quantize_rows_reference),
        mock.patch.object(qk, "int8_gemm", qk.int8_gemm_reference),
    ]


def with_plain(fn):
    """fn() with every kernel wrapper patched to its plain version."""
    patches = plain_patches()
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in patches:
            p.stop()


# The same for the relu gate of the FFN backward: where x W1^T is about the
# point where relu' = (h > 0) switches, the kernel and its plain version may
# set a hidden element's gate apart, and that element's dH is dA on one side
# and 0 on the other. So the plain run's fused_mlp backward takes the kernel
# run's gates, read back from the kernel (tests/_torch_relu_gates.py), in
# the order the kernel run launched its backward.
def recording_relu_gates(store):
    from schemanet_torch.ops.kernels import mlp as mk
    from tests._torch_relu_gates import kernel_gate

    kernel_backward = mk._FusedMlp.backward

    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        grads = kernel_backward(ctx, g)
        if ctx.args[0] == "relu":
            store.append(kernel_gate(x, w1, b1, w2))
        return grads

    return mock.patch.object(mk._FusedMlp, "backward", staticmethod(backward))


def replaying_relu_gates(store, stats):
    """``fused_mlp`` on its plain versions, its backward
    ``fused_mlp_bwd_reference`` given the next recorded gate; ``stats``
    counts the backward calls and the gates the replay set apart from the
    plain run's own."""
    from schemanet_torch.ops.kernels import mlp as mk
    from tests._torch_relu_gates import plain_gate

    class Replay(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w1, b1, w2, b2, activation, dropout_p, seed, row0):
            ctx.save_for_backward(x, w1, b1, w2)
            ctx.args = (activation, dropout_p, seed, row0)
            return mk.fused_mlp_reference(x, w1, b1, w2, b2, activation, dropout_p, seed, row0)

        @staticmethod
        def backward(ctx, g):
            x, w1, b1, w2 = ctx.saved_tensors
            gate = store.pop(0)
            require(gate.shape == (x.numel() // x.shape[-1], w1.shape[0]),
                    f"a replayed relu gate of shape {tuple(gate.shape)} at x {tuple(x.shape)}")
            stats["calls"] += 1
            stats["gates_set_apart"] += int((gate != plain_gate(x, w1, b1)).sum())
            grads = mk.fused_mlp_bwd_reference(x, w1, b1, w2, g.contiguous(), *ctx.args,
                                               gate=gate)
            return (*grads, None, None, None, None)

    def replay(x, w1, b1, w2, b2, activation="gelu", dropout_p=0.0, seed=None, row0=0):
        w1, b1, w2, b2 = (t.to(x.dtype).contiguous() for t in (w1, b1, w2, b2))
        return Replay.apply(x, w1, b1, w2, b2, activation, float(dropout_p), seed, int(row0))

    return mock.patch.object(mk, "fused_mlp", replay)


# A run on the kernels against one on the plain versions: where two codes'
# scores nearly tie, the VQ kernel and its plain version may pick either, and
# one other code changes a graph and its gradients. So the plain run takes
# the kernel run's ids in the same order, and the plain VQ's own ids on the
# plain run's features are held to them apart from near-ties.
def recording_vq(store):
    from schemanet_torch.ops.kernels import vq as vqk

    kernel_vq = vqk.vq_assign_kernel

    def record(x, cb):
        ids = kernel_vq(x, cb)
        store.append(ids)
        return ids

    return mock.patch.object(vqk, "vq_assign_kernel", record)


def replaying_vq(store, stats):
    from schemanet_torch.ops.kernels import vq as vqk

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


def device_counts_by_name(prof) -> dict:
    """Device kernel launches by kernel name in a profile (user annotations
    apart)."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            out[evt.name] = out.get(evt.name, 0) + 1
    return out


def row_launches(shapes: dict, rows: dict):
    """(each row's launches, the launches no row takes) from a run's launches
    by shape (``launch_counts_by_shape()``): ``rows`` maps a kernel-line row
    to (its kernel's counter, its shape)."""
    got = {row: shapes[kernel].get(tuple(shape), 0) for row, (kernel, shape) in rows.items()}
    taken = {(kernel, tuple(shape)) for kernel, shape in rows.values()}
    rest = {f"{kernel} {list(shape)}": n for kernel, by in shapes.items()
            for shape, n in by.items() if (kernel, shape) not in taken and n}
    return got, rest


def profiled_conv_ln_launches(prof, shapes: dict):
    """(the profile's launches, what the wrappers' launches by shape over the
    same calls imply) of the GraphConv tensor-core and LayerNorm kernels: a
    ``sym_conv`` call is one ``sym_conv_tc_kernel``, a ``sym_conv_bwd`` call
    one more (dF) and one ``sym_conv_de_tc_kernel`` (dE, which every graph of
    the stage-4 step needs), a LayerNorm call one ``ln_fwd_kernel`` or one
    ``ln_bwd_kernel``."""
    counts = device_counts_by_name(prof)
    total = {kernel: sum(by.values()) for kernel, by in shapes.items()}
    marks = ("sym_conv_tc_kernel", "sym_conv_de_tc_kernel", "ln_fwd_kernel", "ln_bwd_kernel")
    got = {m: sum(n for name, n in counts.items() if m in name) for m in marks}
    want = {"sym_conv_tc_kernel": total["sym_conv"] + total["sym_conv_bwd"],
            "sym_conv_de_tc_kernel": total["sym_conv_bwd"],
            "ln_fwd_kernel": total["fused_layernorm"],
            "ln_bwd_kernel": total["fused_layernorm_bwd"]}
    return got, want


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


def stage4_fp32_vs_plain(make_trainer, batches, lr: float, frozen_layers: int,
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


def kmeans_vs_plain(feats, held, init_state, n_codes: int, with_plain):
    """Stage 1's k-means in lock step against the plain versions: from
    ``init_state``, S1_CHECK_MINIBATCHES minibatch steps over the first rows
    of ``feats``, then S1_CHECK_LLOYD Lloyd steps over ``held``, each step
    from the kernel run's state, once with the kernel and once with every
    plain version: the ids' mismatches (each must be a near-tie) and the
    updated centers' largest difference apart from the centers a mismatched
    row moved. Returns (the lock-step record, the ids' agreement)."""
    from schemanet_torch.ops import kmeans
    from schemanet_torch.ops.kernels import vq as vqk

    dev = feats.device
    lock = {"steps": 0, "rows": 0, "mismatches": 0, "near_ties_only": True,
            "center_err": 0.0, "centers_moved_by_mismatch": 0}

    def lock_step(ids_fn, step_fn, data):
        ids_k = vqk.vq_assign_kernel(data, ids_fn())
        ids_p = vqk.vq_assign_reference(data, ids_fn())
        gaps, scale = vqk.score_gaps(data, ids_fn(), ids_k, ids_p)
        nxt_k, nxt_p = step_fn(), with_plain(step_fn)
        c_k, c_p = nxt_k[0], nxt_p[0]  # the centers of a KMeansState or a Lloyd step
        moved = torch.zeros(n_codes, dtype=torch.bool, device=dev)
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
    return lock, 1 - lock["mismatches"] / lock["rows"]


def imagenet_phases(dev, card_note: dict) -> dict:
    """Phases 24-30: the kernels at the DeiT-Small, DeiT-Base and ImageNet
    widths against their plain versions; the ImageNet DeiT-Small
    configuration's serving (bf16, counted and timed; fp32 against the plain
    versions), its stage-4 step (bf16, counted, timed, profiled; fp32 in lock
    step against the plain versions) and its stage 0 (fp32 against the plain
    versions, bf16 counted); DeiT-Base's serving microbatch and stage-0
    steps. Returns the rows of the kernels line for the new instantiations,
    and each phase's seconds."""
    from torch.profiler import ProfilerActivity, profile

    from schemanet_torch.models.vit import get_model
    from schemanet_torch.ops.kernels import atlas_opt as ao
    from schemanet_torch.ops.kernels import encoder_block as eb
    from schemanet_torch.ops.kernels import graphconv as gc
    from schemanet_torch.ops.kernels import (launch_counts, launch_counts_by_shape,
                                             reset_launch_counts)
    from schemanet_torch.ops.kernels import layernorm as lnk
    from schemanet_torch.ops.kernels import mlp as mk
    from schemanet_torch.pipeline.bundle import Bundle
    from schemanet_torch.schema import build_predictor, get_loss_fn, init_parameters_
    from schemanet_torch.serve import ServePredictor
    from schemanet_torch.train import (SCHEMA_NET_FROZEN, Trainer, TrainerConfig, backbone_trainer,
                                       schema_net_trainer)

    seconds, rows, errors = {}, {}, {}
    g = torch.Generator().manual_seed(24)
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = now - t_phase
        t_phase = now
        phase("phase_seconds", phase_name=name, seconds=seconds[name], **card_note)

    def rnd(*shape, scale=1.0, gen=None):
        return (torch.randn(*shape, generator=gen or g) * scale).to(dev)

    # the instance graphs' inputs from a generator of their own, so that the
    # phases after them draw the same numbers as without them
    g_inst = torch.Generator().manual_seed(31)

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
    ln_rows = {"d1024": "fused_layernorm_d1024",
               "d1024_instance": "fused_layernorm_instance_d1024"}
    for tag, (rows_, d_, act) in {"d1024": (IN_CLASSES * IN_VMAX, IN_GNN, "relu"),
                                  "d1024_instance": (BATCH * L_INST, IN_GNN, "relu"),
                                  "d384": (vit_rows, 384, "none"),
                                  "d768": (vit_rows, 768, "none")}.items():
        gen = g_inst if tag == "d1024_instance" else g
        x32 = rnd(rows_, d_, gen=gen)
        sc, bi = 1 + rnd(d_, scale=0.1, gen=gen), rnd(d_, scale=0.1, gen=gen)
        cot32 = rnd(rows_, d_, gen=gen)
        if act == "relu":  # no cotangent at a gate tie (|y| <= 1e-5 max |y|), as phase 15
            y = lnk.fused_layernorm_reference(x32, sc, bi, 1e-6, act)
            cot32 = torch.where(y.abs() <= 1e-5 * y.abs().max(), 0.0, cot32)
            for dt in (torch.bfloat16,):
                yk = lnk.fused_layernorm_reference(x32.to(dt), sc, bi, 1e-6, act).float()
                cot32 = torch.where(yk.abs() <= 1e-5 * yk.abs().max(), 0.0, cot32)
            del y, yk
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            xx, cc = x32.to(dt), cot32.to(dt)
            label = (ln_rows.get(tag, f"fused_layernorm_{tag}")
                     + ("" if dt == torch.bfloat16 else "_fp32"))
            compare(label, lnk.fused_layernorm, lnk.fused_layernorm_reference,
                    (xx, sc, bi, 1e-6, act), {}, dt, tol, errors)
            compare(label.replace("layernorm", "layernorm_bwd"), lnk.fused_layernorm_bwd,
                    lnk.fused_layernorm_bwd_reference, (xx, sc, bi, cc, 1e-6, act), {}, dt, tol,
                    errors)
            ln_same[label] = twice_equal(lambda: lnk.fused_layernorm_bwd(xx, sc, bi, cc, 1e-6,
                                                                         act)[1:])
            if tag in ln_rows and dt == torch.bfloat16:
                row(ln_rows[tag], (*ln_work(xx), "float32"),
                    time_ms(lambda: lnk.fused_layernorm(xx, sc, bi, 1e-6, act), iters),
                    time_ms(lambda: lnk.fused_layernorm_reference(xx, sc, bi, 1e-6, act), iters),
                    shape=list(xx.shape), act=act)
                row(ln_rows[tag].replace("layernorm", "layernorm_bwd"),
                    (*ln_work(xx, bwd=True), "float32"),
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

    # 31. explain at ImageNet DeiT-Small, on phase 25's predictor (bf16,
    # K = 1000, M = 8000, V_max = 500), one microbatch of 64
    xb = images[:MICROBATCH]
    reset_launch_counts()
    ex = serve.explain_tensor(xb)
    torch.cuda.synchronize()
    explain_launches = launch_counts()
    one_mb = {name: 0 for name in explain_launches}
    one_mb.update({name: n // mbs for name, n in expected.items()})
    ex_again = serve.explain_tensor(xb)
    with torch.no_grad():
        pred = serve.predict_tensor(xb)
        ids = serve.predictor.ingredient_backbone(xb)["ingredients"]
        atlas = serve.predictor.schema_net.get_atlas()
    # the attribution built apart: the [K, M+1] table summed on the CPU in
    # fp64, rounded to fp32, gathered by the VQ ids
    cv = atlas["class_vertices"].float().cpu().double().numpy()
    ci = atlas["class_ingredients"].long().cpu().numpy()
    table = np.zeros((IN_CLASSES, IN_CODES + 1))
    np.add.at(table, (np.arange(IN_CLASSES)[:, None], ci), cv)
    grid = IMG // PATCH
    want_attr = table.astype(np.float32)[:, ids.long().cpu().numpy().reshape(-1)].reshape(
        IN_CLASSES, MICROBATCH, grid, grid).transpose(1, 0, 2, 3)
    checks = {
        "pred_equals_predict": bool(torch.equal(ex["pred"], pred)),
        "ingredients_equal_vq_ids": bool(torch.equal(ex["ingredients"].reshape(ids.shape), ids)),
        "attribution_equals_cpu_fp64_table": bool(np.array_equal(
            ex["attribution"].cpu().numpy(), want_attr)),
        "run_to_run_bitwise": all(torch.equal(ex[k], ex_again[k]) for k in ex),
        "launches_equal_a_predict_microbatch": explain_launches == one_mb,
    }
    del ex, ex_again, want_attr, table
    lat_ex = []
    for _ in range(LATENCY_ITERS):
        t0 = time.perf_counter()
        serve.explain_tensor(xb)
        torch.cuda.synchronize()
        lat_ex.append((time.perf_counter() - t0) * 1e3)
    phase("imagenet_explain_bf16", microbatch=MICROBATCH, classes=IN_CLASSES, codes=IN_CODES,
          v_max=IN_VMAX, attribution_shape=[MICROBATCH, IN_CLASSES, grid, grid],
          launches=explain_launches, expected=one_mb, **checks,
          explain_p50_ms=float(np.percentile(lat_ex, 50)),
          explain_p99_ms=float(np.percentile(lat_ex, 99)), predict_p50_ms=p50, **card_note)
    require(all(checks.values()), f"ImageNet explain: {checks}")
    lap("31_imagenet_explain_bf16")

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
    gnn_path, gnn_rest = row_launches(launch_counts_by_shape(), IN_GNN_ROWS)
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
        reset_launch_counts()
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
    profiled, implied = profiled_conv_ln_launches(prof, launch_counts_by_shape())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    step_p50 = float(np.median(step_ms))
    want_rows = {name: convs // 2 * BF16_STEPS for name in IN_GNN_ROWS}
    phase("imagenet_train_bf16", steps=BF16_STEPS, batch=BATCH, losses=losses,
          launches=train_launches, expected=expected, launches_by_shape=gnn_path,
          expected_by_shape=want_rows, other_shapes=gnn_rest, moment_dtypes=moments,
          first_steps_s=first_steps_s, step_ms=step_ms, p50_ms=step_p50,
          images_per_s=BATCH / step_p50 * 1e3, device_busy_ms_a_step=busy_us / 2e3,
          idle_share=1 - busy_us / wall_us if busy_us else None,
          top_device_ms_a_step={k: v / 2e3 for k, v in top}, peak_memory_gb=peak_gb,
          profiled_launches=profiled, launches_by_shape_sum=implied, **card_note)
    require(all(np.isfinite(losses)), f"ImageNet bf16 stage-4 losses not finite: {losses}")
    require(train_launches == expected, f"ImageNet stage-4 launches {train_launches} != {expected}")
    require(gnn_path == want_rows and not gnn_rest,
            f"ImageNet GraphConv/LayerNorm launches by shape {gnn_path}, others {gnn_rest}")
    require(profiled == implied, f"ImageNet stage-4 profile: GraphConv/LayerNorm launches "
            f"{profiled} != the rows' sums {implied}")
    require(all(t == "torch.bfloat16" for m in moments.values() for t in m.values()),
            f"an atlas tensor's moment is not bf16: {moments}")
    require(busy_us > 0, "the ImageNet stage-4 profile holds no device time")
    launches_path = {"ffn_block_d384": train_launches["ffn_block"],
                     "attn_block_d384": train_launches["attn_block"],
                     "adamw_project_rows_bf16": train_launches["adamw_project_rows_bf16"],
                     **gnn_path}
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
    # the instance graphs' GraphConv at [64, 196, 1024]: attention-sized E, and
    # beside it (a note: the products alone) torch.bmm on a pre-formed E_sym
    e_i = (torch.rand(BATCH, L_INST, L_INST, generator=g_inst) / L_INST).to(dev, torch.bfloat16)
    f_i, g_i = (rnd(BATCH, L_INST, IN_GNN, gen=g_inst).to(torch.bfloat16) for _ in range(2))
    compare("sym_conv_instance_imagenet", gc.sym_conv, gc.sym_conv_reference, (e_i, f_i), {},
            torch.bfloat16, BF16_TOL, errors)
    compare("sym_conv_bwd_instance_imagenet", gc.sym_conv_bwd, gc.sym_conv_bwd_reference,
            (e_i, f_i, g_i), {}, torch.bfloat16, BF16_TOL, errors)
    inst_flops = 2 * BATCH * L_INST * L_INST * IN_GNN + 2 * BATCH * L_INST * L_INST
    esym_i = gc.symmetrize_edges(e_i)
    with torch.no_grad():
        row("sym_conv_instance_imagenet", (inst_flops, nbytes(e_i, f_i, f_i), "bfloat16"),
            time_ms(lambda: gc.sym_conv(e_i, f_i), iters),
            time_ms(lambda: gc.sym_conv_reference(e_i, f_i), iters), shape=list(f_i.shape),
            bmm_note_ms=time_ms(lambda: torch.bmm(esym_i, f_i), iters))
        row("sym_conv_bwd_instance_imagenet",
            (2 * inst_flops, nbytes(e_i, f_i, g_i, e_i, f_i), "bfloat16"),
            time_ms(lambda: gc.sym_conv_bwd(e_i, f_i, g_i), iters),
            time_ms(lambda: gc.sym_conv_bwd_reference(e_i, f_i, g_i), iters),
            shape=list(f_i.shape), bmm_note_ms=time_ms(
                lambda: (torch.bmm(esym_i, g_i), torch.bmm(g_i, f_i.transpose(1, 2))), iters))
    state54 = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    b54 = batches[:3]
    del e16, f16, gout, e_i, f_i, g_i, esym_i, tr, serve, batches, images
    torch.cuda.empty_cache()
    lap("27_imagenet_train_bf16")

    # 54. the optimizers at full width, from phase 27's state
    optimizer_phase_bf16(state54, b54, dev, card_note)
    del state54, b54
    torch.cuda.empty_cache()
    lap("54_optimizers_bf16")

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
    # 31 (fp32, K = 100): explain against the plain versions, phase 26's rule;
    # the attribution equal where the two sides' tokens took one code
    with torch.no_grad():
        ex_k = s32.explain_tensor(images[:MICROBATCH])
        ex_p = with_plain(lambda: s32.explain_tensor(images[:MICROBATCH]))
    torch.cuda.synchronize()
    same_id = ex_k["ingredients"] == ex_p["ingredients"]
    ex_agree = same_id.float().mean().item()
    ex_scale = ex_p["pred"].abs().max().item()
    ex_err = (ex_k["pred"] - ex_p["pred"]).abs().max().item()
    attr_same = bool(torch.equal(ex_k["attribution"].permute(0, 2, 3, 1)[same_id],
                                 ex_p["attribution"].permute(0, 2, 3, 1)[same_id]))
    phase("imagenet_explain_fp32", classes=IN_FP32_CLASSES, vq_id_agreement=ex_agree,
          pred_max_abs_err=ex_err, pred_scale=ex_scale, tol=1e-3 * ex_scale,
          attribution_equal_at_equal_ids=attr_same)
    require(ex_agree >= 0.999 and ex_err <= 1e-3 * ex_scale and attr_same,
            f"ImageNet fp32 explain against the plain versions: ids {ex_agree}, pred err "
            f"{ex_err}, attribution equal {attr_same}")
    del s32, m32, logits_k, logits_p, images, ex_k, ex_p
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
    # the fresh model) within 1e-5 or no farther from fp64 than the plain
    # versions', and after 2 steps no farther from fp64 (below).
    _, lock = stage4_fp32_vs_plain(
        fp32_trainer, batches, IN_SCHEMA_CFG["training"]["optimizer"]["lr"], FROZEN_LAYERS,
        label="imagenet_train_fp32", tight=False, classes=IN_FP32_CLASSES,
        moments="bf16 (the schema_net group's)")
    first = {k.split(".")[-1]: r["grad_rel_err_steps"][0] for k, r in lock.items()}

    # the step's atlas gradient from the fresh model and after 2 kernel
    # steps: kernels and plain versions in fp32 against the plain versions in
    # fp64; the kernels may not be the farther from fp64 (by more than 10%)
    def grads_vs_fp64(state, batch_, label_):
        def step_grads(plain: bool, dtype=torch.float32):
            mdl = fp32_model(dtype).to(dtype)
            mdl.load_state_dict(state)
            t = Trainer(trainer_cfg, mdl, loss_fn, LOSS_WEIGHTS, IN_STEPS_PER_EPOCH, device=dev)
            batch = {"image": batch_["image"].to(dtype), "label": batch_["label"]}

            def run():
                t.zero_grad()
                t.forward_loss(batch)[0].backward()
                return {k: getattr(t.model.schema_net, k).grad.double() for k in (
                    "edge_weights", "vertex_weights")}

            return with_plain(run) if plain else run()

        ids = []
        with recording_vq(ids):
            g_k = step_grads(False)
        stats = {"rows": 0, "mismatches": 0, "near_ties_only": True}
        with replaying_vq(list(ids), stats):
            g_p = step_grads(True)
        with replaying_vq(list(ids), dict(stats)):
            g_64 = step_grads(True, torch.float64)
        cond = {k: {"kernel_vs_plain": rel_err(g_k[k], g_p[k]),
                    "kernel_vs_fp64": rel_err(g_k[k], g_64[k]),
                    "plain_vs_fp64": rel_err(g_p[k], g_64[k])} for k in g_k}
        phase("imagenet_grad_vs_fp64", **label_, **cond)
        return cond

    def no_farther(c):
        return c["kernel_vs_fp64"] <= 1.1 * c["plain_vs_fp64"] + 1e-6

    # the first lock step: each atlas gradient within 1e-5 of the plain
    # versions', or, where fp32 resolves it no better than that (on other
    # data the edge weights' gradient sat 1.1e-3 from fp64 on both sides,
    # 1.5e-4 apart), no farther from fp64 than the plain one's
    step0 = grads_vs_fp64(host_state, batches[0], {"after_steps": 0})
    require(all(first[k] <= 1e-5 or no_farther(step0[k]) for k in step0),
            f"ImageNet fp32 lock step: the first step's atlas gradients differ by {first} "
            f"from the plain versions' and stand farther from fp64: {step0}")
    tr = fp32_trainer()
    for b in batches[:2]:
        tr.train_iter(b)
    stepped = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    del tr
    after = grads_vs_fp64(stepped, batches[2], {"after_steps": 2})
    require(all(no_farther(c) for c in after.values()),
            f"the kernels' fp32 atlas gradient is farther from fp64 than the plain one: {after}")
    del stepped
    torch.cuda.empty_cache()
    lap("28_imagenet_train_fp32")

    # 54. the optimizers in fp32 at K 100 against the plain versions, resumed
    def opt_trainer(name):
        mdl = fp32_model()
        mdl.load_state_dict(host_state)
        cfg = TrainerConfig.from_cfg(optimizer_training(IN_SCHEMA_CFG["training"], name),
                                     frozen_patterns=SCHEMA_NET_FROZEN)
        return Trainer(cfg, mdl, loss_fn, LOSS_WEIGHTS, IN_STEPS_PER_EPOCH, device=dev)

    optimizer_phase_fp32(opt_trainer, batches, card_note)
    del batches, host_state
    torch.cuda.empty_cache()
    lap("54_optimizers_fp32")

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
        "fused_mlp_bwd"], "fused_mhsa_d384": got["fused_mhsa"],
                          "fused_mhsa_bwd_d384": got["fused_mhsa_bwd"]})
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
                          "fused_mlp_bwd_d768": got["fused_mlp_bwd"],
                          "fused_mhsa_d768": got["fused_mhsa"],
                          "fused_mhsa_bwd_d768": got["fused_mhsa_bwd"]})
    del tr0
    torch.cuda.empty_cache()
    lap("30_deit_base")

    for name, r in rows.items():
        r["launches"] = launches_path.get(name, 0)
        r["max_abs_err"] = max(errors.get(name, 0.0), errors.get(f"{name}_p0", 0.0),
                               errors.get(f"{name}_edge", 0.0), errors.get(f"{name}_vertex", 0.0))
    return {"rows": rows, "seconds": seconds, "launches": launches_path}


def worker_phases(dev, work_dir: str, bundle_dir: str, atlas_path: str, card_note: dict
                  ) -> dict:
    """Phases 19-23: the loader on the card, ``schema_net_worker`` (counted,
    timed, profiled), its resume, its validation in fp32 against the plain
    versions, and ``backbone_worker`` with ``eval_worker`` on its checkpoint.
    Returns each worker's launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from schemanet_torch.data import build_loaders, device_prefetch
    from schemanet_torch.data.augment import get_augmentation, resize_normalize_reference
    from schemanet_torch.data.loader import DataLoader
    from schemanet_torch.ops.kernels import (launch_counts, launch_counts_by_shape,
                                             reset_launch_counts)
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
    s4_shapes = launch_counts_by_shape()
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
    with recording_vq(recorded):
        ev_k, cb_k, logits_k = evaluate({"pred": [], "q": [], "o": []})

    def plain_eval():
        with replaying_vq(recorded, vq_stats):
            return evaluate({"pred": [], "q": [], "o": []})

    ev_p, cb_p, logits_p = with_plain(plain_eval)

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
          **replay_report(vq_stats), seconds=time.perf_counter() - t_phase)
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
    s0w_shapes = launch_counts_by_shape()
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
    # the kernels line's rows: the GraphConv and LayerNorm launches by shape
    rows = {**GNN_ROWS, **S0_LN_ROWS}
    return {"schema_net_worker": {**s4_launches, **row_launches(s4_shapes, rows)[0]},
            "backbone_worker": {**s0w_launches, **row_launches(s0w_shapes, rows)[0]}}


def reference_deit_state(dim: int, classes: int, layers: int = 12, seed: int = 0) -> dict:
    """A reference-named ViT/DeiT state dict at 224^2, patch 16, FFN 4 d, from
    a seed (fp32): the reference's module tree (``transformer.layers.N.
    attention.linear_qkv.weight`` ...), Linear weights [out, in], the conv
    OIHW, ``pos_embed.pos_embed`` [n, 1, d], as ``weights/deit_*_patch16_224.pth``
    holds under its ``model`` entry."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape, scale=0.02):
        return torch.randn(*shape, generator=g) * scale

    sd = {"cls_token": t(1, 1, dim), "pos_embed.pos_embed": t(L_INST + 1, 1, dim),
          "patch_embed.proj.weight": t(dim, 3, PATCH, PATCH), "patch_embed.proj.bias": t(dim),
          "transformer.norm.weight": 1 + t(dim), "transformer.norm.bias": t(dim),
          "cls_head.weight": t(classes, dim), "cls_head.bias": t(classes)}
    for i in range(layers):
        p = f"transformer.layers.{i}."
        sd.update({p + "attention.linear_qkv.weight": t(3 * dim, dim, scale=dim**-0.5),
                   p + "attention.linear_qkv.bias": t(3 * dim),
                   p + "attention.linear_out.weight": t(dim, dim, scale=dim**-0.5),
                   p + "attention.linear_out.bias": t(dim),
                   p + "mlp.linear1.weight": t(4 * dim, dim, scale=dim**-0.5),
                   p + "mlp.linear1.bias": t(4 * dim),
                   p + "mlp.linear2.weight": t(dim, 4 * dim, scale=(4 * dim) ** -0.5),
                   p + "mlp.linear2.bias": t(dim),
                   p + "norm1.weight": 1 + t(dim), p + "norm1.bias": t(dim),
                   p + "norm2.weight": 1 + t(dim), p + "norm2.bias": t(dim)})
    return sd


def save_reference(path: str, sd: dict) -> str:
    """``sd`` as the reference's checkpoints wrap it: a ``model`` entry,
    ``module.`` prefixes."""
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)
    return path


HEAD_LAX = ["cls_head.weight", "cls_head.bias"]


def cli_phase(work_dir: str, has_networkx: bool, card_note: dict, device: str = "cuda") -> dict:
    """Phase 32: the stage chain through the command line at CIFAR DeiT-Tiny's
    full width (12 layers, d 192, M 1024, K 100) on the synthetic dataset
    (128 training images at 32^2 resized to 224^2 on the card, 64 for
    validation; one epoch of 2 steps a worker), configs written as JSON:
    ``train`` (backbone_worker from a reference-named ``.pth`` with a
    1000-class head, the head in ``lax_names``), ``extract``, ``export``,
    ``init``, ``train`` (schema_net_worker), each through ``cli.main`` in
    this process with its launches counted; then ``serve --explain --out``
    (and ``--graph-sample 0`` where networkx is present) as ``python -m
    schemanet_torch.cli`` in a subprocess; its ``.npz`` must equal
    ``load_serve_predictor(...).predict`` and ``.explain`` in this process bit
    for bit. Then (phase 46's command line) ``extract --quant-int8`` in this
    process and ``serve --quant-int8 --out`` in a subprocess, whose logits
    must equal ``load_serve_predictor(..., quant_int8=True).predict`` bit
    for bit. ``device`` goes to every call's ``--device`` (the default,
    cuda, on the card). Returns each stage's seconds."""
    import logging

    from schemanet_torch import cli, load_serve_predictor
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts

    root = os.path.join(work_dir, "cli")
    os.makedirs(os.path.join(root, "datasets"))

    def write(name, cfg):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            json.dump(cfg, f)
        return path

    write("datasets/synthetic.json",
          {"name": "synthetic", "num_classes": NUM_CLASSES, "image_size": 32, "resize": IMG,
           "train": {"num_samples": 2 * BATCH}, "val": {"num_samples": BATCH}})
    layers = STAGE0_CFG["model"]["transformer"]["num_encoder_layers"]
    pth = save_reference(os.path.join(root, "deit_tiny_patch16_224.pth"),
                         reference_deit_state(EMBED_DIM, 1000, layers))
    loop = {"train_epochs": 1, "batch_size": BATCH, "num_workers": 4, "val_interval": 1000,
            "max_keep": 1}
    val = {"batch_size": BATCH, "num_workers": 4}
    vanilla = write("vanilla.json", {
        "dataset": "datasets/synthetic.json", "training": dict(STAGE0_CFG["training"], **loop),
        "validation": val, "model": dict(STAGE0_CFG["model"], pre_train=pth, lax_names=HEAD_LAX),
        "loss": STAGE0_CFG["loss"]})
    ingredient = write("ingredient.json", {"dataset": "datasets/synthetic.json",
                                           "model": STAGE0_CFG["model"],
                                           "discretization": STAGE1_CFG["discretization"]})
    schema_cfg = dict(SCHEMA_CFG, bundle=os.path.join(root, "bundle"),
                      initial_state_fp=os.path.join(root, "atlas.pt"))
    schema = write("schema.json", {
        "dataset": "datasets/synthetic.json",
        "training": dict(TRAIN_CFG, dtype="bfloat16", **loop), "validation": val,
        "schema_net": schema_cfg, "loss": dict(LOSS_CFG, weight_dict=LOSS_WEIGHTS)})
    codes = os.path.join(root, "codes", f"cluster_{NUM_CODES}_from_{2 * BATCH * L_INST}.npy")
    s0_ckpt, s4_ckpt = os.path.join(root, "s0", "ckpt"), os.path.join(root, "s4", "ckpt")
    stages = [
        ("train_backbone_worker", ["train", "--cfg", vanilla, "--worker", "backbone_worker"],
         ("fused_mhsa", "fused_mhsa_bwd", "fused_mlp", "fused_mlp_bwd", "fused_layernorm",
          "fused_layernorm_bwd", "attn_block", "ffn_block")),
        ("extract", ["extract", "--cfg", ingredient, "--ckpt", s0_ckpt, "--save-path",
                     os.path.dirname(codes), "--max-features", str(2 * BATCH * L_INST),
                     "--batch-size", str(BATCH)],
         ("attn_block", "ffn_block", "vq_assign")),
        ("export", ["export", "--cfg", ingredient, "--ckpt", s0_ckpt, "--vocabulary-fp", codes,
                    "--save-path", schema_cfg["bundle"], "--num-classes", str(NUM_CLASSES)], ()),
        ("init", ["init", "--cfg", schema, "--save-fp", schema_cfg["initial_state_fp"],
                  "--batch-size", str(BATCH // 2)],
         ("attn_block", "attn_block_hmean", "ffn_block", "vq_assign")),
        ("train_schema_net_worker", ["train", "--cfg", schema, "--worker", "schema_net_worker"],
         ("attn_block", "attn_block_hmean", "ffn_block", "vq_assign", "sym_conv", "sym_conv_bwd",
          "fused_layernorm", "fused_layernorm_bwd", "embed_grad", "adamw_project_rows")),
    ]
    log_dirs = {"train_backbone_worker": "s0", "train_schema_net_worker": "s4"}
    seconds = {}
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    logging.getLogger("schemanet_torch.train.workers").addHandler(handler)
    try:
        for stage, argv, want in stages:
            reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--seed", "0", "--device", device, "--log-dir",
                                  os.path.join(root, log_dirs.get(stage, stage))])
            torch.cuda.synchronize()
            seconds[stage] = time.perf_counter() - t0
            counts = {k: v for k, v in launch_counts().items() if v}
            phase("cli", stage=stage, exit_code=rc, seconds=seconds[stage], launches=counts)
            require(rc == 0, f"cli {stage}: exit code {rc}")
            require(all(counts.get(k, 0) > 0 for k in want),
                    f"cli {stage}: a kernel of {want} did not launch ({counts})")
    finally:
        logging.getLogger("schemanet_torch.train.workers").removeHandler(handler)
    loaded = any(m.startswith("loaded pretrain weights") for m in messages)
    require(loaded, "cli train backbone_worker: the pre_train file was not loaded")

    # 53. a kernels: entry from the command line: the stage-4 worker with
    # --override kernels.graphconv=xla runs the plain GraphConv, no sym_conv
    from schemanet_torch.ops import policy

    stage = "train_schema_net_worker kernels.graphconv=xla"
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["train", "--cfg", schema, "--worker", "schema_net_worker", "--override",
                       "kernels.graphconv=xla", "--seed", "0", "--device", device, "--log-dir",
                       os.path.join(root, "s4_graphconv_xla")])
        torch.cuda.synchronize()
        resolved = policy.resolve("graphconv")
    finally:
        policy.reset_policy()
    seconds[stage] = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    phase("cli", stage=stage, exit_code=rc, seconds=seconds[stage], launches=counts,
          graphconv=resolved)
    require(rc == 0 and resolved == "xla", f"cli {stage}: exit code {rc}, graphconv {resolved}")
    require(not counts.get("sym_conv") and not counts.get("sym_conv_bwd")
            and all(counts.get(k, 0) > 0 for k in ("attn_block", "ffn_block", "vq_assign",
                                                    "fused_layernorm", "embed_grad",
                                                    "adamw_project_rows")),
            f"cli {stage}: launches {counts}")
    require(os.path.isfile(codes) and os.path.isfile(codes.replace(".npy", ".pth")),
            f"cli extract: {codes} or its .pth is missing")

    n_images = MICROBATCH + 6  # two microbatches, the second padded
    npz = os.path.join(root, "served.npz")
    argv = [sys.executable, "-m", "schemanet_torch.cli", "serve", "--cfg", schema, "--ckpt",
            s4_ckpt, "--images", f"synthetic:{n_images}", "--explain", "--out", npz,
            "--log-dir", os.path.join(root, "serve"), "--device", device]
    if has_networkx:
        argv += ["--graph-sample", "0"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    seconds["serve_subprocess"] = time.perf_counter() - t0
    top = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"index"')]
    phase("cli", stage="serve", exit_code=proc.returncode, seconds=seconds["serve_subprocess"],
          lines=len(top), stderr_tail=proc.stderr[-2000:] if proc.returncode else "")
    require(proc.returncode == 0, f"cli serve: exit code {proc.returncode}")
    require(len(top) == n_images, f"cli serve printed {len(top)} top-k lines, not {n_images}")
    graphml = npz + ".sample0.graphml"
    require(not has_networkx or os.path.isfile(graphml), "cli serve: no GraphML written")

    # the same server in this process, with the subprocess's PyTorch defaults
    # (cuDNN convolutions in TF32: the fp32 patch embedding)
    saved = np.load(npz)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        server = load_serve_predictor(schema_cfg["bundle"], schema_cfg, s4_ckpt, NUM_CLASSES,
                                      microbatch=MICROBATCH, device=device)
        images = np.random.default_rng(0).normal(size=(n_images, IMG, IMG, 3)).astype(np.float32)
        reset_launch_counts()
        logits = server.predict(images)
        explained = server.explain(images)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    equal = {"logits": bool(np.array_equal(saved["logits"], logits)),
             **{k: bool(np.array_equal(saved[k], v)) for k, v in explained.items()}}
    phase("cli_serve_vs_in_process", images=n_images, keys=sorted(saved.files), bitwise=equal,
          attribution_shape=list(saved["attribution"].shape), launches=counts,
          graphml=has_networkx, **card_note)
    require(all(equal.values()), f"cli serve .npz differs from the in-process server: {equal}")
    require(all(counts.get(k, 0) > 0 for k in ("attn_block", "attn_block_hmean", "ffn_block",
                                               "vq_assign", "sym_conv", "fused_layernorm")),
            f"serving from the CLI's files: a kernel did not launch ({counts})")
    del server
    torch.cuda.empty_cache()

    # 46 (the int8 route's command line): extract and serve with --quant-int8
    int8_route = ("quantize_rows", "int8_gemm", "fused_layernorm", "fused_mhsa", "vq_assign")
    codes_int8 = os.path.join(root, "codes_int8", os.path.basename(codes))
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["extract", "--cfg", ingredient, "--ckpt", s0_ckpt, "--save-path",
                   os.path.dirname(codes_int8), "--max-features", str(2 * BATCH * L_INST),
                   "--batch-size", str(BATCH), "--quant-int8", "--seed", "0", "--device", device,
                   "--log-dir", os.path.join(root, "extract_int8")])
    torch.cuda.synchronize()
    seconds["extract_int8"] = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    phase("cli", stage="extract --quant-int8", exit_code=rc, seconds=seconds["extract_int8"],
          launches=counts)
    require(rc == 0 and os.path.isfile(codes_int8), f"cli extract --quant-int8: exit code {rc}")
    require(all(counts.get(k, 0) > 0 for k in int8_route)
            and not counts.get("attn_block") and not counts.get("ffn_block"),
            f"cli extract --quant-int8: not on the int8 route ({counts})")
    npz_int8 = os.path.join(root, "served_int8.npz")
    argv = [sys.executable, "-m", "schemanet_torch.cli", "serve", "--cfg", schema, "--ckpt",
            s4_ckpt, "--images", f"synthetic:{n_images}", "--quant-int8", "--out", npz_int8,
            "--log-dir", os.path.join(root, "serve_int8"), "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    seconds["serve_int8_subprocess"] = time.perf_counter() - t0
    phase("cli", stage="serve --quant-int8", exit_code=proc.returncode,
          seconds=seconds["serve_int8_subprocess"],
          stderr_tail=proc.stderr[-2000:] if proc.returncode else "")
    require(proc.returncode == 0, f"cli serve --quant-int8: exit code {proc.returncode}")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        server = load_serve_predictor(schema_cfg["bundle"], schema_cfg, s4_ckpt, NUM_CLASSES,
                                      microbatch=MICROBATCH, device=device, quant_int8=True)
        reset_launch_counts()
        logits_int8 = server.predict(images)
        counts = {k: v for k, v in launch_counts().items() if v}
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    saved_int8 = np.load(npz_int8)["logits"]
    same = bool(np.array_equal(saved_int8, logits_int8))
    phase("cli_serve_int8_vs_in_process", images=n_images, bitwise=same, launches=counts,
          differs_from_unquantised=not np.array_equal(saved_int8, saved["logits"]), **card_note)
    require(same, "cli serve --quant-int8 logits differ from the in-process int8 server")
    require(all(counts.get(k, 0) > 0 for k in int8_route) and not counts.get("attn_block"),
            f"serving --quant-int8: not on the int8 route ({counts})")
    del server
    torch.cuda.empty_cache()
    return seconds


def pretrained_phase(dev, work_dir: str, card_note: dict) -> None:
    """Phase 33: the pretrained loader at DeiT-Small's real shape: a
    reference-named ``.pth`` from a seed (12 layers, d 384, 1000 classes)
    into a 100-class ``backbone_trainer`` (``configs/imagenet/vanilla/
    deit_small.yaml`` with ``pre_train`` and the head in ``lax_names``):
    every loaded tensor equals the file's after the layout change bit for
    bit, the head keeps its local initialisation, and one bf16 stage-0 step
    is finite."""
    from schemanet_torch.models.vit import get_model
    from schemanet_torch.schema import init_parameters_
    from schemanet_torch.train import backbone_trainer

    sd = reference_deit_state(384, 1000, seed=33)
    path = save_reference(os.path.join(work_dir, "deit_small_patch16_224.pth"), sd)
    cfg = vanilla_cfg(384, 6)
    cfg["model"] = dict(cfg["model"], pre_train=path, lax_names=HEAD_LAX)
    t0 = time.perf_counter()
    tr = backbone_trainer(cfg, IN_STEPS_PER_EPOCH, seed=0, device=dev, num_classes=100)
    load_s = time.perf_counter() - t0
    got = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    local = init_parameters_(get_model(cfg["model"], 100),
                             torch.Generator().manual_seed(0)).state_dict()
    loaded = {k: bool(torch.equal(got[k], v.permute(1, 0, 2) if k == "pos_embed.pos_embed" else v))
              for k, v in sd.items() if k not in HEAD_LAX}
    head_local = all(torch.equal(got[k], local[k]) for k in HEAD_LAX)
    g = torch.Generator().manual_seed(33)
    batch = {"image": torch.randn(BATCH, IMG, IMG, 3, generator=g).to(dev),
             "label": torch.randint(0, 100, (BATCH,), generator=g).to(dev)}
    loss = tr.train_iter(batch)["loss"].item()
    phase("pretrained_deit_small", tensors=len(sd), loaded_bitwise=sum(loaded.values()),
          same_keys=set(got) == set(sd), head_keeps_local_init=head_local, step_loss=loss,
          load_s=load_s, **card_note)
    require(set(got) == set(sd) and all(loaded.values()),
            f"pretrained load: keys differ or tensors differ from the file: "
            f"{[k for k, v in loaded.items() if not v][:5]}")
    require(head_local, "pretrained load: the head in lax_names did not keep its local init")
    require(np.isfinite(loss), f"pretrained stage-0 step: loss {loss}")
    del tr
    torch.cuda.empty_cache()


# ImageNet from folders of JPEGs (phases 34-39): a fake ImageNet tree of the
# JPEG fixtures' ImageNet-sized photos (tests/fixtures/jpeg/photo_*, written
# by tools/make_jpeg_fixtures.py), 1000 class folders of 6 training images
# and 1 validation image; stage 1 at configs/imagenet/ingredient/
# deit_small-l9-M_8000.yaml at the CLI's defaults (not cut), stage 3 at
# configs/imagenet/schema_net/deit_small-l9-M_8000.yaml's ir_atlas (K 1000,
# V_max 500, M 8000; cut to about 2 images a class), then 2 worker steps
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "jpeg")
REFUSED_FIXTURES = ("cmyk_160x120.JPEG", "png_named_jpeg_130x90.JPEG")
IF_TRAIN_PER_CLASS, IF_VAL_PER_CLASS, IF_LOADER_BATCHES = 6, 1, 20
IF_S3_IMAGES, IF_S3_BATCH = 2000, 32  # the CLI's init batch
IMAGENET_TRAIN = 1_281_167
NVJPEG_TOL = {"max_levels": 3, "mean_levels": 0.2}  # measured on the fixtures on an H100
IN_STAGE1_CFG = {  # configs/imagenet/ingredient/deit_small-l9-M_8000.yaml
    "dataset": {"name": "imagenet", "num_classes": IN_CLASSES},
    "model": vit_cfg(384, 6, None),
    "discretization": {"vocabulary": {"size": IN_CODES, "dim": 384},
                       "encoder_layer": f"module.transformer.layers.{ENCODE_LAYER}"},
}


def device_ms_of(fn, iters: int = TIME_ITERS):
    """The profiler's device ms a call of fn, after a call to warm it (main's
    ``device_ms``: CUDA activity only, every device event of ``iters``
    calls). A session without device events is printed and taken again;
    after five, None (not measured): a time, not a check."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(device_time_by_name(prof).values())
        if busy_us:
            return busy_us / iters / 1e3
        phase("profile_empty", attempt=attempt, iters=iters)
    return None


def imagefolder_phases(dev, work_dir: str, card_note: dict, path_launches: dict) -> dict:
    """Phases 34-39: the JPEG decode route, the crop/flip/resize kernel, the
    image-folder loader on a fake ImageNet tree, stage 1 and stage 3 of the
    ImageNet DeiT-Small configuration fed from it, and 2 steps of
    ``schema_net_worker`` from it; then the kernels-line rows this slice
    adds (the image kernels, the fp32 ViT kernels and VQ at 384 wide and
    M 8000, ``fused_mhsa`` at 384 and 768, whose launches come from phases
    29 and 30 through ``path_launches``). Returns the rows and each phase's
    seconds."""
    import importlib.util

    from schemanet_torch.data import jpeg
    from schemanet_torch.data.augment import get_crop_params_fn
    from schemanet_torch.data.datasets import get_dataset, make_partial
    from schemanet_torch.data.loader import DataLoader, build_loaders, device_prefetch
    from schemanet_torch.models.vit import get_model
    from schemanet_torch.ops import kmeans
    from schemanet_torch.ops.kernels import attention as ak
    from schemanet_torch.ops.kernels import encoder_block as eb
    from schemanet_torch.ops.kernels import imagepipe as ipk
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts
    from schemanet_torch.ops.kernels import vq as vqk
    from schemanet_torch.pipeline import (collect_mid_features, extract_stage, init_stage,
                                          save_atlas_init, save_bundle)
    from schemanet_torch.train import LaunchArgs, Trainer, schema_net_worker

    seconds, rows, errors = {}, {}, {}
    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(34)

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = now - t_phase
        t_phase = now
        phase("phase_seconds", phase_name=name, seconds=seconds[name], **card_note)

    def row(name, work, ms, plain_ms, launches, library_ms=None, **extra):
        bound_ms, bound_by = least_ms(*work)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, launches=launches,
                          max_abs_err=errors.get(name, 0.0))
        phase("kernel_time", kernel=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=library_ms, launches=launches, **extra, **card_note)

    def read(name):
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            return f.read()

    photos = sorted(f for f in os.listdir(FIXTURE_DIR) if f.startswith("photo_"))
    route = jpeg.decode_route()
    require(route is not None, "no JPEG decode route: neither libjpeg's header nor nvJPEG")

    def decode_batch(blobs):
        """(packed device pixels, offsets) of JPEG files on this route."""
        if route == jpeg.NVJPEG:
            return jpeg.decode_to_device(blobs, dev)
        images = [jpeg.decode_jpeg(b) for b in blobs]
        offsets = np.cumsum([0] + [im.size for im in images])[:-1].tolist()
        return torch.from_numpy(np.concatenate([im.reshape(-1) for im in images])).to(dev), \
            offsets

    # the rows' kernel times, on data of the path's shapes
    timed = {}

    def time_row(name, work, kernel, plain, plain_iters=TIME_ITERS, library=None, **extra):
        timed[name] = dict(work=work, ms=time_ms(kernel, TIME_ITERS),
                           plain_ms=time_ms(plain, plain_iters, warmup=1),
                           library_ms=None if library is None else time_ms(library, TIME_ITERS),
                           device_ms=device_ms_of(kernel), extra=extra)
        if library is not None:
            extra["library_device_ms"] = device_ms_of(library)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    # a batch of 64 of the ImageNet-sized photos (4:2:0, sizes in their
    # names), as random pixels and planes: crop_resize with the training
    # crop parameters, ycc_to_rgb
    photo_hw = [tuple(int(v) for v in photos[i % len(photos)][:-5].split("_")[-1].split("x"))[
        ::-1] for i in range(BATCH)]
    pix_off = np.cumsum([0] + [h * w * 3 for h, w in photo_hw])
    rand_pixels = torch.randint(0, 256, (int(pix_off[-1]),), generator=g, dtype=torch.uint8).to(dev)
    rrc = get_crop_params_fn("imagenet", "train")
    crop_train = np.asarray([(pix_off[j], h, w, *rrc((h, w, 3), np.random.default_rng(1000 + j)))
                             for j, (h, w) in enumerate(photo_hw)], np.int64)
    window_bytes = int((crop_train[:, 5] * crop_train[:, 6] * 3).sum())
    time_row("crop_resize", (0, window_bytes + BATCH * IMG * IMG * 3, "float32"),
             lambda: ipk.crop_resize(rand_pixels, crop_train, IMG),
             lambda: ipk.crop_resize_reference(rand_pixels, crop_train, IMG), 2,
             images=BATCH, out=IMG, window_bytes=window_bytes)
    ycc_meta, at, out_at = [], 0, 0
    for h, w in photo_hw:
        ch, cw = -(-h // 2), -(-w // 2)
        ycc_meta.append((at, at + h * w, at + h * w + ch * cw, h, w, cw, ch, 2, 2, out_at))
        at, out_at = at + h * w + 2 * ch * cw, out_at + h * w * 3
    rand_planes = torch.randint(0, 256, (at,), generator=g, dtype=torch.uint8).to(dev)
    if route == jpeg.NVJPEG:
        time_row("ycc_to_rgb", (0, at + out_at, "float32"),
                 lambda: ipk.ycc_to_rgb(rand_planes, ycc_meta, out_at),
                 lambda: ipk.ycc_to_rgb_reference(rand_planes, ycc_meta, out_at), 2, images=BATCH)
    del rand_pixels, rand_planes
    # the fp32 ViT kernels at 384 (stage 1's batch; the head-mean at stage
    # 3's), VQ at M 8000 (a minibatch and the Lloyd sample), each checked
    # against its plain version here and timed
    for name, bs_, hmean in (("attn_block_fp32_d384", BATCH, False),
                             ("attn_block_fp32_hmean_d384", IF_S3_BATCH, True)):
        args = (rnd(bs_, L_INST + 1, 384), 1 + rnd(384, scale=0.1), rnd(384, scale=0.1),
                rnd(3 * 384, 384, scale=384 ** -0.5), rnd(3 * 384, scale=0.1),
                rnd(384, 384, scale=384 ** -0.5), rnd(384, scale=0.1), 6)
        kw = {"capture_hmean": True} if hmean else {}
        got, want = eb.attn_block(*args, **kw), eb.attn_block_reference(*args, **kw)
        got, want = (got if isinstance(got, tuple) else (got,)), (
            want if isinstance(want, tuple) else (want,))
        errors[name] = max(rel_err(a, b) for a, b in zip(got, want))
        require(errors[name] <= FP32_TOL, f"{name}: {errors[name]}")
        time_row(name, attn_work(args, hmean=hmean), lambda: eb.attn_block(*args, **kw),
                 lambda: eb.attn_block_reference(*args, **kw), shape=[bs_, L_INST + 1, 384])
    ffn_args = (rnd(BATCH, L_INST + 1, 384), 1 + rnd(384, scale=0.1), rnd(384, scale=0.1),
                rnd(1536, 384, scale=384 ** -0.5), rnd(1536, scale=0.1),
                rnd(384, 1536, scale=1536 ** -0.5), rnd(384, scale=0.1))
    errors["ffn_block_fp32_d384"] = rel_err(eb.ffn_block(*ffn_args),
                                            eb.ffn_block_reference(*ffn_args))
    require(errors["ffn_block_fp32_d384"] <= FP32_TOL, "ffn_block fp32 at 384")
    time_row("ffn_block_fp32_d384", ffn_work(ffn_args), lambda: eb.ffn_block(*ffn_args),
             lambda: eb.ffn_block_reference(*ffn_args), shape=[BATCH, L_INST + 1, 384])
    codebook = rnd(IN_CODES, 384)
    for name, rows_ in (("vq_assign_fp32_m8000", 1024), ("vq_assign_fp32_m8000_lloyd", S1_LLOYD)):
        x = rnd(rows_, 384)
        iters = TIME_ITERS if rows_ == 1024 else 3
        time_row(name, vq_work(x, codebook), lambda: vqk.vq_assign_kernel(x, codebook),
                 lambda: vqk.vq_assign_reference(x, codebook), iters,
                 shape=[[rows_, 384], [IN_CODES, 384]])
        del x
    # fused_mhsa at 384 and 768 (DeiT-Small's and DeiT-Base's stage 0,
    # dropout 0.1), beside SDPA at p = 0
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dim, heads_ in ((384, 6), (768, 12)):
        hd, n_ = dim // heads_, L_INST + 1
        qkv = rnd(BATCH, n_, 3 * dim).to(torch.bfloat16)
        g_att = rnd(BATCH, n_, dim).to(torch.bfloat16)
        att = 2 * BATCH * heads_ * n_ * n_ * hd
        q, k_, v = qkv.view(BATCH, n_, 3, heads_, hd).permute(2, 0, 3, 1, 4)
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k_, v))
        g_heads = g_att.view(BATCH, n_, heads_, hd).transpose(1, 2)
        sdpa_out = sdpa(qg, kg, vg)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa_out, (qg, kg, vg), g_heads, retain_graph=True)

        for name, kernel, plain, args, work, lib in (
                (f"fused_mhsa_d{dim}", ak.fused_mhsa, ak.fused_mhsa_reference,
                 (qkv, heads_, S0_DROPOUT, S0_SEED), (2 * att, nbytes(qkv, g_att)),
                 lambda: sdpa(q, k_, v)),
                (f"fused_mhsa_bwd_d{dim}", ak.fused_mhsa_bwd, ak.fused_mhsa_bwd_reference,
                 (qkv, g_att, heads_, S0_DROPOUT, S0_SEED),
                 (5 * att, 2 * nbytes(qkv) + nbytes(g_att)), sdpa_bwd)):
            with torch.no_grad():
                errors[name] = rel_err(kernel(*args), plain(*args))
            require(errors[name] <= BF16_TOL, f"{name}: {errors[name]}")
            time_row(name, (*work, "bfloat16"), lambda: kernel(*args), lambda: plain(*args), 3,
                     library=lib, dropout=S0_DROPOUT, library_note="SDPA at p = 0")
        del qkv, g_att, q, k_, v, qg, kg, vg, sdpa_out
    torch.cuda.empty_cache()
    lap("34_times")

    # 34 (a). the decode route on the fixtures against their libjpeg pixels
    pixels = np.load(os.path.join(FIXTURE_DIR, "pixels.npz"))
    names = sorted(pixels.files)
    blobs = [read(f"{n}.JPEG") for n in names]
    captured = []

    def spy(planes, meta, total):
        out = ycc_kernel(planes, meta, total)
        captured.append((planes, np.asarray(meta), total, out))
        return out

    ycc_kernel = ipk.ycc_to_rgb
    with mock.patch.object(ipk, "ycc_to_rgb", spy):
        packed, offsets = decode_batch(blobs)
        packed2, _ = decode_batch(blobs)
    diffs = {}
    for n, off in zip(names, offsets):
        want = pixels[n].astype(np.int32)
        got = packed[off:off + want.size].cpu().numpy().reshape(want.shape).astype(np.int32)
        d = np.abs(got - want)
        diffs[n] = (int(d.max()), float(d.mean()))
    worst_max = max(v[0] for v in diffs.values())
    worst_mean = max(v[1] for v in diffs.values())
    decode_same = bool(torch.equal(packed, packed2))
    ycc_same = None
    if route == jpeg.NVJPEG:
        planes, meta, total, out_k = captured[0]
        ycc_same = bool(torch.equal(out_k.cpu(), ipk.ycc_to_rgb_reference(planes.cpu(), meta,
                                                                           total)))
        errors["ycc_to_rgb"] = float((out_k.cpu().int() - ipk.ycc_to_rgb_reference(
            planes.cpu(), meta, total).int()).abs().max())
    has_pillow = importlib.util.find_spec("PIL") is not None
    refused = {}
    for name in REFUSED_FIXTURES:
        try:
            img = jpeg.read_image(os.path.join(FIXTURE_DIR, name), dev)
            refused[name] = f"pillow {list(img.shape)}"
        except jpeg.RefusedImage as exc:
            refused[name] = "raised" if name in str(exc) else f"raised without the name: {exc}"
    phase("decode", route=route, files=len(names), max_level_diff=worst_max,
          max_mean_level_diff=worst_mean, run_to_run_bitwise=decode_same,
          ycc_to_rgb_bitwise_plain=ycc_same, refused=refused, pillow=has_pillow,
          tol=NVJPEG_TOL if route == jpeg.NVJPEG else "bitwise",
          worst_files=sorted(diffs.items(), key=lambda kv: -kv[1][1])[:4], **card_note)
    if route == jpeg.NVJPEG:
        require(worst_max <= NVJPEG_TOL["max_levels"]
                and worst_mean <= NVJPEG_TOL["mean_levels"],
                f"nvJPEG's pixels off libjpeg's beyond {NVJPEG_TOL}: {worst_max}, {worst_mean}")
        require(ycc_same, "ycc_to_rgb differs from its plain version")
    else:
        require(worst_max == 0, "the host decode differs from the committed libjpeg pixels")
    require(decode_same, "the decode differs from run to run")
    require(all(v.startswith("pillow" if has_pillow else "raised") for v in refused.values())
            and "raised without the name" not in str(refused), f"refused files: {refused}")
    # a batch of 64 ImageNet-sized photos: the decode's images/s, the
    # colour kernel's time
    batch_blobs = [read(photos[i % len(photos)]) for i in range(BATCH)]
    captured.clear()
    with mock.patch.object(ipk, "ycc_to_rgb", spy):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        photo_pixels, photo_offsets = decode_batch(batch_blobs)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
    decode_ms_again = time_ms(lambda: decode_batch(batch_blobs), 3, warmup=1)
    photo_same = all(bool(torch.equal(photo_pixels, decode_batch(batch_blobs)[0]))
                     for _ in range(3))
    phase("decode_batch", route=route, images=BATCH, ms=decode_ms, ms_warm=decode_ms_again,
          images_per_s=BATCH / decode_ms_again * 1e3, run_to_run_bitwise=photo_same,
          **card_note)
    require(photo_same, "the decode of the photos' batch differs from run to run")
    del packed, packed2, captured
    lap("34_decode")

    # 35 (b). crop_resize against its plain version on the photos: train
    # (RRC + flip), val and identity parameters, and boxes at the edges
    sizes = [tuple(jpeg.jpeg_header(b)[:2]) for b in batch_blobs]

    def table(fn_or_boxes):
        out = []
        for j, ((h, w), off) in enumerate(zip(sizes, photo_offsets)):
            if callable(fn_or_boxes):
                t, l, ch, cw, f = fn_or_boxes((h, w, 3), np.random.default_rng(1000 + j))
            else:
                t, l, ch, cw, f = fn_or_boxes[j % len(fn_or_boxes)](h, w)
            out.append((off, h, w, t, l, ch, cw, int(f)))
        return np.asarray(out, np.int64)

    edge_boxes = [lambda h, w: (0, 0, h, w, 1), lambda h, w: (-4, -4, h, w, 0),
                  lambda h, w: (h - 7, w - 9, 7, 9, 1), lambda h, w: (0, w - 1, h, 1, 0),
                  lambda h, w: (h // 2, 0, h - h // 2 + 5, w + 3, 1)]
    crop_tables = {"train": table(get_crop_params_fn("imagenet", "train")),
                   "val": table(get_crop_params_fn("imagenet", "val")),
                   "identity": table(lambda shape, rng: (0, 0, shape[0], shape[1], False)),
                   "edges": table(edge_boxes)}
    crop_report = {}
    host_pixels = photo_pixels.cpu()
    for tag, crop in crop_tables.items():
        got = ipk.crop_resize(photo_pixels, crop, IMG)
        again = ipk.crop_resize(photo_pixels, crop, IMG)
        u = ipk.crop_resize_values(host_pixels, crop, IMG)
        want = u.clamp(0.0, 255.0).to(torch.uint8)
        diff = (got.cpu().int() - want.int()).abs()
        off = diff > 0
        at_ties = bool(((u - u.round()).abs()[off] <= 1e-4).all())
        crop_report[tag] = {"bytes": got.numel(), "differ": int(off.sum()),
                            "differ_at_ties_only": at_ties, "max_diff": int(diff.max()),
                            "run_to_run_bitwise": bool(torch.equal(got, again))}
        errors["crop_resize"] = max(errors.get("crop_resize", 0.0), float(diff.max()))
    phase("crop_resize_vs_plain", out=IMG, images=BATCH, cases=crop_report, **card_note)
    require(all(r["differ_at_ties_only"] and r["max_diff"] <= 1 and r["run_to_run_bitwise"]
                for r in crop_report.values()), f"crop_resize against its plain version: "
                                                f"{crop_report}")
    del photo_pixels, host_pixels
    lap("35_crop_resize")

    # 36 (c). the image-folder loader on a fake ImageNet tree
    tree = os.path.join(work_dir, "imagenet")
    t0 = time.perf_counter()
    k = 0
    for split, per in (("train", IF_TRAIN_PER_CLASS), ("val", IF_VAL_PER_CLASS)):
        for c in range(IN_CLASSES):
            folder = os.path.join(tree, split, f"n{c:08d}")
            os.makedirs(folder)
            for i in range(per):
                src, dst = os.path.join(FIXTURE_DIR, photos[k % len(photos)]), \
                    os.path.join(folder, f"n{c:08d}_{i}.JPEG")
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copyfile(src, dst)
                k += 1
    tree_s = time.perf_counter() - t0
    data_cfg = {"name": "imagenet", "root": tree, "resize": IMG}
    block = {"batch_size": BATCH, "num_workers": 8}
    train_loader, val_loader, n_classes = build_loaders(data_cfg, block, dict(block))
    require(n_classes == IN_CLASSES and train_loader.decode_route == route == val_loader.
            decode_route, "the fake tree's loaders")

    def loader_rate(loader, batches, epoch):
        loader.set_epoch(epoch)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = 0
        for b in device_prefetch(iter(loader), dev):
            image = loader.prepare(b["image"], b["crop"])
            got += 1
            if got == batches:
                break
        require(tuple(image.shape[1:]) == (IMG, IMG, 3) and image.dtype == torch.float32,
                "loader images")
        torch.cuda.synchronize()
        images = min(len(loader.dataset), got * BATCH)  # the padding of a last batch apart
        return images / (time.perf_counter() - t0), launch_counts(), got

    train_rates = []
    for epoch in (0, 1):
        rate, counts, got = loader_rate(train_loader, IF_LOADER_BATCHES, epoch)
        train_rates.append(rate)
    val_batches = len(val_loader)
    val_rate, val_counts, _ = loader_rate(val_loader, val_batches, 0)
    phase("loader_imagefolder", route=route, tree_images={"train": IN_CLASSES * IF_TRAIN_PER_CLASS,
                                                          "val": IN_CLASSES * IF_VAL_PER_CLASS},
          tree_seconds=tree_s, batch=BATCH, train_batches=IF_LOADER_BATCHES,
          train_images_per_s=train_rates, val_batches=val_batches, val_images_per_s=val_rate,
          crop_resize_launches=counts["crop_resize"], ycc_to_rgb_launches=counts["ycc_to_rgb"],
          num_workers=block["num_workers"], **card_note)
    require(counts["crop_resize"] == IF_LOADER_BATCHES and val_counts["crop_resize"] ==
            val_batches, f"loader launches: {counts}, {val_counts}")
    # device_prefetch decodes up to 2 batches ahead of the consumer, who
    # stops after IF_LOADER_BATCHES
    decoded = counts["ycc_to_rgb"]
    require(IF_LOADER_BATCHES <= decoded <= IF_LOADER_BATCHES + 2 if route == jpeg.NVJPEG
            else decoded == 0, f"the decode's colour kernel launched {decoded} times")
    lap("36_loader")

    # 37 (d). stage 1 at M 8000 from the tree: the CLI's defaults, not cut
    train_loader.set_epoch(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    bundle = extract_stage(IN_STAGE1_CFG, train_loader, seed=0, device=dev)
    torch.cuda.synchronize()
    s1_seconds = time.perf_counter() - t0
    s1_peak = torch.cuda.max_memory_allocated() / 2**30
    s1_launches = launch_counts()
    per_batch = BATCH * L_INST
    chunks = [min(per_batch, S1_FEATURES - i * per_batch)
              for i in range(-(-S1_FEATURES // per_batch))]
    minibatches = sum(-(-c // 1024) for c in chunks)
    expected = {name: 0 for name in s1_launches}
    expected.update({name: FROZEN_LAYERS * len(chunks) for name in (
        "attn_block", "attn_block_tc", "ffn_block", "ffn_block_tc")})
    expected.update({"vq_assign": minibatches + S1_LLOYD_ITERS,
                     "vq_assign_tc": minibatches + S1_LLOYD_ITERS,
                     "crop_resize": len(chunks),
                     "ycc_to_rgb": len(chunks) if route == jpeg.NVJPEG else 0})
    require(s1_launches == expected, f"ImageNet stage-1 launches {s1_launches} != {expected}")
    require(bool(torch.isfinite(bundle.codebook).all())
            and tuple(bundle.codebook.shape) == (IN_CODES, 384), "ImageNet stage-1 codebook")
    backbone = get_model(IN_STAGE1_CFG["model"], IN_CLASSES)
    backbone.load_state_dict(bundle.backbone_state)
    backbone.requires_grad_(False).to(dev)
    train_loader.set_epoch(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = collect_mid_features(backbone, train_loader, ENCODE_LAYER, S1_FEATURES)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    held = feats[:S1_LLOYD]
    inertia = kmeans.kmeans_inertia(bundle.codebook, held).item()
    init_rows = max(4 * IN_CODES, 4096)
    init_state = kmeans.kmeans_init(torch.Generator().manual_seed(0), feats[:init_rows],
                                    IN_CODES)
    mb = feats[:1024]
    minibatch_ms = time_ms(lambda: kmeans.minibatch_step(init_state, mb), TIME_ITERS)
    lloyd_ms = time_ms(lambda: kmeans.lloyd_step(bundle.codebook, held), 3, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kmeans.kmeans_init(torch.Generator().manual_seed(0), feats[:init_rows], IN_CODES)
    torch.cuda.synchronize()
    plusplus_ms = (time.perf_counter() - t0) * 1e3
    phase("stage1_imagenet_fp32", route=route, features=len(feats), batches=len(chunks),
          batch=BATCH, codes=IN_CODES, width=384, seconds=s1_seconds, launches=s1_launches,
          expected=expected, collect_features_per_s=len(feats) / collect_s,
          collect_seconds=collect_s, minibatch_steps=minibatches, minibatch_step_ms=minibatch_ms,
          lloyd_iterations=S1_LLOYD_ITERS, lloyd_rows=S1_LLOYD, lloyd_step_ms=lloyd_ms,
          kmeans_pp_rows=init_rows, kmeans_pp_ms=plusplus_ms, final_inertia=inertia,
          peak_mem_gb=s1_peak, **card_note)
    require(np.isfinite(inertia), f"ImageNet stage-1 inertia {inertia}")
    train_loader.set_epoch(0)
    plain_feats = with_plain(lambda: collect_mid_features(backbone, train_loader, ENCODE_LAYER,
                                                          2 * per_batch))
    feat_err = rel_err(feats[:len(plain_feats)], plain_feats)
    del plain_feats
    lock, agree = kmeans_vs_plain(feats, held, init_state, IN_CODES, with_plain)
    phase("stage1_imagenet_fp32_vs_plain", feature_rel_err=feat_err, id_agreement=agree,
          tol={"features": FP32_TOL, "ids": 0.999, "near_tie": 1e-5, "centers": 1e-4}, **lock)
    require(feat_err <= FP32_TOL, f"ImageNet stage-1 features differ by {feat_err} of max")
    require(agree >= 0.999, f"ImageNet stage-1 k-means ids agree on {agree} < 0.999")
    require(lock["near_ties_only"], "ImageNet stage-1 k-means: a mismatch is no near-tie")
    require(lock["center_err"] <= 1e-4, f"ImageNet stage-1 centers differ by "
                                        f"{lock['center_err']}")
    # VQ at M 8000 on the stage's features: the kernel's ids against the
    # plain version's (the largest near-tie gap, of the row's |score|)
    for name, x in (("vq_assign_fp32_m8000", mb), ("vq_assign_fp32_m8000_lloyd", held)):
        ids_k, ids_p = vqk.vq_assign_kernel(x, bundle.codebook), vqk.vq_assign_reference(
            x, bundle.codebook)
        gaps, scale = vqk.score_gaps(x, bundle.codebook, ids_k, ids_p)
        errors[name] = float((gaps / scale).max()) if len(gaps) else 0.0
        require(bool((gaps <= 1e-5 * scale).all()), f"{name}: a mismatch is no near-tie")
    del feats, held, init_state, mb, backbone
    torch.cuda.empty_cache()
    lap("37_stage1_imagenet")

    # 38 (e). stage 3 at K 1000 from the tree, cut to about 2 images a class
    s3_set = make_partial(get_dataset(data_cfg, "train"), IF_S3_IMAGES / (
        IN_CLASSES * IF_TRAIN_PER_CLASS))
    s3_loader = DataLoader(s3_set, IF_S3_BATCH, split="train", shuffle=True, drop_last=True,
                           seed=0, resize=IMG, num_workers=8)

    class Timed:
        """The loader, with the host seconds of each pass (to its last batch's end)."""

        def __init__(self, loader):
            self.loader, self.seconds = loader, []

        def __getattr__(self, attr):
            return getattr(self.loader, attr)

        def __iter__(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield from self.loader
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)

    s3_cfg = {"dataset": {"name": "imagenet", "num_classes": IN_CLASSES},
              "schema_net": IN_SCHEMA_CFG["schema_net"]}
    s3_timed = Timed(s3_loader)
    recorded = []
    s3_loader.set_epoch(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recording_vq(recorded):
        atlas = init_stage(s3_cfg, bundle, s3_timed, device=dev)
    torch.cuda.synchronize()
    s3_seconds = time.perf_counter() - t0
    s3_peak = torch.cuda.max_memory_allocated() / 2**30
    s3_launches = launch_counts()
    passes = 2 * len(s3_loader)
    expected = {name: 0 for name in s3_launches}
    expected.update({"attn_block": FROZEN_LAYERS * passes, "attn_block_hmean": passes,
                     "attn_block_tc": FROZEN_LAYERS * passes,
                     "ffn_block": FROZEN_LAYERS * passes, "ffn_block_tc": FROZEN_LAYERS * passes,
                     "vq_assign": passes, "vq_assign_tc": passes, "crop_resize": passes,
                     "ycc_to_rgb": passes if route == jpeg.NVJPEG else 0})
    require(s3_launches == expected, f"ImageNet stage-3 launches {s3_launches} != {expected}")
    replay_stats = {"rows": 0, "mismatches": 0, "near_ties_only": True}

    def plain_init():
        s3_loader.set_epoch(0)
        with replaying_vq(recorded, replay_stats):
            return init_stage(s3_cfg, bundle, s3_loader, device=dev)

    atlas_p = with_plain(plain_init)
    # At about 2 images a class two codes' class weights can sit within
    # fp32's rounding of each other, and the top-V_max sort may then order
    # them otherwise on the two sides. So: each class's code set equal, the
    # order apart only at such near-ties (the weights compared code by
    # code, the plain side's slots put in the kernel side's order)
    ing_k, ing_p = atlas["class_ingredients"].long(), atlas_p["class_ingredients"].long()
    same_sets = bool(torch.equal(ing_k.sort(dim=1).values, ing_p.sort(dim=1).values))
    order = torch.argsort(ing_p, dim=1)
    pos = torch.searchsorted(ing_p.gather(1, order), ing_k).clamp(max=ing_p.shape[1] - 1)
    perm = order.gather(1, pos)  # the plain side's slot of each of the kernel side's codes
    aligned = dict(atlas_p["params"])
    aligned["vertex_weights"] = aligned["vertex_weights"].gather(1, perm)
    e_p = aligned["edge_weights"].gather(1, perm[:, :, None].expand(-1, -1, perm.shape[1]))
    aligned["edge_weights"] = e_p.gather(2, perm[:, None, :].expand(-1, perm.shape[1], -1))
    del e_p
    atlas_err = {k: rel_err(atlas["params"][k], aligned[k]) for k in atlas["params"]}
    reordered = {"classes": int((ing_k != ing_p).any(dim=1).sum()),
                 "slots": int((ing_k != ing_p).sum())}
    del aligned
    ips = [len(s3_loader) * IF_S3_BATCH / sec for sec in s3_timed.seconds]
    phase("stage3_imagenet_fp32", route=route, classes=IN_CLASSES, v_max=IN_VMAX, codes=IN_CODES,
          batch=IF_S3_BATCH, batches_per_pass=len(s3_loader), seconds=s3_seconds,
          cut=f"{len(s3_loader) * IF_S3_BATCH} of ImageNet's {IMAGENET_TRAIN} training images "
              "a pass (about 2 a class)",
          images_per_s_per_pass=ips,
          full_dataset_seconds_extrapolated=sum(IMAGENET_TRAIN / r for r in ips),
          launches=s3_launches, expected=expected, peak_mem_gb=s3_peak,
          class_code_sets_equal=same_sets, reordered_at_near_ties=reordered,
          param_rel_err_code_by_code=atlas_err,
          **replay_report(replay_stats), tol={"params": 1e-5, "ids": 0.999},
          **card_note)
    require(same_sets, "ImageNet stage-3 classes' code sets differ from the plain versions'")
    require(all(err <= 1e-5 for err in atlas_err.values()),
            f"ImageNet stage-3 atlas differs: {atlas_err}")
    del atlas_p
    bundle_dir, atlas_path = os.path.join(work_dir, "bundle"), os.path.join(work_dir, "atlas.pt")
    save_bundle(bundle_dir, bundle.model_cfg, bundle.encode_layer, bundle.backbone_state,
                bundle.codebook, bundle.extra)
    save_atlas_init(atlas_path, atlas["params"], atlas["class_ingredients"])
    del atlas
    torch.cuda.empty_cache()
    lap("38_stage3_imagenet")

    # 39 (f). 2 bf16 steps of schema_net_worker from the tree on that bundle
    # and atlas: training cut to 128 images (the tree's partial), one
    # validation (at the end: no initial one), one checkpoint write
    part = 2 * BATCH / (IN_CLASSES * IF_TRAIN_PER_CLASS)
    worker_cfg = dict(IN_SCHEMA_CFG, dataset=dict(data_cfg, make_partial=part),
                      training=dict(IN_SCHEMA_CFG["training"], train_epochs=1, num_workers=8,
                                    val_interval=1000, max_keep=1),
                      validation=dict(block),
                      schema_net=dict(IN_SCHEMA_CFG["schema_net"], bundle=bundle_dir,
                                      initial_state_fp=atlas_path))
    calls = {"validations": 0}
    validate = Trainer.validate_and_save

    def counted_validation(self, *args, **kw):
        calls["validations"] += 1
        return validate(self, *args, **kw)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(Trainer, "validate_and_save", counted_validation), \
            mock.patch.object(Trainer, "__call__", functools.partialmethod(
                Trainer.__call__, initial_validation=False)):
        run = schema_net_worker(worker_cfg, LaunchArgs(log_dir=os.path.join(work_dir, "s4"),
                                                       device=dev.type))
    torch.cuda.synchronize()
    worker_s = time.perf_counter() - t0
    w_launches = launch_counts()
    tr = run["trainer"]
    ckpts = sorted(os.listdir(os.path.join(work_dir, "s4", "ckpt")))
    phase("schema_net_worker_imagefolder", route=route, steps=tr.step,
          validations=calls["validations"], eval={k: v for k, v in (run["eval"] or {}).items()
                                                  if isinstance(v, (int, float))},
          checkpoints=ckpts, crop_resize_launches=w_launches["crop_resize"],
          ycc_to_rgb_launches=w_launches["ycc_to_rgb"], sym_conv=w_launches["sym_conv"],
          seconds=worker_s, **card_note)
    require(tr.step == 2 and calls["validations"] == 1, f"worker: {tr.step} steps, "
                                                        f"{calls['validations']} validations")
    require(len([c for c in ckpts if c.startswith("iter-")]) == 1, f"worker checkpoints {ckpts}")
    require(w_launches["crop_resize"] >= 3 and w_launches["attn_block"] > 0,
            f"the worker's image kernels did not run: {w_launches}")
    del run, tr
    torch.cuda.empty_cache()
    lap("39_worker_imagefolder")

    # the rows: the times taken before the decode ran, the launches of the
    # paths above (stages 1 and 3; stage 0 for fused_mhsa, phases 29-30)
    path = {"crop_resize": s1_launches["crop_resize"], "ycc_to_rgb": s1_launches["ycc_to_rgb"],
            "attn_block_fp32_d384": s1_launches["attn_block"],
            "attn_block_fp32_hmean_d384": s3_launches["attn_block_hmean"],
            "ffn_block_fp32_d384": s1_launches["ffn_block"],
            "vq_assign_fp32_m8000": minibatches, "vq_assign_fp32_m8000_lloyd": S1_LLOYD_ITERS,
            **{k: v for k, v in path_launches.items() if k.startswith("fused_mhsa")}}
    for name, t in timed.items():
        row(name, t["work"], t["ms"], t["plain_ms"], path[name], t["library_ms"],
            device_ms=t["device_ms"], **t["extra"])
    return {"rows": rows, "seconds": seconds}


# -- 40-42: several ranks (parallel/mesh.py) ---------------------------------
GRID_STEPS = 2  # steps of each grid run
GRID_TIMEOUT_S = 600  # the two-rank run's wall-clock limit; a collective waits at most 300 s
GRID_ENV = "SCHEMANET_SMOKE_GRID"  # "<backend>,<device>" in a spawned rank's environment


def grid_layout():
    """(backend, device) of the two-rank phases: NCCL one card a rank where
    the host has two or more, else gloo with both ranks on ``cuda:0`` (NCCL
    refuses two ranks on one device): the kernels run on the card and the
    collectives through the host."""
    if torch.cuda.device_count() >= 2:
        return "nccl", "cuda"
    return "gloo", "cuda:0"


def in_stage4_cfg(dtype: str, highest: bool = False, optimizer: str = "adamw") -> dict:
    """IN_SCHEMA_CFG in ``dtype``; ``highest``: graph_precision 'highest'
    (the fp32 lock step's, as phase 28's); ``optimizer``: the training block
    of ``optimizer_training`` (phase 54)."""
    cfg = copy.deepcopy(IN_SCHEMA_CFG)
    cfg["training"] = optimizer_training(cfg["training"], optimizer)
    cfg["training"]["dtype"] = dtype
    if highest:
        cfg["schema_net"]["ir_atlas"]["graph_precision"] = "highest"
    return cfg


def in_stage4_state(bundle, ingredients) -> dict:
    """The state (fp32, on the CPU) of phase 27's predictor as
    ``schema_net_trainer`` builds it (seeded, the bundle's backbone and
    codebook), with ``ingredients`` as its class ingredients: made once, so
    each trainer of phases 40-41 loads it instead of drawing the 1.0 GB
    atlas again."""
    from schemanet_torch.train.workers import _schema_cfg, _schema_predictor

    model = _schema_predictor(_schema_cfg(IN_SCHEMA_CFG), bundle, IN_CLASSES, torch.float32, 0)
    with torch.no_grad():
        model.schema_net.class_ingredients.copy_(ingredients)
    return model.state_dict()


def in_stage4_trainer(state: dict, dtype: str, dev, mesh=None, highest=False,
                      optimizer: str = "adamw"):
    """Phase 27's stage-4 trainer in ``dtype`` from ``state``, on ``mesh``
    or in one process: the predictor and ``Trainer`` that
    ``schema_net_trainer`` builds, under ``optimizer`` (phase 54). ``dtype``
    "float64": parameters and compute in fp64 (for the plain versions, as
    phase 28's fp64 step)."""
    from schemanet_torch.schema import build_predictor, get_loss_fn
    from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig
    from schemanet_torch.train.workers import _schema_cfg, resolve_dtype

    fp64 = dtype == "float64"
    cfg = in_stage4_cfg("float32" if fp64 else dtype, highest, optimizer)
    model = build_predictor(vit_cfg(384, 6, None), _schema_cfg(cfg), IN_CLASSES, IN_CODES, 384,
                            ENCODE_LAYER, dtype=torch.float64 if fp64 else resolve_dtype(dtype))
    if fp64:
        model = model.to(torch.float64)
    model.load_state_dict(state)
    return Trainer(TrainerConfig.from_cfg(cfg["training"], frozen_patterns=SCHEMA_NET_FROZEN),
                   model, get_loss_fn(cfg["loss"]), cfg["loss"]["weight_dict"],
                   IN_STEPS_PER_EPOCH, seed=0, device=dev, mesh=mesh)


def trainer_snapshot(tr) -> dict:
    """Every tensor a step reads and writes (this rank's shards): the
    model's state, the AdamW state (deep), the atlas moments, the step and
    the dropout generators."""
    return {"model": {k: v.detach().clone() for k, v in tr.model.state_dict().items()},
            "optimizer": copy.deepcopy(tr.optimizer.state_dict()),
            "hot": {k: {n: t.clone() for n, t in h.state.items()} for k, h in tr.hot.items()},
            "step": tr.step, "rng": (tr.rng.seeds.get_state(), tr.rng.masks.get_state())}


def restore_snapshot(tr, snap: dict) -> None:
    with torch.no_grad():
        tr.model.load_state_dict(snap["model"])
        for k, moments in snap["hot"].items():
            for n, t in moments.items():
                tr.hot[k].state[n].copy_(t)
    tr.optimizer.load_state_dict(copy.deepcopy(snap["optimizer"]))
    tr.step = snap["step"]
    tr.rng.seeds.set_state(snap["rng"][0])
    tr.rng.masks.set_state(snap["rng"][1])


def same_snapshots(a: dict, b: dict) -> list:
    """The names of the tensors two snapshots differ in, bit for bit."""
    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from flat(v, f"{prefix}/{i}")
        elif torch.is_tensor(tree):
            yield prefix, tree

    fa, fb = dict(flat(a)), dict(flat(b))
    return sorted(k for k in fa if k not in fb or not torch.equal(fa[k], fb[k]))


def grid_batches(seed: int, steps: int, classes: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"image": torch.from_numpy(rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, classes, size=BATCH))}
            for _ in range(steps)]


def sure_rule(got: dict, want: dict, sure: dict, bound: float) -> dict:
    """Phase 8's rules on whole tensors: entries whose one-process step-1
    gradient is large (|g| > 1e-3 max) within rtol 1e-4 / atol 1e-6, every
    entry within ``bound``."""
    out = {"sure_ok": True, "max_abs_diff_sure": 0.0, "max_abs_diff": 0.0}
    for k, w in want.items():
        diff = (got[k].float() - w.float()).abs()
        out["max_abs_diff"] = max(out["max_abs_diff"], diff.max().item())
        if sure[k].any():
            out["max_abs_diff_sure"] = max(out["max_abs_diff_sure"], diff[sure[k]].max().item())
            out["sure_ok"] &= bool((diff[sure[k]] <= 1e-6 + 1e-4 * w.float().abs()[sure[k]]).all())
    out["within_bound"] = out["max_abs_diff"] <= bound
    return out


def keep_reduced_gradients(tr) -> dict:
    """Makes ``tr``'s next step keep its gradients after ``reduce_gradients``
    (before the clip, which would hide a wrong scale), whole: a sharded
    parameter's gathered over the model group, so every rank of it calls
    this. Returns the dict that step fills."""
    from schemanet_torch.parallel.mesh import gather_like

    kept = {}

    def reduce_and_keep():
        del tr.reduce_gradients  # the class's method again from the next step on
        tr.reduce_gradients()
        kept.update({k: gather_like(p.grad, p).detach().clone()
                     for k, p in tr.model.named_parameters() if p.grad is not None})

    tr.reduce_gradients = reduce_and_keep
    return kept


def grad_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in fp64 (0 where both are 0)."""
    diff = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    return diff / scale if scale else (0.0 if diff == 0 else float("inf"))


GRAD_RULE = "1e-5 of max, else no farther from fp64 than one process's (+10%)"


def grad_rule(got: dict, want: dict, fp64) -> dict:
    """Phase 28's rule on a step's gradients, leaf by leaf: the grid's
    within 1e-5 of the leaf's max |g| of the one process's; else, where fp32
    resolves the leaf no finer (a sum split over ranks rounds otherwise), no
    farther from the fp64 gradient than the one process's, by more than 10%.
    ``fp64()`` gives the fp64 gradients; it runs only for such a leaf."""
    rel = {k: grad_rel(got[k], w) for k, w in want.items() if k in got}
    wide = sorted(k for k, r in rel.items() if r > 1e-5)
    out = {"leaves": len(want), "same_leaves": sorted(got) == sorted(want),
           "rel_err_max": max(rel.values(), default=0.0),
           "rel_err_max_leaf": max(rel, key=rel.get, default=None), "over_1e-5": wide}
    vs = {}
    if wide:
        g64 = fp64()
        vs = {k: {"rel_err": rel[k], "grid_vs_fp64": grad_rel(got[k], g64[k]),
                  "one_vs_fp64": grad_rel(want[k], g64[k])} for k in wide}
        out["vs_fp64"] = vs
    out["ok"] = out["same_leaves"] and all(
        c["grid_vs_fp64"] <= 1.1 * c["one_vs_fp64"] + 1e-6 for c in vs.values())
    return out


def stage4_fp64_grads(state: dict, batch: dict, ids: list, dev) -> dict:
    """The one-process stage-4 step's gradients on the plain versions in
    fp64 from ``state`` on ``batch``, the VQ taking ``ids`` (the fp32 step's)."""
    from schemanet_torch.schema.atlas import clamp_attribute_weights_

    t = in_stage4_trainer(state, "float64", dev, None, highest=True)
    b = {"image": batch["image"].to(dev, torch.float64), "label": batch["label"].to(dev)}
    stats = {"rows": 0, "mismatches": 0, "near_ties_only": True}

    def run():
        with replaying_vq(list(ids), stats):
            clamp_attribute_weights_(t.atlas)
            t.zero_grad()
            t.forward_loss(b)[0].backward()

    with_plain(run)
    replay_report(stats)
    return {k: p.grad for k, p in t.model.named_parameters() if p.grad is not None}


def stage0_fp64_grads(cfg: dict, batch: dict, dev) -> dict:
    """The one-process stage-0 first step's gradients on the plain versions
    in fp64: ``backbone_trainer``'s model from seed 0 made fp64, the
    dropout drawn as that trainer's first step draws it."""
    from schemanet_torch.schema import get_loss_fn
    from schemanet_torch.train import Trainer, TrainerConfig
    from schemanet_torch.train.workers import _backbone_model

    model = _backbone_model(cfg, IN_CLASSES, torch.float64, 0).to(torch.float64)
    t = Trainer(TrainerConfig.from_cfg(cfg["training"]), model, get_loss_fn(cfg["loss"]),
                cfg["loss"]["weight_dict"], IN_STEPS_PER_EPOCH, seed=0, device=dev)
    b = {"image": batch["image"].to(dev, torch.float64), "label": batch["label"].to(dev)}

    def run():
        t.zero_grad()
        t.forward_loss(b)[0].backward()

    with_plain(run)
    return {k: p.grad for k, p in t.model.named_parameters() if p.grad is not None}


def profiled_step(step) -> dict:
    """One ``step()`` under the profiler: the host wall ms, the device ms
    (CUDA activity, user annotations excluded), the idle share and the
    device ms of the top kernels; None for a session that came back
    without device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_time_by_name(prof)
    busy_ms = sum(by_kernel.values()) / 1e3
    if not busy_ms:
        return None
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "top_device_ms": {k[:80]: v / 1e3 for k, v in top}}


def grid_rank_main(work_dir: str) -> None:
    """One rank of phases 41-42 and 52 (``python3 chip_smoke.py --grid-rank DIR``,
    spawned by ``grid_phases`` with the rendezvous in the environment):
    writes ``DIR/rank<r>.json``; rank 0 also runs the one-process references
    and the comparisons."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import datetime

    from schemanet_torch.ops.kernels import (launch_counts, launch_counts_by_shape,
                                             reset_launch_counts)
    from schemanet_torch.parallel.mesh import gather_like, local_batch_slice, make_mesh
    from schemanet_torch.train import backbone_trainer
    from schemanet_torch.train.common import follows_split

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend, device = os.environ[GRID_ENV].split(",")
    timeout = datetime.timedelta(seconds=300)
    mesh_m = make_mesh(data=1, model=2, device=device, backend=backend, timeout=timeout)
    mesh_d = make_mesh(data=2, model=1, device=device, backend=backend, timeout=timeout)
    dev, rank = mesh_m.device, mesh_m.rank
    inputs = torch.load(os.path.join(work_dir, "inputs.pt"), weights_only=True)
    state = torch.load(os.path.join(work_dir, "state.pt"), weights_only=True, mmap=True)
    out = {"rank": rank, "device": str(dev), "backend": mesh_m.backend}
    t_phase = time.perf_counter()
    hot_names = ("schema_net.vertex_weights", "schema_net.edge_weights")

    def on(batch, sl=slice(None)):
        return {k: v[sl].to(dev) for k, v in batch.items()}

    # 41. mesh_model2: one fp32 lock step, model 2, from the seeded state
    b4 = inputs["stage4"]
    tr = in_stage4_trainer(state, "float32", dev, mesh_m, highest=True)
    state0 = trainer_snapshot(tr)
    grid_grads = keep_reduced_gradients(tr)
    loss = tr.train_iter(on(b4[0]))["loss"].item()
    first = trainer_snapshot(tr)
    restore_snapshot(tr, state0)
    loss_again = tr.train_iter(on(b4[0]))["loss"].item()
    run_to_run = same_snapshots(first, trainer_snapshot(tr)) + (
        [] if loss == loss_again else ["loss"])
    grid_hot = {k: gather_like(tr.hot[k].param.detach(), tr.hot[k].param) for k in hot_names}
    grid_params = {k: gather_like(p.detach(), p) for k, p in tr.model.named_parameters()
                   if p.requires_grad and k not in hot_names}
    shard_shape = list(tr.hot["schema_net.edge_weights"].param.shape)
    del tr, state0, first
    torch.cuda.empty_cache()
    out["lock"] = {"loss": loss, "run_to_run_differs": run_to_run[:20],
                   "edge_shard_shape": shard_shape}
    if rank == 0:  # the one-process step on the same state and batch
        ref = in_stage4_trainer(state, "float32", dev, None, highest=True)
        ids, want_grads = [], keep_reduced_gradients(ref)
        with recording_vq(ids):
            want_loss = ref.train_iter(on(b4[0]))["loss"].item()
        sure = {k: (p.grad.abs() > 1e-3 * p.grad.abs().max()) for k, p in
                ref.model.named_parameters() if p.requires_grad}
        want = {k: p.detach() for k, p in ref.model.named_parameters() if p.requires_grad}
        bound = 2 * IN_SCHEMA_CFG["training"]["optimizer"]["lr"]
        out["lock"].update(
            one_process_loss=want_loss, loss_rel_err=abs(loss - want_loss) / abs(want_loss),
            bound=bound, hot=sure_rule(grid_hot, {k: want[k] for k in hot_names}, sure, bound),
            rest=sure_rule(grid_params, {k: v for k, v in want.items() if k not in hot_names},
                           sure, bound),
            grads=grad_rule(grid_grads, want_grads,
                            lambda: stage4_fp64_grads(state, b4[0], ids, dev)))
        del ref, want, sure, want_grads
    del grid_hot, grid_params, grid_grads
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    out["lock"]["seconds"] = time.perf_counter() - t_phase

    # 41. mesh_model2: 2 bf16 steps at the shard's shapes
    t_phase = time.perf_counter()
    tr = in_stage4_trainer(state, "bfloat16", dev, mesh_m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    step_ms, losses = [], []
    for b in b4[:GRID_STEPS]:
        b = on(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.train_iter(b)["loss"].item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["bf16"] = {"losses": losses, "step_ms": step_ms, "launches": launch_counts(),
                   "launches_by_shape": {f"{name} {list(shape)}": n for name, by in
                                         launch_counts_by_shape().items()
                                         for shape, n in by.items()},
                   "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                   "moment_dtypes": {k: {n: str(t.dtype) for n, t in h.state.items()}
                                     for k, h in tr.hot.items()},
                   "edge_shard_shape": list(tr.hot["schema_net.edge_weights"].param.shape)}
    out["bf16"]["profiled"] = profiled_step(lambda: tr.train_iter(on(b4[0])))
    del tr
    torch.cuda.empty_cache()
    out["bf16"]["seconds"] = time.perf_counter() - t_phase

    # 54. factored AdamW on the model-2 grid: the edge weights factored over
    # their class axis, which is split; one fp32 step, the Adafactor
    # statistics and the atlas gathered, against one process's
    t_phase = time.perf_counter()
    tr = in_stage4_trainer(state, "float32", dev, mesh_m, highest=True, optimizer="adafactor")
    loss = tr.train_iter(on(b4[0]))["loss"].item()
    grid_state = {k: {n: (gather_like(t, h.param) if follows_split(n, h.param) else t).float()
                      for n, t in h.state.items()} for k, h in tr.hot.items()}
    grid_hot = {k: gather_like(h.param.detach(), h.param) for k, h in tr.hot.items()}
    local = {k: {n: list(t.shape) for n, t in h.state.items()} for k, h in tr.hot.items()}
    del tr
    torch.cuda.empty_cache()
    out["factored"] = {"loss": loss, "local_state_shapes": local}
    if rank == 0:
        ref = in_stage4_trainer(state, "float32", dev, None, highest=True, optimizer="adafactor")
        want_loss = ref.train_iter(on(b4[0]))["loss"].item()
        out["factored"].update(
            one_process_loss=want_loss, loss_rel_err=abs(loss - want_loss) / abs(want_loss),
            state_rel_err={f"{k} {n}": rel_err(t, ref.hot[k].state[n].float())
                           for k, st in grid_state.items() for n, t in st.items()},
            shapes_equal=all(t.shape == ref.hot[k].state[n].shape
                             for k, st in grid_state.items() for n, t in st.items()),
            atlas_rel_err={k: rel_err(t, ref.hot[k].param.detach())
                           for k, t in grid_hot.items()},
            one_process_state_shapes={k: {n: list(t.shape) for n, t in h.state.items()}
                                      for k, h in ref.hot.items()})
        del ref
    del grid_state, grid_hot
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    out["factored"]["seconds"] = time.perf_counter() - t_phase

    # 42. mesh_data2_stage0: DeiT-Small stage 0, fp32, dropout live, data 2
    t_phase = time.perf_counter()
    cfg = vanilla_cfg(384, 6)
    cfg["training"] = dict(cfg["training"], dtype="float32")
    b0 = inputs["stage0"]
    sl = local_batch_slice(BATCH, mesh_d)
    tr0 = backbone_trainer(cfg, IN_STEPS_PER_EPOCH, seed=0, device=dev, num_classes=IN_CLASSES,
                           mesh=mesh_d)
    grid_grads = keep_reduced_gradients(tr0)
    reset_launch_counts()
    losses = [tr0.train_iter(on(b, sl))["loss"].item() for b in b0]
    launches = launch_counts()
    grid_params = {k: p.detach().clone() for k, p in tr0.model.named_parameters()}
    del tr0
    torch.cuda.empty_cache()
    out["stage0"] = {"losses": losses, "local_batch": sl.stop - sl.start, "launches": launches}
    if rank == 0:
        ref = backbone_trainer(cfg, IN_STEPS_PER_EPOCH, seed=0, device=dev,
                               num_classes=IN_CLASSES)
        want_losses, sure, want_grads = [], {}, keep_reduced_gradients(ref)
        for b in b0:
            want_losses.append(ref.train_iter(on(b))["loss"].item())
            if not sure:
                sure = {k: p.grad.abs() > 1e-3 * p.grad.abs().max()
                        for k, p in ref.model.named_parameters()}
        want = {k: p.detach() for k, p in ref.model.named_parameters()}
        bound = 2 * cfg["training"]["optimizer"]["lr"] * len(b0)
        out["stage0"].update(
            one_process_losses=want_losses, bound=bound,
            loss_rel_err=max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses)),
            grads=grad_rule(grid_grads, want_grads, lambda: stage0_fp64_grads(cfg, b0[0], dev)),
            **sure_rule(grid_params, want, sure, bound))
        del ref, want, sure, want_grads
    del grid_params, grid_grads
    torch.cuda.empty_cache()
    out["stage0"]["seconds"] = time.perf_counter() - t_phase

    # 52. mesh_data2_resnet50: ResNet-50 stage 0, data 2, in fp64 (fp32
    # resolves these gradients to a few % only: RN_TOL64): BatchNorm's
    # statistics of the global batch (each rank's sums summed over the data
    # group, and their gradients)
    t_phase = time.perf_counter()
    brn = inputs["resnet"]
    sl = local_batch_slice(RN_GRID_BATCH, mesh_d)
    trn = resnet_trainer("float64", dev, mesh_d)
    grid_grads = keep_reduced_gradients(trn)
    reset_launch_counts()
    losses, stats = [], []
    for b in brn:
        losses.append(trn.train_iter(on(b, sl))["loss"].item())
        stats.append(running_stats(trn.model))
    launched = {k: v for k, v in launch_counts().items() if v}
    grid_params = {k: p.detach().clone() for k, p in trn.model.named_parameters()}
    del trn
    torch.cuda.empty_cache()
    out["resnet"] = {"losses": losses, "local_batch": sl.stop - sl.start, "launches": launched}
    if rank == 0:
        ref = resnet_trainer("float64", dev)
        want_losses, want_stats, sure, want_grads = [], [], {}, keep_reduced_gradients(ref)
        for b in brn:
            want_losses.append(ref.train_iter(on(b))["loss"].item())
            want_stats.append(running_stats(ref.model))
            if not sure:
                sure = {k: p.grad.abs() > 1e-3 * p.grad.abs().max()
                        for k, p in ref.model.named_parameters()}
        want = {k: p.detach() for k, p in ref.model.named_parameters()}
        bound = 2 * resnet_cfg("float32")["training"]["optimizer"]["lr"] * len(brn)
        grads = leaf_rel(grid_grads, want_grads)
        out["resnet"].update(
            one_process_losses=want_losses, bound=bound,
            loss_rel_err=[abs(a - b) / abs(b) for a, b in zip(losses, want_losses)],
            stats_rel_err=[max(leaf_rel(a, b).values()) for a, b in zip(stats, want_stats)],
            grads_rel_err_max=max(grads.values()), grads_rel_err_max_leaf=max(grads, key=grads.get),
            same_leaves=sorted(grid_grads) == sorted(want_grads),
            **sure_rule(grid_params, want, sure, bound))
        del ref, want, sure, want_grads, want_stats
    del grid_params, grid_grads, stats
    torch.cuda.empty_cache()
    out["resnet"]["seconds"] = time.perf_counter() - t_phase
    with open(os.path.join(work_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def grid_phases(dev, work_dir: str, card_note: dict) -> dict:
    """Phases 40-42: ``mesh_one_rank`` in this process (a one-rank NCCL grid,
    2 bf16 ImageNet DeiT-Small stage-4 steps, bit for bit the trainer
    without a grid), then two ranks (``grid_rank_main``, spawned with a
    wall-clock limit): ``mesh_model2`` (model 2: the fp32 lock step against
    one process by phase 8's rules and run to run bit for bit, 2 bf16 steps
    counted by shape, peak memory a rank) and ``mesh_data2_stage0`` (data 2:
    2 fp32 DeiT-Small stage-0 steps with dropout live against one process by
    phase 29's rules) and ``mesh_data2_resnet50`` (phase 52: data 2, 2 fp64
    ResNet-50 steps against one process). Returns the kernels line's rows at
    the shard's shapes and the phases' seconds."""
    from schemanet_torch.ops.kernels import _build
    from schemanet_torch.ops.kernels import atlas_opt as ao
    from schemanet_torch.ops.kernels import embed_bwd as ek
    from schemanet_torch.ops.kernels import graphconv as gc
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts
    from schemanet_torch.ops.kernels import layernorm as lnk
    from schemanet_torch.models.vit import get_model
    from schemanet_torch.parallel.launch import spawn_ranks
    from schemanet_torch.parallel.mesh import make_mesh
    from schemanet_torch.pipeline.bundle import Bundle
    from schemanet_torch.schema import init_parameters_

    seconds = {}
    backend, device = grid_layout()
    phase("grid_setup", backend=backend, cards=torch.cuda.device_count(), ranks=2,
          rank_devices=[device] * 2 if device == "cuda:0" else ["cuda:0", "cuda:1"],
          note="gloo: both ranks on one card, the collectives through the host; no measure "
               "of NCCL" if backend == "gloo" else "nccl: one card a rank", **card_note)
    # the bundle and class ingredients of phase 25, drawn the same way
    g = torch.Generator().manual_seed(40)
    small = vit_cfg(384, 6, None)
    vit = get_model(small, IN_CLASSES)
    init_parameters_(vit, torch.Generator().manual_seed(0))
    bundle = Bundle(model_cfg=small, encode_layer=ENCODE_LAYER, img_size=IMG,
                    backbone_state={k: v.clone() for k, v in vit.state_dict().items()},
                    codebook=torch.rand(IN_CODES, 384, generator=g) * 2 - 1, extra={})
    del vit
    ingredients = torch.stack([torch.randperm(IN_CODES, generator=g)[:IN_VMAX]
                               for _ in range(IN_CLASSES)]).to(torch.int32)
    b4 = grid_batches(40, GRID_STEPS, IN_CLASSES)

    # 40. mesh_one_rank
    t0 = time.perf_counter()
    state = in_stage4_state(bundle, ingredients)
    tr = in_stage4_trainer(state, "bfloat16", dev)
    losses_plain = [tr.train_iter({k: v.to(dev) for k, v in b.items()})["loss"].item()
                    for b in b4]
    want = trainer_snapshot(tr)
    del tr
    mesh = make_mesh(device=dev)
    tr = in_stage4_trainer(state, "bfloat16", dev, mesh)
    reset_launch_counts()
    losses_grid = [tr.train_iter({k: v.to(dev) for k, v in b.items()})["loss"].item()
                   for b in b4]
    launches = launch_counts()
    differs = same_snapshots(want, trainer_snapshot(tr))
    del tr, want
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    seconds["40_mesh_one_rank"] = time.perf_counter() - t0
    phase("mesh_one_rank", backend=mesh.backend, grid=mesh.shape, steps=GRID_STEPS,
          losses=losses_grid, losses_without_grid=losses_plain, bitwise=not differs,
          differs=differs[:20], launches=launches, seconds=seconds["40_mesh_one_rank"],
          **card_note)
    require(mesh.backend == "nccl", f"the one-rank grid is not NCCL's: {mesh.backend}")
    require(not differs and losses_grid == losses_plain,
            f"one-rank grid differs from the trainer without a grid in {differs[:20]}")
    require(all(v > 0 for k, v in launches.items() if k in (
        "attn_block", "ffn_block", "vq_assign", "sym_conv", "sym_conv_bwd", "fused_layernorm",
        "fused_layernorm_bwd", "embed_grad", "adamw_project_rows")),
        f"one-rank grid: a kernel of the path never launched: {launches}")

    # 41-42: two ranks
    t0 = time.perf_counter()
    torch.save(state, os.path.join(work_dir, "state.pt"))
    del state
    rng = np.random.default_rng(52)
    resnet_batches = [
        {"image": torch.from_numpy(rng.normal(size=(RN_GRID_BATCH, RN_IMG, RN_IMG, 3)).astype(
            np.float32)), "label": torch.from_numpy(rng.integers(0, RN_CLASSES, RN_GRID_BATCH))}
        for _ in range(GRID_STEPS)]
    torch.save({"stage4": b4,
                "stage0": grid_batches(42, GRID_STEPS, IN_CLASSES), "resnet": resnet_batches},
               os.path.join(work_dir, "inputs.pt"))
    _build.library()  # built before the ranks start
    torch.cuda.empty_cache()
    spawn_ranks([sys.executable, os.path.abspath(__file__), "--grid-rank", work_dir], 2,
                timeout=GRID_TIMEOUT_S, log_dir=os.path.join(work_dir, "logs"),
                env=dict(os.environ, **{GRID_ENV: f"{backend},{device}"}),
                cwd=os.path.dirname(os.path.abspath(__file__)))
    ranks = []
    for r in range(2):
        with open(os.path.join(work_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    seconds["41_42_two_ranks"] = time.perf_counter() - t0
    lock = ranks[0]["lock"]
    phase("mesh_model2", part="fp32_lock_step", backend=backend, grid={"data": 1, "model": 2},
          rank_losses=[r["lock"]["loss"] for r in ranks],
          run_to_run_bitwise=[not r["lock"]["run_to_run_differs"] for r in ranks], **lock,
          tol={"loss": 1e-4, "atlas where |g| is large": "rtol 1e-4 / atol 1e-6",
               "every trained tensor": "2 lr", "gradients": GRAD_RULE}, **card_note)
    require(all(not r["lock"]["run_to_run_differs"] for r in ranks),
            f"a grid step from one state twice differs: {[r['lock'] for r in ranks]}")
    require(lock["loss_rel_err"] <= 1e-4, f"fp32 grid loss differs by {lock['loss_rel_err']}")
    # phase 8's rules: the tight rule on the atlas, the bound on every tensor
    # (the GNN's small gradients are differences of large terms, so their
    # summation order moves them: reported, not gated)
    require(lock["hot"]["sure_ok"] and lock["hot"]["within_bound"],
            f"fp32 grid lock step, the atlas: {lock['hot']}")
    require(lock["rest"]["within_bound"], f"fp32 grid lock step, the GNN: {lock['rest']}")
    # the gradients the update reads: the GNN's and the class lookup's summed
    # over the model group, the atlas's from this rank's classes
    require(lock["grads"]["ok"], f"fp32 grid lock step, the reduced gradients: {lock['grads']}")
    require(lock["edge_shard_shape"] == [IN_CLASSES // 2, IN_VMAX, IN_VMAX],
            f"the edge atlas shard is {lock['edge_shard_shape']}")

    # the bf16 steps' launches: phase 27's at the shard's class count
    convs = 2 * IN_SCHEMA_CFG["schema_net"]["gnn"]["num_layers"]
    k_local = IN_CLASSES // 2
    want_shapes = {f"sym_conv {[k_local, IN_VMAX, IN_GNN]}": convs // 2 * GRID_STEPS,
                   f"sym_conv_bwd {[k_local, IN_VMAX, IN_GNN]}": convs // 2 * GRID_STEPS,
                   f"fused_layernorm {[k_local * IN_VMAX, IN_GNN]}": convs // 2 * GRID_STEPS,
                   f"fused_layernorm_bwd {[k_local * IN_VMAX, IN_GNN]}": convs // 2 * GRID_STEPS,
                   f"sym_conv {[BATCH, L_INST, IN_GNN]}": convs // 2 * GRID_STEPS,
                   f"sym_conv_bwd {[BATCH, L_INST, IN_GNN]}": convs // 2 * GRID_STEPS,
                   f"fused_layernorm {[BATCH * L_INST, IN_GNN]}": convs // 2 * GRID_STEPS,
                   f"fused_layernorm_bwd {[BATCH * L_INST, IN_GNN]}": convs // 2 * GRID_STEPS}
    want_counts = {"attn_block": FROZEN_LAYERS * GRID_STEPS, "attn_block_hmean": GRID_STEPS,
                   "ffn_block": FROZEN_LAYERS * GRID_STEPS, "vq_assign": GRID_STEPS,
                   "sym_conv": convs * GRID_STEPS, "sym_conv_bwd": convs * GRID_STEPS,
                   "fused_layernorm": convs * GRID_STEPS,
                   "fused_layernorm_bwd": convs * GRID_STEPS,
                   "embed_grad": 2 * GRID_STEPS, "embed_grad_planned": GRID_STEPS,
                   "adamw_project_rows": 2 * GRID_STEPS,
                   "adamw_project_rows_bf16": 2 * GRID_STEPS}
    for r in ranks:
        bf = r["bf16"]
        got_shapes = {k: v for k, v in bf["launches_by_shape"].items() if k in want_shapes}
        got_counts = {k: bf["launches"].get(k) for k in want_counts}
        phase("mesh_model2", part="bf16_steps", rank=r["rank"], device=r["device"],
              steps=GRID_STEPS, losses=bf["losses"], step_ms=bf["step_ms"],
              step_ms_note="two ranks on one card through gloo: no measure of NCCL"
              if backend == "gloo" else "nccl", launches_by_shape=got_shapes,
              expected_by_shape=want_shapes, launches=got_counts, expected=want_counts,
              peak_memory_gb=bf["peak_memory_gb"], edge_shard_shape=bf["edge_shard_shape"],
              profiled_third_step=bf["profiled"],
              moment_dtypes=bf["moment_dtypes"], seconds=bf["seconds"], **card_note)
        require(all(np.isfinite(bf["losses"])), f"grid bf16 losses not finite: {bf['losses']}")
        require(got_shapes == want_shapes, f"rank {r['rank']}: launches by shape {got_shapes} "
                                           f"!= {want_shapes}")
        require(got_counts == want_counts, f"rank {r['rank']}: launches {got_counts} != "
                                           f"{want_counts}")
    require(ranks[0]["bf16"]["losses"] == ranks[1]["bf16"]["losses"],
            "the ranks of one model group report other losses")

    # 54. factored AdamW on the grid: the statistics summed over the model
    # group equal one process's (fp32: the order of the class axis' sums)
    fac = ranks[0]["factored"]
    phase("mesh_model2_factored", backend=backend, grid={"data": 1, "model": 2},
          rank_losses=[r["factored"]["loss"] for r in ranks],
          rank_state_shapes=[r["factored"]["local_state_shapes"] for r in ranks],
          tol={"loss": 1e-4, "statistics": 1e-4, "atlas": 1e-5},
          **{k: v for k, v in fac.items() if k != "local_state_shapes"}, **card_note)
    edge_local = ranks[0]["factored"]["local_state_shapes"]["schema_net.edge_weights"]
    require(edge_local == {"v_row": [1, IN_VMAX, IN_VMAX], "v_col": [k_local, IN_VMAX, 1]},
            f"factored edge weights on a rank: {edge_local}")
    require(fac["loss_rel_err"] <= 1e-4, f"factored grid loss differs by {fac['loss_rel_err']}")
    require(fac["shapes_equal"] and all(v <= 1e-4 for v in fac["state_rel_err"].values()),
            f"factored grid statistics differ from one process's: {fac['state_rel_err']}")
    require(all(v <= 1e-5 for v in fac["atlas_rel_err"].values()),
            f"factored grid atlas differs from one process's: {fac['atlas_rel_err']}")

    s0 = ranks[0]["stage0"]
    s0_kernels = ("fused_mhsa", "fused_mhsa_bwd", "fused_mlp", "fused_mlp_bwd")
    phase("mesh_data2_stage0", backend=backend, grid={"data": 2, "model": 1}, steps=GRID_STEPS,
          rank_losses=[r["stage0"]["losses"] for r in ranks],
          launches={k: s0["launches"].get(k) for k in s0_kernels},
          tol={"loss": 1e-4, "sure": "rtol 1e-4 / atol 1e-6", "all": "2 lr a step",
               "gradients": GRAD_RULE},
          **{k: v for k, v in s0.items() if k not in ("launches", "losses")}, **card_note)
    require(s0["loss_rel_err"] <= 1e-4, f"grid stage-0 losses differ by {s0['loss_rel_err']}")
    require(s0["sure_ok"] and s0["within_bound"], f"grid stage-0 parameters: {s0}")
    require(s0["grads"]["ok"], f"grid stage 0, the first step's gradients averaged over the "
                               f"data group: {s0['grads']}")
    require(ranks[0]["stage0"]["losses"] == ranks[1]["stage0"]["losses"],
            "the ranks report other stage-0 losses")
    require(all(r["stage0"]["launches"].get(k) == 12 * GRID_STEPS for r in ranks
                for k in s0_kernels), "grid stage 0: a fused kernel's launches")

    rn = ranks[0]["resnet"]
    phase("mesh_data2_resnet50", backend=backend, grid={"data": 2, "model": 1},
          steps=GRID_STEPS, global_batch=RN_GRID_BATCH, dtype="float64 (the loss fp32)",
          rank_losses=[r["resnet"]["losses"] for r in ranks],
          tol={"loss": RN_TOL64["loss"], "running statistics": "1e-6 of max after step 1, "
               "1e-5 after step 2", "gradients": RN_TOL64["gradients"],
               "sure": "rtol 1e-4 / atol 1e-6", "all": "2 lr a step"},
          **{k: v for k, v in rn.items() if k != "losses"}, **card_note)
    require(max(rn["loss_rel_err"]) <= RN_TOL64["loss"], f"grid ResNet-50 losses differ by "
                                                         f"{rn['loss_rel_err']}")
    require(rn["stats_rel_err"][0] <= 1e-6 and rn["stats_rel_err"][1] <= 1e-5,
            f"grid ResNet-50 running statistics differ by {rn['stats_rel_err']}")
    require(rn["same_leaves"] and rn["grads_rel_err_max"] <= RN_TOL64["gradients"],
            f"grid ResNet-50, the first step's gradients averaged over the data group: "
            f"{rn['grads_rel_err_max']} ({rn['grads_rel_err_max_leaf']})")
    require(rn["sure_ok"] and rn["within_bound"], f"grid ResNet-50 parameters: {rn}")
    require(ranks[0]["resnet"]["losses"] == ranks[1]["resnet"]["losses"],
            "the ranks report other ResNet-50 losses")
    require(not any(r["resnet"]["launches"] for r in ranks),
            f"grid ResNet-50 launched a hand-written kernel: {[r['resnet'] for r in ranks]}")

    # the kernels at the shard's shapes against their plain versions, timed
    rows, errors = {}, {}
    t0 = time.perf_counter()
    iters = 5
    gen = torch.Generator(device=dev).manual_seed(41)  # inputs drawn on the device

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    e = (torch.rand(k_local, IN_VMAX, IN_VMAX, generator=gen, device=dev) / IN_VMAX).to(
        torch.bfloat16)
    f_, gout = (rnd(k_local, IN_VMAX, IN_GNN).to(torch.bfloat16) for _ in range(2))
    compare("sym_conv_shard", gc.sym_conv, gc.sym_conv_reference, (e, f_), {}, torch.bfloat16,
            BF16_TOL, errors)
    compare("sym_conv_bwd_shard", gc.sym_conv_bwd, gc.sym_conv_bwd_reference, (e, f_, gout), {},
            torch.bfloat16, BF16_TOL, errors)
    conv_flops = 2 * k_local * IN_VMAX * IN_VMAX * IN_GNN + 2 * k_local * IN_VMAX * IN_VMAX
    with torch.no_grad():
        rows["sym_conv_shard"] = ((conv_flops, nbytes(e, f_, f_), "bfloat16"),
                                  time_ms(lambda: gc.sym_conv(e, f_), iters),
                                  time_ms(lambda: gc.sym_conv_reference(e, f_), iters))
        rows["sym_conv_bwd_shard"] = (
            (2 * conv_flops, nbytes(e, f_, gout, e, f_), "bfloat16"),
            time_ms(lambda: gc.sym_conv_bwd(e, f_, gout), iters),
            time_ms(lambda: gc.sym_conv_bwd_reference(e, f_, gout), iters))
    del e, f_, gout
    x = rnd(k_local * IN_VMAX, IN_GNN).to(torch.bfloat16)
    sc, bi = 1 + rnd(IN_GNN, scale=0.1), rnd(IN_GNN, scale=0.1)
    y = lnk.fused_layernorm_reference(x, sc, bi, 1e-6, "relu").float()
    cot = torch.where(y.abs() <= 1e-5 * y.abs().max(), 0.0, rnd(*x.shape)).to(torch.bfloat16)
    del y
    compare("fused_layernorm_shard_d1024", lnk.fused_layernorm, lnk.fused_layernorm_reference,
            (x, sc, bi, 1e-6, "relu"), {}, torch.bfloat16, BF16_TOL, errors)
    compare("fused_layernorm_bwd_shard_d1024", lnk.fused_layernorm_bwd,
            lnk.fused_layernorm_bwd_reference, (x, sc, bi, cot, 1e-6, "relu"), {},
            torch.bfloat16, BF16_TOL, errors)
    rows["fused_layernorm_shard_d1024"] = (
        (*ln_work(x), "float32"), time_ms(lambda: lnk.fused_layernorm(x, sc, bi, 1e-6, "relu"),
                                          iters),
        time_ms(lambda: lnk.fused_layernorm_reference(x, sc, bi, 1e-6, "relu"), iters))
    rows["fused_layernorm_bwd_shard_d1024"] = (
        (*ln_work(x, bwd=True), "float32"),
        time_ms(lambda: lnk.fused_layernorm_bwd(x, sc, bi, cot, 1e-6, "relu"), iters),
        time_ms(lambda: lnk.fused_layernorm_bwd_reference(x, sc, bi, cot, 1e-6, "relu"), iters))
    del x, cot
    ids = ingredients[:k_local].to(dev)
    gl = rnd(k_local, IN_VMAX, IN_GNN).to(torch.bfloat16)
    plan = ek.sort_ids(ids, IN_CODES + 1)
    compare("embed_grad_shard", lambda *a: ek.embed_grad(*a, plan=plan), ek.embed_grad_reference,
            (ids, gl, IN_CODES + 1), {}, torch.bfloat16, BF16_TOL, errors)
    rows["embed_grad_shard"] = (
        (*embed_work((ids, gl, IN_CODES + 1)), "bfloat16"),
        time_ms(lambda: ek.embed_grad(ids, gl, IN_CODES + 1, plan=plan), iters),
        time_ms(lambda: ek.embed_grad_reference(ids, gl, IN_CODES + 1), iters))
    del gl
    shape = (k_local, IN_VMAX, IN_VMAX)
    p0 = torch.rand(*shape, generator=gen, device=dev)
    p0 /= p0.sum(-1, keepdim=True)
    grad = rnd(*shape, scale=1e-4)
    m0 = rnd(*shape, scale=1e-5).to(torch.bfloat16)
    v0 = (rnd(*shape, scale=1e-5) ** 2).to(torch.bfloat16)
    hyper = dict(lr=1e-3, weight_decay=5e-4, project=True)
    pk, mk_, vk = p0.clone(), m0.clone(), v0.clone()
    ao.adamw_project_rows(pk, grad, mk_, vk, 3, **hyper)
    pp, mp, vp = p0.clone(), m0.clone(), v0.clone()
    ao.adamw_project_rows_reference(pp, grad, mp, vp, 3, **hyper)
    errors["adamw_project_rows_shard"] = abs_err(pk, pp)
    require(rel_err(pk, pp) <= FP32_TOL, f"adamw_project_rows at the shard: {rel_err(pk, pp)}")
    prm = p0.numel()
    rows["adamw_project_rows_shard"] = (
        (15 * prm, 3 * 4 * prm + 4 * 2 * prm, "float32"),
        time_ms(lambda: ao.adamw_project_rows(pk, grad, mk_, vk, 3, **hyper), iters),
        time_ms(lambda: ao.adamw_project_rows_reference(pp, grad, mp, vp, 3, **hyper), iters))
    del p0, grad, m0, v0, pk, mk_, vk, pp, mp, vp
    torch.cuda.empty_cache()
    seconds["grid_kernel_rows"] = time.perf_counter() - t0
    # each row's launches: rank 0's in the bf16 grid steps, at the row's shape
    by_shape, counts = ranks[0]["bf16"]["launches_by_shape"], ranks[0]["bf16"]["launches"]
    launches = {
        "sym_conv_shard": by_shape.get(f"sym_conv {[k_local, IN_VMAX, IN_GNN]}", 0),
        "sym_conv_bwd_shard": by_shape.get(f"sym_conv_bwd {[k_local, IN_VMAX, IN_GNN]}", 0),
        "fused_layernorm_shard_d1024":
            by_shape.get(f"fused_layernorm {[k_local * IN_VMAX, IN_GNN]}", 0),
        "fused_layernorm_bwd_shard_d1024":
            by_shape.get(f"fused_layernorm_bwd {[k_local * IN_VMAX, IN_GNN]}", 0),
        "embed_grad_shard": counts["embed_grad_planned"],  # the class lookup's
        "adamw_project_rows_shard": counts["adamw_project_rows"] // 2,  # the edge shard's
    }
    out = {}
    for name, (work, ms, plain_ms) in rows.items():
        bound_ms, bound_by = least_ms(*work)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None, max_abs_err=errors[name], launches=launches[name])
        phase("kernel_time", kernel=name, grid="model 2 (K 500 a rank)", **out[name],
              **card_note)
    seconds["total"] = sum(seconds.values())
    phase("grid_seconds", **seconds, **card_note)
    return {"rows": out, "seconds": seconds}


# the int8 route (phases 43-46): the widths of DeiT-Tiny, DeiT-Small and
# DeiT-Base, and the rows of a serving microbatch (64 x 197) and of 1,000
QUANT_WIDTHS = (192, 384, 768)
QUANT_ROWS = (MICROBATCH * (L_INST + 1), 1000)
QUANT_REPLACES = "schemanet_tpu/ops/quant.py (XLA int8 dot_general; no Pallas kernel)"
# tests/test_quant.py's drift bounds: mid-feature relative error, per-token
# cosine, the ViT classifier's argmax agreement
QUANT_DRIFT = {"rel_err": 0.05, "cosine": 0.99, "argmax": 0.875}
# tests/test_torch_quant.py's whole-layer bounds: the share of int8 codes
# that may differ, each by at most 1, and a layer's output within 2e-3 of max
QUANT_LOCK = {"code_share": 1e-4, "code_max_diff": 1, "out_rel_err": 2e-3}


def quantize_work(x):
    """(operations, bytes) of ``quantize_rows`` on x [rows, k]: |x|, the max,
    the division, the rounding and the clip an element in fp32; x read, the
    codes and a scale a row written."""
    rows = x.numel() // x.shape[-1]
    return 5 * x.numel(), nbytes(x) + x.numel() + 4 * rows


def int8_gemm_work(a, w, y):
    """(operations, bytes) of ``int8_gemm``: 2 rows n k int8 operations; a,
    w, the scales and the bias read, y written."""
    rows, k = a.shape
    n = w.shape[0]
    return 2 * rows * n * k, nbytes(a, w, y) + 4 * (rows + 2 * n)


def code_recorder(store):
    """Patches ``ops.quant.quantize_rows`` (the activations' quantisation of
    ``int8_dot``; weights go through ``quantize_weight``) to keep the codes
    of each call in ``store``."""
    from schemanet_torch.ops import quant as tq

    inner = tq.quantize_rows

    def record(x):
        q, s = inner(x)
        store.append(q)
        return q, s

    return mock.patch.object(tq, "quantize_rows", record)


def code_share(got: list, want: list) -> dict:
    """The share of int8 codes that differ between two runs' records, and the
    largest difference."""
    require(len(got) == len(want) and got, f"code records of {len(got)} and {len(want)} calls")
    differ = total = worst = 0
    for a, b in zip(got, want):
        diff = (a.int() - b.int()).abs()
        differ += int((diff > 0).sum())
        total += diff.numel()
        worst = max(worst, int(diff.max()))
    return {"codes": total, "codes_differing": differ, "code_share_differing": differ / total,
            "code_max_diff": worst}


def quant_phases(dev, card_note: dict, stage1: dict, device_images) -> dict:
    """Phases 43-46, the int8 (W8A8) route of the frozen backbone: 43 the two
    kernels against their plain versions bit for bit at every projection of
    the three widths, timed at DeiT-Small's; 44 ImageNet DeiT-Small serving
    in bf16 through ``ServePredictor(quant_int8=True)`` on phase 25's
    stage-4 predictor, counted, timed beside its bf16 route, its drift
    against that route under tests/test_quant.py's bounds; 45 the same in
    fp32 at K 100 against the plain versions (phase 4's rule), and
    DeiT-Base's microbatch (k 3072); 46 stage 1 at CIFAR with ``quant``,
    beside phase 16's (``stage1``: its seconds, codebook, held sample and
    stage shape; ``device_images`` its loader class). Returns the kernels
    line's rows and each phase's seconds."""
    from torch.profiler import ProfilerActivity, profile

    from schemanet_torch.kernel_times import projections
    from schemanet_torch.models.vit import get_model
    from schemanet_torch.ops import kmeans
    from schemanet_torch.ops.kernels import encoder_block as eb
    from schemanet_torch.ops.kernels import (launch_counts, launch_counts_by_shape,
                                             reset_launch_counts)
    from schemanet_torch.ops.kernels import quant as qk
    from schemanet_torch.pipeline import collect_mid_features, extract_stage
    from schemanet_torch.pipeline.bundle import Bundle
    from schemanet_torch.schema import build_predictor, init_parameters_
    from schemanet_torch.serve import ServePredictor
    from schemanet_torch.train import schema_net_trainer

    seconds, rows = {}, {}
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = now - t_phase
        t_phase = now
        phase("phase_seconds", phase_name=name, seconds=seconds[name], **card_note)

    gd = torch.Generator(device=dev).manual_seed(43)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gd, device=dev) * scale

    # 43. the two kernels against their plain versions, bit for bit
    cases, max_err = [], {"quantize_rows": 0.0, "int8_gemm": 0.0}
    for d in QUANT_WIDTHS:
        for name, n, k in projections(d):
            w, b = rnd(n, k, scale=k**-0.5), rnd(n, scale=0.02)
            wq, ws = qk.quantize_rows(w)
            want_wq, want_ws = qk.quantize_rows_reference(w)
            w_same = torch.equal(wq, want_wq) and torch.equal(ws, want_ws)
            for n_rows in QUANT_ROWS:
                x32 = rnd(n_rows, k)
                for dt in (torch.bfloat16, torch.float32):
                    x = x32.to(dt)
                    xq, xs = qk.quantize_rows(x)
                    want_xq, want_xs = qk.quantize_rows_reference(x)
                    y = qk.int8_gemm(xq, wq, xs, ws, b, dt)
                    want_y = qk.int8_gemm_reference(xq, wq, xs, ws, b, dt)
                    dense = eb.dense(x, w, b)  # the product the route stands in for
                    max_err["quantize_rows"] = max(
                        max_err["quantize_rows"], abs_err(xq, want_xq), abs_err(xs, want_xs),
                        abs_err(wq, want_wq), abs_err(ws, want_ws))
                    max_err["int8_gemm"] = max(max_err["int8_gemm"], abs_err(y, want_y))
                    cases.append({"width": d, "projection": name, "rows": n_rows,
                                  "dtype": str(dt).split(".")[-1], "weight_bitwise": w_same,
                                  "x_bitwise": torch.equal(xq, want_xq) and torch.equal(
                                      xs, want_xs), "y_bitwise": torch.equal(y, want_y),
                                  "vs_dense_rel": rel_err(y, dense)})
                    del x, xq, y, want_y, dense
            del w, wq
    bitwise = all(c["weight_bitwise"] and c["x_bitwise"] and c["y_bitwise"] for c in cases)
    phase("quant_vs_plain", cases=len(cases), bitwise=bitwise, max_abs_err=max_err,
          worst_vs_dense_rel={dt: max(c["vs_dense_rel"] for c in cases if c["dtype"] == dt)
                              for dt in ("bfloat16", "float32")}, report=cases)
    require(bitwise, "quantize_rows or int8_gemm differs from its plain version: "
            + json.dumps([c for c in cases if not (c["weight_bitwise"] and c["x_bitwise"]
                                                   and c["y_bitwise"])][:4]))
    # times at DeiT-Small's projections, a serving microbatch in bf16
    timed = {}
    for name, n, k in projections(384):
        x = rnd(QUANT_ROWS[0], k).to(torch.bfloat16)
        w, b = rnd(n, k, scale=k**-0.5), rnd(n, scale=0.02)
        xq, xs = qk.quantize_rows(x)
        wq, ws = qk.quantize_rows(w)
        y = qk.int8_gemm(xq, wq, xs, ws, b, torch.bfloat16)
        wt, w16, b16 = wq.t(), w.to(torch.bfloat16), b.to(torch.bfloat16)
        q_ops, q_bytes = quantize_work(x)
        g_ops, g_bytes = int8_gemm_work(xq, wq, y)
        timed[name] = {
            "shape": [QUANT_ROWS[0], n, k],
            "quantize_rows_ms": time_ms(lambda: qk.quantize_rows(x), TIME_ITERS),
            "quantize_rows_plain_ms": time_ms(lambda: qk.quantize_rows_reference(x), TIME_ITERS),
            "quantize_rows_bound": least_ms(q_ops, q_bytes, "float32"),
            "quantize_weight_ms": time_ms(lambda: qk.quantize_rows(w), TIME_ITERS),
            "int8_gemm_ms": time_ms(lambda: qk.int8_gemm(xq, wq, xs, ws, b, torch.bfloat16),
                                    TIME_ITERS),
            "int8_gemm_plain_ms": time_ms(
                lambda: qk.int8_gemm_reference(xq, wq, xs, ws, b, torch.bfloat16), TIME_ITERS),
            "int8_gemm_bound": least_ms(g_ops, g_bytes, "int8"),
            # the library's int32 product alone (no epilogue), and the bf16
            # product the route stands in for: notes
            "int_mm_ms": time_ms(lambda: torch._int_mm(xq, wt), TIME_ITERS),
            "bf16_linear_ms": time_ms(lambda: torch.nn.functional.linear(x, w16, b16),
                                      TIME_ITERS),
        }
        phase("kernel_time", kernel="int8_route", projection=name, dtype="bfloat16",
              **timed[name], **card_note)
        del x, xq, y, wq
    qkv = timed["qkv"]
    rows["quantize_rows"] = {"ms": qkv["quantize_rows_ms"], "plain_ms": qkv["quantize_rows_plain_ms"],
                             "bound_ms": qkv["quantize_rows_bound"][0],
                             "bound_by": qkv["quantize_rows_bound"][1], "library_ms": None,
                             "max_abs_err": max_err["quantize_rows"]}
    rows["int8_gemm"] = {"ms": qkv["int8_gemm_ms"], "plain_ms": qkv["int8_gemm_plain_ms"],
                         "bound_ms": qkv["int8_gemm_bound"][0],
                         "bound_by": qkv["int8_gemm_bound"][1], "library_ms": qkv["int_mm_ms"],
                         "library_note": "torch._int_mm on the same int8 operands: the int32 "
                                         "product alone, without the epilogue",
                         "max_abs_err": max_err["int8_gemm"]}
    torch.cuda.empty_cache()
    lap("43_quant_kernels")

    # 44. ImageNet DeiT-Small W8A8 serving in bf16: phase 25's stage-4
    # predictor (schema_net_trainer from a seeded bundle, K 1000, V_max 500,
    # M 8000, GNN 1024 x 2) through ServePredictor(quant_int8=True)
    g = torch.Generator().manual_seed(44)
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
    model = tr.model
    cfg_before = model.cfg
    serve_b = ServePredictor(model, microbatch=MICROBATCH, device=dev)
    serve_q = ServePredictor(model, microbatch=MICROBATCH, device=dev, quant_int8=True)
    images = torch.from_numpy(np.random.default_rng(44).normal(
        size=(N_IMAGES, IMG, IMG, 3)).astype(np.float32)).to(dev)
    reset_launch_counts()
    logits = serve_q.predict_tensor(images)
    torch.cuda.synchronize()
    got = launch_counts()
    by_shape = {k: {str(list(s)): c for s, c in v.items()}
                for k, v in launch_counts_by_shape().items() if k in ("quantize_rows", "int8_gemm")}
    mbs = -(-N_IMAGES // MICROBATCH)
    convs = 2 * IN_SCHEMA_CFG["schema_net"]["gnn"]["num_layers"]
    expected = {name: 0 for name in got}
    expected.update({"quantize_rows": 8 * FROZEN_LAYERS * mbs, "int8_gemm": 4 * FROZEN_LAYERS * mbs,
                     "fused_layernorm": (2 * FROZEN_LAYERS + convs) * mbs,
                     "fused_mhsa": (FROZEN_LAYERS - 1) * mbs,
                     "fused_mhsa_tc": (FROZEN_LAYERS - 1) * mbs, "vq_assign": mbs,
                     "vq_assign_tc": mbs, "sym_conv": convs * mbs, "sym_conv_tc": convs * mbs})
    rows["quantize_rows"]["launches"] = got["quantize_rows"]
    rows["int8_gemm"]["launches"] = got["int8_gemm"]
    finite = {n_img: bool(torch.isfinite(serve_q.predict_tensor(images[:n_img])).all())
              for n_img in (1, MICROBATCH)}
    finite[N_IMAGES] = bool(torch.isfinite(logits).all())
    invariant = torch.equal(serve_q.predict_tensor(images[:5]), logits[:5])
    xb = images[:MICROBATCH]
    lat = {"bf16": [], "int8": []}
    for route in ("bf16", "int8", "int8", "bf16"):  # in turns
        server = serve_q if route == "int8" else serve_b
        for _ in range(LATENCY_ITERS // 2):
            t0 = time.perf_counter()
            server.predict_tensor(xb)
            torch.cuda.synchronize()
            lat[route].append((time.perf_counter() - t0) * 1e3)
    p = {route: {"p50_ms": float(np.percentile(v, 50)), "p99_ms": float(np.percentile(v, 99)),
                 "images_per_s": MICROBATCH / float(np.percentile(v, 50)) * 1e3}
         for route, v in lat.items()}
    # the frozen ViT's own classifier (all 12 layers, its 1000-class head),
    # in the serving dtype and, as tests/test_quant.py gates it, in fp32
    backbone = model.ingredient_backbone.backbone
    vit32 = get_model(small, IN_CLASSES)
    vit32.load_state_dict(backbone.state_dict())
    vit32.requires_grad_(False).to(dev)

    def vit_logits(net, quant):
        return torch.cat([net.resume_from_layer(net.encode_until(
            images[i:i + MICROBATCH], FROZEN_LAYERS, quant=quant)[0], FROZEN_LAYERS,
            quant=quant)["pred"] for i in range(0, N_IMAGES, MICROBATCH)])

    def agree(a, b):
        return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    with torch.no_grad():
        out_q = model.ingredient_backbone(xb, quant=True)
        out_b = model.ingredient_backbone(xb, quant=False)
        logits_b = serve_b.predict_tensor(images)
        vit_q, vit_b = vit_logits(backbone, True), vit_logits(backbone, False)
        vit32_q, vit32_b = vit_logits(vit32, True), vit_logits(vit32, False)
    mid_q, mid_b = out_q["mid_feat"].float().flatten(0, 1), out_b["mid_feat"].float().flatten(0, 1)
    diff = abs_err(logits, logits_b)
    top2 = logits_b.float().topk(2, dim=-1).values
    drift = {
        "mid_rel_err": ((mid_q - mid_b).norm() / mid_b.norm()).item(),
        "token_cosine_min": torch.nn.functional.cosine_similarity(mid_q, mid_b, dim=-1).min().item(),
        # tests/test_quant.py's argmax gate: the ViT classifier's logits in
        # fp32; in bf16 beside it, with bf16's own agreement with fp32 (no
        # int8) as the measure of how finely bf16 resolves these argmaxes
        "vit_argmax_agreement_fp32": agree(vit32_q, vit32_b),
        "vit_argmax_agreement_bf16": agree(vit_q, vit_b),
        "vit_argmax_bf16_vs_fp32": agree(vit_b, vit32_b),
        "vq_id_agreement": (out_q["ingredients"] == out_b["ingredients"]).float().mean().item(),
        # the SchemaNet logits (reported): seeded class graphs give near-ties
        # that bf16 rounds together; the share of images whose top two lie
        # within twice the routes' largest logit difference
        "schemanet_argmax_agreement": (logits.argmax(-1) == logits_b.argmax(-1)).float().mean()
        .item(),
        "schemanet_top2_within_2x_diff": (top2[:, 0] - top2[:, 1] <= 2 * diff).float().mean()
        .item(),
        "logit_max_abs_diff": diff, "logit_scale": logits_b.abs().max().item(),
    }
    del out_q, out_b, mid_q, mid_b, vit_q, vit_b, vit32_q, vit32_b, vit32
    def profiled(server):
        """Device ms, wall ms, idle share and the top kernels a microbatch,
        from a profile of two."""
        for attempt in range(1, 6):  # a session without device events is taken again
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(2):
                    server.predict_tensor(xb)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = device_time_by_name(prof)
            busy_us = sum(busy.values())
            if busy_us:
                break
            phase("profile_empty", attempt=attempt, iters=2)
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:12]
        return {"device_ms_a_microbatch": busy_us / 2e3, "wall_ms_a_microbatch": wall_us / 2e3,
                "idle_share": 1 - busy_us / wall_us if busy_us else None,
                "top_device_ms_a_microbatch": {k[:80]: v / 2e3 for k, v in top}}

    prof_q, prof_b = profiled(serve_q), profiled(serve_b)
    unchanged = model.cfg is cfg_before and not model.cfg.quant_backbone
    phase("imagenet_serve_int8", images=N_IMAGES, microbatches=mbs, logits=list(logits.shape),
          finite=finite, batch_invariant=invariant, launches=got, expected=expected,
          launches_by_shape=by_shape, latency=p, drift=drift, drift_bounds=QUANT_DRIFT,
          profile_int8=prof_q, profile_bf16=prof_b, callers_model_unchanged=unchanged, classes=IN_CLASSES, codes=IN_CODES, v_max=IN_VMAX,
          gnn=IN_GNN, **card_note)
    require(tuple(logits.shape) == (N_IMAGES, IN_CLASSES) and all(finite.values()),
            f"ImageNet int8 logits {tuple(logits.shape)}, finite {finite}")
    require(invariant, "ImageNet int8 serving: predict(x[:5]) != predict(x)[:5]")
    require(got == expected, f"ImageNet int8 serving launches {got} != {expected}")
    require(unchanged, "ServePredictor(quant_int8=True) changed the caller's config")
    require(drift["mid_rel_err"] < QUANT_DRIFT["rel_err"]
            and drift["token_cosine_min"] > QUANT_DRIFT["cosine"]
            and drift["vit_argmax_agreement_fp32"] >= QUANT_DRIFT["argmax"],
            f"ImageNet int8 serving drift {drift} beyond {QUANT_DRIFT}")
    require(prof_q["device_ms_a_microbatch"] > 0 and prof_b["device_ms_a_microbatch"] > 0,
            "a serving profile holds no device time")
    del tr, model, serve_b, serve_q, images, logits, logits_b
    torch.cuda.empty_cache()
    lap("44_imagenet_serve_int8")

    # 45. fp32 at K 100 against the plain versions, then DeiT-Base's
    # microbatch (fc2's k 3072). Free running, phase 4's rule is reported:
    # a code that flips where x / scale lies at .5 within the kernels' fp32
    # differences moves its projection by a quantisation step, which flips
    # more codes in the next layers, so the two runs part further layer by
    # layer (as free-running training steps do, phase 8). The gate is the
    # lock step: each layer on the kernel run's input to that layer,
    # kernels against plain versions, under tests/test_torch_quant.py's
    # whole-layer bounds.
    schema = dict(IN_SCHEMA_CFG["schema_net"], ir_atlas=dict(
        IN_SCHEMA_CFG["schema_net"]["ir_atlas"], graph_precision="highest"))
    images = torch.from_numpy(np.random.default_rng(45).normal(
        size=(N_IMAGES, IMG, IMG, 3)).astype(np.float32)).to(dev)
    report = {}
    for label, cfg, width in (("deit_small", small, 384), ("deit_base", vit_cfg(768, 12, None), 768)):
        m32 = build_predictor(cfg, schema, IN_FP32_CLASSES, IN_CODES, width, ENCODE_LAYER)
        init_parameters_(m32, torch.Generator().manual_seed(0))
        with torch.no_grad():
            if width == 384:  # phase 44's backbone and codebook
                m32.ingredient_backbone.backbone.load_state_dict(
                    {k: v for k, v in bundle.backbone_state.items()
                     if not k.startswith("cls_head.")}, strict=False)
                m32.ingredient_backbone.vocabulary.copy_(bundle.codebook)
            m32.schema_net.class_ingredients.copy_(ingredients[:IN_FP32_CLASSES])
        s32 = ServePredictor(m32, microbatch=MICROBATCH, device=dev, quant_int8=True)
        x = images if width == 384 else images[:MICROBATCH]
        n_mbs = -(-x.shape[0] // MICROBATCH)
        codes_k, codes_p = [], []
        with torch.no_grad():
            reset_launch_counts()
            logits_k = s32.predict_tensor(x)
            torch.cuda.synchronize()
            got = launch_counts()
            k_shapes = sorted({s[2] for s in launch_counts_by_shape()["int8_gemm"]})
            with code_recorder(codes_k):
                ids_k = m32.ingredient_backbone(x[:MICROBATCH], quant=True)["ingredients"]
            logits_p = with_plain(lambda: s32.predict_tensor(x))
            with code_recorder(codes_p):
                ids_p = with_plain(lambda: m32.ingredient_backbone(x[:MICROBATCH], quant=True))[
                    "ingredients"]
            lock = {"code_share_differing": 0.0, "code_max_diff": 0, "out_rel_err": 0.0}
            bb = m32.ingredient_backbone.backbone
            seq = bb.embed(x[:MICROBATCH])
            for i, layer in enumerate(bb.transformer.layers[:FROZEN_LAYERS]):
                hmean = i == ENCODE_LAYER  # the serving path's per-op attention
                lock_k, lock_p = [], []
                with code_recorder(lock_k):
                    out_k, _ = layer(seq, hmean, quant=True)
                with code_recorder(lock_p):
                    out_p, _ = with_plain(lambda: layer(seq, hmean, quant=True))
                layer_codes = code_share(lock_k, lock_p)
                lock["code_share_differing"] = max(lock["code_share_differing"],
                                                   layer_codes["code_share_differing"])
                lock["code_max_diff"] = max(lock["code_max_diff"], layer_codes["code_max_diff"])
                lock["out_rel_err"] = max(lock["out_rel_err"], rel_err(out_k, out_p))
                seq = out_k
                del lock_k, lock_p, out_p
        torch.cuda.synchronize()
        want = {"quantize_rows": 8 * FROZEN_LAYERS * n_mbs, "int8_gemm": 4 * FROZEN_LAYERS * n_mbs,
                "fused_mhsa": (FROZEN_LAYERS - 1) * n_mbs, "fused_mhsa_tc": 0,
                "attn_block": 0, "ffn_block": 0}
        scale = logits_p.abs().max().item()
        free = {"vq_id_agreement": (ids_k == ids_p).float().mean().item(),
                "logit_max_abs_err": abs_err(logits_k, logits_p), "logit_scale": scale,
                **code_share(codes_k, codes_p)}
        free["phase4_rule_met"] = bool(free["vq_id_agreement"] >= 0.999
                                       and free["logit_max_abs_err"] <= 1e-3 * scale)
        report[label] = {"images": x.shape[0], "int8_gemm_k": k_shapes, "free_running": free,
                         "lock_step": lock, "launches": {k: got[k] for k in want},
                         "expected": want}
        del s32, m32, logits_k, logits_p, codes_k, codes_p, seq, out_k
        torch.cuda.empty_cache()
    phase("imagenet_serve_int8_fp32", classes=IN_FP32_CLASSES,
          phase4_rule={"ids": 0.999, "logits": "1e-3 of max"}, lock_step_rule=QUANT_LOCK,
          **report, **card_note)
    for label, r in report.items():
        lock = r["lock_step"]
        require(r["launches"] == r["expected"], f"{label} int8 fp32 launches {r['launches']}")
        require(lock["code_share_differing"] <= QUANT_LOCK["code_share"]
                and lock["code_max_diff"] <= QUANT_LOCK["code_max_diff"]
                and lock["out_rel_err"] <= QUANT_LOCK["out_rel_err"],
                f"{label} int8 fp32 layers against the plain versions in lock step: {lock}")
    require(3072 in report["deit_base"]["int8_gemm_k"], "DeiT-Base's fc2 (k 3072) did not run")
    del images
    lap("45_imagenet_serve_int8_fp32")

    # 46. stage 1 at CIFAR, uncut, on the int8 route, beside phase 16's
    loader = device_images(S1_BATCHES, S1_BATCH, 3)  # phase 16's images
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    bundle_q = extract_stage(STAGE1_CFG, loader, seed=0, device=dev, quant=True)
    torch.cuda.synchronize()
    s1_seconds = time.perf_counter() - t0
    got = launch_counts()
    chunks = stage1["chunks"]
    expected = {name: 0 for name in got}
    expected.update({"quantize_rows": 8 * FROZEN_LAYERS * chunks,
                     "int8_gemm": 4 * FROZEN_LAYERS * chunks,
                     "fused_layernorm": 2 * FROZEN_LAYERS * chunks,
                     "fused_mhsa": FROZEN_LAYERS * chunks,
                     "vq_assign": stage1["vq_launches"], "vq_assign_tc": stage1["vq_launches"]})
    held = stage1["held"].to(dev)
    ref_cb, q_cb = stage1["codebook"].to(dev), bundle_q.codebook
    nearest = torch.cdist(q_cb, ref_cb).min(dim=1).values
    backbone = get_model(STAGE1_CFG["model"], NUM_CLASSES)
    backbone.load_state_dict(bundle_q.backbone_state)
    backbone.requires_grad_(False).to(dev)
    n_feats = 2 * S1_BATCH * L_INST
    f_q = collect_mid_features(backbone, device_images(2, S1_BATCH, 3), ENCODE_LAYER, n_feats,
                               quant=True)
    f_b = collect_mid_features(backbone, device_images(2, S1_BATCH, 3), ENCODE_LAYER, n_feats)
    centers = {
        "inertia_int8_centers": kmeans.kmeans_inertia(q_cb, held).item(),
        "inertia_fp32_centers": kmeans.kmeans_inertia(ref_cb, held).item(),
        "nearest_fp32_center_mean": nearest.mean().item(),
        "nearest_fp32_center_max": nearest.max().item(),
        "fp32_center_norm_mean": ref_cb.norm(dim=1).mean().item(),
    }
    feat_drift = {"rel_err": ((f_q - f_b).norm() / f_b.norm()).item(),
                  "token_cosine_min": torch.nn.functional.cosine_similarity(
                      f_q, f_b, dim=-1).min().item()}
    phase("stage1_int8", features=S1_FEATURES, batches=chunks, batch=S1_BATCH, codes=NUM_CODES,
          seconds=s1_seconds, features_per_s=S1_FEATURES / s1_seconds,
          fp32_seconds=stage1["seconds"], fp32_features_per_s=S1_FEATURES / stage1["seconds"],
          launches=got, expected=expected, centers=centers, feature_drift=feat_drift,
          drift_bounds=QUANT_DRIFT, **card_note)
    require(got == expected, f"stage-1 int8 launches {got} != {expected}")
    require(bool(torch.isfinite(q_cb).all()) and tuple(q_cb.shape) == (NUM_CODES, EMBED_DIM),
            "stage-1 int8 codebook")
    require(feat_drift["rel_err"] < QUANT_DRIFT["rel_err"]
            and feat_drift["token_cosine_min"] > QUANT_DRIFT["cosine"],
            f"stage-1 int8 feature drift {feat_drift} beyond {QUANT_DRIFT}")
    del held, f_q, f_b, backbone, bundle_q
    torch.cuda.empty_cache()
    lap("46_stage1_int8")
    return {"rows": rows, "seconds": seconds}


# the model zoo (phases 47-52): the FFN kernels' activations, a relu and a
# post-norm DeiT-Small, ResNet-50 and ResNet-18
ZOO_WIDTHS = (192, 384, 768)  # DeiT-Tiny, -Small, -Base
ZOO_ROWS = BATCH * (L_INST + 1)  # a stage-0 batch or a serving microbatch: 12,608 rows
ZOO_FORWARD_ONLY = ("swish", "sigmoid", "hard_sigmoid", "none")  # no backward, as the TPU kernel
ZOO_SEED = 2**31 - 3
RN_IMG, RN_CLASSES = 224, 1000
RN_FP32_BATCH, RN_BATCH, RN_STEPS, RN_WARMUP = 8, 128, 10, 2
RN_GRID_BATCH = 16  # phase 52's global batch: 8 images a rank
# phase 50's gates. fp32 resolves a ResNet-50's first-step gradients to a
# few % of a leaf's max (a ReLU input within two runs' rounding of 0 takes
# its other branch: 2-12% from fp64 a leaf at ResNet-50's first step, in one
# process and on the grid alike), so fp32 gates the forward, the loss and
# the running statistics, and fp64 the gradients (the loss takes fp32 logits
# in both packages: its rounding, ~1e-7, carried back)
RN_TOL = {"logits": 1e-4, "loss": 1e-4, "running_stats": 1e-4}
RN_TOL64 = {"logits": 1e-6, "loss": 1e-6, "running_stats": 1e-6, "gradients": 1e-5}
RW_DATA = {"name": "synthetic", "num_classes": 10, "image_size": 32, "resize": RN_IMG,
           "train": {"num_samples": 64}, "val": {"num_samples": 32}}


def relu_cfg(dim: int, heads: int) -> dict:
    """``vanilla_cfg`` whose model names no activation: relu, the default of
    both packages' ``_transformer_kwargs``."""
    cfg = copy.deepcopy(vanilla_cfg(dim, heads))
    del cfg["model"]["transformer"]["activation"]
    return cfg


def post_norm_cfg(dim: int, heads: int, activation: str = "relu") -> dict:
    """``relu_cfg`` with post-norm layers and the identity position encoding
    (and ``activation`` named where it is not relu)."""
    cfg = relu_cfg(dim, heads)
    cfg["model"]["transformer"]["pre_norm"] = False
    if activation != "relu":
        cfg["model"]["transformer"]["activation"] = activation
    cfg["model"]["pos_encoding"] = {"name": "identity"}
    return cfg


def resnet_cfg(dtype: str) -> dict:
    """Stage 0 of a ResNet-50 under the ImageNet vanilla block's training."""
    cfg = copy.deepcopy(vanilla_cfg(384, 6))
    cfg["model"] = {"name": "official_models", "model_name": "resnet50"}
    cfg["training"]["dtype"] = dtype
    return cfg


def running_stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_buffers()
            if k.endswith((".mean", ".var"))}


def leaf_rel(got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| / max |want| (``grad_rel``)."""
    return {k: grad_rel(got[k].to(w.device), w) for k, w in want.items()}


def resnet_trainer(dtype: str, dev, mesh=None):
    """``backbone_trainer``'s ResNet-50 (seed 0) under ``resnet_cfg``, on
    ``mesh`` or in one process; ``dtype`` "float64": parameters and compute
    in fp64 (the loss takes fp32 logits, in both packages)."""
    from schemanet_torch.schema import get_loss_fn
    from schemanet_torch.train import Trainer, TrainerConfig, backbone_trainer
    from schemanet_torch.train.workers import _backbone_model

    if dtype != "float64":
        return backbone_trainer(resnet_cfg(dtype), IN_STEPS_PER_EPOCH, seed=0, device=dev,
                                num_classes=RN_CLASSES, mesh=mesh)
    cfg = resnet_cfg("float32")
    model = _backbone_model(cfg, RN_CLASSES, torch.float64, 0).to(torch.float64)
    return Trainer(TrainerConfig.from_cfg(cfg["training"]), model, get_loss_fn(cfg["loss"]),
                   cfg["loss"]["weight_dict"], IN_STEPS_PER_EPOCH, seed=0, device=dev, mesh=mesh)


def resnet_step(dtype: str, dev, batch: dict) -> dict:
    """One step of ``resnet_trainer(dtype)`` on ``batch``: the loss, the
    gradients before the clip and the running statistics after it (on the
    CPU), and the logits of a deterministic forward before it."""
    t = resnet_trainer(dtype, dev)
    with torch.no_grad():
        logits = t.model(batch["image"].to(t.device))["pred"].float().cpu()
    kept = keep_reduced_gradients(t)
    loss = t.train_iter(batch)["loss"].item()
    return {"logits": logits, "loss": loss, "grads": {k: v.cpu() for k, v in kept.items()},
            "stats": {k: v.cpu() for k, v in running_stats(t.model).items()}}


def grad_distance(got: dict, want: dict) -> float:
    """The whole gradient's distance: sqrt of the sum over leaves of
    ``grad_rel`` squared."""
    return float(np.sqrt(sum(grad_rel(got[k], w) ** 2 for k, w in want.items())))


def zoo_phases(dev, card_note: dict) -> dict:
    """Phases 47-51: the FFN kernels with relu and the registry's other
    activations against their plain versions; a relu DeiT-Small (stage 0 and
    its frozen forward, counted); a post-norm identity-encoded DeiT-Small
    (stage 0 in fp32 against the plain versions, bf16 counted, its frozen
    forward, a masked layer against the CPU); ResNet-50 (fp32 on the card
    against the CPU, then bf16 stage 0 timed and profiled); ResNet-18's
    ``backbone_worker`` with a checkpoint and resume. Returns the kernels
    line's relu rows and the phases' seconds."""
    from torch.profiler import ProfilerActivity, profile

    from schemanet_torch.models.transformer import EncoderLayer
    from schemanet_torch.models.vit import get_model
    from schemanet_torch.ops.kernels import encoder_block as eb
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts
    from schemanet_torch.ops.kernels import mlp as mk
    from schemanet_torch.schema import init_parameters_
    from schemanet_torch.train import LaunchArgs, backbone_trainer
    from schemanet_torch.train.workers import backbone_worker
    from tests._torch_relu_gates import gate_flips, kernel_gate

    seconds, rows, errors = {}, {}, {}
    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(47)

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = now - t_phase
        t_phase = now
        phase("phase_seconds", phase_name=name, seconds=seconds[name], **card_note)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    def ffn_inputs(dim):
        f_ = 4 * dim
        return (rnd(BATCH, L_INST + 1, dim), (1 + rnd(dim, scale=0.1), rnd(dim, scale=0.1)),
                (rnd(f_, dim, scale=dim**-0.5), rnd(f_, scale=0.1), rnd(dim, f_, scale=f_**-0.5),
                 rnd(dim, scale=0.1)), rnd(BATCH, L_INST + 1, dim))

    def relu_bwd_compare(label, args, dt, tol):
        """fused_mlp_bwd with relu against its plain version in lock step:
        the plain version given the kernel's gate (read back from the
        kernel), within the tolerance of 3; every gate the two set apart a
        candidate of ``gate_candidates``. Returns the gate's read-back
        launches."""
        x, w1, b1, w2 = args[:4]
        got = mk.fused_mlp_bwd(*args)
        before = mk.fused_mlp_bwd.launches
        gate = kernel_gate(x, w1, b1, w2)
        reads = mk.fused_mlp_bwd.launches - before
        want, free = mk.fused_mlp_bwd_reference(*args, gate=gate), mk.fused_mlp_bwd_reference(*args)
        flips = gate_flips(gate, x, w1, b1)
        torch.cuda.synchronize()
        rels = [rel_err(a, b) for a, b in zip(got, want)]
        phase("compare", kernel=label, dtype=str(dt).split(".")[-1], shape=list(x.shape),
              rel_err=rels, max_abs_err=[abs_err(a, b) for a, b in zip(got, want)], tol=tol,
              free_running_rel_err=[rel_err(a, b) for a, b in zip(got, free)], **flips,
              rule="lock step: the plain version given the kernel's relu gate")
        require(all(r <= tol for r in rels), f"{label} {dt}: rel err {rels} > {tol}")
        require(flips["flips_outside_candidates"] == 0,
                f"{label} {dt}: gates set apart where no fp32 order can: {flips}")
        if dt == torch.bfloat16 or label not in errors:
            errors[label] = max(abs_err(a, b) for a, b in zip(got, want))
        return reads

    # 47. the FFN kernels with relu at the configs' widths, both dtypes, and
    # the forward-only activations at 384, against their plain versions
    inputs = {dim: ffn_inputs(dim) for dim in ZOO_WIDTHS}
    for dim, (x, ln, w, cot) in inputs.items():
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            sfx = f"_d{dim}" if dt == torch.bfloat16 else f"_fp32_d{dim}"
            xd, wd, cd = x.to(dt), tuple(t.to(dt) for t in w), cot.to(dt)
            before = {k: v for k, v in launch_counts().items() if k.endswith("_relu")}
            compare(f"ffn_block_relu{sfx}", eb.ffn_block, eb.ffn_block_reference, (xd, *ln, *w),
                    {"activation": "relu"}, dt, tol, errors)
            compare(f"fused_mlp_relu{sfx}", mk.fused_mlp, mk.fused_mlp_reference,
                    (xd, *wd, "relu", S0_DROPOUT, ZOO_SEED), {}, dt, tol, errors)
            reads = relu_bwd_compare(f"fused_mlp_bwd_relu{sfx}",
                                     (xd, *wd[:3], cd, "relu", S0_DROPOUT, ZOO_SEED), dt, tol)
            after = {k: v for k, v in launch_counts().items() if k.endswith("_relu")}
            want_after = {k: before[k] + 1 + (reads if k == "fused_mlp_bwd_relu" else 0)
                          for k in before}
            require(after == want_after, f"relu at {dim} {dt}: each kernel counted once (and "
                                         f"the gate's {reads} reads): {before} -> {after}")
            if dim == 384:
                for act in ZOO_FORWARD_ONLY:
                    before = launch_counts()
                    compare(f"ffn_block_{act}{sfx}", eb.ffn_block, eb.ffn_block_reference,
                            (xd, *ln, *w), {"activation": act}, dt, tol, errors)
                    compare(f"fused_mlp_{act}{sfx}", mk.fused_mlp, mk.fused_mlp_reference,
                            (xd, *wd, act), {}, dt, tol, errors)
                    moved = {k: v - before[k] for k, v in launch_counts().items()
                             if v != before[k]}
                    phase("launches", kernels=f"ffn_block_{act}{sfx}, fused_mlp_{act}{sfx}",
                          moved=moved)
                    require(moved.get("ffn_block") == 1 and moved.get("fused_mlp") == 1 and all(
                        k.startswith(("ffn_block", "fused_mlp")) and not k.endswith("_relu")
                        for k in moved), f"{act} at 384 {dt}: launches {moved}")
    # the relu rows of the kernels line, timed at DeiT-Small's serving
    # microbatch and stage-0 batch in bf16 (12,608 rows of 384 -> 1536 -> 384)
    x, ln, w, cot = inputs[384]
    x16, w16, c16 = x.to(torch.bfloat16), tuple(t.to(torch.bfloat16) for t in w), cot.to(
        torch.bfloat16)
    fwd_args = (x16, *w16, "relu", S0_DROPOUT, ZOO_SEED)
    bwd_args = (x16, *w16[:3], c16, "relu", S0_DROPOUT, ZOO_SEED)
    mlp_flops = 2 * ZOO_ROWS * 384 * 1536
    mlp_weights = nbytes(*w16[:3])
    F_ = torch.nn.functional
    with torch.no_grad():
        timed = {
            "ffn_block_relu": (ffn_work((x16, *ln, *w)),
                               lambda: eb.ffn_block(x16, *ln, *w, activation="relu"),
                               lambda: eb.ffn_block_reference(x16, *ln, *w, activation="relu"),
                               lambda: x16 + F_.linear(F_.relu(F_.linear(F_.layer_norm(
                                   x16, (384,), ln[0].to(x16.dtype), ln[1].to(x16.dtype), 1e-6),
                                   w16[0], w16[1])), w16[2], w16[3])),
            "fused_mlp_relu": ((2 * mlp_flops, 2 * nbytes(x16) + mlp_weights + nbytes(w16[3])),
                               lambda: mk.fused_mlp(*fwd_args),
                               lambda: mk.fused_mlp_reference(*fwd_args),
                               lambda: F_.linear(F_.relu(F_.linear(x16, w16[0], w16[1])), w16[2],
                                                 w16[3])),
            "fused_mlp_bwd_relu": ((5 * mlp_flops, 3 * nbytes(x16) + 2 * mlp_weights
                                    + nbytes(w16[3])),
                                   lambda: mk.fused_mlp_bwd(*bwd_args),
                                   lambda: mk.fused_mlp_bwd_reference(*bwd_args), None),
        }
        for name, (work, kern, plain, library) in timed.items():
            ms, plain_ms = time_ms(kern, TIME_ITERS), time_ms(plain, TIME_ITERS)
            bound_ms, bound_by = least_ms(*work, "bfloat16")
            rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None, max_abs_err=errors[f"{name}_d384"])
            if library is not None:
                rows[name]["library_note"] = {
                    "ms": time_ms(library, TIME_ITERS),
                    "calls": "F.layer_norm + F.linear + F.relu + F.linear + residual"
                    if name == "ffn_block_relu" else "F.linear + F.relu + F.linear (no dropout)"}
            phase("kernel_time", kernel=name, shape=[ZOO_ROWS, 384], dtype="bfloat16",
                  **rows[name], **card_note)
    del inputs, x, ln, w, cot, x16, w16, c16, fwd_args, bwd_args, timed
    torch.cuda.empty_cache()
    lap("47_ffn_activations")

    rng = np.random.default_rng(48)
    images = [torch.from_numpy(rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)).to(dev)
              for _ in range(BF16_STEPS)]
    labels = [torch.from_numpy(rng.integers(0, IN_CLASSES, size=BATCH)).to(dev)
              for _ in range(BF16_STEPS)]
    batches = [{"image": i, "label": lab} for i, lab in zip(images, labels)]
    layers = 12

    def vit_trainer(cfg, dtype):
        cfg = dict(cfg, training=dict(cfg["training"], dtype=dtype))
        return backbone_trainer(cfg, IN_STEPS_PER_EPOCH, seed=0, device=dev,
                                num_classes=IN_CLASSES)

    def counted(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, launch_counts()

    def expect(**nonzero):
        want = {name: 0 for name in launch_counts()}
        want.update(nonzero)
        return want

    train_kernels = ("fused_mhsa", "fused_mhsa_bwd", "fused_mlp", "fused_mlp_bwd", "fused_mhsa_tc",
                     "fused_mhsa_bwd_tc", "fused_mlp_tc", "fused_mlp_bwd_tc", "fused_mlp_wide",
                     "fused_mlp_bwd_wide", "fused_mlp_relu", "fused_mlp_bwd_relu")
    ln_kernels = ("fused_layernorm", "fused_layernorm_bwd", "fused_layernorm_bwd_vec")

    # 48. a relu DeiT-Small (vanilla_cfg naming no activation): 2 bf16
    # stage-0 steps and a frozen forward, counted
    tr = vit_trainer(relu_cfg(384, 6), "bfloat16")
    require(tr.model.transformer.layers[0].activation == "relu", "the default activation")
    losses, got = counted(lambda: [tr.train_iter(b)["loss"].item() for b in batches[:2]])
    want = expect(**{k: layers * 2 for k in train_kernels},
                  **{k: (2 * layers + 1) * 2 for k in ln_kernels})
    with torch.no_grad():
        logits, got_eval = counted(lambda: tr.model(images[0])["pred"])
    want_eval = expect(attn_block=layers, attn_block_tc=layers, ffn_block=layers,
                       ffn_block_tc=layers, ffn_block_relu=layers, fused_layernorm=1)
    phase("relu_deit_small", steps=2, batch=BATCH, losses=losses, launches=got, expected=want,
          frozen_launches=got_eval, frozen_expected=want_eval,
          frozen_finite=bool(torch.isfinite(logits).all()), **card_note)
    require(all(np.isfinite(losses)), f"relu DeiT-Small losses: {losses}")
    require(got == want, f"relu DeiT-Small stage-0 launches {got} != {want}")
    require(got_eval == want_eval and bool(torch.isfinite(logits).all()),
            f"relu DeiT-Small frozen forward launches {got_eval} != {want_eval}")
    relu_launches = {"fused_mlp_relu": got["fused_mlp_relu"],
                     "fused_mlp_bwd_relu": got["fused_mlp_bwd_relu"],
                     "ffn_block_relu": got_eval["ffn_block_relu"]}
    del tr, logits
    torch.cuda.empty_cache()
    lap("48_relu_deit_small")

    # 49. a post-norm DeiT-Small, identity position encoding: 3 fp32 steps
    # with dropout live against the plain versions (phase 12's rules) with
    # gelu and with relu, and each one's fp32 frozen forward against the plain
    # versions; 3 bf16 steps and a bf16 frozen forward counted with relu
    # (the per-op route: no whole-layer kernel); a masked layer against the CPU,
    # on the LayerNorm and FFN kernels
    def pn_fp32_run(cfg, track_sure):
        t = vit_trainer(cfg, "float32")
        out_losses, sure = [], {}
        for b in batches[:FP32_STEPS]:
            out_losses.append(t.train_iter(b)["loss"].item())
            if track_sure and not sure:
                sure = {k: p.grad.abs() > 1e-3 * p.grad.abs().max()
                        for k, p in t.model.named_parameters()}
        params = {k: p.detach().clone() for k, p in t.model.named_parameters()}
        with torch.no_grad():
            frozen = t.model(images[0])["pred"]
        del t
        torch.cuda.empty_cache()
        return out_losses, params, sure, frozen

    for act in ("gelu", "relu"):
        cfg = post_norm_cfg(384, 6, act)
        bound = 2 * cfg["training"]["optimizer"]["lr"] * FP32_STEPS
        if act == "gelu":
            losses_k, params_k, _, frozen_k = pn_fp32_run(cfg, False)
            losses_p, params_p, sure, frozen_p = with_plain(lambda: pn_fp32_run(cfg, True))
            replay = {}
        else:
            # relu: the plain run in lock step, given the kernel run's gates
            # (the free-running plain run reported beside it, not gated)
            gates, replay = [], {"calls": 0, "gates_set_apart": 0}
            with recording_relu_gates(gates):
                losses_k, params_k, _, frozen_k = pn_fp32_run(cfg, False)
            recorded = len(gates)

            def locked():
                with replaying_relu_gates(gates, replay):
                    return pn_fp32_run(cfg, True)

            losses_p, params_p, sure, frozen_p = with_plain(locked)
            require(recorded == replay["calls"] == FP32_STEPS * layers and not gates,
                    f"relu gates recorded {recorded}, replayed {replay}, left {len(gates)}")
            free_losses, free_params, _, _ = with_plain(lambda: pn_fp32_run(cfg, False))
            replay["free_running"] = sure_rule(params_k, free_params, sure, bound)
            replay["free_running_loss_rel_err"] = max(
                abs(a - b) / abs(b) for a, b in zip(losses_k, free_losses))
            del free_params
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
        worst = sure_rule(params_k, params_p, sure, bound)
        frozen_rel = rel_err(frozen_k, frozen_p)
        phase("post_norm_stage0_fp32", model=f"deit_small post-norm identity {act}",
              steps=FP32_STEPS, batch=BATCH, dropout=S0_DROPOUT, losses=losses_k,
              plain_losses=losses_p, loss_rel_err=loss_rel, tol=1e-4, bound=bound,
              frozen_rel_err=frozen_rel, frozen_tol=FP32_TOL, relu_gate_replay=replay, **worst)
        require(loss_rel <= 1e-4, f"post-norm {act} stage-0 fp32 losses differ by {loss_rel}")
        require(worst["within_bound"] and worst["sure_ok"], f"post-norm {act} stage-0 fp32: {worst}")
        require(frozen_rel <= FP32_TOL, f"post-norm {act} fp32 frozen forward: {frozen_rel}")
        del params_k, params_p, sure, frozen_k, frozen_p
    tr = vit_trainer(post_norm_cfg(384, 6), "bfloat16")
    losses, got = counted(lambda: [tr.train_iter(b)["loss"].item() for b in batches[:3]])
    want = expect(**{k: layers * 3 for k in train_kernels},
                  **{k: (2 * layers + 1) * 3 for k in ln_kernels})
    with torch.no_grad():
        logits, got_eval = counted(lambda: tr.model(images[0])["pred"])
    want_eval = expect(fused_mhsa=layers, fused_mhsa_tc=layers, fused_mlp=layers,
                       fused_mlp_tc=layers, fused_mlp_wide=layers, fused_mlp_relu=layers,
                       fused_layernorm=2 * layers + 1)
    phase("post_norm_stage0_bf16", steps=3, batch=BATCH, losses=losses, launches=got,
          expected=want, frozen_launches=got_eval, frozen_expected=want_eval,
          frozen_finite=bool(torch.isfinite(logits).all()), **card_note)
    require(all(np.isfinite(losses)), f"post-norm bf16 losses: {losses}")
    require(got == want, f"post-norm stage-0 launches {got} != {want}")
    require(got_eval == want_eval and bool(torch.isfinite(logits).all()),
            f"post-norm frozen forward launches {got_eval} != {want_eval}")
    del tr, logits
    torch.cuda.empty_cache()
    layer = EncoderLayer(6, 384, 1536, "relu", 1e-6, None, pre_norm=False)
    init_parameters_(layer, torch.Generator().manual_seed(49))
    seq = torch.randn(8, L_INST + 1, 384, generator=g)
    keep = torch.tril(torch.ones(L_INST + 1, L_INST + 1, dtype=torch.bool))
    mask = torch.where(keep, 0.0, -1e9)[None, None]
    with torch.no_grad():
        want_m, _ = layer(seq, attn_mask=mask)
        got_m, masked_launches = counted(
            lambda: layer.to(dev)(seq.to(dev), attn_mask=mask.to(dev))[0])
    masked_rel = rel_err(got_m.cpu(), want_m)
    masked_launches = {k: v for k, v in masked_launches.items() if v}
    phase("masked_layer", shape=list(seq.shape), rel_err=masked_rel, tol=1e-5,
          launches=masked_launches, **card_note)
    require(masked_rel <= 1e-5, f"a masked layer on the card differs from the CPU: {masked_rel}")
    # JAX declines the attention kernels and whole-layer fusion for a mask,
    # and keeps the LayerNorm and FFN kernels
    require(masked_launches.get("fused_layernorm") == 2 and masked_launches.get("fused_mlp") == 1
            and masked_launches.get("fused_mlp_relu") == 1
            and not any(k.startswith(("fused_mhsa", "attn_block", "ffn_block"))
                        for k in masked_launches),
            f"a masked layer's launches: {masked_launches}")
    del layer, seq, got_m, want_m, batches, images, labels
    torch.cuda.empty_cache()
    lap("49_post_norm_deit_small")

    # 50. ResNet-50 at full width (224^2, 1000 classes): one step on the
    # card against the CPU at batch 8, in fp32 (TF32 off) and in fp64, then
    # bf16 stage 0 timed and profiled
    rng = np.random.default_rng(50)
    b8 = {"image": torch.from_numpy(rng.normal(size=(RN_FP32_BATCH, RN_IMG, RN_IMG, 3)).astype(
        np.float32)), "label": torch.from_numpy(rng.integers(0, RN_CLASSES, size=RN_FP32_BATCH))}
    steps = {(dtype, where): resnet_step(dtype, dev if where == "card" else "cpu", b8)
             for dtype in ("float32", "float64") for where in ("card", "cpu")}
    torch.cuda.empty_cache()
    compared = {}
    for dtype in ("float32", "float64"):
        card, host = steps[(dtype, "card")], steps[(dtype, "cpu")]
        grads = leaf_rel(card["grads"], host["grads"])
        compared[dtype] = {
            "logits_rel_err": rel_err(card["logits"], host["logits"]),
            "loss_rel_err": abs(card["loss"] - host["loss"]) / abs(host["loss"]),
            "running_stats_rel_err": max(leaf_rel(card["stats"], host["stats"]).values()),
            "grads_rel_err_max": max(grads.values()),
            "grads_rel_err_max_leaf": max(grads, key=grads.get)}
    f64 = steps[("float64", "card")]["grads"]
    compared["float32"].update(  # how far fp32 resolves the step's gradients
        card_vs_fp64=grad_distance(steps[("float32", "card")]["grads"], f64),
        cpu_vs_fp64=grad_distance(steps[("float32", "cpu")]["grads"], f64))
    phase("resnet50_card_vs_cpu", batch=RN_FP32_BATCH, tf32=False, **compared,
          losses={f"{d}_{w}": v["loss"] for (d, w), v in steps.items()},
          tol={"fp32": RN_TOL, "fp64": RN_TOL64}, **card_note)
    for dtype, tol in (("float32", RN_TOL), ("float64", RN_TOL64)):
        c = compared[dtype]
        require(c["logits_rel_err"] <= tol["logits"] and c["loss_rel_err"] <= tol["loss"]
                and c["running_stats_rel_err"] <= tol["running_stats"],
                f"ResNet-50 {dtype} card against CPU: {c}")
    require(compared["float64"]["grads_rel_err_max"] <= RN_TOL64["gradients"],
            f"ResNet-50 fp64 gradients card against CPU: {compared['float64']}")
    del steps, f64, b8
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(50)
    rn_batches = [{"image": torch.randn(RN_BATCH, RN_IMG, RN_IMG, 3, generator=gen, device=dev),
                   "label": torch.randint(0, RN_CLASSES, (RN_BATCH,), generator=gen, device=dev)}
                  for _ in range(2)]
    t = backbone_trainer(resnet_cfg("bfloat16"), IN_STEPS_PER_EPOCH, seed=0, device=dev,
                         num_classes=RN_CLASSES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    losses, ms = [], []
    for i in range(RN_WARMUP + RN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(t.train_iter(rn_batches[i % 2])["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launched = {k: v for k, v in launch_counts().items() if v}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    prof = None
    for attempt in range(1, 6):  # a session without device events is taken again
        prof = profiled_step(lambda: t.train_iter(rn_batches[0]))
        if prof is not None:
            break
        phase("profile_empty", attempt=attempt, iters=1)
    p50 = float(np.percentile(ms[RN_WARMUP:], 50))
    phase("resnet50_stage0_bf16", batch=RN_BATCH, img=RN_IMG, steps=RN_STEPS,
          warmup=RN_WARMUP, losses=losses, step_ms=ms[RN_WARMUP:], p50_step_ms=p50,
          images_per_s=RN_BATCH / p50 * 1e3, peak_memory_gb=peak_gb, profiled=prof,
          kernel_launches=launched, **card_note)
    require(all(np.isfinite(losses)), f"ResNet-50 bf16 losses: {losses}")
    require(prof is not None, "ResNet-50: five profiler sessions came back empty")
    require(not launched, f"ResNet-50 launched a hand-written kernel: {launched}")
    del t, rn_batches
    torch.cuda.empty_cache()
    lap("50_resnet50")

    # 51. backbone_worker with resnet18 on the synthetic dataset: a two-epoch
    # run, and a one-epoch run resumed for the second, bit for bit
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_resnet18_")
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        def worker_cfg(epochs):
            return {"dataset": RW_DATA, "model": {"name": "resnet18"},
                    "loss": {"name": "ce_loss", "weight_dict": {"cls": 1.0}},
                    "training": {"optimizer": {"name": "AdamW", "lr": 1e-3},
                                 "lr_schedule": {"name": "constant"}, "train_epochs": epochs,
                                 "batch_size": 32, "num_workers": 1, "print_interval": 100,
                                 "val_interval": 1000},
                    "validation": {"batch_size": 32, "num_workers": 1}}

        full = backbone_worker(worker_cfg(2), LaunchArgs(
            seed=0, log_dir=os.path.join(work_dir, "full"), device=str(dev)))
        cut_dir = os.path.join(work_dir, "cut")
        backbone_worker(worker_cfg(1), LaunchArgs(seed=0, log_dir=cut_dir, device=str(dev)))
        resumed = backbone_worker(worker_cfg(2), LaunchArgs(seed=0, log_dir=cut_dir,
                                                            resume="auto", device=str(dev)))
        want_state, got_state = full["trainer"].state_dict(), resumed["trainer"].state_dict()
        differs = same_snapshots({"model": want_state["model"], "opt": want_state["optimizer"]},
                                 {"model": got_state["model"], "opt": got_state["optimizer"]})
        moved = not torch.equal(want_state["model"]["bn1.mean"].cpu(), torch.zeros(64))
        phase("resnet18_worker", steps=full["trainer"].step,
              resumed_from_epoch=resumed["trainer"].start_epoch, bitwise=not differs,
              differs=differs[:20], running_stats_moved=moved, eval=full["eval"],
              resumed_eval=resumed["eval"], **card_note)
        require(not differs and resumed["eval"] == full["eval"],
                f"ResNet-18 worker resumed differs in {differs[:20]}")
        require(moved and resumed["trainer"].start_epoch == 1 and full["trainer"].step == 4,
                "ResNet-18 worker: no steps, or no resume")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    lap("51_resnet18_worker")
    for name in rows:
        rows[name]["launches"] = relu_launches[name]
    return {"rows": rows, "seconds": seconds}


def run_grid_phases(dev, card_note: dict) -> dict:
    """``grid_phases`` in a temporary directory it removes."""
    torch.cuda.empty_cache()
    grid_dir = tempfile.mkdtemp(prefix="chip_smoke_grid_")
    try:
        return grid_phases(dev, grid_dir, card_note)
    finally:
        shutil.rmtree(grid_dir, ignore_errors=True)


# -- phases 53-55: the kernel policy, the optimizers, the feature dump --------

# each policy field's plain value, and the launch counters its plain value
# stops on the stage-4 path ("s4") and the stage-0 path ("s0")
POLICY_PLAIN = {"attn": "xla", "block": "xla", "ln": "xla", "mlp": "xla", "gnn_ln": "xla",
                "graphconv": "xla", "vq": "xla", "static_embed_bwd": "blocked",
                "embed_bwd": "xla", "atlas_opt": "xla"}
_LN_COUNTERS = ("fused_layernorm", "fused_layernorm_bwd", "fused_layernorm_bwd_vec")
POLICY_COUNTERS = {
    "block": {"s4": ("attn_block", "attn_block_hmean", "attn_block_tc", "ffn_block",
                     "ffn_block_tc", "ffn_block_wide", "ffn_ln_rows", "ffn_block_relu")},
    "attn": {"s0": ("fused_mhsa", "fused_mhsa_bwd", "fused_mhsa_tc", "fused_mhsa_bwd_tc")},
    "mlp": {"s0": ("fused_mlp", "fused_mlp_bwd", "fused_mlp_tc", "fused_mlp_bwd_tc",
                   "fused_mlp_wide", "fused_mlp_bwd_wide", "fused_mlp_relu",
                   "fused_mlp_bwd_relu")},
    "ln": {"s0": _LN_COUNTERS},
    "gnn_ln": {"s4": _LN_COUNTERS},
    "graphconv": {"s4": ("sym_conv", "sym_conv_bwd", "sym_conv_tc", "sym_conv_bwd_tc")},
    "vq": {"s4": ("vq_assign", "vq_assign_tc")},
    "atlas_opt": {"s4": ("adamw_project_rows", "adamw_project_rows_bf16",
                         "adamw_project_rows_vec")},
}


def policy_expected(field: str, path: str, base: dict) -> dict:
    """The launches of one step with ``field`` alone plain, from the default
    run's ``base``: the field's counters 0, every other counter as in
    ``base``. Two fields share a kernel: the embedding lookups (the class
    lookup, planned, is ``static_embed_bwd``'s; the instance lookup
    ``embed_bwd``'s: one ``embed_grad`` launch each) and, with ``block``
    plain, the frozen layers take the per-op route, whose kernels the other
    fields keep: a ``fused_mhsa`` (the encode layer's head-mean takes the
    per-op attention instead), two ``fused_layernorm`` and a ``fused_mlp`` a
    layer."""
    want = dict(base)
    for name in POLICY_COUNTERS.get(field, {}).get(path, ()):
        want[name] = 0
    if path == "s4" and field in ("embed_bwd", "static_embed_bwd"):
        want["embed_grad"] -= 1
        want["embed_grad_vec"] -= 1
        if field == "static_embed_bwd":
            want["embed_grad_planned"] = 0
    if path == "s4" and field == "block":
        for name, more in (("fused_mhsa", FROZEN_LAYERS - 1), ("fused_mhsa_tc", FROZEN_LAYERS - 1),
                           ("fused_layernorm", 2 * FROZEN_LAYERS), ("fused_mlp", FROZEN_LAYERS),
                           ("fused_mlp_tc", FROZEN_LAYERS)):
            want[name] += more
    return want


def policy_phase(tr, batch, path: str, card_note: dict) -> dict:
    """Phase 53 on one path (``s4``: the CIFAR stage-4 bf16 step, ``s0``:
    stage 0): from one state, the step under the default policy, then with
    each field of ``ops/policy.py`` alone plain (``policy_expected``), then
    with every field plain, whose loss and updated state must equal bit for
    bit those of ``with_plain`` from the same state (on the stage-4 path with
    ``block: xla`` on both sides: ``with_plain`` puts ``attn_block_reference``
    in the frozen layers, the policy JAX's per-op route). Restores the state
    and the default policy."""
    from schemanet_torch.ops import policy
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts

    snap = trainer_snapshot(tr)

    def run(**fields):
        policy.reset_policy()
        policy.set_policy(**fields)
        restore_snapshot(tr, snap)
        torch.cuda.synchronize()
        reset_launch_counts()
        loss = tr.train_iter(batch)["loss"].detach().clone()
        torch.cuda.synchronize()
        return loss, launch_counts()

    report = {}
    try:
        base_loss, base = run()
        for field in POLICY_PLAIN:
            loss, counts = run(**{field: POLICY_PLAIN[field]})
            want = policy_expected(field, path, base)
            report[field] = {"ok": counts == want, "finite": bool(torch.isfinite(loss)),
                             "launches": {k: v for k, v in counts.items() if v},
                             "differs": {k: (counts[k], want[k]) for k in counts
                                         if counts[k] != want[k]}}
        loss_p, counts_p = run(**POLICY_PLAIN)
        got = trainer_snapshot(tr)
        ref_fields = {"block": "xla"} if path == "s4" else {}
        loss_r, _ = with_plain(lambda: run(**ref_fields))
        differs = same_snapshots(got, trainer_snapshot(tr))
        del got
    finally:
        policy.reset_policy()
        restore_snapshot(tr, snap)
        del snap
        torch.cuda.empty_cache()
    all_plain = {"launches": {k: v for k, v in counts_p.items() if v},
                 "loss_bitwise": torch.equal(loss_p, loss_r), "state_differs": differs[:20]}
    phase("kernel_policy", path=path, default_launches={k: v for k, v in base.items() if v},
          default_loss=base_loss.item(), fields=report, all_plain=all_plain,
          all_plain_loss=loss_p.item(), reference="with_plain" + (" and block: xla" if ref_fields
                                                                   else ""), **card_note)
    bad = {f: r["differs"] for f, r in report.items() if not r["ok"] or not r["finite"]}
    require(not bad, f"kernel policy ({path}): a field's plain value launched {bad}")
    require(not all_plain["launches"], f"kernel policy ({path}): every field plain, yet "
                                       f"{all_plain['launches']} launched")
    require(all_plain["loss_bitwise"] and not differs,
            f"kernel policy ({path}): every field plain differs from with_plain in {differs[:20]}")
    return report


OPTIMIZERS = {"sgd": {"name": "sgd", "lr": 0.001},
              "adam": {"name": "adam", "lr": 0.001},
              "adafactor": {"name": "AdamW", "lr": 0.001, "weight_decay": 0.05, "factored": True}}


def optimizer_training(training: dict, name: str) -> dict:
    """A ``training`` block under optimizer ``name`` (AdamW: as it is). Under
    ``adafactor`` the parameter groups lose their low-memory keys: with them
    the JAX ``make_one`` keeps a group on ``adamw_lowmem`` even when
    ``factored`` (``schemanet_tpu/train/common.py``), and the atlas would not
    be factored."""
    out = copy.deepcopy(training)
    if name == "adamw":
        return out
    out["optimizer"] = dict(OPTIMIZERS[name])
    if name == "adafactor":
        for group in out.get("param_groups") or ():
            group["cfg"] = {k: v for k, v in (group.get("cfg") or {}).items()
                            if k not in ("moment_dtype", "nu_dtype", "nu_factored_min_size")}
    return out


def optimizer_phase_bf16(state: dict, batches: list, dev, card_note: dict) -> dict:
    """Phase 54 at full width: the ImageNet DeiT-Small stage-4 step (K 1000,
    bf16, the YAML's groups) from phase 27's state under AdamW, SGD, Adam and
    factored AdamW, 3 steps each: finite losses, p50 step ms and peak memory
    beside AdamW's; no ``adamw_project_rows`` launch but under AdamW, and the
    frozen forward's and GNN's kernels launched as under AdamW."""
    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts

    out = {}
    for name in ("adamw", *OPTIMIZERS):
        tr = in_stage4_trainer(state, "bfloat16", dev, optimizer=name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        ms, losses = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(tr.train_iter(b)["loss"].item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = launch_counts()
        hot = {k.split(".")[-1]: sorted(h.state) for k, h in tr.hot.items()}
        out[name] = {"losses": losses, "step_ms": ms, "p50_ms": float(np.median(ms)),
                     "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
                     "launches": {k: v for k, v in counts.items() if v}, "hot_state": hot}
        del tr
        torch.cuda.empty_cache()
    base = out["adamw"]["launches"]
    same = ("attn_block", "attn_block_tc", "attn_block_hmean", "ffn_block", "ffn_block_tc",
            "sym_conv", "sym_conv_bwd", "vq_assign", "fused_layernorm", "fused_layernorm_bwd",
            "embed_grad")
    phase("optimizers_bf16", classes=IN_CLASSES, steps=len(batches), batch=BATCH, runs=out,
          **card_note)
    for name, r in out.items():
        require(all(np.isfinite(r["losses"])), f"{name}: ImageNet stage-4 losses {r['losses']}")
        require(all(r["launches"].get(k, 0) == base.get(k, 0) > 0 for k in same),
                f"{name}: the path's kernels launched {r['launches']}, not as under AdamW {base}")
        if name != "adamw":
            require(not r["launches"].get("adamw_project_rows"),
                    f"{name}: adamw_project_rows launched under another optimizer")
    require(base.get("adamw_project_rows") == 2 * len(batches), "AdamW: no fused atlas update")
    require(out["adafactor"]["hot_state"]["edge_weights"] == ["v_col", "v_row"],
            f"factored AdamW: the edge weights' state {out['adafactor']['hot_state']}")
    return out


def optimizer_phase_fp32(make_trainer, batches: list, card_note: dict) -> dict:
    """Phase 54 in fp32 at K 100: each of SGD, Adam and factored AdamW
    against the plain versions by phase 8's rules (``stage4_fp32_vs_plain``:
    free run, lock step, ``run_to_run_bitwise``; the tight rule reported, as
    phase 28), then resumed from step 2 through a checkpoint (``state_dict``
    saved and loaded in a new trainer) bit for bit the uninterrupted third
    step."""
    import io

    out = {}
    for name, opt in OPTIMIZERS.items():
        stage4_fp32_vs_plain(lambda: make_trainer(name), batches, opt["lr"], FROZEN_LAYERS,
                             label=f"optimizer_fp32_{name}", tight=False, optimizer=name,
                             classes=IN_FP32_CLASSES)
        tr = make_trainer(name)
        for b in batches[:2]:
            tr.train_iter(b)
        buf = io.BytesIO()
        torch.save(tr.state_dict(), buf)
        tr.train_iter(batches[2])
        want = trainer_snapshot(tr)
        del tr
        resumed = make_trainer(name)
        buf.seek(0)
        resumed.load_state_dict(torch.load(buf, weights_only=False))
        resumed.train_iter(batches[2])
        differs = same_snapshots(want, trainer_snapshot(resumed))
        del resumed, want, buf
        torch.cuda.empty_cache()
        out[name] = differs
        phase("optimizer_resume", optimizer=name, resumed_at_step=2, bitwise=not differs,
              differs=differs[:20], **card_note)
        require(not differs, f"{name}: resumed from step 2, the third step differs in "
                             f"{differs[:20]}")
    return out


def saved_features_phase(feats, init_state, card_note: dict) -> dict:
    """Phase 55: ``cluster_features`` (the ``--saved-features-fp`` path's
    clustering) on stage 1's 1,000,000 x 192 fp32 features on the card,
    counted and timed; against the plain versions by stage 1's rules, in
    lock step from its k-means++ init; whether h5py is importable, and where
    it is, the dump's round trip."""
    import importlib.util

    from schemanet_torch.ops.kernels import launch_counts, reset_launch_counts
    from schemanet_torch.pipeline.extract_ingredients import (LLOYD_SAMPLE, append_h5,
                                                              cluster_features,
                                                              read_saved_features)

    has_h5py = importlib.util.find_spec("h5py") is not None
    print(json.dumps({"h5py_importable": has_h5py}), flush=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    centers = cluster_features(feats, NUM_CODES, seed=0, lloyd_iters=S1_LLOYD_ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    minibatches = -(-len(feats) // 1024)
    lock, agree = kmeans_vs_plain(feats, feats[:LLOYD_SAMPLE], init_state, NUM_CODES,
                                  with_plain)
    round_trip = None
    if has_h5py:
        path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_h5_"), "saved_features.h5")
        try:
            part = feats[:100_000]
            append_h5(path, part[:60_000])
            append_h5(path, part[60_000:])
            round_trip = bool(np.array_equal(read_saved_features(path), part.cpu().numpy()))
        finally:
            shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    phase("saved_features", features=len(feats), codes=NUM_CODES, seconds=seconds,
          launches={k: v for k, v in counts.items() if v},
          expected_vq_assign=minibatches + S1_LLOYD_ITERS, id_agreement=agree,
          h5py_importable=has_h5py, h5_round_trip=round_trip,
          tol={"ids": 0.999, "near_tie": 1e-5, "centers": 1e-4}, **lock, **card_note)
    require(bool(torch.isfinite(centers).all()) and tuple(centers.shape) == (NUM_CODES, EMBED_DIM),
            "cluster_features: centers")
    require(centers.is_cuda and counts["vq_assign"] == minibatches + S1_LLOYD_ITERS > 0,
            f"cluster_features: vq_assign launched {counts['vq_assign']} times")
    require(agree >= 0.999 and lock["near_ties_only"] and lock["center_err"] <= 1e-4,
            f"cluster_features against the plain versions: {lock}, ids {agree}")
    require(round_trip in (None, True), "saved_features.h5: the rows read back differ")
    return {"seconds": seconds}


GATE_SCRIPTS = ("tools/ab_graph_precision_torch.sh", "tools/ab_atlas_moments_torch.sh")
GATE_TIMEOUT_S = {"tools/ab_graph_precision_torch.sh": 600, "tools/ab_atlas_moments_torch.sh": 300}
GATE_GAP, GATE_FLOOR = 0.005, 0.10  # within 0.5 pt of top-1; ten times chance at K 100
GATE_EXTRA = "-o training.max_keep=1"  # a checkpoint's retention, not the recipe


def yaml_configs_phase(card_note: dict) -> int:
    """Phase 56: every shipped YAML config through the port's reader, with
    PyYAML refused in this process; the count."""
    import importlib.util

    from schemanet_torch.utils.config import get_cfg

    root = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, files in os.walk(os.path.join(root, "configs"))
                   for f in files if f.endswith(".yaml"))
    t0 = time.perf_counter()
    with mock.patch.dict(sys.modules, {"yaml": None}):  # any import of PyYAML now raises
        read = {path: get_cfg(os.path.join(root, path)) for path in paths}
    seconds = time.perf_counter() - t0
    mappings = sum(isinstance(cfg, dict) and bool(cfg) for cfg in read.values())
    phase("yaml_configs", files=len(paths), mappings=mappings, seconds=seconds,
          pyyaml_installed=importlib.util.find_spec("yaml") is not None, **card_note)
    require(paths and mappings == len(paths),
            f"{len(paths) - mappings} of {len(paths)} shipped configs did not read to a mapping")
    return len(paths)


def gate_phases(card_note: dict) -> dict:
    """Phases 56-57: the shipped YAML, then the two accuracy gates at the JAX
    recipe (``GATE_SCRIPTS``), each a subprocess, under a work directory
    deleted afterwards; returns each phase's seconds."""
    seconds = {}
    t0 = time.perf_counter()
    yaml_configs_phase(card_note)
    seconds["56_yaml_configs"] = time.perf_counter() - t0
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_gates_")
    run = os.path.join(work, "ab")
    env = dict(os.environ, AB_RUN=run, AB_EXTRA=GATE_EXTRA, PYTHON=sys.executable)
    verdicts = {}
    try:
        for script in GATE_SCRIPTS:
            t0 = time.perf_counter()
            proc = subprocess.run(["sh", script], cwd=root, env=env, capture_output=True,
                                  text=True, timeout=GATE_TIMEOUT_S[script])
            took = time.perf_counter() - t0
            lines = [line for line in proc.stdout.splitlines() if line.startswith('{"gate"')]
            verdict = json.loads(lines[-1]) if lines else {}
            name = verdict.get("gate", script)
            verdicts[name] = verdict
            seconds[f"57_{name}"] = took
            phase("gate", script=script, exit_code=proc.returncode, seconds=took,
                  final_eval_lines=[line for line in proc.stdout.splitlines()
                                    if ": final eval: " in line and " cli INFO" not in line],
                  verdict=verdict, stdout_tail="" if proc.returncode == 0 else proc.stdout[-3000:],
                  stderr_tail="" if proc.returncode == 0 else proc.stderr[-3000:], **card_note)
            require(proc.returncode == 0 and verdict.get("pass") is True,
                    f"{script}: exit code {proc.returncode}, verdict {verdict.get('pass')}")
            require(all(s["exit_code"] == 0 for s in verdict["stages"].values()),
                    f"{script}: a stage failed ({verdict['stages']})")
            if name == "graph_precision":
                arms = verdict["arms"]
                require(set(arms) == {"default", "highest"}, f"graph_precision arms {set(arms)}")
                require(abs(arms["highest"]["top1"] - arms["default"]["top1"]) <= GATE_GAP,
                        f"graph_precision: |default - highest| top-1 > {GATE_GAP} ({arms})")
                require(arms["default"]["top1"] >= GATE_FLOOR,
                        f"graph_precision: the default arm under {GATE_FLOOR} top-1 ({arms})")
                ev = verdict["eval_worker"]
                require(ev["equal"] and ev["counts"] == ev["final_eval_counts"],
                        f"eval_worker on the default arm's best checkpoint: {ev}")
                for arm in ("default", "highest"):  # the moments gate reads only their logs
                    ckpt = os.path.join(run, f"schema_{arm}", "ckpt")
                    for f in os.listdir(ckpt):
                        if f.endswith(".pt"):
                            os.remove(os.path.join(ckpt, f))
            else:
                arms = verdict["arms"]
                require(set(arms) == {"fp32", "bf16", "factored"}, f"atlas_moments arms {arms}")
                require(abs(arms["bf16"]["top1"] - arms["fp32"]["top1"]) <= GATE_GAP,
                        f"atlas_moments: |bf16 - fp32| top-1 > {GATE_GAP} ({arms})")
                require(arms["fp32"]["top1"] >= GATE_FLOOR,
                        f"atlas_moments: the fp32 arm under {GATE_FLOOR} top-1 ({arms})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    stages = verdicts["atlas_moments"]["stages"]
    for gate, verdict in verdicts.items():
        for arm, r in verdict["arms"].items():
            log = {"default": "schema_default", "fp32": "schema_default",
                   "highest": "schema_highest"}.get(arm, f"schema_mom_{arm}")
            phase("gate_arm", gate=gate, arm=arm, role=r["role"], top1=r["top1"], top5=r["top5"],
                  steps=r["steps"], gap=r.get("gap"), verdict=r["verdict"],
                  stage4_seconds=stages[log]["seconds"], **card_note)
    first = {k: stages[k]["seconds"] for k in ("vanilla", "extract", "export", "init")}
    phase("gate_stages", seconds=first, stages_0_3=sum(first.values()),
          eval_worker=stages["eval_default"]["seconds"], **card_note)
    return seconds


def main(grid_only: bool = False, gates_only: bool = False) -> None:
    """Every phase; ``grid_only``: phases 1-2 and 40-42, with the grid's
    kernel rows; ``gates_only``: phases 1-2, 56 and 57."""
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
    from schemanet_torch.ops.kernels import (launch_counts, launch_counts_by_shape,
                                             reset_launch_counts)
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
    import importlib.util

    has_networkx = importlib.util.find_spec("networkx") is not None  # the GraphML export's
    phase("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda, networkx=has_networkx)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          compile_seconds=_build.build_seconds, library=str(_build.library_path().name))
    # 53. the resolved kernel policy, every field, so that a stray
    # SCHEMANET_* variable shows
    from schemanet_torch.ops import policy

    print(json.dumps({"kernel_policy": policy.resolved()}), flush=True)
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
    # (4 pairs). quant.cu (phase 43): quantize_rows_kernel at 6 pieces a
    # lane in 2 dtypes, int8_gemm_kernel in 2 output dtypes. The FFN
    # kernels that compute the activation are instances for it (ffn.cuh
    # ffn_act): bf16 forwards for gelu, relu and the run-time
    # code (x3), bf16 backwards for gelu and relu (x2), fp32 ones for gelu and
    # the run-time code (x2): mlp.cu's tc_kernel 4 x 3 + 4 x 2 + 1, its wide
    # fc1 gemm_wg x3, gemm_dual x2, gemm_fma + 2; encoder_block.cu's
    # ffn_tc_kernel 5 x 3, ffn_tf32_kernel 5 x 2, the wide fc1's linear_tf32
    # x2 and gemm_wg x3
    for source, tag, count in (("attention.cu", "mhsa_tc", 16), ("graphconv.cu", "tc_kernel", 8),
                               ("mlp.cu", "tc_kernel", 21), ("mlp.cu", "_wg_kernel", 10),
                               ("mlp.cu", "gemm_dual", 2), ("mlp.cu", "gemm_fma", 7),
                               ("mlp.cu", "col_sum", 1), ("encoder_block.cu", "linear_tc", 2),
                               ("encoder_block.cu", "linear_tf32", 4),
                               ("encoder_block.cu", "gemm_wg", 6),
                               ("encoder_block.cu", "ln_rows_bf16", 1),
                               ("encoder_block.cu", "attn_tf32", 3),
                               ("encoder_block.cu", "ln_stats", 1),
                               ("encoder_block.cu", "ffn_tc_kernel", 15),
                               ("encoder_block.cu", "ffn_tf32_kernel", 10), ("vq.cu", "vq_tc", 2),
                               ("layernorm.cu", "ln_bwd_kernel", 18),
                               ("layernorm.cu", "ln_param_sum", 1), ("embed_bwd.cu", "embed_", 6),
                               ("atlas_opt.cu", "adamw_rows_warp", 16),
                               ("atlas_opt.cu", "adamw_rows_block", 4),
                               ("quant.cu", "quantize_rows_kernel", 12),
                               ("quant.cu", "int8_gemm_kernel", 2)):
        tc_ptxas = {name: dict(zip(("registers", "spill_stores", "spill_loads"), r))
                    for name, r in ptxas_report(build_log, source).items() if tag in name}
        phase("ptxas", source=source, tag=tag, kernels=tc_ptxas)
        require(len(tc_ptxas) == count,
                f"ptxas reported {len(tc_ptxas)} {tag} kernels in {source}, not {count}")
        require(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in tc_ptxas.values()),
                f"a kernel of {source} ({tag}) spills to local memory")

    if gates_only:
        gates = gate_phases(card_note)
        phase("gate_seconds", total=sum(gates.values()), **gates, **card_note)
        phase("total", seconds=time.perf_counter() - t_start, **card_note)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if grid_only:
        grid = run_grid_phases(dev, card_note)
        phase("total", seconds=time.perf_counter() - t_start, **card_note)
        print(json.dumps({"grid_kernels": grid["rows"]}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return

    # 3. each serving kernel against its plain version at the serving shapes
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.float32, gen=None):
        return (torch.randn(*shape, generator=gen or g) * scale).to(dev, dtype)

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

    def plain_layernorm(fn):
        """fn with the plain LayerNorm in place of the kernels, the rest as is."""
        with mock.patch.object(lnk, "fused_layernorm", lnk.fused_layernorm_plain):
            return fn()

    def median(xs):
        return float(np.percentile(xs, 50))

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
        TRAIN_CFG["optimizer"]["lr"], FROZEN_LAYERS)

    # 9. the training step in bf16: the main path, counted
    tr16 = trainer(torch.bfloat16, "default")
    torch.cuda.synchronize()
    reset_launch_counts()
    metrics = [tr16.train_iter(batch) for batch in batches]
    torch.cuda.synchronize()
    train_launches = launch_counts()
    train_shapes = launch_counts_by_shape()
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
    # the GNN's GraphConv and LayerNorm launches by shape: class graphs
    # [K, V_max, D] and instance graphs [bs, L, D] (rows K V_max and bs L),
    # half of each kernel's launches each
    gnn_path, gnn_rest = row_launches(train_shapes, GNN_ROWS)
    want_rows = {name: GNN_CONVS // 2 * BF16_STEPS for name in GNN_ROWS}
    phase("train_bf16_by_shape", launches=gnn_path, expected=want_rows, other_shapes=gnn_rest)
    require(gnn_path == want_rows and not gnn_rest,
            f"stage-4 GraphConv/LayerNorm launches by shape {gnn_path}, others {gnn_rest} != "
            f"{want_rows}")

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
    # the same at the instance graphs' shape [64, 196, 256]
    conv_args = cases["sym_conv_instance"](torch.bfloat16)[2]
    bwd_args = train_cases["sym_conv_bwd_instance"](torch.bfloat16)[2]
    esym = gc.symmetrize_edges(conv_args[0])
    f16, g16 = bwd_args[1], bwd_args[2]
    phase("kernel_time", kernel="sym_conv_instance_device", dtype="bfloat16",
          shape=list(f16.shape), device_ms={
              "sym_conv_instance": device_ms(lambda: gc.sym_conv(*conv_args)),
              "sym_conv_bwd_instance": device_ms(lambda: gc.sym_conv_bwd(*bwd_args))},
          ms={k: times[k][0] for k in ("sym_conv_instance", "sym_conv_bwd_instance")},
          note="bmm_*: torch.bmm on a pre-formed E_sym, the products alone; not library_ms",
          bmm_fwd_ms=time_ms(lambda: torch.bmm(esym, conv_args[1]), TIME_ITERS),
          bmm_bwd_ms=time_ms(bwd_products, TIME_ITERS), **card_note)
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
    for attempt in range(1, 6):  # a session without device events is taken again
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in batches[:3]:
                tr16.train_iter(batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_kernel = device_time_by_name(prof)
        busy_us = sum(by_kernel.values())
        if busy_us:
            break
        phase("profile_empty", attempt=attempt, iters=3)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    # the rows' launches by shape over these 3 steps sum to the profile's
    profiled, implied = profiled_conv_ln_launches(prof, launch_counts_by_shape())
    phase("train_profile", steps=3, wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
          idle_share=(1 - busy_us / wall_us) if busy_us else None,
          top_device_ms_per_step={k[:80]: v / 3e3 for k, v in top},
          profiled_launches=profiled, launches_by_shape_sum=implied, **card_note)
    require(busy_us > 0, "the stage-4 profile holds no device time")
    require(profiled == implied, f"stage-4 profile: GraphConv/LayerNorm launches {profiled} != "
            f"the rows' sums {implied}")

    # 53. the kernel policy on the stage-4 step: each field alone plain, then
    # every field plain against with_plain
    t53 = time.perf_counter()
    policy_phase(tr16, batches[0], "s4", card_note)
    policy_seconds = time.perf_counter() - t53

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

    # 53. the kernel policy on the stage-0 step
    t53 = time.perf_counter()
    policy_phase(tr0, s0_batches[0], "s0", card_note)
    policy_seconds += time.perf_counter() - t53
    phase("phase_seconds", phase_name="53_kernel_policy", seconds=policy_seconds, **card_note)

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

    def ln_case(rows, width, act, name, gen=None):
        """(x fp32, scale, bias, cotangent, act). For relu: the gate y > 0 is a
        tie where y is a few ulps from 0: the kernel's and the plain version's
        roundings of y may fall on either side, and one element gated apart
        moves dx by ~r g scale. No cotangent sits there (y of the fp32 and of
        the bf16 x)."""
        x32 = rnd(rows, width, gen=gen) * 2 + 0.5
        sc, bi = 1 + rnd(width, scale=0.3, gen=gen), rnd(width, scale=0.3, gen=gen)
        cot = rnd(rows, width, gen=gen)
        if act == "relu":
            ties = torch.zeros_like(cot, dtype=torch.bool)
            for dt in (torch.float32, torch.bfloat16):
                y = lnk.fused_layernorm_reference(x32.to(dt), sc, bi, 1e-6, "none").float()
                ties |= y.abs() <= 1e-5 * y.abs().max()
            cot = torch.where(ties, torch.zeros_like(cot), cot)
            phase("compare", kernel=name, relu_ties_zeroed=int(ties.sum()))
        return x32, sc, bi, cot, act

    ln_shapes = {"fused_layernorm": (BATCH * n, d, "none"),
                 "fused_layernorm_gnn": (NUM_CLASSES * NUM_CODES, GNN_DIM, "relu"),
                 "fused_layernorm_gnn_instance": (BATCH * L_INST, GNN_DIM, "relu")}
    ln_inputs = {}
    # the instance graphs' inputs from a generator of their own, so that the
    # phases after them draw the same numbers as without them
    g_inst = torch.Generator().manual_seed(16)
    for name, (rows, width, act) in ln_shapes.items():
        ln_inputs[name] = ln_case(rows, width, act,
                                  name.replace("fused_layernorm", "fused_layernorm_bwd"),
                                  g_inst if name.endswith("_instance") else None)
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
    lock, agree = kmeans_vs_plain(feats, held, init_state, NUM_CODES, with_plain)
    phase("stage1_fp32_vs_plain", feature_rel_err=feat_err, id_agreement=agree,
          tol={"features": FP32_TOL, "ids": 0.999, "near_tie": 1e-5, "centers": 1e-4}, **lock)
    require(agree >= 0.999, f"stage-1 k-means ids agree on {agree} < 0.999")
    require(lock["near_ties_only"], "stage-1 k-means: a mismatch is no near-tie")
    require(lock["center_err"] <= 1e-4, f"stage-1 centers differ by {lock['center_err']}")
    # 55. the --saved-features-fp path's clustering on these features
    t55 = time.perf_counter()
    saved_features_phase(feats, init_state, card_note)
    phase("phase_seconds", phase_name="55_saved_features", seconds=time.perf_counter() - t55,
          **card_note)
    # what phase 46 (stage 1 on the int8 route) is held beside, the sample on the host
    s1_ref = {"seconds": s1_seconds, "codebook": bundle.codebook.cpu(), "held": held[:50_000].cpu(),
              "chunks": len(chunks), "vq_launches": minibatches + S1_LLOYD_ITERS}
    del feats, held, backbone, init_state, mb
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
        layer_norm_ms = time_ms(lambda: torch.nn.functional.layer_norm(
            x, (x.shape[-1],), w16, b16, 1e-6), TIME_ITERS)
        if act == "none":  # F.layer_norm has no relu: at the GNN's shapes a note
            library[name] = layer_norm_ms
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
              ms=times[name][0], plain_ms=times[name][1], layer_norm_ms=layer_norm_ms,
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
            card_note)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    # 24-30. ImageNet: the kernels at the new widths, DeiT-Small's serving,
    # stage-4 step and stage 0, DeiT-Base's serving and stage 0
    torch.cuda.empty_cache()
    imagenet = imagenet_phases(dev, card_note)

    # 32-33. the command line's stage chain, and the pretrained loader
    torch.cuda.empty_cache()
    cli_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.perf_counter()
        cli_seconds = cli_phase(cli_dir, has_networkx, card_note)
        phase("phase_seconds", phase_name="32_cli", seconds=time.perf_counter() - t0,
              stages=cli_seconds, **card_note)
        t0 = time.perf_counter()
        pretrained_phase(dev, cli_dir, card_note)
        phase("phase_seconds", phase_name="33_pretrained", seconds=time.perf_counter() - t0,
              **card_note)
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)

    # 34-39. ImageNet from folders of JPEGs: the decode, the crop/resize
    # kernel, the loader, stages 1 and 3 and the worker from a fake tree
    torch.cuda.empty_cache()
    folder_dir = tempfile.mkdtemp(prefix="chip_smoke_folder_")
    try:
        folder = imagefolder_phases(dev, folder_dir, card_note, imagenet["launches"])
    finally:
        shutil.rmtree(folder_dir, ignore_errors=True)

    # 40-42. several ranks: a one-rank NCCL grid, then two ranks (model 2,
    # data 2) on the cards present
    grid = run_grid_phases(dev, card_note)

    # 43-46. the int8 (W8A8) route: its kernels, ImageNet serving in bf16
    # and fp32, stage 1 at CIFAR
    torch.cuda.empty_cache()
    quant = quant_phases(dev, card_note, s1_ref, DeviceImages)

    # 47-51. the model zoo: the FFN kernels' activations, a relu and a
    # post-norm DeiT-Small, ResNet-50 and ResNet-18's worker
    torch.cuda.empty_cache()
    zoo = zoo_phases(dev, card_note)

    # 56-57. the project's own runs: the shipped YAML configs, then the two
    # accuracy gates at the JAX recipe, each stage a subprocess
    torch.cuda.empty_cache()
    gates = gate_phases(card_note)

    # the least time the card could take for the timed work of each kernel
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
        "sym_conv_instance": conv_work(cases["sym_conv_instance"](torch.bfloat16)[2]),
        "sym_conv_bwd": conv_work(train_cases["sym_conv_bwd"](torch.bfloat16)[2], bwd=True),
        "sym_conv_bwd_instance": conv_work(train_cases["sym_conv_bwd_instance"](torch.bfloat16)[2],
                                           bwd=True),
        "embed_grad": embed_work(train_cases["embed_grad"](torch.bfloat16)[2]),
        "adamw_project_rows": adamw_work("edge"),
        **{name: s0_work(name) for name in s0_kernels},
        "vq_assign": vq_work(*vq_inputs["minibatch"]),
        # timed in bf16
        **{name: ln_work(x.to(torch.bfloat16)) for name, (x, *_) in ln_inputs.items()},
        **{name.replace("layernorm", "layernorm_bwd"): ln_work(x.to(torch.bfloat16), bwd=True)
           for name, (x, *_) in ln_inputs.items()},
    }
    replaces = {
        "attn_block": "schemanet_tpu/ops/pallas/encoder_block.py:240",
        "attn_block_hmean": "schemanet_tpu/ops/pallas/encoder_block.py:240",
        "attn_block_fp32": "schemanet_tpu/ops/pallas/encoder_block.py:240",
        "attn_block_fp32_hmean": "schemanet_tpu/ops/pallas/encoder_block.py:240",
        "ffn_block": "schemanet_tpu/ops/pallas/encoder_block.py:286",
        "ffn_block_fp32": "schemanet_tpu/ops/pallas/encoder_block.py:286",
        "sym_conv": "schemanet_tpu/ops/pallas/graphconv.py:68",
        "sym_conv_instance": "schemanet_tpu/ops/pallas/graphconv.py:68",
        "sym_conv_bwd": "schemanet_tpu/ops/pallas/graphconv.py:100",
        "sym_conv_bwd_instance": "schemanet_tpu/ops/pallas/graphconv.py:100",
        "embed_grad": "schemanet_tpu/ops/pallas/embed_bwd.py:161",
        "adamw_project_rows": "schemanet_tpu/ops/pallas/atlas_opt.py:133",
        "fused_mhsa": "schemanet_tpu/ops/pallas/attention.py:162",
        "fused_mhsa_bwd": "schemanet_tpu/ops/pallas/attention.py:216",
        "fused_mlp": "schemanet_tpu/ops/pallas/mlp.py:230",
        "fused_mlp_bwd": "schemanet_tpu/ops/pallas/mlp.py:271",
        "vq_assign": "schemanet_tpu/ops/pallas/vq.py:79",
        **{name: "schemanet_tpu/ops/pallas/layernorm.py:119" for name in ln_inputs},
        **{name.replace("layernorm", "layernorm_bwd"): "schemanet_tpu/ops/pallas/layernorm.py:151"
           for name in ln_inputs},
    }
    sources = {"embed_grad": "embed_bwd.cu", "adamw_project_rows": "atlas_opt.cu",
               "fused_mhsa": "attention.cu", "fused_mhsa_bwd": "attention.cu",
               "fused_mlp": "mlp.cu", "fused_mlp_bwd": "mlp.cu", "vq_assign": "vq.cu"}

    def source_of(name):
        if name.startswith("sym_conv"):
            return "graphconv.cu"
        return "layernorm.cu" if name.startswith("fused_layernorm") else sources.get(
            name, "encoder_block.cu")

    variants = {"embed_grad": "embed_grad_instance",
                "adamw_project_rows": "adamw_project_rows_vertex",
                **{name: f"{name}_p0" for name in s0_kernels}}
    # each kernel's launches on the path that runs it most: stage 4 for the
    # SchemaNet kernels (the GNN's GraphConv and LayerNorm by shape, class
    # and instance graphs apart), stage 0 for the fused ViT kernels and the
    # ViT's LayerNorm, stage 1 for VQ and fp32 ffn_block and attn_block,
    # stage 3 for the fp32 head-mean
    launches = {**train_launches, **gnn_path,
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
        fp32_ops = name.startswith(("adamw_project_rows", "fused_layernorm"))
        flops, moved, *ops_type = work[name]
        dtype = ops_type[0] if ops_type else "float32" if fp32_ops else "bfloat16"
        bound_ms, bound_by = least_ms(flops, moved, dtype)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "schemanet_torch/csrc/" + source_of(name),
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
        "sym_conv_instance_imagenet": ("graphconv.cu", "graphconv.py:68"),
        "sym_conv_bwd_instance_imagenet": ("graphconv.cu", "graphconv.py:100"),
        "fused_layernorm_instance_d1024": ("layernorm.cu", "layernorm.py:119"),
        "fused_layernorm_bwd_instance_d1024": ("layernorm.cu", "layernorm.py:151"),
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
    # phases 34-39's rows: the image pipeline's kernels (ported from the host
    # pipeline, native/src/imagepipe.cpp, not from a Pallas kernel), the fp32
    # ViT kernels and VQ at ImageNet's width and vocabulary, fused_mhsa at 384
    # and 768
    folder_rows = {
        "crop_resize": ("imagepipe.cu", "native/src/imagepipe.cpp:147 (ip_process_sample_u8; "
                                        "no Pallas kernel)"),
        "ycc_to_rgb": ("imagepipe.cu", "native/src/imagepipe.cpp:228 (ip_decode_jpeg's libjpeg "
                                       "upsampling and colour conversion; no Pallas kernel)"),
        "attn_block_fp32_d384": ("encoder_block.cu", "schemanet_tpu/ops/pallas/encoder_block.py:240"),
        "attn_block_fp32_hmean_d384": ("encoder_block.cu",
                                       "schemanet_tpu/ops/pallas/encoder_block.py:240"),
        "ffn_block_fp32_d384": ("encoder_block.cu", "schemanet_tpu/ops/pallas/encoder_block.py:286"),
        "vq_assign_fp32_m8000": ("vq.cu", "schemanet_tpu/ops/pallas/vq.py:79"),
        "vq_assign_fp32_m8000_lloyd": ("vq.cu", "schemanet_tpu/ops/pallas/vq.py:79"),
        "fused_mhsa_d384": ("attention.cu", "schemanet_tpu/ops/pallas/attention.py:162"),
        "fused_mhsa_bwd_d384": ("attention.cu", "schemanet_tpu/ops/pallas/attention.py:216"),
        "fused_mhsa_d768": ("attention.cu", "schemanet_tpu/ops/pallas/attention.py:162"),
        "fused_mhsa_bwd_d768": ("attention.cu", "schemanet_tpu/ops/pallas/attention.py:216"),
    }
    for name, (source, tpu_site) in folder_rows.items():
        if name not in folder["rows"]:  # ycc_to_rgb runs on the nvJPEG route alone
            continue
        r = folder["rows"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "schemanet_torch/csrc/" + source,
            "replaces": tpu_site, "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "worker_launches": {},
        })
    # phases 41's rows: the class graphs' kernels at a model-2 rank's shard
    # (K 500), launches from its bf16 steps
    grid_rows = {
        "sym_conv_shard": ("graphconv.cu", "graphconv.py:68"),
        "sym_conv_bwd_shard": ("graphconv.cu", "graphconv.py:100"),
        "fused_layernorm_shard_d1024": ("layernorm.cu", "layernorm.py:119"),
        "fused_layernorm_bwd_shard_d1024": ("layernorm.cu", "layernorm.py:151"),
        "embed_grad_shard": ("embed_bwd.cu", "embed_bwd.py:161"),
        "adamw_project_rows_shard": ("atlas_opt.cu", "atlas_opt.py:133"),
    }
    for name, (source, tpu_site) in grid_rows.items():
        r = grid["rows"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "schemanet_torch/csrc/" + source,
            "replaces": "schemanet_tpu/ops/pallas/" + tpu_site, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "worker_launches": {},
        })
    # phases 43-46's rows: the int8 route's kernels, which replace XLA's int8
    # product (no Pallas kernel), timed at DeiT-Small's qkv projection of a
    # serving microbatch, launches from phase 44's serving run
    for name in ("quantize_rows", "int8_gemm"):
        r = quant["rows"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "schemanet_torch/csrc/quant.cu",
            "replaces": QUANT_REPLACES, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"library_note": r["library_note"]} if "library_note" in r else {}),
            "worker_launches": {},
        })
    # phases 47-48's rows: the FFN kernels with relu (a config that names no
    # activation), timed at DeiT-Small's widths in bf16, launches from phase
    # 48's relu DeiT-Small (its stage-0 steps, its frozen forward)
    relu_rows = {"ffn_block_relu": ("encoder_block.cu", "encoder_block.py:286"),
                 "fused_mlp_relu": ("mlp.cu", "mlp.py:230"),
                 "fused_mlp_bwd_relu": ("mlp.cu", "mlp.py:271")}
    for name, (source, tpu_site) in relu_rows.items():
        r = zoo["rows"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "schemanet_torch/csrc/" + source,
            "replaces": "schemanet_tpu/ops/pallas/" + tpu_site, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"library_note": r["library_note"]} if "library_note" in r else {}),
            "worker_launches": {},
        })
    require(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
    phase("gate_seconds", total=sum(gates.values()), **gates)
    phase("zoo_seconds", total=sum(zoo["seconds"].values()), **zoo["seconds"])
    phase("quant_seconds", total=sum(quant["seconds"].values()), **quant["seconds"])
    phase("imagenet_seconds", total=sum(imagenet["seconds"].values()), **imagenet["seconds"])
    phase("imagefolder_seconds", total=sum(folder["seconds"].values()), **folder["seconds"])
    phase("total", seconds=time.perf_counter() - t_start, **card_note)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grid-rank"]:  # a rank of phases 41-42, spawned by grid_phases
        grid_rank_main(sys.argv[2])
    else:
        main(grid_only=sys.argv[1:] == ["--grid"], gates_only=sys.argv[1:] == ["--gates"])
