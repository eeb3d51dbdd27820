"""Operations and bytes of the benchmark's layers, from a configuration's
mathematics at a cell's shapes: the yardstick of every roofline and ``mfu``
metric.

Operations: a matrix product ``2 m n k``, attention ``4 B n^2 d`` (scores
and values), elementwise work (norms, softmax, activations, graph
normalisation, pooling sums) left out. A split-precision product (fp32 by
three TF32 products) counts once: the work is the mathematics, not its
route. Bytes: each input read once, each output written once.

Peaks (NVIDIA H100 SXM data sheet, dense): 989 TFLOP/s bf16 whatever the
configuration's precision, so no fp32-accurate route can read over 100%;
3.35 TB/s HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def _sizes(cfg: dict):
    t, pe = cfg["model"]["transformer"], cfg["model"]["patch_embed"]
    L = (pe["img_size"] // pe["patch_size"]) ** 2
    return t["embed_dim"], t["dim_feedforward"], L + 1, L, pe


def vit_flops(cfg: dict, images: int) -> float:
    """The frozen ViT to its encode layer (patch embedding and layers
    0..encode_layer) and the VQ of its patch tokens over the codebook."""
    d, f, n, L, pe = _sizes(cfg)
    patch = 2 * L * pe["image_channels"] * pe["patch_size"] ** 2 * d
    layer = 2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d + 4 * n * d * f
    vq = 2 * L * cfg["num_codes"] * d
    return float(images * (patch + (cfg["encode_layer"] + 1) * layer + vq))


def vit_bytes(cfg: dict, images: int, dtype: str) -> float:
    """The ViT layer's inputs (fp32 images, its fp32 weights and codebook)
    read once and its outputs (the mid feature, the quantised patches, their
    ids, the head-mean attention, in ``dtype``) written once."""
    d, f, n, L, pe = _sizes(cfg)
    a = DTYPE_BYTES[dtype]
    weights = (pe["image_channels"] * pe["patch_size"] ** 2 * d + d + n * d + d
               + (cfg["encode_layer"] + 1) * (4 * d * d + 2 * d * f + 9 * d + f))
    ins = 4 * (images * (pe["img_size"] ** 2) * pe["image_channels"] + weights
               + cfg["num_codes"] * d)
    outs = images * (a * n * d + a * L * d + 4 * L + a * n * n)
    return float(ins + outs)


def _gnn_graph_flops(cfg: dict, graphs: int, v: int) -> float:
    g = cfg["schema_net"]["gnn"]
    dg = g["embed_dim"]
    per_layer = 2 * v * v * dg + 2 * v * dg * dg
    return float(graphs * (g["num_layers"] * per_layer + 2 * dg * dg))


def class_vertices(cfg: dict) -> int:
    return cfg["schema_net"]["ir_atlas"].get("class_max_vertices") or cfg["num_codes"]


def gnn_flops(cfg: dict, batch: int) -> float:
    """One matcher forward: the GNN over ``batch`` instance graphs of L
    slots and the K class graphs of V vertices (convolutions, Linear layers,
    the final Linear), and the K x batch similarities."""
    _, _, _, L, _ = _sizes(cfg)
    k, dg = cfg["num_classes"], cfg["schema_net"]["gnn"]["embed_dim"]
    return (_gnn_graph_flops(cfg, batch, L) + _gnn_graph_flops(cfg, k, class_vertices(cfg))
            + 2.0 * batch * k * dg)


def gnn_bytes(cfg: dict, batch: int, dtype: str) -> float:
    """The matcher's inputs read once (the instance graphs' vertices and
    edges and slot codes, the class graphs' vertices, edges and ingredients in
    ``dtype``, the fp32 embedding table and layer weights) and the fp32
    logits written once."""
    _, _, _, L, _ = _sizes(cfg)
    a = DTYPE_BYTES[dtype]
    g = cfg["schema_net"]["gnn"]
    k, v, dg = cfg["num_classes"], class_vertices(cfg), g["embed_dim"]
    weights = 4 * ((cfg["num_codes"] + 1) * dg + g["num_layers"] * (dg * dg + 3 * dg)
                   + dg * dg + dg)
    instance = batch * (a * L + a * L * L + 4 * L + 1)
    klass = k * (a * v + a * v * v + 4 * v)
    return float(weights + instance + klass + 4 * batch * k)


def train_step_flops(cfg: dict, batch: int) -> float:
    """A stage-4 step: the frozen ViT and VQ forward only, the trainable
    GNN and matcher forward plus twice that for the backward."""
    return vit_flops(cfg, batch) + 3 * gnn_flops(cfg, batch)


def serve_flops(cfg: dict, batch: int) -> float:
    """A serving microbatch: every part forward once."""
    return vit_flops(cfg, batch) + gnn_flops(cfg, batch)


def pass_flops(cfg: dict, images: int) -> float:
    """Stage 3's passes: the frozen ViT and VQ of each image (the graph
    sums are elementwise and left out)."""
    return vit_flops(cfg, images)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time on the card: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
