"""``work.py``'s operation and byte counts against hand counts and against
PyTorch's own count of the reference's products at small shapes."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import weights, work
from perfbench.reference import model as ref
from perfbench.reference.precision import Precision
from perfbench.tests.tiny import tiny_config

CFG = tiny_config("float32")  # d 32, f 128, 2 layers to the encode layer, 64^2 at patch 16, M 40


def test_vit_flops_by_hand():
    d, f, n, L, M = 32, 128, 17, 16, 40
    patch = 2 * L * (3 * 16 * 16) * d
    layer = 2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d + 2 * 2 * n * d * f
    assert work.vit_flops(CFG, 3) == 3 * (patch + 2 * layer + 2 * L * M * d)


def test_gnn_flops_by_hand():
    L, V, D, K, B = 16, 8, 16, 6, 5
    per_graph = lambda v: 2 * (2 * v * v * D + 2 * v * D * D) + 2 * D * D  # noqa: E731
    assert work.gnn_flops(CFG, B) == B * per_graph(L) + K * per_graph(V) + 2 * B * K * D
    assert work.train_step_flops(CFG, B) == work.vit_flops(CFG, B) + 3 * work.gnn_flops(CFG, B)


def test_bytes_by_hand():
    d, f, n, L, M, B = 32, 128, 17, 16, 40, 2
    weights_ = 3 * 256 * d + d + n * d + d + 2 * (4 * d * d + 2 * d * f + 9 * d + f)
    ins = 4 * (B * 64 * 64 * 3 + weights_ + M * d)
    assert work.vit_bytes(CFG, B, "bfloat16") == ins + B * (2 * n * d + 2 * L * d + 4 * L
                                                            + 2 * n * n)
    assert work.least_seconds(989e12, 0.0) == 1.0
    assert work.least_seconds(0.0, 3.35e12) == 1.0


def test_counts_match_the_references_products():
    """PyTorch counts the products the reference runs: the ViT and VQ, and
    the GNN over instance and class graphs with the similarities."""
    state = weights.make_weights(CFG, 3, "cpu")
    images, _ = weights.make_pool(CFG, 3, "cpu", 4, 0.1)
    p = Precision("fp32")
    with FlopCounterMode(display=False) as fc:
        feats, _ = ref.vit_encode(state, CFG, images, p)
        ref.vq(feats, state[ref.CODEBOOK], p)
    assert fc.get_total_flops() == work.vit_flops(CFG, 4)
    with torch.no_grad():
        feats, hmean = ref.vit_encode(state, CFG, images, p)
        ids = ref.vq(feats, state[ref.CODEBOOK], p)
        inst = ref.instance_graphs(ids, hmean, state, CFG, ref.geometry(CFG, "cpu"))
    with FlopCounterMode(display=False) as fc:
        fi = ref.gnn_embed(state, CFG, inst["vertices"], inst["edges"], inst["codes"],
                           inst["live"], 16.0, p)
        kg, _, _ = ref.class_features(state, CFG, p)
        p.mm(fi, kg.t())
    assert fc.get_total_flops() == work.gnn_flops(CFG, 4)
