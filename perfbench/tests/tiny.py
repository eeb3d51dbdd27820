"""A tiny configuration of the benchmark's shape, for the CPU tests: every
width small, every mechanism present (V_max below M, pruning, two GNN
layers, the encode layer inside the stack)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]


def tiny_config(dtype: str = "float32", v_max=8) -> dict:
    cfg = copy.deepcopy(json.loads((BENCH / "configs" / "imagenet_deit_small.json").read_text()))
    t = cfg["model"]["transformer"]
    t.update(embed_dim=32, num_heads=2, dim_feedforward=128, num_encoder_layers=3)
    cfg["model"]["patch_embed"]["img_size"] = 64
    cfg["schema_net"]["ir_atlas"].update(feat_h=4, feat_w=4, class_max_vertices=v_max)
    cfg["schema_net"]["gnn"]["embed_dim"] = 16
    cfg.update(num_classes=6, num_codes=40, encode_layer=1, train_images=640, serve_dtype=dtype)
    cfg["training"]["dtype"] = dtype
    if dtype == "float32":  # graphs at fp32 too: the port then computes what the reference does
        cfg["schema_net"]["ir_atlas"]["graph_precision"] = "highest"
        cfg["training"]["param_groups"][0]["cfg"] = {"weight_decay": 0.0005}
    return cfg


class Ctx:
    """What run.py hands an entry, on the CPU."""

    def __init__(self, cfg: dict, traffic: dict, seed: int = 7, seconds: float = 0.5):
        self.cell = type("Cell", (), {"config": cfg, "traffic": traffic, "name": "tiny"})()
        self.config, self.traffic = cfg, traffic
        self.seed, self.seconds, self.device = seed, seconds, torch.device("cpu")
        self.reference_precision = "fp32"
        self.trace = None
