"""``examples/visualize_atlas_torch.py`` on the CPU: from a seeded bundle and
checkpoint of the port (written by the port's own writers) it renders the
class graph and the attribution heatmap as two PNG files, and it imports
nothing of the JAX package."""

import ast
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from schemanet_torch.models.vit import get_model
from schemanet_torch.pipeline import save_bundle
from schemanet_torch.schema import build_predictor, init_parameters_
from schemanet_torch.train.common import CheckpointManager

pytest.importorskip("matplotlib")
pytest.importorskip("networkx")

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / "visualize_atlas_torch.py"
MODEL_CFG = {"name": "vit",
             "transformer": {"embed_dim": 32, "num_encoder_layers": 2, "num_heads": 2,
                             "dim_feedforward": 64, "activation": "gelu", "final_norm": True,
                             "norm_eps": 1e-6},
             "patch_embed": {"img_size": 16, "patch_size": 4, "image_channels": 3},
             "pos_encoding": {"name": "learnable"}}
SCHEMA_CFG = {"matcher": {"similarity": "inner_product"},
              "gnn": {"embed_dim": 16, "num_layers": 2},
              "ir_atlas": {"feat_h": 4, "feat_w": 4, "clamp_edge_attn": -1.0,
                           "prune_node_threshold": 0.001}}
K, M, D = 4, 16, 32


def test_example_writes_both_pngs(tmp_path):
    backbone = get_model(MODEL_CFG, K)
    init_parameters_(backbone, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    save_bundle(str(tmp_path / "bundle"), MODEL_CFG, 1, backbone.state_dict(),
                torch.rand(M, D, generator=g))
    model = build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, 1)
    init_parameters_(model, torch.Generator().manual_seed(2))
    CheckpointManager(str(tmp_path / "ckpt")).save("best", {"model": model.state_dict()})
    (tmp_path / "schema.json").write_text(json.dumps({"schema_net": SCHEMA_CFG}))
    np.save(tmp_path / "images.npy",
            np.random.default_rng(3).normal(size=(2, 16, 16, 3)).astype(np.float32))

    spec = importlib.util.spec_from_file_location("visualize_atlas_torch", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = tmp_path / "atlas.png"
    example.main(["--bundle", str(tmp_path / "bundle"),
                  "--ckpt", str(tmp_path / "ckpt" / "best.pt"),
                  "--schema-cfg", str(tmp_path / "schema.json"), "--num-classes", str(K),
                  "--class-id", "2", "--out", str(out), "--image", str(tmp_path / "images.npy"),
                  "--device", "cpu"])
    for png in (out, tmp_path / "atlas_attribution.png"):
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", png
        assert png.stat().st_size > 1000


def test_example_imports_no_jax():
    tree = ast.parse(EXAMPLE.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not any(n.split(".")[0] in ("jax", "schemanet_tpu", "flax", "optax") for n in names)
