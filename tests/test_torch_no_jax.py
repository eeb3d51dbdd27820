"""The port imports neither JAX nor the JAX package: the machine with the card
has no JAX. Checked in a fresh interpreter where importing any of them fails,
and by reading the port's sources."""

import pathlib
import re
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "schemanet_tpu")


def test_import_and_cpu_forward_without_jax():
    script = textwrap.dedent(
        f"""
        import sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None  # any import of it now raises ImportError
        import numpy as np
        import torch
        import schemanet_torch
        from schemanet_torch.schema import build_predictor, init_parameters_

        model_cfg = {{
            "name": "deit",
            "transformer": dict(embed_dim=32, num_encoder_layers=2, num_heads=2,
                                dim_feedforward=64, activation="gelu", norm_eps=1e-6),
            "patch_embed": dict(img_size=16, patch_size=4, image_channels=3),
        }}
        schema_cfg = {{"gnn": {{"embed_dim": 16, "num_layers": 2}},
                      "ir_atlas": {{"feat_h": 4, "feat_w": 4, "clamp_edge_attn": -1.0,
                                    "prune_node_threshold": 0.001}}}}
        model = build_predictor(model_cfg, schema_cfg, num_classes=5, num_codes=16,
                                code_dim=32, encode_layer=1)
        init_parameters_(model, torch.Generator().manual_seed(0))
        server = schemanet_torch.ServePredictor(model, microbatch=2)
        logits = server.predict(np.random.default_rng(0).normal(size=(3, 16, 16, 3)))
        assert logits.shape == (3, 5) and np.isfinite(logits).all(), logits
        loaded = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


def test_sources_name_no_jax_module():
    pattern = re.compile(
        rf"^\s*(import|from)\s+({'|'.join(FORBIDDEN)})\b", re.MULTILINE
    )
    offenders = [
        str(p.relative_to(REPO))
        for p in sorted((REPO / "schemanet_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
        if pattern.search(p.read_text())
    ]
    assert not offenders, offenders
