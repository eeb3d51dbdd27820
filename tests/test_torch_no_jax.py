"""The port imports neither JAX nor the JAX package: the machine with the card
has no JAX. Checked in a fresh interpreter where importing any of them fails
(serving, one SchemaNet training step and one stage-0 backbone step with
dropout live), and by reading the port's sources."""

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
        server = schemanet_torch.ServePredictor(model, microbatch=2, device="cpu")
        logits = server.predict(np.random.default_rng(0).normal(size=(3, 16, 16, 3)))
        assert logits.shape == (3, 5) and np.isfinite(logits).all(), logits
        from schemanet_torch.schema import get_loss_fn
        from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig
        train_model = build_predictor(model_cfg, schema_cfg, num_classes=5, num_codes=16,
                                      code_dim=32, encode_layer=1)
        init_parameters_(train_model, torch.Generator().manual_seed(0))
        trainer = Trainer(TrainerConfig(train_epochs=1, optimizer={{"lr": 1e-3}},
                                        frozen_patterns=SCHEMA_NET_FROZEN),
                          train_model, get_loss_fn({{"name": "schema_inference_loss"}}),
                          {{"cls": 1.0}}, steps_per_epoch=1, device="cpu")
        loss = trainer.train_iter({{"image": torch.randn(2, 16, 16, 3),
                                    "label": torch.tensor([0, 1])}})["loss"]
        assert torch.isfinite(loss), loss
        from schemanet_torch.ops.kernels import attention, dropmask, mlp
        from schemanet_torch.train import backbone_trainer
        stage0 = {{"dataset": {{"name": "cifar_10"}},
                   "model": dict(model_cfg, name="vit", transformer=dict(
                       model_cfg["transformer"], dropout=0.1)),
                   "loss": {{"name": "ce_loss", "weight_dict": {{"cls": 1.0}}}},
                   "training": {{"train_epochs": 1, "clip_max_norm": 0.1,
                                 "optimizer": {{"name": "AdamW", "lr": 1e-4}}}}}}
        backbone = backbone_trainer(stage0, steps_per_epoch=1, device="cpu")
        loss = backbone.train_iter({{"image": torch.randn(2, 16, 16, 3),
                                     "label": torch.tensor([0, 1])}})["loss"]
        assert torch.isfinite(loss), loss
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
