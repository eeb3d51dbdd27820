"""The port imports neither JAX nor the JAX package, and neither Pillow nor
TensorBoard: the machine with the card has none of them. Checked in a fresh
interpreter where importing any of them fails (serving, one SchemaNet
training step, one stage-0 backbone step with dropout live, stages 1 and 3
through the pipeline package, with the VQ and LayerNorm kernel modules, and
one epoch of ``schema_net_worker`` with its loaders, validation, TensorBoard
writer and checkpoints), and by reading the port's sources."""

import pathlib
import re
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "schemanet_tpu")
ABSENT_ON_CARD = ("PIL", "tensorboard")  # not installed beside the card either


def test_import_and_cpu_forward_without_jax(tmp_path):
    blocked = FORBIDDEN + ABSENT_ON_CARD
    script = textwrap.dedent(
        f"""
        import sys
        for name in {blocked!r}:
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
        from schemanet_torch.ops.kernels import layernorm, vq
        from schemanet_torch.pipeline import extract_stage, init_stage
        images = {{"image": np.random.default_rng(1).normal(size=(2, 16, 16, 3)),
                   "label": np.array([0, 1])}}
        bundle = extract_stage({{"dataset": {{"name": "cifar_10"}}, "model": model_cfg,
                                 "discretization": {{"vocabulary": {{"size": 16}},
                                                    "encoder_layer": 1}}}},
                               [images], device="cpu", max_features=32, lloyd_iters=1)
        atlas = init_stage({{"dataset": {{"name": "cifar_10"}}, "schema_net": schema_cfg}},
                           bundle, [images], device="cpu")
        assert atlas["class_ingredients"].shape == (10, 16), atlas["class_ingredients"].shape
        import json, os
        from schemanet_torch.pipeline import save_atlas_init, save_bundle
        from schemanet_torch.train import LaunchArgs, schema_net_worker
        root = {str(tmp_path)!r}
        save_bundle(os.path.join(root, "bundle"), bundle.model_cfg, bundle.encode_layer,
                    bundle.backbone_state, bundle.codebook)
        save_atlas_init(os.path.join(root, "atlas.pt"), atlas["params"], atlas["class_ingredients"])
        worker_cfg = {{
            "dataset": {{"name": "synthetic", "num_classes": 10, "image_size": 8, "resize": 16,
                        "train": {{"num_samples": 8}}, "val": {{"num_samples": 6}}}},
            "training": {{"train_epochs": 1, "batch_size": 4, "val_interval": 1,
                          "num_workers": 1, "optimizer": {{"name": "AdamW", "lr": 1e-3}}}},
            "validation": {{"batch_size": 4, "num_workers": 1}},
            "schema_net": dict(schema_cfg, bundle=os.path.join(root, "bundle"),
                               initial_state_fp=os.path.join(root, "atlas.pt")),
            "loss": {{"name": "schema_inference_loss", "weight_dict": {{"cls": 1.0}}}},
        }}
        out = schema_net_worker(worker_cfg, LaunchArgs(log_dir=os.path.join(root, "run"),
                                                       device="cpu"))
        meta = json.load(open(os.path.join(root, "run", "ckpt", "meta.json")))
        assert meta["iter"] == 2 and meta["last_tag"] == "iter-2", meta
        assert os.path.isfile(os.path.join(root, "run", "ckpt", "best.pt"))
        assert out["trainer"].tb._writer is None  # no tensorboard: the writer does nothing
        loaded = [m for m in sys.modules if m.split(".")[0] in {blocked!r}
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


def test_data_and_utils_import_no_pillow_or_tensorboard_at_module_level():
    pattern = re.compile(
        r"^(import|from)\s+(PIL|tensorboard|torch\.utils\.tensorboard)\b", re.MULTILINE)
    sources = [p for sub in ("data", "utils")
               for p in sorted((REPO / "schemanet_torch" / sub).rglob("*.py"))]
    assert len(sources) >= 7
    offenders = [str(p.relative_to(REPO)) for p in sources if pattern.search(p.read_text())]
    assert not offenders, offenders
