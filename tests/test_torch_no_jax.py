"""The port imports neither JAX nor the JAX package, and neither Pillow,
PyYAML nor TensorBoard: the machine with the card has none of them. Checked
in a fresh interpreter where importing any of them fails (serving, one
SchemaNet training step, one stage-0 backbone step with dropout live, stages
1 and 3 through the pipeline package, with the VQ and LayerNorm kernel
modules, one epoch of ``schema_net_worker`` with its loaders, validation,
TensorBoard writer and checkpoints, then the command line's ``serve
--explain`` on its files from a JSON config, ``load_serve_predictor``, the
capture probes and the config helpers; the grid of ``parallel/``: a
one-rank gloo grid, a training step on it, the sharding rules; and the
model zoo: a ResNet stage-0 step, a post-norm identity-encoded ViT, a masked
stack, every FFN activation), and by reading the port's sources."""

import pathlib
import re
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "schemanet_tpu")
ABSENT_ON_CARD = ("PIL", "tensorboard", "yaml")  # not installed beside the card either


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
        from schemanet_torch import cli, load_serve_predictor
        from schemanet_torch.models.capture import MidExtractor
        serve_cfg = os.path.join(root, "serve.json")
        with open(serve_cfg, "w") as f:
            json.dump(dict(worker_cfg, num_classes=10), f)
        npz = os.path.join(root, "served.npz")
        assert cli.main(["serve", "--cfg", serve_cfg, "--ckpt", os.path.join(root, "run", "ckpt"),
                         "--images", "synthetic:3", "--microbatch", "2", "--explain", "--out",
                         npz, "--log-dir", os.path.join(root, "cli"), "--device", "cpu",
                         "-o", "schema_net.gnn.num_layers=2"]) == 0
        saved = np.load(npz)
        server = load_serve_predictor(worker_cfg["schema_net"]["bundle"], worker_cfg["schema_net"],
                                      os.path.join(root, "run", "ckpt"), 10, microbatch=2,
                                      device="cpu")
        assert saved["attribution"].shape == (3, 10, 4, 4), saved["attribution"].shape
        assert (saved["logits"] == server.predict(
            np.random.default_rng(0).normal(size=(3, 16, 16, 3)).astype(np.float32))).all()
        feats = MidExtractor(server.predictor.ingredient_backbone.backbone,
                             ["module.transformer.layers.1.attention.attn_identity"])(
            torch.randn(2, 16, 16, 3))
        assert feats["module.transformer.layers.1.attention.attn_identity"].shape == (2, 2, 18, 18)
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


def test_grid_without_jax():
    """The grid modules (``parallel/mesh.py``, ``parallel/launch.py``) in a
    fresh interpreter where JAX and the JAX package cannot be imported: a
    one-rank gloo grid, a SchemaNet training step on it, the sharding rules
    and ``shard_params`` at model 2."""
    blocked = FORBIDDEN + ABSENT_ON_CARD
    script = textwrap.dedent(
        f"""
        import sys
        for name in {blocked!r}:
            sys.modules[name] = None
        import torch
        from schemanet_torch.parallel import launch
        from schemanet_torch.parallel.mesh import (Mesh, make_mesh, param_shardings,
                                                   shard_params)
        from schemanet_torch.schema import build_predictor, get_loss_fn, init_parameters_
        from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig
        model_cfg = {{"name": "vit",
                      "transformer": dict(embed_dim=32, num_encoder_layers=2, num_heads=2,
                                          dim_feedforward=64, activation="gelu", norm_eps=1e-6),
                      "patch_embed": dict(img_size=16, patch_size=4, image_channels=3)}}
        schema_cfg = {{"gnn": {{"embed_dim": 16, "num_layers": 2}},
                      "ir_atlas": {{"feat_h": 4, "feat_w": 4, "clamp_edge_attn": -1.0}}}}
        model = build_predictor(model_cfg, schema_cfg, num_classes=4, num_codes=16, code_dim=32,
                                encode_layer=1)
        init_parameters_(model, torch.Generator().manual_seed(0))
        state = dict(model.state_dict())
        mesh = make_mesh(device="cpu")
        assert (mesh.data, mesh.model, mesh.backend) == (1, 1, "gloo"), mesh
        trainer = Trainer(TrainerConfig(train_epochs=1, optimizer={{"lr": 1e-3}},
                                        frozen_patterns=SCHEMA_NET_FROZEN),
                          model, get_loss_fn({{"name": "schema_inference_loss"}}), {{"cls": 1.0}},
                          steps_per_epoch=1, mesh=mesh)
        loss = trainer.train_iter({{"image": torch.randn(2, 16, 16, 3),
                                    "label": torch.tensor([0, 1])}})["loss"]
        assert torch.isfinite(loss), loss
        dims = param_shardings(Mesh(2, 2), [(k, v.shape) for k, v in state.items()
                                            if v.is_floating_point()])
        assert dims["schema_net.edge_weights"] == 0, dims
        local = shard_params(Mesh(2, 2, rank=3), state)
        assert local["schema_net.edge_weights"].shape == (2, 16, 16)
        assert callable(launch.spawn_ranks)
        loaded = [m for m in sys.modules if m.split(".")[0] in {blocked!r}
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        torch.distributed.destroy_process_group()
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


def test_model_zoo_without_jax():
    """The model zoo in a fresh interpreter where JAX and the JAX package
    cannot be imported: ``models/resnet.py`` and ``models/layers_extra.py``
    (a ResNet-18 stage-0 step, its running statistics moved), a post-norm
    identity-encoded relu ViT's training step, a masked stack, and the
    FFN kernels' activations on their plain versions."""
    blocked = FORBIDDEN + ABSENT_ON_CARD
    script = textwrap.dedent(
        f"""
        import sys
        for name in {blocked!r}:
            sys.modules[name] = None
        import torch
        from schemanet_torch.models import layers_extra, resnet
        from schemanet_torch.models.transformer import Transformer
        from schemanet_torch.ops.kernels import encoder_block, mlp
        from schemanet_torch.train import backbone_trainer
        loss_cfg = {{"name": "ce_loss", "weight_dict": {{"cls": 1.0}}}}
        train_cfg = {{"train_epochs": 1, "optimizer": {{"name": "AdamW", "lr": 1e-3}}}}
        stage0 = {{"dataset": {{"num_classes": 3}}, "model": {{"name": "resnet18"}},
                   "loss": loss_cfg, "training": train_cfg}}
        trainer = backbone_trainer(stage0, steps_per_epoch=1, device="cpu")
        batch = {{"image": torch.randn(2, 32, 32, 3), "label": torch.tensor([0, 1])}}
        assert torch.isfinite(trainer.train_iter(batch)["loss"])
        assert isinstance(trainer.model, resnet.ResNet)
        assert not torch.equal(trainer.model.bn1.mean, torch.zeros(64))
        vit = {{"dataset": {{"num_classes": 3}}, "loss": loss_cfg, "training": train_cfg,
                "model": {{"name": "vit", "pos_encoding": {{"name": "identity"}},
                           "transformer": dict(embed_dim=32, num_encoder_layers=2, num_heads=2,
                                               dim_feedforward=64, pre_norm=False,
                                               dropout=0.1),
                           "patch_embed": dict(img_size=16, patch_size=4)}}}}
        trainer = backbone_trainer(vit, steps_per_epoch=1, device="cpu")
        batch = {{"image": torch.randn(2, 16, 16, 3), "label": torch.tensor([0, 1])}}
        assert torch.isfinite(trainer.train_iter(batch)["loss"])
        stack = Transformer(2, 2, 32, 64, "relu", pre_norm=False)
        mask = torch.zeros(1, 1, 5, 5)
        out, _ = stack.run(torch.randn(2, 5, 32), attn_mask=mask)
        assert out.shape == (2, 5, 32)
        assert layers_extra.get_norm("batch_norm", 4, use_running_average=True)(
            torch.randn(2, 3, 3, 4)).shape == (2, 3, 3, 4)
        x = torch.randn(2, 3, 8)
        for act in encoder_block.ACT_CODES:
            w = (torch.randn(16, 8), torch.randn(16), torch.randn(8, 16), torch.randn(8))
            assert mlp.fused_mlp(x, *w, act).shape == x.shape
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
        for p in sorted((REPO / "schemanet_torch").rglob("*.py"))
        + [REPO / "chip_smoke.py", REPO / "tests" / "_torch_relu_gates.py"]  # chip_smoke's helper
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


def test_new_modules_import_no_optional_package_at_module_level():
    """The command line, serving, the capture probes, the graph export and
    the config helpers import Pillow, PyYAML, TensorBoard and networkx only
    inside the functions that need them."""
    pattern = re.compile(
        r"^(import|from)\s+(PIL|yaml|tensorboard|networkx|torch\.utils\.tensorboard)\b",
        re.MULTILINE)
    sources = [REPO / "schemanet_torch" / name for name in (
        "cli.py", "serve.py", "models/capture.py", "models/port.py", "schema/convert_graph.py",
        "utils/config.py", "utils/seed.py", "data/jpeg.py", "data/datasets.py",
        "ops/kernels/imagepipe.py")]
    offenders = [str(p.relative_to(REPO)) for p in sources if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_image_folder_route_without_jax_or_pillow(tmp_path):
    """An ImageNet-style tree of JPEG fixtures through the port's datasets,
    decode, loader and ``prepare`` in an interpreter where JAX, Pillow,
    PyYAML and TensorBoard cannot be imported (the host decode route; skips
    where libjpeg's header is missing)."""
    import shutil

    from schemanet_torch.data import jpeg

    if jpeg.decode_route() != jpeg.LIBJPEG:
        import pytest

        pytest.skip("libjpeg's jpeglib.h is not installed: the host decode route is absent")
    fixtures = REPO / "tests" / "fixtures" / "jpeg"
    names = sorted(f for f in __import__("os").listdir(fixtures) if f.startswith("photo_"))
    for split in ("train", "val"):
        for c in range(2):
            (tmp_path / split / f"n{c:08d}").mkdir(parents=True)
            for i in range(3):
                shutil.copy(fixtures / names[c * 3 + i], tmp_path / split / f"n{c:08d}" / f"{i}.JPEG")
    blocked = FORBIDDEN + ABSENT_ON_CARD
    script = textwrap.dedent(
        f"""
        import sys
        for name in {blocked!r}:
            sys.modules[name] = None
        import torch
        from schemanet_torch.data import build_loaders
        from schemanet_torch.data.loader import batch_to_device
        train, val, n = build_loaders({{"name": "imagenet", "root": {str(tmp_path)!r},
                                        "resize": 32}}, {{"batch_size": 4, "num_workers": 2}},
                                      {{"batch_size": 4, "num_workers": 2}})
        assert n == 2 and train.decode_route == "libjpeg", train.decode_route
        for loader, batches in ((train, 1), (val, 2)):
            got = [loader.prepare(b["image"], b["crop"])
                   for b in map(lambda b: batch_to_device(b, "cpu"), loader)]
            assert len(got) == batches and all(g.shape == (4, 32, 32, 3) for g in got)
            assert all(torch.isfinite(g).all() for g in got)
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


def test_policy_optimizers_and_feature_dump_without_jax():
    """The kernel policy (every field set plain, then reset), SGD, Adam and
    factored AdamW steps of a SchemaNet trainer, and ``cluster_features``,
    in an interpreter where JAX, h5py, Pillow, PyYAML and TensorBoard cannot
    be imported; the feature dump names the missing h5py."""
    blocked = FORBIDDEN + ABSENT_ON_CARD + ("h5py",)
    script = textwrap.dedent(
        f"""
        import sys
        for name in {blocked!r}:
            sys.modules[name] = None
        import numpy as np
        import torch
        from schemanet_torch.ops import policy
        from schemanet_torch.pipeline.extract_ingredients import append_h5, cluster_features
        from schemanet_torch.schema import build_predictor, get_loss_fn, init_parameters_
        from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig

        policy.configure({{f: ("blocked" if f == "static_embed_bwd" else "xla")
                           for f in policy.KERNEL_FIELDS}})
        assert not any(getattr(policy.routes(), f) for f in policy.KERNEL_FIELDS)
        model_cfg = {{"name": "deit",
                      "transformer": dict(embed_dim=32, num_encoder_layers=2, num_heads=2,
                                          dim_feedforward=64, activation="gelu"),
                      "patch_embed": dict(img_size=16, patch_size=4, image_channels=3)}}
        schema_cfg = {{"gnn": {{"embed_dim": 16, "num_layers": 2}},
                      "ir_atlas": {{"feat_h": 4, "feat_w": 4, "clamp_edge_attn": -1.0,
                                    "prune_node_threshold": 0.001}}}}
        for opt in ({{"name": "sgd", "lr": 1e-3}}, {{"name": "adam", "lr": 1e-3}},
                    {{"name": "AdamW", "lr": 1e-3, "factored": True}}):
            model = build_predictor(model_cfg, schema_cfg, num_classes=5, num_codes=16,
                                    code_dim=32, encode_layer=1)
            init_parameters_(model, torch.Generator().manual_seed(0))
            trainer = Trainer(TrainerConfig(train_epochs=1, optimizer=opt,
                                            frozen_patterns=SCHEMA_NET_FROZEN),
                              model, get_loss_fn({{"name": "schema_inference_loss"}}),
                              {{"cls": 1.0}}, steps_per_epoch=1, device="cpu")
            loss = trainer.train_iter({{"image": torch.randn(2, 16, 16, 3),
                                        "label": torch.tensor([0, 1])}})["loss"]
            assert torch.isfinite(loss), (opt, loss)
        policy.reset_policy()
        centers = cluster_features(np.random.default_rng(0).normal(size=(500, 8)), 4,
                                   lloyd_iters=2, device="cpu")
        assert centers.shape == (4, 8) and torch.isfinite(centers).all()
        try:
            append_h5("x.h5", np.zeros((2, 3), np.float32))
        except ImportError as exc:
            assert "h5py" in str(exc), exc
        else:
            raise AssertionError("no error")
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


def test_policy_and_example_name_no_jax_module():
    """The kernel policy, the stage-1 feature dump and the atlas viewer
    example name no JAX module; the dump imports h5py, and the viewer
    matplotlib and networkx, inside the functions that need them."""
    pattern = re.compile(rf"^\s*(import|from)\s+({'|'.join(FORBIDDEN)})\b", re.MULTILINE)
    optional = re.compile(r"^(import|from)\s+(h5py|matplotlib|networkx)\b", re.MULTILINE)
    sources = [REPO / "schemanet_torch" / "ops" / "policy.py",
               REPO / "schemanet_torch" / "pipeline" / "extract_ingredients.py",
               REPO / "examples" / "visualize_atlas_torch.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text()) or optional.search(p.read_text())]
    assert not offenders, offenders
