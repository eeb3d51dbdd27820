"""The port's command line against the JAX package's, on the CPU: the
parser's subcommands, flags and defaults (``--device`` added), the config
helpers on the same inputs, YAML and JSON configs without PyYAML, the
unported flags, the whole stage chain ``train -> extract -> export -> init ->
train schema_net_worker -> serve --explain --out --graph-sample`` with
``--device cpu`` at a tiny size, and the grid flags: ``train`` and
``extract`` with ``--mesh-data 2 --device cpu`` (two gloo ranks the command
line spawns) against one process, a grid larger than the GPUs present, and
``--multi-host`` without ``torchrun``'s rendezvous."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from schemanet_torch import cli
from schemanet_torch.utils import config as torch_config
from schemanet_tpu import cli as jax_cli
from schemanet_tpu.utils import config as jax_config

from tests.test_torch_pretrained import reference_state_dict, save_reference

REPO = pathlib.Path(__file__).resolve().parents[1]
COMMANDS = ("train", "extract", "export", "init", "serve")


def _options(parser):
    sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return {name: {tuple(a.option_strings): (a.dest, a.default, a.required, a.choices, a.type,
                                             a.nargs, a.const)
                   for a in p._actions if a.option_strings and a.dest != "help"}
            for name, p in sub.choices.items()}


@pytest.mark.parametrize("command", COMMANDS)
def test_parser_matches_jax(command):
    got, want = _options(cli.build_parser()), _options(jax_cli.build_parser())
    assert set(got) == set(want) == set(COMMANDS)
    flags = dict(got[command])
    assert flags.pop(("--device",))[:2] == ("device", "cuda")
    assert flags == want[command]


CFG = {
    "dataset": "datasets/synthetic.yaml",
    "training": {"param_groups": [{"pattern": "schema_net", "cfg": {"weight_decay": 5e-4}},
                                  {"pattern": "matcher"}], "batch_size": 64},
    "model": {"name": "vit", "transformer": {"embed_dim": 192}},
}
OVERRIDES = ["training.param_groups.0.cfg.nu_dtype=bfloat16", "training.batch_size=32",
             "dataset.num_classes=7", "model.transformer.dropout=0.1", "loss.name=ce_loss",
             "training.param_groups.1=null"]


def test_config_helpers_match_jax(tmp_path):
    (tmp_path / "datasets").mkdir()
    (tmp_path / "datasets" / "synthetic.yaml").write_text(
        "name: synthetic\nnum_classes: 10\nimage_size: 8\n")
    got_o = torch_config.parse_override_strings(OVERRIDES)
    want_o = jax_config.parse_override_strings(OVERRIDES)
    assert got_o == want_o
    got = torch_config.apply_overrides(CFG, got_o, base_dir=str(tmp_path))
    want = jax_config.apply_overrides(CFG, want_o, base_dir=str(tmp_path))
    assert got == want
    assert got["dataset"]["num_classes"] == 7 and got["dataset"]["image_size"] == 8
    assert got["training"]["param_groups"][0]["cfg"]["nu_dtype"] == "bfloat16"
    assert CFG["training"]["batch_size"] == 64  # a copy
    for value in ("datasets/synthetic.yaml", {"name": "inline"}):
        assert (torch_config.resolve_subconfig(value, str(tmp_path))
                == jax_config.resolve_subconfig(value, str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        torch_config.resolve_subconfig("missing.yaml", str(tmp_path))
    path = tmp_path / "cfg.yaml"
    path.write_text("a: 1\nb: [x, 2.5]\n")
    assert torch_config.get_cfg(str(path)) == jax_config.get_cfg(str(path))


def test_json_configs_without_pyyaml(tmp_path):
    """With PyYAML missing: a shipped YAML config loads equal to the JAX
    loader's dict, override values are typed as YAML types them (``1e-3``
    and ``x`` strings), and a JSON config still loads."""
    cfg = {"dataset": {"name": "synthetic"}, "training": {"lr": 0.001, "groups": [1, 2]}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    shipped = str(REPO / "configs" / "synthetic" / "schema_net" / "deit_tiny-l9-M_128.yaml")
    assert jax_config.get_cfg(str(tmp_path / "cfg.json")) == cfg
    want_yaml = jax_config.get_cfg(shipped)
    want_o = jax_config.parse_override_strings(["a.b=1e-3", 'c="x"', "d=true", "e=x"])
    assert want_o == {"a.b": "1e-3", "c": "x", "d": True, "e": "x"}
    script = textwrap.dedent(f"""
        import sys
        sys.modules["yaml"] = None
        from schemanet_torch.utils import config
        root = {str(tmp_path)!r}
        assert config.get_cfg(root + "/cfg.json") == {cfg!r}
        assert config.get_cfg({shipped!r}) == {want_yaml!r}
        assert config.parse_override_strings(['a.b=1e-3', 'c="x"', 'd=true', 'e=x']) == {want_o!r}
        assert "yaml" not in sys.modules or sys.modules["yaml"] is None
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


@pytest.mark.parametrize("argv, item", [
    (["extract", "--save-features", "--ckpt", "c", "--save-path", "s"], "A9"),
    (["extract", "--saved-features-fp", "f.h5", "--ckpt", "c", "--save-path", "s"], "A9"),
])
def test_unported_flags_raise(tmp_path, argv, item):
    """The feature-dump flags, once refused, now run: the command gets past
    them to the config (here empty, so its missing ``discretization`` block
    raises). Their runs: test_torch_saved_features.py."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text("{}")
    with pytest.raises(KeyError, match="discretization"):
        cli.main(argv[:1] + ["--cfg", str(cfg), "--log-dir", str(tmp_path), "--device", "cpu"]
                 + argv[1:])


def test_default_device_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"dataset": {"name": "synthetic", "num_classes": 3,
                                           "image_size": 8, "resize": 16,
                                           "train": {"num_samples": 4}}},))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["init", "--cfg", str(cfg), "--log-dir", str(tmp_path), "--save-fp",
                  str(tmp_path / "a.pt")])


MODEL = {"name": "vit",
         "transformer": {"embed_dim": 32, "num_encoder_layers": 2, "num_heads": 2,
                         "dim_feedforward": 128, "dropout": 0.1, "activation": "gelu",
                         "final_norm": True, "norm_eps": 1e-6},
         "patch_embed": {"img_size": 16, "patch_size": 4, "image_channels": 3},
         "pos_encoding": {"name": "learnable"}}
CLASSES, CODES = 5, 16


def _write(path, cfg):
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_chain_on_the_cpu(tmp_path):
    """Stage 0 from a reference ``.pth`` (head in ``lax_names``), stage 1,
    stage 2, stage 3, stage 4, then serving with explanations, a ``.npz`` and
    a GraphML graph; every call exits 0 and the ``.npz`` equals the server
    ``load_serve_predictor`` builds from the same files, bit for bit."""
    root = tmp_path
    data = {"name": "synthetic", "num_classes": CLASSES, "image_size": 8, "resize": 16,
            "train": {"num_samples": 8}, "val": {"num_samples": 4}}
    (root / "datasets").mkdir()
    _write(root / "datasets" / "synthetic.json", data)
    pth = save_reference(root / "ref.pth",
                         reference_state_dict(dim=32, layers=2, classes=1000, img=16, patch=4))
    train = {"train_epochs": 1, "batch_size": 4, "num_workers": 1, "val_interval": 1,
             "optimizer": {"name": "AdamW", "lr": 1e-3}, "clip_max_norm": 0.1}
    val = {"batch_size": 4, "num_workers": 1}
    vanilla = _write(root / "vanilla.json", {
        "dataset": "datasets/synthetic.json", "training": train, "validation": val,
        "model": dict(MODEL, pre_train=pth, lax_names=["cls_head.weight", "cls_head.bias"]),
        "loss": {"name": "ce_loss", "weight_dict": {"cls": 1.0}}})
    ingredient = _write(root / "ingredient.json", {
        "dataset": "datasets/synthetic.json", "model": MODEL,
        "discretization": {"vocabulary": {"size": CODES, "dim": 32},
                           "encoder_layer": "module.transformer.layers.1"}})
    schema_cfg = {"bundle": str(root / "bundle"), "initial_state_fp": str(root / "atlas.pt"),
                  "gnn": {"embed_dim": 16, "num_layers": 2},
                  "ir_atlas": {"feat_h": 4, "feat_w": 4, "clamp_edge_attn": -1.0,
                               "prune_node_threshold": 0.001}}
    schema = _write(root / "schema.json", {
        "dataset": "datasets/synthetic.json", "training": train, "validation": val,
        "schema_net": schema_cfg,
        "loss": {"name": "schema_inference_loss", "weight_dict": {"cls": 1.0}}})
    common = ["--device", "cpu", "--seed", "3"]

    def run(*argv):
        assert cli.main(list(argv) + common) == 0, argv

    run("train", "--cfg", vanilla, "--worker", "backbone_worker", "--log-dir", str(root / "s0"),
        "-o", "training.train_epochs=1")
    run("extract", "--cfg", ingredient, "--ckpt", str(root / "s0" / "ckpt"), "--save-path",
        str(root / "codes"), "--batch-size", "4", "--max-features", "128", "--log-dir",
        str(root / "s1"))
    codes = root / "codes" / f"cluster_{CODES}_from_128.npy"
    assert np.load(codes).shape == (CODES, 32)
    assert torch.load(str(codes).replace(".npy", ".pth")).shape == (CODES, 32)
    run("export", "--cfg", ingredient, "--ckpt", str(root / "s0" / "ckpt" / "iter-2"),
        "--vocabulary-fp", str(codes), "--save-path", str(root / "bundle"), "--num-classes",
        str(CLASSES), "--log-dir", str(root / "s2"))
    run("init", "--cfg", schema, "--save-fp", str(root / "atlas.pt"), "--batch-size", "4",
        "--log-dir", str(root / "s3"))
    run("train", "--cfg", schema, "--worker", "schema_net_worker", "--log-dir", str(root / "s4"))
    out = root / "served.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "schemanet_torch.cli", "serve", "--cfg", schema, "--ckpt",
         str(root / "s4" / "ckpt"), "--images", "synthetic:6", "--microbatch", "4", "--explain",
         "--out", str(out), "--graph-sample", "0", "--log-dir", str(root / "serve"), *common],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert [line["index"] for line in lines] == list(range(6))
    assert all(len(line["topk"]) == CLASSES for line in lines)
    assert os.path.isfile(str(out) + ".sample0.graphml")

    from schemanet_torch.serve import load_serve_predictor

    saved = np.load(out)
    server = load_serve_predictor(str(root / "bundle"), dict(schema_cfg), str(root / "s4" / "ckpt"),
                                  CLASSES, microbatch=4, device="cpu")
    images = np.random.default_rng(0).normal(size=(6, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(saved["logits"], server.predict(images))
    explained = server.explain(images)
    for key, value in explained.items():
        np.testing.assert_array_equal(saved[key], value, err_msg=key)
    assert saved["attribution"].shape == (6, CLASSES, 4, 4)


@pytest.fixture(scope="module")
def synthetic_chain(tmp_path_factory):
    """The synthetic chain's files without stage 0: ``extract`` and ``export``
    from a reference ``.pth``, ``init``, ``train --worker schema_net_worker``;
    returns (root, ingredient config, schema config path, schema_net block,
    common flags)."""
    root = tmp_path_factory.mktemp("quant_chain")
    data = {"name": "synthetic", "num_classes": CLASSES, "image_size": 8, "resize": 16,
            "train": {"num_samples": 8}, "val": {"num_samples": 4}}
    (root / "datasets").mkdir()
    _write(root / "datasets" / "synthetic.json", data)
    pth = save_reference(root / "ref.pth",
                         reference_state_dict(dim=32, layers=2, classes=1000, img=16, patch=4))
    train = {"train_epochs": 1, "batch_size": 4, "num_workers": 1, "val_interval": 1,
             "optimizer": {"name": "AdamW", "lr": 1e-3}, "clip_max_norm": 0.1}
    ingredient = _write(root / "ingredient.json", {
        "dataset": "datasets/synthetic.json", "model": MODEL,
        "discretization": {"vocabulary": {"size": CODES, "dim": 32},
                           "encoder_layer": "module.transformer.layers.1"}})
    schema_cfg = {"bundle": str(root / "bundle"), "initial_state_fp": str(root / "atlas.pt"),
                  "gnn": {"embed_dim": 16, "num_layers": 2},
                  "ir_atlas": {"feat_h": 4, "feat_w": 4, "clamp_edge_attn": -1.0,
                               "prune_node_threshold": 0.001}}
    schema = _write(root / "schema.json", {
        "dataset": "datasets/synthetic.json", "training": train,
        "validation": {"batch_size": 4, "num_workers": 1}, "schema_net": schema_cfg,
        "loss": {"name": "schema_inference_loss", "weight_dict": {"cls": 1.0}}})
    common = ["--device", "cpu", "--seed", "3"]
    for argv in (["extract", "--cfg", ingredient, "--ckpt", pth, "--save-path", str(root / "codes"),
                  "--batch-size", "4", "--max-features", "128", "--log-dir", str(root / "s1")],
                 ["export", "--cfg", ingredient, "--ckpt", pth, "--vocabulary-fp",
                  str(root / "codes" / f"cluster_{CODES}_from_128.npy"), "--save-path",
                  str(root / "bundle"), "--num-classes", str(CLASSES), "--log-dir",
                  str(root / "s2")],
                 ["init", "--cfg", schema, "--save-fp", str(root / "atlas.pt"), "--batch-size",
                  "4", "--log-dir", str(root / "s3")],
                 ["train", "--cfg", schema, "--worker", "schema_net_worker", "--log-dir",
                  str(root / "s4")]):
        assert cli.main(argv + common) == 0, argv
    return root, ingredient, pth, schema, schema_cfg, common


@pytest.mark.parametrize("command", ["serve", "extract"])
def test_quant_int8_flag_runs(synthetic_chain, command):
    """``--quant-int8`` runs the backbone's W8A8 route on the synthetic chain:
    ``serve`` prints the logits of ``load_serve_predictor(...,
    quant_int8=True)`` bit for bit (not those of the unquantised server),
    ``extract`` writes the codebook of ``extract_codebook(..., quant=True)``
    (not that of the unquantised features)."""
    from schemanet_torch.models.port import load_pretrain_into
    from schemanet_torch.models.vit import get_model
    from schemanet_torch.pipeline import extract_codebook
    from schemanet_torch.schema.predictor import init_parameters_
    from schemanet_torch.serve import load_serve_predictor

    root, ingredient, pth, schema, schema_cfg, common = synthetic_chain
    if command == "serve":
        out = root / "served_quant.npz"
        assert cli.main(["serve", "--cfg", schema, "--ckpt", str(root / "s4" / "ckpt"),
                         "--images", "synthetic:6", "--microbatch", "4", "--quant-int8",
                         "--out", str(out), "--log-dir", str(root / "serve"), *common]) == 0
        images = np.random.default_rng(0).normal(size=(6, 16, 16, 3)).astype(np.float32)

        def server(quant):
            return load_serve_predictor(str(root / "bundle"), dict(schema_cfg),
                                        str(root / "s4" / "ckpt"), CLASSES, microbatch=4,
                                        device="cpu", quant_int8=quant)

        logits = np.load(out)["logits"]
        np.testing.assert_array_equal(logits, server(True).predict(images))
        assert not np.array_equal(logits, server(False).predict(images))
        return
    save = root / "codes_quant"
    assert cli.main(["extract", "--cfg", ingredient, "--ckpt", pth, "--save-path", str(save),
                     "--batch-size", "4", "--max-features", "128", "--quant-int8",
                     "--log-dir", str(root / "s1_quant"), *common]) == 0
    got = np.load(save / f"cluster_{CODES}_from_128.npy")
    model = get_model(MODEL, CLASSES)  # as the CLI loads it
    init_parameters_(model, torch.Generator().manual_seed(0))
    load_pretrain_into(model, pth)
    model.requires_grad_(False)
    data = json.loads((root / "datasets" / "synthetic.json").read_text())
    loader = cli._stage_loader(cli.get_dataset(data, "train"), data, 4, 3)
    want = extract_codebook(model, loader, 1, CODES, max_features=128, seed=3, quant=True)
    np.testing.assert_array_equal(got, want.numpy())
    assert not np.array_equal(got, np.load(root / "codes" / f"cluster_{CODES}_from_128.npy"))


FIXTURES = REPO / "tests" / "fixtures" / "jpeg"


def _jpeg_tree(root, classes, per_class):
    """An ImageNet-style tree of JPEG fixture copies under root/train, root/val."""
    import shutil

    photos = sorted(f for f in os.listdir(FIXTURES) if f.startswith(("photo_", "s4")))
    k = 0
    for split, n in (("train", per_class), ("val", max(1, per_class // 2))):
        for cls in classes:
            (root / split / cls).mkdir(parents=True)
            for i in range(n):
                shutil.copy(FIXTURES / photos[k % len(photos)], root / split / cls / f"{i}.JPEG")
                k += 1


def test_cli_chain_on_an_image_folder_tree(tmp_path):
    """``extract`` (from a reference ``.pth``) -> ``export`` -> ``init`` ->
    ``train --worker schema_net_worker`` on an ImageNet-style tree of JPEG
    fixtures, every loader on the image-folder route; then ``serve --images``
    on a directory of JPEGs in an interpreter where Pillow cannot be
    imported: exit 0, its logits bit for bit the in-process server's on the
    port's decode of the same files, which is within two levels of the JAX
    CLI's PIL decode and resize."""
    from schemanet_torch.data import jpeg

    if jpeg.decode_route() != jpeg.LIBJPEG:
        pytest.skip("libjpeg's jpeglib.h is not installed: the host decode route is absent")
    root = tmp_path
    wnids = [f"n{i:08d}" for i in range(CLASSES)]
    _jpeg_tree(root / "tree", wnids, 4)
    data = {"name": "imagenet", "root": str(root / "tree"), "resize": 16}
    (root / "datasets").mkdir()
    _write(root / "datasets" / "imagenet.json", data)
    pth = save_reference(root / "ref.pth",
                         reference_state_dict(dim=32, layers=2, classes=1000, img=16, patch=4))
    train = {"train_epochs": 1, "batch_size": 4, "num_workers": 2, "val_interval": 1,
             "optimizer": {"name": "AdamW", "lr": 1e-3}, "clip_max_norm": 0.1}
    val = {"batch_size": 4, "num_workers": 2}
    ingredient = _write(root / "ingredient.json", {
        "dataset": "datasets/imagenet.json", "model": MODEL,
        "discretization": {"vocabulary": {"size": CODES, "dim": 32},
                           "encoder_layer": "module.transformer.layers.1"}})
    schema_cfg = {"bundle": str(root / "bundle"), "initial_state_fp": str(root / "atlas.pt"),
                  "gnn": {"embed_dim": 16, "num_layers": 2},
                  "ir_atlas": {"feat_h": 4, "feat_w": 4, "clamp_edge_attn": -1.0,
                               "prune_node_threshold": 0.001}}
    schema = _write(root / "schema.json", {
        "dataset": "datasets/imagenet.json", "training": train, "validation": val,
        "schema_net": schema_cfg,
        "loss": {"name": "schema_inference_loss", "weight_dict": {"cls": 1.0}}})
    common = ["--device", "cpu", "--seed", "3"]

    def run(*argv):
        assert cli.main(list(argv) + common) == 0, argv

    run("extract", "--cfg", ingredient, "--ckpt", pth, "--save-path", str(root / "codes"),
        "--batch-size", "4", "--max-features", "256", "--log-dir", str(root / "s1"))
    codes = root / "codes" / f"cluster_{CODES}_from_256.npy"
    assert np.load(codes).shape == (CODES, 32)
    run("export", "--cfg", ingredient, "--ckpt", pth, "--vocabulary-fp", str(codes),
        "--save-path", str(root / "bundle"), "--num-classes", str(CLASSES), "--log-dir",
        str(root / "s2"))
    run("init", "--cfg", schema, "--save-fp", str(root / "atlas.pt"), "--batch-size", "4",
        "--log-dir", str(root / "s3"))
    run("train", "--cfg", schema, "--worker", "schema_net_worker", "--log-dir", str(root / "s4"))
    meta = json.load(open(root / "s4" / "ckpt" / "meta.json"))
    assert meta["iter"] == (CLASSES * 4) // 4, meta

    images = root / "tree" / "val" / wnids[0]
    out = root / "served.npz"
    argv = ["serve", "--cfg", schema, "--ckpt", str(root / "s4" / "ckpt"), "--images",
            str(images), "--microbatch", "2", "--out", str(out), "--log-dir",
            str(root / "serve"), *common]
    script = textwrap.dedent(f"""
        import sys
        sys.modules["PIL"] = None  # no Pillow, as beside the card
        from schemanet_torch import cli
        code = cli.main({argv!r})
        assert "PIL" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
        sys.exit(code)
        """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert [line["index"] for line in lines] == [0, 1]

    from schemanet_torch.serve import load_serve_predictor

    port_images = cli._load_serve_images(str(images), 16, "cpu")
    jax_images = jax_cli._load_serve_images(str(images), 16)
    assert port_images.shape == jax_images.shape == (2, 16, 16, 3)
    assert np.abs(port_images - jax_images).max() <= 2 / 255 + 1e-6
    server = load_serve_predictor(str(root / "bundle"), dict(schema_cfg), str(root / "s4" / "ckpt"),
                                  CLASSES, microbatch=2, device="cpu")
    np.testing.assert_array_equal(np.load(out)["logits"], server.predict(port_images))


def _run_cli(argv, timeout=240):
    """``python -m schemanet_torch.cli argv`` in its own session, killed with
    the ranks it spawned past ``timeout`` seconds."""
    import signal

    proc = subprocess.Popen([sys.executable, "-m", "schemanet_torch.cli", *argv], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-4000:]
    return out


@pytest.fixture(scope="module")
def grid_cfgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid_cli")
    data = {"name": "synthetic", "num_classes": CLASSES, "image_size": 8, "resize": 16,
            "train": {"num_samples": 8}, "val": {"num_samples": 4}}
    train = {"train_epochs": 1, "batch_size": 4, "num_workers": 1, "val_interval": 1,
             "optimizer": {"name": "AdamW", "lr": 1e-3}, "clip_max_norm": 0.1}
    vanilla = _write(root / "vanilla.json", {
        "dataset": data, "training": train, "validation": {"batch_size": 4, "num_workers": 1},
        "model": MODEL, "loss": {"name": "ce_loss", "weight_dict": {"cls": 1.0}}})
    ingredient = _write(root / "ingredient.json", {
        "dataset": data, "model": MODEL,
        "discretization": {"vocabulary": {"size": CODES, "dim": 32},
                           "encoder_layer": "module.transformer.layers.1"}})
    return root, vanilla, ingredient


def test_train_on_a_data_grid_equals_one_process(grid_cfgs):
    """``train --mesh-data 2 --device cpu``: the command line spawns two gloo
    ranks (dropout 0.1 live, clipping); rank 0's checkpoint after the 2 steps
    equals one process's within 1e-6, its step and validation the same. The
    key bias of the qkv projection is the exception: its exact gradient is 0
    (a softmax ignores a shift of a row's scores), so AdamW's normalised
    step follows rounding noise there; it is held to 2 lr a step."""
    root, vanilla, _ = grid_cfgs
    common = ["train", "--cfg", vanilla, "--worker", "backbone_worker", "--device", "cpu",
              "--seed", "3"]
    _run_cli(common + ["--log-dir", str(root / "one")])
    _run_cli(common + ["--log-dir", str(root / "grid"), "--mesh-data", "2"])
    metas = [json.loads((root / run / "ckpt" / "meta.json").read_text()) for run in ("one", "grid")]
    assert metas[0] == metas[1] and metas[0]["iter"] == 2
    one, grid = (torch.load(root / run / "ckpt" / "iter-2.pt", weights_only=True)["model"]
                 for run in ("one", "grid"))
    assert sorted(one) == sorted(grid)
    for name, want in one.items():
        err = (grid[name] - want).abs()
        if name.endswith("linear_qkv.bias"):
            q, k, v = err.chunk(3)
            assert float(k.max()) <= 2 * 1e-3 * 2, name
            err = torch.cat([q, v])
        assert float(err.max()) <= 1e-6, name


def test_extract_on_a_data_grid_equals_one_process(grid_cfgs, tmp_path):
    """``extract --mesh-data 2 --device cpu``: both ranks' features gathered,
    the same k-means; rank 0 writes the codebook of one process."""
    root, vanilla, ingredient = grid_cfgs
    pth = save_reference(tmp_path / "ref.pth",
                         reference_state_dict(dim=32, layers=2, classes=CLASSES, img=16, patch=4))
    common = ["extract", "--cfg", ingredient, "--ckpt", pth, "--batch-size", "4",
              "--max-features", "128", "--device", "cpu", "--seed", "3"]
    _run_cli(common + ["--save-path", str(tmp_path / "one"), "--log-dir", str(tmp_path / "l1")])
    _run_cli(common + ["--save-path", str(tmp_path / "grid"), "--log-dir", str(tmp_path / "l2"),
                       "--mesh-data", "2"])
    name = f"cluster_{CODES}_from_128.npy"
    np.testing.assert_allclose(np.load(tmp_path / "grid" / name), np.load(tmp_path / "one" / name),
                               rtol=1e-5, atol=1e-5)


def test_a_grid_larger_than_the_gpus_raises(grid_cfgs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, vanilla, _ = grid_cfgs
    with pytest.raises(SystemExit, match="needs 2 GPUs, one a rank; this host has 0"):
        cli.main(["train", "--cfg", vanilla, "--mesh-data", "2"])


def test_multi_host_without_a_rendezvous_raises(grid_cfgs, monkeypatch, tmp_path):
    _, vanilla, _ = grid_cfgs
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(["train", "--cfg", vanilla, "--multi-host", "--device", "cpu", "--log-dir",
                  str(tmp_path)])
