"""The port's stages on a grid of gloo ranks, one process each, against the
port's one process on the global batch, on the CPU (the port of
``tests/test_multihost.py`` and of ``tests/test_parallel.py``'s stage tests).

Each test spawns its ranks with ``spawn_ranks`` under a time limit: a rank
that fails or hangs stops the others and fails the test. Tolerances, each
against one process on the same global batches (the same code; only the
order of the sums over the ranks differs):

* stage 0 (the DeiT backbone fine-tuned with dropout 0.1 live, the CIFAR-100
  vanilla config's AdamW and clipping, data 2): each rank's masks are the
  global batch's for its rows, so the losses agree to rtol 1e-6 (measured
  7.7e-8) and the parameters after 3 steps within 1e-6 (measured 1.25e-7);
* stage 3 (data 2): ``class_ingredients`` equal, the atlas within 1e-5
  (measured 6.0e-8, both accumulations);
* stage 1 (data 2): the features within 1e-5, the k-means centers within
  1e-5 (both measured equal) and the codes of every feature equal but at
  near-ties (two centers within 1e-4 of the distance);
* validation on a model-2 grid: each sample counted once (``n``), the
  accuracy and loss of one process;
* a ``(2, 2)`` checkpoint (clipping on, so the global norm adds the
  shards' squares over the model group): the file rank 0 writes restores
  in one process bit for bit, and a ``(2, 2)`` grid resumed from it takes
  one process's next step within 2e-6;
* ``schema_net_worker`` on a data-2 grid with its loaders, validation and
  checkpoints, in fp32 (in bf16 each rank rounds its share of a weight
  gradient's sum over the batch to bf16, so the sums differ by bf16's
  rounding): both ranks hold the same state and the same final validation,
  which agree with one process's (loss rtol 1e-5, parameters within 1e-5).
"""

import json
import os

import numpy as np
import pytest
import torch

from schemanet_torch.models.vit import get_model
from schemanet_torch.pipeline import save_atlas_init, save_bundle
from schemanet_torch.pipeline.extract_ingredients import collect_mid_features, extract_codebook
from schemanet_torch.pipeline.init_schema_net import init_atlas
from schemanet_torch.schema import build_predictor, get_loss_fn, init_parameters_
from schemanet_torch.schema.atlas import AtlasConfig, trunc_normal_unit
from schemanet_torch.train import (SCHEMA_NET_FROZEN, CheckpointManager, Evaluation, LaunchArgs,
                                   Trainer, TrainerConfig, schema_net_worker)
from schemanet_tpu.utils.config import get_cfg
from tests._torch_grid_rank import SliceLoader, _fake_stage3_predictor, run_grid, run_steps
from tests.test_torch_parallel import CIFAR, MODEL_CFG, SCHEMA_CFG

VANILLA = get_cfg("configs/cifar_100/vanilla/deit_tiny.yaml")
VIT_CFG = dict(MODEL_CFG, transformer=dict(MODEL_CFG["transformer"], num_encoder_layers=2,
                                           dropout=0.1))
FROZEN_VIT_CFG = dict(VIT_CFG, transformer=dict(VIT_CFG["transformer"], dropout=None))
K, M, D = 6, 16, 32


def _images(rng, n, size=16):
    return torch.from_numpy(rng.normal(size=(n, size, size, 3)).astype(np.float32))


def test_stage0_data_parallel_with_dropout_matches_one_process(tmp_path):
    model = get_model(VIT_CFG, K)
    init_parameters_(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batches = [(_images(rng, 8), torch.from_numpy(rng.integers(0, K, 8))) for _ in range(3)]
    spec = dict(case="steps", kind="backbone", model_cfg=VIT_CFG, K=K,
                train_cfg=VANILLA["training"], loss_cfg=VANILLA["loss"],
                state=model.state_dict(), steps_per_epoch=2, batches=batches, grid=(2, 1))
    one = run_steps(spec, None)
    ranks = run_grid(spec, 2, tmp_path)
    got = [s["loss"] for s in ranks[0]["losses"]]
    np.testing.assert_allclose(got, [s["loss"] for s in one["losses"]], rtol=1e-6)
    assert len(set(got)) == 3
    for name, want in one["state"]["model"].items():
        for r in ranks:
            assert float((r["state"]["model"][name] - want).abs().max()) <= 1e-6, name


def test_resnet_batch_norm_on_a_data_grid_matches_one_process(tmp_path):
    """ResNet-18 stage 0 on a (data 2, model 1) grid: every BatchNorm
    normalises by the global batch's statistics (each rank's sums of x and
    x^2 summed over the data group, and their gradients in the backward), so
    the losses, the step-1 gradients and the running statistics after two
    steps are one process's on the global batch. In fp64 but the loss (fp32
    in both packages): in fp32 a ReLU input within the grid's rounding
    difference of 0 would take its other branch and move its neighbours'
    gradients by its cotangent (tests/test_torch_resnet.py). Losses rtol
    1e-6 and the step-1 gradients within 1e-5 of each leaf's largest value
    (the fp32 loss's rounding, ~1e-7, carried back); the running statistics
    and parameters after two steps within 1e-4 of the largest (AdamW moves
    an entry whose gradient is near 0 by lr either way)."""
    cfg = {"name": "resnet18"}
    model = get_model(cfg, K, dtype=torch.float64)
    init_parameters_(model, torch.Generator().manual_seed(0))
    model.double()
    rng = np.random.default_rng(5)
    batches = [(_images(rng, 8, 32).double(), torch.from_numpy(rng.integers(0, K, 8)))
               for _ in range(2)]
    spec = dict(case="steps", kind="backbone", model_cfg=cfg, K=K, dtype="float64",
                train_cfg=VANILLA["training"], loss_cfg=VANILLA["loss"],
                state=model.state_dict(), steps_per_epoch=2, batches=batches, grid=(2, 1))
    one = run_steps(spec, None)
    ranks = run_grid(spec, 2, tmp_path)
    np.testing.assert_allclose([s["loss"] for s in ranks[0]["losses"]],
                               [s["loss"] for s in one["losses"]], rtol=1e-6)
    for name, want in one["grads"].items():
        for r in ranks:
            assert float((r["grads"][name] - want).abs().max()) <= 1e-5 * float(
                want.abs().max()), name
    stats = [n for n in one["state"]["model"] if n.endswith((".mean", ".var"))]
    assert len(stats) == 2 * 20 and not torch.equal(one["state"]["model"]["bn1.mean"],
                                                     torch.zeros(64, dtype=torch.float64))
    for name, want in one["state"]["model"].items():
        for r in ranks:
            assert float((r["state"]["model"][name] - want).abs().max()) <= 1e-4 * float(
                want.abs().max()), name


def _stage3_batches(rng):
    return [{"image": torch.from_numpy(rng.integers(0, 8, size=(8, 4)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 3, size=8))} for _ in range(3)]


@pytest.mark.parametrize("compat", [False, True])
def test_stage3_data_parallel_matches_one_process(tmp_path, compat):
    """tests/test_parallel.py:153-195's atlas init, its two passes on 2 ranks
    (and the reference's accumulation onto the random edge init)."""
    atlas_cfg = dict(num_vertices=8, num_classes=3, class_max_vertices=4, feat_h=2, feat_w=2,
                     remove_self_loop=True)
    batches = _stage3_batches(np.random.default_rng(0))
    base = init_atlas(_fake_stage3_predictor, SliceLoader(batches, None),
                      AtlasConfig(**atlas_cfg), accumulate_compat=compat, device="cpu")
    ranks = run_grid(dict(case="stage3", atlas_cfg=atlas_cfg, batches=batches, compat=compat,
                          grid=(2, 1)), 2, tmp_path)
    for got in ranks:
        assert torch.equal(got["class_ingredients"], base["class_ingredients"])
        for key, want in base["params"].items():
            torch.testing.assert_close(got["params"][key], want, rtol=1e-5, atol=1e-5,
                                       msg=key)


def test_stage1_data_parallel_matches_one_process(tmp_path):
    """tests/test_parallel.py:198-232's codebook: the features of both ranks
    gathered in the global batch's order, then the same k-means."""
    model = get_model(FROZEN_VIT_CFG, 4)
    init_parameters_(model, torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    rng = np.random.default_rng(2)
    batches = [{"image": _images(rng, 8)} for _ in range(2)]
    kmeans = dict(encode_layer=1, num_clusters=4, max_features=256, lloyd_iters=2, seed=0)
    loader = SliceLoader(batches, None)
    want_feats = collect_mid_features(model, loader, 1, 256)
    want = extract_codebook(model, loader, **kmeans)
    ranks = run_grid(dict(case="stage1", kind="backbone", model_cfg=FROZEN_VIT_CFG,
                          K=4, state=model.state_dict(), batches=batches, kmeans=kmeans,
                          grid=(2, 1)), 2, tmp_path)
    for got in ranks:
        torch.testing.assert_close(got["features"], want_feats, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["centers"], want, rtol=1e-5, atol=1e-5)
        d_want, d_got = torch.cdist(want_feats, want), torch.cdist(want_feats, got["centers"])
        near = d_want.sort(dim=1).values
        tie = (near[:, 1] - near[:, 0]) <= 1e-4 * near[:, 1]
        same = d_want.argmin(1) == d_got.argmin(1)
        assert bool((same | tie).all()) and same.float().mean() > 0.9


def _predictor_state(seed=0):
    model = build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, 1)
    init_parameters_(model, torch.Generator().manual_seed(seed))
    return model


def test_evaluation_on_a_model_axis_counts_each_sample_once(tmp_path):
    """Two ranks of one model group hold the same data: the sums go over the
    data group, so 10 validation samples (the last batch padded) count 10
    times, not 20, with one process's accuracy and loss; a metric meter
    synced over the data group counts them once too."""
    model = _predictor_state()
    rng = np.random.default_rng(3)
    batches = [{"image": _images(rng, 4), "label": torch.from_numpy(rng.integers(0, K, 4)),
                "valid": torch.tensor([1.0, 1.0, 1.0, 1.0] if i < 2 else [1.0, 1.0, 0.0, 0.0])}
               for i in range(3)]
    loss_cfg = CIFAR["loss"]
    want = Evaluation(model, get_loss_fn(loss_cfg), loss_cfg["weight_dict"],
                      SliceLoader(batches, None), (1, 5), "cpu")()
    ranks = run_grid(dict(case="eval", kind="schema", model_cfg=MODEL_CFG, schema_cfg=SCHEMA_CFG,
                          K=K, M=M, D=D, encode_layer=1, state=model.state_dict(),
                          loss_cfg=loss_cfg, batches=batches, grid=(1, 2)), 2, tmp_path)
    assert want["n"] == 10
    for r in ranks:
        got = r["eval"]
        assert got["n"] == 10 and r["meter_count"] == 10
        assert got["acc"] == pytest.approx(want["acc"], rel=1e-6)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def test_grid_checkpoint_restores_in_one_process(tmp_path):
    """Rank 0 of a (2, 2) grid writes the gathered state after 2 steps; one
    process restores it bit for bit, moments and all; a (2, 2) grid and one
    process both resume from it and take the same next step (within the
    grid's tolerances of ``tests/test_torch_parallel.py``: 2e-6 a
    parameter)."""
    model = _predictor_state(1)
    rng = np.random.default_rng(4)
    batches = [(_images(rng, 8), torch.from_numpy(rng.integers(0, K, 8))) for _ in range(2)]
    # clipping on: the global norm of a model-2 grid adds its shards' squares
    train_cfg = dict(CIFAR["training"], clip_max_norm=0.05)
    spec = dict(case="steps", kind="schema", model_cfg=MODEL_CFG, schema_cfg=SCHEMA_CFG, K=K,
                M=M, D=D, encode_layer=1, train_cfg=train_cfg, loss_cfg=CIFAR["loss"],
                state=model.state_dict(), steps_per_epoch=2, batches=batches, grid=(2, 2),
                ckpt_dir=str(tmp_path / "ckpt"))
    ranks = run_grid(spec, 4, tmp_path / "grid")
    saved = CheckpointManager(str(tmp_path / "ckpt")).restore("grid")
    fresh = build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, 1)
    trainer = Trainer(TrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN),
                      fresh, get_loss_fn(CIFAR["loss"]), CIFAR["loss"]["weight_dict"], 2,
                      device="cpu", ckpt_dir=str(tmp_path / "ckpt"))
    trainer.resume("grid")
    restored = trainer.state_dict()

    def same_bits(a, b, path=""):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                same_bits(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                same_bits(x, y, f"{path}/{i}")
        elif torch.is_tensor(a):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert torch.equal(a.reshape(-1).view(torch.uint8) if a.is_floating_point() else a,
                               b.reshape(-1).view(torch.uint8) if b.is_floating_point() else b), path
        else:
            assert a == b, path

    same_bits(saved["model"], restored["model"])
    same_bits(saved["hot"], restored["hot"])
    same_bits(saved["optimizer"]["state"], restored["optimizer"]["state"])
    same_bits(saved["model"], ranks[3]["state"]["model"])  # the whole state on every rank
    assert saved["step"] == restored["step"] == 2
    assert saved["hot"]["schema_net.edge_weights"]["m"].shape == (K, M, M)

    more = dict(spec, batches=batches[:1], ckpt_dir=None,
                restore=str(tmp_path / "ckpt" / "grid.pt"))
    want = run_steps(dict(more, grid=None), None)["state"]
    got = run_grid(more, 4, tmp_path / "resumed")[0]["state"]
    assert got["step"] == want["step"] == 3
    for name, w in want["model"].items():
        if w.is_floating_point():
            assert float((got["model"][name] - w).abs().max()) <= 2e-6, name


@pytest.fixture(scope="module")
def worker_files(tmp_path_factory):
    """A bundle (a seeded 2-layer ViT and codebook) and an atlas init."""
    root = tmp_path_factory.mktemp("grid_workers")
    backbone = get_model(MODEL_CFG, K)
    init_parameters_(backbone, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    save_bundle(str(root / "bundle"), MODEL_CFG, 0, backbone.state_dict(),
                torch.rand(M, D, generator=g) * 2 - 1)
    save_atlas_init(str(root / "atlas_init.pt"), {
        "vertex_weights": trunc_normal_unit((K, M), g),
        "edge_weights": trunc_normal_unit((K, M, M), g),
        "vertex_attribute_weights": torch.full((2, 1), 0.5),
        "edge_attribute_weights": torch.full((2, 1), 0.5),
    }, torch.stack([torch.randperm(M, generator=g) for _ in range(K)]).int())
    return root


def test_schema_net_worker_on_two_ranks_matches_one_process(worker_files, tmp_path):
    """tests/test_multihost.py's two-process run, on the port: loaders
    giving each rank its half of every batch of 4, validation every 4 steps
    and at the end, checkpoints from rank 0."""
    cfg = {"dataset": {"name": "synthetic", "num_classes": K, "image_size": 8, "resize": 16,
                       "train": {"num_samples": 12}, "val": {"num_samples": 6}},
           "training": dict(CIFAR["training"], dtype="float32", train_epochs=2, batch_size=4,
                            val_interval=4, print_interval=2, num_workers=2),
           "validation": {"batch_size": 4, "num_workers": 2}, "loss": CIFAR["loss"],
           "schema_net": dict(SCHEMA_CFG, bundle=str(worker_files / "bundle"),
                              initial_state_fp=str(worker_files / "atlas_init.pt"))}
    one = schema_net_worker(cfg, LaunchArgs(seed=0, log_dir=str(tmp_path / "one"), device="cpu"))
    ranks = run_grid(dict(case="worker", cfg=cfg, log_dir=str(tmp_path / "grid"), grid=(2, 1)),
                     2, tmp_path / "ranks")
    want_state = one["trainer"].state_dict()["model"]
    for r in ranks:
        assert r["step"] == one["trainer"].step == 6
        assert r["eval"]["n"] == one["eval"]["n"] == 6
        assert r["eval"]["acc"] == ranks[0]["eval"]["acc"]
        assert r["eval"]["loss"] == pytest.approx(one["eval"]["loss"], rel=1e-5)
        for name, want in want_state.items():
            got = r["state"]["model"][name]
            assert torch.equal(got, ranks[0]["state"]["model"][name]), name
            if want.is_floating_point():
                assert float((got - want).abs().max()) <= 1e-5, name
    meta = json.loads((tmp_path / "grid" / "ckpt" / "meta.json").read_text())
    assert meta["iter"] == 6 and meta["last_tag"] == "iter-6"
    assert {"best.pt", "iter-6.pt"} <= set(os.listdir(tmp_path / "grid" / "ckpt"))
