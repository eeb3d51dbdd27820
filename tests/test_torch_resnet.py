"""The port's ResNets (``models/resnet.py``, ``official_models``) against the
JAX package's, on the CPU.

The port starts from the JAX model's seeded variables (``params`` and
``batch_stats``, through ``from_jax_params``). Tolerances, and why:

* fp32 forwards: logits, the stage probe and the running statistics a
  training forward leaves, within 1e-5 of the largest value (a ResNet-50's
  training forward: 1e-3, below);
* two AdamW steps (the training forward normalises by the batch's
  statistics and moves the running ones, as flax's ``mutable=
  ["batch_stats"]``), run in fp64 on both sides but the loss, which both
  packages take in fp32 (its logits cast): losses rtol 1e-6; the step-1
  gradients leaf by leaf within 1e-5 of the leaf's largest value (the fp32
  loss's rounding, ~1e-7, carried back); the parameters after two steps
  rtol 1e-4 / atol 1e-6 (``test_torch_backbone_train.py``'s) where the step-1 gradient exceeds 1e-3 of its leaf's largest,
  and within 2 lr steps elsewhere (AdamW's first step moves an entry by lr
  sign(g), either way where g is near 0); so the step-2 gradients and the
  running statistics after the two steps within 1e-4 of the largest (such
  entries' lr moved a few step-2 values by 1.5e-5 of the largest). Not fp32
  throughout: a ReLU
  whose input lies within the packages' fp32 difference of 0 (~1e-5 after a
  block at 64^2; one such input in a 64^2 batch of 8 measured 1.4e-6) takes
  its other branch in one of them, and the gradient of its neighbourhood
  moves by its cotangent: a 5% difference in a bias gradient, where fp32
  against fp64 within each package agreed to 5e-6. AdamW's first step then
  moves such an entry by lr the other way;
* a ResNet-50's fp32 training forward at 48^2 (its last stage normalises 2
  x 2 maps of 8 items, 32 values a channel): logits and statistics within
  1e-3 of the largest; flax's fast variance E[x^2] - E[x]^2 loses digits
  where a channel's mean is large against its spread, and the packages'
  sums run in other orders: measured 4e-4 of the largest logit at 64^2,
  where its deterministic forward (the running statistics) agrees within
  2e-6.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch import cli
from schemanet_torch.models.port import from_jax_params, jax_name, to_jax_params, to_jax_variables
from schemanet_torch.models.resnet import Bottleneck, ResNet
from schemanet_torch.models.vit import get_model as torch_get_model
from schemanet_torch.schema import get_loss_fn as torch_get_loss_fn
from schemanet_torch.schema import init_parameters_
from schemanet_torch.train import LaunchArgs, Trainer, TrainerConfig, backbone_trainer
from schemanet_torch.train.workers import backbone_worker
from schemanet_tpu.models.vit import get_model as jax_get_model
from schemanet_tpu.parallel.mesh import make_mesh
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn
from schemanet_tpu.train.trainer import Trainer as JaxTrainer
from schemanet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

NUM_CLASSES, IMG, BATCH, STEPS = 5, 64, 8, 2
TRAIN_CFG = {"optimizer": {"name": "AdamW", "lr": 1e-3}, "lr_schedule": {"name": "constant"},
             "train_epochs": 1}
LOSS_CFG = {"name": "ce_loss", "weight_dict": {"cls": 1.0}}


def _leaves(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_leaves(value, prefix + (key,)))
        else:
            out["/".join(prefix + (key,))] = np.asarray(value)
    return out


def _close(got, want, frac, what):
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=frac * np.abs(w).max(),
                                   err_msg=f"{what} {name}")


def _images(seed=0, n=BATCH, size=IMG):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _jax_resnet(name, size=IMG):
    model = jax_get_model({"name": name}, NUM_CLASSES)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    params = jax.tree_util.tree_map(np.asarray, dict(v["params"]))
    # running statistics away from their initial 0 and 1, so the
    # deterministic forward reads them
    stats = jax.tree_util.tree_map(np.asarray, dict(v["batch_stats"]))
    rng = np.random.default_rng(7)
    stats = jax.tree_util.tree_map(
        lambda s: (s + rng.uniform(0.0, 0.2, s.shape)).astype(np.float32), stats)
    return model, params, stats


def _port(name, params, stats):
    model = torch_get_model({"name": name}, NUM_CLASSES)
    model.load_state_dict(from_jax_params(params, stats, model))
    return model


@pytest.fixture(scope="module")
def resnet18():
    return _jax_resnet("resnet18")


@pytest.mark.parametrize("name,count", [("resnet18", 11_689_512), ("resnet34", 21_797_672),
                                        ("resnet50", 25_557_032)])
def test_parameter_counts_are_torchvision_s(name, count):
    model = torch_get_model({"name": name}, 1000)
    assert sum(p.numel() for p in model.parameters()) == count
    # the running statistics are buffers, as flax's batch_stats are no params
    assert all(n.rsplit(".", 1)[-1] in ("mean", "var") for n, _ in model.named_buffers())


def test_registry_entries():
    official = torch_get_model({"name": "official_models", "model_name": "resnet50"}, 7)
    assert isinstance(official, ResNet) and isinstance(official.layer1_0, Bottleneck)
    assert official.fc.out_features == 7
    assert official.stage_sizes == (3, 4, 6, 3)
    assert torch_get_model({"name": "resnet34"}, 7).stage_sizes == (3, 4, 6, 3)
    with pytest.raises(KeyError):
        torch_get_model({"name": "official_models", "model_name": "resnet101"}, 7)


def test_variables_map_both_ways(resnet18):
    _, params, stats = resnet18
    model = _port("resnet18", params, stats)
    got_params, got_stats = to_jax_variables(model.state_dict())
    _close(_leaves(got_params), _leaves(params), 0.0, "params")
    _close(_leaves(got_stats), _leaves(stats), 0.0, "batch_stats")
    assert jax_name("layer2_0.downsample_conv.weight", 4) == "layer2_0.downsample_conv.kernel"
    assert jax_name("layer2_0.downsample_bn.weight", 1) == "layer2_0.downsample_bn.scale"
    assert jax_name("fc.weight", 2) == "fc.kernel"


def test_forwards_and_running_statistics_match_jax(resnet18):
    model_j, params, stats = resnet18
    model = _port("resnet18", params, stats)
    image = _images()
    variables = {"params": params, "batch_stats": stats}
    want_eval = model_j.apply(variables, image, capture=("layer2.out",))
    want_train, mutated = model_j.apply(variables, image, deterministic=False,
                                        mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = model(torch.from_numpy(image), capture=("layer2.out",))
        # the deterministic forward leaves the running statistics alone
        assert all(torch.equal(a, b) for a, b in zip(model.buffers(), _port(
            "resnet18", params, stats).buffers()))
        got_train = model(torch.from_numpy(image), deterministic=False)
    _close({"pred": got_eval["pred"].numpy()}, {"pred": np.asarray(want_eval["pred"])}, 1e-5,
           "eval")
    probe = got_eval["captured"]["layer2.out"]
    assert probe.shape == (BATCH, IMG // 8, IMG // 8, 128)
    _close({"p": probe.numpy()}, {"p": np.asarray(want_eval["captured"]["layer2.out"])}, 1e-5,
           "layer2.out")
    _close({"pred": got_train["pred"].numpy()}, {"pred": np.asarray(want_train["pred"])}, 1e-5,
           "train")
    _close(_leaves(to_jax_variables(model.state_dict())[1]),
           _leaves(jax.device_get(mutated["batch_stats"])), 1e-5, "batch_stats")


def test_resnet50_forwards_match_jax():
    model_j, params, stats = _jax_resnet("resnet50", 48)
    model = _port("resnet50", params, stats)
    image = _images(1, size=48)
    variables = {"params": params, "batch_stats": stats}
    want_eval = np.asarray(model_j.apply(variables, image)["pred"])
    want_train, mutated = model_j.apply(variables, image, deterministic=False,
                                        mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = model(torch.from_numpy(image))["pred"].numpy()
        got_train = model(torch.from_numpy(image), deterministic=False)["pred"].numpy()
    _close({"pred": got_eval}, {"pred": want_eval}, 1e-5, "eval")
    _close({"pred": got_train}, {"pred": np.asarray(want_train["pred"])}, 1e-3, "train")
    _close(_leaves(to_jax_variables(model.state_dict())[1]),
           _leaves(jax.device_get(mutated["batch_stats"])), 1e-3, "batch_stats")


class _Steps:
    """What the JAX Trainer reads of a loader when stepped by hand."""

    def __len__(self):
        return 1


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def two_steps(resnet18):
    """Two AdamW steps of the JAX Trainer (its worker's apply_fn, the
    running statistics threaded through ``__buffers__``) and of the port's
    Trainer from the same variables and batches, in fp64 on both sides."""
    _, params, stats = resnet18
    result = {"jax_loss": [], "torch_loss": [], "jax_grads": [], "torch_grads": []}
    with jax.enable_x64(True):
        model_j = jax_get_model({"name": "resnet18"}, NUM_CLASSES, dtype=jnp.float64)
        jax_loss = jax_get_loss_fn(LOSS_CFG)

        def apply_fn(p, b, image, rng, train):
            if train:
                out, mutated = model_j.apply({"params": p, "batch_stats": b}, image,
                                             deterministic=False, mutable=["batch_stats"])
                out["__buffers__"] = mutated["batch_stats"]
                return out
            return model_j.apply({"params": p, "batch_stats": b}, image)

        jax_trainer = JaxTrainer(
            cfg=JaxTrainerConfig.from_cfg(TRAIN_CFG), apply_fn=apply_fn, loss_fn=jax_loss,
            loss_weights=LOSS_CFG["weight_dict"], params=jax.tree_util.tree_map(
                jnp.asarray, _f64(params)), buffers=jax.tree_util.tree_map(jnp.asarray, _f64(stats)),
            train_loader=_Steps(), val_loader=_Steps(), mesh=make_mesh(devices=jax.devices()[:1]),
            seed=0, compute_dtype=jnp.float64,
        )

        @jax.jit
        def grads_of(p, b, image, label):
            def total(p_):
                return jax_loss(apply_fn(p_, b, image, None, True), {"label": label})["cls"]

            return jax.grad(total)(p)

        model = torch_get_model({"name": "resnet18"}, NUM_CLASSES, dtype=torch.float64).double()
        model.load_state_dict(from_jax_params(params, stats, model))
        trainer = Trainer(TrainerConfig.from_cfg(TRAIN_CFG), model, torch_get_loss_fn(LOSS_CFG),
                          LOSS_CFG["weight_dict"], 1, device="cpu")
        rng = np.random.default_rng(3)
        for step in range(STEPS):
            image = _images(10 + step).astype(np.float64)
            label = rng.integers(0, NUM_CLASSES, size=BATCH).astype(np.int32)
            state = jax_trainer.state
            result["jax_grads"].append(_leaves(jax.device_get(
                grads_of(state.params, state.buffers, image, label))))
            result["jax_loss"].append(float(jax_trainer.train_iter(
                {"image": image, "label": label})["loss"]))
            metrics = trainer.train_iter({"image": torch.from_numpy(image),
                                          "label": torch.from_numpy(label)})
            result["torch_loss"].append(float(metrics["loss"]))
            result["torch_grads"].append(_leaves(to_jax_params(
                {n: p.grad for n, p in model.named_parameters()})))
        result["jax_stats"] = _leaves(jax.device_get(jax_trainer.state.buffers))
        result["jax_params"] = _leaves(jax.device_get(jax_trainer.state.params))
    result["torch_params"], result["torch_stats"] = map(_leaves,
                                                        to_jax_variables(model.state_dict()))
    return result


def test_two_steps_losses_match_jax(two_steps):
    np.testing.assert_allclose(two_steps["torch_loss"], two_steps["jax_loss"], rtol=1e-6)
    assert two_steps["torch_loss"][0] != two_steps["torch_loss"][1]


@pytest.mark.parametrize("step", range(STEPS))
def test_gradients_match_jax(two_steps, step):
    _close(two_steps["torch_grads"][step], two_steps["jax_grads"][step], (1e-5, 1e-4)[step],
           f"step {step + 1} gradient")


def test_state_after_two_steps_matches_jax(two_steps):
    _close(two_steps["torch_stats"], two_steps["jax_stats"], 1e-4, "batch_stats")
    want, got = two_steps["jax_params"], two_steps["torch_params"]
    assert sorted(got) == sorted(want)
    lr = TRAIN_CFG["optimizer"]["lr"]
    for name, w in want.items():
        g = np.abs(two_steps["jax_grads"][0][name])
        sure = g > 1e-3 * g.max()
        np.testing.assert_allclose(got[name][sure], w[sure], rtol=1e-4, atol=1e-6, err_msg=name)
        assert np.abs(got[name] - w).max() <= 2 * lr * STEPS, name
    # the biased variance: torch's BatchNorm2d would move var by n / (n - 1)
    assert not np.allclose(two_steps["torch_stats"]["bn1/var"], 1.0)


def test_init_parameters_follow_flax():
    model = torch_get_model({"name": "resnet18"}, 10)
    init_parameters_(model, torch.Generator().manual_seed(0))
    w = model.layer3_0.conv2.weight.detach()  # 256 x 3 x 3 inputs: lecun normal, std 1/sqrt(fan_in)
    assert abs(float(w.std()) - (1 / (256 * 9)) ** 0.5) < 0.05 * (1 / (256 * 9)) ** 0.5
    assert float(w.abs().max()) <= 2 / 0.87962566 / (256 * 9) ** 0.5
    assert torch.equal(model.bn1.weight, torch.ones(64))
    assert torch.equal(model.bn1.bias, torch.zeros(64))
    assert torch.equal(model.bn1.mean, torch.zeros(64)) and torch.equal(model.bn1.var,
                                                                         torch.ones(64))
    assert torch.equal(model.fc.bias, torch.zeros(10))


def test_pre_train_raises_as_the_jax_loader(tmp_path):
    """The reference checkpoint loader reads a ViT's depth: a ResNet config
    naming a file that exists raises (the JAX worker's ``model.
    num_encoder_layers``), one naming a missing file trains from scratch."""
    path = tmp_path / "ref.pth"
    torch.save({"model": {}}, path)
    cfg = {"model": {"name": "resnet18", "pre_train": str(path)}, "training": TRAIN_CFG,
           "loss": LOSS_CFG, "dataset": {"num_classes": NUM_CLASSES}}
    with pytest.raises(AttributeError):
        backbone_trainer(cfg, 1, device="cpu")
    cfg["model"]["pre_train"] = str(tmp_path / "missing.pth")
    assert isinstance(backbone_trainer(cfg, 1, device="cpu").model, ResNet)


def _worker_cfg(epochs):
    return {
        "dataset": {"name": "synthetic", "num_classes": 3, "image_size": 32,
                    "train": {"num_samples": 16}, "val": {"num_samples": 8}},
        "training": dict(TRAIN_CFG, train_epochs=epochs, batch_size=8, num_workers=1,
                         print_interval=100, val_interval=1000),
        "validation": {"batch_size": 8, "num_workers": 1},
        "model": {"name": "resnet18"},
        "loss": LOSS_CFG,
    }


def test_worker_resumes_bit_for_bit_with_the_running_statistics(tmp_path):
    """``python -m schemanet_torch.cli train`` takes a ResNet config: one
    epoch, then ``backbone_worker`` resumed ("auto") for a second, ends with
    the bits of a two-epoch run: parameters, running statistics, moments."""
    cfg_path = tmp_path / "resnet.json"
    cfg_path.write_text(json.dumps(_worker_cfg(1)))
    cut = tmp_path / "cut"
    assert cli.main(["train", "--cfg", str(cfg_path), "--worker", "backbone_worker", "--log-dir",
                     str(cut), "--device", "cpu", "--seed", "0"]) == 0
    resumed = backbone_worker(_worker_cfg(2), LaunchArgs(seed=0, log_dir=str(cut),
                                                         resume="auto", device="cpu"))
    full = backbone_worker(_worker_cfg(2), LaunchArgs(seed=0, log_dir=str(tmp_path / "full"),
                                                      device="cpu"))
    assert resumed["trainer"].start_epoch == 1 and resumed["trainer"].step == 4
    want, got = full["trainer"].state_dict(), resumed["trainer"].state_dict()
    assert not torch.equal(want["model"]["bn1.mean"], torch.zeros(64))  # the statistics moved
    for name, value in want["model"].items():
        assert torch.equal(got["model"][name], value), name
    for pid, slot in want["optimizer"]["state"].items():
        for key, value in slot.items():
            assert torch.equal(got["optimizer"]["state"][pid][key], value), (pid, key)
    assert resumed["eval"] == full["eval"]
