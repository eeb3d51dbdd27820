"""Stage 0 of the port (fine-tuning the ViT backbone) against the JAX
package's, on the CPU.

A small ViT (2 layers, d=32, 2 heads of 16, FFN 64, 32^2 images, patch 8,
10 classes) starts from the JAX model's seeded variables, loaded into the
port through ``from_jax_params``. JAX runs its fused attention and FFN
kernels in interpret mode (``SCHEMANET_ATTN_BACKEND`` and
``SCHEMANET_MLP_BACKEND`` set to ``interpret``, as its own tests do), the
whole-step comparison included; the port runs the kernels' plain versions.
Both in fp32.

Tolerances, and why (those of ``tests/test_torch_train.py``): logits and
losses rtol 1e-4 (fp32 sums in other orders through 2 layers, ~1e-7
relative per op); gradients leaf by leaf rtol 1e-4 and atol 1e-4 of the
leaf's max (a bias gradient is a sum of terms larger than itself); the
parameters after 3 steps rtol 1e-4 / atol 1e-6 where the step-1 gradient
exceeds 1e-3 of its leaf's max and within 2 * lr * steps elsewhere (Adam's
first step moves an entry by lr * sign(g), which may go either way where g
is near 0); Adam moments rtol 1e-4 and atol 1e-4 of the largest value the
moment could take.

Dropout masks cannot match across the frameworks on the residual branches
(``jax.random`` and ``torch.Generator`` differ), so the comparisons with JAX
run with ``dropout`` off; the dropout-live path is checked on the port
alone: a fixed-generator finite-difference gradient, and equal losses from
equal trainer seeds.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from schemanet_torch.models.layers import DropoutRNG
from schemanet_torch.models.port import from_jax_params, jax_name, to_jax_params
from schemanet_torch.models.vit import get_model as torch_get_model
from schemanet_torch.schema import get_loss_fn as torch_get_loss_fn
from schemanet_torch.train import Trainer, TrainerConfig, backbone_trainer
from schemanet_tpu.models.vit import get_model as jax_get_model
from schemanet_tpu.parallel.mesh import make_mesh
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn
from schemanet_tpu.train.trainer import Trainer as JaxTrainer
from schemanet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from schemanet_tpu.utils.config import get_cfg

STAGE0 = get_cfg("configs/cifar_100/vanilla/deit_tiny.yaml")
NUM_CLASSES, IMG, BATCH, STEPS, STEPS_PER_EPOCH = 10, 32, 4, 3, 2


def _model_cfg(dropout=None, name="vit"):
    return {
        "name": name,
        "transformer": dict(embed_dim=32, num_encoder_layers=2, num_heads=2, dim_feedforward=64,
                            dropout=dropout, activation="gelu", final_norm=True, norm_eps=1e-6),
        "patch_embed": dict(img_size=IMG, patch_size=8, image_channels=3),
        "pos_encoding": {"name": "learnable", "dropout": None},
    }


def _train_cfg():
    return dict(STAGE0["training"], dtype="float32")


class _Steps:
    """What the JAX Trainer reads of a loader when stepped by hand."""

    def __len__(self):
        return STEPS_PER_EPOCH


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _leaves(tree):
    return {"/".join(path): value for path, value in _flatten(tree)}


def _adam_moments(opt_state, which):
    out = {}
    for path, value in jax.tree_util.tree_leaves_with_path(opt_state):
        key = jax.tree_util.keystr(path)
        if f".{which}[" in key:
            out["/".join(re.findall(r"\['([^']+)'\]", key.split(f".{which}", 1)[1]))] = value
    return out


def _batches():
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32),
             rng.integers(0, NUM_CLASSES, size=BATCH).astype(np.int32)) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def fused_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCHEMANET_ATTN_BACKEND", "interpret")
        mp.setenv("SCHEMANET_MLP_BACKEND", "interpret")
        yield


@pytest.fixture(scope="module")
def jax_vit(fused_jax):
    model = jax_get_model(_model_cfg(), NUM_CLASSES)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    return model, params


def _port(params, dropout=None):
    model = torch_get_model(_model_cfg(dropout), NUM_CLASSES)
    model.load_state_dict(from_jax_params(params, {}, model))
    return model


def test_bare_vit_tree_maps_both_ways(jax_vit):
    """The bare ViT tree (no ``backbone`` prefix) maps onto the port and back,
    and jax_name gives the JAX dotted names."""
    _, params = jax_vit
    model = _port(params)
    back = _leaves(to_jax_params(model.state_dict()))
    want = _leaves(params)
    assert sorted(back) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    assert jax_name("transformer.layers.1.attention.linear_qkv.weight", 2) == \
        "transformer.layers_1.attention.linear_qkv.kernel"
    assert jax_name("cls_head.bias", 1) == "cls_head.bias"


def test_eval_and_training_forward_match_jax(jax_vit):
    model_j, params = jax_vit
    model = _port(params)
    image = _batches()[0][0]
    apply = jax.jit(model_j.apply, static_argnames="deterministic")
    want_eval = np.asarray(apply({"params": params}, image, deterministic=True)["pred"])
    want_train = np.asarray(apply({"params": params}, image, deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(1)})["pred"])
    with torch.no_grad():
        got_eval = model(torch.from_numpy(image))["pred"].numpy()
        got_train = model(torch.from_numpy(image), deterministic=False)["pred"].numpy()
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        assert got.shape == (BATCH, NUM_CLASSES)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_loss_and_gradients_match_jax(jax_vit):
    model_j, params = jax_vit
    image, label = _batches()[0]
    loss_cfg = STAGE0["loss"]
    jax_loss = jax_get_loss_fn(loss_cfg)

    def total(p):
        out = model_j.apply({"params": p}, image, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_loss(out, {"label": label})["cls"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(total))(params)
    model = _port(params)
    out = model(torch.from_numpy(image), deterministic=False)
    loss = torch_get_loss_fn(loss_cfg)(out, {"label": torch.from_numpy(label)})["cls"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    got = _leaves(to_jax_params({n: p.grad for n, p in model.named_parameters()}))
    want = _leaves(jax.device_get(want_grads))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def three_steps(jax_vit):
    """Three steps of both trainers with the stage-0 YAML's optimizer,
    schedule and clip_max_norm 0.1."""
    model_j, params = jax_vit
    train_cfg, loss_cfg = _train_cfg(), STAGE0["loss"]
    jax_loss = jax_get_loss_fn(loss_cfg)

    def apply_fn(p, b, image, rng, train):
        return model_j.apply({"params": p}, image, deterministic=not train,
                             rngs={"dropout": rng} if train else None)

    jax_trainer = JaxTrainer(
        cfg=JaxTrainerConfig.from_cfg(train_cfg), apply_fn=apply_fn, loss_fn=jax_loss,
        loss_weights=loss_cfg["weight_dict"], params=jax.tree_util.tree_map(jnp.asarray, params),
        buffers={}, train_loader=_Steps(), val_loader=_Steps(),
        mesh=make_mesh(devices=jax.devices()[:1]), seed=0, compute_dtype=jnp.float32,
    )
    clipper = optax.clip_by_global_norm(train_cfg["clip_max_norm"])

    @jax.jit
    def clipped_grads(p, image, label):
        def total(p_):
            out = apply_fn(p_, {}, image, jax.random.PRNGKey(0), True)
            return jax_loss(out, {"label": label})["cls"]

        grads = jax.grad(total)(p)
        return grads, clipper.update(grads, clipper.init(grads))[0], optax.global_norm(grads)

    model = _port(params)
    trainer = Trainer(TrainerConfig.from_cfg(train_cfg), model, torch_get_loss_fn(loss_cfg),
                      loss_cfg["weight_dict"], STEPS_PER_EPOCH, device="cpu")
    result = {"jax_loss": [], "torch_loss": [], "jax_grads": [], "norms": []}
    for step, (image, label) in enumerate(_batches()):
        grads, clipped, norm = jax.device_get(clipped_grads(jax_trainer.state.params, image, label))
        result["jax_grads"].append(_leaves(grads))
        result["norms"].append(float(norm))
        if step == 0:
            result["jax_clipped"] = _leaves(clipped)
        result["jax_loss"].append(float(jax_trainer.train_iter({"image": image, "label": label})["loss"]))
        metrics = trainer.train_iter({"image": torch.from_numpy(image),
                                      "label": torch.from_numpy(label)})
        result["torch_loss"].append(float(metrics["loss"]))
        if step == 0:
            result["torch_clipped"] = _leaves(to_jax_params(
                {n: p.grad for n, p in model.named_parameters()}))
    result["jax_params"] = _leaves(jax.device_get(jax_trainer.state.params))
    result["torch_params"] = _leaves(to_jax_params(dict(model.named_parameters())))
    opt = jax.device_get(jax_trainer.state.opt_state)
    result["jax_mu"], result["jax_nu"] = _adam_moments(opt, "mu"), _adam_moments(opt, "nu")
    state = trainer.optimizer.optimizer.state
    for which, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        result[f"torch_{which}"] = _leaves(to_jax_params(
            {n: state[p][key] for n, p in model.named_parameters()}))
    result["lr"] = float(train_cfg["optimizer"]["lr"])
    return result


def test_three_steps_losses_match_jax(three_steps):
    np.testing.assert_allclose(three_steps["torch_loss"], three_steps["jax_loss"], rtol=1e-4)
    assert len(set(three_steps["torch_loss"])) == STEPS
    # the clip is live: every step's global norm exceeds clip_max_norm 0.1
    assert min(three_steps["norms"]) > 0.1


def test_step1_clipped_gradients_match_jax(three_steps):
    want, got = three_steps["jax_clipped"], three_steps["torch_clipped"]
    assert sorted(got) == sorted(want)
    total = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in got.values()))
    np.testing.assert_allclose(total, 0.1, rtol=1e-5)  # clipped to the limit
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_params_after_three_steps_match_jax(three_steps):
    want, got = three_steps["jax_params"], three_steps["torch_params"]
    assert sorted(got) == sorted(want)
    bound = 2 * three_steps["lr"] * STEPS
    for name, w in want.items():
        g = np.abs(three_steps["jax_grads"][0][name])
        sure = g > 1e-3 * g.max()
        assert sure.any(), name
        np.testing.assert_allclose(got[name][sure], w[sure], rtol=1e-4, atol=1e-6, err_msg=name)
        assert np.abs(got[name] - w).max() <= bound, name


@pytest.mark.parametrize("which,power,decay", [("mu", 1, 0.9), ("nu", 2, 0.999)])
def test_adam_moments_match_jax(three_steps, which, power, decay):
    want, got = three_steps[f"jax_{which}"], three_steps[f"torch_{which}"]
    assert sorted(got) == sorted(want) == sorted(three_steps["jax_params"])
    for name, w in want.items():
        bound = (1 - decay) * sum(np.abs(g[name]).max() ** power for g in three_steps["jax_grads"])
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * bound, err_msg=name)


def test_dropout_gradient_finite_difference(jax_vit):
    """With dropout 0.1 live, the gradient of the port's training forward
    (plain versions of both kernels, their plain backwards, residual and
    positional dropout) agrees with a central finite difference taken with
    the same generators, so the same masks, in each evaluation."""
    _, params = jax_vit
    model = _port(params, dropout=0.1)
    image = torch.from_numpy(_batches()[0][0])
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(BATCH, NUM_CLASSES)).astype(np.float32))

    def f(x):
        rng = DropoutRNG(torch.Generator().manual_seed(3), torch.Generator().manual_seed(4))
        return (model(x, deterministic=False, rng=rng)["pred"] * w).sum()

    x = image.clone().requires_grad_()
    f(x).backward()
    with torch.no_grad():
        assert float(f(image)) == float(f(image))  # the same generators give the same masks
        off = (_port(params)(image, deterministic=False)["pred"] * w).sum()
        assert float(f(image)) != float(off)  # dropout is live
        with pytest.raises(ValueError, match="DropoutRNG"):
            model(image, deterministic=False)
    v = torch.from_numpy(np.random.default_rng(6).normal(size=image.shape).astype(np.float32))
    v = v / v.norm()
    eps = 0.02
    with torch.no_grad():
        fd = (float(f(image + eps * v)) - float(f(image - eps * v))) / (2 * eps)
    an = float((x.grad * v).sum())
    assert abs(fd - an) / max(abs(fd), abs(an), 1e-9) < 2e-2, (fd, an)


def test_equal_trainer_seeds_give_equal_losses():
    cfg = dict(STAGE0, model=_model_cfg(dropout=0.1), training=_train_cfg(),
               dataset={"name": "cifar_100", "num_classes": NUM_CLASSES})
    image, label = (torch.from_numpy(a) for a in _batches()[0])

    def losses(seed):
        trainer = backbone_trainer(cfg, STEPS_PER_EPOCH, seed=seed, device="cpu")
        assert trainer.model.cls_head.out_features == NUM_CLASSES
        return [float(trainer.train_iter({"image": image, "label": label})["loss"])
                for _ in range(2)]

    first = losses(0)
    assert losses(0) == first
    assert losses(1) != first


def test_deit_heads_and_ce_loss():
    """DeiT returns both heads' logits when training and their mean in eval;
    ce_loss trains on the class head."""
    model = torch_get_model(_model_cfg(name="deit"), NUM_CLASSES)
    from schemanet_torch.schema import init_parameters_

    init_parameters_(model, torch.Generator().manual_seed(0))
    image = torch.from_numpy(_batches()[0][0])
    with torch.no_grad():
        train = model(image, deterministic=False)
        evals = model(image)["pred"]
    assert sorted(train) == ["dist", "pred"]
    torch.testing.assert_close(evals, (train["pred"] + train["dist"]) / 2)
    label = torch.zeros(BATCH, dtype=torch.long)
    loss = torch_get_loss_fn({"name": "ce_loss"})(train, {"label": label})["cls"]
    torch.testing.assert_close(loss, torch.nn.functional.cross_entropy(train["pred"], label))


def test_chip_smoke_stage0_config_is_the_yaml():
    """``chip_smoke.py`` drives stage 0 with a copy of the YAML (the card's
    machine may have no YAML parser): the copy must say what the file says."""
    import chip_smoke

    cfg = chip_smoke.STAGE0_CFG
    assert cfg["training"] == {k: STAGE0["training"][k] for k in cfg["training"]}
    assert cfg["loss"] == STAGE0["loss"]
    for key in ("name", "transformer", "patch_embed", "pos_encoding"):
        assert cfg["model"][key] == STAGE0["model"][key], key
