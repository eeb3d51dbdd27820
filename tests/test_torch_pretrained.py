"""The pretrained-weight loader, the capture probes, ``distill_kl`` and
``make_deterministic`` against the JAX package's, on the CPU.

A reference-named state dict (the reference's module tree:
``transformer.layers.N.attention.linear_qkv.weight`` ..., ``pos_embed`` [n, 1,
d]) is made from a numpy seed at DeiT-Tiny's real shape, wrapped as the
reference's checkpoints are (a ``model`` entry, ``module.`` prefixes), saved
as a ``.pth`` and loaded by both packages' ``load_pretrain_into``; the two
forwards of the same images agree within 1e-4 x max |logit| (fp32; the two
frameworks sum in different orders through 12 layers).
"""

import logging
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models.capture import MidExtractor, translate_probe_name
from schemanet_torch.models.port import from_jax_params, load_pretrain_into, reference_to_port
from schemanet_torch.models.vit import get_model
from schemanet_torch.schema import init_parameters_
from schemanet_torch.schema.loss import get_loss_fn
from schemanet_torch.utils import make_deterministic
from schemanet_tpu.models.capture import MidExtractor as JaxMidExtractor
from schemanet_tpu.models.capture import translate_probe_name as jax_translate_probe_name
from schemanet_tpu.models.port import load_pretrain_into as jax_load_pretrain_into
from schemanet_tpu.models.vit import get_model as jax_get_model
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn
from schemanet_tpu.utils.seed import make_deterministic as jax_make_deterministic


def vit_cfg(dim=192, layers=12, heads=3, img=224, patch=16):
    return {"name": "vit",
            "transformer": dict(embed_dim=dim, num_encoder_layers=layers, num_heads=heads,
                                dim_feedforward=4 * dim, dropout=0.1, activation="gelu",
                                final_norm=True, norm_eps=1e-6),
            "patch_embed": dict(img_size=img, patch_size=patch, image_channels=3),
            "pos_encoding": {"name": "learnable"}}


def reference_state_dict(dim=192, layers=12, classes=1000, img=224, patch=16, seed=0):
    """Reference-named float32 tensors from a numpy seed: Linear [out, in],
    the conv OIHW, pos_embed [n, 1, d]."""
    rng = np.random.default_rng(seed)
    n = (img // patch) ** 2 + 1

    def t(*shape, scale=0.02):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    sd = {"cls_token": t(1, 1, dim), "pos_embed.pos_embed": t(n, 1, dim),
          "patch_embed.proj.weight": t(dim, 3, patch, patch), "patch_embed.proj.bias": t(dim),
          "transformer.norm.weight": 1 + t(dim), "transformer.norm.bias": t(dim),
          "cls_head.weight": t(classes, dim), "cls_head.bias": t(classes)}
    for i in range(layers):
        p = f"transformer.layers.{i}."
        sd.update({
            p + "attention.linear_qkv.weight": t(3 * dim, dim, scale=dim**-0.5),
            p + "attention.linear_qkv.bias": t(3 * dim),
            p + "attention.linear_out.weight": t(dim, dim, scale=dim**-0.5),
            p + "attention.linear_out.bias": t(dim),
            p + "mlp.linear1.weight": t(4 * dim, dim, scale=dim**-0.5),
            p + "mlp.linear1.bias": t(4 * dim),
            p + "mlp.linear2.weight": t(dim, 4 * dim, scale=(4 * dim) ** -0.5),
            p + "mlp.linear2.bias": t(dim),
            p + "norm1.weight": 1 + t(dim), p + "norm1.bias": t(dim),
            p + "norm2.weight": 1 + t(dim), p + "norm2.bias": t(dim),
        })
    return sd


def save_reference(path, sd):
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}, "epoch": 299}, path)
    return str(path)


def _port_model(cfg, classes, seed=0):
    model = get_model(cfg, classes)
    return init_parameters_(model, torch.Generator().manual_seed(seed))


def _jax_params(cfg, classes):
    model = jax_get_model(cfg, classes)
    img = cfg["patch_embed"]["img_size"]
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, dict(params))


def test_pretrained_deit_tiny_matches_jax(tmp_path):
    """DeiT-Tiny's real shape (12 layers, d 192, 1000 classes): both loaders
    take the same file; every port tensor is the file's after the layout
    change, bit for bit; the logits agree with JAX's."""
    cfg = vit_cfg()
    sd = reference_state_dict()
    path = save_reference(tmp_path / "deit_tiny_patch16_224.pth", sd)
    model = load_pretrain_into(_port_model(cfg, 1000), path)
    got_sd = model.state_dict()
    assert set(got_sd) == set(sd)
    for name, value in sd.items():
        want = value.permute(1, 0, 2) if name == "pos_embed.pos_embed" else value
        assert torch.equal(got_sd[name], want), name

    jax_model, params = _jax_params(cfg, 1000)
    params = jax_load_pretrain_into(params, path, num_layers=12)
    images = np.random.default_rng(3).normal(size=(2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jax_model.apply({"params": p}, x)["pred"])(
        params, jnp.asarray(images)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(images))["pred"].numpy()
    assert got.shape == want.shape == (2, 1000)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


SMALL = dict(dim=32, layers=2, heads=2, img=16, patch=4)


def _small_sd(classes):
    s = dict(SMALL)
    s.pop("heads")
    return reference_state_dict(classes=classes, **s)


@pytest.mark.parametrize("framework", ["torch", "jax"])
def test_lax_names_keep_the_local_head(tmp_path, framework):
    """A 100-class model from a 1000-class file with the head in
    ``lax_names``: the head keeps its local initialisation, the rest is the
    file's."""
    cfg, sd = vit_cfg(**SMALL), _small_sd(1000)
    path = save_reference(tmp_path / "ref.pth", sd)
    lax = ["cls_head.weight", "cls_head.bias"]
    if framework == "torch":
        model = _port_model(cfg, 100)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        got = load_pretrain_into(model, path, lax_names=lax).state_dict()
        for name in ("cls_head.weight", "cls_head.bias"):
            assert torch.equal(got[name], before[name])
        assert torch.equal(got["transformer.layers.1.mlp.linear2.weight"],
                           sd["transformer.layers.1.mlp.linear2.weight"])
    else:
        _, params = _jax_params(cfg, 100)
        got = jax_load_pretrain_into(params, path, lax_names=lax, num_layers=2)
        np.testing.assert_array_equal(got["cls_head"]["kernel"], params["cls_head"]["kernel"])
        np.testing.assert_array_equal(
            got["transformer"]["layers_1"]["mlp"]["linear2"]["kernel"],
            sd["transformer.layers.1.mlp.linear2.weight"].numpy().T)


@pytest.mark.parametrize("framework", ["torch", "jax"])
def test_lax_names_without_the_head_raise(tmp_path, framework):
    cfg = vit_cfg(**SMALL)
    path = save_reference(tmp_path / "ref.pth", _small_sd(1000))
    with pytest.raises(ValueError, match="shape mismatch"):
        if framework == "torch":
            load_pretrain_into(_port_model(cfg, 100), path, lax_names=["dist_head.weight"])
        else:
            jax_load_pretrain_into(_jax_params(cfg, 100)[1], path,
                                   lax_names=["dist_head.weight"], num_layers=2)


@pytest.mark.parametrize("framework", ["torch", "jax"])
def test_no_lax_names_warn_and_keep(tmp_path, framework, caplog):
    """``lax_names`` None: a mismatch keeps the local value with a warning;
    keys of the file that map onto nothing warn too."""
    cfg, sd = vit_cfg(**SMALL), _small_sd(1000)
    sd["transformer.layers.7.norm1.weight"] = torch.ones(32)  # past the model's depth
    path = save_reference(tmp_path / "ref.pth", sd)
    with caplog.at_level(logging.WARNING):
        if framework == "torch":
            model = _port_model(cfg, 100)
            head = model.cls_head.weight.detach().clone()
            load_pretrain_into(model, path)
            assert torch.equal(model.cls_head.weight, head)
        else:
            _, params = _jax_params(cfg, 100)
            got = jax_load_pretrain_into(params, path, num_layers=2)
            np.testing.assert_array_equal(got["cls_head"]["kernel"], params["cls_head"]["kernel"])
    assert "keeping local init for cls_head" in caplog.text
    assert "transformer.layers.7.norm1.weight" in caplog.text


def test_reference_to_port_changes_only_pos_embed():
    sd = _small_sd(10)
    out = reference_to_port(sd, num_layers=2)
    assert set(out) == set(sd)
    assert tuple(out["pos_embed.pos_embed"].shape) == (1, 17, 32)
    assert all(out[k] is sd[k] for k in sd if k != "pos_embed.pos_embed")


PROBE_NAMES = ["module.transformer.layers.1",
               "module.transformer.layers.1.attention.attn_raw_identity",
               "module.transformer.layers.0.attention.attn_identity",
               "module.transformer.layers.1.identity1", "module.transformer.layers.0.identity2",
               "layers_1", "layers_0.attn_hmean"]


@pytest.mark.parametrize("name", PROBE_NAMES)
def test_translate_probe_name_matches_jax(name):
    assert translate_probe_name(name) == jax_translate_probe_name(name)


def test_mid_extractor_matches_jax():
    """Features by reference name, through the plain path of each probed
    layer, within rtol 1e-4 / atol 1e-5 x max of JAX's."""
    cfg = vit_cfg(**SMALL)
    jax_model, params = _jax_params(cfg, 10)
    names = PROBE_NAMES[:5]
    images = np.random.default_rng(4).normal(size=(3, 16, 16, 3)).astype(np.float32)
    want = JaxMidExtractor(jax_model, params, names)(jnp.asarray(images))
    model = get_model(cfg, 10)
    model.load_state_dict(from_jax_params(params, {}, model))
    got = MidExtractor(model, names)(torch.from_numpy(images))
    assert list(got) == names
    for name in names:
        w = np.asarray(want[name])
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("T", [1.0, 4.0])
def test_distill_kl_matches_jax(T):
    rng = np.random.default_rng(5)
    student, teacher = (rng.normal(size=(6, 10)).astype(np.float32) * 3 for _ in range(2))
    cfg = {"name": "distill_kl", "loss_cfg": {"T": T}}
    got = get_loss_fn(cfg)({"pred": torch.from_numpy(student)},
                           {"teacher_pred": torch.from_numpy(teacher)})["kl"]
    want = jax_get_loss_fn(cfg)({"pred": jnp.asarray(student)},
                                {"teacher_pred": jnp.asarray(teacher)})["kl"]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("per_process", [True, False])
def test_make_deterministic_matches_jax(per_process):
    """The effective seed and the host generators' draws equal JAX's (one
    process: rank 0)."""
    draws = []
    for fn in (make_deterministic, jax_make_deterministic):
        eff = fn(1234, per_process)
        draws.append((eff, np.random.rand(4).tolist(), random.random()))
    assert draws[0] == draws[1]
