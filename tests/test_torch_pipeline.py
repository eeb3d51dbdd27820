"""Stages 1 and 3 of the port (``schemanet_torch/pipeline``) against the JAX
package, on the CPU, on a 3-layer ViT of width 32 (16 x 16 images, patch 4)
whose JAX weights reach the port through ``models/port.py``.

* ``collect_mid_features``: the layer-1 patch tokens within 1e-5 of max.
* ``extract_codebook`` whole, M = 16: the k-means++ seeding draws from a
  ``torch.Generator`` where JAX draws from ``jax.random``, so the centers
  differ; the port's inertia on the held sample must be within 5% of
  JAX's. The data are sized so both stages hold the same Lloyd sample (the
  JAX stage holds only the chunks read before its k-means starts).
* ``init_atlas`` whole, with JAX's codebook in both: ``class_ingredients``
  equal, the atlas parameters within 1e-5 of max; also with
  ``remove_self_loop``, V_max < M, and ``accumulate_compat`` from an
  explicit ``initial_edge_weights``.
* The chain: ``extract_stage`` -> bundle files -> ``init_stage`` -> atlas
  file -> a stage-4 ``Trainer`` step from the saved atlas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models.port import from_jax_params
from schemanet_torch.models.vit import get_model as torch_get_model
from schemanet_torch.ops import kmeans
from schemanet_torch.pipeline import (
    collect_mid_features,
    extract_codebook,
    extract_stage,
    init_atlas,
    init_stage,
    load_atlas_init,
    load_bundle,
    save_atlas_init,
    save_bundle,
)
from schemanet_torch.schema.atlas import AtlasConfig
from schemanet_torch.schema.predictor import IngredientBackbone
from schemanet_torch.train import schema_net_trainer
from schemanet_tpu.models.vit import get_model as jax_get_model
from schemanet_tpu.pipeline import extract_ingredients as jax_extract
from schemanet_tpu.pipeline.init_schema_net import init_atlas as jax_init_atlas
from schemanet_tpu.schema.atlas import AtlasConfig as JaxAtlasConfig
from schemanet_tpu.schema.predictor import IngredientBackbone as JaxIngredientBackbone

IMG, DIM, M, K, ENCODE_LAYER = 16, 32, 16, 3, 1
MODEL_CFG = {
    "name": "vit",
    "transformer": dict(embed_dim=DIM, num_encoder_layers=3, num_heads=2, dim_feedforward=64,
                        dropout=None, activation="gelu", final_norm=True, norm_eps=1e-6),
    "patch_embed": dict(img_size=IMG, patch_size=4, image_channels=3),
    "pos_encoding": dict(name="learnable"),
}
IR_ATLAS = dict(feat_h=4, feat_w=4, clamp_vertex_attn=-1.0, clamp_edge_attn=-1.0)


class Loader(list):
    def set_epoch(self, epoch):
        pass


def _loader(batches, size, seed, classes=K):
    rng = np.random.default_rng(seed)
    out = Loader()
    for i in range(batches):
        batch = {"image": rng.normal(size=(size, IMG, IMG, 3)).astype(np.float32),
                 "label": rng.integers(0, classes, size=size)}
        if i == batches - 1:
            batch["valid"] = np.array([1.0] * (size - 1) + [0.0], np.float32)
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def jax_vit():
    model = jax_get_model(MODEL_CFG, K)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    port = torch_get_model(MODEL_CFG, K)
    port.load_state_dict(from_jax_params(params, {}, port))
    return model, params, port.requires_grad_(False)


@pytest.fixture(scope="module")
def kmeans_loader():
    # 256 images x 16 patches = 4,096 features a batch: the init sample and
    # the JAX stage's held Lloyd sample are both the first batch
    return _loader(2, 256, 1)


@pytest.fixture(scope="module")
def jax_codebook(jax_vit, kmeans_loader):
    model, params, _ = jax_vit
    return np.array(jax_extract.extract_codebook(model, params, kmeans_loader, ENCODE_LAYER, M,
                                                 max_features=8192, seed=0, lloyd_iters=3,
                                                 lloyd_sample=4096))


def test_collect_mid_features_matches_jax(jax_vit):
    model, params, port = jax_vit
    loader = _loader(3, 8, 0)
    want = jax_extract.collect_mid_features(model, params, loader, ENCODE_LAYER, 300)
    got = collect_mid_features(port, loader, ENCODE_LAYER, 300)
    assert got.shape == want.shape == (300, DIM)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    chunks = list(collect_mid_features(port, loader, ENCODE_LAYER, 300, as_iterator=True))
    assert [len(c) for c in chunks] == [128, 128, 44]


def test_extract_codebook_inertia_within_5_percent_of_jax(jax_vit, kmeans_loader, jax_codebook):
    model, params, port = jax_vit
    got = extract_codebook(port, kmeans_loader, ENCODE_LAYER, M, max_features=8192, seed=0,
                           lloyd_iters=3, lloyd_sample=4096)
    assert got.shape == (M, DIM) and got.dtype == torch.float32
    held = torch.from_numpy(jax_extract.collect_mid_features(
        model, params, kmeans_loader[:1], ENCODE_LAYER, 4096))
    mine = float(kmeans.kmeans_inertia(got, held))
    theirs = float(kmeans.kmeans_inertia(torch.from_numpy(jax_codebook), held))
    assert abs(mine - theirs) <= 0.05 * theirs, (mine, theirs)


@pytest.mark.parametrize("v_max,remove_self_loop,compat", [
    (M, False, False), (8, True, False), (8, False, True)])
def test_init_atlas_matches_jax(jax_vit, jax_codebook, v_max, remove_self_loop, compat):
    model, params, port = jax_vit
    loader = _loader(3, 6, 2)
    cfg = dict(IR_ATLAS, class_max_vertices=v_max, remove_self_loop=remove_self_loop)
    initial = None
    if compat:
        initial = np.random.default_rng(3).random((K, v_max, v_max)).astype(np.float32)
    ib_j = JaxIngredientBackbone(backbone=model, num_codes=M, code_dim=DIM,
                                 encode_layer=ENCODE_LAYER)
    variables = {"params": {"backbone": params, "vocabulary": jnp.asarray(jax_codebook)}}
    want = jax_init_atlas(lambda img: ib_j.apply(variables, img), loader,
                          JaxAtlasConfig(num_vertices=M, num_classes=K, **cfg),
                          accumulate_compat=compat,
                          initial_edge_weights=None if initial is None else jnp.asarray(initial))
    ib = IngredientBackbone(port, M, DIM, ENCODE_LAYER)
    with torch.no_grad():
        ib.vocabulary.copy_(torch.from_numpy(jax_codebook))
    got = init_atlas(ib, loader, AtlasConfig(num_vertices=M, num_classes=K, **cfg),
                     accumulate_compat=compat,
                     initial_edge_weights=None if initial is None else torch.from_numpy(initial),
                     device="cpu")
    assert got["class_ingredients"].dtype == torch.int32
    np.testing.assert_array_equal(got["class_ingredients"].numpy(), want["class_ingredients"])
    for name, value in want["params"].items():
        value = np.asarray(value)
        np.testing.assert_allclose(got["params"][name].numpy(), value, rtol=1e-5,
                                   atol=1e-5 * np.abs(value).max(), err_msg=name)


INGREDIENT_CFG = {
    "dataset": {"name": "cifar_10"},
    "model": MODEL_CFG,
    "discretization": {"vocabulary": {"size": M, "dim": DIM},
                       "encoder_layer": f"module.transformer.layers.{ENCODE_LAYER}"},
}
SCHEMA_NET_CFG = {
    "dataset": {"name": "cifar_10"},
    "training": {"dtype": "float32", "optimizer": {"name": "AdamW", "lr": 1e-3},
                 "param_groups": [{"pattern": "schema_net", "cfg": {"weight_decay": 5e-4}},
                                  {"pattern": "matcher"}],
                 "train_epochs": 1, "batch_size": 4},
    "schema_net": {"matcher": {"similarity": "inner_product"},
                   "gnn": {"embed_dim": 16, "num_layers": 2, "activation": "relu"},
                   "ir_atlas": dict(IR_ATLAS, prune_node_threshold=0.001)},
    "loss": {"name": "schema_inference_loss",
             "weight_dict": {"cls": 1.0, "re_entropy_vertex": 0.5, "re_entropy_edge": 0.75}},
}


def test_stages_chain_through_the_bundle_files(tmp_path):
    loader = _loader(2, 6, 4, classes=10)
    bundle = extract_stage(INGREDIENT_CFG, loader, seed=0, device="cpu", max_features=150,
                           lloyd_iters=2, lloyd_sample=100)
    assert bundle.codebook.shape == (M, DIM) and bundle.encode_layer == ENCODE_LAYER
    save_bundle(str(tmp_path / "bundle"), bundle.model_cfg, bundle.encode_layer,
                bundle.backbone_state, bundle.codebook, bundle.extra)
    loaded = load_bundle(str(tmp_path / "bundle"))
    assert torch.equal(loaded.codebook, bundle.codebook)
    assert sorted(loaded.backbone_state) == sorted(bundle.backbone_state)
    for name, value in bundle.backbone_state.items():
        assert torch.equal(loaded.backbone_state[name], value), name
    assert loaded.extra == {"discretization": INGREDIENT_CFG["discretization"]}

    atlas = init_stage(SCHEMA_NET_CFG, loaded, loader, device="cpu")
    save_atlas_init(str(tmp_path / "atlas.pt"), atlas["params"], atlas["class_ingredients"])
    atlas_back = load_atlas_init(str(tmp_path / "atlas.pt"))
    assert torch.equal(atlas_back["class_ingredients"], atlas["class_ingredients"])
    for name, value in atlas["params"].items():
        assert torch.equal(atlas_back["params"][name], value), name

    trainer = schema_net_trainer(SCHEMA_NET_CFG, loaded, atlas_back, steps_per_epoch=1,
                                 device="cpu")
    sn = trainer.model.schema_net
    assert torch.equal(sn.class_ingredients, atlas["class_ingredients"])
    torch.testing.assert_close(sn.vertex_weights.detach(), atlas["params"]["vertex_weights"])
    assert sn.cfg.graph_precision == "default"
    batch = loader[0]
    loss = trainer.train_iter({"image": torch.from_numpy(batch["image"]),
                               "label": torch.from_numpy(batch["label"])})["loss"]
    assert torch.isfinite(loss), loss


def test_stage_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loader = _loader(1, 2, 5, classes=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_stage(INGREDIENT_CFG, loader)
    bundle = extract_stage(INGREDIENT_CFG, loader, device="cpu", max_features=40,
                           lloyd_iters=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_stage(SCHEMA_NET_CFG, bundle, loader)


def test_init_atlas_orders_unseen_codes_as_jax_top_k():
    """V_max = M: each class row of pass 1 is a full permutation, and every
    code a class never saw weighs an exact 0. Those keep ascending code
    order, as ``jax.lax.top_k`` puts the lower index first among equals."""
    rng = np.random.default_rng(7)
    loader = Loader({"image": rng.integers(0, 3, size=(5, 4)).astype(np.float32) + 4 * (i % 2),
                     "label": rng.integers(0, 2, size=5)} for i in range(4))

    def fake(ing):  # codes ride in as the "image"; attention derives from them
        attn = (ing[:, :, None] + ing[:, None, :]) / 10.0
        return {"ingredients": ing, "attn": attn, "attn_cls": ing / 5.0}

    cfg = dict(num_vertices=8, num_classes=2, feat_h=2, feat_w=2)
    want = jax_init_atlas(lambda img: dict(fake(img), ingredients=img.astype(jnp.int32)),
                          loader, JaxAtlasConfig(**cfg))
    got = init_atlas(lambda img: dict(fake(img), ingredients=img.int()), loader,
                     AtlasConfig(**cfg), device="cpu")
    assert (np.asarray(want["params"]["vertex_weights"]) == 0).any()
    np.testing.assert_array_equal(got["class_ingredients"].numpy(), want["class_ingredients"])
    np.testing.assert_allclose(got["params"]["edge_weights"].numpy(),
                               np.asarray(want["params"]["edge_weights"]), rtol=1e-5, atol=1e-7)
