"""The port's image-folder datasets, crop parameters and image-folder loader
route against the JAX package, on the CPU, on trees of the JPEG fixtures
(``tests/fixtures/jpeg/``, written by ``tools/make_jpeg_fixtures.py``) made
in ``tmp_path``.

* Builders: each of the 12 image-folder names gives the JAX builder's
  samples (paths and labels), classes and order, exactly; the class files
  of ``configs/datasets/examples/`` included.
* Crop parameters: each split's function draws the JAX function's
  ``(top, left, crop_h, crop_w, flip)`` for 1,000 seeds.
* The loader (libjpeg route) after ``prepare``: order, labels and ``valid``
  exact, images within 1 / (255 min std) + 1e-5 of the JAX
  ``DataLoader(device_normalize=True)``'s (its C++ filter rounds once where
  the port's kernel and plain version round twice: one level at a .5 tie);
  refused files through Pillow as JAX's loader, or raising without it.
* Stages 1 and 3 fed from a tree by the port's loader: the port's stages
  against the JAX stages on the same prepared images, with
  ``tests/test_torch_pipeline.py``'s rules.

Tests that decode need libjpeg's header (the host route) and skip without
it; those that compare with the JAX loader's native route need
``native/libimagepipe.so``.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.data import augment as port_augment
from schemanet_torch.data import datasets as port_datasets
from schemanet_torch.data import jpeg
from schemanet_torch.data import loader as port_loader
from schemanet_tpu.data import augment as jax_augment
from schemanet_tpu.data import datasets as jax_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
EXAMPLES = os.path.join(REPO, "configs", "datasets", "examples")
PHOTOS = sorted(f for f in os.listdir(FIXTURES) if f.startswith(("photo_", "s4", "prog", "gray")))


@pytest.fixture
def libjpeg():
    if jpeg.decode_route() != jpeg.LIBJPEG:
        pytest.skip("libjpeg's jpeglib.h is not installed: the host decode route is absent")


@pytest.fixture
def jax_native():
    from schemanet_tpu.data import native

    if not native.jpeg_available():
        pytest.skip("native/libimagepipe.so (the JAX package's libjpeg route) is not built")
    return native


def _tree(root, classes, per_class, names=PHOTOS, ext=".JPEG", start=0):
    """<root>/<class>/img<k><ext>: copies of fixtures, a different one each."""
    k = start
    for cls in classes:
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(per_class):
            shutil.copy(os.path.join(FIXTURES, names[k % len(names)]),
                        os.path.join(root, cls, f"img{i:04d}{ext}"))
            k += 1
    return str(root)


def _samples(ds):
    if hasattr(ds, "indices"):  # a SubsetDataset
        return [ds.base.samples[i] for i in ds.indices]
    return list(ds.samples)


def _assert_same(port, jax_ds):
    assert type(port).__name__ == type(jax_ds).__name__
    assert _samples(port) == _samples(jax_ds)
    assert list(port.classes) == list(jax_ds.classes)
    assert port.num_classes == jax_ds.num_classes and len(port) == len(jax_ds)
    assert port.name == jax_ds.name


def _build_both(name, root, **kw):
    return (port_datasets.DATASET_REGISTRY.get(name)(root=root, **kw),
            jax_datasets.DATASET_REGISTRY.get(name)(root=root, **kw))


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("name", ["imagenet", "imagenet=10", "imagenet=20", "imagenet=50",
                                  "imagenet=100"])
def test_imagenet_builders_match_jax(tmp_path, name, split):
    wnids = [f"n{i:08d}" for i in range(105)]
    for sub in ("train", "val"):
        _tree(tmp_path / sub, wnids[::-1], 1, names=["s420_1x1.JPEG"])  # made in reverse
    (tmp_path / "train" / "not_a_class.txt").write_text("x")
    _assert_same(*_build_both(name, str(tmp_path), split=split))
    classes = tmp_path / "classes.txt"
    classes.write_text("".join(w + "\n" for w in wnids[50:0:-3]))
    _assert_same(*_build_both(name, str(tmp_path), split=split, classes_file=str(classes)))
    _assert_same(*_build_both(name, str(tmp_path), split=split, classes=wnids[7:30]))


def test_imagenet_10birds_matches_jax(tmp_path):
    wnids = [f"n0153{i:04d}" for i in range(12)]
    _tree(tmp_path / "train", wnids, 2, names=["s420_1x1.JPEG"])
    _tree(tmp_path / "val", wnids, 1, names=["s420_1x1.JPEG"])
    fp = tmp_path / "birds.csv"
    fp.write_text(",classes\n" + "".join(f"{i},{w}\n" for i, w in enumerate(wnids[2:12])))
    for split in ("train", "val"):
        _assert_same(*_build_both("imagenet=10birds", str(tmp_path), split=split,
                                  classes_file=str(fp)))
    with pytest.raises(ValueError, match="wnid list"):
        port_datasets.DATASET_REGISTRY.get("imagenet=10birds")(str(tmp_path))


@pytest.mark.parametrize("name", ["imagenet_a", "imagenet_r"])
@pytest.mark.parametrize("nested", [False, True])
def test_robustness_builders_match_jax(tmp_path, name, nested):
    full = [f"n{i:08d}" for i in range(20)]
    root = tmp_path / "set"
    _tree(root / "val" if nested else root, full[3:20:4], 3, names=["s420_1x1.JPEG"])
    _assert_same(*_build_both(name, str(root)))
    fp = tmp_path / "wnids.txt"
    fp.write_text("".join(w + "\n" for w in full))
    port, jax_ds = _build_both(name, str(root), imagenet_classes_file=str(fp))
    _assert_same(port, jax_ds)
    assert sorted({label for _, label in port.samples}) == [3, 7, 11, 15, 19]
    fp.write_text(full[0] + "\n")
    with pytest.raises(ValueError, match="absent"):
        port_datasets.DATASET_REGISTRY.get(name)(str(root), imagenet_classes_file=str(fp))


@pytest.mark.parametrize("split", ["train", "val"])
def test_caltech_101_matches_jax(tmp_path, split):
    classes = port_datasets.load_class_list(
        os.path.join(EXAMPLES, "caltech_101_classes.example.csv"))
    root = tmp_path / "caltech"
    for c, cls in enumerate(classes):
        os.makedirs(root / cls)
        for i in range(1, 4 + c):
            shutil.copy(os.path.join(FIXTURES, "s420_1x1.JPEG"), root / cls / f"image_{i:04d}.jpg")
    for kw in ({"train_per_class": 2, "seed": 5}, {"train_per_class": 30},
               {"split_file": os.path.join(EXAMPLES, "caltech_101_train_split.example.txt")}):
        _assert_same(*_build_both("caltech_101", str(root), split=split, **kw))


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("single_folder", [False, True])
def test_mini_imagenet_matches_jax(tmp_path, split, single_folder):
    fp = os.path.join(EXAMPLES, "mini_imagenet_classes.example.csv")
    classes = port_datasets.load_class_list(fp)
    assert classes == jax_datasets.load_class_list(fp)
    base = tmp_path if single_folder else tmp_path / split
    _tree(base, classes[::-1] + ["n09999999"], 2, names=["s420_1x1.JPEG"])
    _assert_same(*_build_both("mini_imagenet", str(tmp_path), split=split, classes_file=fp))


def _cub_tree(base):
    rows = [("1", "001.Black_footed_Albatross/a1.jpg", "1", "1"),
            ("2", "001.Black_footed_Albatross/a2.jpg", "1", "0"),
            ("10", "002.Laysan_Albatross/b1.jpg", "2", "1"),
            ("3", "002.Laysan_Albatross/b2.jpg", "2", "0"),
            ("4", "002.Laysan_Albatross/b3.jpg", "2", "1")]
    os.makedirs(base, exist_ok=True)
    (base / "images.txt").write_text("".join(f"{i} {p}\n" for i, p, _, _ in rows))
    (base / "image_class_labels.txt").write_text("".join(f"{i} {c}\n" for i, _, c, _ in rows))
    (base / "train_test_split.txt").write_text("".join(f"{i} {t}\n" for i, _, _, t in rows))
    (base / "classes.txt").write_text("1 001.Black_footed_Albatross\n2 002.Laysan_Albatross\n")
    for _, p, _, _ in rows:
        os.makedirs(os.path.dirname(base / "images" / p), exist_ok=True)
        shutil.copy(os.path.join(FIXTURES, "s420_1x1.JPEG"), base / "images" / p)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("layout", ["split_files", "nested_split_files", "folders"])
def test_cub_200_matches_jax(tmp_path, split, layout):
    if layout == "folders":
        _tree(tmp_path / split, ["c0", "c1"], 2, names=["s420_1x1.JPEG"])
    else:
        _cub_tree(tmp_path / "CUB_200_2011" if layout == "nested_split_files" else tmp_path)
    _assert_same(*_build_both("cub_200", str(tmp_path), split=split))


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("layout", ["devkit", "folders"])
def test_stanford_cars_matches_jax(tmp_path, split, layout):
    if layout == "folders":
        _tree(tmp_path / split, ["AM General Hummer", "Acura RL"], 2, names=["s420_1x1.JPEG"])
    else:
        from scipy.io import savemat

        devkit = tmp_path / "devkit"
        devkit.mkdir()
        savemat(str(devkit / "cars_meta.mat"),
                {"class_names": np.array(["AM General Hummer", "Acura RL"], object)})
        kind = [("class", "i4"), ("fname", "O")]
        savemat(str(devkit / "cars_train_annos.mat"), {"annotations": np.array(
            [(np.int32(1), "t1.jpg"), (np.int32(2), "t2.jpg"), (np.int32(1), "t3.jpg")], kind)})
        savemat(str(devkit / "cars_test_annos_withlabels.mat"),
                {"annotations": np.array([(np.int32(2), "v1.jpg")], kind)})
    _assert_same(*_build_both("stanford_cars", str(tmp_path), split=split))


def test_load_class_list_matches_jax(tmp_path):
    plain = tmp_path / "plain.txt"
    plain.write_text("n01440764\nn01773157\n\nn02051845\n")
    pandas = tmp_path / "pandas.csv"
    pandas.write_text(",classes\n0,n01\n1,n02\n2,n03\n")
    for fp in [str(plain), str(pandas)] + [os.path.join(EXAMPLES, f) for f in os.listdir(EXAMPLES)
                                           if f.endswith(".csv")]:
        assert port_datasets.load_class_list(fp) == jax_datasets.load_class_list(fp)


def test_dataset_configs_build(tmp_path, libjpeg):
    """``configs/datasets/{imagenet,caltech_101,mini_imagenet}.yaml``, as JSON
    (the card's machine has no PyYAML), build the image-folder loaders."""
    import yaml

    from schemanet_torch.utils.config import get_cfg

    tree = tmp_path / "data"
    _tree(tree / "train", ["n01532829", "n01558993"], 2)
    _tree(tree / "val", ["n01532829", "n01558993"], 1)
    for name in ("imagenet", "caltech_101", "mini_imagenet"):
        with open(os.path.join(REPO, "configs", "datasets", f"{name}.yaml")) as f:
            cfg = dict(yaml.safe_load(f), root=str(tree))
        if name == "caltech_101":
            cfg.update(root=str(tree / "train"), train_per_class=1)
        path = tmp_path / f"{name}.json"
        path.write_text(__import__("json").dumps(cfg))
        data_cfg = get_cfg(str(path))
        train, val, n = port_loader.build_loaders(data_cfg, {"batch_size": 2, "num_workers": 1},
                                                  {"batch_size": 2, "num_workers": 1})
        assert n == 2 and train.decode_route == jpeg.LIBJPEG == val.decode_route
        batch = port_loader.batch_to_device(next(iter(train)), "cpu")
        image = train.prepare(batch["image"], batch["crop"])
        assert image.shape == (2, 224, 224, 3) and torch.isfinite(image).all()


# ---------------------------------------------------------------------------
# crop parameters
# ---------------------------------------------------------------------------


def test_crop_params_match_jax_for_1000_seeds():
    assert set(port_augment.CROP_PARAMS_REGISTRY) == set(jax_augment.NATIVE_AUG_REGISTRY)
    shapes = [(375, 500, 3), (500, 333, 3), (32, 32, 3), (1, 1, 3), (9, 17, 3), (224, 224, 3)]
    for key, port_fn in port_augment.CROP_PARAMS_REGISTRY.items():
        jax_fn = jax_augment.NATIVE_AUG_REGISTRY[key]
        for attr in ("fixed_crop", "identity"):
            assert getattr(port_fn, attr, None) == getattr(jax_fn, attr, None), (key, attr)
        for seed in range(1000):
            shape = shapes[seed % len(shapes)]
            assert (port_fn(shape, np.random.default_rng(seed))
                    == jax_fn(shape, np.random.default_rng(seed))), (key, seed)
    for split in ("train", "val", "test"):
        assert (port_augment.get_crop_params_fn("imagenet", split)
                is {"train": port_augment._params_rrc_train}.get(
                    split, port_augment._params_imagenet_val))


# ---------------------------------------------------------------------------
# the loader's image-folder route
# ---------------------------------------------------------------------------

RESIZE = 48
STD_TOL = 1.0 / (255.0 * min(port_augment.DEFAULT_STD)) + 1e-5


def _jax_loader(ds, split, batch, train, seed):
    from schemanet_tpu.data.loader import DataLoader

    return DataLoader(ds, batch, split=split, shuffle=train, drop_last=train, seed=seed,
                      resize=RESIZE, num_workers=2, device_normalize=True, process_index=0,
                      process_count=1)


def _port_loader(ds, split, batch, train, seed):
    return port_loader.DataLoader(ds, batch, split=split, shuffle=train, drop_last=train,
                                  seed=seed, resize=RESIZE, num_workers=2)


def _compare_loaders(port, jax_loader, epochs=(0,)):
    mean = np.asarray(port_augment.DEFAULT_MEAN, np.float32)
    std = np.asarray(port_augment.DEFAULT_STD, np.float32)
    n = 0
    for epoch in epochs:
        port.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        assert len(port) == len(jax_loader)
        for got, want in zip(port, jax_loader):
            moved = port_loader.batch_to_device(got, "cpu")
            image = port.prepare(moved["image"], moved["crop"]).numpy()
            np.testing.assert_array_equal(moved["label"].numpy(), want["label"])
            np.testing.assert_array_equal(moved["valid"].numpy(), want["valid"])
            ref = (want["image"].astype(np.float32) / 255.0 - mean) / std
            assert image.shape == ref.shape == (len(want["label"]), RESIZE, RESIZE, 3)
            assert np.abs(image - ref).max() <= STD_TOL
            n += 1
    return n


@pytest.mark.parametrize("split,train", [("train", True), ("val", False)])
def test_loader_matches_jax_native_route(tmp_path, libjpeg, jax_native, split, train):
    root = _tree(tmp_path / split, [f"n{i:08d}" for i in range(5)], 3)
    port_ds = port_datasets.get_dataset({"name": "imagenet", "root": str(tmp_path)}, split)
    jax_ds = jax_datasets.get_dataset({"name": "imagenet", "root": str(tmp_path)}, split)
    assert root and len(port_ds) == 15
    port = _port_loader(port_ds, split, 4, train, seed=3)
    assert port.decode_route == jpeg.LIBJPEG
    assert _compare_loaders(port, _jax_loader(jax_ds, split, 4, train, 3), epochs=(0, 1)) == \
        (6 if train else 8)


def _refused_tree(tmp_path):
    """A class folder with the two files libjpeg refuses and a real PNG
    among ordinary JPEGs."""
    from PIL import Image

    root = tmp_path / "val"
    _tree(root, ["n00000001", "n00000002"], 2)
    for name in ("cmyk_160x120.JPEG", "png_named_jpeg_130x90.JPEG"):
        shutil.copy(os.path.join(FIXTURES, name), root / "n00000001" / f"z_{name}")
    Image.fromarray(np.asarray(Image.open(os.path.join(FIXTURES, "s444_160x120.JPEG")))).save(
        root / "n00000002" / "z_real.png")
    return root


@pytest.mark.parametrize("split", ["train", "val"])
def test_refused_files_take_pillow_as_jax(tmp_path, libjpeg, jax_native, split):
    root = _refused_tree(tmp_path)
    if split == "train":
        os.rename(root, tmp_path / "train")
    port_ds = port_datasets.get_dataset({"name": "imagenet", "root": str(tmp_path)}, split)
    jax_ds = jax_datasets.get_dataset({"name": "imagenet", "root": str(tmp_path)}, split)
    train = split == "train"
    _compare_loaders(_port_loader(port_ds, split, 7, train, 1),
                     _jax_loader(jax_ds, split, 7, train, 1))


def test_refused_files_raise_without_pillow(tmp_path, libjpeg, monkeypatch):
    root = _refused_tree(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = port_datasets.get_dataset({"name": "imagenet", "root": str(tmp_path)}, "val")
    for i, (path, _) in enumerate(ds.samples):
        if os.path.basename(path).startswith("z_"):
            with pytest.raises(jpeg.RefusedImage, match=os.path.basename(path)):
                ds[i]
        else:
            assert ds[i][0].dtype == np.uint8
    loader = _port_loader(ds, "val", 7, False, 0)
    with pytest.raises(jpeg.RefusedImage, match="z_"):
        list(loader)
    assert root


def test_subset_of_a_folder_takes_the_route(tmp_path, libjpeg):
    _tree(tmp_path / "train", ["a", "b"], 3)
    ds = port_datasets.make_partial(
        port_datasets.get_dataset({"name": "imagenet", "root": str(tmp_path)}, "train"), 0.5, 2)
    assert ds.get_raw(0)[0] == open(ds.sample_path(0), "rb").read()
    loader = _port_loader(ds, "train", 3, True, 0)
    assert loader.decode_route == jpeg.LIBJPEG
    batch = next(iter(loader))
    assert batch["crop"].shape == (3, 8) and batch["image"].dtype == np.uint8
    array_subset = port_datasets.make_partial(
        port_datasets.get_dataset({"name": "synthetic", "num_samples": 8}, "train"), 0.5)
    assert not hasattr(array_subset, "get_raw")


# ---------------------------------------------------------------------------
# stages 1 and 3 fed from a tree
# ---------------------------------------------------------------------------

IMG, DIM, M, K, ENCODE_LAYER = 16, 32, 16, 3, 1
MODEL_CFG = {
    "name": "vit",
    "transformer": dict(embed_dim=DIM, num_encoder_layers=3, num_heads=2, dim_feedforward=64,
                        dropout=None, activation="gelu", final_norm=True, norm_eps=1e-6),
    "patch_embed": dict(img_size=IMG, patch_size=4, image_channels=3),
    "pos_encoding": dict(name="learnable"),
}


class _Epochs:
    """A loader of precomputed batches, one list an epoch (the JAX stages
    read the port loader's prepared images through it)."""

    def __init__(self, by_epoch):
        self.by_epoch, self.epoch = by_epoch, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        return iter(self.by_epoch[self.epoch])


def _prepared(loader, epoch):
    loader.set_epoch(epoch)
    out = []
    for batch in loader:
        moved = port_loader.batch_to_device(batch, "cpu")
        out.append({"image": loader.prepare(moved["image"], moved["crop"]).numpy(),
                    "label": moved["label"].numpy(), "valid": moved["valid"].numpy()})
    return out


def test_stages_1_and_3_from_a_tree_match_jax(tmp_path, libjpeg):
    from schemanet_torch.models.port import from_jax_params
    from schemanet_torch.models.vit import get_model as torch_get_model
    from schemanet_torch.ops import kmeans
    from schemanet_torch.pipeline import collect_mid_features, extract_codebook, init_atlas
    from schemanet_torch.schema.atlas import AtlasConfig
    from schemanet_torch.schema.predictor import IngredientBackbone
    from schemanet_tpu.models.vit import get_model as jax_get_model
    from schemanet_tpu.pipeline import extract_ingredients as jax_extract
    from schemanet_tpu.pipeline.init_schema_net import init_atlas as jax_init_atlas
    from schemanet_tpu.schema.atlas import AtlasConfig as JaxAtlasConfig
    from schemanet_tpu.schema.predictor import IngredientBackbone as JaxIngredientBackbone

    _tree(tmp_path / "train", [f"n{i:08d}" for i in range(K)], 40)
    ds = port_datasets.get_dataset({"name": "imagenet", "root": str(tmp_path)}, "train")
    loader = port_loader.DataLoader(ds, 24, split="train", shuffle=True, drop_last=False, seed=2,
                                    resize=IMG, num_workers=2)
    by_epoch = [_prepared(loader, 0), _prepared(loader, 1)]
    loader.set_epoch(0)
    model = jax_get_model(MODEL_CFG, K)
    params = jax.tree_util.tree_map(np.asarray, dict(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))["params"]))
    port = torch_get_model(MODEL_CFG, K)
    port.load_state_dict(from_jax_params(params, {}, port))
    port.requires_grad_(False)

    # stage 1: the features from the tree, then the codebook's inertia (the
    # JAX stage holds every feature as its Lloyd sample: fewer than 4,096)
    want = jax_extract.collect_mid_features(model, params, _Epochs(by_epoch), ENCODE_LAYER, 1920)
    got = collect_mid_features(port, loader, ENCODE_LAYER, 1920)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    codebook_j = np.array(jax_extract.extract_codebook(
        model, params, _Epochs(by_epoch), ENCODE_LAYER, M, max_features=1920, seed=0,
        lloyd_iters=3, lloyd_sample=1920))
    codebook = extract_codebook(port, loader, ENCODE_LAYER, M, max_features=1920, seed=0,
                                lloyd_iters=3, lloyd_sample=1920)
    held = torch.from_numpy(np.asarray(want))
    mine = float(kmeans.kmeans_inertia(codebook, held))
    theirs = float(kmeans.kmeans_inertia(torch.from_numpy(codebook_j), held))
    assert abs(mine - theirs) <= 0.05 * theirs, (mine, theirs)

    # stage 3: both passes from the tree (pass 2 at epoch 1), JAX's codebook in both
    cfg = dict(feat_h=4, feat_w=4, clamp_vertex_attn=-1.0, clamp_edge_attn=-1.0,
               class_max_vertices=8)
    ib_j = JaxIngredientBackbone(backbone=model, num_codes=M, code_dim=DIM,
                                 encode_layer=ENCODE_LAYER)
    variables = {"params": {"backbone": params, "vocabulary": jnp.asarray(codebook_j)}}
    want = jax_init_atlas(lambda img: ib_j.apply(variables, img), _Epochs(by_epoch),
                          JaxAtlasConfig(num_vertices=M, num_classes=K, **cfg))
    ib = IngredientBackbone(port, M, DIM, ENCODE_LAYER)
    with torch.no_grad():
        ib.vocabulary.copy_(torch.from_numpy(codebook_j))
    loader.set_epoch(0)
    got = init_atlas(ib, loader, AtlasConfig(num_vertices=M, num_classes=K, **cfg), device="cpu")
    np.testing.assert_array_equal(got["class_ingredients"].numpy(), want["class_ingredients"])
    for name, value in want["params"].items():
        value = np.asarray(value)
        np.testing.assert_allclose(got["params"][name].numpy(), value, rtol=1e-5,
                                   atol=1e-5 * np.abs(value).max(), err_msg=name)
