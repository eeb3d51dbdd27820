"""The feature dump of stage 1 (``saved_features.h5``) and its clustering,
the port's against the JAX package's, on the CPU.

* ``append_h5`` writes the file ``_append_h5`` writes: dataset
  ``features``, float32, chunks ``(4096, d)``, maxshape ``(None, d)``, the
  same rows (bit for bit) after two appends.
* ``cluster_features`` from the JAX k-means++ init (the JAX package draws
  it from ``jax.random``, the port from a ``torch.Generator``) against the
  JAX ``cluster_saved_features`` on one file, by stage 1's rules: the ids
  of every row >= 99.9% equal (measured all equal), the centers within 1e-4
  of their max. The port's own seeding: inertia within 5% of JAX's on
  unclustered features, as ``tests/test_torch_pipeline.py`` holds
  ``extract_codebook``.
* The CLI: ``extract --save-features`` dumps the collected features (the
  rows of ``collect_mid_features``) beside the codebook, and ``extract
  --saved-features-fp`` writes ``cluster_<M>_from_h5.npy``, the centers of
  ``cluster_saved_features`` of the dump.
"""

import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch import cli
from schemanet_torch.ops import kmeans
from schemanet_torch.pipeline import extract_ingredients as port_ei
from schemanet_tpu.ops import kmeans as jax_kmeans
from schemanet_tpu.pipeline import extract_ingredients as jax_ei
from tests.test_torch_cli import CODES, MODEL, _write
from tests.test_torch_pretrained import reference_state_dict, save_reference

M, DIM = 32, 16


def _features(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(M, DIM)) * 4
    return (centers[rng.integers(0, M, n)] + rng.normal(size=(n, DIM))).astype(np.float32)


def _layout(path):
    with h5py.File(path, "r") as f:
        ds = f["features"]
        return {"keys": sorted(f), "dtype": ds.dtype, "chunks": ds.chunks,
                "maxshape": ds.maxshape, "shape": ds.shape}, ds[:]


def test_dump_layout_equals_jax(tmp_path):
    a, b = _features(5000, 1), _features(3000, 2)
    port, jax_path = tmp_path / "port.h5", tmp_path / "jax.h5"
    port_ei.append_h5(str(port), torch.from_numpy(a))
    port_ei.append_h5(str(port), b)
    jax_ei._append_h5(str(jax_path), a)
    jax_ei._append_h5(str(jax_path), b)
    (got, rows), (want, want_rows) = _layout(port), _layout(jax_path)
    assert got == want and got["chunks"] == (4096, DIM) and got["maxshape"] == (None, DIM)
    assert got["dtype"] == np.float32
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(port_ei.read_saved_features(str(port)), np.concatenate([a, b]))


def test_reads_the_reference_dataset_name(tmp_path):
    feats = _features(100)
    with h5py.File(tmp_path / "ref.h5", "w") as f:
        f.create_dataset("saved_features", data=feats)
    np.testing.assert_array_equal(port_ei.read_saved_features(str(tmp_path / "ref.h5")), feats)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("dump") / "saved_features.h5"
    jax_ei._append_h5(str(path), _features(9000, 3))
    return str(path)


def test_cluster_matches_jax_from_its_init(dump):
    feats = port_ei.read_saved_features(dump)
    want = np.asarray(jax_ei.cluster_saved_features(dump, M, seed=0, lloyd_iters=3))
    init = jax_kmeans.kmeans_init(jax.random.PRNGKey(0), jnp.asarray(feats[:4096]), M)
    got = port_ei.cluster_features(
        feats, M, lloyd_iters=3, device="cpu",
        init=kmeans.KMeansState(torch.from_numpy(np.array(init.centers)),
                                torch.from_numpy(np.array(init.counts)))).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    ids = lambda c: ((feats[:, None] - c[None]) ** 2).sum(-1).argmin(1)  # noqa: E731
    assert (ids(got) == ids(want)).mean() >= 0.999


def test_cluster_saved_features_inertia_within_5_percent_of_jax(tmp_path):
    """On features without clusters (one Gaussian), where the two seedings
    reach minima of about one depth (on well-separated blobs either may
    merge two of them)."""
    dump = str(tmp_path / "gauss.h5")
    feats = np.random.default_rng(4).normal(size=(9000, DIM)).astype(np.float32)
    jax_ei._append_h5(dump, feats)
    got = port_ei.cluster_saved_features(dump, M, seed=0, lloyd_iters=3, device="cpu")
    want = torch.from_numpy(np.array(jax_ei.cluster_saved_features(dump, M, seed=0,
                                                                     lloyd_iters=3)))
    assert got.shape == (M, DIM) and got.device.type == "cpu"
    got_inertia = float(kmeans.kmeans_inertia(got, torch.from_numpy(feats)))
    want_inertia = float(kmeans.kmeans_inertia(want, torch.from_numpy(feats)))
    assert abs(got_inertia - want_inertia) <= 0.05 * want_inertia


def test_missing_h5py_is_named(monkeypatch, tmp_path):
    import builtins

    real = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="needs h5py"):
        port_ei.append_h5(str(tmp_path / "x.h5"), np.zeros((2, 3), np.float32))


def test_cli_save_features_then_cluster_the_dump(tmp_path):
    root = tmp_path
    data = {"name": "synthetic", "num_classes": 5, "image_size": 8, "resize": 16,
            "train": {"num_samples": 8}}
    (root / "datasets").mkdir()
    _write(root / "datasets" / "synthetic.json", data)
    pth = save_reference(root / "ref.pth",
                         reference_state_dict(dim=32, layers=2, classes=1000, img=16, patch=4))
    ingredient = _write(root / "ingredient.json", {
        "dataset": "datasets/synthetic.json", "model": MODEL,
        "discretization": {"vocabulary": {"size": CODES, "dim": 32},
                           "encoder_layer": "module.transformer.layers.1"}})
    common = ["--cfg", ingredient, "--ckpt", pth, "--save-path", str(root / "codes"),
              "--batch-size", "4", "--max-features", "96", "--device", "cpu", "--seed", "3",
              "--log-dir", str(root / "log")]
    assert cli.main(["extract", "--save-features", *common]) == 0
    assert cli.main(["extract", "--save-features", *common]) == 0  # a new dump, not appended
    dump = root / "codes" / "saved_features.h5"
    layout, rows = _layout(dump)
    assert layout["shape"] == (96, 32) and layout["chunks"] == (4096, 32)
    assert layout["maxshape"] == (None, 32) and layout["dtype"] == np.float32

    from schemanet_torch.models.port import load_pretrain_into
    from schemanet_torch.models.vit import get_model
    from schemanet_torch.pipeline import collect_mid_features
    from schemanet_torch.schema.predictor import init_parameters_

    model = get_model(MODEL, 5)  # as the CLI loads it
    init_parameters_(model, torch.Generator().manual_seed(0))
    load_pretrain_into(model, pth)
    model.requires_grad_(False)
    loader = cli._stage_loader(cli.get_dataset(data, "train"), data, 4, 3)
    np.testing.assert_array_equal(rows, collect_mid_features(model, loader, 1, 96).numpy())

    assert cli.main(["extract", "--saved-features-fp", str(dump), *common]) == 0
    got = np.load(root / "codes" / f"cluster_{CODES}_from_h5.npy")
    want = port_ei.cluster_saved_features(str(dump), CODES, seed=3, device="cpu")
    np.testing.assert_array_equal(got, want.numpy())
    assert json.loads((root / "datasets" / "synthetic.json").read_text()) == data
