"""The port's data path (``schemanet_torch/data``) against the JAX package's
loader, on the CPU.

Datasets: ``synthetic`` (32^2, 5 classes) and a CIFAR-100 root of fake
python-pickle batches (as ``tests/test_data.py`` writes one), both resized
to 48^2, in the train split (shuffled, CIFAR's random crop with padding 4
and flip, ``drop_last``) and the val split (in order, the last batch
padded), over two epochs.

* Order, labels and ``valid``: exactly the JAX loader's (same permutation
  ``default_rng((seed, epoch))``, same per-sample seeds, same padding).
* Images after the resize and the normalisation, against both routes of the
  JAX loader here. The port resizes on the device with PIL's bilinear
  filter, unrounded, in fp32.
  - The PIL route (forced by making ``native.available`` return False for
    the test): within one uint8 step of normalised value,
    ``1 / (255 * min(std))``, plus 1e-5 for the fp32 arithmetic. PIL rounds
    its horizontal pass and its output to uint8, which puts its result
    within one step of the exact filter.
  - The native route (``native/imagepipe``, where it is built; the JAX
    loader's float output, ``device_normalize=False``): within 1e-5 on the
    pixels whose filter taps lie inside the crop window. At the window's
    edge (1 pixel at 32 -> 48) the native filter does not clamp to the
    window as PIL does: it weighs a virtual zero row above and below and
    the image's own neighbouring columns left and right, so the border
    differs by design of that route and is reported, not compared.
"""

import pickle

import numpy as np
import pytest
import torch

from schemanet_torch.data import DataLoader, device_prefetch, get_dataset
from schemanet_torch.data.augment import (DEFAULT_MEAN, DEFAULT_STD, resize_normalize,
                                          resize_normalize_reference)
from schemanet_tpu.data import native
from schemanet_tpu.data.datasets import get_dataset as jax_get_dataset
from schemanet_tpu.data.loader import DataLoader as JaxDataLoader

BATCH, RESIZE, EPOCHS = 8, 48, 2
STEP = 1.0 / (255.0 * min(DEFAULT_STD))  # one uint8 step after normalisation


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    rng = np.random.default_rng(0)
    c100 = root / "cifar-100-python"
    c100.mkdir()
    for split, n in (("train", 40), ("test", 21)):
        data = rng.integers(0, 256, size=(n, 3072), dtype=np.uint8)
        with open(c100 / split, "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": list(rng.integers(0, 100, n))}, f)
    return str(root)


def _data_cfg(name, cifar_root):
    if name == "synthetic":
        return {"name": "synthetic", "num_classes": 5, "num_samples": 21, "image_size": 32,
                "resize": RESIZE}
    return {"name": "cifar_100", "root": cifar_root, "resize": RESIZE}


def _loaders(name, split, cifar_root, **jax_kw):
    cfg = _data_cfg(name, cifar_root)
    train = split == "train"
    kw = dict(batch_size=BATCH, split=split, shuffle=train, drop_last=train, seed=3,
              resize=RESIZE, num_workers=2)
    port = DataLoader(get_dataset(cfg, split), **kw)
    jax = JaxDataLoader(jax_get_dataset(cfg, split), **kw, **jax_kw)
    return port, jax


def _epochs(port, jax):
    for epoch in range(EPOCHS):
        port.set_epoch(epoch)
        jax.set_epoch(epoch)
        yield epoch, list(port), list(jax)


CASES = [(name, split) for name in ("synthetic", "cifar_100") for split in ("train", "val")]


def _prepared(batch):
    return resize_normalize(torch.from_numpy(batch["image"]), RESIZE, DEFAULT_MEAN,
                            DEFAULT_STD).numpy()


@pytest.mark.parametrize("name,split", CASES)
def test_order_labels_valid_match_jax(name, split, cifar_root):
    port, jax = _loaders(name, split, cifar_root)
    for epoch, got, want in _epochs(port, jax):
        np.testing.assert_array_equal(port._indices(), jax._indices())
        assert len(got) == len(want) == len(port) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["label"], w["label"])
            np.testing.assert_array_equal(g["valid"], w["valid"])
            assert g["image"].dtype == np.uint8 and g["image"].shape == (BATCH, 32, 32, 3)
    if split == "val":  # the last batch padded: 21 = 2 x 8 + 5
        assert got[-1]["valid"].sum() == 21 % BATCH


@pytest.mark.parametrize("name,split", CASES)
def test_images_match_jax_pil_route(name, split, cifar_root, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    port, jax = _loaders(name, split, cifar_root)
    assert jax._native_params is None  # the JAX loader's PIL route
    for _, got, want in _epochs(port, jax):
        for g, w in zip(got, want):
            assert w["image"].shape == (BATCH, RESIZE, RESIZE, 3)
            err = np.abs(_prepared(g) - w["image"]).max()
            assert err <= STEP + 1e-5, (err, STEP)


def _interior(in_size, out_size):
    """Output rows whose bilinear taps lie inside [0, in_size)."""
    center = (np.arange(out_size) + 0.5) * in_size / out_size
    return (center >= 0.5) & (center <= in_size - 0.5)


@pytest.mark.parametrize("name,split", CASES)
def test_images_match_jax_native_route(name, split, cifar_root):
    if not native.available():
        pytest.skip("native/libimagepipe.so is not built")
    port, jax = _loaders(name, split, cifar_root, device_normalize=False)
    assert jax._native_params is not None  # the JAX loader's native route
    inner = np.ix_(_interior(32, RESIZE), _interior(32, RESIZE))
    for _, got, want in _epochs(port, jax):
        for g, w in zip(got, want):
            diff = np.abs(_prepared(g) - w["image"])
            assert diff[:, inner[0], inner[1]].max() <= 1e-5
            assert diff.max() > 1e-5  # the native route's border, reported in the docstring


@pytest.mark.parametrize("size", [224, 48, 32, 20])
def test_resize_normalize_matches_reference(size):
    images = np.random.default_rng(1).integers(0, 256, size=(3, 32, 32, 3), dtype=np.uint8)
    got = resize_normalize(torch.from_numpy(images), size, DEFAULT_MEAN, DEFAULT_STD)
    want = resize_normalize_reference(images, size, DEFAULT_MEAN, DEFAULT_STD)
    assert got.shape == (3, size, size, 3) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_device_prefetch_on_cpu():
    """The batches as tensors, in order; the producer's exception reaches the
    consumer; a consumer that stops early leaves no producer running."""
    batches = [{"image": np.full((2, 4, 4, 3), i, np.uint8), "label": np.arange(2) + i}
               for i in range(5)]
    got = list(device_prefetch(iter(batches), "cpu"))
    assert [int(b["label"][0]) for b in got] == list(range(5))
    assert all(torch.equal(b["image"], torch.from_numpy(w["image"])) for b, w in zip(got, batches))

    def failing():
        yield batches[0]
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(device_prefetch(failing(), "cpu"))
    stream = device_prefetch(iter(batches * 100), "cpu", buffer_size=1)
    next(stream)
    stream.close()
    import threading

    assert not any(t.name == "device_prefetch" and t.is_alive() for t in threading.enumerate())
