"""In-memory datasets (port of ``schemanet_tpu/data/datasets.py``, the part
the port's loader path reads).

A dataset yields ``(uint8 HWC image, int label)`` pairs and exposes
``num_classes``/``classes``. Registered names follow the JAX package:
``cifar_10``, ``cifar_100`` (the python pickle batches), ``mnist`` (IDX
files) and ``synthetic`` (class-separable images made from a seed, for
tests and benchmarks: no dataset file is in the repository). The
image-folder datasets (ImageNet and its subsets, Caltech-101, CUB-200,
Stanford Cars, mini-ImageNet, the robustness sets) and the native JPEG
decode are not ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.registry import Registry

DATASET_REGISTRY: Registry = Registry("datasets")


class ArrayDataset:
    """In-memory uint8 dataset."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, classes: List[str], name: str):
        self.images = images
        self.labels = labels.astype(np.int64)
        self.classes = classes
        self.name = name

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        return self.images[idx], int(self.labels[idx])


class SubsetDataset:
    def __init__(self, base, indices: Sequence[int]):
        self.base = base
        self.indices = list(indices)
        self.classes = base.classes
        self.name = base.name

    @property
    def num_classes(self) -> int:
        return self.base.num_classes

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.base[self.indices[idx]]


def make_partial(dataset, fraction: Optional[float], seed: int = 0):
    """Random fraction subsample (init_schema_net.py --make_partial)."""
    if not fraction or fraction >= 1.0:
        return dataset
    rng = np.random.default_rng(seed)
    n = max(1, int(len(dataset) * fraction))
    idx = rng.permutation(len(dataset))[:n]
    return SubsetDataset(dataset, idx)


def _load_cifar_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = d.get(b"labels", d.get(b"fine_labels"))
    return np.ascontiguousarray(data), np.asarray(labels)


@DATASET_REGISTRY.register("cifar_10")
def build_cifar10(root: str, split: str = "train", **kwargs) -> ArrayDataset:
    base = os.path.join(os.path.expanduser(root), "cifar-10-batches-py")
    if split == "train":
        parts = [_load_cifar_file(os.path.join(base, f"data_batch_{i}")) for i in range(1, 6)]
        images = np.concatenate([p[0] for p in parts])
        labels = np.concatenate([p[1] for p in parts])
    else:
        images, labels = _load_cifar_file(os.path.join(base, "test_batch"))
    classes = [str(i) for i in range(10)]
    return ArrayDataset(images, labels, classes, "cifar_10")


@DATASET_REGISTRY.register("cifar_100")
def build_cifar100(root: str, split: str = "train", **kwargs) -> ArrayDataset:
    base = os.path.join(os.path.expanduser(root), "cifar-100-python")
    fn = "train" if split == "train" else "test"
    images, labels = _load_cifar_file(os.path.join(base, fn))
    classes = [str(i) for i in range(100)]
    return ArrayDataset(images, labels, classes, "cifar_100")


@DATASET_REGISTRY.register("mnist")
def build_mnist(root: str, split: str = "train", **kwargs) -> ArrayDataset:
    """MNIST from the standard IDX files (gz or raw); images replicated to 3
    channels to fit the RGB pipeline (the reference registers mnist augs at
    data/aug.py:33-34; its loader lives in cv_lib)."""
    import gzip

    base = os.path.expanduser(root)
    prefix = "train" if split == "train" else "t10k"

    def read(name):
        for candidate, opener in (
            (os.path.join(base, name), open),
            (os.path.join(base, name + ".gz"), gzip.open),
            (os.path.join(base, "MNIST", "raw", name), open),
            (os.path.join(base, "MNIST", "raw", name + ".gz"), gzip.open),
        ):
            if os.path.isfile(candidate):
                with opener(candidate, "rb") as f:
                    return f.read()
        raise FileNotFoundError(f"{name} under {base}")

    img_raw = read(f"{prefix}-images-idx3-ubyte")
    lab_raw = read(f"{prefix}-labels-idx1-ubyte")
    n = int.from_bytes(img_raw[4:8], "big")
    h = int.from_bytes(img_raw[8:12], "big")
    w = int.from_bytes(img_raw[12:16], "big")
    images = np.frombuffer(img_raw, np.uint8, offset=16).reshape(n, h, w, 1)
    images = np.repeat(images, 3, axis=-1)
    labels = np.frombuffer(lab_raw, np.uint8, offset=8).astype(np.int64)
    return ArrayDataset(images, labels, [str(i) for i in range(10)], "mnist")


@DATASET_REGISTRY.register("synthetic")
def build_synthetic(
    root: str = "",
    split: str = "train",
    num_classes: int = 10,
    num_samples: int = 512,
    image_size: int = 32,
    seed: int = 0,
    **kwargs,
) -> ArrayDataset:
    """Deterministic class-separable images: class-seeded low-frequency pattern
    + noise. Good enough for the loss to move and for throughput benchmarks."""
    rng = np.random.default_rng(seed + (1 if split != "train" else 0))
    labels = rng.integers(0, num_classes, size=(num_samples,))
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / image_size
    images = np.empty((num_samples, image_size, image_size, 3), np.uint8)
    for i, lab in enumerate(labels):
        phase = 2 * np.pi * (lab + 1) / num_classes
        base = 0.5 + 0.4 * np.sin(2 * np.pi * (lab + 2) * xx + phase) * np.cos(
            2 * np.pi * (lab + 1) * yy
        )
        noise = rng.normal(scale=0.1, size=(image_size, image_size, 3))
        img = np.clip(base[..., None] + noise, 0, 1)
        images[i] = (img * 255).astype(np.uint8)
    classes = [str(i) for i in range(num_classes)]
    return ArrayDataset(images, labels, classes, "synthetic")


def get_dataset(data_cfg: Dict[str, Any], split: str):
    """Build from a dataset yaml block (name/root/train/val/resize...)."""
    name = data_cfg["name"]
    split_cfg = data_cfg.get(split, {}) or {}
    kwargs = {
        k: v
        for k, v in data_cfg.items()
        if k not in ("name", "root", "train", "val", "resize", "make_partial", "mean", "std")
    }
    kwargs.update(split_cfg)
    kwargs.pop("split", None)
    ds = DATASET_REGISTRY.get(name)(root=data_cfg.get("root", ""), split=split, **kwargs)
    return make_partial(ds, data_cfg.get("make_partial"))
