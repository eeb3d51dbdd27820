"""Image augmentations (port of ``schemanet_tpu/data/augment.py``) and the
device-side resize and normalisation.

Host side: numpy transforms over uint8 HWC images, one sample at a time,
each drawing from the sample's own ``np.random.Generator`` in the JAX
package's order (CIFAR train: ``random_crop((32, 32), padding=4)`` then
``random_horizontal_flip``). The transforms that need Pillow (a bicubic or
aspect-keeping ``resize``, ``random_rotation``, the ImageNet crops) import
it when they run, so importing this module never does. The image-folder
loader takes the crop-parameter form of each augmentation instead
(``CROP_PARAMS_REGISTRY``), whose windows the ``crop_resize`` kernel
resizes on the device: no Pillow there either.

Device side: the dataset's final ``resize`` (the JAX loader's
``final_resize``, done there on the host with PIL or ``native/imagepipe``)
and the normalisation (the JAX trainer's ``_prep_image``) run on the
device, in fp32, after the host-to-device copy (``resize_normalize``), so
a loader ships uint8 at the source size: 32^2 for CIFAR, 49x fewer bytes
than 224^2. The resize is PIL's bilinear filter (a triangle filter on
half-pixel centres, widened by the scale when shrinking, weights
renormalised over the taps inside the image), which
``F.interpolate(mode="bilinear", antialias=True)`` computes;
``resize_normalize_reference`` is its plain numpy version.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Transform = Callable[[np.ndarray, np.random.Generator], np.ndarray]

# standard ImageNet statistics; overridable per dataset yaml (mean/std keys)
DEFAULT_MEAN = (0.485, 0.456, 0.406)
DEFAULT_STD = (0.229, 0.224, 0.225)


def compose(*transforms: Optional[Transform]) -> Transform:
    """The transforms in order (None entries skipped)."""
    ts = [t for t in transforms if t is not None]

    def run(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        for t in ts:
            img = t(img, rng)
        return img

    return run


def random_crop(size: Tuple[int, int], padding: int = 0) -> Transform:
    def run(img, rng):
        if padding:
            img = np.pad(img, ((padding, padding), (padding, padding), (0, 0)), mode="constant")
        h, w = img.shape[:2]
        th, tw = size
        top = int(rng.integers(0, h - th + 1))
        left = int(rng.integers(0, w - tw + 1))
        return img[top : top + th, left : left + tw]

    return run


def random_horizontal_flip(p: float = 0.5) -> Transform:
    def run(img, rng):
        return img[:, ::-1] if rng.random() < p else img

    return run


def _pil_resize(img: np.ndarray, size: Tuple[int, int], mode: str = "bilinear") -> np.ndarray:
    """PIL's resize to (h, w); ``mode`` 'bilinear' or 'bicubic'."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(f"this transform resizes with Pillow ({mode}), which is not "
                          "installed; the loader's final resize runs on the device") from exc
    filt = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[mode]
    return np.asarray(Image.fromarray(img).resize((size[1], size[0]), filt))


def resize(size, mode: str = "bilinear", keep_aspect: bool = True) -> Transform:
    """int size: resize the short edge keeping aspect (torchvision semantics).
    Runs on the host with Pillow."""

    def run(img, rng):
        if isinstance(size, int) and keep_aspect:
            h, w = img.shape[:2]
            out = (size, max(1, round(w * size / h))) if h < w else (max(1, round(h * size / w)), size)
        else:
            out = (size, size) if isinstance(size, int) else tuple(size)
        return _pil_resize(img, out, mode)

    return run


def center_crop(size: Tuple[int, int]) -> Transform:
    def run(img, rng):
        h, w = img.shape[:2]
        th, tw = size
        if h < th or w < tw:
            img = _pil_resize(img, (max(h, th), max(w, tw)))
            h, w = img.shape[:2]
        top = (h - th) // 2
        left = (w - tw) // 2
        return img[top : top + th, left : left + tw]

    return run


def random_resized_crop(size: Tuple[int, int], scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)) -> Transform:
    """torchvision RandomResizedCrop sampling (10 tries then center fallback);
    resizes with Pillow."""

    def run(img, rng):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * rng.uniform(*scale)
            aspect = np.exp(rng.uniform(*np.log(ratio)))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = int(rng.integers(0, h - ch + 1))
                left = int(rng.integers(0, w - cw + 1))
                return _pil_resize(img[top : top + ch, left : left + cw], tuple(size))
        return center_crop(tuple(size))(_pil_resize(img, (max(h, size[0]), max(w, size[1]))), rng)

    return run


def random_rotation(degrees: Tuple[float, float]) -> Transform:
    """Rotation by a uniform angle, bilinear; with Pillow."""

    def run(img, rng):
        angle = rng.uniform(*degrees)
        try:
            from PIL import Image
        except ImportError as exc:
            raise ImportError("random_rotation rotates with Pillow, which is not installed") from exc
        return np.asarray(Image.fromarray(img).rotate(angle, resample=Image.BILINEAR))

    return run


# ---------------------------------------------------------------------------
# Per-dataset registry (the reference's data/aug.py:26-59)
# ---------------------------------------------------------------------------

_CIFAR_TRAIN = compose(random_crop((32, 32), padding=4), random_horizontal_flip())
_IMAGENET_TRAIN = compose(random_resized_crop((224, 224), scale=(0.6, 1.0)),
                          random_horizontal_flip())
_IMAGENET_VAL = compose(resize(256, "bicubic"), center_crop((224, 224)))
_MNIST_TRAIN = compose(random_rotation((-30, 30)))

_IMAGENET_LIKE = (
    ["imagenet", "caltech_101", "mini_imagenet", "cub_200", "stanford_cars", "imagenet_a",
     "imagenet_r"]
    + [f"imagenet={n}" for n in (10, 20, 50, 100)]
    + ["imagenet=10birds"]
)

AUG_REGISTRY: Dict[str, Optional[Transform]] = {
    "mnist_train": _MNIST_TRAIN,
    "mnist_val": None,
    "cifar_10_train": _CIFAR_TRAIN,
    "cifar_10_val": None,
    "cifar_100_train": _CIFAR_TRAIN,
    "cifar_100_val": None,
    "synthetic_train": None,
    "synthetic_val": None,
}
for _name in _IMAGENET_LIKE:
    AUG_REGISTRY[f"{_name}_train"] = _IMAGENET_TRAIN
    AUG_REGISTRY[f"{_name}_val"] = _IMAGENET_VAL


def get_augmentation(dataset_name: str, split: str) -> Optional[Transform]:
    return AUG_REGISTRY.get(f"{dataset_name}_{'train' if split == 'train' else 'val'}")


# ---------------------------------------------------------------------------
# Crop-parameter form of each augmentation (the JAX package's native route):
# one (top, left, crop_h, crop_w, flip) draw a sample, which the crop/flip/
# resize kernel (ops/kernels/imagepipe.py) turns into the output image.
#   cifar train:    RandomCrop(32, pad=4) + flip, then the resize: the
#                   window may pass the image's edges (zeros there).
#   imagenet train: RandomResizedCrop(scale .6-1) + flip: a box a sample.
#   imagenet val:   Resize(256 short edge) + CenterCrop(224): the center box
#                   of side short * 224 / 256, resized in one filter pass.
#   identity:       the whole image.
# Each draws from the sample's generator in the JAX package's order.
# ---------------------------------------------------------------------------


def _params_cifar_train(shape, rng):
    h, w = shape[:2]
    pad = 4
    top = int(rng.integers(0, 2 * pad + 1)) - pad
    left = int(rng.integers(0, 2 * pad + 1)) - pad
    return top, left, h, w, rng.random() < 0.5


def _params_rrc_train(shape, rng, scale=(0.6, 1.0), ratio=(3 / 4, 4 / 3)):
    h, w = shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(*np.log(ratio)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw, rng.random() < 0.5
    side = min(h, w)
    return (h - side) // 2, (w - side) // 2, side, side, rng.random() < 0.5


def _params_imagenet_val(shape, rng):
    h, w = shape[:2]
    short = min(h, w)
    crop = max(1, int(round(short * 224.0 / 256.0)))
    return (h - crop) // 2, (w - crop) // 2, crop, crop, False


def _params_identity(shape, rng):
    h, w = shape[:2]
    return 0, 0, h, w, False


# the crop size is a function of the source shape alone for these (the JAX
# package batches them in one C++ call); RandomResizedCrop draws a box a sample
_params_cifar_train.fixed_crop = True
_params_imagenet_val.fixed_crop = True
_params_identity.fixed_crop = True
_params_identity.identity = True  # no crop or flip
_params_rrc_train.fixed_crop = False

CROP_PARAMS_REGISTRY: Dict[str, Callable] = {
    "cifar_10_train": _params_cifar_train,
    "cifar_100_train": _params_cifar_train,
    "cifar_10_val": _params_identity,
    "cifar_100_val": _params_identity,
    "synthetic_train": _params_identity,
    "synthetic_val": _params_identity,
}
for _name in _IMAGENET_LIKE:
    CROP_PARAMS_REGISTRY[f"{_name}_train"] = _params_rrc_train
    CROP_PARAMS_REGISTRY[f"{_name}_val"] = _params_imagenet_val


def get_crop_params_fn(dataset_name: str, split: str) -> Optional[Callable]:
    """The crop-parameter function of a dataset's split (the JAX package's
    ``get_native_params_fn``), or None."""
    return CROP_PARAMS_REGISTRY.get(f"{dataset_name}_{'train' if split == 'train' else 'val'}")


def normalize_batch(images: np.ndarray, mean: Sequence[float] = DEFAULT_MEAN,
                    std: Sequence[float] = DEFAULT_STD) -> np.ndarray:
    """uint8 [..., 3] -> float32 (x / 255 - mean) / std, on the host."""
    x = images.astype(np.float32) / 255.0
    x -= np.asarray(mean, np.float32)
    x /= np.asarray(std, np.float32)
    return x


# ---------------------------------------------------------------------------
# Device side: the final resize and the normalisation
# ---------------------------------------------------------------------------


def resize_normalize(images: torch.Tensor, size: Optional[int], mean: Sequence[float],
                     std: Sequence[float]) -> torch.Tensor:
    """uint8 NHWC images [bs, h, w, 3] on any device -> fp32 NHWC
    ``(resize(x) / 255 - mean) / std`` at ``size`` x ``size`` (no resize when
    ``size`` is None or the images are that size already). The result is a
    channels-last view of an NCHW tensor, which the patch embedding reads
    back as NCHW without a copy."""
    x = images.permute(0, 3, 1, 2).float()
    if size and tuple(x.shape[-2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=True)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)[:, None, None]
    s = torch.tensor(std, dtype=torch.float32, device=x.device)[:, None, None]
    return ((x / 255.0 - m) / s).permute(0, 2, 3, 1)


def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] fp64 weights of PIL's bilinear resize along one axis."""
    scale = in_size / out_size
    support = max(scale, 1.0)
    centers = (np.arange(out_size) + 0.5) * scale
    taps = np.arange(in_size) + 0.5
    w = np.maximum(0.0, 1.0 - np.abs(taps[None, :] - centers[:, None]) / support)
    return w / w.sum(axis=1, keepdims=True)


def resize_normalize_reference(images: np.ndarray, size: Optional[int], mean: Sequence[float],
                               std: Sequence[float]) -> np.ndarray:
    """The plain version of ``resize_normalize``: numpy, fp64 weights and
    sums, fp32 out."""
    x = images.astype(np.float64)
    h, w = x.shape[1:3]
    if size and (h, w) != (size, size):
        x = np.einsum("oh,bhwc->bowc", _bilinear_weights(h, size), x)
        x = np.einsum("pw,bowc->bopc", _bilinear_weights(w, size), x)
    return ((x / 255.0 - np.asarray(mean)) / np.asarray(std)).astype(np.float32)
