"""Data: in-memory and image-folder datasets, the JPEG decode (libjpeg on
the host or nvJPEG on the card), the numpy augmentations and their
crop-parameter form, the loader with its host-to-device prefetch, and the
device-side crop/resize and normalisation. Importing it imports neither
Pillow nor any JAX module."""

from .augment import AUG_REGISTRY, get_augmentation, normalize_batch, resize_normalize
from .datasets import DATASET_REGISTRY, get_dataset, make_partial
from .loader import (DataLoader, build_adv_loader, build_eval_loader, build_loaders,
                     device_prefetch, prepare_images)

__all__ = [
    "AUG_REGISTRY",
    "DATASET_REGISTRY",
    "DataLoader",
    "build_adv_loader",
    "build_eval_loader",
    "build_loaders",
    "device_prefetch",
    "get_augmentation",
    "get_dataset",
    "make_partial",
    "normalize_batch",
    "prepare_images",
    "resize_normalize",
]
