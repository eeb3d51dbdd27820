"""Worker setups (port of ``schemanet_tpu/train/workers.py``), without the
loaders: the data pipeline is not ported yet, so a worker here returns its
``Trainer`` and the caller feeds it batches.

``backbone_trainer`` is ``backbone_worker``'s model, optimizer, loss and
trainer: stage 0, fine-tuning the ViT/DeiT backbone with the YAML's
``training`` block (AdamW, schedule, ``clip_max_norm``, ``dtype``) and loss.
The model starts from seeded random weights (``init_parameters_``): loading
the pretrained DeiT weights that the YAML names (``model.pre_train``) needs
a file the repository does not hold.
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict

import torch

from ..models.vit import get_model
from ..schema.loss import get_loss_fn
from ..schema.predictor import init_parameters_
from .trainer import Trainer, TrainerConfig

# classes of the datasets whose class count does not depend on the files on disk
_NUM_CLASSES = {"cifar_10": 10, "cifar_100": 100, "mini_imagenet": 100, "imagenet": 1000}
_DTYPES = {None: torch.float32, "float32": torch.float32, "fp32": torch.float32,
           "f32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def resolve_dtype(name) -> torch.dtype:
    """The ``training.dtype`` YAML key -> compute dtype (parameters stay fp32)."""
    if name not in _DTYPES:
        raise KeyError(f"unknown dtype {name!r}")
    return _DTYPES[name]


def _num_classes(dataset_cfg) -> int:
    """Class count of a ``dataset`` block: an inline dict (with ``num_classes``
    or a ``name``) or the path of a dataset YAML named after the dataset."""
    if isinstance(dataset_cfg, dict):
        if "num_classes" in dataset_cfg:
            return int(dataset_cfg["num_classes"])
        name = dataset_cfg.get("name")
    else:
        name = pathlib.Path(str(dataset_cfg)).stem
    if name not in _NUM_CLASSES:
        raise KeyError(f"dataset {name!r}: give its num_classes in the dataset block "
                       f"(known: {sorted(_NUM_CLASSES)})")
    return _NUM_CLASSES[name]


def backbone_trainer(global_cfg: Dict[str, Any], steps_per_epoch: int, seed: int = 0,
                     device=None) -> Trainer:
    """Stage 0's trainer from a ``configs/<dataset>/vanilla/*.yaml`` config
    (parsed into a dict): the model of ``model`` in ``training.dtype`` with
    weights from ``seed`` and a head for the ``dataset``'s classes, the
    ``loss`` block, and the ``training`` block's optimizer, schedule and
    clipping. ``device`` defaults to CUDA."""
    model_cfg, train_cfg, loss_cfg = global_cfg["model"], global_cfg["training"], global_cfg["loss"]
    num_classes = _num_classes(global_cfg["dataset"])
    model = get_model(model_cfg, num_classes, dtype=resolve_dtype(train_cfg.get("dtype")))
    init_parameters_(model, torch.Generator().manual_seed(seed))
    return Trainer(TrainerConfig.from_cfg(train_cfg), model, get_loss_fn(loss_cfg),
                   loss_cfg["weight_dict"], steps_per_epoch, seed=seed, device=device)
