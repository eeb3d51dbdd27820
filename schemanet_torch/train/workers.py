"""Worker setups (port of ``schemanet_tpu/train/workers.py``), without the
loaders: the data pipeline is not ported yet, so a worker here returns its
``Trainer`` and the caller feeds it batches.

``backbone_trainer`` is ``backbone_worker``'s model, optimizer, loss and
trainer: stage 0, fine-tuning the ViT/DeiT backbone with the YAML's
``training`` block (AdamW, schedule, ``clip_max_norm``, ``dtype``) and loss.
The model starts from seeded random weights (``init_parameters_``): loading
the pretrained DeiT weights that the YAML names (``model.pre_train``) needs
a file the repository does not hold.

``schema_net_trainer`` is ``schema_net_worker``'s: stage 4, the SchemaNet
predictor built from a stage-1 bundle and started from a stage-3 atlas init
(``pipeline.bundle``), the GNN from seeded random weights.
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict

import torch

from ..models.vit import get_model
from ..schema.loss import get_loss_fn
from ..schema.predictor import build_predictor, init_parameters_
from .trainer import SCHEMA_NET_FROZEN, Trainer, TrainerConfig

# classes of the datasets whose class count does not depend on the files on disk
_NUM_CLASSES = {"cifar_10": 10, "cifar_100": 100, "mini_imagenet": 100, "imagenet": 1000}
_DTYPES = {None: torch.float32, "float32": torch.float32, "fp32": torch.float32,
           "f32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def resolve_dtype(name) -> torch.dtype:
    """The ``training.dtype`` YAML key -> compute dtype (parameters stay fp32)."""
    if name not in _DTYPES:
        raise KeyError(f"unknown dtype {name!r}")
    return _DTYPES[name]


def num_classes_of(dataset_cfg) -> int:
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
    num_classes = num_classes_of(global_cfg["dataset"])
    model = get_model(model_cfg, num_classes, dtype=resolve_dtype(train_cfg.get("dtype")))
    init_parameters_(model, torch.Generator().manual_seed(seed))
    return Trainer(TrainerConfig.from_cfg(train_cfg), model, get_loss_fn(loss_cfg),
                   loss_cfg["weight_dict"], steps_per_epoch, seed=seed, device=device)


def schema_net_trainer(global_cfg: Dict[str, Any], bundle, atlas_init: Dict[str, Any],
                       steps_per_epoch: int, seed: int = 0, device=None) -> Trainer:
    """Stage 4's trainer from a ``configs/<dataset>/schema_net/*.yaml`` config
    (parsed into a dict), a bundle (``pipeline.bundle.Bundle``) and an atlas
    init (``pipeline.bundle.load_atlas_init``'s dict): the predictor in
    ``training.dtype`` with graph tensors at ``graph_precision`` 'default'
    unless the YAML pins it, the bundle's backbone and codebook, the atlas
    init's parameters and ``class_ingredients``, the GNN from ``seed``; the
    ``training`` block's optimizer groups and schedule with the frozen
    backbone; the ``loss`` block. ``device`` defaults to CUDA."""
    train_cfg, loss_cfg = global_cfg["training"], global_cfg["loss"]
    schema_cfg = dict(global_cfg["schema_net"])
    ir_cfg = dict(schema_cfg.get("ir_atlas") or {})
    ir_cfg.setdefault("graph_precision", "default")
    schema_cfg["ir_atlas"] = ir_cfg
    m, d = bundle.codebook.shape
    model = build_predictor(bundle.model_cfg, schema_cfg, num_classes_of(global_cfg["dataset"]),
                            m, d, bundle.encode_layer,
                            dtype=resolve_dtype(train_cfg.get("dtype")))
    init_parameters_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.ingredient_backbone.backbone.load_state_dict(bundle.backbone_state)
        model.ingredient_backbone.vocabulary.copy_(bundle.codebook)
        for name, value in atlas_init["params"].items():
            getattr(model.schema_net, name).copy_(value)
        model.schema_net.class_ingredients.copy_(atlas_init["class_ingredients"])
    return Trainer(TrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN), model,
                   get_loss_fn(loss_cfg), loss_cfg["weight_dict"], steps_per_epoch, seed=seed,
                   device=device)
