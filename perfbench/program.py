"""The system under test, built from a configuration file and the seeded
weights: the port's predictor, its stage-4 ``Trainer`` as
``schema_net_trainer`` builds it, its ``ServePredictor`` and its stage-3
``init_stage``. The only file of the harness besides the entries that
imports the port."""

from __future__ import annotations

import copy
from typing import Dict

import torch

from perfbench.reference import model as ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def schema_cfg(cfg: dict) -> dict:
    """The ``schema_net`` block with graph tensors at ``graph_precision``
    'default' unless the file pins it, as the stage-4 worker trains and
    serves."""
    out = copy.deepcopy(cfg["schema_net"])
    out.setdefault("ir_atlas", {}).setdefault("graph_precision", "default")
    return out


def predictor(cfg: dict, state: Dict[str, torch.Tensor], dtype: str, device):
    """The port's SchemaNet predictor in ``dtype``, built on ``device`` and
    loaded with ``state``."""
    from schemanet_torch.schema import build_predictor

    with torch.device(device):
        model = build_predictor(cfg["model"], schema_cfg(cfg), cfg["num_classes"],
                                cfg["num_codes"], cfg["model"]["transformer"]["embed_dim"],
                                cfg["encode_layer"], dtype=DTYPES[dtype])
    model.load_state_dict(state)
    return model


def trainer(cfg: dict, state: Dict[str, torch.Tensor], device, seed: int):
    """Stage 4's trainer over ``predictor``, with the arguments
    ``schema_net_trainer`` gives ``Trainer``: the training block with the
    frozen backbone, the loss block, the dataset's steps an epoch."""
    from schemanet_torch.schema import get_loss_fn
    from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig

    tr, loss = cfg["training"], cfg["loss"]
    model = predictor(cfg, state, tr["dtype"], device)
    steps = cfg["train_images"] // tr["batch_size"]
    return Trainer(TrainerConfig.from_cfg(tr, frozen_patterns=SCHEMA_NET_FROZEN), model,
                   get_loss_fn(loss), loss["weight_dict"], steps, seed=seed % 2**63,
                   device=device, name="schema_net_trainer")


def server(cfg: dict, state: Dict[str, torch.Tensor], device, microbatch: int):
    from schemanet_torch.serve import ServePredictor

    model = predictor(cfg, state, cfg["serve_dtype"], device)
    return ServePredictor(model, microbatch=microbatch, device=device)


def bundle(cfg: dict, state: Dict[str, torch.Tensor]):
    """Stage 1's output as stage 3 reads it: the backbone and the codebook."""
    from schemanet_torch.pipeline.bundle import Bundle

    vit = {k[len(ref.VIT):]: v for k, v in state.items() if k.startswith(ref.VIT)}
    return Bundle(model_cfg=cfg["model"], encode_layer=cfg["encode_layer"],
                  img_size=cfg["model"]["patch_embed"]["img_size"], backbone_state=vit,
                  codebook=state[ref.CODEBOOK], extra={})


def init_stage(cfg: dict, bundle_, loader, seed: int, device):
    from schemanet_torch.pipeline.stages import init_stage as run

    global_cfg = {"schema_net": cfg["schema_net"],
                  "dataset": {"name": cfg["dataset"], "num_classes": cfg["num_classes"]}}
    return run(global_cfg, bundle_, loader, seed=seed % 2**63, device=device)
