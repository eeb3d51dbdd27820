"""The port's entry points run on CUDA unless the caller passes
``device="cpu"``; without a GPU the default raises, and nothing carries on
on the CPU unasked."""

import pytest
import torch

from schemanet_torch import ServePredictor
from schemanet_torch.schema import build_predictor, get_loss_fn, init_parameters_
from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig, backbone_trainer

MODEL_CFG = {
    "name": "vit",
    "transformer": dict(embed_dim=32, num_encoder_layers=2, num_heads=2, dim_feedforward=64,
                        activation="gelu", norm_eps=1e-6, dropout=0.1),
    "patch_embed": dict(img_size=16, patch_size=4, image_channels=3),
}
SCHEMA_CFG = {"gnn": {"embed_dim": 16, "num_layers": 2},
              "ir_atlas": {"feat_h": 4, "feat_w": 4, "clamp_edge_attn": -1.0,
                           "prune_node_threshold": 0.001}}
STAGE0 = {"dataset": {"name": "cifar_10"}, "model": MODEL_CFG, "loss": {"name": "ce_loss",
          "weight_dict": {"cls": 1.0}}, "training": {"train_epochs": 1, "optimizer": {"lr": 1e-4}}}


def test_default_device_is_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_predictor(MODEL_CFG, SCHEMA_CFG, num_classes=5, num_codes=16, code_dim=32,
                            encode_layer=1)
    init_parameters_(model, torch.Generator().manual_seed(0))
    cfg = TrainerConfig(train_epochs=1, optimizer={"lr": 1e-3}, frozen_patterns=SCHEMA_NET_FROZEN)
    loss = get_loss_fn({"name": "schema_inference_loss"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServePredictor(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, model, loss, {"cls": 1.0}, steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backbone_trainer(STAGE0, steps_per_epoch=1)
    assert ServePredictor(model, device="cpu").device == torch.device("cpu")
    trainer = Trainer(cfg, model, loss, {"cls": 1.0}, steps_per_epoch=1, device="cpu")
    assert trainer.device == torch.device("cpu")
    assert backbone_trainer(STAGE0, steps_per_epoch=1, device="cpu").model.cls_head.out_features == 10
