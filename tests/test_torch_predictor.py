"""The port's predictor in training: the frozen backbone, on the CPU."""

import torch

from schemanet_torch.schema import build_predictor

MODEL_CFG = {
    "name": "vit",
    "transformer": dict(embed_dim=32, num_encoder_layers=3, num_heads=2, dim_feedforward=64,
                        dropout=None, activation="gelu", final_norm=True, norm_eps=1e-6),
    "patch_embed": dict(img_size=16, patch_size=4, image_channels=3),
    "pos_encoding": dict(name="learnable"),
}
SCHEMA_CFG = {"gnn": {"embed_dim": 16, "num_layers": 2},
              "ir_atlas": dict(feat_h=4, feat_w=4, clamp_edge_attn=-1.0,
                               prune_node_threshold=0.001)}


def test_frozen_backbone_runs_without_autograd():
    """The backbone runs under no_grad and its parameters need no gradient,
    as the JAX package's stop_gradient: its output carries no graph, and
    backward reaches only the atlas and the GNN."""
    model = build_predictor(MODEL_CFG, SCHEMA_CFG, num_classes=5, num_codes=16, code_dim=32,
                            encode_layer=1)
    seen = {}

    def hook(module, args, output):
        seen["grad_enabled"] = torch.is_grad_enabled()
        seen["requires_grad"] = output["mid_feat"].requires_grad

    model.ingredient_backbone.register_forward_hook(hook)
    out = model(torch.randn(2, 16, 16, 3))
    assert seen == {"grad_enabled": False, "requires_grad": False}
    assert not any(p.requires_grad for p in model.ingredient_backbone.parameters())
    out["pred"].sum().backward()
    with_grad = {n.split(".")[0] for n, p in model.named_parameters() if p.grad is not None}
    assert with_grad == {"schema_net", "matcher"}
    assert not model.matcher.per_sample_pooling  # training pools by the batch max
