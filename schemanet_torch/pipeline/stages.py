"""Stages 1 and 3 as the JAX package's ``cmd_extract`` and ``cmd_init`` build
them (``schemanet_tpu/cli.py``), without the loaders, the CLI and the
checkpoint reading: the caller passes the parsed YAML blocks and any
re-iterable loader, and writes the results with ``pipeline.bundle``.

``extract_stage`` reads a ``configs/<dataset>/ingredient/*.yaml`` config:
its ``model`` block (the backbone, as a parsed dict), ``discretization``
(``vocabulary.size`` codes, ``encoder_layer``) and ``dataset``. The backbone
comes from ``backbone_state`` (a state dict, e.g. of the fine-tuned stage-0
model) or, when None, from seeded random weights: no pretrained file is in
the repository. ``init_stage`` reads a ``configs/<dataset>/schema_net/*.yaml``
config's ``schema_net.ir_atlas`` block and ``dataset``, and runs on a bundle.

Both run on CUDA unless the caller passes ``device="cpu"``. With a
``mesh`` (``parallel.mesh.make_mesh``) they run data-parallel over its data
group, on its device; the loader must give this rank's data slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from ..models.vit import get_model
from ..parallel.mesh import Mesh
from ..schema.atlas import AtlasConfig
from ..schema.predictor import IngredientBackbone, init_parameters_
from ..train.workers import num_classes_of, resolve_dtype
from .bundle import Bundle
from .extract_ingredients import extract_codebook
from .init_schema_net import init_atlas


def parse_encode_layer(encoder_layer_cfg) -> int:
    """``'module.transformer.layers.9'`` -> 9 (the ingredient YAML's
    ``encoder_layer``); an int stays as it is."""
    if isinstance(encoder_layer_cfg, int):
        return encoder_layer_cfg
    for token in reversed(str(encoder_layer_cfg).split(".")):
        if token.isdigit():
            return int(token)
    raise ValueError(f"cannot parse encode layer from {encoder_layer_cfg!r}")


def extract_stage(global_cfg: Dict[str, Any], loader, seed: int = 0, device=None,
                  backbone_state: Optional[Dict[str, torch.Tensor]] = None,
                  dtype: str = "float32", max_features: int = 1_000_000,
                  lloyd_iters: int = 10, lloyd_sample: int = 200_000,
                  mesh: Optional[Mesh] = None, quant: bool = False) -> Bundle:
    """Stage 1: the codebook of ``discretization.vocabulary.size`` codes from
    the features of layer ``discretization.encoder_layer``, with the CLI's
    defaults (fp32 backbone, 1,000,000 features, 10 Lloyd iterations over
    200,000); ``quant`` takes the features from the backbone's W8A8 route
    (the CLI's ``--quant-int8``). Returns the bundle that stage 3 and
    serving read."""
    dev = resolve_device(mesh.device if mesh is not None and device is None else device)
    disc = global_cfg["discretization"]
    model_cfg = global_cfg["model"]
    model = get_model(model_cfg, num_classes_of(global_cfg["dataset"]), dtype=resolve_dtype(dtype))
    if backbone_state is None:
        init_parameters_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(backbone_state)
    model.requires_grad_(False).to(dev)
    encode_layer = parse_encode_layer(disc["encoder_layer"])
    codebook = extract_codebook(model, loader, encode_layer, disc["vocabulary"]["size"],
                                max_features=max_features, seed=seed, lloyd_iters=lloyd_iters,
                                lloyd_sample=lloyd_sample, mesh=mesh, quant=quant)
    return Bundle(model_cfg=model_cfg, encode_layer=encode_layer,
                  img_size=int(model_cfg.get("patch_embed", {}).get("img_size", 224)),
                  backbone_state=model.state_dict(), codebook=codebook,
                  extra={"discretization": disc})


def _ingredient_backbone(bundle: Bundle, num_classes: int, device) -> IngredientBackbone:
    """The frozen fp32 backbone and codebook of a bundle, as stage 3 runs them
    (the head-mean attention kept fp32: the init passes build their graphs at
    ``graph_precision`` 'highest')."""
    model = get_model(bundle.model_cfg, num_classes)
    model.load_state_dict(bundle.backbone_state)
    m, d = bundle.codebook.shape
    ib = IngredientBackbone(model, m, d, bundle.encode_layer)
    with torch.no_grad():
        ib.vocabulary.copy_(bundle.codebook)
    return ib.requires_grad_(False).to(device)


def init_stage(global_cfg: Dict[str, Any], bundle: Bundle, loader, seed: int = 0,
               device=None, mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Stage 3: the initial IR-Atlas of ``schema_net.ir_atlas`` over the
    bundle's backbone and codebook, with ``init_accumulate_compat`` read as
    the CLI reads it (its random edge init drawn from a CPU generator seeded
    with ``seed``). Returns ``init_atlas``'s dict, which
    ``pipeline.bundle.save_atlas_init`` writes."""
    dev = resolve_device(mesh.device if mesh is not None and device is None else device)
    ir_cfg = global_cfg["schema_net"].get("ir_atlas", {})
    num_classes = num_classes_of(global_cfg["dataset"])
    atlas_cfg = AtlasConfig.from_cfg(bundle.codebook.shape[0], num_classes, ir_cfg)
    return init_atlas(
        _ingredient_backbone(bundle, num_classes, dev), loader, atlas_cfg,
        accumulate_compat=bool(ir_cfg.get("init_accumulate_compat", False)),
        generator=torch.Generator().manual_seed(seed), device=dev, mesh=mesh,
    )
