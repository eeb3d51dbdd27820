"""The frozen-backbone bundle and the IR-Atlas init, torch-native (the port's
counterpart of ``schemanet_tpu/pipeline/bundle.py``).

A bundle is one directory, with the JAX bundle's layout:

* ``manifest.json``: ``model_cfg``, ``encode_layer``, ``img_size``, ``extra``
  and ``format`` (``schemanet-torch-bundle-v1`` here, where the JAX package
  writes ``schemanet-tpu-bundle-v1``);
* ``codebook.npy``: the [M, d] float32 k-means centers;
* ``backbone_params.pt`` (the JAX bundle's ``backbone_params.msgpack``): the
  backbone as a flat dict of CPU tensors under the JAX tree's names, joined
  by ``/`` and in its layouts (``transformer/layers_0/norm1/scale``, Dense
  kernels ``[in, out]``); ``models/port.py`` maps them onto the port's
  module.

The atlas init (``save_atlas_init``) is one ``torch.save`` file of the same
kind: ``params/<name>`` for the four atlas tensors and
``class_ingredients`` (int32). Reading the JAX package's msgpack files needs
flax, which the machine with the card does not have: that converter is not
part of the port yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..models.port import from_jax_params, to_jax_params

FORMAT = "schemanet-torch-bundle-v1"
_BACKBONE_FILE = "backbone_params.pt"


@dataclasses.dataclass
class Bundle:
    model_cfg: Dict[str, Any]
    encode_layer: int
    img_size: int
    backbone_state: Dict[str, torch.Tensor]  # the port's state-dict names (a bare ViT/DeiT)
    codebook: torch.Tensor  # [M, d] float32
    extra: Dict[str, Any]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def _unflatten(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, value in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = value.numpy()
    return tree


def save_bundle(path: str, model_cfg: Dict[str, Any], encode_layer: int,
                backbone_state: Mapping[str, torch.Tensor], codebook: torch.Tensor,
                extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the bundle directory: the backbone's state dict (a bare
    ViT/DeiT's names) and the [M, d] codebook."""
    os.makedirs(path, exist_ok=True)
    manifest = {
        "model_cfg": model_cfg,
        "encode_layer": int(encode_layer),
        "img_size": int(model_cfg.get("patch_embed", {}).get("img_size", 224)),
        "extra": extra or {},
        "format": FORMAT,
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=float)
    torch.save(_flatten(to_jax_params(backbone_state)), os.path.join(path, _BACKBONE_FILE))
    np.save(os.path.join(path, "codebook.npy"),
            codebook.detach().float().cpu().numpy().astype(np.float32))


def load_bundle(path: str) -> Bundle:
    path = os.path.expanduser(path)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: bundle format {manifest.get('format')!r} is not {FORMAT!r}; "
                         "JAX bundles need a converter")
    flat = torch.load(os.path.join(path, _BACKBONE_FILE), map_location="cpu", weights_only=True)
    return Bundle(
        model_cfg=manifest["model_cfg"],
        encode_layer=manifest["encode_layer"],
        img_size=manifest["img_size"],
        backbone_state=from_jax_params(_unflatten(flat), {}),
        codebook=torch.from_numpy(np.load(os.path.join(path, "codebook.npy"))),
        extra=manifest.get("extra", {}),
    )


def save_atlas_init(path: str, atlas_params: Mapping[str, torch.Tensor],
                    class_ingredients: torch.Tensor) -> None:
    """The initial IR-Atlas (the reference's ``init_IR_atlas-*.pth``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    blob = {f"params/{k}": v.detach().cpu().contiguous() for k, v in atlas_params.items()}
    blob["class_ingredients"] = class_ingredients.detach().cpu().to(torch.int32).contiguous()
    torch.save(blob, path)


def load_atlas_init(path: str) -> Dict[str, Any]:
    """``{"params": {name: tensor}, "class_ingredients": int32 tensor}``."""
    blob = torch.load(os.path.expanduser(path), map_location="cpu", weights_only=True)
    params = {k.split("/", 1)[1]: v for k, v in blob.items() if k.startswith("params/")}
    return {"params": params, "class_ingredients": blob["class_ingredients"]}
