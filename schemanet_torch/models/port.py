"""JAX predictor variables -> the port's ``state_dict``.

``from_jax_params(params, buffers)`` takes the ``params`` and ``buffers`` trees
of a ``schemanet_tpu`` ``SchemaNetPredictor`` as nested dicts of numpy arrays
and returns a state dict for ``schemanet_torch.SchemaNetPredictor``:

* Dense ``kernel [in, out]`` -> ``weight [out, in]`` (the fused qkv column
  order ``(3, H, d)`` is unchanged);
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
* ``pos_embed`` keeps ``[1, n, d]``; the GNN ``embedding`` keeps its M+1 rows
  (the last is padding); atlas parameters and ``class_ingredients`` map as
  they are;
* module paths: ``backbone`` -> ``ingredient_backbone.backbone``,
  ``layers_{i}`` -> ``layers.{i}``.

Every leaf must be consumed; with ``model`` given, every parameter and buffer
of the port must be set, with its shape. Imports numpy and torch only.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_AS_IS = {
    "bias", "embedding", "vocabulary", "cls_token", "dist_token", "pos_embed",
    "vertex_weights", "edge_weights", "vertex_attribute_weights", "edge_attribute_weights",
    "class_ingredients",
}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _port_name(path: Tuple[str, ...]) -> str:
    parts = []
    for i, seg in enumerate(path):
        if i == 0 and seg == "backbone":
            parts += ["ingredient_backbone", "backbone"]
        elif seg.startswith("layers_") and seg[7:].isdigit():
            parts += ["layers", seg[7:]]
        else:
            parts.append(seg)
    return ".".join(parts)


def _convert_leaf(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    leaf = path[-1]
    if leaf == "kernel" and value.ndim == 2:
        return "weight", value.T
    if leaf == "kernel" and value.ndim == 4:
        return "weight", value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "scale":
        return "weight", value
    if leaf in _AS_IS:
        return leaf, value
    raise KeyError(f"unconsumed JAX leaf {'/'.join(path)} {value.shape}")


def from_jax_params(
    params: Mapping[str, Any],
    buffers: Mapping[str, Any],
    model: Optional[torch.nn.Module] = None,
) -> Dict[str, torch.Tensor]:
    """State dict of the port's predictor from the JAX predictor's variables."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in list(_flatten(params)) + list(_flatten(buffers)):
        leaf, converted = _convert_leaf(path, value)
        name = _port_name(path[:-1] + (leaf,))
        if name in state:
            raise KeyError(f"two JAX leaves map onto {name}")
        state[name] = torch.tensor(np.ascontiguousarray(converted))
    if model is not None:
        want = model.state_dict()
        unset = sorted(set(want) - set(state))
        extra = sorted(set(state) - set(want))
        if unset or extra:
            raise KeyError(f"port parameters unset: {unset}; JAX leaves without a port "
                           f"parameter: {extra}")
        for name, tensor in want.items():
            if tuple(tensor.shape) != tuple(state[name].shape):
                raise ValueError(f"{name}: port shape {tuple(tensor.shape)} vs converted "
                                 f"{tuple(state[name].shape)}")
            state[name] = state[name].to(tensor.dtype)
    return state
