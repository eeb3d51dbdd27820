"""JAX predictor variables <-> the port's ``state_dict``.

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
of the port must be set, with its shape.

``to_jax_params(state)`` is the inverse: any mapping of the port's names to
tensors (parameters, or a tree of the same shape such as gradients or Adam
moments) back to the JAX nested-dict layout, as numpy arrays. ``jax_name``
gives the JAX package's dotted name of a port parameter, which its
param-group regexes are written against. Imports numpy and torch only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

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


def _jax_path(name: str) -> List[str]:
    """Module path of a port name in the JAX tree, leaf name unconverted."""
    parts = name.split(".")
    if parts[:2] == ["ingredient_backbone", "backbone"]:
        parts = parts[1:]
    path = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            path.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    return path


def _jax_leaf_name(leaf: str, ndim: int) -> str:
    if leaf == "weight" and ndim in (2, 4):
        return "kernel"
    if leaf == "weight" and ndim == 1:
        return "scale"
    if leaf in _AS_IS:
        return leaf
    raise KeyError(f"port leaf {leaf} of rank {ndim} has no JAX counterpart")


def jax_name(name: str, ndim: int) -> str:
    """The JAX package's dotted name of the port parameter ``name`` of rank
    ``ndim`` (e.g. ``matcher.gnn.layers.0.g_conv.linear.weight`` ->
    ``matcher.gnn.layers_0.g_conv.linear.kernel``)."""
    path = _jax_path(name)
    return ".".join(path[:-1] + [_jax_leaf_name(path[-1], ndim)])


def to_jax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Nested dict in the JAX layout (numpy arrays) of a port state dict, or
    of any mapping of port parameter names to tensors of their shapes."""
    tree: Dict[str, Any] = {}
    for name, tensor in state.items():
        path = _jax_path(name)
        t = tensor.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bf16
            t = t.float()
        value = t.numpy()
        leaf = _jax_leaf_name(path[-1], value.ndim)
        if leaf == "kernel":  # [out, in] -> [in, out]; OIHW -> HWIO
            value = value.T if value.ndim == 2 else value.transpose(2, 3, 1, 0)
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        if leaf in node:
            raise KeyError(f"two port leaves map onto {'/'.join(path[:-1] + [leaf])}")
        node[leaf] = np.ascontiguousarray(value)
    return tree
