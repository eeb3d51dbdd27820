"""JAX predictor variables <-> the port's ``state_dict``.

``from_jax_params(params, buffers)`` takes the ``params`` and ``buffers`` trees
of a ``schemanet_tpu`` ``SchemaNetPredictor`` as nested dicts of numpy arrays
and returns a state dict for ``schemanet_torch.SchemaNetPredictor``:

* Dense ``kernel [in, out]`` -> ``weight [out, in]`` (the fused qkv column
  order ``(3, H, d)`` is unchanged);
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* LayerNorm and BatchNorm ``scale``/``bias`` -> ``weight``/``bias``;
  BatchNorm's ``batch_stats`` ``mean``/``var`` (a ResNet's ``buffers``) ->
  its running buffers ``mean``/``var``;
* ``pos_embed`` keeps ``[1, n, d]``; the GNN ``embedding`` keeps its M+1 rows
  (the last is padding); atlas parameters and ``class_ingredients`` map as
  they are;
* module paths: ``backbone`` -> ``ingredient_backbone.backbone``,
  ``layers_{i}`` -> ``layers.{i}``.

Every leaf must be consumed; with ``model`` given, every parameter and buffer
of the port must be set, with its shape.

``to_jax_params(state)`` is the inverse: any mapping of the port's names to
tensors (parameters, or a tree of the same shape such as gradients or Adam
moments) back to the JAX nested-dict layout, as numpy arrays;
``to_jax_variables(state)`` splits a state dict into ``(params,
batch_stats)``. ``jax_name``
gives the JAX package's dotted name of a port parameter, which its
param-group regexes are written against.

Pretrained backbones (the JAX package's ``torch_vit_to_flax`` and
``merge_pretrained``): the reference loads renamed official DeiT weights
whose names follow its own module tree (``transformer.layers.N.attention.
linear_qkv.weight`` ..., ``utils/model.py:10-36``). The port's ViT/DeiT has
that tree, so ``reference_to_port`` maps names as they are and converts one
layout, ``pos_embed.pos_embed`` ``[n, 1, d]`` -> ``[1, n, d]``; Linear
weights stay ``[out, in]``, the conv ``OIHW``, the fused qkv in the
reference's ``(3, H, d)`` order. ``load_pretrain_into`` overlays a file onto a
model under the ``lax_names`` rule. Imports numpy and torch only.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# BatchNorm's running statistics: flax's batch_stats, the port's buffers
_STATS = ("mean", "var")
_AS_IS = {
    "bias", "embedding", "vocabulary", "cls_token", "dist_token", "pos_embed",
    "vertex_weights", "edge_weights", "vertex_attribute_weights", "edge_attribute_weights",
    "class_ingredients", *_STATS,
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


def to_jax_variables(state: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) of a port state dict: BatchNorm's running
    ``mean``/``var`` buffers form flax's ``batch_stats`` collection, the
    rest the ``params``."""
    stats = {k: v for k, v in state.items() if k.rsplit(".", 1)[-1] in _STATS}
    return (to_jax_params({k: v for k, v in state.items() if k not in stats}),
            to_jax_params(stats))


# -- pretrained reference checkpoints ---------------------------------------

_LAYER_KEYS = tuple(f"{sub}.{leaf}" for sub in (
    "attention.linear_qkv", "attention.linear_out", "mlp.linear1", "mlp.linear2", "norm1",
    "norm2") for leaf in ("weight", "bias"))
_TOP_KEYS = ("cls_token", "dist_token", "patch_embed.proj.weight", "patch_embed.proj.bias",
             "pos_embed.pos_embed", "transformer.norm.weight", "transformer.norm.bias",
             "cls_head.weight", "cls_head.bias", "dist_head.weight", "dist_head.bias")


def _unwrap_state_dict(ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    """Unwrap the ``model``/``student`` entries and strip ``module.``
    prefixes (the reference's ``utils/model.py:19-30``)."""
    for key in ("model", "student"):
        if key in ckpt and isinstance(ckpt[key], Mapping):
            ckpt = ckpt[key]
    return {k.removeprefix("module."): v for k, v in ckpt.items()}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a reference checkpoint file, unwrapped, on the CPU.
    Read with ``weights_only=True``: tensors, containers and plain values
    load, arbitrary pickled objects raise."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach() for k, v in _unwrap_state_dict(ckpt).items() if torch.is_tensor(v)}


def reference_to_port(state_dict: Mapping[str, torch.Tensor], num_layers: int = 12
                      ) -> Dict[str, torch.Tensor]:
    """The port's ViT/DeiT names and layouts of a reference-named state dict:
    layers ``0 .. num_layers - 1``; ``pos_embed`` ``[n, 1, d]`` -> ``[1, n,
    d]``, everything else as it is. Keys of the file that map onto nothing
    are logged as a warning."""
    sd = dict(state_dict)
    keys = list(_TOP_KEYS) + [f"transformer.layers.{i}.{k}" for i in range(num_layers)
                              for k in _LAYER_KEYS]
    out = {k: sd.pop(k) for k in keys if k in sd}
    if "pos_embed.pos_embed" in out:
        out["pos_embed.pos_embed"] = out["pos_embed.pos_embed"].permute(1, 0, 2).contiguous()
    leftover = [k for k in sd if not k.endswith("num_batches_tracked")]
    if leftover:
        logger.warning("unported torch parameters: %s", leftover)
    return out


def merge_pretrained(local: Mapping[str, torch.Tensor], ported: Mapping[str, torch.Tensor],
                     lax_names: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """``local`` (a state dict) with every entry ``ported`` has, cast to the
    local dtype. Where the shapes differ, an entry whose name starts with the
    module path of a ``lax_names`` entry (torch naming, e.g.
    ``cls_head.weight`` -> ``cls_head``) keeps the local value, as does every
    entry when ``lax_names`` is None, with a warning; any other raises (the
    reference's tolerance for a head of another class count,
    ``utils/model.py:24-33``)."""
    lax_prefixes = {n.rsplit(".", 1)[0] for n in (lax_names or [])}
    out = {}
    for name, value in local.items():
        if name not in ported:
            out[name] = value
            continue
        new = ported[name]
        if tuple(new.shape) != tuple(value.shape):
            if lax_names is None or any(name.startswith(p) for p in lax_prefixes):
                logger.warning("keeping local init for %s (ckpt %s vs local %s)", name,
                               tuple(new.shape), tuple(value.shape))
                out[name] = value
                continue
            raise ValueError(f"shape mismatch for {name}: {tuple(new.shape)} vs "
                             f"{tuple(value.shape)}")
        out[name] = new.to(value.dtype)
    return out


def load_pretrain_into(model: torch.nn.Module, path: str,
                       lax_names: Optional[Sequence[str]] = None,
                       num_layers: Optional[int] = None) -> torch.nn.Module:
    """Load the reference checkpoint ``path`` into the ViT/DeiT ``model`` in
    place, under the ``lax_names`` rule of ``merge_pretrained``; returns the
    model. ``num_layers`` defaults to the model's depth."""
    if num_layers is None:
        num_layers = model.transformer.num_encoder_layers
    ported = reference_to_port(load_torch_state_dict(path), num_layers)
    model.load_state_dict(merge_pretrained(model.state_dict(), ported, lax_names))
    return model
