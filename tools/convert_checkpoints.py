#!/usr/bin/env python
"""Convert files between the JAX package (``schemanet_tpu``) and the
PyTorch port (``schemanet_torch``), both ways. Runs where JAX, flax and
orbax are installed (it reads and writes their formats through the JAX
package's own readers and writers); no module of either package imports it.

    # the stage-2 bundle: backbone_params.msgpack <-> backbone_params.pt
    python tools/convert_checkpoints.py bundle --to torch JAX_BUNDLE OUT_DIR
    python tools/convert_checkpoints.py bundle --to jax TORCH_BUNDLE OUT_DIR
    # the IR-Atlas init (msgpack <-> the port's torch.save file)
    python tools/convert_checkpoints.py atlas --to torch init.msgpack init.pt
    python tools/convert_checkpoints.py atlas --to jax init.pt init.msgpack
    # an Orbax checkpoint directory (a tag of the JAX CheckpointManager)
    python tools/convert_checkpoints.py orbax --to torch CKPT/iter-100 iter-100.pt \
        --cfg configs/cifar_100/schema_net/deit_tiny-l9-M_1024.yaml --bundle BUNDLE
    python tools/convert_checkpoints.py orbax --to jax iter-100.pt CKPT/iter-100 \
        --drop-optimizer

Names and layouts map through ``schemanet_torch/models/port.py``
(``from_jax_params``, ``to_jax_params``): Dense kernels ``[in, out]`` <->
weights ``[out, in]``, convolutions HWIO <-> OIHW, ``layers_N`` <->
``layers.N``. An Orbax checkpoint's parameters, running statistics
(``buffers``) and step convert both ways. Its optimizer state converts from
JAX to the port for AdamW (``optax.adamw`` and the JAX package's
``adamw_lowmem``: mu and nu, full or factored, into the port's AdamW, its
low-memory groups and its hot atlas tensors), given the port's trainer for
the same config (``--cfg``, and ``--bundle`` for a SchemaNet config), so
that the port resumes a JAX run. Any other optimizer state raises, and so
does the port's optimizer state on the way to JAX, unless the caller passes
``--model-only`` / ``--drop-optimizer``, which write the checkpoint without
it: nothing is dropped silently.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from schemanet_torch.models.port import from_jax_params, jax_name, to_jax_params  # noqa: E402
from schemanet_torch.pipeline import bundle as torch_bundle  # noqa: E402

# the port's state entries that are buffers (flax's ``buffers``/``batch_stats``)
_BUFFER_LEAVES = ("class_ingredients", "mean", "var")


# -- the bundle ---------------------------------------------------------------

def bundle_to_torch(src: str, dst: str) -> None:
    """A JAX bundle directory into the port's: ``backbone_params.pt`` (the
    same tree, flat), ``codebook.npy`` copied, the manifest's ``format``."""
    from schemanet_tpu.pipeline.bundle import load_bundle

    b = load_bundle(src)
    state = from_jax_params(_np_tree(b.backbone_params), {})
    torch_bundle.save_bundle(dst, b.model_cfg, b.encode_layer, state,
                             torch.from_numpy(np.array(b.codebook, np.float32)), b.extra)


def bundle_to_jax(src: str, dst: str) -> None:
    """The port's bundle directory into a JAX one (``backbone_params.msgpack``,
    format ``schemanet-tpu-bundle-v1``)."""
    from schemanet_tpu.pipeline.bundle import save_bundle

    b = torch_bundle.load_bundle(src)
    save_bundle(dst, b.model_cfg, b.encode_layer, to_jax_params(b.backbone_state),
                b.codebook.numpy(), b.extra)


# -- the atlas init -----------------------------------------------------------

def atlas_to_torch(src: str, dst: str) -> None:
    from schemanet_tpu.pipeline.bundle import load_atlas_init

    blob = load_atlas_init(src)
    torch_bundle.save_atlas_init(
        dst, {k: torch.from_numpy(np.array(v)) for k, v in blob["params"].items()},
        torch.from_numpy(np.array(blob["class_ingredients"])))


def atlas_to_jax(src: str, dst: str) -> None:
    from schemanet_tpu.pipeline.bundle import save_atlas_init

    blob = torch_bundle.load_atlas_init(src)
    save_atlas_init(dst, {k: v.numpy() for k, v in blob["params"].items()},
                    blob["class_ingredients"].numpy())


# -- Orbax checkpoints ---------------------------------------------------------

def _np_tree(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def restore_orbax(path: str) -> Dict[str, Any]:
    """The whole tree of a JAX checkpoint directory as numpy arrays (the JAX
    ``CheckpointManager.restore`` without a template)."""
    from schemanet_tpu.train.common import CheckpointManager

    path = os.path.abspath(path)
    return CheckpointManager(os.path.dirname(path), max_keep=None).restore(path)


def _adamw_states(opt_state: Any) -> Dict[str, Dict[str, Any]]:
    """{label: {"mu": tree, "nu": tree}} of a JAX ``make_optimizer`` state
    (optax's ``multi_transform``, after ``clip_by_global_norm`` when the
    config clips) as a template-free restore gives it. Raises on a group
    whose state is not AdamW's."""
    node = opt_state
    if isinstance(node, (list, tuple)):  # chain(clip, multi_transform)
        node = next(s for s in node if isinstance(s, Mapping) and "inner_states" in s)
    out = {}
    for label, masked in node["inner_states"].items():
        inner = masked["inner_state"] if isinstance(masked, Mapping) else masked
        if label == "frozen" or inner is None:
            continue
        first = inner[0] if isinstance(inner, (list, tuple)) and inner else inner
        if not (isinstance(first, Mapping) and {"mu", "nu"} <= set(first)):
            raise NotImplementedError(
                f"optimizer state of group {label!r} is not AdamW's (its keys: "
                f"{sorted(first) if isinstance(first, Mapping) else type(first).__name__}); "
                "only AdamW moments convert")
        out[label] = {"mu": first["mu"], "nu": first["nu"]}
    return out


def _leaf(tree: Any, path) -> Any:
    for key in path:
        if not isinstance(tree, Mapping) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _port_layout(value: np.ndarray, jax_leaf: str) -> torch.Tensor:
    if jax_leaf == "kernel" and value.ndim == 2:
        value = value.T
    elif jax_leaf == "kernel" and value.ndim == 4:
        value = value.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(value))


def _moments_of(name: str, p: torch.Tensor, trees: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``m`` and ``v`` (or factored ``row``/``col``) of parameter
    ``name`` from the JAX mu and nu trees."""
    path = jax_name(name, p.ndim).split(".")
    mu, nu = _leaf(trees["mu"], path), _leaf(trees["nu"], path)
    if mu is None or nu is None:
        raise KeyError(f"no AdamW moments for {'/'.join(path)}")
    out = {"m": _port_layout(np.asarray(mu), path[-1])}
    if isinstance(nu, Mapping) and "full" in nu:
        nu = nu["full"]
    if isinstance(nu, Mapping):  # adamw_lowmem's factored nu
        if path[-1] == "kernel":
            raise NotImplementedError(f"factored nu of the Dense kernel {name} is not converted")
        out.update(row=torch.from_numpy(np.asarray(nu["row"])),
                   col=torch.from_numpy(np.asarray(nu["col"])))
    else:
        out["v"] = _port_layout(np.asarray(nu), path[-1])
    return out


def _copy_state(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], name: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"{name}: the port keeps {sorted(dst)}, the checkpoint {sorted(src)}")
    for key, t in dst.items():
        if tuple(t.shape) != tuple(src[key].shape):
            raise ValueError(f"{name}.{key}: port shape {tuple(t.shape)} vs "
                             f"{tuple(src[key].shape)}")
        t.copy_(src[key].to(t.dtype))


def load_orbax_into(trainer, restored: Mapping[str, Any]) -> None:
    """A template-free restore of a JAX training checkpoint (``params``,
    ``buffers``, ``opt_state``, ``step``) onto the port's ``trainer`` of the
    same config: the model's parameters and buffers, the step, and every
    AdamW moment into the torch AdamW groups, the low-memory groups and the
    hot atlas tensors. The hot atlas tensors are projected afterwards, as
    the port's trainer keeps them (the JAX trainer projects them before its
    next step)."""
    from schemanet_torch.schema.atlas import project_atlas_params

    model = trainer.model
    state = from_jax_params(_np_tree(restored["params"]), _np_tree(restored.get("buffers", {})),
                            model)
    trees = _adamw_states(restored["opt_state"])
    opt = trainer.optimizer
    torch_opt = opt.optimizer
    plain = ({id(p): (hp, st) for (hp, ps), sts in zip(opt.lowmem.groups, opt.lowmem.state)
              for p, st in zip(ps, sts)} if opt.lowmem is not None else {})
    hot = {id(h.param): h for h in trainer.hot.values()}
    adamw = ({id(q) for g in torch_opt.param_groups for q in g["params"]}
             if torch_opt is not None else set())
    step = int(np.asarray(restored["step"]))
    with torch.no_grad():
        model.load_state_dict(state)
        for name, p in model.named_parameters():
            label = trainer.labels[name]
            if label == "frozen":
                continue
            moments = _moments_of(name, p, trees[label])
            if id(p) in hot:
                _copy_state(hot[id(p)].state, moments, name)
            elif id(p) in plain:
                hp, st = plain[id(p)]
                if hp.kind != "adamw":
                    raise NotImplementedError(f"{name}: the port's {hp.kind} state is not "
                                              "converted from AdamW moments")
                _copy_state(st, moments, name)
            else:
                if id(p) not in adamw:
                    raise ValueError(f"{name}: no optimizer state in the port")
                torch_opt.state[p] = {"step": torch.tensor(float(step)),
                                      "exp_avg": moments["m"].to(p.dtype).clone(),
                                      "exp_avg_sq": moments["v"].to(p.dtype).clone()}
        if trainer.atlas is not None:
            project_atlas_params(trainer.atlas)
    trainer.step = step


def orbax_to_torch(src: str, dst: str, trainer=None, model_only: bool = False) -> None:
    """A JAX checkpoint directory into a port checkpoint file: with a
    ``trainer`` of the same config, the trainer's whole state after
    ``load_orbax_into`` (the port resumes from it); else, with
    ``model_only``, the model's state and the step alone."""
    restored = restore_orbax(src)
    if trainer is not None:
        load_orbax_into(trainer, restored)
        out = trainer.state_dict()
    else:
        if restored.get("opt_state") is not None and not model_only:
            raise ValueError("the checkpoint holds an optimizer state: give the port's trainer "
                             "(--cfg) to convert it, or --model-only to leave it out")
        out = {"model": from_jax_params(_np_tree(restored["params"]),
                                        _np_tree(restored.get("buffers", {}))),
               "step": int(np.asarray(restored["step"]))}
    os.makedirs(os.path.dirname(os.path.abspath(dst)) or ".", exist_ok=True)
    torch.save(out, dst)


def torch_to_orbax(src: str, dst: str, drop_optimizer: bool = False) -> None:
    """A port checkpoint file (or a bare model state dict) into a JAX
    checkpoint directory: ``params``, ``buffers`` and ``step``. The port's
    optimizer state does not convert: it raises unless ``drop_optimizer``."""
    import orbax.checkpoint as ocp

    blob = torch.load(src, map_location="cpu", weights_only=False)
    model = blob.get("model", blob)
    if blob.get("optimizer") and not drop_optimizer:
        raise ValueError("the port's optimizer state does not convert to optax's: pass "
                         "--drop-optimizer to write parameters, buffers and step alone")
    is_buffer = [k for k in model if k.rsplit(".", 1)[-1] in _BUFFER_LEAVES]
    tree = {
        "params": to_jax_params({k: v for k, v in model.items() if k not in is_buffer}),
        "buffers": to_jax_params({k: model[k] for k in is_buffer}),
        "step": np.asarray(int(blob.get("step", 0)), np.int32),
    }
    dst = os.path.abspath(dst)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(dst, tree)
    ckptr.wait_until_finished()


def trainer_for(cfg_path: str, bundle_path: Optional[str] = None, seed: int = 0):
    """The port's trainer of a config on the CPU, as its worker builds it
    (``schema_net_trainer`` with ``bundle_path``, else ``backbone_trainer``):
    a template whose layout a JAX checkpoint fills."""
    from schemanet_torch.train.workers import backbone_trainer, schema_net_trainer
    from schemanet_torch.utils.config import get_cfg, resolve_subconfig

    cfg = get_cfg(cfg_path)
    cfg = dict(cfg, dataset=resolve_subconfig(cfg["dataset"], os.path.dirname(cfg_path)))
    if bundle_path:
        return schema_net_trainer(cfg, torch_bundle.load_bundle(bundle_path), None, 1, seed,
                                  device="cpu")
    return backbone_trainer(cfg, 1, seed, device="cpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("kind", choices=("bundle", "atlas", "orbax"))
    p.add_argument("--to", choices=("torch", "jax"), required=True)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--cfg", help="orbax --to torch: the run's config, for the port's trainer")
    p.add_argument("--bundle", help="orbax --to torch: the port's bundle of a SchemaNet config")
    p.add_argument("--model-only", action="store_true",
                   help="orbax --to torch without --cfg: write the model and step alone")
    p.add_argument("--drop-optimizer", action="store_true",
                   help="orbax --to jax: write parameters, buffers and step alone")
    args = p.parse_args(argv)
    if args.kind == "bundle":
        (bundle_to_torch if args.to == "torch" else bundle_to_jax)(args.src, args.dst)
    elif args.kind == "atlas":
        (atlas_to_torch if args.to == "torch" else atlas_to_jax)(args.src, args.dst)
    elif args.to == "torch":
        trainer = trainer_for(args.cfg, args.bundle) if args.cfg else None
        orbax_to_torch(args.src, args.dst, trainer, args.model_only)
    else:
        torch_to_orbax(args.src, args.dst, args.drop_optimizer)
    print(json.dumps({"converted": args.kind, "to": args.to, "dst": args.dst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
