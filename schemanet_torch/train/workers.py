"""Worker entry points (port of ``schemanet_tpu/train/workers.py``; the
reference's ``dist_engine.py:39-43`` registry): ``backbone_worker``,
``schema_net_worker`` and ``eval_worker``, each built from the same YAML
config families as the JAX package (a parsed dict; its ``dataset`` block
inline or the path of a dataset YAML).

``backbone_worker`` (stage 0) and ``schema_net_worker`` (stage 4) build the
loaders (``data/loader.py`` ``build_loaders``; the class count comes from
the dataset), the model, the loss and a ``Trainer`` with validation,
TensorBoard (``<log_dir>/tb``) and checkpoints (``<log_dir>/ckpt``), resume
as ``LaunchArgs.resume`` asks, and train for the YAML's epochs.
``eval_worker`` evaluates a checkpoint: top-1/top-5 and loss
(``Evaluation``) and, for a SchemaNet predictor, the codebook agreement
(``CBEvaluation``).

Weights: a backbone starts from seeded random weights
(``init_parameters_``), then from the pretrained reference checkpoint that
the YAML names (``model.pre_train``, a reference-named ``.pth``) under its
``lax_names`` rule (``models/port.py`` ``load_pretrain_into``) where that
file exists; a run whose file is absent trains from scratch with a warning,
as the JAX worker does. A SchemaNet
predictor reads the port's own bundle and atlas-init files
(``pipeline/bundle.py``).

``backbone_trainer`` and ``schema_net_trainer`` are the two training
workers' trainers without loaders, which callers that feed batches by hand
use.

Several GPUs: ``LaunchArgs.mesh_data`` and ``mesh_model`` give the grid, as
the JAX ``LaunchArgs`` do. A grid of more than one rank, or a process that
has joined ``torch.distributed`` (a rank the command line or ``torchrun``
spawned), runs on ``parallel.mesh.make_mesh``'s grid: each rank's loaders
give its data slice and the trainer or evaluator runs on the grid.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pathlib
from typing import Any, Dict, Optional

import torch

from ..data.loader import build_eval_loader, build_loaders
from ..device import resolve_device
from ..models.port import load_pretrain_into
from ..models.vit import get_model
from ..ops.policy import configure
from ..parallel.mesh import Mesh, make_mesh, shard_module
from ..schema.loss import get_loss_fn
from ..schema.predictor import build_predictor, init_parameters_
from ..utils.config import resolve_subconfig
from ..utils.registry import Registry
from .common import merge_restored, restore_model_state
from .evaluator import CBEvaluation, Evaluation
from .trainer import SCHEMA_NET_FROZEN, Trainer, TrainerConfig

WORKER_REGISTRY: Registry = Registry("workers")
logger = logging.getLogger(__name__)

# classes of the datasets whose class count does not depend on the files on disk
_NUM_CLASSES = {"cifar_10": 10, "cifar_100": 100, "mini_imagenet": 100, "imagenet": 1000}
_DTYPES = {None: torch.float32, "float32": torch.float32, "fp32": torch.float32,
           "f32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


@dataclasses.dataclass
class LaunchArgs:
    """What the JAX ``LaunchArgs`` carries that one process needs, and the
    device (CUDA unless "cpu")."""

    seed: int = 42
    debug: bool = False
    log_dir: str = "run"
    resume: str = ""
    base_dir: Optional[str] = None  # for resolving config path references
    device: Optional[str] = None
    mesh_data: Optional[int] = None  # None: every rank that mesh_model leaves
    mesh_model: int = 1


def worker_mesh(args: LaunchArgs) -> Optional[Mesh]:
    """The grid a worker runs on: None for one process outside
    ``torch.distributed`` with a grid of one, else ``make_mesh``'s."""
    one = (args.mesh_data or 1) * args.mesh_model == 1
    if one and not torch.distributed.is_initialized():
        return None
    return make_mesh(data=args.mesh_data, model=args.mesh_model, device=args.device)


def _slice_kw(mesh: Optional[Mesh]) -> Dict[str, int]:
    """The loader arguments of a rank's data slice."""
    return {} if mesh is None else {"process_index": mesh.data_index, "process_count": mesh.data}


def _device(args: LaunchArgs, mesh: Optional[Mesh]):
    return mesh.device if mesh is not None else args.device


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


def _split_cfg(global_cfg: Dict[str, Any], args: LaunchArgs):
    # kernels: the kernel policy (ops/policy.py), resolved before any model
    # is built, where the JAX workers call it
    configure(global_cfg.get("kernels"))
    data_cfg = resolve_subconfig(global_cfg["dataset"], args.base_dir)
    train_cfg = dict(global_cfg.get("training", {}))
    val_cfg = dict(global_cfg.get("validation", {}))
    if args.debug:  # dist_engine --debug semantics (worker.py:292-296)
        train_cfg.update(num_workers=0, print_interval=1, val_interval=10)
        val_cfg.update(num_workers=0)
    return data_cfg, train_cfg, val_cfg


def model_cfg_of(global_cfg, base_dir: Optional[str] = None) -> Dict[str, Any]:
    """The ``model`` block, inline or from the file it names (whose payload
    sits under ``model:``)."""
    model_cfg = global_cfg["model"]
    if isinstance(model_cfg, str):
        model_cfg = resolve_subconfig(model_cfg, base_dir).get("model", model_cfg)
    return model_cfg


def _backbone_model(global_cfg, num_classes: int, dtype, seed: int):
    model_cfg = model_cfg_of(global_cfg)
    model = get_model(model_cfg, num_classes, dtype=dtype)
    init_parameters_(model, torch.Generator().manual_seed(seed))
    pretrain = model_cfg.get("pre_train")
    if pretrain and os.path.isfile(os.path.expanduser(pretrain)):
        load_pretrain_into(model, os.path.expanduser(pretrain), model_cfg.get("lax_names"))
        logger.info("loaded pretrain weights from %s", pretrain)
    elif pretrain:
        logger.warning("pretrain file %s not found; training from scratch", pretrain)
    return model


def _schema_cfg(global_cfg) -> Dict[str, Any]:
    """The ``schema_net`` block with graph tensors at ``graph_precision``
    'default' unless the YAML pins it, as the JAX worker trains."""
    schema_cfg = dict(global_cfg["schema_net"])
    ir_cfg = dict(schema_cfg.get("ir_atlas") or {})
    ir_cfg.setdefault("graph_precision", "default")
    schema_cfg["ir_atlas"] = ir_cfg
    return schema_cfg


def _schema_predictor(schema_cfg, bundle, num_classes: int, dtype, seed: int):
    """The predictor over the bundle's backbone and codebook, the rest from
    ``seed``."""
    m, d = bundle.codebook.shape
    model = build_predictor(bundle.model_cfg, schema_cfg, num_classes, m, d, bundle.encode_layer,
                            dtype=dtype)
    init_parameters_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.ingredient_backbone.backbone.load_state_dict(bundle.backbone_state)
        model.ingredient_backbone.vocabulary.copy_(bundle.codebook)
    return model


def backbone_trainer(global_cfg: Dict[str, Any], steps_per_epoch: Optional[int], seed: int = 0,
                     device=None, num_classes: Optional[int] = None, **trainer_kw) -> Trainer:
    """Stage 0's trainer from a ``configs/<dataset>/vanilla/*.yaml`` config
    (parsed into a dict): the model of ``model`` in ``training.dtype`` with
    weights from ``seed`` and a head for ``num_classes`` (default: the
    ``dataset``'s), the ``loss`` block, and the ``training`` block's
    optimizer, schedule and clipping. ``trainer_kw`` go to ``Trainer``
    (loaders, directories, resume). ``device`` defaults to CUDA."""
    train_cfg, loss_cfg = global_cfg["training"], global_cfg["loss"]
    if num_classes is None:
        num_classes = num_classes_of(global_cfg["dataset"])
    model = _backbone_model(global_cfg, num_classes, resolve_dtype(train_cfg.get("dtype")), seed)
    return Trainer(TrainerConfig.from_cfg(train_cfg), model, get_loss_fn(loss_cfg),
                   loss_cfg["weight_dict"], steps_per_epoch, seed=seed, device=device,
                   name="backbone_trainer", **trainer_kw)


def schema_net_trainer(global_cfg: Dict[str, Any], bundle, atlas_init: Optional[Dict[str, Any]],
                       steps_per_epoch: Optional[int], seed: int = 0, device=None,
                       num_classes: Optional[int] = None, **trainer_kw) -> Trainer:
    """Stage 4's trainer from a ``configs/<dataset>/schema_net/*.yaml`` config
    (parsed into a dict), a bundle (``pipeline.bundle.Bundle``) and an atlas
    init (``pipeline.bundle.load_atlas_init``'s dict, or None for the seeded
    random atlas): the predictor in ``training.dtype`` with graph tensors at
    ``graph_precision`` 'default' unless the YAML pins it, the bundle's
    backbone and codebook, the atlas init's parameters and
    ``class_ingredients``, the GNN from ``seed``; the ``training`` block's
    optimizer groups and schedule with the frozen backbone; the ``loss``
    block. ``trainer_kw`` go to ``Trainer``. ``device`` defaults to CUDA."""
    train_cfg, loss_cfg = global_cfg["training"], global_cfg["loss"]
    if num_classes is None:
        num_classes = num_classes_of(global_cfg["dataset"])
    model = _schema_predictor(_schema_cfg(global_cfg), bundle, num_classes,
                              resolve_dtype(train_cfg.get("dtype")), seed)
    if atlas_init is not None:
        with torch.no_grad():
            for name, value in atlas_init["params"].items():
                getattr(model.schema_net, name).copy_(value)
            model.schema_net.class_ingredients.copy_(atlas_init["class_ingredients"])
    return Trainer(TrainerConfig.from_cfg(train_cfg, frozen_patterns=SCHEMA_NET_FROZEN), model,
                   get_loss_fn(loss_cfg), loss_cfg["weight_dict"], steps_per_epoch, seed=seed,
                   device=device, name="schema_net_trainer", **trainer_kw)


def _run_dirs(args: LaunchArgs) -> Dict[str, Any]:
    return {"log_dir": os.path.join(args.log_dir, "tb"),
            "ckpt_dir": os.path.join(args.log_dir, "ckpt"), "resume": args.resume}


@WORKER_REGISTRY.register("backbone_worker")
def backbone_worker(global_cfg: Dict[str, Any], args: LaunchArgs) -> Dict[str, Any]:
    """Fine-tune the ViT/DeiT backbone (reference ``tasks/worker.py``):
    ``{"trainer", "eval" (the final validation), "model"}``."""
    data_cfg, train_cfg, val_cfg = _split_cfg(global_cfg, args)
    mesh = worker_mesh(args)
    train_loader, val_loader, n_classes = build_loaders(data_cfg, train_cfg, val_cfg, args.seed,
                                                        **_slice_kw(mesh))
    global_cfg = dict(global_cfg, training=train_cfg, model=model_cfg_of(global_cfg, args.base_dir))
    trainer = backbone_trainer(global_cfg, None, seed=args.seed, device=_device(args, mesh),
                               num_classes=n_classes, train_loader=train_loader,
                               val_loader=val_loader, mesh=mesh, **_run_dirs(args))
    result = trainer()
    return {"trainer": trainer, "eval": result, "model": trainer.model}


@WORKER_REGISTRY.register("schema_net_worker")
def schema_net_worker(global_cfg: Dict[str, Any], args: LaunchArgs) -> Dict[str, Any]:
    """Train the SchemaNet predictor over the frozen backbone of
    ``schema_net.bundle``, from the atlas init of
    ``schema_net.initial_state_fp`` where that file exists (reference
    ``tasks/worker_schema_net.py``): ``{"trainer", "eval", "predictor"}``.
    A resumed checkpoint whose ``class_ingredients`` differ from the atlas
    init's is refused."""
    data_cfg, train_cfg, val_cfg = _split_cfg(global_cfg, args)
    if args.debug:
        train_cfg.update(batch_size=1)
        val_cfg.update(batch_size=1)
    mesh = worker_mesh(args)
    train_loader, val_loader, n_classes = build_loaders(data_cfg, train_cfg, val_cfg, args.seed,
                                                        **_slice_kw(mesh))
    # pipeline.stages imports this module: its bundle module is read here
    from ..pipeline.bundle import load_atlas_init, load_bundle

    schema_cfg = global_cfg["schema_net"]
    bundle = load_bundle(schema_cfg["bundle"])
    atlas_init, init_fp = None, schema_cfg.get("initial_state_fp")
    if init_fp and os.path.exists(os.path.expanduser(init_fp)):
        atlas_init = load_atlas_init(init_fp)
        logger.info("loaded initial IR-Atlas from %s", init_fp)

    def buffer_guard(state):
        if atlas_init is not None and not torch.equal(
                state["schema_net.class_ingredients"].cpu(), atlas_init["class_ingredients"]):
            raise ValueError("resumed class_ingredients buffer differs from the atlas init "
                             f"({init_fp}) this run was built with; refusing to continue")

    def attr_scalars(model):
        v = model.schema_net.vertex_attribute_weights.detach().cpu()
        e = model.schema_net.edge_attribute_weights.detach().cpu()
        return {"v_geo": float(v[0, 0]), "v_attn": float(v[1, 0]),
                "e_geo": float(e[0, 0]), "e_attn": float(e[1, 0])}

    trainer = schema_net_trainer(dict(global_cfg, training=train_cfg), bundle, atlas_init, None,
                                 seed=args.seed, device=_device(args, mesh),
                                 num_classes=n_classes, train_loader=train_loader,
                                 val_loader=val_loader, buffer_guard=buffer_guard,
                                 extra_scalars=attr_scalars, mesh=mesh, **_run_dirs(args))
    result = trainer()
    return {"trainer": trainer, "eval": result, "predictor": trainer.model}


def _restore_model(model: torch.nn.Module, path: str) -> None:
    """A checkpoint's model state onto ``model``, laxly (``merge_restored``)."""
    merged = merge_restored(dict(model.state_dict()), restore_model_state(path))
    model.load_state_dict(merged)


def _assemble_schema_predictor(global_cfg: Dict[str, Any], args: LaunchArgs, n_classes: int):
    """The predictor of ``schema_net.bundle`` in the validation (else the
    training) dtype, its atlas and GNN from the checkpoint ``args.resume``."""
    from ..pipeline.bundle import load_bundle

    dtype = resolve_dtype((global_cfg.get("validation") or {}).get("dtype")
                          or (global_cfg.get("training") or {}).get("dtype"))
    predictor = _schema_predictor(dict(global_cfg["schema_net"]), load_bundle(
        global_cfg["schema_net"]["bundle"]), n_classes, dtype, 0)
    if args.resume:
        _restore_model(predictor, args.resume)
    return predictor


@WORKER_REGISTRY.register("eval_worker")
def eval_worker(global_cfg: Dict[str, Any], args: LaunchArgs) -> Dict[str, Any]:
    """Evaluate the checkpoint ``args.resume`` (reference
    ``tasks/worker_eval.py``): ``{"loss", "loss_dict", "acc": {1, 5}}`` of
    the validation split, and for a SchemaNet predictor (a config with a
    ``schema_net`` block) ``"cb"``, the codebook agreement. A plain model
    is built in the validation block's dtype (fp32 when it names none). On a
    grid the model is sharded by its rules and each rank evaluates its data
    slice."""
    data_cfg, _, val_cfg = _split_cfg(global_cfg, args)
    loss_cfg = global_cfg.get("loss", {"name": "ce_loss", "weight_dict": {"cls": 1.0}})
    mesh = worker_mesh(args)
    val_loader, n_classes = build_eval_loader(data_cfg, val_cfg, args.seed, **_slice_kw(mesh))
    device = resolve_device(_device(args, mesh))

    def placed(model):
        if mesh is not None:
            shard_module(model, mesh)
        return model.to(device)

    if "schema_net" in global_cfg:
        predictor = placed(_assemble_schema_predictor(global_cfg, args, n_classes))
        result = Evaluation(predictor, get_loss_fn(loss_cfg), loss_cfg["weight_dict"], val_loader,
                            top_k=(1, 5), device=device, mesh=mesh)()
        result["cb"] = CBEvaluation(predictor.classify_discretized, val_loader, device=device,
                                    mesh=mesh)()
        return result
    model = get_model(model_cfg_of(global_cfg, args.base_dir), n_classes,
                      dtype=resolve_dtype(val_cfg.get("dtype")))
    init_parameters_(model, torch.Generator().manual_seed(0))
    if args.resume:
        _restore_model(model, args.resume)
    return Evaluation(placed(model), get_loss_fn(loss_cfg), loss_cfg["weight_dict"], val_loader,
                      top_k=(1, 5), device=device, mesh=mesh)()
