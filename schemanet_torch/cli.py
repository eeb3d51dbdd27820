"""Command line of the port (counterpart of ``schemanet_tpu/cli.py``): the
reference's five-stage pipeline and serving.

Subcommands, with the JAX CLI's flags and defaults and one more, ``--device``
(``cuda`` unless the caller passes ``cpu``; the JAX CLI's
``SCHEMANET_PLATFORM``):

    train    --worker {backbone_worker, schema_net_worker, eval_worker}
    extract  (stage 1: codebook k-means; writes cluster_<M>_from_<N>.npy and .pth)
    export   (stage 2: the port's bundle of backbone and codebook)
    init     (stage 3: IR-Atlas initialisation)
    serve    (microbatched predict; --explain, --out .npz, --graph-sample GraphML)

Run as ``python -m schemanet_torch.cli <subcommand> ...``. Configs are YAML
(the port's reader, ``utils/config.py``, with PyYAML's typing and without
PyYAML) or JSON. ``scripts/torch/*.sh``, ``tools/parity_run_torch.sh`` and
the accuracy gates ``tools/ab_*_torch.sh`` run the stages through this
module. ``--quant-int8`` (``extract``, ``serve``) runs the backbone's W8A8
route (``ops/quant.py``); ``--save-features`` and ``--saved-features-fp``
dump and cluster features through h5py.

Several GPUs (``train``, ``extract``, ``init``): ``--mesh-data D
--mesh-model M`` runs a ``D x M`` grid (``parallel/mesh.py``), one process a
rank on this host (``parallel/launch.py``; rank r on ``cuda:r``, the kernel
library built before the ranks start; with ``--device cpu`` gloo processes
on the CPU). A grid larger than the GPUs present raises. ``--multi-host``
joins the rendezvous ``torchrun`` sets instead (``torchrun
--nproc-per-node N -m schemanet_torch.cli train ...``, on each host);
``--mesh-data`` then defaults to every rank ``--mesh-model`` leaves. Rank 0
writes the outputs. ``export`` and ``serve`` run in one process, as the JAX
CLI's do.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Dict

import numpy as np
import torch

from .data.datasets import IMG_EXTS, get_dataset
from .data.jpeg import read_image
from .data.loader import _loader
from .device import resolve_device
from .models.port import load_pretrain_into
from .models.vit import get_model
from .ops.kernels import _build
from .ops.policy import configure
from .parallel.launch import GRID_CHILD, spawn_ranks
from .parallel.mesh import RENDEZVOUS_KEYS, init_from_env, make_mesh
from .pipeline.bundle import load_bundle, save_atlas_init, save_bundle
from .pipeline.extract_ingredients import cluster_saved_features, extract_codebook
from .pipeline.stages import init_stage, parse_encode_layer
from .schema.predictor import init_parameters_
from .serve import load_serve_predictor
from .train.common import restore_model_state
from .train.workers import WORKER_REGISTRY, LaunchArgs, model_cfg_of, resolve_dtype
from .utils.config import apply_overrides, get_cfg, parse_override_strings, resolve_subconfig
from .utils.logging_utils import setup_logger

__all__ = ["build_parser", "main", "parse_encode_layer"]


def _common_flags(p: argparse.ArgumentParser):
    p.add_argument("--cfg-filepath", "--cfg", dest="cfg", type=str, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-dir", type=str, default="run/exp")
    p.add_argument("--file-name-cfg", type=str, default="exp")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--mesh-data", type=int, default=None, help="data-parallel axis size")
    p.add_argument("--mesh-model", type=int, default=1, help="model-parallel axis size")
    p.add_argument("--multi-host", action="store_true",
                   help="join the rendezvous torchrun sets (several hosts)")
    p.add_argument(
        "--override", "-o", action="append", default=[],
        help="dotted-path config override key=value (repeatable)",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default; raises without a GPU) or cpu")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("schemanet-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="run a training/eval worker")
    _common_flags(p_train)
    p_train.add_argument(
        "--worker", type=str, default="backbone_worker",
        choices=["backbone_worker", "schema_net_worker", "eval_worker"],
    )
    p_train.add_argument("--resume", type=str, default="",
                         help="checkpoint tag/path, or 'auto' for the latest")

    p_extract = sub.add_parser("extract", help="stage 1: extract ingredient codebook")
    _common_flags(p_extract)
    p_extract.add_argument("--ckpt", type=str, required=True,
                           help="backbone checkpoint (file, tag or directory) or reference .pth")
    p_extract.add_argument("--save-path", type=str, required=True)
    p_extract.add_argument("--max-features", type=int, default=1_000_000)
    p_extract.add_argument("--batch-size", type=int, default=64)
    p_extract.add_argument("--save-features", action="store_true",
                           help="also dump the features to saved_features.h5 (needs h5py)")
    p_extract.add_argument("--saved-features-fp", type=str, default=None,
                           help="cluster a saved feature dump instead of extracting (needs h5py)")
    p_extract.add_argument("--dtype", type=str, default="float32",
                           help="backbone compute dtype (bfloat16 for speed; fp32 = reference "
                                "parity)")
    p_extract.add_argument("--quant-int8", action="store_true",
                           help="W8A8 backbone forward (int8 projections)")

    p_export = sub.add_parser("export", help="stage 2: export frozen bundle")
    _common_flags(p_export)
    p_export.add_argument("--ckpt", type=str, required=True)
    p_export.add_argument("--vocabulary-fp", type=str, required=True)
    p_export.add_argument("--save-path", type=str, required=True)
    p_export.add_argument("--num-classes", type=int, required=True)

    p_init = sub.add_parser("init", help="stage 3: initialise IR-Atlas")
    _common_flags(p_init)
    p_init.add_argument("--save-fp", type=str, required=True)
    p_init.add_argument("--batch-size", type=int, default=32)
    p_init.add_argument("--make-partial", type=float, default=None)

    p_serve = sub.add_parser("serve", help="microbatched inference + interpretability (serve.py)")
    _common_flags(p_serve)
    p_serve.add_argument("--ckpt", type=str, required=True,
                         help="trained schema_net checkpoint (file, tag or directory)")
    p_serve.add_argument("--images", type=str, required=True,
                         help=".npy [N,H,W,3] array, an image file, a directory "
                              "of images, or 'synthetic:N'")
    p_serve.add_argument("--microbatch", type=int, default=64)
    p_serve.add_argument("--quant-int8", action="store_true",
                         help="W8A8 backbone (int8 projections)")
    p_serve.add_argument("--explain", action="store_true",
                         help="also compute attribution maps / instance graphs")
    p_serve.add_argument("--graph-sample", type=int, default=None,
                         help="export sample's instance graph as GraphML (needs --out)")
    p_serve.add_argument("--out", type=str, default=None,
                         help="write logits (+ explain bundle) to this .npz")
    p_serve.add_argument("--topk", type=int, default=5)
    return parser


GRID_COMMANDS = ("train", "extract", "init")


def _grid_size(args) -> int:
    return (args.mesh_data or 1) * args.mesh_model


def _is_rank(args) -> bool:
    """This process is a rank of a grid: spawned by the launcher, or
    ``--multi-host`` under ``torchrun``."""
    return args.command in GRID_COMMANDS and (args.multi_host or GRID_CHILD in os.environ)


def _spawn_grid(args, argv) -> int:
    """Run this command line as the grid's ranks on this host."""
    n = _grid_size(args)
    if torch.device(args.device).type == "cuda":
        count = torch.cuda.device_count()
        if n > count:
            raise SystemExit(f"a grid of {n} ranks needs {n} GPUs, one a rank; this host has "
                             f"{count}")
        _build.library()  # once, before the ranks start
    spawn_ranks([sys.executable, "-m", "schemanet_torch.cli", *argv], n)
    return 0


def _refuse_unported(args) -> None:
    """Flags the port cannot honour raise instead of being ignored."""
    if args.multi_host and not all(k in os.environ for k in RENDEZVOUS_KEYS):
        raise SystemExit("--multi-host joins the rendezvous torchrun sets ("
                         + ", ".join(RENDEZVOUS_KEYS) + " are unset): launch with torchrun "
                         "--nproc-per-node N -m schemanet_torch.cli ...")


def _base_dir(args) -> str:
    return os.path.dirname(os.path.abspath(args.cfg))


def _setup(args) -> Dict[str, Any]:
    _refuse_unported(args)
    resolve_device(args.device)  # raises before any work where the device is missing
    if _is_rank(args):
        init_from_env(device=args.device)
    elif _grid_size(args) > 1:
        logging.getLogger("cli").warning("%s runs in one process; the grid flags are ignored",
                                         args.command)
    setup_logger(os.path.join(args.log_dir, "logs"), f"{args.file_name_cfg}.log")
    cfg = get_cfg(args.cfg)
    cfg = apply_overrides(cfg, parse_override_strings(args.override), base_dir=_base_dir(args))
    # kernels: the kernel policy (ops/policy.py), for every subcommand, as
    # the JAX package's _setup applies it
    configure(cfg.get("kernels"))
    return cfg


def _launch_args(args, resume: str = ""):
    return LaunchArgs(seed=args.seed, debug=args.debug, log_dir=args.log_dir, resume=resume,
                      base_dir=_base_dir(args), device=args.device, mesh_data=args.mesh_data,
                      mesh_model=args.mesh_model)


def _stage_mesh(args):
    """The grid of stages 1 and 3 (data-parallel passes), None in one
    process."""
    if not _is_rank(args):
        return None
    return make_mesh(data=args.mesh_data, model=args.mesh_model, device=args.device)


def _stage_loader(train_set, data_cfg, batch_size: int, seed: int, mesh=None):
    """The training split shuffled, as stages 1 and 3 read it; a rank's data
    slice on a grid."""
    kw = {} if mesh is None else {"process_index": mesh.data_index, "process_count": mesh.data}
    return _loader(train_set, data_cfg, {"batch_size": batch_size}, "train", True, seed, **kw)


def _is_writer(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _load_backbone_for_stage(cfg, args):
    """(model, model_cfg, data_cfg): the ViT/DeiT of the config's ``model``
    with the fine-tuned backbone of ``args.ckpt``, a checkpoint of the port
    (a ``<tag>.pt`` file, a tag's path or a checkpoint directory; every
    parameter from it) or a reference-named ``.pth`` (``models/port.py``
    ``load_pretrain_into``, other-shaped entries kept with a warning)."""
    data_cfg = resolve_subconfig(cfg["dataset"], _base_dir(args))
    model_cfg = model_cfg_of(cfg, _base_dir(args))
    n_classes = cfg.get("num_classes") or getattr(args, "num_classes", None)
    if n_classes is None:
        n_classes = get_dataset(data_cfg, "train").num_classes
    model = get_model(model_cfg, n_classes, dtype=resolve_dtype(getattr(args, "dtype", None)))
    init_parameters_(model, torch.Generator().manual_seed(0))
    ckpt_path = os.path.abspath(os.path.expanduser(args.ckpt))
    if ckpt_path.endswith(".pth"):
        load_pretrain_into(model, ckpt_path)
    else:
        model.load_state_dict(restore_model_state(ckpt_path))
    return model, model_cfg, data_cfg


def cmd_train(args):
    cfg = _setup(args)
    worker = WORKER_REGISTRY.get(args.worker)
    result = worker(cfg, _launch_args(args, args.resume))
    if isinstance(result, dict) and "eval" in result:
        logging.getLogger("cli").info("final eval: %s", (result["eval"] or {}).get("acc"))
    elif isinstance(result, dict):
        # eval_worker returns the metrics dict directly
        logging.getLogger("cli").info(
            "eval result: %s", {k: v for k, v in result.items() if not k.startswith("_")})
    return 0


def cmd_extract(args):
    cfg = _setup(args)
    num_clusters = cfg["discretization"]["vocabulary"]["size"]
    os.makedirs(args.save_path, exist_ok=True)
    mesh = _stage_mesh(args)
    if args.saved_features_fp:  # cluster a dump (the JAX CLI's resume-from-h5 path)
        centers = cluster_saved_features(args.saved_features_fp, num_clusters, seed=args.seed,
                                         device=mesh.device if mesh else args.device)
        n_feats = "h5"
    else:
        model, _, data_cfg = _load_backbone_for_stage(cfg, args)
        model.requires_grad_(False).to(mesh.device if mesh else resolve_device(args.device))
        encode_layer = parse_encode_layer(cfg["discretization"]["encoder_layer"])
        loader = _stage_loader(get_dataset(data_cfg, "train"), data_cfg, args.batch_size,
                               args.seed, mesh)
        dump = os.path.join(args.save_path, "saved_features.h5") if args.save_features else None
        if dump and _is_writer(mesh) and os.path.exists(dump):
            os.remove(dump)  # a new dump, not an append to an earlier run's
        centers = extract_codebook(model, loader, encode_layer, num_clusters,
                                   max_features=args.max_features, seed=args.seed, mesh=mesh,
                                   quant=args.quant_int8, save_features_path=dump)
        n_feats = args.max_features
    if not _is_writer(mesh):
        return 0
    centers = centers.float().cpu()
    save_fp = os.path.join(args.save_path, f"cluster_{num_clusters}_from_{n_feats}.npy")
    np.save(save_fp, centers.numpy())
    torch.save(centers, save_fp.replace(".npy", ".pth"))  # the reference's artifact
    print(f"saved codebook to {save_fp}")
    return 0


def cmd_export(args):
    cfg = _setup(args)
    model, model_cfg, _ = _load_backbone_for_stage(cfg, args)
    encode_layer = parse_encode_layer(cfg["discretization"]["encoder_layer"])
    vocab_fp = os.path.expanduser(args.vocabulary_fp)
    if vocab_fp.endswith(".npy"):
        codebook = np.load(vocab_fp)
    else:
        codebook = torch.load(vocab_fp, map_location="cpu", weights_only=True).numpy()
    size = cfg["discretization"]["vocabulary"]["size"]
    if codebook.shape[0] > size:  # random subsample (discretization.py:40-48)
        rng = np.random.default_rng(args.seed)
        codebook = codebook[rng.permutation(codebook.shape[0])[:size]]
    save_bundle(args.save_path, model_cfg, encode_layer, model.state_dict(),
                torch.from_numpy(np.ascontiguousarray(codebook, np.float32)),
                extra={"discretization": cfg["discretization"]})
    print(f"saved bundle to {args.save_path}")
    return 0


def cmd_init(args):
    cfg = _setup(args)
    data_cfg = dict(resolve_subconfig(cfg["dataset"], _base_dir(args)))
    if args.make_partial:
        data_cfg["make_partial"] = args.make_partial
    train_set = get_dataset(data_cfg, "train")
    mesh = _stage_mesh(args)
    loader = _stage_loader(train_set, data_cfg, args.batch_size, args.seed, mesh)
    bundle = load_bundle(cfg["schema_net"]["bundle"])
    stage_cfg = dict(cfg, dataset=dict(data_cfg, num_classes=train_set.num_classes))
    atlas_init = init_stage(stage_cfg, bundle, loader, seed=args.seed,
                            device=None if mesh else args.device, mesh=mesh)
    if not _is_writer(mesh):
        return 0
    save_atlas_init(args.save_fp, atlas_init["params"], atlas_init["class_ingredients"])
    print(f"saved initial IR-Atlas to {args.save_fp}")
    return 0


def _load_serve_images(spec: str, img_size: int, device: str) -> np.ndarray:
    """--images: 'synthetic:N' | .npy array | image file | directory. JPEG
    files decode through the port's route (``data/jpeg.py``: libjpeg on the
    host, or nvJPEG on ``device``), other files through Pillow; each image
    is resized to ``img_size`` by the JAX CLI's PIL ``resize``'s filter
    (bicubic, antialiased, uint8; a level or two apart from PIL's at
    most), then scaled to [0, 1]."""
    if spec.startswith("synthetic:"):
        n = int(spec.split(":", 1)[1])
        rng = np.random.default_rng(0)
        return rng.normal(size=(n, img_size, img_size, 3)).astype(np.float32)
    path = os.path.expanduser(spec)
    if path.endswith(".npy"):
        arr = np.asarray(np.load(path), np.float32)
        return arr[None] if arr.ndim == 3 else arr
    files = (
        sorted(os.path.join(path, f) for f in os.listdir(path)
               if f.lower().endswith(IMG_EXTS))
        if os.path.isdir(path) else [path]
    )
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    decode_device = device if torch.device(device).type == "cuda" else None
    imgs = []
    for f in files:
        x = torch.from_numpy(np.ascontiguousarray(read_image(f, decode_device)))
        # PyTorch's uint8 antialiased resize takes PIL's fixed-point steps
        x = torch.nn.functional.interpolate(x.permute(2, 0, 1)[None].contiguous(),
                                            size=(img_size, img_size), mode="bicubic",
                                            align_corners=False, antialias=True)
        imgs.append(x[0].permute(1, 2, 0).numpy().astype(np.float32) / 255.0)
    return np.stack(imgs)


def cmd_serve(args):
    """The reference ships no serving path; this surface is the JAX CLI's."""
    cfg = _setup(args)
    schema_cfg = cfg["schema_net"]
    num_classes = cfg.get("num_classes")
    if num_classes is None:
    
        num_classes = get_dataset(resolve_subconfig(cfg["dataset"], _base_dir(args)),
                                  "train").num_classes
    bundle_path = os.path.expanduser(schema_cfg["bundle"])
    img_size = load_bundle(bundle_path).img_size
    server = load_serve_predictor(bundle_path, schema_cfg, args.ckpt, num_classes,
                                  microbatch=args.microbatch, device=args.device,
                                  quant_int8=args.quant_int8)
    images = _load_serve_images(args.images, img_size, args.device)

    logits = server.predict(images)
    k = min(args.topk, logits.shape[1])
    order = np.argsort(-logits, axis=1)[:, :k]
    for i, row in enumerate(order):
        print(json.dumps({
            "index": i,
            "label": int(row[0]),
            "topk": [[int(c), float(logits[i, c])] for c in row],
        }))

    saved: Dict[str, Any] = {"logits": logits}
    if args.explain:
        saved.update(server.explain(images))
    if args.out:
        np.savez(os.path.expanduser(args.out), **saved)
        print(f"saved {sorted(saved)} to {args.out}")
        if args.graph_sample is not None:
            import networkx as nx

            g = server.explain_networkx(images, sample=args.graph_sample)
            graph_fp = os.path.expanduser(args.out) + f".sample{args.graph_sample}.graphml"
            nx.write_graphml(g, graph_fp)
            print(f"saved instance graph to {graph_fp}")
    return 0


COMMANDS = {"train": cmd_train, "extract": cmd_extract, "export": cmd_export, "init": cmd_init,
            "serve": cmd_serve}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if (args.command in GRID_COMMANDS and _grid_size(args) > 1 and not _is_rank(args)):
        _refuse_unported(args)
        return _spawn_grid(args, argv)
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
