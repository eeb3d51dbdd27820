"""One rank of a CPU grid test: ``python -m tests._torch_grid_rank <workdir>``,
started by ``schemanet_torch.parallel.launch.spawn_ranks`` (gloo, the
rendezvous in the environment). Reads ``<workdir>/spec.pt`` (what to run:
``case`` and its inputs, made by the test), writes ``<workdir>/rank<r>.pt``.
Imports torch and the port only."""

import logging
import os
import pathlib
import sys
from datetime import timedelta

import numpy as np
import torch

from schemanet_torch.parallel.mesh import (gather_like, local_batch_slice, make_mesh,
                                           shard_module)

TIMEOUT = timedelta(seconds=120)  # a collective a dead rank leaves waiting fails after this
REPO = pathlib.Path(__file__).resolve().parents[1]


def run_grid(spec, nprocs, workdir, timeout=240):
    """Run ``spec`` on ``nprocs`` gloo ranks (each its own process, killed
    with the others when one fails or ``timeout`` seconds pass); the ranks'
    outputs in rank order."""
    from schemanet_torch.parallel.launch import spawn_ranks

    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(spec, workdir / "spec.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    spawn_ranks([sys.executable, "-m", "tests._torch_grid_rank", str(workdir)], nprocs,
                timeout=timeout, log_dir=str(workdir / "logs"), env=env, cwd=str(REPO))
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(nprocs)]


class SliceLoader(list):
    """A list of global batches, yielded as this rank's data slices."""

    def __init__(self, batches, mesh):
        super().__init__(batches)
        self.mesh = mesh

    def __iter__(self):
        for batch in list.__iter__(self):
            n = len(next(iter(batch.values())))
            sl = local_batch_slice(n, self.mesh) if self.mesh is not None else slice(None)
            yield {k: v[sl] for k, v in batch.items()}

    def set_epoch(self, epoch):
        pass


def build_model(spec):
    from schemanet_torch.models.vit import get_model
    from schemanet_torch.schema import build_predictor

    if spec["kind"] == "backbone":
        if spec.get("dtype") == "float64":  # parameters and compute in fp64
            return get_model(spec["model_cfg"], spec["K"], dtype=torch.float64).double()
        return get_model(spec["model_cfg"], spec["K"])
    return build_predictor(spec["model_cfg"], spec["schema_cfg"], spec["K"], spec["M"],
                           spec["D"], spec["encode_layer"])


def make_trainer(spec, mesh):
    """The trainer of ``spec`` (its model loaded from ``spec["state"]``), on
    ``mesh`` or in one process (None)."""
    from schemanet_torch.schema import get_loss_fn
    from schemanet_torch.train import SCHEMA_NET_FROZEN, Trainer, TrainerConfig

    model = build_model(spec)
    model.load_state_dict(spec["state"])
    frozen = SCHEMA_NET_FROZEN if spec["kind"] == "schema" else ()
    loss_cfg = spec["loss_cfg"]
    return Trainer(TrainerConfig.from_cfg(spec["train_cfg"], frozen_patterns=frozen), model,
                   get_loss_fn(loss_cfg), loss_cfg["weight_dict"], spec["steps_per_epoch"],
                   seed=spec.get("seed", 0), device="cpu", mesh=mesh)


def run_steps(spec, mesh):
    """The steps of ``spec`` on ``mesh`` (None: one process): losses, the
    step-1 gradients (whole), the trainer's (whole) state after the steps."""
    trainer = make_trainer(spec, mesh)
    if spec.get("restore"):  # a whole checkpoint (any grid's) onto this rank
        trainer.load_state_dict(torch.load(spec["restore"], weights_only=True))
    losses, grads = [], None
    for image, label in spec["batches"]:
        sl = local_batch_slice(len(label), mesh) if mesh is not None else slice(None)
        metrics = trainer.train_iter({"image": image[sl], "label": label[sl]})
        losses.append({k: float(v) for k, v in metrics.items()})
        if grads is None:
            grads = {n: gather_like(p.grad, p).clone() for n, p in trainer.model.named_parameters()
                     if p.grad is not None}
    state = trainer.state_dict()
    if spec.get("ckpt_dir") and (mesh is None or mesh.rank == 0):
        from schemanet_torch.train import CheckpointManager

        CheckpointManager(spec["ckpt_dir"]).save("grid", state)
    return {"losses": losses, "grads": grads, "state": state}


def _fake_stage3_predictor(image):
    """Stage 3's backbone stand-in (the JAX test's): code ids as the image."""
    ing = image.to(torch.int32)
    attn = (ing[:, :, None] + ing[:, None, :]).float() / 10.0
    return {"ingredients": ing, "attn": attn, "attn_cls": ing.float() / 5.0}


def main(workdir):
    logging.basicConfig(level=logging.INFO)
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    case = spec["case"]
    grid = spec.get("grid", (None, 1))
    mesh = make_mesh(data=grid[0], model=grid[1], device="cpu", timeout=TIMEOUT)
    out = {}
    if case == "steps":
        out = run_steps(spec, mesh)
    elif case == "stage3":
        from schemanet_torch.pipeline.init_schema_net import init_atlas
        from schemanet_torch.schema.atlas import AtlasConfig

        out = init_atlas(_fake_stage3_predictor, SliceLoader(spec["batches"], mesh),
                         AtlasConfig(**spec["atlas_cfg"]), accumulate_compat=spec["compat"],
                         device="cpu", mesh=mesh)
    elif case == "stage1":
        from schemanet_torch.pipeline.extract_ingredients import (collect_mid_features,
                                                                  extract_codebook)

        model = build_model(spec)
        model.load_state_dict(spec["state"])
        model.requires_grad_(False)
        loader = SliceLoader(spec["batches"], mesh)
        kw = spec["kmeans"]
        out = {"features": collect_mid_features(model, loader, kw["encode_layer"],
                                                kw["max_features"], mesh=mesh),
               "centers": extract_codebook(model, loader, mesh=mesh, **kw)}
    elif case == "eval":
        from schemanet_torch.schema import get_loss_fn
        from schemanet_torch.train import Evaluation

        model = build_model(spec)
        model.load_state_dict(spec["state"])
        shard_module(model, mesh)
        loss_cfg = spec["loss_cfg"]
        from schemanet_torch.utils.metrics import AverageMeter

        result = Evaluation(model, get_loss_fn(loss_cfg), loss_cfg["weight_dict"],
                            SliceLoader(spec["batches"], mesh), (1, 5), "cpu", mesh)()
        meter = AverageMeter()  # the host-side meter over the same samples
        for batch in SliceLoader(spec["batches"], mesh):
            meter.update(1.0, int(batch["valid"].sum()))
        meter.sync(mesh.data_group)
        out = {"eval": result, "meter_count": meter.count}
    elif case == "worker":
        from schemanet_torch.train import LaunchArgs, schema_net_worker

        args = LaunchArgs(seed=0, log_dir=spec["log_dir"], device="cpu", mesh_data=grid[0],
                          mesh_model=grid[1])
        res = schema_net_worker(spec["cfg"], args)
        trainer = res["trainer"]
        out = {"eval": res["eval"], "step": trainer.step, "state": trainer.state_dict()}
    else:
        raise ValueError(f"unknown case {case}")
    torch.save(out, os.path.join(workdir, f"rank{mesh.rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    np.seterr(all="ignore")
    main(sys.argv[1])
