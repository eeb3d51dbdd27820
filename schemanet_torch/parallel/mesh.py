"""The grid of ranks and the sharding rules (port of
``schemanet_tpu/parallel/mesh.py``).

The JAX package runs on one ``jax.sharding.Mesh`` with axes ``data`` and
``model`` and lets XLA insert the collectives. Here the same grid is a set of
``torch.distributed`` ranks, one process each, and the collectives are
explicit:

* ``data`` (data parallel): each rank of a data group reads its slice of
  every global batch (``data/loader.py`` with ``process_index =
  data_index``); gradients are averaged over the group.
* ``model`` (parameter sharding, for the big-atlas configs): ImageNet's edge
  atlas ``[1000, 500, 500]`` is 1.0 GB in fp32 before its moments. The
  atlas's class axis K, the GNN code embedding's rows and four backbone
  weights are split over the ranks of a model group, which share one data
  slice. With ``model`` 1 every parameter is replicated.

Rank r of a ``data x model`` grid has ``data_index = r // model`` and
``model_index = r % model``: the ranks of one model group are contiguous.

The rules (``DEFAULT_PARAM_RULES``) are the JAX package's regexes, matched
against the JAX name of a port parameter (``models/port.py`` ``jax_name``,
with ``/`` between path segments). Each gives the dimension that is split,
counted in the JAX layout; ``param_shardings`` turns it into the port's
layout (a Dense ``kernel [in, out]`` is the port's ``weight [out, in]``). A
tensor whose dimension the model size does not divide stays replicated.

How a sharded parameter is used:

* the atlas's ``vertex_weights`` and ``edge_weights`` stay local: each rank
  embeds its K / model classes with the GNN and ``all_gather`` gives every
  rank the class features ``[K, D]`` (``schema/gnn.py``);
* the GNN embedding and the backbone's ``linear1``, ``linear2``,
  ``linear_qkv`` and ``linear_out`` are sharded storage: the shard, its
  gradient and its optimizer moments; ``gathered`` makes the whole tensor
  before each use, as XLA gathers around a Pallas call it cannot partition.

The collectives are built from ``all_reduce`` alone, so one code path runs
under NCCL and under gloo (which takes CUDA tensors for ``all_reduce`` and
``broadcast`` only). ``all_gather`` is an ``all_reduce`` of a buffer filled with
``-0.0`` in which each rank writes its slice: adding ``-0.0`` returns every
value bit for bit, signed zeros included. Its backward sums the cotangents
over the group and keeps the rank's slice.

Gradients (``train/trainer.py``): each rank back-propagates its local loss
divided by ``model`` (the ranks of a model group compute the same loss); a
replicated parameter's gradient is summed over the model group, then every
gradient is averaged over the data group, in that fixed order.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
import socket
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

# param-path regex -> the dimension split over ``model``, in the JAX layout.
# Paths are '/'-joined JAX names (schemanet_tpu/parallel/mesh.py's rules).
DEFAULT_PARAM_RULES = (
    # atlas: shard classes over 'model' (K is the big axis at ImageNet scale)
    (r".*schema_net/vertex_weights$", 0),
    (r".*schema_net/edge_weights$", 0),
    # GNN code embedding: shard vocabulary rows
    (r".*matcher/gnn/embedding$", 0),
    # backbone FFN: hidden dim
    (r".*mlp/linear1/kernel$", 1),
    (r".*mlp/linear1/bias$", 0),
    (r".*mlp/linear2/kernel$", 0),
    # fused qkv: output (head) dim
    (r".*attention/linear_qkv/kernel$", 1),
    (r".*attention/linear_qkv/bias$", 0),
    (r".*attention/linear_out/kernel$", 0),
)


@dataclasses.dataclass
class Mesh:
    """A ``data x model`` grid and this rank's place in it. ``data_group``
    holds the ranks of this rank's model index (one per data slice),
    ``model_group`` those of its data index (one per shard); both are
    ``torch.distributed`` process groups, None for a grid built without
    them (the sharding helpers need only the sizes and the indices)."""

    data: int
    model: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    data_group: Any = None
    model_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    """nccl for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_device(device, local_rank: int) -> torch.device:
    """``device`` with a CUDA device without an index taken as
    ``cuda:local_rank``; None means CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return dev


RENDEZVOUS_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_from_env(backend: Optional[str] = None, device=None,
                  timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group of the rendezvous ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), with
    ``timeout`` on every collective. Returns this rank's device: a CUDA
    ``device`` without an index (or None) is ``cuda:LOCAL_RANK``. The backend
    is ``backend``, else ``default_backend`` of the device."""
    missing = [k for k in RENDEZVOUS_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(f"no rendezvous in the environment ({', '.join(missing)} unset): "
                           "launch the ranks with torchrun")
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or default_backend(dev), init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), timeout=timeout)
    return dev


def make_mesh(data: Optional[int] = None, model: int = 1, device=None,
              backend: Optional[str] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """The ``data x model`` grid over the ranks of ``torch.distributed``,
    joining it first where this process has not: from the environment's
    rendezvous (``init_from_env``) where it has one, else as the one rank of
    a one-rank grid on a free localhost port. ``data`` None takes every rank
    that ``model`` leaves; a grid that does not match the world size raises.
    ``device`` as ``init_from_env``; the backend is the process group's
    (``backend``, else nccl for CUDA and gloo for the CPU)."""
    if not dist.is_initialized():
        if all(k in os.environ for k in RENDEZVOUS_KEYS):
            init_from_env(backend, device, timeout)
        else:
            dev = _rank_device(device, 0)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(backend or default_backend(dev),
                                    init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                    world_size=1, timeout=timeout)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        if world % model:
            raise ValueError(f"{world} ranks are not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"grid {data} x {model} does not match the world of {world} ranks")
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", "0")))
    mesh = Mesh(data, model, rank, dev, dist.get_backend())
    # every rank creates every group, in the same order
    for m in range(model):
        group = dist.new_group([d * model + m for d in range(data)], timeout=timeout)
        if m == mesh.model_index:
            mesh.data_group = group
    for d in range(data):
        group = dist.new_group([d * model + m for m in range(model)], timeout=timeout)
        if d == mesh.data_index:
            mesh.model_group = group
    return mesh


def local_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch (its data slice)."""
    per = global_batch // mesh.data
    start = per * mesh.data_index
    return slice(start, start + per)


# -- the rules ----------------------------------------------------------------

def _spec_fits(dim: int, shape, model: int) -> bool:
    return dim < len(shape) and shape[dim] % model == 0


def param_shardings(mesh: Mesh, named_shapes: Iterable[Tuple[str, Sequence[int]]],
                    rules: Sequence = DEFAULT_PARAM_RULES) -> Dict[str, Optional[int]]:
    """The split dimension, in the port's layout, of every named parameter
    (port names and full shapes); None: replicated (no rule matches its JAX
    name, the model size is 1, or the model size does not divide it)."""
    from ..models.port import jax_name

    out: Dict[str, Optional[int]] = {}
    for name, shape in named_shapes:
        shape = tuple(shape)
        out[name] = None
        if mesh.model <= 1:
            continue
        jname = jax_name(name, len(shape))
        path = jname.replace(".", "/")
        for pattern, jax_dim in rules:
            if re.match(pattern, path):
                # a 2-D Dense kernel [in, out] is the port's weight [out, in]
                dim = 1 - jax_dim if jname.endswith(".kernel") and len(shape) == 2 else jax_dim
                if _spec_fits(dim, shape, mesh.model):
                    out[name] = dim
                break
    return out


def _shard_of(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    if dim is None:
        return t
    n = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_index * n, n)


def shard_params(mesh: Mesh, state: Mapping[str, torch.Tensor],
                 shardings: Optional[Mapping[str, Optional[int]]] = None,
                 rules: Sequence = DEFAULT_PARAM_RULES) -> Dict[str, torch.Tensor]:
    """This rank's shards (views) of a full state dict. ``shardings``
    defaults to ``param_shardings`` of the state's floating-point entries;
    buffers and anything else unnamed by it stay whole."""
    if shardings is None:
        shardings = param_shardings(
            mesh, [(k, v.shape) for k, v in state.items() if v.is_floating_point()], rules)
    return {k: _shard_of(v, shardings.get(k), mesh) for k, v in state.items()}


def gather_params(mesh: Mesh, state: Mapping[str, torch.Tensor],
                  shardings: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """The full state dict of a sharded one (a collective over the model
    group: every rank of it calls this), ``shardings`` from the full shapes.
    Replicated entries come back as they are."""
    out = {}
    for k, v in state.items():
        dim = shardings.get(k)
        out[k] = v if dim is None else all_gather(v.detach(), dim, mesh)
    return out


# -- collectives ------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum ``t`` (or reduce it by ``op``) over ``group`` in place; returns it."""
    dist.all_reduce(t, op=op, group=group)
    return t


def _gather(x: torch.Tensor, dim: int, group, index: int, size: int) -> torch.Tensor:
    """``size`` ranks' ``x`` concatenated along ``dim`` in ``index`` order:
    an ``all_reduce`` of a ``-0.0``-filled buffer in which this rank wrote
    its slice (adding -0.0 is exact, and keeps a -0.0 entry)."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    buf = torch.full(shape, -0.0, dtype=x.dtype, device=x.device)
    buf.narrow(dim, index * n, n).copy_(x)
    return all_reduce_(buf, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        ctx.dim, ctx.group, ctx.index, ctx.n = dim, group, index, x.shape[dim]
        return _gather(x, dim, group, index, size)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(), None, None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable: each rank's sum is the
    same function of every rank's ``x``, so the backward sums the cotangent
    over the group too (BatchNorm's statistics of a global batch,
    ``models/layers_extra.py``)."""
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The model group's shards of ``x`` concatenated along ``dim`` in rank
    order, differentiable: the backward sums the cotangent over the group
    and keeps this rank's slice. A model size of 1 returns ``x``."""
    if mesh.model == 1:
        return x
    return _AllGather.apply(x.contiguous(), dim, mesh.model_group, mesh.model_index, mesh.model)


def gather_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data group's ``x`` concatenated along dim 0 in data order (the
    global batch's order), not differentiable."""
    if mesh.data == 1:
        return x
    return _gather(x, 0, mesh.data_group, mesh.data_index, mesh.data)


# -- sharded storage ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """What ``shard_module`` attaches to a sharded parameter
    (``param.grid_shard``): its split dimension and the grid."""

    dim: int
    mesh: Mesh


def grid_shard(p: torch.Tensor) -> Optional[Shard]:
    return getattr(p, "grid_shard", None)


def gathered(p: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a parameter held as shards (``all_gather`` over
    its model group, differentiable); any other tensor as it is."""
    shard = grid_shard(p)
    return p if shard is None else all_gather(p, shard.dim, shard.mesh)


def _owner(model: torch.nn.Module, name: str):
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    return (model.get_submodule(path) if path else model), leaf


@torch.no_grad()
def shard_module(model: torch.nn.Module, mesh: Mesh,
                 rules: Sequence = DEFAULT_PARAM_RULES) -> Dict[str, Optional[int]]:
    """Replace each parameter the rules shard by this rank's shard (a new
    ``nn.Parameter`` with ``grid_shard`` set, same name and
    ``requires_grad``); then every module with a ``join_grid`` method is
    told the grid (a SchemaNet atlas whose class axis is split learns its
    class range; the matcher takes its pooling size over the data group).
    Returns ``param_shardings`` of the full shapes, which ``gather_params``
    and ``shard_params`` take."""
    named = list(model.named_parameters())
    shardings = param_shardings(mesh, [(n, p.shape) for n, p in named], rules)
    for name, p in named:
        dim = shardings[name]
        if dim is None:
            continue
        owner, leaf = _owner(model, name)
        shard = torch.nn.Parameter(_shard_of(p.detach(), dim, mesh).clone(),
                                   requires_grad=p.requires_grad)
        shard.grid_shard = Shard(dim, mesh)
        setattr(owner, leaf, shard)
    for module in model.modules():
        if hasattr(module, "join_grid"):
            module.join_grid(mesh)
    return shardings


def gather_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A state tensor of parameter ``p`` (an optimizer moment, or a factored
    moment's row or column statistics) made whole where it follows ``p``'s
    split: it has ``p``'s split dimension at ``p``'s shard size. A
    collective over the model group when ``p`` is sharded."""
    shard = grid_shard(p)
    if shard is None or t.ndim <= shard.dim or t.shape[shard.dim] != p.shape[shard.dim]:
        return t
    return all_gather(t, shard.dim, shard.mesh)


def slice_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The inverse of ``gather_like``: this rank's slice of a whole state
    tensor of the sharded parameter ``p``."""
    shard = grid_shard(p)
    if (shard is None or t.ndim <= shard.dim
            or t.shape[shard.dim] != p.shape[shard.dim] * shard.mesh.model):
        return t
    return _shard_of(t, shard.dim, shard.mesh)
