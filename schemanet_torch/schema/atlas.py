"""IR-Atlas: per-class knowledge graphs and instance-graph building.

Port of ``schemanet_tpu/schema/atlas.py``. Parameters:

* ``vertex_weights``  [K, V_max]
* ``edge_weights``    [K, V_max, V_max]
* ``vertex_attribute_weights`` / ``edge_attribute_weights``  [2, 1]

and the ``class_ingredients`` buffer [K, V_max] (global code id per class
slot; ``arange`` by default). The getters renormalise the fp32 parameters in
fp32, with the row sums detached from the gradient as in the JAX package, and
emit the graph dtype (bf16 under ``graph_precision='default'``).

``project_atlas_params`` is the no-grad ``normalize()`` projection that
training keeps the parameters on; it works on the module in place.

On a grid with a model axis (``parallel/mesh.py`` ``shard_module``) each rank
holds the vertex and edge weights of its K / model classes
(``join_grid``): the getters return those classes' graphs and
``class_ingredients``' rows, and ``gather_classes`` concatenates a per-class
tensor over the model group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import geometry, graph as graph_ops
from ..ops.kernels import embed_bwd as ek
from ..ops.normalize import normalize_sum_clamp, zero_nans
from ..parallel.mesh import Mesh, all_gather, grid_shard


@dataclasses.dataclass(frozen=True)
class AtlasConfig:
    """``ir_atlas`` config block."""

    num_vertices: int  # M, vocabulary size
    num_classes: int
    class_max_vertices: Optional[int] = None  # V_max (None -> M)
    dist_alpha: float = 1.0
    dist_pow: float = 2.0
    feat_h: int = 14
    feat_w: int = 14
    constant_vertex_attr: Optional[Tuple[float, float]] = None
    constant_edge_attr: Optional[Tuple[float, float]] = None
    clamp_vertex_attn: Optional[float] = None
    clamp_edge_attn: Optional[float] = None
    remove_self_loop: bool = False
    prune_node_threshold: Optional[float] = None
    apply_normalize: bool = True
    clamp_weights: bool = True
    graph_precision: str = "highest"

    def __post_init__(self):
        if self.class_max_vertices is not None and self.class_max_vertices > self.num_vertices:
            raise ValueError(
                f"class_max_vertices {self.class_max_vertices} exceeds vocabulary size "
                f"{self.num_vertices}"
            )
        if self.dist_alpha < 0:
            raise ValueError("dist_alpha must be non-negative")
        if self.graph_precision not in ("highest", "default"):
            raise ValueError(f"graph_precision {self.graph_precision!r} not in (highest, default)")

    @property
    def v_max(self) -> int:
        return self.class_max_vertices or self.num_vertices

    @classmethod
    def from_cfg(cls, num_vertices: int, num_classes: int, ir_atlas_cfg: Dict[str, Any]):
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in ir_atlas_cfg.items() if k in known}
        for key in ("constant_vertex_attr", "constant_edge_attr"):
            if kwargs.get(key) is not None:
                kwargs[key] = tuple(kwargs[key])
        return cls(num_vertices=num_vertices, num_classes=num_classes, **kwargs)


class SchemaAtlas(nn.Module):
    def __init__(self, cfg: AtlasConfig):
        super().__init__()
        self.cfg = cfg
        k, v = cfg.num_classes, cfg.v_max
        self.vertex_weights = nn.Parameter(torch.zeros(k, v))
        self.edge_weights = nn.Parameter(torch.zeros(k, v, v))

        def attr(const):
            value = torch.full((2, 1), 0.5) if const is None else torch.tensor(const).reshape(2, 1)
            return nn.Parameter(value.float())

        self.vertex_attribute_weights = attr(cfg.constant_vertex_attr)
        self.edge_attribute_weights = attr(cfg.constant_edge_attr)
        self.register_buffer(
            "class_ingredients", torch.arange(v, dtype=torch.int32).expand(k, v).contiguous()
        )
        # the embedding gradient's plan of class_ingredients (sorted ids,
        # offsets, range checked), rebuilt when the buffer changes
        self.class_id_plans = ek.PlannedIds()
        self.class_mesh: Optional[Mesh] = None  # set by join_grid
        self._local_ingredients = (None, None)

    def join_grid(self, mesh: Mesh) -> None:
        """Where ``shard_module`` split the class axis, this rank holds the
        classes ``class_range`` of the model axis."""
        if grid_shard(self.vertex_weights) is not None:
            self.class_mesh = mesh

    @property
    def class_range(self) -> Tuple[int, int]:
        """(first, end) of the classes this module holds."""
        k = self.cfg.num_classes
        if self.class_mesh is None:
            return 0, k
        n = k // self.class_mesh.model
        return self.class_mesh.model_index * n, (self.class_mesh.model_index + 1) * n

    def gather_classes(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor of this rank's classes along dim 0 made whole over the
        model group (differentiable); as it is when the classes are not
        split."""
        return t if self.class_mesh is None else all_gather(t, 0, self.class_mesh)

    def local_class_ingredients(self) -> torch.Tensor:
        """``class_ingredients``' rows of the classes this module holds: the
        same tensor object while the buffer is unchanged, so the class
        lookup's ``PlannedIds`` keeps its plan."""
        ci = self.class_ingredients
        if self.class_mesh is None:
            return ci
        key = (ci.data_ptr(), tuple(ci.shape), ci._version)
        if self._local_ingredients[0] != key:
            k0, k1 = self.class_range
            self._local_ingredients = (key, ci[k0:k1])
        return self._local_ingredients[1]

    def _out_dtype(self) -> torch.dtype:
        return graph_ops.graph_dtype(self.cfg.graph_precision)

    def get_class_vertices(self) -> torch.Tensor:
        return normalize_sum_clamp(self.vertex_weights, detach_sum=True, min_val=1e-5).to(
            self._out_dtype())

    def get_class_edges(self) -> torch.Tensor:
        c = self.cfg
        e = self.edge_weights
        if c.prune_node_threshold is not None:
            # zero every edge touching a vertex at or below the threshold; the
            # mask carries no gradient
            with torch.no_grad():
                keep = (self.get_class_vertices() > c.prune_node_threshold).to(e.dtype)  # [K, V]
            e = e * (keep[:, :, None] * keep[:, None, :])
        e = normalize_sum_clamp(e, detach_sum=True, min_val=0.0).to(self._out_dtype())
        if c.remove_self_loop:
            eye = torch.eye(e.shape[-1], dtype=torch.bool, device=e.device)[None]
            e = torch.where(eye, torch.zeros_like(e), e)
        return e

    def get_atlas(self) -> Dict[str, torch.Tensor]:
        return {
            "class_vertices": self.get_class_vertices(),
            "class_edges": self.get_class_edges(),
            "class_ingredients": self.local_class_ingredients(),
        }

    def forward(self, ingredients: torch.Tensor, attn: torch.Tensor, attn_cls: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """ingredients [bs, L], attn [bs, L, L] raw, attn_cls [bs, L] raw ->
        dense slot-space instance graphs."""
        c = self.cfg
        slots = graph_ops.compact_instance_slots(ingredients, num_codes=c.num_vertices)
        vertices = graph_ops.instance_vertices(
            slots, attn_cls, self.vertex_attribute_weights, c.clamp_vertex_attn,
            precision=c.graph_precision,
        )
        geo = geometry.pairwise_point_sim(c.feat_h, c.feat_w, c.dist_alpha, c.dist_pow,
                                          device=attn.device)
        edges = graph_ops.instance_edges(
            slots, attn, geo, self.edge_attribute_weights,
            clamp_edge_attn=c.clamp_edge_attn, remove_self_loop=c.remove_self_loop,
            precision=c.graph_precision,
        )
        return {
            "instance_ingredients": slots.codes,
            "instance_vertices": vertices,
            "instance_edges": edges,
            "feat_mask": ~slots.mask,  # True = padding
            "num_slots": slots.num_slots,
        }


def trunc_normal_(t: torch.Tensor, std: float, lo: float, hi: float, g: torch.Generator
                  ) -> torch.Tensor:
    """Fill t with Normal(0, std) truncated to [lo*std, hi*std], by redrawing
    the entries outside from ``g``."""
    t.copy_(torch.randn(t.shape, generator=g) * std)
    while True:
        bad = (t < lo * std) | (t > hi * std)
        if not bad.any():
            return t
        t[bad] = torch.randn(int(bad.sum()), generator=g) * std


def trunc_normal_unit(shape, generator: torch.Generator) -> torch.Tensor:
    """The atlas weights' initialiser, the port's ``_trunc_normal_unit``:
    0.5 + Normal(0, 1/6) truncated to 3 std, clipped to [0, 1], then each
    row divided by its sum. fp32 on the CPU, drawn from ``generator``
    (``jax.random`` gives other numbers from the same seed)."""
    x = torch.clamp(0.5 + trunc_normal_(torch.empty(shape), 1 / 6, -3.0, 3.0, generator), 0, 1)
    s = x.sum(dim=-1, keepdim=True)
    return torch.where(s > 0, x / s, x)


@torch.no_grad()
def clamp_attribute_weights_(atlas: SchemaAtlas) -> None:
    """Clamp the vertex and edge attribute weights to [0.01, 10] in place
    (when ``clamp_weights``): the cheap half of the projection, which
    training runs before every step."""
    if atlas.cfg.clamp_weights:
        for w in (atlas.vertex_attribute_weights, atlas.edge_attribute_weights):
            w.clamp_(0.01, 10.0)


@torch.no_grad()
def _project_rows_(w: torch.Tensor, remove_self_loop: bool = False) -> None:
    """clamp-min 0 and row-sum normalise over the last axis in place, all-zero
    rows to 0; with ``remove_self_loop`` zero the diagonal of each [V, V]."""
    w.clamp_(min=0.0)
    w.copy_(zero_nans(w / w.sum(dim=-1, keepdim=True)))
    if remove_self_loop:
        w.diagonal(dim1=-2, dim2=-1).zero_()


@torch.no_grad()
def project_params_(params: Dict[str, torch.Tensor], cfg: AtlasConfig) -> Dict[str, torch.Tensor]:
    """The no-grad ``normalize()`` projection of
    ``schemanet_tpu.schema.atlas.project_atlas_params`` on a dict of the four
    atlas tensors, in place: clamp the attribute weights to [0.01, 10]
    (``clamp_weights``); clamp-min 0 and row-sum normalise the vertex and
    edge weights, zeroing the edge diagonals when ``remove_self_loop``
    (``apply_normalize``)."""
    if cfg.clamp_weights:
        for key in ("vertex_attribute_weights", "edge_attribute_weights"):
            params[key].clamp_(0.01, 10.0)
    if cfg.apply_normalize:
        _project_rows_(params["vertex_weights"])
        _project_rows_(params["edge_weights"], cfg.remove_self_loop)
    return params


def project_atlas_params(atlas: SchemaAtlas) -> SchemaAtlas:
    """``project_params_`` on the module's parameters, in place."""
    project_params_(dict(atlas.named_parameters()), atlas.cfg)
    return atlas
