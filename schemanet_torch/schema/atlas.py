"""IR-Atlas: per-class knowledge graphs and instance-graph building.

Port of ``schemanet_tpu/schema/atlas.py`` (serving half). Parameters:

* ``vertex_weights``  [K, V_max]
* ``edge_weights``    [K, V_max, V_max]
* ``vertex_attribute_weights`` / ``edge_attribute_weights``  [2, 1]

and the ``class_ingredients`` buffer [K, V_max] (global code id per class
slot; ``arange`` by default). The getters renormalise the fp32 parameters in
fp32 and emit the graph dtype (bf16 under ``graph_precision='default'``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import geometry, graph as graph_ops
from ..ops.normalize import normalize_sum_clamp


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

    def _out_dtype(self) -> torch.dtype:
        return graph_ops.graph_dtype(self.cfg.graph_precision)

    def get_class_vertices(self) -> torch.Tensor:
        return normalize_sum_clamp(self.vertex_weights, min_val=1e-5).to(self._out_dtype())

    def get_class_edges(self) -> torch.Tensor:
        c = self.cfg
        e = self.edge_weights
        if c.prune_node_threshold is not None:
            # zero every edge touching a vertex at or below the threshold
            keep = (self.get_class_vertices() > c.prune_node_threshold).to(e.dtype)  # [K, V]
            e = e * (keep[:, :, None] * keep[:, None, :])
        e = normalize_sum_clamp(e, min_val=0.0).to(self._out_dtype())
        if c.remove_self_loop:
            eye = torch.eye(e.shape[-1], dtype=torch.bool, device=e.device)[None]
            e = torch.where(eye, torch.zeros_like(e), e)
        return e

    def get_atlas(self) -> Dict[str, torch.Tensor]:
        return {
            "class_vertices": self.get_class_vertices(),
            "class_edges": self.get_class_edges(),
            "class_ingredients": self.class_ingredients,
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
