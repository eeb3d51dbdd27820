"""Stage 3: IR-Atlas initialisation, two dataset passes (port of
``schemanet_tpu/pipeline/init_schema_net.py``).

Pass 1 averages each class's full-vocabulary vertex weights and keeps its
top ``V_max`` codes as the class's vertex set; pass 2 averages the
class-limited edges. Both add per-sample tensors into per-class
accumulators by label: here one one-hot product over the batch's distinct
labels, so the sums do not depend on the run (an ``index_add_`` on the card
adds duplicate labels with atomics in no fixed order).

Pass 2 accumulates from zeros, the intended average. ``accumulate_compat``
reproduces the reference's accumulation onto the random edge init
(``scripts/init_schema_net.py:19-40``): the accumulator starts from
``initial_edge_weights``, or from ``trunc_normal_unit`` drawn from
``generator`` (a CPU generator seeded with 0 when None; ``jax.random`` draws
other numbers for the same seed).

On a data-parallel grid (``mesh``) each rank runs both passes over its
slice of every batch (its loader built with ``process_index = data_index``)
and the per-label sums and counts are added over the data group once a
pass, ``all_reduce`` in a fixed order, so every rank holds the same atlas.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.loader import batch_to_device, prepare_images
from ..device import resolve_device
from ..ops import geometry, graph as graph_ops
from ..parallel.mesh import Mesh, all_reduce_
from ..schema.atlas import AtlasConfig, project_params_, trunc_normal_unit


def _add_by_label(acc: torch.Tensor, labels: torch.Tensor, values: torch.Tensor) -> None:
    """acc[labels[b]] += values[b] for every b, duplicates included: the
    values of each distinct label summed by one one-hot product."""
    uniq, inverse = torch.unique(labels, return_inverse=True)
    onehot = F.one_hot(inverse, len(uniq)).to(values.dtype).t()  # [U, bs]
    sums = onehot @ values.reshape(len(labels), -1)
    acc[uniq] += sums.reshape(len(uniq), *values.shape[1:])


def _batch(loader, batch, device: torch.device):
    """(images, labels, valid) of a loader batch on the device; uint8 images
    made ready by the loader's ``prepare``."""
    labels = torch.as_tensor(batch["label"]).to(device, torch.long)
    valid = batch.get("valid")
    valid = (torch.ones(len(labels)) if valid is None else torch.as_tensor(valid))
    moved = batch_to_device({k: batch[k] for k in batch if k not in ("label", "valid")}, device)
    image = prepare_images(loader, moved["image"], moved.get("crop"))
    return image, labels, valid.to(device, torch.float32)


def _attr_weights(c: AtlasConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    def attr(const):
        value = torch.full((2, 1), 0.5) if const is None else torch.tensor(const).reshape(2, 1)
        return value.float()

    return attr(c.constant_vertex_attr), attr(c.constant_edge_attr)


@torch.no_grad()
def init_atlas(
    predictor,  # (image) -> dict with ingredients [bs, L], attn [bs, L, L], attn_cls [bs, L]
    loader,
    atlas_cfg: AtlasConfig,
    attr_init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    accumulate_compat: bool = False,
    initial_edge_weights: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """``{"params": the four atlas tensors, "class_ingredients": [K, V_max]
    int32}``, projected as ``project_atlas_params`` leaves them, on
    ``device`` (CUDA unless the caller passes ``"cpu"``; the predictor must
    be there). ``loader`` is iterated twice; its ``set_epoch(1)`` is called
    before pass 2 when it has one. With a ``mesh``, on its device unless
    ``device`` is given, the loader giving this rank's data slice."""
    dev = resolve_device(mesh.device if mesh is not None and device is None else device)

    def reduce_(*accs):
        if mesh is not None:
            for a in accs:
                all_reduce_(a, mesh.data_group)
    c = atlas_cfg
    k, v_max, m = c.num_classes, c.v_max, c.num_vertices
    w_v, w_e = _attr_weights(c) if attr_init is None else attr_init
    w_v, w_e = w_v.to(dev, torch.float32), w_e.to(dev, torch.float32)
    geo = geometry.pairwise_point_sim(c.feat_h, c.feat_w, c.dist_alpha, c.dist_pow, device=dev)

    # pass 1: class vertex averages
    acc = torch.zeros(k, m, device=dev)
    counts = torch.zeros(k, device=dev)
    for batch in loader:
        image, labels, valid = _batch(loader, batch, dev)
        out = predictor(image)
        vertices = graph_ops.feat_to_full_vertices(
            out["ingredients"], out["attn_cls"], m, w_v, c.clamp_vertex_attn)  # [bs, M]
        _add_by_label(acc, labels, vertices * valid[:, None])
        _add_by_label(counts, labels, valid)
    reduce_(acc, counts)
    class_vertices = acc / torch.clamp(counts, min=1.0)[:, None]
    class_vertices = class_vertices / torch.clamp(class_vertices.sum(dim=-1, keepdim=True),
                                                  min=1e-12)
    # top V_max by a stable descending sort: among equal weights (every code
    # a class never saw is an exact 0) the lower code comes first, as in
    # jax.lax.top_k; torch.topk promises no order there
    init_weights, order = torch.sort(class_vertices, dim=-1, descending=True, stable=True)
    init_weights, class_ingredients = init_weights[:, :v_max].contiguous(), order[:, :v_max].int()
    del acc, class_vertices

    # pass 2: class-limited edge averages
    if accumulate_compat:
        if initial_edge_weights is None:
            g = torch.Generator().manual_seed(0) if generator is None else generator
            initial_edge_weights = trunc_normal_unit((k, v_max, v_max), g)
        if tuple(initial_edge_weights.shape) != (k, v_max, v_max):
            raise ValueError(f"initial_edge_weights must be {(k, v_max, v_max)}, got "
                             f"{tuple(initial_edge_weights.shape)}")
        acc_e = initial_edge_weights.to(dev, torch.float32).clone()
        if mesh is not None and mesh.data_index:  # the init counts once in the sum
            acc_e.zero_()
    else:
        acc_e = torch.zeros(k, v_max, v_max, device=dev)
    if hasattr(loader, "set_epoch"):
        loader.set_epoch(1)
    for batch in loader:
        image, labels, valid = _batch(loader, batch, dev)
        out = predictor(image)
        edges = graph_ops.class_limited_edges(
            out["ingredients"], out["attn"], geo, labels, class_ingredients, w_e,
            clamp_edge_attn=c.clamp_edge_attn, remove_self_loop=c.remove_self_loop,
        )  # [bs, V_max, V_max]
        _add_by_label(acc_e, labels, edges * valid[:, None, None])
    reduce_(acc_e)
    edge_weights = acc_e.div_(torch.clamp(counts, min=1.0)[:, None, None])

    params = {
        "vertex_weights": init_weights,
        "edge_weights": edge_weights,
        "vertex_attribute_weights": w_v.clone(),
        "edge_attribute_weights": w_e.clone(),
    }
    return {"params": project_params_(params, c), "class_ingredients": class_ingredients}
