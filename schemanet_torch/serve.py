"""Batched inference and interpretability for SchemaNet predictors (port of
``schemanet_tpu/serve.py``).

Images of any count are split into fixed-size microbatches; the last one is
padded by repeating its final image, so every call runs one shape. Serving
pools each instance graph by its own live-slot count (``per_sample_pooling``,
passed to every forward call): the reference's bs=1 semantics, which makes
the logits of an image independent of the images it shares a microbatch
with. The caller's model keeps its own pooling for training. The W8A8
backbone (``quant_int8``, or the predictor's ``cfg.quant_backbone``) is
passed the same way, as an argument of each call.

``explain`` returns, per image, the ingredient map [H, W], the instance graph
and the class-attribution maps ``attribution[b, k, h, w]`` = the atlas
vertex weight of the token's code in class k (0 where the code is not among
class k's vertices), which the reference's ``SchemaNetPredictor`` docstring
promises and never computes (``graph/__init__.py:19-24``). They come from a
``[K, M+1]`` code-weight table and a gather by the tokens' codes, never from
the literal ``[bs, K, L, V_max]`` match tensor (~25 GB at ImageNet serving).

``load_serve_predictor`` assembles a server from the port's bundle and a
checkpoint of its ``schema_net_worker``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .schema.predictor import SchemaNetPredictor

Images = Union[np.ndarray, torch.Tensor]
# explain's outputs, in the JAX package's order
EXPLAIN_KEYS = ("pred", "ingredients", "attribution", "instance_vertices", "instance_edges",
                "instance_ingredients", "attn_cls")


def code_weight_table(class_vertices: torch.Tensor, class_ingredients: torch.Tensor,
                      num_codes: int) -> torch.Tensor:
    """[K, M+1] fp32: entry (k, c) sums class k's vertex weights over its
    slots whose code is c (column M takes the padded slots). Duplicate codes
    add. On the card ``scatter_add_`` adds a column's values in no fixed
    order, which changes no bit while a column takes at most two (0 + a + b
    and 0 + b + a are the same sum); only the padding column M, which no
    token reads, takes more."""
    k = class_vertices.shape[0]
    table = torch.zeros(k, num_codes + 1, dtype=torch.float32, device=class_vertices.device)
    return table.scatter_add_(1, class_ingredients.long(), class_vertices.float())


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class ServePredictor:
    """Serves ``predictor`` on ``device``: CUDA unless the caller passes
    ``device="cpu"``; without a GPU the default raises. ``quant_int8`` runs
    the frozen backbone's W8A8 route (``ops/quant.py``: int8 projections on
    the ``quantize_rows`` and ``int8_gemm`` kernels), as does a predictor
    whose ``cfg.quant_backbone`` is set.

    The model is moved to the serving device in place (``Module.to`` moves
    the caller's module). Nothing else of it changes: its config, its
    matcher's pooling and its training mode stay as they were, since the
    predictor's forward does not depend on the mode, and the per-sample
    pooling and the int8 route are arguments of each call."""

    def __init__(self, predictor: SchemaNetPredictor, microbatch: int = 64, device=None,
                 quant_int8: bool = False):
        self.microbatch = microbatch
        self.device = resolve_device(device)
        self.predictor = predictor.to(self.device)
        self.quant = bool(quant_int8 or predictor.cfg.quant_backbone)

    def _microbatches(self, images: torch.Tensor) -> Iterator[Tuple[torch.Tensor, int]]:
        mb = self.microbatch
        for start in range(0, images.shape[0], mb):
            chunk = images[start : start + mb]
            pad = mb - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk[-1:].expand(pad, *chunk.shape[1:])])
            yield chunk, mb - pad

    def _as_tensor(self, images: Images) -> torch.Tensor:
        images = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        return images.to(self.device, torch.float32)

    @torch.no_grad()
    def predict_tensor(self, images: torch.Tensor) -> torch.Tensor:
        """images [n, H, W, C] float (normalised), on any device -> logits
        [n, K] on the serving device."""
        images = images.to(self.device, torch.float32)
        outs = [self.predictor(chunk, per_sample_pooling=True, quant=self.quant)["pred"][:n_valid]
                for chunk, n_valid in self._microbatches(images)]
        return torch.cat(outs)

    def predict(self, images: Images) -> np.ndarray:
        """images [n, H, W, C] float32 (normalised) -> logits [n, K] (fp32 numpy)."""
        return self.predict_tensor(self._as_tensor(images)).float().cpu().numpy()

    def predict_labels(self, images: Images) -> np.ndarray:
        return self.predict(images).argmax(-1)

    @torch.no_grad()
    def _explain_microbatch(self, chunk: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.predictor(chunk, per_sample_pooling=True, requires_graph=True,
                             quant=self.quant)
        c = self.predictor.cfg.atlas
        ingredients = out["ingredients"]  # [bs, L]
        table = code_weight_table(out["class_vertices"], out["class_ingredients"],
                                  self.predictor.num_codes)
        bs, k = ingredients.shape[0], table.shape[0]
        # [K, bs * L] gathered by the tokens' codes, then [bs, K, H, W]
        attribution = table.index_select(1, ingredients.reshape(-1).long())
        attribution = attribution.reshape(k, bs, c.feat_h, c.feat_w).transpose(0, 1)
        return {
            "pred": out["pred"],
            "ingredients": ingredients.reshape(bs, c.feat_h, c.feat_w),
            "attribution": attribution.contiguous(),
            "instance_vertices": out["instance_vertices"],
            "instance_edges": out["instance_edges"],
            "instance_ingredients": out["instance_ingredients"],
            "attn_cls": out["attn_cls"],
        }

    def explain_tensor(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Interpretability outputs of images [n, H, W, C] (normalised), on
        the serving device, with the microbatching and per-sample pooling of
        ``predict_tensor`` (so ``pred`` has ``predict_tensor``'s bits):
        ``pred`` [n, K], ``ingredients`` [n, H, W], ``attribution``
        [n, K, H, W] fp32, ``instance_vertices`` [n, L],
        ``instance_edges`` [n, L, L], ``instance_ingredients`` [n, L] (slot
        codes, M for a padded slot), ``attn_cls`` [n, L]."""
        images = images.to(self.device, torch.float32)
        outs: Dict[str, list] = {key: [] for key in EXPLAIN_KEYS}
        for chunk, n_valid in self._microbatches(images):
            for key, value in self._explain_microbatch(chunk).items():
                outs[key].append(value[:n_valid])
        return {key: torch.cat(values) for key, values in outs.items()}

    def explain(self, images: Images) -> Dict[str, np.ndarray]:
        """``explain_tensor`` as numpy arrays (bf16 tensors as fp32)."""
        return {k: _numpy(v) for k, v in self.explain_tensor(self._as_tensor(images)).items()}

    def explain_networkx(self, images: Images, sample: int = 0, **kwargs):
        """Instance graph of one sample as a NetworkX graph (code-id nodes);
        ``kwargs`` go to ``schema.convert_graph.to_networkx``
        (``edge_threshold`` and ``node_threshold`` default to 0)."""
        import networkx as nx

        from .schema.convert_graph import to_networkx

        res = self.explain(images)
        codes = res["instance_ingredients"][sample]
        n = int((codes < self.predictor.num_codes).sum())
        g = to_networkx(
            res["instance_vertices"][sample][:n],
            res["instance_edges"][sample][:n, :n],
            kwargs.pop("edge_threshold", 0.0),
            kwargs.pop("node_threshold", 0.0),
            **kwargs,
        )
        return nx.relabel_nodes(g, {i: int(codes[i]) for i in g.nodes})


def load_serve_predictor(
    bundle_path: str,
    schema_cfg: Dict[str, Any],
    ckpt_path: str,
    num_classes: int,
    microbatch: int = 64,
    device=None,
    dtype: torch.dtype = torch.float32,
    quant_int8: bool = False,
) -> ServePredictor:
    """A ``ServePredictor`` from the port's bundle (``pipeline/bundle.py``)
    and a checkpoint of the trained predictor (``train/common.py``
    ``checkpoint_file``: a ``<tag>.pt`` file, a tag's path or a checkpoint
    directory), which sets every parameter and buffer. ``dtype`` is the
    compute dtype; ``device`` is CUDA unless the caller passes "cpu";
    ``quant_int8`` serves the W8A8 backbone."""
    from .pipeline.bundle import load_bundle
    from .schema.predictor import build_predictor
    from .train.common import restore_model_state

    bundle = load_bundle(bundle_path)
    m, d = bundle.codebook.shape
    predictor = build_predictor(bundle.model_cfg, schema_cfg, num_classes, m, d,
                                bundle.encode_layer, dtype=dtype)
    predictor.load_state_dict(restore_model_state(ckpt_path))
    return ServePredictor(predictor, microbatch=microbatch, device=device, quant_int8=quant_int8)
