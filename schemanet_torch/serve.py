"""Batched inference for SchemaNet predictors (port of ``ServePredictor.predict``
in ``schemanet_tpu/serve.py``).

Images of any count are split into fixed-size microbatches; the last one is
padded by repeating its final image, so every call runs one shape. Serving
pools each instance graph by its own live-slot count (``per_sample_pooling``,
passed to every forward call): the reference's bs=1 semantics, which makes
the logits of an image independent of the images it shares a microbatch
with. The caller's model keeps its own pooling for training.
"""

from __future__ import annotations

from typing import Iterator, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .schema.predictor import SchemaNetPredictor

Images = Union[np.ndarray, torch.Tensor]


class ServePredictor:
    """Serves ``predictor`` on ``device``: CUDA unless the caller passes
    ``device="cpu"``; without a GPU the default raises.

    The model is moved to the serving device in place (``Module.to`` moves
    the caller's module). Nothing else of it changes: its config, its
    matcher's pooling and its training mode stay as they were, since the
    predictor's forward does not depend on the mode and the per-sample pooling
    is an argument of each call."""

    def __init__(self, predictor: SchemaNetPredictor, microbatch: int = 64, device=None):
        self.microbatch = microbatch
        self.device = resolve_device(device)
        self.predictor = predictor.to(self.device)

    def _microbatches(self, images: torch.Tensor) -> Iterator[Tuple[torch.Tensor, int]]:
        mb = self.microbatch
        for start in range(0, images.shape[0], mb):
            chunk = images[start : start + mb]
            pad = mb - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk[-1:].expand(pad, *chunk.shape[1:])])
            yield chunk, mb - pad

    @torch.no_grad()
    def predict_tensor(self, images: torch.Tensor) -> torch.Tensor:
        """images [n, H, W, C] float (normalised), on any device -> logits
        [n, K] on the serving device."""
        images = images.to(self.device, torch.float32)
        outs = [self.predictor(chunk, per_sample_pooling=True)["pred"][:n_valid]
                for chunk, n_valid in self._microbatches(images)]
        return torch.cat(outs)

    def predict(self, images: Images) -> np.ndarray:
        """images [n, H, W, C] float32 (normalised) -> logits [n, K] (fp32 numpy)."""
        images = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        return self.predict_tensor(images).float().cpu().numpy()

    def predict_labels(self, images: Images) -> np.ndarray:
        return self.predict(images).argmax(-1)
