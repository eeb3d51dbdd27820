"""Batched inference for SchemaNet predictors (port of ``ServePredictor.predict``
in ``schemanet_tpu/serve.py``).

Images of any count are split into fixed-size microbatches; the last one is
padded by repeating its final image, so every call runs one shape. The served
model pools each instance graph by its own live-slot count
(``per_sample_pooling``): the reference's bs=1 semantics, which makes the
logits of an image independent of the images it shares a microbatch with.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple, Union

import numpy as np
import torch

from .schema.predictor import SchemaNetPredictor

Images = Union[np.ndarray, torch.Tensor]


class ServePredictor:
    def __init__(self, predictor: SchemaNetPredictor, microbatch: int = 64, device=None):
        self.microbatch = microbatch
        self.device = torch.device(device) if device is not None else next(
            predictor.parameters()
        ).device
        predictor.matcher.per_sample_pooling = True
        predictor.cfg = dataclasses.replace(predictor.cfg, per_sample_pooling=True)
        self.predictor = predictor.to(self.device).eval()

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
        outs = [self.predictor(chunk)["pred"][:n_valid] for chunk, n_valid in
                self._microbatches(images)]
        return torch.cat(outs)

    def predict(self, images: Images) -> np.ndarray:
        """images [n, H, W, C] float32 (normalised) -> logits [n, K] (fp32 numpy)."""
        images = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        return self.predict_tensor(images).float().cpu().numpy()

    def predict_labels(self, images: Images) -> np.ndarray:
        return self.predict(images).argmax(-1)
