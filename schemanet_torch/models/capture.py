"""Features by name (port of ``schemanet_tpu/models/capture.py``).

The reference grabs intermediate activations with cv_lib's MidExtractor
(forward hooks matched by module name, ``scripts/extract_ingredients.py:88``).
Here the encoder returns them as probes of ``encode_until(capture=...)``;
``MidExtractor`` gives the same "features by name" interface, reference-style
module names translated to probe names (``module.transformer.layers.9`` ->
``layers_9.out``, ``...layers.9.attention.attn_raw_identity`` ->
``layers_9.attn_raw``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def translate_probe_name(name: str) -> str:
    """Reference hook-target name -> capture probe name."""
    name = name.removeprefix("module.").removeprefix("transformer.")
    parts = name.split(".")
    if parts[0] == "layers" and len(parts) >= 2 and parts[1].isdigit():
        layer, rest = parts[1], parts[2:]
        if not rest:
            return f"layers_{layer}.out"
        probe = {"attn_raw_identity": "attn_raw", "attn_identity": "attn",
                 "identity1": "resid1", "identity2": "resid2"}.get(rest[-1])
        if probe is not None:
            return f"layers_{layer}.{probe}"
    if name.startswith("layers_"):
        return name if "." in name else f"{name}.out"
    raise KeyError(f"cannot translate probe name {name!r}")


class MidExtractor:
    """``extractor(images) -> {name: activation}`` over a ViT/DeiT's frozen
    forward, through the deepest layer any name asks for (no final norm, no
    head)."""

    def __init__(self, model, extract_names: Sequence[str]):
        self.model = model
        self.extract_names = list(extract_names)
        self._probe_of = {n: translate_probe_name(n) for n in self.extract_names}
        self._capture = tuple(self._probe_of.values())
        self._end = 1 + max(int(p.split(".")[0].removeprefix("layers_")) for p in self._capture)
        self.features: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        _, captured = self.model.encode_until(images, end_layer=self._end, capture=self._capture)
        self.features = {name: captured[probe] for name, probe in self._probe_of.items()}
        return self.features
