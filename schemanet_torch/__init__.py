"""SchemaNet in PyTorch for NVIDIA Hopper (H100).

The port of ``schemanet_tpu`` (the JAX reference, which stays beside it).
Module paths and public names follow the JAX package so that each port module
has an obvious counterpart; inside, the code is plain PyTorch (``nn.Module``s,
explicit devices and ``torch.Generator``s). The kernels that the JAX package
wrote in Pallas for the TPU are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built at first use (``ops/kernels/_build.py``).

Entry points: ``ServePredictor`` (serving), ``train.backbone_trainer``
(stage 0, fine-tuning the ViT/DeiT backbone), ``pipeline.extract_stage``
(stage 1, the codebook), ``pipeline.init_stage`` (stage 3, the IR-Atlas
init) and ``train.schema_net_trainer`` or ``train.Trainer`` with a SchemaNet
predictor (stage 4); ``load_serve_predictor`` assembles a server from the
files the stages write, and ``python -m schemanet_torch.cli`` runs every
stage from the command line (``--device cpu`` for the CPU). They run on CUDA
unless the caller passes ``device="cpu"``. On several GPUs
``parallel.make_mesh`` gives the grid of ``torch.distributed`` ranks that
``Trainer(mesh=...)``, the workers and stages 1 and 3 run on.

This package never imports JAX, Flax, Optax, Orbax or ``schemanet_tpu``.
"""

from .schema.predictor import SchemaNetPredictor, build_predictor
from .serve import ServePredictor, load_serve_predictor
from .utils import (apply_overrides, get_cfg, make_deterministic, parse_override_strings,
                    resolve_subconfig)

__all__ = [
    "SchemaNetPredictor",
    "ServePredictor",
    "apply_overrides",
    "build_predictor",
    "get_cfg",
    "load_serve_predictor",
    "make_deterministic",
    "parse_override_strings",
    "resolve_subconfig",
]
