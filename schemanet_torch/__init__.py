"""SchemaNet in PyTorch for NVIDIA Hopper (H100).

The port of ``schemanet_tpu`` (the JAX reference, which stays beside it).
Module paths and public names follow the JAX package so that each port module
has an obvious counterpart; inside, the code is plain PyTorch (``nn.Module``s,
explicit devices and ``torch.Generator``s). The kernels that the JAX package
wrote in Pallas for the TPU are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built at first use (``ops/kernels/_build.py``).

Entry points: ``ServePredictor`` (serving), ``train.Trainer`` with a
SchemaNet predictor (stage 4) and ``train.backbone_trainer`` (stage 0,
fine-tuning the ViT/DeiT backbone). They run on CUDA unless the caller
passes ``device="cpu"``.

This package never imports JAX, Flax, Optax, Orbax or ``schemanet_tpu``.
"""

from .schema.predictor import SchemaNetPredictor, build_predictor
from .serve import ServePredictor

__all__ = ["SchemaNetPredictor", "ServePredictor", "build_predictor"]
