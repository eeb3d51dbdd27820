#!/bin/sh
# Stage 0a of the port (counterpart of scripts/0.build.sh): build the CUDA
# kernel library ahead of time (schemanet_torch/_build/libschemanet_kernels_
# <hash>.so; every process otherwise builds it at its first kernel launch,
# and later ones load it). Needs nvcc (the CUDA toolkit).
# usage: scripts/torch/0.build.sh
# env:   PYTHON (default python3)
set -e
cd "$(dirname "$0")/../.."
${PYTHON:-python3} -c "from schemanet_torch.ops.kernels import _build; _build.library(); \
print('built', _build.library_path())"
