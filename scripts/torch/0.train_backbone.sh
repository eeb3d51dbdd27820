#!/bin/sh
# Stage 0b of the port: fine-tune the backbone (counterpart of
# scripts/0.train_backbone.sh); writes <RUN_DIR>/<dataset>/vanilla/<model>/ckpt
# (best.pt, iter-<n>.pt, meta.json).
# usage: scripts/torch/0.train_backbone.sh <dataset> [model] [extra cli args...]
# env:   RUN_DIR (default run/torch), DEVICE (default cuda; cpu for the CPU),
#        PYTHON (default python3)
set -e
cd "$(dirname "$0")/../.."
DS=${1:-cifar_100}; MODEL=${2:-deit_tiny}
if [ $# -ge 2 ]; then shift 2; else shift $#; fi
R=${RUN_DIR:-run/torch}
${PYTHON:-python3} -m schemanet_torch.cli train --worker backbone_worker \
    --cfg "configs/${DS}/vanilla/${MODEL}.yaml" \
    --log-dir "${R}/${DS}/vanilla/${MODEL}" --device "${DEVICE:-cuda}" "$@"
