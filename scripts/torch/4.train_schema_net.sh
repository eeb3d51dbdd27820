#!/bin/sh
# Stage 4 of the port: train SchemaNet (counterpart of
# scripts/4.train_schema_net.sh); writes <RUN_DIR>/<dataset>/schema_net/
# <model>-l9-M_<M>/ckpt (best.pt, iter-<n>.pt, meta.json).
# usage: scripts/torch/4.train_schema_net.sh <dataset> <model> <M> [extra cli args...]
# env:   RUN_DIR (default run/torch), DEVICE (default cuda), PYTHON (default python3)
set -e
cd "$(dirname "$0")/../.."
DS=${1:-cifar_100}; MODEL=${2:-deit_tiny}; M=${3:-1024}
if [ $# -ge 3 ]; then shift 3; else shift $#; fi
R=${RUN_DIR:-run/torch}
${PYTHON:-python3} -m schemanet_torch.cli train --worker schema_net_worker \
    --cfg "configs/${DS}/schema_net/${MODEL}-l9-M_${M}.yaml" \
    --log-dir "${R}/${DS}/schema_net/${MODEL}-l9-M_${M}" \
    -o "schema_net.bundle=${R}/${DS}/ingredient/${MODEL}-l9-M_${M}/bundle" \
    -o "schema_net.initial_state_fp=${R}/${DS}/schema_net/init_IR_atlas-${MODEL}-l9-M_${M}.pt" \
    --device "${DEVICE:-cuda}" "$@"
