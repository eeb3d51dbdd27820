#!/bin/sh
# Stage 3 of the port: initialise the IR-Atlas (counterpart of
# scripts/3.init_schema_net.sh); writes the port's atlas init,
# <RUN_DIR>/<dataset>/schema_net/init_IR_atlas-<model>-l9-M_<M>.pt.
# usage: scripts/torch/3.init_schema_net.sh <dataset> <model> <M> [make_partial]
#        [extra cli args...]  (pass an empty make_partial to give extra args)
# env:   RUN_DIR (default run/torch), DEVICE (default cuda), PYTHON (default python3)
set -e
cd "$(dirname "$0")/../.."
DS=${1:-cifar_100}; MODEL=${2:-deit_tiny}; M=${3:-1024}; PARTIAL=${4:-}
if [ $# -ge 4 ]; then shift 4; else shift $#; fi
R=${RUN_DIR:-run/torch}
PART=""
[ -n "$PARTIAL" ] && PART="--make-partial $PARTIAL"
${PYTHON:-python3} -m schemanet_torch.cli init \
    --cfg "configs/${DS}/schema_net/${MODEL}-l9-M_${M}.yaml" \
    --save-fp "${R}/${DS}/schema_net/init_IR_atlas-${MODEL}-l9-M_${M}.pt" \
    -o "schema_net.bundle=${R}/${DS}/ingredient/${MODEL}-l9-M_${M}/bundle" \
    --log-dir "${R}/${DS}/schema_net/init-${MODEL}-l9-M_${M}" \
    --device "${DEVICE:-cuda}" $PART "$@"
