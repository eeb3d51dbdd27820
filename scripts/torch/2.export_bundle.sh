#!/bin/sh
# Stage 2 of the port: export the frozen bundle (counterpart of
# scripts/2.export_bundle.sh); writes the port's bundle directory
# (manifest.json, backbone_params.pt, codebook.npy).
# usage: scripts/torch/2.export_bundle.sh <dataset> <model> <M> <num_classes> [max_features]
#        [extra cli args...]
# env:   RUN_DIR (default run/torch), DEVICE (default cuda), PYTHON (default python3)
set -e
cd "$(dirname "$0")/../.."
DS=${1:-cifar_100}; MODEL=${2:-deit_tiny}; M=${3:-1024}; K=${4:-100}; MAXF=${5:-1000000}
if [ $# -ge 5 ]; then shift 5; else shift $#; fi
R=${RUN_DIR:-run/torch}
I="${R}/${DS}/ingredient/${MODEL}-l9-M_${M}"
${PYTHON:-python3} -m schemanet_torch.cli export \
    --cfg "configs/${DS}/ingredient/${MODEL}-l9-M_${M}.yaml" \
    --ckpt "${R}/${DS}/vanilla/${MODEL}/ckpt/best" \
    --vocabulary-fp "${I}/cluster_${M}_from_${MAXF}.npy" \
    --save-path "${I}/bundle" --num-classes "${K}" --log-dir "${I}/export" \
    --device "${DEVICE:-cuda}" "$@"
