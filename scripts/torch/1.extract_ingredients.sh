#!/bin/sh
# Stage 1 of the port: extract the ingredient codebook (counterpart of
# scripts/1.extract_ingredients.sh); writes cluster_<M>_from_<max_features>
# .npy and .pth under <RUN_DIR>/<dataset>/ingredient/<model>-l9-M_<M>.
# usage: scripts/torch/1.extract_ingredients.sh <dataset> <model> <M> [max_features]
#        [extra cli args...]
# env:   RUN_DIR (default run/torch), DEVICE (default cuda), PYTHON (default python3)
set -e
cd "$(dirname "$0")/../.."
DS=${1:-cifar_100}; MODEL=${2:-deit_tiny}; M=${3:-1024}; MAXF=${4:-1000000}
if [ $# -ge 4 ]; then shift 4; else shift $#; fi
R=${RUN_DIR:-run/torch}
${PYTHON:-python3} -m schemanet_torch.cli extract \
    --cfg "configs/${DS}/ingredient/${MODEL}-l9-M_${M}.yaml" \
    --ckpt "${R}/${DS}/vanilla/${MODEL}/ckpt/best" \
    --save-path "${R}/${DS}/ingredient/${MODEL}-l9-M_${M}" \
    --max-features "${MAXF}" --log-dir "${R}/${DS}/ingredient/${MODEL}-l9-M_${M}" \
    --device "${DEVICE:-cuda}" "$@"
