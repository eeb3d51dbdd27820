#!/bin/sh
# The port's real-data parity kit (counterpart of tools/parity_run.sh): run
# one BASELINE.md config end to end (backbone fine-tune -> extract -> export
# -> init -> schema train -> eval) through scripts/torch/*.sh, asserting the
# port's artifact after every stage. See PARITY.md for the per-config
# matrix, weight filenames and acceptance criteria.
#
# usage:  sh tools/parity_run_torch.sh <1|2|3|4|5|dry>  [extra cli args...]
#   1  cifar_10      deit_tiny   M=128
#   2  cifar_100     deit_tiny   M=1024
#   3  caltech_101   deit_small  M=1024
#   4  mini_imagenet deit_small  M=1024
#   5  imagenet      deit_base   M=8000    (several GPUs: MESH_DATA=N)
#   dry  synthetic stand-in, tiny budget, on the CPU: validates the kit
#        itself with no data or weights on disk
# The extra cli args go to every stage (flags every subcommand takes: -o
# key=value, --seed, --mesh-data, ...); the dry mode's budget goes first.
#
# env:  WEIGHTS_DIR  (default weights/)    renamed-DeiT checkpoints, see PARITY.md
#       RUN_DIR      (default run/torch)   artifact root
#       MESH_DATA    (optional)            data-parallel axis for stages 0 and 4
#       DEVICE       (default cuda; cpu in the dry mode)
#       PYTHON       (default python3)
set -e
cd "$(dirname "$0")/.."
RUN_DIR=${RUN_DIR:-run/torch}
WEIGHTS_DIR=${WEIGHTS_DIR:-weights}
PY=${PYTHON:-python3}
export RUN_DIR  # the stage scripts root their artifact paths here too

case "$1" in
  1) DS=cifar_10;      MODEL=deit_tiny;  M=128;  K=10;   MAXF=1000000 ;;
  2) DS=cifar_100;     MODEL=deit_tiny;  M=1024; K=100;  MAXF=1000000 ;;
  3) DS=caltech_101;   MODEL=deit_small; M=1024; K=101;  MAXF=1000000 ;;
  4) DS=mini_imagenet; MODEL=deit_small; M=1024; K=100;  MAXF=1000000 ;;
  5) DS=imagenet;      MODEL=deit_base;  M=8000; K=1000; MAXF=50000000 ;;
  dry) DS=synthetic;   MODEL=deit_tiny;  M=128;  K=10;   MAXF=2048 ;;
  *) echo "usage: sh tools/parity_run_torch.sh <1|2|3|4|5|dry> [extra cli args...]"; exit 2 ;;
esac
shift
MESH=${MESH_DATA:+--mesh-data $MESH_DATA}

say()  { echo; echo "=== parity[$DS/$MODEL/M=$M] $* ==="; }
need() { [ -e "$1" ] || { echo "FAIL: expected artifact missing: $1"; exit 1; }; }

if [ "$DS" != "synthetic" ]; then
  # preflight: weights and dataset visible before burning hours (PARITY.md #2)
  W="$WEIGHTS_DIR/${MODEL}_patch16_224.pth"
  [ -f "$W" ] || { echo "FAIL: pretrained backbone missing: $W (PARITY.md #2)"; exit 1; }
  $PY - "$DS" <<'PREFLIGHT'
import os
import sys

sys.path.insert(0, os.getcwd())
from schemanet_torch.data.datasets import get_dataset
from schemanet_torch.utils.config import get_cfg, resolve_subconfig

base = f"configs/{sys.argv[1]}/vanilla"
cfg = get_cfg(os.path.join(base, sorted(os.listdir(base))[0]))
ds = get_dataset(resolve_subconfig(cfg["dataset"], os.path.abspath(base)), "train")
print(f"preflight ok: {len(ds)} train samples, {ds.num_classes} classes")
PREFLIGHT
fi

EXTRA=""
if [ "$DS" = "synthetic" ]; then
  # a tiny budget so the dry run finishes in minutes on the CPU; the CPU by
  # default (a busy GPU must not block validating the kit)
  export DEVICE=${DEVICE:-cpu}
  EXTRA="-o training.train_epochs=1 -o training.batch_size=8 \
         -o validation.batch_size=8 -o dataset.num_samples=256 \
         -o training.num_workers=1 -o validation.num_workers=1"
fi
I="$RUN_DIR/$DS/ingredient/$MODEL-l9-M_$M"
S="$RUN_DIR/$DS/schema_net"

say "stage 0: backbone fine-tune"
sh scripts/torch/0.train_backbone.sh "$DS" "$MODEL" $MESH $EXTRA "$@"
need "$RUN_DIR/$DS/vanilla/$MODEL/ckpt/best.pt"

say "stage 1: ingredient extraction (k-means codebook, M=$M)"
sh scripts/torch/1.extract_ingredients.sh "$DS" "$MODEL" "$M" "$MAXF" $EXTRA "$@"
need "$I/cluster_${M}_from_${MAXF}.npy"

say "stage 2: bundle export"
sh scripts/torch/2.export_bundle.sh "$DS" "$MODEL" "$M" "$K" "$MAXF" $EXTRA "$@"
need "$I/bundle/manifest.json"

say "stage 3: IR-Atlas init"
sh scripts/torch/3.init_schema_net.sh "$DS" "$MODEL" "$M" "" $EXTRA "$@"
need "$S/init_IR_atlas-$MODEL-l9-M_$M.pt"

say "stage 4: SchemaNet training"
sh scripts/torch/4.train_schema_net.sh "$DS" "$MODEL" "$M" $MESH $EXTRA "$@"
need "$S/$MODEL-l9-M_$M/ckpt/best.pt"

say "stage 5: eval worker (top-1 + CB agreement)"
$PY -m schemanet_torch.cli train --worker eval_worker \
    --cfg "configs/$DS/schema_net/$MODEL-l9-M_$M.yaml" \
    --log-dir "$RUN_DIR/$DS/eval/$MODEL-l9-M_$M" \
    --resume "$S/$MODEL-l9-M_$M/ckpt/best" \
    -o "schema_net.bundle=$I/bundle" \
    -o "schema_net.initial_state_fp=$S/init_IR_atlas-$MODEL-l9-M_$M.pt" \
    --device "${DEVICE:-cuda}" $EXTRA "$@"

say "DONE — compare the logged top-1 against the reference run (PARITY.md #4)"
