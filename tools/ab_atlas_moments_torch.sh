#!/bin/sh
# Accuracy gate of the port's low-memory atlas Adam moments (counterpart of
# tools/ab_atlas_moments.sh, with its recipe unchanged): stage-4 SchemaNet
# training with fp32 AdamW (the graph-precision gate's `default` arm) against
# bf16 moments (through the adamw_project_rows kernel) and factored second
# moments (nu_factored_min_size=64: the plain update and project_rows_),
# routed through the schema_net parameter group. Reuses the stage 0-3
# artifacts of a tools/ab_graph_precision_torch.sh run under the same AB_RUN,
# so only the two extra stage-4 arms run. PASS (tools/ab_verdict_torch.py):
# |bf16 - fp32| <= 0.005 top-1 and fp32 at least 0.10; the factored arm is
# reported, not gated. Exits 1 when a rule fails, 2 when a stage fails or an
# artifact is missing.
#
# usage: AB_RUN=run/ab_gp_torch sh tools/ab_atlas_moments_torch.sh
# env:   AB_RUN (default run/ab_gp_torch), AB_K, AB_EPOCHS as the JAX gate's;
#        AB_DEVICE (default cuda), AB_EXTRA (-o overrides for every stage,
#        before the gate's own), PYTHON (default python3)
set -e
cd "$(dirname "$0")/.."
RUN=${AB_RUN:-run/ab_gp_torch}
SEED=0
K=${AB_K:-100}
EPOCHS=${AB_EPOCHS:-3}
PY=${PYTHON:-python3}

[ -d "$RUN/ingredient/bundle" ] || { echo "no artifacts under $RUN (run tools/ab_graph_precision_torch.sh first)"; exit 2; }
[ -f "$RUN/schema_default.stdout" ] || { echo "no fp32 baseline under $RUN (run tools/ab_graph_precision_torch.sh first)"; exit 2; }

need () { [ -e "$1" ] || { echo "FAIL: expected artifact missing: $1"; exit 2; }; }
run_arm () {  # $1 = arm name, remaining args = extra -o overrides
  ARM=$1; shift
  echo "== stage 4: SchemaNet training (moments=$ARM, $EPOCHS epochs) =="
  T0=$(date +%s.%N)
  RC=0
  $PY -m schemanet_torch.cli train --worker schema_net_worker \
    --cfg configs/synthetic/schema_net/deit_tiny-l9-M_128.yaml \
    --log-dir $RUN/schema_mom_$ARM --seed $SEED --device "${AB_DEVICE:-cuda}" $AB_EXTRA \
    -o dataset.num_classes=$K \
    -o schema_net.bundle=$RUN/ingredient/bundle \
    -o schema_net.initial_state_fp=$RUN/init_IR_atlas.pt \
    -o training.train_epochs=$EPOCHS \
    "$@" > $RUN/schema_mom_$ARM.stdout 2>&1 || RC=$?
  echo "schema_mom_$ARM $RC $T0 $(date +%s.%N)" >> "$RUN/stages.txt"
  cat $RUN/schema_mom_$ARM.stdout
  [ $RC -eq 0 ] || { echo "FAIL: stage schema_mom_$ARM exited $RC"; exit 2; }
  need $RUN/schema_mom_$ARM/ckpt/best.pt
}

run_arm bf16 \
  -o training.param_groups.0.cfg.moment_dtype=bfloat16 \
  -o training.param_groups.0.cfg.nu_dtype=bfloat16
run_arm factored \
  -o training.param_groups.0.cfg.moment_dtype=bfloat16 \
  -o training.param_groups.0.cfg.nu_dtype=bfloat16 \
  -o training.param_groups.0.cfg.nu_factored_min_size=64

echo "== A/B result (fp32 baseline = the graph-precision gate's default arm) =="
$PY tools/ab_verdict_torch.py --gate atlas_moments --run $RUN \
  --baseline fp32=$RUN/schema_default.stdout --gated bf16=$RUN/schema_mom_bf16.stdout \
  --reported factored=$RUN/schema_mom_factored.stdout
