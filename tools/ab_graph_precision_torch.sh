#!/bin/sh
# Accuracy gate of the port's bf16 training default (counterpart of
# tools/ab_graph_precision.sh, with its recipe unchanged):
# schema_net.ir_atlas.graph_precision 'default' (bf16 graph tensors, the
# GraphConv and LayerNorm kernels in bf16, the training default of
# schemanet_torch/train/workers.py) against 'highest' (fp32). Same seed, same
# artifacts, CIFAR-100-scale synthetic data (K=100, M=1024): stage 0 from
# scratch on configs/synthetic/vanilla/deit_tiny.yaml (its pre_train file is
# absent), stage 1 (400,000 features, batch 256, bf16), export, init, then
# stage 4 on configs/synthetic/schema_net/deit_tiny-l9-M_128.yaml (batch 64,
# 3 epochs: 96 steps an arm), and eval_worker on the 'default' arm's best
# checkpoint. PASS (tools/ab_verdict_torch.py): |default - highest| <= 0.005
# top-1, 'default' at least 0.10 top-1, eval_worker's counts equal to the
# 'default' arm's final eval. Exits 1 when a rule fails, 2 when a stage fails
# or an artifact is missing.
#
# usage: sh tools/ab_graph_precision_torch.sh   (on the GPU; every stage runs
#        python3 -m schemanet_torch.cli)
# env:   AB_RUN (default run/ab_gp_torch), AB_K, AB_M, AB_MAXF, AB_EPOCHS,
#        AB_BS as the JAX gate's; AB_ONLY_DEFAULT=1 stops after the 'default'
#        arm; AB_DEVICE (default cuda; cpu for a toy run), AB_EXTRA (-o
#        overrides for every stage, before the gate's own: a toy run's sizes),
#        PYTHON (default python3)
set -e
cd "$(dirname "$0")/.."
RUN=${AB_RUN:-run/ab_gp_torch}
SEED=0
K=${AB_K:-100}
M=${AB_M:-1024}
MAXF=${AB_MAXF:-400000}
EPOCHS=${AB_EPOCHS:-3}
BS=${AB_BS:-256}
PY=${PYTHON:-python3}
mkdir -p "$RUN"
: > "$RUN/stages.txt"

need () { [ -e "$1" ] || { echo "FAIL: expected artifact missing: $1"; exit 2; }; }
stage () {  # $1 = stage name: its output to $RUN/<name>.stdout, exit code and times to stages.txt
  NAME=$1; shift
  T0=$(date +%s.%N)
  RC=0
  $PY -m schemanet_torch.cli "$@" --seed $SEED --device "${AB_DEVICE:-cuda}" \
    > "$RUN/$NAME.stdout" 2>&1 || RC=$?
  echo "$NAME $RC $T0 $(date +%s.%N)" >> "$RUN/stages.txt"
  cat "$RUN/$NAME.stdout"
  [ $RC -eq 0 ] || { echo "FAIL: stage $NAME exited $RC"; exit 2; }
}

echo "== stage 0: backbone fine-tune ($EPOCHS epochs, scratch) =="
stage vanilla train --worker backbone_worker \
  --cfg configs/synthetic/vanilla/deit_tiny.yaml --log-dir $RUN/vanilla $AB_EXTRA \
  -o dataset.num_classes=$K -o training.train_epochs=$EPOCHS \
  -o training.val_interval=100000 -o training.batch_size=$BS
need $RUN/vanilla/ckpt/best.pt

echo "== stage 1: codebook extraction =="
stage extract extract \
  --cfg configs/synthetic/ingredient/deit_tiny-l9-M_128.yaml \
  --ckpt $RUN/vanilla/ckpt/best --save-path $RUN/ingredient --log-dir $RUN/extract \
  --max-features $MAXF --batch-size $BS --dtype bfloat16 $AB_EXTRA \
  -o dataset.num_classes=$K -o discretization.vocabulary.size=$M
need $RUN/ingredient/cluster_${M}_from_${MAXF}.npy

echo "== stage 2: bundle export =="
stage export export \
  --cfg configs/synthetic/ingredient/deit_tiny-l9-M_128.yaml \
  --ckpt $RUN/vanilla/ckpt/best \
  --vocabulary-fp $RUN/ingredient/cluster_${M}_from_${MAXF}.npy \
  --save-path $RUN/ingredient/bundle --num-classes $K --log-dir $RUN/export $AB_EXTRA \
  -o dataset.num_classes=$K -o discretization.vocabulary.size=$M
need $RUN/ingredient/bundle/manifest.json

echo "== stage 3: IR-Atlas init =="
stage init init \
  --cfg configs/synthetic/schema_net/deit_tiny-l9-M_128.yaml \
  --save-fp $RUN/init_IR_atlas.pt --batch-size $BS --log-dir $RUN/init $AB_EXTRA \
  -o dataset.num_classes=$K -o schema_net.bundle=$RUN/ingredient/bundle
need $RUN/init_IR_atlas.pt

# AB_ONLY_DEFAULT=1: stop after the `default` arm: enough to (re)build the
# stage 0-3 artifacts and the fp32-moments baseline that
# ab_atlas_moments_torch.sh compares against
ARMS="default highest"
[ -n "$AB_ONLY_DEFAULT" ] && ARMS="default"
for P in $ARMS; do
  echo "== stage 4: SchemaNet training (graph_precision=$P, $EPOCHS epochs) =="
  stage schema_$P train --worker schema_net_worker \
    --cfg configs/synthetic/schema_net/deit_tiny-l9-M_128.yaml \
    --log-dir $RUN/schema_$P $AB_EXTRA \
    -o dataset.num_classes=$K \
    -o schema_net.bundle=$RUN/ingredient/bundle \
    -o schema_net.initial_state_fp=$RUN/init_IR_atlas.pt \
    -o schema_net.ir_atlas.graph_precision=$P \
    -o training.train_epochs=$EPOCHS
  need $RUN/schema_$P/ckpt/best.pt
done

echo "== stage 5: eval worker on the default arm's best checkpoint =="
stage eval_default train --worker eval_worker \
  --cfg configs/synthetic/schema_net/deit_tiny-l9-M_128.yaml \
  --log-dir $RUN/eval_default --resume $RUN/schema_default/ckpt/best $AB_EXTRA \
  -o dataset.num_classes=$K \
  -o schema_net.bundle=$RUN/ingredient/bundle \
  -o schema_net.initial_state_fp=$RUN/init_IR_atlas.pt \
  -o schema_net.ir_atlas.graph_precision=default

echo "== A/B result =="
GATED=""
[ -z "$AB_ONLY_DEFAULT" ] && GATED="--gated highest=$RUN/schema_highest.stdout"
$PY tools/ab_verdict_torch.py --gate graph_precision --run $RUN \
  --baseline default=$RUN/schema_default.stdout $GATED --eval $RUN/eval_default.stdout
