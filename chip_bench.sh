#!/bin/bash
# Every bench module of merv_tpu_torch/bench/ at its defaults on the card, one at a time, ROUNDS times (2 by
# default) for a spread: the readings PERF.md keeps.
#
#   bash chip_bench.sh [ROUNDS]
#
# decode (bf16, then BENCH_INT8=1 BENCH_INT8_KV=1), train, serving, breakdown, tower_attn over all five
# implementations, tower_ops, loader and vidlm_prefix (which writes runs/merv-full-randinit first and deletes it
# at the end). Each run's output goes to chiprun_out/bench/<label><round>.log; the card's name and power limit
# and every result line are printed at the end.
set -u
rounds=${1:-2}
mkdir -p chiprun_out/bench
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee chiprun_out/bench/nvidia_smi.txt
run() {  # label, then the command
  local label=$1; shift
  local t0=$SECONDS
  "$@" > "chiprun_out/bench/$label.log" 2>&1
  echo "$label rc $? $((SECONDS - t0)) s"
}
for r in $(seq 1 "$rounds"); do
  run decode_bf16_$r python3 -m merv_tpu_torch.bench.decode
  run decode_int8_$r env BENCH_INT8=1 BENCH_INT8_KV=1 python3 -m merv_tpu_torch.bench.decode
  run train_$r python3 -m merv_tpu_torch.bench.train
  run serving_$r python3 -m merv_tpu_torch.bench.serving
  run breakdown_$r python3 -m merv_tpu_torch.bench.breakdown
  run tower_attn_$r python3 -m merv_tpu_torch.bench.tower_attn --impls small,xla_kt,xla,fused_block,default
  run tower_ops_$r python3 -m merv_tpu_torch.bench.tower_ops
  run loader_$r python3 -m merv_tpu_torch.bench.loader
  run vidlm_prefix_$r python3 -m merv_tpu_torch.bench.vidlm_prefix
done
rm -rf runs/merv-full-randinit eval_result/merv-full-randinit
for f in chiprun_out/bench/*.log; do
  echo "== $f"
  grep -E '^\{' "$f" | tail -1 | cut -c1-1500
done
