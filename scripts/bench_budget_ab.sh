#!/usr/bin/env bash
# Budget-variance A/B on the GPU: fixed-scan decode vs the continuous
# (in-flight) pool when requests carry their OWN max_new_tokens drawn
# uniform [8, 64] (seeded). This is the workload continuous batching exists
# for: the fixed path decodes every batch to ~max(batch budgets) ≈ 64 steps,
# the pool frees each slot at its own budget (mean ≈ 36). The variance-free
# A/B is scripts/bench_continuous_ab.sh; this run has variance present. A
# same-session fixed no-spread anchor keeps the comparison inside one call.
#
# Usage: bash scripts/bench_budget_ab.sh [out_log]
set -u
cd "$(dirname "$0")/.."
OUT="${1:-/tmp/bench_budget_ab.log}"

run() {
  local label="$1"; shift
  echo "=== $label ===" | tee -a "$OUT"
  env BENCH_CONFIG=squad BENCH_MNT=64 BENCH_BATCHES=20 \
      PREFIX_CACHE_MB=4000 PREFIX_CACHE_DTYPE=int8 PREFIX_POOL_LEN=512 \
      PROMPT_LEN_BUCKETS=192,256,384,448,512,640,1024 \
      ENCODE_LEN_BUCKETS=32,64 WARMUP_FULL=1 WARMUP_OVERFLOW_CAP=1024 \
      "$@" python bench.py 2>> "$OUT" | tee -a "$OUT"
}

# 1) same-session anchor: fixed, no spread (comparable to the r4 mnt64 row)
run "fixed mnt64 (anchor)"   DECODE_MODE=fixed
# 2) fixed under budget variance: batches still pay ~max(batch) = ~64 steps
run "fixed mnt64 bud8-64"    DECODE_MODE=fixed BENCH_BUDGET_SPREAD=8,64
# 3) continuous under the same variance: slots free at their own budgets
run "continuous mnt64 bud8-64" DECODE_MODE=continuous DECODE_WINDOW=704 \
                               DECODE_SLOTS=64 DECODE_CHUNK=8 \
                               BENCH_BUDGET_SPREAD=8,64

echo "done; log: $OUT"
