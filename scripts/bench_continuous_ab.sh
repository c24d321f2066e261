#!/usr/bin/env bash
# Decode-heavy A/B on the GPU: fixed-scan decode vs the continuous
# (in-flight) batching pool at MAX_NEW_TOKENS=64 on the squad_real serving
# config. Adds a same-session fixed rerun so drift between runs can't fake
# a win; device proxies anchor the comparison.
#
# Usage: bash scripts/bench_continuous_ab.sh [out_log]
set -u
cd "$(dirname "$0")/.."
OUT="${1:-/tmp/bench_cont_ab.log}"

run() {
  local label="$1"; shift
  echo "=== $label ===" | tee -a "$OUT"
  env BENCH_CONFIG=squad BENCH_MNT=64 BENCH_BATCHES=20 \
      PREFIX_CACHE_MB=4000 PREFIX_CACHE_DTYPE=int8 PREFIX_POOL_LEN=512 \
      PROMPT_LEN_BUCKETS=192,256,384,448,512,640,1024 \
      ENCODE_LEN_BUCKETS=32,64 WARMUP_FULL=1 WARMUP_OVERFLOW_CAP=1024 \
      "$@" python bench.py 2>> "$OUT" | tee -a "$OUT"
}

# 1) fixed-scan baseline (same-session anchor for the r4 mnt64 row)
run "fixed mnt64"      DECODE_MODE=fixed
# 2) continuous pool, window sized for the prefix+suffix and <=640 cold
#    buckets (1024-bucket tails fall back to fixed inside the pool)
run "continuous mnt64" DECODE_MODE=continuous DECODE_WINDOW=704 \
                       DECODE_SLOTS=64 DECODE_CHUNK=8
# 3) continuous at the protocol mnt=10 (crossover honesty: chunked decode
#    may LOSE to the fixed scan when completions barely vary)
run "continuous mnt10" DECODE_MODE=continuous DECODE_WINDOW=704 \
                       DECODE_SLOTS=64 DECODE_CHUNK=8 BENCH_MNT=10

echo "done; log: $OUT"
