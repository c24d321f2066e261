#!/usr/bin/env bash
# Byte-level reference-protocol ladder against the NATIVE C++ HTTP front at
# the squad_real b32 serving config. Protocol =
# the reference's own load_test.sh: INITIAL=1, STEP=5, 60 s/rung, uniform +
# random interleaved, p99 >= 10 s gate, seed convention BASE + rung_index
# (reference benchmarks/load_test.sh:3-13). Client = the C++ load generator
# (the asyncio client can saturate a shared measurement core, which would
# cap the ladder client-side).
#
# Server env = the squad_real protocol config below plus the native front
# (NATIVE_FRONT_PORT): POST /rag, result polls and /health are served from
# the C++ epoll loop off the GIL; the asyncio server keeps /stats on PORT.
#
# Resume-safe: rows append to sweep.csv; re-invoking with FROM=<rung> (and
# REUSE=1 against the live server) continues the climb. A wall-clock-capped
# run leaves consistent artifacts + the resume line in progress.txt.
set -u
cd "$(dirname "$0")/.."

PORT="${PORT:-8041}"           # asyncio server (stats)
FPORT="${FPORT:-8040}"         # native epoll front (the driven surface)
FROM="${FROM:-1}"
TO="${TO:-1200}"
DURATION="${DURATION:-60}"
P99_GATE=10
OUT_DIR="benchmarks/results_native_refprotocol"
CSV="$OUT_DIR/sweep.csv"
mkdir -p "$OUT_DIR"

if [ ! -x benchmarks/loadgen_native ] || \
   [ benchmarks/loadgen_native.cc -nt benchmarks/loadgen_native ]; then
  g++ -O2 -std=c++17 -o benchmarks/loadgen_native benchmarks/loadgen_native.cc
fi

if [ "${REUSE:-0}" = "1" ] && curl -sf "http://localhost:$FPORT/health" > /dev/null 2>&1; then
  echo "[native-ref] reusing live server on :$FPORT"
  SERVER_PID=""
else
  echo "[native-ref] starting squad_real b32 + native-front server"
  env DOCUMENT_TEXT_FILE=data/squad_real_contexts.json \
    DOCUMENT_EMBEDDINGS_FILE=data/squad_real_embeddings.npy \
    DOCUMENT_QUERIES_FILE=data/squad_real_queries.json \
    MAX_BATCH_SIZE=32 BATCH_BUCKETS=8,32 \
    QUANT_WEIGHTS=int8 QUANT_ACT=int8 \
    PREFIX_CACHE_MB=6000 PREFIX_CACHE_DTYPE=int8 PREFIX_POOL_LEN=512 \
    PREFETCH_WORKERS=2 \
    PROMPT_LEN_BUCKETS=192,256,384,448,512,640,1024 ENCODE_LEN_BUCKETS=32,64 \
    WARMUP_FULL=1 WARMUP_OVERFLOW_CAP=1024 \
    NATIVE_FRONT_PORT=$FPORT PORT=$PORT \
    timeout "${SERVER_TIMEOUT:-28800}" python main.py \
    > "$OUT_DIR/server.log" 2>&1 &
  SERVER_PID=$!
  echo $SERVER_PID > /tmp/native_ref_server.pid
  for i in $(seq 1 540); do  # WARMUP_FULL on a cold cache can take ~30 min
    curl -sf "http://localhost:$FPORT/health" > /dev/null 2>&1 && break
    kill -0 $SERVER_PID 2>/dev/null || { echo "[native-ref] server died:"; tail -5 "$OUT_DIR/server.log"; exit 1; }
    sleep 5
  done
  curl -sf "http://localhost:$FPORT/health" > /dev/null || {
    echo "[native-ref] never healthy"; kill "$SERVER_PID" 2>/dev/null; exit 1; }
fi
echo "[native-ref] healthy; ladder $FROM..$TO (1, 5, 10, 15, ... step 5)"

[ -f "$CSV" ] || echo "pattern,rps,duration,total,success,fail,throughput,success_throughput,p50,p95,p99" > "$CSV"

# the reference ladder: rung 1, then 5, 10, ... (+5)
rungs() {
  local r="$FROM"
  [ "$r" = 1 ] && { echo 1; r=5; }
  seq "$r" 5 "$TO"
}

declare -A STOPPED GATE MAXOK
STOPPED[uniform]=0; STOPPED[random]=0
GATE[uniform]=0;    GATE[random]=0
# resume: seed max-ok from rows already in the CSV (best rung with p99 < gate)
best_from_csv() {
  awk -F, -v p="$1" -v g="$P99_GATE" \
    '$1 == p && $11 >= 0 && $11 < g && $2 > m {m = $2} END {print m + 0}' "$CSV"
}
MAXOK[uniform]=$(best_from_csv uniform)
MAXOK[random]=$(best_from_csv random)
for RPS in $(rungs); do
  for PATTERN in uniform random; do
    [ "${STOPPED[$PATTERN]}" = "1" ] && continue
    BASE=10; [ "$PATTERN" = "random" ] && BASE=210
    SEED=$((BASE + RPS / 5 + 1))    # load_test.sh's seed convention
    OUT_JSON="$OUT_DIR/${PATTERN}_rps${RPS}.json"
    echo "=== pattern=$PATTERN rps=$RPS seed=$SEED ==="
    benchmarks/loadgen_native \
      --endpoint "http://localhost:$FPORT" --pattern "$PATTERN" \
      --rps "$RPS" --duration "$DURATION" --seed "$SEED" --timeout 60 \
      --query-sample random --queries-file data/squad_real_queries.json \
      --output "$OUT_JSON" || { echo "client failed"; STOPPED[$PATTERN]=1; continue; }
    ROW=$(python - "$OUT_JSON" "$PATTERN" "$RPS" <<'PYEOF'
import json, sys
m = json.load(open(sys.argv[1])); lat = m.get("latency", {})
print(",".join(str(x) for x in [
    sys.argv[2], sys.argv[3], f"{m['duration_seconds']:.1f}",
    m["total_requests"], m["successful_requests"], m["failed_requests"],
    f"{m['throughput_rps']:.2f}", f"{m['successful_throughput_rps']:.2f}",
    f"{lat.get('p50', -1):.3f}", f"{lat.get('p95', -1):.3f}",
    f"{lat.get('p99', -1):.3f}"]))
PYEOF
)
    [ -n "$ROW" ] || { echo "metrics extraction failed"; STOPPED[$PATTERN]=1; continue; }
    echo "$ROW" >> "$CSV"
    P99=${ROW##*,}
    echo "p99=${P99}s"
    if python -c "import sys; sys.exit(0 if 0 <= float('$P99') < $P99_GATE else 1)"; then
      MAXOK[$PATTERN]=$RPS
    else
      echo "gate fired — stopping $PATTERN at $RPS"
      STOPPED[$PATTERN]=1; GATE[$PATTERN]=1
    fi
  done
  echo "resume: FROM=$((RPS + 5)) REUSE=1 bash benchmarks/run_native_refprotocol.sh" > "$OUT_DIR/progress.txt"
  [ "${STOPPED[uniform]}" = "1" ] && [ "${STOPPED[random]}" = "1" ] && break
done

python - "$OUT_DIR" "${MAXOK[uniform]}" "${MAXOK[random]}" \
  "${GATE[uniform]}" "${GATE[random]}" <<'PYEOF'
import glob, json, sys
out = sys.argv[1]
mu, mr = int(sys.argv[2]), int(sys.argv[3])
gu, gr = sys.argv[4] == "1", sys.argv[5] == "1"
pats = {}
for pat, mx, gate in (("uniform", mu, gu), ("random", mr, gr)):
    rungs = glob.glob(f"{out}/{pat}_rps*.json")
    failed = 0
    clean = 0   # honest wall: the p99 gate ignores failed requests (the
    for rj in rungs:  # reference's blind spot — see ANALYSIS_uniform_vs_random.md)
        try:
            m = json.load(open(rj))
            failed += m.get("failed_requests", 0)
            r = int(rj.rsplit("rps", 1)[1].split(".")[0])
            p99 = m.get("latency", {}).get("p99", -1)
            if (m.get("failed_requests", 1) == 0 and p99 is not None
                    and 0 <= p99 < 10 and r > clean):
                clean = r
        except Exception:
            pass
    entry = {"rungs_run": len(rungs), "max_sustainable_rps": mx,
             "clean_max_sustainable_rps": clean,
             "gate_fired": gate, "failed_requests_total": failed}
    try:
        row = json.load(open(f"{out}/{pat}_rps{mx}.json"))
        entry["p99_at_max_s"] = row.get("latency", {}).get("p99")
    except Exception:
        pass
    pats[pat] = entry
summary = {
    "protocol": "reference byte-level: rungs 1,5,10,...(+5), 60 s/rung, "
                "p99>=10 s gate (reference benchmarks/load_test.sh:3-13)",
    "surface": "native C++ epoll front (native/httpfront.cc), C++ load "
               "generator (benchmarks/loadgen_native.cc)",
    "config": "squad_real b32 protocol config (server env in this "
              "script) + NATIVE_FRONT_PORT",
    "patterns": pats,
}
if pats["uniform"]["gate_fired"] and pats["random"]["gate_fired"]:
    summary["note"] = ("saturation measured: the gate fired for both "
                       "patterns at reference granularity")
else:
    summary["note"] = ("wall-clock-capped: the gate has not fired for every "
                       "pattern; max_sustainable_rps is a LOWER BOUND — "
                       "resume with progress.txt")
json.dump(summary, open(f"{out}/summary.json", "w"), indent=1)
print(json.dumps(summary["patterns"], indent=1))
PYEOF
echo "[native-ref] done: uniform max=${MAXOK[uniform]} random max=${MAXOK[random]}"
