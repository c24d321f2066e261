#!/usr/bin/env bash
# Soak test: sustained load at a fixed fraction of
# the measured wall, tracking the host-RAM structures the 60-second rungs
# never stress — server RSS, prefix-pool bytes, prompt-token/query caches,
# miniredis used_memory — plus per-window ok-rps and p99 drift.
#
# Run against an ALREADY-RUNNING server:
#   SERVER_PID=<pid> RATE=320 WINDOWS=20 WINDOW_S=120 \
#     ENDPOINT=http://localhost:8010 STATS=http://localhost:8010 \
#     bash benchmarks/soak.sh
#
# Emits $OUT/soak.csv (one row per window) and $OUT/summary.json with
# first/half/last deltas and a flat-memory / stable-p99 verdict.
set -u
cd "$(dirname "$0")/.."

ENDPOINT="${ENDPOINT:-http://localhost:8010}"
STATS="${STATS:-$ENDPOINT}"
RATE="${RATE:-320}"
WINDOWS="${WINDOWS:-20}"
WINDOW_S="${WINDOW_S:-120}"
PATTERN="${PATTERN:-random}"
OUT="${OUT:-benchmarks/results_soak}"
SERVER_PID="${SERVER_PID:-}"
MINIREDIS_PORT="${MINIREDIS_PORT:-}"
QUERIES="${QUERIES:-data/squad_real_queries.json}"
LOADGEN="${LOADGEN:-benchmarks/loadgen_native}"

mkdir -p "$OUT"
CSV="$OUT/soak.csv"
echo "window,t_s,rate,ok_rps,p50_s,p99_s,failed,rss_mb,prefix_bytes,prefix_entries,query_entries,queue_size,miniredis_bytes" > "$CSV"

for i in $(seq 1 360); do
  curl -sf "$STATS/health" > /dev/null 2>&1 && break
  sleep 5
done
curl -sf "$STATS/health" > /dev/null || { echo "[soak] server never healthy"; exit 1; }

rss_mb() {
  [ -n "$SERVER_PID" ] && [ -r "/proc/$SERVER_PID/status" ] || { echo -1; return; }
  awk '/VmRSS/ {printf "%.1f", $2/1024}' "/proc/$SERVER_PID/status"
}

mini_bytes() {
  [ -n "$MINIREDIS_PORT" ] || { echo -1; return; }
  python - "$MINIREDIS_PORT" <<'PYEOF' 2>/dev/null || echo -1
import sys
from rag_serving_system.utils.resp import RespClient
c = RespClient("127.0.0.1", int(sys.argv[1]))
print(c.info().get("used_memory", -1))
PYEOF
}

T0=$(date +%s)
echo "[soak] $WINDOWS windows x ${WINDOW_S}s at $RATE rps ($PATTERN) -> $CSV"
for W in $(seq 1 "$WINDOWS"); do
  OUT_JSON="$OUT/window_${W}.json"
  "$LOADGEN" --endpoint "$ENDPOINT" --pattern "$PATTERN" --rps "$RATE" \
    --duration "$WINDOW_S" --seed $((100 + W)) --timeout 60 \
    --query-sample random --queries-file "$QUERIES" \
    --output "$OUT_JSON" > /dev/null 2>&1
  ROW=$(python - "$OUT_JSON" <<'PYEOF'
import json, sys
try:
    m = json.load(open(sys.argv[1])); lat = m.get("latency", {})
    print(",".join(str(x) for x in [
        f"{m.get('successful_throughput_rps', -1):.2f}",
        f"{lat.get('p50', -1):.3f}", f"{lat.get('p99', -1):.3f}",
        m.get("failed_requests", -1)]))
except Exception:
    print("-1,-1,-1,-1")
PYEOF
)
  STATS_ROW=$(curl -sf "$STATS/stats" 2>/dev/null | python - <<'PYEOF'
import json, sys
try:
    s = json.load(sys.stdin)
except Exception:
    print("-1,-1,-1,-1"); raise SystemExit
px = s.get("prefix_cache", {}) or {}
qc = s.get("query_cache", {}) or {}
print(",".join(str(x) for x in [
    px.get("bytes", -1), px.get("entries", -1),
    qc.get("entries", -1), s.get("queue_size", -1)]))
PYEOF
)
  [ -n "$STATS_ROW" ] || STATS_ROW="-1,-1,-1,-1"
  T=$(( $(date +%s) - T0 ))
  LINE="$W,$T,$RATE,$ROW,$(rss_mb),$STATS_ROW,$(mini_bytes)"
  echo "$LINE" >> "$CSV"
  echo "[soak] $LINE"
done

python - "$OUT" <<'PYEOF'
import csv, json, sys
out = sys.argv[1]
rows = list(csv.DictReader(open(f"{out}/soak.csv")))
if len(rows) < 3:
    print("[soak] too few windows for a verdict"); sys.exit(0)
f = lambda r, k: float(r[k])
# warm-up excluded: compare window 2 (caches populated) to the last window
first, mid, last = rows[1], rows[len(rows)//2], rows[-1]
rss_f, rss_l = f(first, "rss_mb"), f(last, "rss_mb")
p99s = [f(r, "p99_s") for r in rows[1:]]
ok = [f(r, "ok_rps") for r in rows[1:]]
summary = {
    "windows": len(rows),
    "rate_rps": float(rows[0]["rate"]),
    "rss_mb": {"after_warm": rss_f, "mid": f(mid, "rss_mb"), "final": rss_l,
               "growth_pct": round((rss_l - rss_f) / rss_f * 100, 2)
               if rss_f > 0 else None},
    "p99_s": {"min": min(p99s), "max": max(p99s),
              "first": p99s[0], "last": p99s[-1]},
    "ok_rps": {"min": min(ok), "max": max(ok), "mean": sum(ok) / len(ok)},
    "prefix_bytes": {"after_warm": f(first, "prefix_bytes"),
                     "final": f(last, "prefix_bytes")},
    "miniredis_bytes": {"after_warm": f(first, "miniredis_bytes"),
                        "final": f(last, "miniredis_bytes")},
    "failed_total": sum(int(float(r["failed"])) for r in rows),
}
flat_mem = rss_f <= 0 or (rss_l - rss_f) / rss_f < 0.05
stable_p99 = max(p99s) < 2 * max(min(p99s), 0.05)
summary["verdict"] = {
    "flat_memory": flat_mem, "stable_p99": stable_p99,
    "pass": bool(flat_mem and stable_p99 and summary["failed_total"] == 0)}
json.dump(summary, open(f"{out}/summary.json", "w"), indent=1)
print("[soak] summary:", json.dumps(summary["verdict"]))
PYEOF
