"""Same-session A/B of BatchProcessor pipeline knobs on ONE warmed engine.

Two calls can land on two cards with different power limits and neighbours,
so cross-call comparisons of host-path changes mean little; this script
builds/warms the engine ONCE (scripts/_harness.py — the exact
bench.py configuration) and then measures the serving loop under each
processor configuration in the same session: FINALIZE_ASYNC on/off,
PREFETCH_WORKERS, STAGE_PROMPTS. Reports wall req/s per config plus the
(config-independent) device proxy so the engine anchor is on record.

Usage: python scripts/ab_processor.py [config ...]
  each config is a comma-separated env fragment, e.g.
  python scripts/ab_processor.py FINALIZE_ASYNC=0 FINALIZE_ASYNC=1 \
      FINALIZE_ASYNC=1,PREFETCH_WORKERS=2
  (default sweep below when no args are given)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(
    globals().get("__file__", "scripts/ab_processor.py"))))

from _harness import build_bench_engine  # noqa: E402

DEFAULT_SWEEP = [
    "FINALIZE_ASYNC=0",
    "FINALIZE_ASYNC=1",
    "FINALIZE_ASYNC=1,PREFETCH_WORKERS=2",
    "FINALIZE_ASYNC=1,STAGE_PROMPTS=1",
    "FINALIZE_ASYNC=1,PREFETCH_WORKERS=2,STAGE_PROMPTS=1",
]


def main() -> None:
    n_batches = int(os.environ.get("BENCH_BATCHES", "20"))
    reps = int(os.environ.get("AB_REPS", "2"))
    sweep = sys.argv[1:] or DEFAULT_SWEEP

    from rag_serving_system.core.batch_processor import BatchProcessor
    from rag_serving_system.core.request_queue import RequestQueue

    engine, queries, batch, _ = build_bench_engine()
    engine.process(queries, [2] * batch)  # absorb first-touch costs

    # config-independent device anchor (chained generate, one sync)
    staged = engine.stage_prompts(engine.prepare(queries, [2] * batch))
    handle = engine.generate_tokens(staged=staged)
    engine.finalize_tokens(handle)
    t0 = time.time()
    for _ in range(8):
        handle = engine.generate_tokens(staged=staged)
    engine.finalize_tokens(handle)
    proxy_ms = (time.time() - t0) / 8 * 1e3
    print(f"[ab] device proxy {proxy_ms:.1f} ms/batch", file=sys.stderr)

    results = {}
    total = batch * n_batches
    for frag in sweep:
        saved = {}
        for kv in frag.split(","):
            k, v = kv.split("=")
            saved[k] = os.environ.get(k)
            os.environ[k] = v
        try:
            best = 0.0
            for r in range(reps):
                rq = RequestQueue(max_batch_size=batch, max_wait_time=0.5,
                                  polling_interval=0.002)
                proc = BatchProcessor(rq, engine, polling_interval=0.002)
                proc.start()
                t0 = time.time()
                rids = [rq.add_request(queries[j % len(queries)], 2)
                        for j in range(total)]
                for rid in rids:
                    res = rq.get_result(rid, timeout=600)
                    assert res is not None and "result" in res, res
                rps = total / (time.time() - t0)
                proc.stop(drain_timeout=5.0)
                best = max(best, rps)
                print(f"[ab] {frag} rep{r}: {rps:.1f} req/s", file=sys.stderr)
            results[frag] = round(best, 1)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    print(json.dumps({"config": os.environ.get("BENCH_CONFIG", "short_facts"),
                      "batch": batch,
                      "device_proxy_ms_per_batch": round(proxy_ms, 1),
                      "wall_req_s_by_config": results}))


if __name__ == "__main__":
    main()
