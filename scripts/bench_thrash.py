"""Prefix-cache THRASH-regime benchmark.

Serving benchmarks that cycle a few queries sit at 95-99% prefix-cache hit
rate; this one measures the low-hit-rate regimes. It drives the
GENERATION stage with directly-constructed PromptSpec batches — real SQuAD
contexts, real prompt-length distribution — so the context working set is
controlled exactly (the HTTP path can't produce 1000 distinct contexts under
random-init encoder weights).

Workloads, each measured cache-ON (adaptive), cache-ON (adaptive off), and
cache-OFF on the same engine build:

  reuse    — 32 distinct contexts cycling (the steady-state serving regime)
  thrash   — cyclic sweep over WORKING_SET > capacity contexts (LRU's
             pathological case: every lookup misses forever)
  zero     — every batch uses never-seen-again contexts (0% temporal reuse;
             intra-batch dedup still applies)

Prints one JSON line per (workload, cache mode) with batches/s and the
cache stats, plus a verdict line: cache-on must never lose to cache-off by
more than the probe overhead in thrash/zero, and must win big in reuse.

Usage (GPU): python scripts/bench_thrash.py [--batches 30] [--working-set 96]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_engine(prefix_cache: bool, adaptive: bool, cache_mb: int,
                contexts, emb):
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    settings = Settings(
        model_preset="full", batch_buckets=[32], max_batch_size=32,
        encode_len_buckets=[32, 64],
        prompt_len_buckets=[192, 256, 384, 448, 512, 640, 1024],
        max_new_tokens=10, max_k=16,
        prefix_cache=prefix_cache, prefix_adaptive=adaptive,
        prefix_cache_mb=cache_mb,
        # the adaptive window in LOOKUPS; one batch = 32 lookups, so 256
        # fills within 8 thrash batches — small enough to flip within the run
        prefix_adaptive_window=int(os.environ.get("THRASH_WINDOW", "256")),
        prefix_probe_every=8)
    return RagEngine(settings, contexts, emb)


def batches_for(engine, workload: str, contexts, n_batches: int,
                working_set: int, batch: int = 32, offset: int = 0):
    """Yield per-batch prompt lists (PromptSpec when the cache is on)."""
    from rag_serving_system.core.engine import (
        DOC_JOIN, PREFIX_TEMPLATE, PROMPT_TEMPLATE)
    from rag_serving_system.core.prefix_cache import PromptSpec

    def spec(ci: int, qi: int):
        ctx = contexts[ci % len(contexts)]
        q = f"what does passage {ci} say about item {qi}?"
        text = PROMPT_TEMPLATE.format(context=ctx, question=q)
        if engine.prefix_cache is None:
            return text
        return PromptSpec(text, prefix_text=PREFIX_TEMPLATE.format(context=ctx),
                          cache_key=("ctx", (ci,)))

    cursor = offset
    for b in range(n_batches):
        if workload == "reuse":
            idxs = [(b * batch + i) % 32 for i in range(batch)]
        elif workload == "thrash":
            idxs = [(cursor + i) % working_set for i in range(batch)]
            cursor += batch
        elif workload == "zero":
            # never-seen keys: offset separates the warm pass from the
            # measured pass so warm inserts can't turn into measured hits
            idxs = [cursor + i for i in range(batch)]
            cursor += batch
        else:
            raise ValueError(workload)
        yield [spec(ci, i) for i, ci in enumerate(idxs)]
    _ = DOC_JOIN  # parity note: contexts here are single docs


def run(engine, workload: str, contexts, n_batches: int, working_set: int):
    # warm pass: one full unmeasured run of the SAME workload — compiles
    # every (suffix/prompt) bucket the context-length distribution reaches,
    # including the no-prefix traces the adaptive bypass falls back to
    # (mid-serving compiles were exactly what poisoned the round-2 thrash
    # datapoint)
    for prompts in batches_for(engine, workload, contexts, n_batches,
                               working_set, offset=100_000):
        engine.generate_answers(list(prompts))
    if engine.prefix_cache is not None:
        # reset stats/state after warmup so the measurement is clean
        pc = engine.prefix_cache
        pc.hits = pc.misses = pc.bypassed = pc.probes = 0
        pc._win_hits.clear()
        pc.bypass_mode = False
        pc._batch_no = 0
    t0 = time.time()
    n = 0
    for prompts in batches_for(engine, workload, contexts, n_batches,
                               working_set):
        engine.generate_answers(list(prompts))
        n += len(prompts)
    dt = time.time() - t0
    row = {"workload": workload, "batches": n_batches,
           "req_per_s": round(n / dt, 1),
           "ms_per_batch": round(dt / n_batches * 1e3, 1)}
    if engine.prefix_cache is not None:
        st = engine.prefix_cache.stats()
        row["cache"] = {k: st[k] for k in
                        ("hits", "misses", "bypassed", "hit_rate",
                         "bypass_mode", "probes", "entries", "slots")}
    return row


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--batches", type=int, default=30)
    p.add_argument("--working-set", type=int, default=96)
    p.add_argument("--cache-mb", type=int, default=0,
                   help="prefix budget; 0 = sized so capacity < working set")
    p.add_argument("--out", default="benchmarks/results_squad_thrash/summary.json")
    args = p.parse_args()

    import jax

    from rag_serving_system.backend import setup_compile_cache

    setup_compile_cache()
    os.environ.setdefault("QUANT_WEIGHTS", "int8")
    os.environ.setdefault("QUANT_ACT", "int8")

    import numpy as np

    ctx_path = os.path.join(REPO, "data", "squad_real_contexts.json")
    with open(ctx_path) as f:
        contexts = json.load(f)
    emb = np.load(os.path.join(REPO, "data", "squad_real_embeddings.npy"))

    results = {"config": vars(args)}
    for mode, kw in (("cache_adaptive", dict(prefix_cache=True, adaptive=True)),
                     ("cache_always", dict(prefix_cache=True, adaptive=False)),
                     ("cache_off", dict(prefix_cache=False, adaptive=False))):
        cache_mb = args.cache_mb
        if cache_mb == 0 and kw["prefix_cache"]:
            # size capacity BELOW the thrash working set (but >= min_slots):
            # pool_len=384 bf16 entries ≈ 10.5 MB → 65 slots ≈ 683 MB
            cache_mb = 700
        engine = make_engine(cache_mb=cache_mb, contexts=contexts, emb=emb, **kw)
        if engine.prefix_cache is not None:
            print(f"[thrash] {mode}: capacity={engine.prefix_cache.capacity} "
                  f"working_set={args.working_set}", file=sys.stderr)
        for workload in ("reuse", "thrash", "zero"):
            row = run(engine, workload, contexts, args.batches,
                      args.working_set)
            row["mode"] = mode
            results.setdefault("rows", []).append(row)
            print(json.dumps(row), flush=True)
        del engine

    rows = results["rows"]

    def rps(mode, wl):
        return next(r["req_per_s"] for r in rows
                    if r["mode"] == mode and r["workload"] == wl)

    verdict = {
        "reuse_speedup_cache_on": round(rps("cache_adaptive", "reuse")
                                        / rps("cache_off", "reuse"), 2),
        "thrash_ratio_adaptive": round(rps("cache_adaptive", "thrash")
                                       / rps("cache_off", "thrash"), 2),
        "thrash_ratio_always": round(rps("cache_always", "thrash")
                                     / rps("cache_off", "thrash"), 2),
        "zero_ratio_adaptive": round(rps("cache_adaptive", "zero")
                                     / rps("cache_off", "zero"), 2),
    }
    results["verdict"] = verdict
    print(json.dumps(verdict))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
