"""End-to-end RAG throughput benchmark (the reference's headline metric).

Reference baseline: 23.67 req/s end-to-end on 1x NVIDIA L4 at batch 32
(reference README.md:3, protocol in SURVEY §6 / BASELINE.md). This bench
reproduces the serving configuration — short_facts-scale corpus (100 docs),
k=2, MAX_BATCH_SIZE=32, max_new_tokens=10, sampling on — and measures
steady-state batches through the full engine pipeline:

  host tokenize → e5-large encode (mean-pool) → fused cosine top-k →
  host prompt build → Qwen2.5-1.5B prefill + 10-token KV-cached decode →
  host detokenize

Model weights are architecture-true (e5-large 560M / Qwen2.5-1.5B) random
inits when no HF snapshot is present — identical FLOPs/memory to real
weights, so the throughput number is honest.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
Full mode needs a GPU and fails without one; BENCH_MODE=tiny is an explicit
CPU smoke of toy models whose numbers are not device measurements.
"""

from __future__ import annotations

import json
import os
import sys
import time

BASELINE_RPS = 23.67  # reference README.md:3


def build_corpus(n_docs: int, dim: int, config: str = "short_facts"):
    """Prefer the repo's real data artifacts; synthesize when absent or when
    the embedding dim doesn't match the active model preset. `squad_real`
    loads the genuine SQuAD corpus + real e5 embeddings (data/squad_real_*)
    so the benchmark runs on real prompt-length distributions."""
    import json

    import numpy as np

    if config == "squad_real":
        base = "data/squad_real"
        with open(base + "_contexts.json") as f:
            docs = json.load(f)
        emb = np.load(base + "_embeddings.npy")
        assert emb.shape[1] == dim, (
            f"squad_real needs the full-size encoder (dim {emb.shape[1]})")
        return docs, emb

    # repo-shipped squad artifacts are the SYNTHETIC fallback (no network to
    # fetch real SQuAD at build time) — reported as squad_synthetic
    name = "squad" if config == "squad_synthetic" else config
    ctx_path = f"data/{name}_contexts.json"
    emb_path = f"data/{name}_embeddings.npy"
    if os.path.exists(ctx_path) and os.path.exists(emb_path):
        with open(ctx_path) as f:
            docs = json.load(f)
        emb = np.load(emb_path)
        if emb.shape[1] == dim:
            return docs, emb

    subjects = ["water", "the sun", "gold", "oxygen", "the moon", "iron",
                "light", "sound", "carbon", "helium"]
    facts = []
    for i in range(n_docs):
        s = subjects[i % len(subjects)]
        facts.append(
            f"Fact {i}: {s} has the measured property number {i} with value "
            f"{i * 3 + 1} under standard conditions according to study {i}.")
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n_docs, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return facts, emb


def main() -> None:
    from rag_serving_system.config import Settings

    mode = os.environ.get("BENCH_MODE", "full")
    # configs: short_facts | squad_synthetic | squad_real (genuine SQuAD
    # corpus, data/squad_real_*). "squad" is kept as a legacy alias: the
    # real corpus needs the full-size (1024-d) encoder, so tiny mode reports
    # it as synthetic
    config = os.environ.get("BENCH_CONFIG", "short_facts")
    if config == "squad":
        config = "squad_real" if mode != "tiny" else "squad_synthetic"
    # weight-only int8 decode + W8A8 prefill stay this benchmark's
    # configuration (prefill logits track bf16 at cos > 0.999,
    # tests/test_quant.py); whether they are faster than bf16 on the GPU is
    # not measured yet. QUANT_WEIGHTS=none / QUANT_ACT=none give bf16
    os.environ.setdefault("QUANT_WEIGHTS", "int8")
    os.environ.setdefault("QUANT_ACT", "int8")
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    n_batches = int(os.environ.get("BENCH_BATCHES", "20"))
    # decode-heavy variant: MAX_NEW_TOKENS past the
    # reference's 10 exercises the fixed-scan decode regime
    mnt = int(os.environ.get("BENCH_MNT", "10"))

    settings = Settings(
        model_preset="tiny" if mode == "tiny" else "full",
        batch_buckets=[batch],
        encode_len_buckets=[32, 64],
        prompt_len_buckets=[64, 96, 128] if config == "short_facts"
        else [192, 256, 384, 448, 512, 640, 1024],
        max_new_tokens=mnt,
        max_k=16,
        max_batch_size=batch,
    )

    from rag_serving_system.backend import (configure_xla_flags,
                                            setup_compile_cache)

    configure_xla_flags()
    import jax
    import numpy as np

    setup_compile_cache()
    dev = jax.devices()[0]
    if mode != "tiny" and dev.platform != "gpu":
        raise SystemExit(f"[bench] full mode needs a GPU; JAX found "
                         f"{dev.platform!r} (BENCH_MODE=tiny is the CPU smoke)")

    from rag_serving_system.core.engine import RagEngine
    from rag_serving_system.models.configs import encoder_config_for

    enc_cfg = encoder_config_for(settings.model_preset)
    docs, emb = build_corpus(100 if config == "short_facts" else 1000,
                             enc_cfg.hidden_size, config=config)
    print(f"[bench] backend={jax.default_backend()} devices={len(jax.devices())} "
          f"mode={mode} config={config} batch={batch} corpus={len(docs)}",
          file=sys.stderr)

    t0 = time.time()
    engine = RagEngine(settings, docs, emb)
    print(f"[bench] engine ready in {time.time() - t0:.1f}s", file=sys.stderr)

    if config == "squad_real":
        with open("data/squad_real_queries.json") as f:
            real_queries = json.load(f)
        queries = [real_queries[i % len(real_queries)] for i in range(batch)]
    else:
        queries = [f"What is the measured property number {i} of the subject?"
                   for i in range(batch)]
    ks = [2] * batch

    # parallel compile matrix: every (batch × length-bucket) program the
    # scheduler can reach compiles CONCURRENTLY (XLA releases the GIL), then
    # two end-to-end sanity batches run compile-free — this wall time IS the
    # cold-start cost on a fresh machine (persistent cache makes repeats ~free)
    t0 = time.time()
    engine.warmup()
    print(f"[bench] warmup (parallel compile matrix) {time.time() - t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
    engine.process(queries, ks)
    print(f"[bench] first batch (post-warmup) {time.time() - t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
    # JAX_TRACE_DIR=<dir> records a jax.profiler trace of one warm batch
    from rag_serving_system.utils.timing import device_trace

    with device_trace(os.environ.get("JAX_TRACE_DIR")):
        engine.process(queries, ks)  # warm
    warm = time.time() - t0
    print(f"[bench] warm batch (engine serial) {warm:.3f}s", file=sys.stderr)

    # BENCH_BUDGET_SPREAD="lo,hi": per-request generation budgets drawn
    # uniform [lo, hi] (seeded) — the completion-length-variance workload
    # continuous batching exists for. The fixed path pays ~max(batch) decode
    # steps per batch; the pool frees each slot at its own budget.
    spread = os.environ.get("BENCH_BUDGET_SPREAD")
    total = batch * n_batches
    budgets = None
    if spread:
        lo, hi = (int(x) for x in spread.split(","))
        budgets = np.random.default_rng(42).integers(
            lo, hi + 1, size=total).tolist()

    # device-side anchor: CHAINED generate dispatches with one host sync at
    # the end, so the queue, HTTP, host staging and the per-dispatch
    # host-device round trip stay out of the number
    staged = engine.stage_prompts(
        engine.prepare(queries, ks,
                       budgets[:batch] if budgets else None))
    reps = 8
    handle = engine.generate_tokens(staged=staged)
    engine.finalize_tokens(handle)  # sync
    t0 = time.time()
    for _ in range(reps):
        handle = engine.generate_tokens(staged=staged)
    engine.finalize_tokens(handle)
    proxy_ms = (time.time() - t0) / reps * 1e3
    print(f"[bench] device proxy (chained generate) {proxy_ms:.1f} ms/batch",
          file=sys.stderr)

    # measure through the real serving loop: queue -> pipelined BatchProcessor
    # (stage-1 embed/retrieve/prompt-build overlaps stage-2 generation)
    from rag_serving_system.core.batch_processor import BatchProcessor
    from rag_serving_system.core.request_queue import RequestQueue

    rq = RequestQueue(max_batch_size=batch, max_wait_time=0.5,
                      polling_interval=0.002)
    processor = BatchProcessor(rq, engine, polling_interval=0.002)
    processor.start()

    t0 = time.time()
    rids = [rq.add_request(queries[j % len(queries)], 2,
                           budgets[j] if budgets else None)
            for j in range(total)]
    for rid in rids:
        res = rq.get_result(rid, timeout=600)
        assert res is not None, "request timed out"
    elapsed = time.time() - t0
    processor.stop()
    rps = total / elapsed

    result = {
        "metric": f"rag_e2e_throughput_b{batch}"
                  + ("" if config == "short_facts" else f"_{config}")
                  + ("_tinysmoke" if mode == "tiny" else "")
                  + (f"_mnt{mnt}" if mnt != 10 else "")
                  # per-request budget-variance workload (seeded uniform)
                  + ((f"_bud" + spread.replace(",", "_")) if spread else "")
                  # continuous (in-flight) batching over the decode pool —
                  # distinct key: the serving loop's completion semantics
                  # differ (per-request delivery, no batch-drain wait)
                  + ("_cont" if getattr(engine, "decode_pool", None)
                     is not None else "")
                  # decode-mode A/B markers: greedy (DO_SAMPLE=0) is its own
                  # regime (deterministic, spec-eligible); _specN records the
                  # speculative arm; _ebX the EOS-bias length-variance arm
                  + ("_greedy" if not settings.do_sample else "")
                  + (f"_spec{engine.spec_gamma}" if engine.spec_gamma else "")
                  + ((f"_eb{settings.eos_bias:g}").replace(".", "p")
                     if settings.eos_bias else "")
                  + ("_noprefix" if engine.prefix_cache is None else "")
                  # packed prefill is the default; the padded-prefill A/B
                  # variant records under its own key
                  + ("_nopack" if not getattr(engine, "packed", False) else "")
                  + ("_pxint8" if engine.prefix_int8 else "")
                  + ("_noqcache" if engine.query_cache_stats() is None else "")
                  # non-default suffix buckets are an experiment, not the
                  # protocol config — don't overwrite the canonical entry
                  # a real (HF/BPE) tokenizer replaces the hash fallback —
                  # distinct key so host-path cost regimes don't mix
                  + ("_bpetok" if type(engine.dec_tok).__name__ == "HFTokenizer"
                     else "")
                  + (("_sfx" + os.environ["SUFFIX_LEN_BUCKETS"].replace(",", "_"))
                     if os.environ.get("SUFFIX_LEN_BUCKETS", "32,64") != "32,64"
                     else ""),
        "value": round(rps, 2),
        "unit": "req/s",
        # tiny mode is a CI smoke run of toy models — not baseline-comparable
        "vs_baseline": round(rps / BASELINE_RPS, 2) if mode != "tiny" else None,
        # device-side anchor: generate time per batch without the host path
        # (a CPU smoke's time is not a device metric)
        "device_proxy_ms_per_batch": (round(proxy_ms, 1)
                                      if dev.platform == "gpu" else None),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    if engine.prefix_cache is not None:
        # the workload reuses `batch` distinct queries, so steady-state hit
        # rate is high — the stats record makes that context explicit
        result["prefix_cache"] = engine.prefix_cache.stats()
    qstats = engine.query_cache_stats()
    if qstats is not None:
        # same disclosure: the cycled query set makes steady-state hits ~100%;
        # the cache is exact (deterministic retrieval), QUERY_CACHE_SIZE=0
        # gives the no-cache bound
        result["query_cache"] = qstats
    print(json.dumps(result))


if __name__ == "__main__":
    main()
