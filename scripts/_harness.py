"""Shared measurement-harness setup for scripts/ab_processor.py and
scripts/profile_host.py: the SAME serving configuration bench.py measures
(int8 quant defaults, bucket sets, corpus/query selection, persistent
compile cache), built once. Changing bench defaults here keeps the A/B and
profiling scripts measuring the configuration bench.py records."""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(globals().get("__file__", "scripts/_harness.py")))))


def build_bench_engine(warmup: bool = True):
    """Returns (engine, queries, batch, settings) matching bench.py's
    BENCH_MODE / BENCH_CONFIG / BENCH_BATCH env contract."""
    os.environ.setdefault("QUANT_WEIGHTS", "int8")
    os.environ.setdefault("QUANT_ACT", "int8")
    mode = os.environ.get("BENCH_MODE", "full")
    config = os.environ.get("BENCH_CONFIG", "short_facts")
    batch = int(os.environ.get("BENCH_BATCH", "32"))

    import jax

    from rag_serving_system.backend import setup_compile_cache

    setup_compile_cache()

    from bench import build_corpus
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine
    from rag_serving_system.models.configs import encoder_config_for

    settings = Settings(
        model_preset="tiny" if mode == "tiny" else "full",
        batch_buckets=[batch],
        encode_len_buckets=[32, 64],
        prompt_len_buckets=[64, 96, 128] if config == "short_facts"
        else [192, 256, 384, 448, 512, 640, 1024],
        max_new_tokens=10, max_k=16, max_batch_size=batch)
    enc_cfg = encoder_config_for(settings.model_preset)
    docs, emb = build_corpus(100 if config == "short_facts" else 1000,
                             enc_cfg.hidden_size, config=config)
    t0 = time.time()
    engine = RagEngine(settings, docs, emb)
    print(f"[harness] engine ready in {time.time() - t0:.1f}s",
          file=sys.stderr)
    if warmup:
        t0 = time.time()
        engine.warmup()
        print(f"[harness] warmup {time.time() - t0:.1f}s", file=sys.stderr)

    if config == "squad_real":
        with open("data/squad_real_queries.json") as f:
            qpool = json.load(f)
        queries = [qpool[i % len(qpool)] for i in range(batch)]
    else:
        queries = [f"What is the measured property number {i} of the subject?"
                   for i in range(batch)]
    return engine, queries, batch, settings
