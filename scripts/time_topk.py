"""Time exact top-k retrieval on the GPU, split into GEMM and selection.

    python scripts/time_topk.py [--docs 1000000] [--batch 32] [--k 16] [--reps 20]

A seeded 1M x 1024 corpus is made on the device (L2-normalized) in bf16,
float32 and int8; for each, the serving path (`ops.topk.cosine_topk` /
`cosine_topk_int8`) is timed whole, then its two parts alone: the (B, N)
score GEMM and `lax.top_k` on a precomputed score matrix. Medians of N runs
after a compile run, each ended by block_until_ready. Prints the card's
name and power limit first, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_ms(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from rag_serving_system.backend import setup_compile_cache
    from rag_serving_system.ops.topk import (cosine_topk, cosine_topk_int8,
                                             quantize_corpus_int8)

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("time_topk needs a GPU")
    setup_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    n, b, k, r = args.docs, args.batch, args.k, args.reps
    c32 = jax.random.normal(jax.random.PRNGKey(1), (n, 1024), jnp.float32)
    c32 = c32 / jnp.linalg.norm(c32, axis=1, keepdims=True)
    q = jax.random.normal(jax.random.PRNGKey(2), (b, 1024), jnp.float32)
    q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
    res = {"card": smi, "docs": n, "batch": b, "k": k}

    topk_only = jax.jit(lambda s: jax.lax.top_k(s, k))
    for name, corpus in (("bf16", c32.astype(jnp.bfloat16)), ("f32", c32)):
        prec = (jax.lax.Precision.HIGHEST if corpus.dtype == jnp.float32
                else jax.lax.Precision.DEFAULT)
        gemm = jax.jit(lambda c, q, prec=prec: jnp.einsum(
            "bd,nd->bn", q.astype(c.dtype), c,
            preferred_element_type=jnp.float32, precision=prec))
        res[f"{name}_full_ms"] = _median_ms(lambda: cosine_topk(corpus, q, k), r)
        res[f"{name}_gemm_ms"] = _median_ms(lambda: gemm(corpus, q), r)
        scores = gemm(corpus, q)
        res[f"{name}_topk_ms"] = _median_ms(lambda: topk_only(scores), r)
        res[f"{name}_corpus_bytes"] = int(corpus.size * corpus.dtype.itemsize)
        print(f"[topk] {name}: full {res[f'{name}_full_ms']:.3f} ms, gemm "
              f"{res[f'{name}_gemm_ms']:.3f} ms, lax.top_k "
              f"{res[f'{name}_topk_ms']:.3f} ms", flush=True)
        del corpus, scores
    cq, cs, cm = quantize_corpus_int8(c32)
    del c32
    res["int8_full_ms"] = _median_ms(
        lambda: cosine_topk_int8(cq, cs, q, k, corpus_mean=cm), r)
    print(f"[topk] int8: full {res['int8_full_ms']:.3f} ms", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
