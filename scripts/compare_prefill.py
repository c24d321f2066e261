"""Time the prefill attention routes on the GPU, alone and end to end.

    python scripts/compare_prefill.py [--reps N]

1. Attention alone at B=32, Hq=12, Hk=2, D=128, bf16, left-padded prompts
   (P = 512 and 1024): the serving wrapper on cuDNN (rows rotated so the
   valid run comes first, sequence-length mask), cuDNN with a boolean
   (B, 1, S, S) mask, XLA's `dot_product_attention`, and the einsum.
2. End to end: one no-prefix batch of 32 real SQuAD questions through
   `RagEngine.generate_tokens` (Qwen2.5-1.5B, random init, bf16; max_new
   tokens 10), staged as padded prefill (cuDNN, then the einsum) and as
   packed prefill (the repo's Pallas kernel, then the library's Pallas
   `mha` kernel with KV heads repeated).

Each timing is the median of N runs after a compile run, each run ended by
block_until_ready. Prints the card's name and power limit first. Needs a
GPU; the numbers are device times of this process only.
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

    jax.block_until_ready(fn())           # compile + first run
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def attention_alone(reps: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rag_serving_system.models.layers import attention, causal_padding_bias
    from rag_serving_system.ops.attention import self_attention

    out = {}
    b, hq, hk, d = 32, 12, 2, 128
    rng = np.random.default_rng(0)
    for p in (512, 1024):
        ks = jax.random.split(jax.random.PRNGKey(p), 3)
        q = jax.random.normal(ks[0], (b, p, hq, d), jnp.bfloat16)
        k = jax.random.normal(ks[1], (b, p, hk, d), jnp.bfloat16)
        v = jax.random.normal(ks[2], (b, p, hk, d), jnp.bfloat16)
        lens = rng.integers(p // 4, p + 1, size=b)
        mask = jnp.asarray((np.arange(p)[None] >= (p - lens)[:, None]).astype(np.int32))
        full = (np.tril(np.ones((p, p), bool))[None]
                & (np.asarray(mask)[:, None, :] > 0))[:, None]
        full = jnp.asarray(full)
        variants = {
            "cudnn_rotated_seqlen": jax.jit(lambda q, k, v, m: self_attention(
                q, k, v, m, causal=True, impl="cudnn")),
            "cudnn_bool_mask": jax.jit(lambda q, k, v, m: jax.nn.dot_product_attention(
                q, k, v, mask=full, implementation="cudnn")),
            "xla_dot_product_attention": jax.jit(lambda q, k, v, m: self_attention(
                q, k, v, m, causal=True, impl="xla")),
            "einsum": jax.jit(lambda q, k, v, m: attention(
                q, k, v, causal_padding_bias(m))),
        }
        for name, fn in variants.items():
            try:
                out[f"attn_P{p}_{name}_ms"] = _median_ms(
                    lambda: fn(q, k, v, mask), reps)
            except Exception as e:  # noqa: BLE001 — report and go on
                out[f"attn_P{p}_{name}_ms"] = f"failed: {type(e).__name__}: {e}"[:300]
            print(f"[attn] P={p} {name}: {out[f'attn_P{p}_{name}_ms']}", flush=True)
    return out


def packed_sweep(reps: int) -> dict:
    """Block sizes and warps of the packed kernel at the squad_real packed
    shape (32 rows, mean 385 tokens), next to cuDNN on the padded batch."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from rag_serving_system.ops.attention import (packed_attention_pallas,
                                                  self_attention)

    out = {}
    hq, hk, d = 12, 2, 128
    rng = np.random.default_rng(5)
    lens = np.clip(rng.normal(385, 60, size=32).astype(int), 100, 512)
    t = -(-int(lens.sum()) // 1024) * 1024
    seg = np.full(t, 32, np.int32)
    off = 0
    for r, n in enumerate(lens):
        seg[off:off + n] = r
        off += n
    ks = jax.random.split(jax.random.PRNGKey(7), 3)
    q = jax.random.normal(ks[0], (1, t, hq, d), jnp.bfloat16)
    k = jax.random.normal(ks[1], (1, t, hk, d), jnp.bfloat16)
    v = jax.random.normal(ks[2], (1, t, hk, d), jnp.bfloat16)
    segj = jnp.asarray(seg)[None]
    out["sweep_T"] = t
    for bq, bk, nw in ((64, 64, 4), (64, 64, 8), (128, 64, 4), (128, 64, 8),
                       (128, 128, 8), (64, 128, 4)):
        fn = functools.partial(packed_attention_pallas, block_q=bq,
                               block_k=bk, num_warps=nw)
        key = f"packed_bq{bq}_bk{bk}_w{nw}_ms"
        try:
            out[key] = _median_ms(lambda: fn(q, k, v, segj), reps)
        except Exception as e:  # noqa: BLE001 — report and go on
            out[key] = f"failed: {type(e).__name__}: {e}"[:200]
        print(f"[sweep] {key}: {out[key]}", flush=True)
    p = 512
    qp = jax.random.normal(ks[0], (32, p, hq, d), jnp.bfloat16)
    kp = jax.random.normal(ks[1], (32, p, hk, d), jnp.bfloat16)
    vp = jax.random.normal(ks[2], (32, p, hk, d), jnp.bfloat16)
    mask = jnp.asarray((np.arange(p)[None] >= (p - lens)[:, None]).astype(np.int32))
    fn = jax.jit(lambda q, k, v, m: self_attention(q, k, v, m, causal=True,
                                                   impl="cudnn"))
    out["padded_cudnn_B32_P512_ms"] = _median_ms(lambda: fn(qp, kp, vp, mask), reps)
    print(f"[sweep] padded cudnn B=32 P=512: {out['padded_cudnn_B32_P512_ms']}")

    # prefix + suffix: 64 suffix queries against [768 prefix | 64 suffix]
    from rag_serving_system.models.layers import attention
    s_, pl_ = 64, 768
    qs = jax.random.normal(ks[0], (32, s_, hq, d), jnp.bfloat16)
    kk = jax.random.normal(ks[1], (32, pl_ + s_, hk, d), jnp.bfloat16)
    vv = jax.random.normal(ks[2], (32, pl_ + s_, hk, d), jnp.bfloat16)
    bias = jnp.where(jnp.asarray(rng.random((32, 1, s_, pl_ + s_)) < 0.9),
                     0.0, -1e9).astype(jnp.float32)
    e = jax.jit(attention)
    c = jax.jit(lambda q, k, v, b: jax.nn.dot_product_attention(
        q, k, v, bias=b.astype(q.dtype), implementation="cudnn"))
    out["prefix_suffix_einsum_ms"] = _median_ms(lambda: e(qs, kk, vv, bias), reps)
    try:
        out["prefix_suffix_cudnn_bias_ms"] = _median_ms(
            lambda: c(qs, kk, vv, bias), reps)
    except Exception as e_:  # noqa: BLE001
        out["prefix_suffix_cudnn_bias_ms"] = f"failed: {e_}"[:200]
    print(f"[sweep] prefix+suffix einsum {out['prefix_suffix_einsum_ms']}, "
          f"cudnn+bias {out['prefix_suffix_cudnn_bias_ms']}", flush=True)
    return out


def _library_mha(q, k, v, seg, **_):
    """Packed attention through the Pallas library kernel
    (jax.experimental.pallas.ops.gpu.attention.mha — a library kernel, not
    this repository's); it has no GQA, so KV heads are repeated."""
    import math

    import jax.numpy as jnp
    from jax.experimental.pallas.ops.gpu.attention import mha

    group = q.shape[2] // k.shape[2]
    return mha(q, jnp.repeat(k, group, axis=2), jnp.repeat(v, group, axis=2),
               segment_ids=seg, sm_scale=1.0 / math.sqrt(q.shape[-1]),
               causal=True)


def end_to_end(reps: int) -> dict:
    import jax

    import rag_serving_system.core.engine as eng_mod
    import rag_serving_system.ops.attention as attn_mod
    from rag_serving_system import backend
    from rag_serving_system.config import Settings

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "data/squad_real_contexts.json")) as f:
        docs = json.load(f)
    with open(os.path.join(root, "data/squad_real_queries.json")) as f:
        questions = json.load(f)[:32]
    import numpy as np
    emb = np.load(os.path.join(root, "data/squad_real_embeddings.npy"))
    settings = Settings(batch_buckets=[32], max_batch_size=32,
                        encode_len_buckets=[32, 64],
                        prompt_len_buckets=[512, 1024], prefix_cache=False,
                        query_cache_size=0)
    engine = eng_mod.RagEngine(settings, docs, emb)
    prompts = engine.prepare(questions, [2] * len(questions))
    rows = engine._prompt_tokens_batch(list(prompts))
    lens = [len(r) for r in rows]
    out = {"prompt_tokens_mean": float(np.mean(lens)),
           "prompt_tokens_max": int(max(lens)),
           "packed_p": engine.packed_p}

    def run(label, margin, table=None, packed_fn=None):
        old = (eng_mod.PACKED_MARGIN, dict(backend._TABLE),
               attn_mod.packed_attention_pallas)
        try:
            eng_mod.PACKED_MARGIN = margin
            if table:
                backend._TABLE["gpu"] = backend.Kernels(**table)
            if packed_fn:
                attn_mod.packed_attention_pallas = packed_fn
            jax.clear_caches()
            staged = engine.stage_prompts(prompts)
            shape = (f"T={staged[1].shape[1]}" if staged[0] == "packed"
                     else f"B={staged[1].shape[0]} P={staged[1].shape[1]}")
            ms = _median_ms(lambda: engine.generate_tokens(staged=staged)[0],
                            reps)
            out[f"e2e_{label}_ms"] = ms
            out[f"e2e_{label}_shape"] = f"{staged[0]} {shape}"
        except Exception as e:  # noqa: BLE001 — report and go on
            out[f"e2e_{label}_ms"] = f"failed: {type(e).__name__}: {e}"[:300]
        finally:
            eng_mod.PACKED_MARGIN = old[0]
            backend._TABLE.clear()
            backend._TABLE.update(old[1])
            attn_mod.packed_attention_pallas = old[2]
        print(f"[e2e] {label}: {out[f'e2e_{label}_ms']} "
              f"({out.get(f'e2e_{label}_shape')})", flush=True)

    # padded and packed in turns (A, B, B, A) so drift hits both alike
    run("padded_cudnn", 0.0)
    run("packed_repo_kernel", 10.0)
    run("packed_repo_kernel_2", 10.0)
    run("padded_cudnn_2", 0.0)
    run("padded_einsum", 0.0, table={"prefill_attention": "einsum",
                                     "packed_attention": "pallas_triton"})
    run("packed_library_mha", 10.0, packed_fn=_library_mha)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--skip-attn", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep the packed kernel's block sizes")
    args = ap.parse_args()
    import jax

    from rag_serving_system.backend import setup_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("compare_prefill needs a GPU")
    setup_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"card": smi, "jax": jax.__version__,
           "xla_flags": os.environ.get("XLA_FLAGS", "")}
    print(f"[card] {smi}", flush=True)
    if args.sweep:
        res.update(packed_sweep(args.reps))
    if not args.skip_attn:
        res.update(attention_alone(args.reps))
    if not args.skip_e2e:
        res.update(end_to_end(args.reps))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
