"""On-card smoke check of the RAG serving path.

    python chip_smoke.py               # one GPU: device, kernels, HTTP serving
    python chip_smoke.py --four-cards  # four GPUs: the sharded server vs card 0

Phases (each one passes or the script exits non-zero; nothing is caught and
passed over):

1. Device: JAX must see a GPU. Prints the card's name and power limit.
2. Kernels against plain references at real widths (float32 references under
   `jax.default_matmul_precision("highest")`, so TF32 cannot blur them):
   top-k (float32, bfloat16 at 1M x 1024, int8), prefill attention (padded,
   packed, prefix + suffix) and last-token prefill logits of Qwen2.5-1.5B
   (bf16 and int8 W8A8) against a float32 forward with einsum attention.
3. Serve: `main.build_app` under the program's default Settings on the
   squad_real corpus; 64 real SQuAD questions over HTTP, then one batch with
   the prefix cache off (packed prefill).

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import http.client
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOPK_GAP = 1e-5          # rows whose k-th/(k+1)-th oracle scores are closer are near-ties
# bf16 rounding of O(1) attention outputs is ~4e-3 relative; the softmax
# weights are rounded to bf16 before the PV product as well, so allow 2e-2
ATTN_ATOL = 2e-2
LOGIT_COS = 0.99         # per-row cosine of bf16 serving logits vs the f32 forward
LOGIT_DMAX = 0.5         # max |Δ| over the reference logits' std
INT8_COS = 0.95          # W8A8 logits vs the f32 forward
# the sharded encoder sums in another order, so bf16 query embeddings may
# differ by about one bf16 ulp at 1.0; closer top-k boundaries may flip
ENGINE_GAP = 4e-3


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  {'PASS' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device(want: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(f"JAX found no GPU (platform {devs[0].platform!r})")
    if len(devs) < want:
        raise SmokeFailure(f"need {want} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"[device] {smi.stdout.strip().splitlines()[0]}")
    print(f"[device] device_kind={devs[0].device_kind} jax={jax.__version__} "
          f"count={len(devs)}")
    present = {m: importlib.util.find_spec(m) is not None
               for m in ("aiohttp", "pydantic", "prometheus_client",
                         "safetensors", "transformers", "redis")}
    print(f"[device] optional packages importable: {json.dumps(present)}")
    return devs


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _load_squad():
    import numpy as np

    with open(os.path.join(ROOT, "data/squad_real_contexts.json")) as f:
        docs = json.load(f)
    with open(os.path.join(ROOT, "data/squad_real_queries.json")) as f:
        queries = json.load(f)
    emb = np.load(os.path.join(ROOT, "data/squad_real_embeddings.npy"))
    return docs, queries, emb.astype(np.float32)


def _set_mismatch(got, want_scores, k):
    """Rows whose top-k index SET differs from the oracle's, among rows whose
    oracle k-th and (k+1)-th scores differ by more than TOPK_GAP."""
    import numpy as np

    order = np.argsort(-want_scores, axis=1, kind="stable")
    srt = np.take_along_axis(want_scores, order, axis=1)
    clear = (srt[:, k - 1] - srt[:, k]) > TOPK_GAP
    bad = [r for r in range(got.shape[0])
           if clear[r] and set(got[r]) != set(order[r, :k])]
    return bad, int(clear.sum())


def check_topk(emb, big_n: int = 1_000_000):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rag_serving_system.ops.topk import (cosine_topk, cosine_topk_int8,
                                             quantize_corpus_int8)

    k = 16
    rng = np.random.default_rng(0)
    corpus = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sel = rng.choice(corpus.shape[0], size=64, replace=False)
    noise = rng.standard_normal((64, corpus.shape[1])).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    queries = (corpus[sel] + 0.3 * noise).astype(np.float32)

    # float32 corpus vs a float64 numpy oracle
    _, idx = cosine_topk(jnp.asarray(corpus), jnp.asarray(queries), k)
    q64 = queries.astype(np.float64)
    q64 /= np.linalg.norm(q64, axis=1, keepdims=True)
    oracle = q64 @ corpus.astype(np.float64).T
    bad, n = _set_mismatch(np.asarray(idx), oracle, k)
    check(not bad, f"topk f32 squad_real k={k}: {len(bad)} set mismatches over "
                   f"{n} rows with gap > {TOPK_GAP} (bound 0)")

    # int8 corpus: task recall@5 within 0.01 of the float32 path
    cq, cs, cm = quantize_corpus_int8(jnp.asarray(corpus))
    _, i8 = cosine_topk_int8(cq, cs, jnp.asarray(queries), 5, corpus_mean=cm)
    _, i32 = cosine_topk(jnp.asarray(corpus), jnp.asarray(queries), 5)
    r8 = float(np.mean([sel[r] in np.asarray(i8)[r] for r in range(64)]))
    r32 = float(np.mean([sel[r] in np.asarray(i32)[r] for r in range(64)]))
    check(r8 >= r32 - 0.01, f"topk int8 recall@5 {r8:.4f} vs f32 {r32:.4f} "
                            f"(bound: within 0.01)")

    # 1M x 1024 bf16 corpus, B=32: oracle in float32 on the bf16 values of
    # both operands (the serving path rounds the query to bf16 too)
    n_docs, b = big_n, 32
    key = jax.random.PRNGKey(1)
    c = jax.random.normal(key, (n_docs, 1024), jnp.float32)
    c = (c / jnp.linalg.norm(c, axis=1, keepdims=True)).astype(jnp.bfloat16)
    qb = jax.random.normal(jax.random.PRNGKey(2), (b, 1024), jnp.float32)
    qb = qb / jnp.linalg.norm(qb, axis=1, keepdims=True)
    _, idx = cosine_topk(c, qb, k)
    with jax.default_matmul_precision("highest"):
        ref = jnp.einsum("bd,nd->bn", qb.astype(jnp.bfloat16).astype(jnp.float32),
                         c.astype(jnp.float32))
        ref_s, ref_i = jax.lax.top_k(ref, k + 1)
    ref_s, ref_i, idx = map(np.asarray, (ref_s, ref_i, idx))
    clear = (ref_s[:, k - 1] - ref_s[:, k]) > TOPK_GAP
    bad = [r for r in range(b) if clear[r] and set(idx[r]) != set(ref_i[r, :k])]
    check(not bad, f"topk bf16 {n_docs} x 1024 B={b}: {len(bad)} set mismatches over "
                   f"{int(clear.sum())} rows with gap > {TOPK_GAP} (bound 0)")
    del c, ref


def _attn_ref(q, k, v, bias):
    import jax
    import jax.numpy as jnp

    from rag_serving_system.models.layers import attention

    f = lambda x: x.astype(jnp.float32)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        return attention(f(q), f(k), f(v), bias)


def check_attention(packed_t: int, ps=(256, 512, 1024), b: int = 32,
                    p_row: int = 1024):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rag_serving_system.backend import kernels
    from rag_serving_system.models.layers import NEG_INF, causal_padding_bias
    from rag_serving_system.ops.attention import (biased_attention,
                                                  packed_attention,
                                                  self_attention)

    impl = kernels()
    hq, hk, d = 12, 2, 128
    rng = np.random.default_rng(3)

    def qkv(shape_b, s):
        ks = jax.random.split(jax.random.PRNGKey(s + shape_b), 3)
        return tuple(jax.random.normal(kk, (shape_b, s, h, d), jnp.bfloat16)
                     for kk, h in zip(ks, (hq, hk, hk)))

    attend = jax.jit(lambda q, k, v, m: self_attention(
        q, k, v, m, causal=True, impl=impl.prefill_attention))
    for p in ps:
        q, k, v = qkv(b, p)
        lens = rng.integers(p // 4, p + 1, size=b)
        lens[0] = p                                  # one unpadded row
        mask = jnp.asarray((np.arange(p)[None, :] >= (p - lens)[:, None])
                           .astype(np.int32))
        out = attend(q, k, v, mask)
        ref = _attn_ref(q, k, v, causal_padding_bias(mask))
        m = np.asarray(mask).astype(bool)
        err = float(np.abs(np.asarray(out, np.float32) - np.asarray(ref))[m].max())
        check(err <= ATTN_ATOL, f"prefill attention {impl.prefill_attention} "
                                f"B={b} P={p} left-padded: max|err| {err:.2e} "
                                f"(bound {ATTN_ATOL})")

    # packed: rows back to back in one stream at the largest packed bucket;
    # the reference attends each row alone (per-row causal == block-diagonal)
    lens = rng.integers(p_row // 2, p_row + 1, size=b)
    while lens.sum() > packed_t:
        lens = lens * 9 // 10
    seg = np.full(packed_t, b, np.int32)
    gather = np.zeros((b, p_row), np.int32)
    valid = np.zeros((b, p_row), np.int32)
    off = 0
    for r, n in enumerate(lens):
        seg[off:off + n] = r
        gather[r, :n] = off + np.arange(n)
        valid[r, :n] = 1
        off += n
    q, k, v = qkv(1, packed_t)
    out = jax.jit(lambda q, k, v, s: packed_attention(
        q, k, v, s, impl=impl.packed_attention))(q, k, v, jnp.asarray(seg)[None])
    take = lambda x: jnp.take(x[0], jnp.asarray(gather), axis=0)  # noqa: E731
    ref = _attn_ref(take(q), take(k), take(v),
                    causal_padding_bias(jnp.asarray(valid)))
    got = np.asarray(take(out), np.float32)
    err = float(np.abs(got - np.asarray(ref))[valid.astype(bool)].max())
    check(err <= ATTN_ATOL, f"packed attention {impl.packed_attention} "
                            f"T={packed_t} ({b} rows, {off} tokens): max|err| "
                            f"{err:.2e} (bound {ATTN_ATOL})")

    # prefix + suffix: 64 suffix queries against [768 prefix | 64 suffix]
    pl_, s = min(768, 3 * p_row // 4), 64
    q, _, _ = qkv(b, s)
    _, k, v = qkv(b, pl_ + s)
    plen = rng.integers(1, pl_ + 1, size=b)
    slen = rng.integers(1, s + 1, size=b)
    smask = jnp.asarray((np.arange(s)[None, :] >= (s - slen)[:, None])
                        .astype(np.int32))
    pvalid = jnp.asarray(np.arange(pl_)[None, :] < plen[:, None])
    bias = jnp.concatenate(
        [jnp.broadcast_to(jnp.where(pvalid, 0.0, NEG_INF)[:, None, None, :],
                          (b, 1, s, pl_)), causal_padding_bias(smask)], axis=-1)
    out = jax.jit(lambda q, k, v, bias: biased_attention(
        q, k, v, bias, impl=impl.prefill_attention))(q, k, v, bias)
    ref = _attn_ref(q, k, v, bias)
    m = np.asarray(smask).astype(bool)
    err = float(np.abs(np.asarray(out, np.float32) - np.asarray(ref))[m].max())
    check(err <= ATTN_ATOL, f"prefix+suffix attention "
                            f"{impl.prefill_attention} B={b} "
                            f"prefix={pl_} suffix={s}: max|err| {err:.2e} "
                            f"(bound {ATTN_ATOL})")


def check_logits(docs, questions, cfg=None, b: int = 8, p: int = 512):
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from rag_serving_system.core.engine import DOC_JOIN, PROMPT_TEMPLATE
    from rag_serving_system.models import QWEN25_15B
    from rag_serving_system.models.qwen2 import prefill
    from rag_serving_system.models.tokenizer import HashTokenizer, pad_and_stack
    from rag_serving_system.models.weights import init_decoder_params
    from rag_serving_system.ops.quant import quantize_decoder_params

    cfg = cfg or QWEN25_15B
    tok = HashTokenizer(cfg.vocab_size, pad_id=cfg.pad_token_id,
                        eos_id=cfg.eos_token_id)
    rows = [tok.encode(PROMPT_TEMPLATE.format(
        context=docs[2 * i] + DOC_JOIN + docs[2 * i + 1], question=questions[i]))
        for i in range(b)]
    ids, mask = pad_and_stack(rows, p, tok.pad_id, pad_side="left",
                              truncate_side="left")
    ids, mask = jnp.asarray(ids), jnp.asarray(mask)

    @functools.partial(jax.jit, static_argnames=("dtype", "act_quant", "impl"))
    def last_logits(params, ids, mask, dtype, act_quant=False, impl=None):
        return prefill(params, cfg, ids, mask, 0, dtype=dtype,
                       act_quant=act_quant, attn_impl=impl)[0]

    params = init_decoder_params(cfg, seed=1, dtype=jnp.bfloat16)
    params32 = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(last_logits(params32, ids, mask, jnp.float32,
                                     impl="einsum"))
    del params32
    got = np.asarray(last_logits(params, ids, mask, jnp.bfloat16))

    def compare(a, r):
        cos = np.sum(a * r, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(r, axis=1))
        dmax = np.abs(a - r).max(axis=1) / r.std(axis=1)
        return cos, dmax

    cos, dmax = compare(got, ref)
    print(f"  bf16 logits per-row cosine {np.round(cos, 5).tolist()}")
    print(f"  bf16 logits per-row max|Δ|/std {np.round(dmax, 4).tolist()}")
    check(cos.min() >= LOGIT_COS and dmax.max() <= LOGIT_DMAX,
          f"prefill logits bf16 vs f32 (B={b} P={p}): min cos {cos.min():.5f} "
          f"(bound {LOGIT_COS}), max |Δ|/std {dmax.max():.4f} "
          f"(bound {LOGIT_DMAX})")

    q8 = quantize_decoder_params(params, bits=8)
    got8 = np.asarray(last_logits(q8, ids, mask, jnp.bfloat16, act_quant=True))
    cos8, dmax8 = compare(got8, ref)
    cos8b, _ = compare(got8, got)
    print(f"  int8 W8A8 logits per-row cosine vs f32 {np.round(cos8, 5).tolist()}")
    print(f"  int8 W8A8 logits cosine vs bf16: min {cos8b.min():.5f}, "
          f"max|Δ|/std vs f32 {dmax8.max():.4f}")
    check(cos8.min() >= INT8_COS, f"prefill logits int8 W8A8 vs f32: min cos "
                                  f"{cos8.min():.5f} (bound {INT8_COS})")
    return ids, mask, ref


def run_gpu_tests():
    """The `gpu`-marked tests, in this process (it owns the card)."""
    import pytest

    os.environ["RAG_TEST_DEVICE"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    check(rc == 0, f"gpu-marked tests (pytest exit code {int(rc)})")


def phase_kernels(emb, docs, questions, packed_t: int):
    run_gpu_tests()
    check_topk(emb)
    check_attention(packed_t)
    check_logits(docs, questions)


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

SERVE_ENV = {
    "DOCUMENT_TEXT_FILE": "data/squad_real_contexts.json",
    "DOCUMENT_EMBEDDINGS_FILE": "data/squad_real_embeddings.npy",
    "DOCUMENT_QUERIES_FILE": "data/squad_real_queries.json",
    # only the shapes this phase sends: full batches of short questions
    # with two-passage prompts
    "BATCH_BUCKETS": "32",
    "MAX_BATCH_SIZE": "32",
    "ENCODE_LEN_BUCKETS": "32,64",
    "PROMPT_LEN_BUCKETS": "512,1024",
    "PACKED_T_STEP": "4096",
}


class _Client:
    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)

    def call(self, method: str, path: str, body=None):
        data = None if body is None else json.dumps(body)
        headers = {} if body is None else {"Content-Type": "application/json"}
        self.conn.request(method, path, body=data, headers=headers)
        r = self.conn.getresponse()
        return r.status, json.loads(r.read() or b"null")


def _serve_batch(client: _Client, questions) -> list:
    ids = []
    for q in questions:
        status, body = client.call("POST", "/rag", {"query": q, "k": 2})
        if status != 200:
            raise SmokeFailure(f"POST /rag -> {status}: {body}")
        ids.append(body["request_id"])
    out = []
    deadline = time.time() + 600
    for rid in ids:
        while True:
            status, body = client.call("GET", f"/rag/result/{rid}?timeout=10")
            if status == 200 and body.get("status") == "complete":
                out.append(body["result"])
                break
            if time.time() > deadline:
                raise SmokeFailure(f"request {rid} never completed")
    return out


def _build_and_serve(questions, label: str, extra_env: dict) -> tuple:
    os.environ.update(extra_env)
    import main as main_mod
    from rag_serving_system.api.endpoints import ServerThread

    t0 = time.time()
    app, processor, engine, _ = main_mod.build_app()
    compile_s = time.time() - t0
    print(f"[serve:{label}] build_app + warmup (compile) {compile_s:.1f}s; "
          f"packed prefill {'on' if engine.packed else 'off'}, prefix cache "
          f"{'on' if engine.prefix_cache is not None else 'off'}")
    server = ServerThread(app).start()
    try:
        client = _Client(server.port)
        t0 = time.time()
        results = _serve_batch(client, questions)
        wall = time.time() - t0
        _, stats = client.call("GET", "/stats")
        _, health = client.call("GET", "/health")
    finally:
        server.stop()
        processor.stop(drain_timeout=30)
    failed = [r for r in results if "result" not in r]
    empty = [r for r in results if "result" in r and not r["result"].strip()]
    print(f"[serve:{label}] {len(results)} requests answered in {wall:.2f}s "
          f"(batches {stats.get('batches_processed')}, packed batches "
          f"{stats.get('packed_batches')})")
    print(f"[serve:{label}] sample answer: {results[0].get('result', '')[:80]!r}")
    check(health == {"status": "healthy"}, f"{label}: /health")
    check(not failed and not empty,
          f"{label}: {len(results)} requests complete with non-empty text "
          f"({len(failed)} failed, {len(empty)} empty)")
    return engine, stats, len(results)


def phase_serve(questions):
    os.environ.update(SERVE_ENV)
    engine, _, n1 = _build_and_serve(questions[:64], "prefix-cache", {})
    check(n1 >= 64, f"served {n1} requests (bound >= 64)")
    del engine
    _, stats, n2 = _build_and_serve(questions[64:96], "no-prefix",
                                    {"PREFIX_CACHE": "0"})
    check(stats.get("packed_batches", 0) >= 1,
          f"no-prefix batch ran packed prefill "
          f"(packed batches {stats.get('packed_batches')})")
    print(f"[serve] total requests answered over HTTP: {n1 + n2}")


# ---------------------------------------------------------------------------
# --four-cards: the sharded server path against the same engine on card 0
# ---------------------------------------------------------------------------

def phase_four_cards(docs, questions, emb, model_preset: str = "full"):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine
    from rag_serving_system.models.tokenizer import pad_and_stack
    from rag_serving_system.models.qwen2 import prefill
    from rag_serving_system.ops.topk import cosine_topk
    from rag_serving_system.parallel.mesh import make_mesh
    from rag_serving_system.parallel.sharded_topk import (shard_corpus,
                                                          sharded_cosine_topk)
    from rag_serving_system.core.engine import (DOC_JOIN, PROMPT_TEMPLATE,
                                                QUERY_PREFIX, pick_bucket)

    devs = jax.devices()[:4]
    qs = questions[:32]
    k = 16
    settings = Settings(model_preset=model_preset,
                        batch_buckets=[32], max_batch_size=32,
                        encode_len_buckets=[32, 64], prefix_cache=False,
                        packed_prefill=False, query_cache_size=0)

    # retrieval collectives on identical query vectors: exact equality
    corpus = jnp.asarray(emb / np.linalg.norm(emb, axis=1, keepdims=True))
    rng = np.random.default_rng(0)
    qv = jnp.asarray(emb[rng.choice(len(emb), 32, replace=False)]
                     + 0.3 * rng.standard_normal((32, emb.shape[1]))
                     .astype(np.float32))
    _, want = cosine_topk(corpus, qv, k)
    want = np.asarray(want)

    base = RagEngine(settings, docs, emb)      # arrays on card 0
    tok = base.dec_tok
    rows = [tok.encode(PROMPT_TEMPLATE.format(
        context=docs[2 * i] + DOC_JOIN + docs[2 * i + 1], question=qs[i]))
        for i in range(8)]
    ids, mask = pad_and_stack(rows, 512, tok.pad_id, pad_side="left",
                              truncate_side="left")
    dec_cfg, dtype = base.dec_cfg, base.dtype
    logits_fn = jax.jit(lambda p, i, m: prefill(p, dec_cfg, i, m, 0,
                                                dtype=dtype)[0])
    params32 = jax.tree.map(lambda x: x.astype(jnp.float32), base.dec_params)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, i, m: prefill(
            p, dec_cfg, i, m, 0, dtype=jnp.float32,
            attn_impl="einsum")[0])(params32, jnp.asarray(ids), jnp.asarray(mask)))
    del params32
    base_idx = base.embed_and_retrieve(qs, [k] * len(qs))
    base_logits = np.asarray(logits_fn(base.dec_params, jnp.asarray(ids),
                                       jnp.asarray(mask)))
    # near-tie rows of the engine path, judged on card 0's own embeddings
    enc_rows = base.enc_tok.encode_many([QUERY_PREFIX + q for q in qs])
    ids_e, mask_e = pad_and_stack(
        enc_rows, pick_bucket(settings.encode_len_buckets,
                              max(len(r) for r in enc_rows)),
        base.enc_tok.pad_id, pad_side="right")
    emb0 = np.asarray(base._embed_jit(jnp.asarray(ids_e), jnp.asarray(mask_e)),
                      np.float64)
    emb0 /= np.linalg.norm(emb0, axis=1, keepdims=True)
    s0 = np.sort(emb0 @ np.asarray(corpus, np.float64).T, axis=1)[:, ::-1]
    clear = (s0[:, k - 1] - s0[:, k]) > ENGINE_GAP
    del base

    def cos_rows(a, r):
        return np.sum(a * r, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(r, axis=1))

    for shape in ("4,1", "2,2"):
        mesh = make_mesh(shape, devices=devs)
        _, got = sharded_cosine_topk(shard_corpus(corpus, mesh), qv, k, mesh,
                                     valid_n=corpus.shape[0])
        check(np.array_equal(np.asarray(got), want),
              f"mesh {shape}: sharded top-k indices identical to card 0 "
              f"(32 queries, k={k})")
        eng = RagEngine(settings, docs, emb, mesh=mesh)
        got_idx = eng.embed_and_retrieve(qs, [k] * len(qs))
        same = [got_idx[r] == base_idx[r] for r in range(len(qs))]
        diff_clear = [r for r in range(len(qs)) if clear[r] and not same[r]]
        print(f"  mesh {shape}: engine retrieval identical on {sum(same)}/"
              f"{len(qs)} queries ({int(clear.sum())} without a near-tie)")
        check(not diff_clear, f"mesh {shape}: engine retrieval identical on "
                              f"every query without a near-tie "
                              f"(gap > {ENGINE_GAP})")
        # the sharded engine's own query embeddings: close to card 0's, and
        # its retrieval exact against a float64 oracle on them
        emb_m = np.asarray(eng._embed_jit(eng._put_batch(ids_e),
                                          eng._put_batch(mask_e)), np.float64)
        emb_m /= np.linalg.norm(emb_m, axis=1, keepdims=True)
        c_emb = cos_rows(emb_m, emb0)
        bad, n = _set_mismatch(np.asarray(got_idx),
                               emb_m @ np.asarray(corpus, np.float64).T, k)
        check(c_emb.min() >= LOGIT_COS and not bad,
              f"mesh {shape}: query embeddings cos vs card 0 min "
              f"{c_emb.min():.5f} (bound {LOGIT_COS}); engine retrieval vs "
              f"float64 oracle on them: {len(bad)} set mismatches over {n} "
              f"rows with gap > {TOPK_GAP} (bound 0)")
        lg =np.asarray(logits_fn(eng.dec_params, eng._put_batch(ids),
                                  eng._put_batch(mask)))
        c_ref, c_base = cos_rows(lg, ref), cos_rows(lg, base_logits)
        dmax = (np.abs(lg - ref).max(axis=1) / ref.std(axis=1)).max()
        print(f"  mesh {shape}: logits cos vs f32 min {c_ref.min():.5f}, vs card "
              f"0 min {c_base.min():.5f}, max|Δ|/std vs f32 {dmax:.4f}")
        check(c_ref.min() >= LOGIT_COS and dmax <= LOGIT_DMAX,
              f"mesh {shape}: greedy last-token logits within the single-card "
              f"bound (cos >= {LOGIT_COS}, max|Δ|/std <= {LOGIT_DMAX})")
        del eng


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded path and its comparison")
    args = ap.parse_args()
    want = 4 if args.four_cards else 1
    # line-buffered, so a crash still shows how far the run got
    sys.stdout.reconfigure(line_buffering=True)

    t_start = time.time()
    sys.path.insert(0, ROOT)
    from rag_serving_system.backend import (configure_xla_flags,
                                            setup_compile_cache)

    configure_xla_flags()           # before JAX creates its GPU client
    devs = phase_device(want)
    print(f"[setup] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"[setup] compile cache: {setup_compile_cache()}")
    docs, questions, emb = _load_squad()
    if args.four_cards:
        print("[four-cards] sharded serving path vs card 0")
        phase_four_cards(docs, questions, emb)
    else:
        print("[kernels] against plain references")
        phase_kernels(emb, docs, questions, packed_t=32 * 1024)
        print("[serve] HTTP serving through main.build_app")
        phase_serve(questions)
    print(f"[done] {time.time() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
