"""Serving top-k (GEMM + lax.top_k) vs the jnp oracle vs numpy.

Mirrors the validation role the reference's SimpleRetriever plays for its GPU
paths (reference: rag_service/core/retriever.py:57-166)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rag_serving_system.ops.topk import (
    cosine_topk,
    cosine_topk_int8,
    cosine_topk_reference,
)


def _numpy_cosine_topk(corpus, queries, k):
    q = queries / np.maximum(np.linalg.norm(queries, axis=-1, keepdims=True), 1e-12)
    sims = q @ corpus.T
    idx = np.argsort(-sims, axis=1, kind="stable")[:, :k]
    scores = np.take_along_axis(sims, idx, axis=1)
    return scores, idx


def _make(rng, n, d, b):
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    return corpus, queries


@pytest.mark.parametrize("n,d,b,k", [(100, 64, 4, 5), (1000, 128, 8, 10), (257, 256, 1, 3)])
def test_reference_matches_numpy(rng, n, d, b, k):
    corpus, queries = _make(rng, n, d, b)
    scores, idx = cosine_topk_reference(jnp.asarray(corpus), jnp.asarray(queries), k)
    np_scores, np_idx = _numpy_cosine_topk(corpus, queries, k)
    np.testing.assert_allclose(np.asarray(scores), np_scores, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(idx), np_idx)


@pytest.mark.parametrize("n,d,b,k", [
    (100, 128, 4, 5),       # tiny corpus
    (1000, 128, 8, 10),     # serving-size corpus
    (512, 256, 2, 16),      # k larger than usual
    (300, 128, 32, 5),      # full serving batch
])
def test_serving_topk_matches_numpy(rng, n, d, b, k):
    """The float32 serving path must return the numpy oracle's exact index
    lists (ranked) and its scores."""
    corpus, queries = _make(rng, n, d, b)
    s, i = cosine_topk(jnp.asarray(corpus), jnp.asarray(queries), k)
    np_s, np_i = _numpy_cosine_topk(corpus.astype(np.float64),
                                    queries.astype(np.float64), k)
    np.testing.assert_allclose(np.asarray(s), np_s, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), np_i)


def test_topk_ties_resolve_to_lowest_index(rng):
    # duplicate rows → tied scores; the earliest index must win, matching
    # lax.top_k / argsort(stable) semantics.
    d = 128
    base = rng.standard_normal((1, d)).astype(np.float32)
    corpus = np.repeat(base, 6, axis=0)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = base.copy()
    s, i = cosine_topk(jnp.asarray(corpus), jnp.asarray(queries), 3)
    np.testing.assert_array_equal(np.asarray(i)[0], [0, 1, 2])


def test_unnormalized_queries_ok(rng):
    corpus, queries = _make(rng, 200, 128, 4)
    queries *= 7.5  # scale must not change cosine ranking
    ref_s, ref_i = cosine_topk_reference(jnp.asarray(corpus), jnp.asarray(queries), 5)
    s, i = cosine_topk(jnp.asarray(corpus), jnp.asarray(queries), 5)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))


def test_bf16_corpus_matches_bf16_oracle():
    """bf16 corpus: the serving path must produce the same top-k as the
    f32 oracle evaluated on the bf16-cast corpus (the query is rounded to
    bf16 too, so scores agree to bf16 resolution)."""
    rng = np.random.default_rng(11)
    corpus = rng.standard_normal((300, 128)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = rng.standard_normal((4, 128)).astype(np.float32)
    c_bf = jnp.asarray(corpus, dtype=jnp.bfloat16)
    s, i = cosine_topk(c_bf, jnp.asarray(queries), 5)
    s_ref, i_ref = cosine_topk_reference(
        c_bf.astype(jnp.float32), jnp.asarray(queries), 5)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref), atol=2e-3)


def test_topk_large_query_batch(rng):
    """A query batch far past the serving buckets stays oracle-exact."""
    corpus = rng.standard_normal((700, 256)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = rng.standard_normal((512, 256)).astype(np.float32)
    got_s, got_i = cosine_topk(jnp.asarray(corpus), jnp.asarray(queries), k=8)
    ref_s, ref_i = cosine_topk_reference(jnp.asarray(corpus),
                                         jnp.asarray(queries), k=8)
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(ref_s),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# int8 corpus mode
# ---------------------------------------------------------------------------

def test_int8_quantize_roundtrip():
    from rag_serving_system.ops.topk import quantize_corpus_int8

    corpus, _ = _make(np.random.default_rng(3), 200, 128, 1)
    q, s, m = quantize_corpus_int8(jnp.asarray(corpus))
    assert q.dtype == jnp.int8 and s.shape == (1, 200) and m.shape == (1, 128)
    deq = np.asarray(m) + np.asarray(q, dtype=np.float32) * np.asarray(s).T
    # per-row symmetric scale on the residual: max error is scale/2 per comp
    np.testing.assert_allclose(deq, corpus, atol=np.asarray(s).max() / 2 + 1e-7)


@pytest.mark.parametrize("n,d,b,k", [
    (300, 128, 4, 5),
    (1000, 256, 8, 10),
    (257, 128, 1, 3),          # odd corpus size + B=1
])
def test_int8_high_overlap_with_oracle(n, d, b, k):
    """int8 is approximate: assert the top-k SETS nearly match the f32
    oracle (random high-dim corpora have near-ties that may flip). A local
    fixed-seed generator keeps the near-tie structure deterministic — the
    shared session rng's state depends on test order."""
    from rag_serving_system.ops.topk import quantize_corpus_int8

    corpus, queries = _make(np.random.default_rng(n + d), n, d, b)
    cq, cs, cm = quantize_corpus_int8(jnp.asarray(corpus))
    s, i = cosine_topk_int8(cq, cs, jnp.asarray(queries), k, corpus_mean=cm)
    ref_s, ref_i = cosine_topk_reference(jnp.asarray(corpus),
                                         jnp.asarray(queries), k)
    i, ref_i = np.asarray(i), np.asarray(ref_i)
    overlap = np.mean([len(set(i[r]) & set(ref_i[r])) / k for r in range(b)])
    assert overlap >= 0.9, overlap
    # top-1 must agree on random data at this scale
    np.testing.assert_array_equal(i[:, 0], ref_i[:, 0])
    # returned scores approximate true cosine
    np.testing.assert_allclose(np.asarray(s)[:, 0], np.asarray(ref_s)[:, 0],
                               atol=0.02)


def test_int8_exact_on_separated_corpus():
    """With well-separated docs (the serving regime — real corpora are not
    isotropic noise) int8 retrieval must be index-exact vs the oracle."""
    from rag_serving_system.ops.topk import quantize_corpus_int8

    rng = np.random.default_rng(42)
    d = 128
    corpus = rng.standard_normal((128, d)).astype(np.float32) * 4.0
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = corpus[:4] + 0.1 * rng.standard_normal((4, d)).astype(np.float32)
    cq, cs, cm = quantize_corpus_int8(jnp.asarray(corpus))
    _, i = cosine_topk_int8(cq, cs, jnp.asarray(queries.astype(np.float32)),
                            5, corpus_mean=cm)
    _, ref_i = cosine_topk_reference(jnp.asarray(corpus), jnp.asarray(queries), 5)
    i, ref_i = np.asarray(i), np.asarray(ref_i)
    # the retrieved SET must be exact; order within it may swap at the
    # ~1e-3-gap adjacent ranks that sit inside int8's resolution
    for r in range(i.shape[0]):
        assert set(i[r]) == set(ref_i[r]), (r, i[r], ref_i[r])
    np.testing.assert_array_equal(i[:, 0], ref_i[:, 0])


def test_int8_recall_on_real_squad_embeddings():
    """TASK recall@5 (does the true document surface) of int8 retrieval vs
    the f32 oracle on the repo's REAL SQuAD e5 embeddings — the regime that
    matters. e5 vectors live in a tight cone (pairwise cosine ≈ 0.55 with
    ~1e-4 rank gaps), which is why quantize_corpus_int8 centers: without
    centering this drops to ~0.78. Mid-noise (0.3) is the harsh setting."""
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "squad_embeddings.npy")
    emb = np.load(path).astype(np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
    from rag_serving_system.ops.topk import quantize_corpus_int8

    rng = np.random.default_rng(7)
    sel = rng.choice(emb.shape[0], size=64, replace=False)
    noise = rng.standard_normal((64, emb.shape[1])).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    queries = emb[sel] + 0.3 * noise
    cq, cs, cm = quantize_corpus_int8(jnp.asarray(emb))
    s8, i8 = cosine_topk_int8(cq, cs, jnp.asarray(queries), 5,
                              corpus_mean=cm)
    sref, ref = cosine_topk_reference(jnp.asarray(emb), jnp.asarray(queries), 5)
    i8, ref = np.asarray(i8), np.asarray(ref)
    r8 = np.mean([sel[r] in i8[r] for r in range(64)])
    rref = np.mean([sel[r] in ref[r] for r in range(64)])
    assert r8 >= rref - 0.01, (r8, rref)   # int8 must match f32 task recall
    # with the mean term added back, returned scores approximate true cosine
    np.testing.assert_allclose(np.asarray(s8)[:, 0], np.asarray(sref)[:, 0],
                               atol=5e-3)


def test_retriever_int8_corpus_dtype():
    from rag_serving_system.core.retriever import ExactRetriever

    corpus, queries = _make(np.random.default_rng(5), 120, 64, 3)
    docs = [f"doc {i}" for i in range(120)]
    r_f32 = ExactRetriever(corpus, docs)
    r_int8 = ExactRetriever(corpus, docs, corpus_dtype="int8")
    a = r_f32.batch_retrieve(queries, [1, 1, 1])
    b = r_int8.batch_retrieve(queries, [1, 1, 1])
    assert a == b


# ---------------------------------------------------------------------------
# chunked int8 corpus
# ---------------------------------------------------------------------------

def test_int8_chunked_matches_single_chunk():
    """Chunk boundaries must be invisible: per-row scales make quantization
    chunk-independent and top-k-of-chunk-top-ks is exact, so a 4-chunk split
    (ragged tail included) returns bit-identical results to one chunk."""
    from rag_serving_system.ops.topk import (cosine_topk_int8_chunked,
                                             quantize_corpus_int8_chunked)

    corpus, queries = _make(np.random.default_rng(11), 1000, 128, 4)
    one, m1 = quantize_corpus_int8_chunked(corpus, chunk_rows=10**9)
    four, m4 = quantize_corpus_int8_chunked(corpus, chunk_rows=300)
    assert len(one) == 1 and len(four) == 4
    assert four[-1][0].shape[0] == 100          # ragged tail
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m4))
    s1, i1 = cosine_topk_int8_chunked(one, jnp.asarray(queries), 5,
                                      corpus_mean=m1)
    s4, i4 = cosine_topk_int8_chunked(four, jnp.asarray(queries), 5,
                                      corpus_mean=m4)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i4))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s4), rtol=1e-6)


def test_retriever_int8_chunked(monkeypatch):
    from rag_serving_system.core.retriever import ExactRetriever

    corpus, queries = _make(np.random.default_rng(5), 120, 64, 3)
    docs = [f"doc {i}" for i in range(120)]
    monkeypatch.setenv("TOPK_CHUNK_ROWS", "50")   # force 3 chunks
    r_f32 = ExactRetriever(corpus, docs)
    r_int8 = ExactRetriever(corpus, docs, corpus_dtype="int8")
    assert len(r_int8.corpus_chunks) == 3
    a = r_f32.batch_retrieve(queries, [2, 2, 2])
    b = r_int8.batch_retrieve(queries, [2, 2, 2])
    assert a == b


def test_engine_int8_chunked_corpus(tiny_settings_factory=None):
    """Engine path: a multi-chunk int8 corpus retrieves identically to the
    f32 default through embed_and_retrieve (separate encode + chunked top-k
    dispatches instead of the fused program)."""
    import json
    import os
    import tempfile

    from rag_serving_system.config import get_settings
    from rag_serving_system.core.engine import RagEngine

    rng = np.random.default_rng(9)
    docs = [f"passage {i}: " + " ".join(f"tok{i}_{j}" for j in range(5))
            for i in range(90)]
    emb = rng.standard_normal((90, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    with tempfile.TemporaryDirectory() as td:
        dp = os.path.join(td, "docs.json")
        json.dump(docs, open(dp, "w"))
        base = dict(MODEL_PRESET="tiny", PREFIX_CACHE="0", BATCH_BUCKETS="1",
                    MAX_BATCH_SIZE="2", ENCODE_LEN_BUCKETS="16",
                    PROMPT_LEN_BUCKETS="64", DOCUMENT_TEXT_FILE=dp)
        old = {k: os.environ.get(k) for k in
               list(base) + ["RETRIEVAL_CORPUS_DTYPE", "TOPK_CHUNK_ROWS"]}
        os.environ.update(base)
        try:
            os.environ["RETRIEVAL_CORPUS_DTYPE"] = "int8"
            os.environ["TOPK_CHUNK_ROWS"] = "40"
            eng8 = RagEngine(get_settings(), docs, emb)
            assert eng8.corpus_chunks is not None
            assert len(eng8.corpus_chunks) == 3
            os.environ["RETRIEVAL_CORPUS_DTYPE"] = "float32"
            engf = RagEngine(get_settings(), docs, emb)
            queries = [docs[7], docs[41]]
            assert eng8.embed_and_retrieve(queries, [3, 3]) == \
                engf.embed_and_retrieve(queries, [3, 3])
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
