"""IVF approximate retrieval: recall on clustered data, exactness when
nprobe = n_clusters, padding/interface behavior."""

import numpy as np
import pytest

import jax.numpy as jnp

from rag_serving_system.core.retriever import IvfRetriever, SimpleRetriever
from rag_serving_system.ops.ivf import build_ivf, ivf_search


def clustered_corpus(rng, n_clusters=16, per=64, d=64):
    """Well-separated clusters — the regime IVF is built for."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 5
    rows = np.concatenate([
        centers[i] + rng.standard_normal((per, d)).astype(np.float32) * 0.3
        for i in range(n_clusters)])
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    return rows


def test_ivf_search_shapes(rng):
    corpus = clustered_corpus(rng)
    index = build_ivf(corpus, n_clusters=16, iters=5)
    q = corpus[::100][:4]
    scores, idx = ivf_search(index, jnp.asarray(q), k=5, nprobe=4)
    assert scores.shape == (4, 5) and idx.shape == (4, 5)
    assert (np.asarray(idx) >= 0).all()


def test_ivf_high_recall_on_clustered_data(rng):
    corpus = clustered_corpus(rng)
    docs = [f"d{i}" for i in range(len(corpus))]
    queries = corpus[rng.choice(len(corpus), 32, replace=False)]
    queries = queries + rng.standard_normal(queries.shape).astype(np.float32) * 0.05
    exact = SimpleRetriever(corpus, docs)
    ivf = IvfRetriever(corpus, docs, n_clusters=16, nprobe=4, iters=8)
    ks = [5] * len(queries)
    got = ivf.batch_retrieve(queries, ks)
    want = exact.batch_retrieve(queries, ks)
    hits = sum(len(set(g) & set(w)) for g, w in zip(got, want))
    recall = hits / (5 * len(queries))
    assert recall >= 0.9, recall


def test_ivf_full_probe_is_exact(rng):
    corpus = clustered_corpus(rng, n_clusters=8, per=32)
    docs = [f"d{i}" for i in range(len(corpus))]
    queries = rng.standard_normal((8, 64)).astype(np.float32)
    exact = SimpleRetriever(corpus, docs)
    ivf = IvfRetriever(corpus, docs, n_clusters=8, nprobe=8, iters=8)
    ks = [5] * 8
    assert ivf.batch_retrieve(queries, ks) == exact.batch_retrieve(queries, ks)


def test_ivf_interface_edges(rng):
    corpus = clustered_corpus(rng, n_clusters=4, per=16)
    docs = [f"d{i}" for i in range(len(corpus))]
    ivf = IvfRetriever(corpus, docs, n_clusters=4, nprobe=2)
    assert ivf.batch_retrieve(np.zeros((0, 64), np.float32), []) == []
    assert ivf.batch_retrieve(np.ones((1, 32), np.float32), [2]) == [[]]
    out = ivf.retrieve(np.ones(64, np.float32), k=3)
    assert len(out) == 3


def test_ivf_small_corpus_clamps_nprobe_and_k(rng):
    """Small corpora build fewer clusters than requested and can have fewer
    candidates than k; both previously crashed lax.top_k."""
    from rag_serving_system.core.retriever import IvfRetriever

    docs = [f"doc {i}" for i in range(10)]
    emb = rng.standard_normal((10, 64)).astype(np.float32)
    r = IvfRetriever(emb, docs, n_clusters=64, nprobe=16, max_k=16)
    assert r.nprobe <= r.index.centroids.shape[0]
    out = r.batch_retrieve(rng.standard_normal((3, 64)).astype(np.float32),
                           [8, 2, 16])
    assert len(out) == 3 and all(len(row) >= 1 for row in out)
    assert all(d in docs for row in out for d in row)


def test_engine_serves_ivf(rng):
    """RETRIEVER=ivf is env-selectable in the serving engine:
    the engine builds the index, passes the startup recall gate on
    clusterable data, and serves retrieval through ivf_search."""
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    corpus = clustered_corpus(rng, n_clusters=8, per=32, d=64)
    docs = [f"doc {i}" for i in range(corpus.shape[0])]
    s = Settings(model_preset="tiny", batch_buckets=[2], max_batch_size=2,
                 encode_len_buckets=[16], prompt_len_buckets=[64],
                 max_new_tokens=2, retriever="ivf", ivf_clusters=8,
                 ivf_nprobe=8, ivf_recall_gate=0.9)
    eng = RagEngine(s, docs, corpus)
    assert eng.ivf_index is not None and eng.corpus is None
    idx = eng.embed_and_retrieve(["doc 3", "doc 7"], [2, 2])
    assert len(idx) == 2 and all(len(r) == 2 for r in idx)
    # nprobe == n_clusters degenerates to exact: parity with an exact engine
    s2 = Settings(model_preset="tiny", batch_buckets=[2], max_batch_size=2,
                  encode_len_buckets=[16], prompt_len_buckets=[64],
                  max_new_tokens=2)
    exact = RagEngine(s2, docs, corpus)
    assert idx == exact.embed_and_retrieve(["doc 3", "doc 7"], [2, 2])


def test_engine_ivf_recall_gate_refuses_unclusterable(rng):
    """Uniform random embeddings don't cluster; the startup gate must refuse
    to serve instead of silently degrading recall."""
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    corpus = rng.standard_normal((512, 64)).astype(np.float32)
    docs = [f"doc {i}" for i in range(512)]
    s = Settings(model_preset="tiny", batch_buckets=[2], max_batch_size=2,
                 encode_len_buckets=[16], prompt_len_buckets=[64],
                 max_new_tokens=2, retriever="ivf", ivf_clusters=64,
                 ivf_nprobe=1, ivf_recall_gate=0.9)
    with pytest.raises(ValueError, match="recall"):
        RagEngine(s, docs, corpus)


def test_engine_ivf_sentinel_ids_filtered(rng):
    """ivf_search pads short candidate lists with -1 (fewer than k reachable
    docs at this nprobe); the engine must DROP the sentinels — Python
    negative indexing would silently substitute documents[-1] into the RAG
    context (review finding, round 4)."""
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    # tight clusters, nprobe=1, k > cluster size -> -1 padding is guaranteed
    corpus = clustered_corpus(rng, n_clusters=8, per=4, d=64)
    docs = [f"doc {i}" for i in range(corpus.shape[0])]
    s = Settings(model_preset="tiny", batch_buckets=[2], max_batch_size=2,
                 encode_len_buckets=[16], prompt_len_buckets=[64],
                 max_new_tokens=2, retriever="ivf", ivf_clusters=8,
                 ivf_nprobe=1, ivf_recall_gate=0.0, max_k=16,
                 query_cache_size=0)
    eng = RagEngine(s, docs, corpus)
    rows = eng.embed_and_retrieve(["doc 3", "doc 7"], [16, 16])
    for row in rows:
        assert all(i >= 0 for i in row), row       # sentinels dropped
        assert len(row) < 16                        # genuinely short, not padded
        assert len(row) == len(set(row))            # no duplicate substitution
    # end-to-end: a short context list still serves
    out = eng.process(["doc 3"], [16])
    assert len(out) == 1 and "result" in out[0]


def test_engine_packed_t_step_rounds_to_256(rng):
    """A PACKED_T_STEP that isn't a 256-multiple must be rounded up: packed
    lengths have to be multiples of the packed kernel's block sizes."""
    import os
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    corpus = rng.standard_normal((16, 64)).astype(np.float32)
    docs = [f"doc {i}" for i in range(16)]
    os.environ["PACKED_T_STEP"] = "1500"
    try:
        s = Settings(model_preset="tiny", batch_buckets=[2], max_batch_size=2,
                     encode_len_buckets=[16], prompt_len_buckets=[64],
                     max_new_tokens=2)
        eng = RagEngine(s, docs, corpus)
        if eng.packed:
            assert all(t % 256 == 0 for t in eng.packed_t_buckets), \
                eng.packed_t_buckets
    finally:
        del os.environ["PACKED_T_STEP"]
