"""Retriever classes: exactness vs the numpy oracle, variable per-query k,
defensive validation, recall@k on the reference data artifacts, and the
sharded retriever on the 8-virtual-device CPU mesh."""

import json
import os

import numpy as np
import pytest

from rag_serving_system.core.retriever import (
    ShardedRetriever,
    SimpleRetriever,
    ExactRetriever,
)

DATA_DIR = os.environ.get("RAG_DATA_DIR", "/root/reference/data")


@pytest.fixture(scope="module")
def corpus(rng_mod=None):
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((257, 128)).astype(np.float32)
    docs = [f"doc-{i}" for i in range(257)]
    return emb, docs


def test_exact_matches_simple(corpus):
    emb, docs = corpus
    rng = np.random.default_rng(3)
    queries = rng.standard_normal((8, 128)).astype(np.float32)
    simple = SimpleRetriever(emb, docs)
    exact = ExactRetriever(emb, docs)
    ks = [1, 2, 3, 5, 8, 2, 4, 7]
    assert exact.batch_retrieve(queries, ks) == simple.batch_retrieve(queries, ks)


def test_single_retrieve(corpus):
    emb, docs = corpus
    q = np.random.default_rng(5).standard_normal(128).astype(np.float32)
    simple = SimpleRetriever(emb, docs)
    exact = ExactRetriever(emb, docs)
    assert exact.retrieve(q, 5) == simple.retrieve(q, 5)


def test_k_clamped_to_corpus(corpus):
    emb, docs = corpus
    exact = ExactRetriever(emb[:3], docs[:3])
    out = exact.retrieve(np.ones(128, np.float32), k=50)
    assert len(out) == 3


def test_empty_batch_returns_empty(corpus):
    emb, docs = corpus
    for cls in (ExactRetriever, ShardedRetriever):
        r = cls(emb, docs)
        assert r.batch_retrieve(np.zeros((0, 128), np.float32), []) == []


def test_bad_shape_returns_empty(corpus):
    emb, docs = corpus
    exact = ExactRetriever(emb, docs)
    out = exact.batch_retrieve(np.ones((2, 64), np.float32), [2, 2])
    assert out == [[], []]


def test_sharded_matches_simple(corpus):
    import jax
    assert len(jax.devices()) == 8, "conftest should force 8 CPU devices"
    emb, docs = corpus
    rng = np.random.default_rng(11)
    queries = rng.standard_normal((4, 128)).astype(np.float32)
    simple = SimpleRetriever(emb, docs)
    sharded = ShardedRetriever(emb, docs)
    ks = [5, 3, 8, 1]
    assert sharded.batch_retrieve(queries, ks) == simple.batch_retrieve(queries, ks)


def test_sharded_ties_match_single_device():
    # duplicate rows across shard boundaries: merge must tie-break to the
    # lowest global index, like single-device lax.top_k
    emb = np.tile(np.ones((1, 128), np.float32), (16, 1))
    docs = [f"d{i}" for i in range(16)]
    sharded = ShardedRetriever(emb, docs)
    out = sharded.retrieve(np.ones(128, np.float32), k=5)
    assert out == ["d0", "d1", "d2", "d3", "d4"]


@pytest.mark.skipif(not os.path.isdir(DATA_DIR), reason="reference data not mounted")
def test_recall_on_shipped_squad_corpus():
    """Recall@5 parity check on the shipped SQuAD artifacts: the oracle and the
    fused retriever must produce identical top-5 sets (method is exact search,
    SURVEY §6 north star)."""
    emb = np.load(os.path.join(DATA_DIR, "squad_embeddings.npy"))
    with open(os.path.join(DATA_DIR, "squad_contexts.json")) as f:
        docs = json.load(f)
    rng = np.random.default_rng(42)
    queries = emb[rng.choice(len(emb), size=16, replace=False)]
    queries = queries + 0.01 * rng.standard_normal(queries.shape).astype(np.float32)
    simple = SimpleRetriever(emb, docs)
    exact = ExactRetriever(emb, docs)
    sharded = ShardedRetriever(emb, docs)
    ks = [5] * len(queries)
    expected = simple.batch_retrieve(queries, ks)
    assert exact.batch_retrieve(queries, ks) == expected
    assert sharded.batch_retrieve(queries, ks) == expected


def test_simple_retriever_tie_break_matches_top_k():
    """The numpy oracle must tie-break like lax.top_k (lowest index wins) —
    duplicate documents/embeddings are common and argpartition's arbitrary
    intra-tie order made oracle-parity checks flaky. One-hot embeddings make
    every score exactly 0 or 1 in BOTH implementations, so the comparison
    tests pure tie-breaking, not float rounding."""
    import jax.numpy as jnp
    from rag_serving_system.core.retriever import SimpleRetriever
    from rag_serving_system.ops.topk import cosine_topk_reference

    eye = np.eye(8, dtype=np.float32)
    # docs 0..7 distinct; 8..11 duplicate 0..3; 12..13 duplicate 0..1
    emb = np.concatenate([eye, eye[:4], eye[:2]])
    docs = [f"d{i}" for i in range(len(emb))]
    r = SimpleRetriever(emb, docs)
    q = eye[:5]  # query i scores 1.0 on every copy of basis vector i, 0 else
    _, want = cosine_topk_reference(jnp.asarray(emb), jnp.asarray(q), 6)
    got = r.batch_retrieve(q, [6] * 5)
    want_docs = [[docs[i] for i in row] for row in np.asarray(want)]
    assert got == want_docs


def test_simple_retriever_empty_and_malformed(rng):
    from rag_serving_system.core.retriever import SimpleRetriever

    empty = SimpleRetriever(np.zeros((0, 16), np.float32), [])
    assert empty.retrieve(rng.standard_normal(16).astype(np.float32), 2) == []
    r = SimpleRetriever(rng.standard_normal((4, 16)).astype(np.float32),
                        ["a", "b", "c", "d"])
    assert r.retrieve(np.zeros(7, np.float32), 2) == []  # wrong dim → empty


def test_device_retrievers_clamp_k_to_max_k(rng):
    """A huge requested k must clamp to the compiled max_k width instead of
    compiling an unbounded-k kernel (k-DoS guard at the retriever level)."""
    from rag_serving_system.core.retriever import ExactRetriever

    docs = [f"doc {i}" for i in range(50)]
    emb = rng.standard_normal((50, 32)).astype(np.float32)
    r = ExactRetriever(emb, docs, max_k=4)
    out = r.batch_retrieve(rng.standard_normal((2, 32)).astype(np.float32),
                           [5000, 2])
    assert len(out[0]) == 4 and len(out[1]) == 2
