"""Retriever classes: the serving-facing wrapper around the top-k ops.

Mirrors the reference's retriever interface
(reference: rag_service/core/retriever.py:615,686):
    retrieve(query_embedding, k) -> list[str]
    batch_retrieve(query_embeddings, ks) -> list[list[str]]

Implementations, in the same spirit as the reference's trio
(SimpleRetriever / CupyRetriever / TritonKnnRetriever):

- `SimpleRetriever`  — pure numpy oracle (reference retriever.py:57-166 role)
- `ExactRetriever`   — single-device GEMM + top-k over the resident corpus
- `IvfRetriever`     — approximate IVF for very large corpora
- `ShardedRetriever` — corpus sharded over a jax Mesh, exact merged top-k

All use the reference's fixed-max_k trick for variable per-query k: requests
are clamped to the compiled `max_k` width and sliced per query on host
(reference retriever.py:744-790) — an attacker-supplied huge k can never
trigger an unbounded recompile. Defensive input validation follows the
reference's behavior of returning empty results on malformed input rather
than raising (retriever.py:704-732).
"""

from __future__ import annotations

import logging
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rag_serving_system.ops.topk import cosine_topk
from rag_serving_system.parallel.mesh import make_mesh
from rag_serving_system.parallel.sharded_topk import shard_corpus, sharded_cosine_topk

logger = logging.getLogger(__name__)


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


class SimpleRetriever:
    """Numpy exact cosine top-k — correctness oracle and CPU fallback.

    Tie-breaking matches `jax.lax.top_k` (equal scores → lowest index wins):
    a stable argsort over negated scores, NOT argpartition, whose arbitrary
    intra-tie order would make oracle-parity checks flaky on corpora with
    duplicate documents."""

    def __init__(self, embeddings: np.ndarray, documents: Sequence[str]):
        self.documents = list(documents)
        self.embeddings = _l2n(np.asarray(embeddings, dtype=np.float32))

    def retrieve(self, query_embedding: np.ndarray, k: int = 2) -> List[str]:
        q = _l2n(np.asarray(query_embedding, dtype=np.float32).reshape(-1))
        n = len(self.documents)
        if n == 0 or q.shape[0] != self.embeddings.shape[-1]:
            logger.error("retrieve: bad query shape %s or empty corpus", q.shape)
            return []
        k = max(1, min(int(k), n))
        sims = self.embeddings @ q
        idx = np.argsort(-sims, kind="stable")[:k]
        return [self.documents[i] for i in idx]

    def batch_retrieve(self, query_embeddings: np.ndarray,
                       ks: Sequence[int]) -> List[List[str]]:
        return [self.retrieve(q, k) for q, k in zip(np.asarray(query_embeddings), ks)]


class _DeviceRetriever:
    """Shared serving surface for the device-backed retrievers: validation,
    the fixed-max_k clamp, one device→host index transfer, per-query host
    slicing. Subclasses set `documents`, `n`, `max_k`, `_dim` and implement
    `topk_indices(queries, k) -> (scores, indices)`."""

    documents: List[str]
    n: int
    max_k: int
    _dim: int

    def topk_indices(self, query_embeddings, k: int):
        raise NotImplementedError

    def retrieve(self, query_embedding: np.ndarray, k: int = 2) -> List[str]:
        return self.batch_retrieve(np.asarray(query_embedding)[None, :], [k])[0]

    def batch_retrieve(self, query_embeddings: np.ndarray,
                       ks: Sequence[int]) -> List[List[str]]:
        if len(ks) == 0:
            return []
        q = np.asarray(query_embeddings, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self._dim or self.n == 0:
            logger.error("batch_retrieve: bad query shape %s (corpus n=%d)",
                         q.shape, self.n)
            return [[] for _ in ks]
        want = [max(1, min(int(k), self.n)) for k in ks]
        ks = [min(k, self.max_k) for k in want]
        if ks != want:
            logger.warning("k clamped to compiled max_k=%d (requested up to "
                           "%d)", self.max_k, max(want))
        _, idx = self.topk_indices(q, max(ks))
        idx = np.asarray(idx)  # one device→host transfer for the whole batch
        # -1 marks below-capacity slots (IVF padding)
        return [[self.documents[i] for i in row[:k] if i >= 0]
                for row, k in zip(idx, ks)]


class ExactRetriever(_DeviceRetriever):
    """Single-device exact similarity + top-k (ops/topk.py).

    The corpus is resident in device memory, pre-normalized once at init
    (analogue of the reference's one-time `cp.asarray` upload, retriever.py:582).
    """

    def __init__(self, embeddings: np.ndarray, documents: Sequence[str],
                 max_k: int = 16, corpus_dtype: str = "float32"):
        self.documents = list(documents)
        corpus = _l2n(np.asarray(embeddings, dtype=np.float32))
        # bf16 halves the corpus bytes streamed per query batch; int8 halves
        # them again and fits 10M-doc corpora in one card's memory.
        # Near-tie orderings can differ from the f32 oracle, so
        # exact-parity deployments keep the default f32
        self.corpus_dtype = corpus_dtype
        self.n = corpus.shape[0]
        self._dim = corpus.shape[1] if corpus.ndim == 2 else 0
        self.max_k = max(1, min(max_k, self.n))
        if corpus_dtype == "int8":
            from rag_serving_system.ops.topk import (
                quantize_corpus_int8_chunked)
            import os
            chunk_rows = int(os.environ.get("TOPK_CHUNK_ROWS",
                                            str(4_194_304)))
            self.corpus_chunks, self.corpus_mean = (
                quantize_corpus_int8_chunked(corpus, chunk_rows=chunk_rows))
        else:
            dt = jnp.bfloat16 if corpus_dtype == "bfloat16" else jnp.float32
            self.corpus = jax.device_put(jnp.asarray(corpus, dtype=dt))

    def topk_indices(self, query_embeddings, k: int):
        """Device path: returns ((B,k) scores, (B,k) indices) jax arrays."""
        q = jnp.asarray(query_embeddings, dtype=jnp.float32)
        if self.corpus_dtype == "int8":
            from rag_serving_system.ops.topk import cosine_topk_int8_chunked
            return cosine_topk_int8_chunked(
                self.corpus_chunks, q, k, corpus_mean=self.corpus_mean)
        return cosine_topk(self.corpus, q, k)


class IvfRetriever(_DeviceRetriever):
    """Approximate (IVF) retriever for very large corpora — O(C + nprobe*cap)
    rows scanned per query instead of O(N). Same serving interface as the
    exact retrievers; recall controlled by nprobe (nprobe=C ⇒ exact)."""

    def __init__(self, embeddings: np.ndarray, documents: Sequence[str],
                 n_clusters: int = 64, nprobe: int = 8, iters: int = 10,
                 max_k: int = 16):
        from rag_serving_system.ops.ivf import build_ivf

        self.documents = list(documents)
        corpus = _l2n(np.asarray(embeddings, dtype=np.float32))
        self.n = corpus.shape[0]
        self._dim = corpus.shape[1] if corpus.ndim == 2 else 0
        self.max_k = max(1, min(max_k, self.n))
        self.index = build_ivf(corpus, n_clusters=min(n_clusters, self.n),
                               iters=iters)
        # clamp to the clusters actually BUILT (small corpora get fewer than
        # requested; ivf_search's top_k would reject nprobe > C)
        self.nprobe = min(nprobe, self.index.centroids.shape[0])

    def topk_indices(self, query_embeddings, k: int):
        from rag_serving_system.ops.ivf import ivf_search

        q = jnp.asarray(query_embeddings, dtype=jnp.float32)
        return ivf_search(self.index, q, k, nprobe=self.nprobe)


class ShardedRetriever(_DeviceRetriever):
    """Corpus sharded on N over a jax Mesh; exact top-k with merged
    per-shard winners."""

    def __init__(self, embeddings: np.ndarray, documents: Sequence[str],
                 mesh=None, max_k: int = 16):
        self.documents = list(documents)
        self.mesh = mesh if mesh is not None else make_mesh()
        corpus = _l2n(np.asarray(embeddings, dtype=np.float32))
        self.n = corpus.shape[0]
        self._dim = corpus.shape[1] if corpus.ndim == 2 else 0
        self.max_k = max(1, min(max_k, self.n))
        self.corpus = shard_corpus(jnp.asarray(corpus), self.mesh)

    def topk_indices(self, query_embeddings, k: int):
        q = jnp.asarray(query_embeddings, dtype=jnp.float32)
        return sharded_cosine_topk(self.corpus, q, k, self.mesh,
                                   valid_n=self.n)
