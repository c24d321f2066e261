"""IVF (inverted-file) approximate retrieval for very large corpora.

The reference only does brute-force exact search (rag_service/core/
retriever.py); exact is also this framework's default (ops/topk.py). IVF
is the capacity escape hatch beyond that: scan cost drops from O(N) to
O(C + nprobe * cap) rows per query.

Static shapes drive the layout:
- k-means runs as jit-compiled assign/update iterations on device
  (a matmul gives the (N, C) assignment scores; segment-sum via one-hot
  matmul).
- clusters are packed into a FIXED-CAPACITY (C, cap, D) tensor (padded with
  zero rows / -1 indices) so nprobe search is static-shape gathers + einsum
  — no dynamic shapes anywhere, everything jit-compiles once.
- search: score centroids (B, C) → top-nprobe clusters → gather their blocks
  → exact cosine within candidates → global top-k with true doc indices.

Recall is controlled by nprobe; with nprobe = C it degenerates to exact.

Regime notes:
- IVF only helps when the embedding distribution clusters (true for real
  text embeddings; tests/test_ivf.py pins recall on clustered data). On
  UNIFORM random vectors recall collapses — nothing is clusterable.
- Whether IVF beats the exact GEMM + top-k on the GPU, and from which
  corpus size, is not measured yet; the candidate gather
  (B, nprobe, cap, D) should be kept small via more, smaller clusters
  (cap ~ sqrt(N)).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rag_serving_system.ops.topk import _l2_normalize

NEG_INF = -3.0e38


class IvfIndex(NamedTuple):
    centroids: jax.Array   # (C, D) f32, L2-normalized
    packed: jax.Array      # (C, cap, D) f32 — cluster-major corpus rows
    packed_idx: jax.Array  # (C, cap) i32 — original doc ids, -1 = padding


@functools.partial(jax.jit, static_argnames=("n_clusters", "iters"))
def _kmeans(corpus: jax.Array, n_clusters: int, iters: int, seed: int = 0):
    """Spherical k-means (cosine) on device. Returns (C, D) centroids."""
    n, d = corpus.shape
    key = jax.random.PRNGKey(seed)
    init = jax.random.choice(key, n, shape=(n_clusters,), replace=False)
    centroids = corpus[init]

    def step(centroids, _):
        scores = corpus @ centroids.T                      # (N, C)
        assign = jnp.argmax(scores, axis=1)                # (N,)
        onehot = jax.nn.one_hot(assign, n_clusters, dtype=corpus.dtype)
        sums = onehot.T @ corpus                           # (C, D)
        counts = jnp.sum(onehot, axis=0)[:, None]
        new = jnp.where(counts > 0, sums / jnp.maximum(counts, 1), centroids)
        return _l2_normalize(new), None

    centroids, _ = jax.lax.scan(step, _l2_normalize(centroids), None, length=iters)
    return centroids


def build_ivf(corpus, n_clusters: int = 256, iters: int = 10,
              cap: int | None = None, seed: int = 0) -> IvfIndex:
    """Build the index. `corpus` (N, D) should be L2-normalized. Host-side
    packing (one pass of numpy bucketing); training runs on device."""
    import numpy as np

    corpus = jnp.asarray(corpus, jnp.float32)
    centroids = _kmeans(corpus, n_clusters, iters, seed)
    assign = np.asarray(jnp.argmax(corpus @ centroids.T, axis=1))
    corpus_np = np.asarray(corpus)

    buckets = [np.where(assign == c)[0] for c in range(n_clusters)]
    max_sz = max(1, max(len(b) for b in buckets))
    if cap is None:
        cap = max_sz
    elif max_sz > cap:
        raise ValueError(f"cluster capacity {cap} < largest cluster {max_sz}")

    n, d = corpus_np.shape
    packed = np.zeros((n_clusters, cap, d), np.float32)
    packed_idx = np.full((n_clusters, cap), -1, np.int32)
    for c, b in enumerate(buckets):
        packed[c, :len(b)] = corpus_np[b]
        packed_idx[c, :len(b)] = b
    return IvfIndex(centroids=centroids,
                    packed=jnp.asarray(packed),
                    packed_idx=jnp.asarray(packed_idx))


@functools.partial(jax.jit, static_argnames=("k", "nprobe"))
def ivf_search(index: IvfIndex, queries: jax.Array, k: int,
               nprobe: int = 8) -> tuple[jax.Array, jax.Array]:
    """Approximate cosine top-k. Returns ((B, k) scores, (B, k) doc ids;
    id -1 marks below-capacity slots when fewer than k candidates exist)."""
    q = _l2_normalize(queries.astype(jnp.float32))          # (B, D)
    c_scores = q @ index.centroids.T                        # (B, C)
    # clamp the probe and candidate widths to what the index actually holds:
    # lax.top_k REQUIRES k <= axis size (small corpora build fewer clusters
    # than requested, and tiny nprobe*cap pools can undercut k)
    nprobe = min(nprobe, index.centroids.shape[0])
    _, probe = jax.lax.top_k(c_scores, nprobe)              # (B, nprobe)

    cand = index.packed[probe]                              # (B, nprobe, cap, D)
    cand_idx = index.packed_idx[probe]                      # (B, nprobe, cap)
    scores = jnp.einsum("bd,bpcd->bpc", q, cand,
                        preferred_element_type=jnp.float32)
    b = q.shape[0]
    scores = scores.reshape(b, -1)
    cand_idx = cand_idx.reshape(b, -1)
    scores = jnp.where(cand_idx >= 0, scores, NEG_INF)      # mask padding
    k_eff = min(k, scores.shape[1])
    top_s, pos = jax.lax.top_k(scores, k_eff)
    top_i = jnp.take_along_axis(cand_idx, pos, axis=1)
    if k_eff < k:  # keep the (B, k) contract; -1 marks missing candidates
        pad = ((0, 0), (0, k - k_eff))
        top_s = jnp.pad(top_s, pad, constant_values=NEG_INF)
        top_i = jnp.pad(top_i, pad, constant_values=-1)
    return top_s, top_i
