"""Distributed exact cosine top-k over a sharded corpus.

This is the collective answer to the reference's replica-DP-over-Redis
scaling (SURVEY §5): the (N, D) corpus is sharded on N across the whole mesh;
each device runs the local GEMM + top-k over its shard, then per-shard
(score, global-index) candidates are all-gathered between the devices and
merged with a final `lax.top_k`. Exactness is preserved: the global top-k is
a subset of the union of per-shard top-ks.

Communication cost: all_gather of (B, k) scores + indices per shard —
O(n_shards * B * k * 8 bytes), thousands of times smaller than gathering
the (B, N) score matrix.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from rag_serving_system.ops.topk import NEG_INF, _l2_normalize, cosine_topk


def shard_corpus(corpus: jax.Array, mesh: Mesh) -> jax.Array:
    """Place the (N, D) corpus sharded on N over every mesh device.

    N is padded to a multiple of the device count with zero rows. Pad rows
    score 0 against any query, which CAN beat real rows with negative cosine
    similarity — `sharded_cosine_topk` stays exact by widening the per-shard
    selection by the pad count before masking (see k_local below)."""
    n_dev = mesh.devices.size
    n = corpus.shape[0]
    n_pad = ((n + n_dev - 1) // n_dev) * n_dev
    if n_pad != n:
        corpus = jnp.pad(corpus, ((0, n_pad - n), (0, 0)))
    sharding = NamedSharding(mesh, P(("data", "model"), None))
    return jax.device_put(corpus, sharding)


@functools.partial(jax.jit, static_argnames=("k", "mesh", "valid_n"))
def sharded_cosine_topk(
    corpus_sharded: jax.Array,   # (N_pad, D) sharded on N over ("data","model")
    queries: jax.Array,          # (B, D) replicated
    k: int,
    mesh: Mesh,
    valid_n: int,                # true corpus size (pre-padding)
) -> tuple[jax.Array, jax.Array]:
    """Exact global top-k. Returns ((B,k) f32 scores, (B,k) i32 global indices)."""
    n_pad = corpus_sharded.shape[0]
    n_dev = mesh.devices.size
    shard_n = n_pad // n_dev
    # Exactness with zero-padded rows: a pad row scores 0 and can displace a
    # real row with NEGATIVE similarity from a shard's local top-k. Each shard
    # holds at most (n_pad - valid_n) pad rows, so selecting k + pad_count
    # locally guarantees every shard's true top-k real rows survive the
    # post-selection mask below.
    k_local = min(k + (n_pad - valid_n), shard_n)

    q = _l2_normalize(queries.astype(jnp.float32))

    def local_topk(c_shard, q_rep):
        # flat shard index over the combined ("data","model") axes
        di = jax.lax.axis_index(("data", "model"))
        base = di * shard_n
        s, i = cosine_topk(c_shard, q_rep, k_local, normalize_queries=False)
        # mask padded rows (they score 0; k_local already over-selected so no
        # real row was displaced)
        gidx = base + i
        s = jnp.where(gidx < valid_n, s, NEG_INF)
        return s[None], gidx[None]      # (1, B, k_local) per shard

    # per-shard candidates come out stacked on a leading device axis; the
    # merge below runs under the same jit — GSPMD inserts the all-gather
    # of the tiny (n_dev, B, k_local) candidate tensors, never the corpus
    fn = shard_map(
        local_topk,
        mesh=mesh,
        in_specs=(P(("data", "model"), None), P(None, None)),
        out_specs=(P(("data", "model"), None, None),
                   P(("data", "model"), None, None)),
    )
    all_s, all_i = fn(corpus_sharded, q)                # (n_dev, B, k_local)
    b = q.shape[0]
    cand_s = jnp.transpose(all_s, (1, 0, 2)).reshape(b, n_dev * k_local)
    cand_i = jnp.transpose(all_i, (1, 0, 2)).reshape(b, n_dev * k_local)
    # tie-break identical scores toward the lowest global index so the
    # merged result matches single-device lax.top_k semantics
    order = jnp.argsort(cand_i, axis=1)
    cand_s = jnp.take_along_axis(cand_s, order, axis=1)
    cand_i = jnp.take_along_axis(cand_i, order, axis=1)
    top_s, pos = jax.lax.top_k(cand_s, k)
    top_i = jnp.take_along_axis(cand_i, pos, axis=1)
    return top_s, top_i
