"""Exact cosine top-k retrieval over a device-resident corpus.

The reference (rag_service/core/retriever.py:594-611, 744-769) scores the
whole (B, N) similarity matrix with one cuBLAS GEMM and selects on the
device. This module does the same through XLA: one GEMM in the corpus's own
dtype with float32 accumulation, then `lax.top_k` (lowest index wins ties).

- The corpus is expected PRE-NORMALIZED (the datasets L2-normalize,
  scripts/fact_dataset.py); queries are normalized on the fly, so dot
  products are cosine similarities.
- A float32 corpus is scored at HIGHEST precision: the GPU's default float32
  matmul runs in TF32 (about three decimal digits), which reorders near-ties
  against the exact oracle. A bfloat16 corpus halves the bytes streamed and
  may reorder near-ties; an int8 corpus quarters them (see below).

`cosine_topk_reference` is the float32 oracle the tests compare against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG_INF = -3.0e38


def _l2_normalize(x: jax.Array, eps: float = 1e-12) -> jax.Array:
    n = jnp.sqrt(jnp.sum(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True))
    return (x / jnp.maximum(n, eps)).astype(x.dtype)


@functools.partial(jax.jit, static_argnames=("k", "normalize_queries", "normalize_corpus"))
def cosine_topk_reference(
    corpus: jax.Array,      # (N, D) — pre-normalized unless normalize_corpus
    queries: jax.Array,     # (B, D)
    k: int,
    normalize_queries: bool = True,
    normalize_corpus: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Exact float32 batched cosine top-k. Returns (scores, indices)."""
    q = _l2_normalize(queries) if normalize_queries else queries
    c = _l2_normalize(corpus) if normalize_corpus else corpus
    sims = jnp.einsum("bd,nd->bn", q.astype(jnp.float32), c.astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)
    return jax.lax.top_k(sims, k)


@functools.partial(jax.jit, static_argnames=("k", "normalize_queries"))
def cosine_topk(
    corpus: jax.Array,      # (N, D) pre-normalized, float32 or bfloat16
    queries: jax.Array,     # (B, D)
    k: int,
    normalize_queries: bool = True,  # False when the caller pre-normalized
) -> tuple[jax.Array, jax.Array]:
    """Serving top-k: GEMM with the corpus in its own dtype (float32
    accumulation), then `lax.top_k`. Returns ((B, k) f32 scores, (B, k) i32
    indices)."""
    q = _l2_normalize(queries) if normalize_queries else queries
    precision = (jax.lax.Precision.HIGHEST if corpus.dtype == jnp.float32
                 else jax.lax.Precision.DEFAULT)
    sims = jnp.einsum("bd,nd->bn", q.astype(corpus.dtype), corpus,
                      preferred_element_type=jnp.float32, precision=precision)
    return jax.lax.top_k(sims, k)


# ---------------------------------------------------------------------------
# int8 corpus: a quarter of float32's bytes, and 10M x 1024 fits one card
# (10.2 GB). Mean-centered per-row symmetric quantization of the
# pre-normalized corpus. The corpus stays int8 in device memory and is
# upcast inside the einsum (|v| <= 127 is exact in bfloat16); the per-row
# scale and the rank-invariant `q . mean` term are applied to the (B, N)
# scores, so ranking follows the residual dot product.
# ---------------------------------------------------------------------------

def quantize_corpus_int8(
    corpus: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Mean-centered per-row symmetric int8 quantization. Returns
    (values (N,D) int8, scales (1,N) f32, mean (1,D) f32) with
    corpus ≈ mean + values * scales.T[:, None].

    Centering matters for real text embeddings: e5's SQuAD vectors are
    roughly one shared unit vector plus much smaller residuals, and
    `q . mean` is constant per query so it cannot change ranking —
    quantizing only the residual makes the int8 step much finer
    (tests/test_topk.py pins f32-parity task recall on the repo's SQuAD
    embeddings). For isotropic corpora mean ≈ 0 and centering is a no-op."""
    c = corpus.astype(jnp.float32)
    mean = jnp.mean(c, axis=0, keepdims=True)                  # (1, D)
    r = c - mean
    amax = jnp.max(jnp.abs(r), axis=1, keepdims=True)          # (N, 1)
    scale = jnp.maximum(amax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(r / scale), -127, 127).astype(jnp.int8)
    return q, scale.reshape(1, -1), mean


@functools.partial(jax.jit, static_argnames=("k", "normalize_queries"))
def cosine_topk_int8(
    corpus_q: jax.Array,        # (N, D) int8 — from quantize_corpus_int8
    corpus_scales: jax.Array,   # (1, N) f32
    queries: jax.Array,         # (B, D)
    k: int,
    corpus_mean: jax.Array | None = None,   # (1, D) f32 (centered corpora)
    normalize_queries: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Top-k over an int8-quantized corpus. Scores approximate cosine
    (quantization error; near-tie order can differ from the f32 oracle)."""
    qn = _l2_normalize(queries) if normalize_queries else queries
    qn = qn.astype(jnp.float32)
    raw = jnp.einsum("bd,nd->bn", qn.astype(jnp.bfloat16),
                     corpus_q.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    sims = raw * corpus_scales
    if corpus_mean is not None:
        sims = sims + qn @ corpus_mean.reshape(-1, 1)           # (B, 1)
    return jax.lax.top_k(sims, k)


# ---------------------------------------------------------------------------
# Chunked int8 corpus. Quantization runs on the host in chunks and each
# chunk's top-k is its own dispatch, which bounds both the host's float32
# quantization transients and the (B, chunk) score matrix on the device.
# Equal-size chunks reuse ONE compiled program (the ragged tail compiles
# once more). Per-chunk winners merge exactly: the top-k of a union is the
# top-k of the per-chunk top-ks.
# ---------------------------------------------------------------------------

def quantize_corpus_int8_chunked(
    corpus, chunk_rows: int = 4_194_304,
) -> tuple[list[tuple[jax.Array, jax.Array]], jax.Array]:
    """Quantize host-side (numpy) into equal `chunk_rows` chunks. Returns
    ([(values (C,D) int8, scales (1,C) f32), ...], mean (1,D) f32); the last
    chunk is not padded."""
    import numpy as _np

    c = _np.asarray(corpus, dtype=_np.float32)
    mean = c.mean(axis=0, keepdims=True)
    out = []
    for lo in range(0, c.shape[0], chunk_rows):
        r = c[lo:lo + chunk_rows] - mean
        scale = _np.maximum(_np.abs(r).max(axis=1, keepdims=True), 1e-12) / 127.0
        qv = _np.clip(_np.round(r / scale), -127, 127).astype(_np.int8)
        out.append((jax.device_put(jnp.asarray(qv)),
                    jax.device_put(jnp.asarray(scale.reshape(1, -1)))))
    return out, jax.device_put(jnp.asarray(mean))


def cosine_topk_int8_chunked(
    chunks: list,                       # [(values (C,D) int8, scales (1,C) f32)]
    queries: jax.Array,                 # (B, D)
    k: int,
    corpus_mean: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Exact merge of per-chunk `cosine_topk_int8` winners. Returns
    ((B, k) scores, (B, k) GLOBAL indices)."""
    all_s, all_i = [], []
    base = 0
    for values, scales in chunks:
        s, i = cosine_topk_int8(values, scales, queries, min(k, values.shape[0]),
                                corpus_mean=corpus_mean)
        all_s.append(s)
        all_i.append(i + base)
        base += values.shape[0]
    if len(chunks) == 1:
        return all_s[0], all_i[0]
    cand_s = jnp.concatenate(all_s, axis=1)      # (B, S*k)
    cand_i = jnp.concatenate(all_i, axis=1)
    top_s, pos = jax.lax.top_k(cand_s, k)
    return top_s, jnp.take_along_axis(cand_i, pos, axis=1)
