"""Prefill attention: the padded self-attention wrapper and packed attention.

`self_attention` serves the decoder's prompt prefill (causal, left-padded
prompts), the prefix-KV builder (causal, right-padded prefixes) and the
encoder (non-causal, right-padded). `impl` comes from
`rag_serving_system.backend.kernels()`:

- "einsum": `models.layers.attention` with an additive mask — the plain XLA
  path and the oracle; it materializes the (B, H, S, S) float32 scores.
- "cudnn" / "xla": `jax.nn.dot_product_attention`. cuDNN's fused kernel
  never writes the scores to device memory, but its padding mask assumes
  each row's valid tokens come first. So each row is rotated to put its
  contiguous valid run at the front, attended with sequence lengths (and
  cuDNN's causal mask), and rotated back. "xla" runs the same formulation
  through XLA, which is how the CPU tests check it.

`packed_attention` is block-diagonal causal attention over one (1, T)
stream of back-to-back rows (segment ids mark the rows): each token attends
to earlier tokens of its own row. Neither XLA nor cuDNN's public interface
computes it without the (T, T) scores, so on the GPU it runs a Pallas kernel
compiled by Triton (`_packed_kernel`). Each query block walks only the key
blocks from the start of its first row to the diagonal, so the work grows
with sum(len_b * max_len), not T^2.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl

from rag_serving_system.models.layers import (
    NEG_INF,
    attention,
    causal_padding_bias,
    padding_bias,
)

# finite mask value for the kernel: -inf - -inf would give NaN in the
# online-softmax correction
_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _rotate(x: jax.Array, shift: jax.Array) -> jax.Array:
    """Per-row rotation along axis 1: out[b, t] = x[b, (t + shift[b]) % S]."""
    s = x.shape[1]
    idx = (jnp.arange(s)[None, :] + shift[:, None]) % s          # (B, S)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
    return jnp.take_along_axis(x, idx, axis=1)


def self_attention(
    q: jax.Array,          # (B, S, Hq, D)
    k: jax.Array,          # (B, S, Hk, D)
    v: jax.Array,          # (B, S, Hk, D)
    mask: jax.Array,       # (B, S) {0,1}; each row's valid tokens contiguous
    *,
    causal: bool,
    impl: str,
) -> jax.Array:
    """Grouped-query self-attention over a padded batch; (B, S, Hq, D) out.

    Causal: query t attends to valid keys at positions <= t. Non-causal:
    every query (pads included, as the encoder's unmasked mean pool needs
    them) attends to every valid key. Rows without a valid key give zeros;
    in causal mode so do the padding queries (their outputs feed only keys
    that every real query masks)."""
    if impl == "einsum":
        bias = causal_padding_bias(mask) if causal else padding_bias(mask)
        return attention(q, k, v, bias)
    if impl not in ("cudnn", "xla"):
        raise ValueError(f"unknown attention implementation {impl!r}")
    b, s = mask.shape
    valid = mask > 0
    n = jnp.sum(valid, axis=-1).astype(jnp.int32)                  # (B,)
    start = jnp.argmax(valid, axis=-1).astype(jnp.int32)           # first valid
    k_r, v_r = _rotate(k, start), _rotate(v, start)
    if causal:
        out = jax.nn.dot_product_attention(
            _rotate(q, start), k_r, v_r, is_causal=True,
            query_seq_lengths=n, key_value_seq_lengths=n,
            implementation=impl)
        out = _rotate(out, -start)
        pos = jnp.arange(s)[None, :]
        keep = (pos >= start[:, None]) & (pos < (start + n)[:, None])
    else:
        out = jax.nn.dot_product_attention(
            q, k_r, v_r,
            query_seq_lengths=jnp.full((b,), s, jnp.int32),
            key_value_seq_lengths=n, implementation=impl)
        keep = jnp.broadcast_to((n > 0)[:, None], (b, s))
    return jnp.where(keep[:, :, None, None], out, 0).astype(q.dtype)


def biased_attention(q, k, v, bias, *, impl: str) -> jax.Array:
    """Attention with an additive (B, 1, S, T) float32 mask — the prefix-KV
    path, where short suffix queries see [valid prefix slots | causal
    suffix], two disjoint ranges no sequence-length mask expresses. cuDNN
    reads the bias in the query's dtype (0 and -1e9 survive bf16)."""
    if impl == "einsum":
        return attention(q, k, v, bias)
    if impl not in ("cudnn", "xla"):
        raise ValueError(f"unknown attention implementation {impl!r}")
    return jax.nn.dot_product_attention(q, k, v, bias=bias.astype(q.dtype),
                                        implementation=impl)


def packed_attention_reference(q, k, v, seg):
    """jnp oracle for packed attention (and the CPU path): block-diagonal
    causal bias from segment ids. O(T^2) memory."""
    t = q.shape[1]
    col = jnp.arange(t)
    valid = (seg[0][:, None] == seg[0][None, :]) & (col[None, :] <= col[:, None])
    bias = jnp.where(valid, 0.0, NEG_INF)[None, None].astype(jnp.float32)
    return attention(q, k, v, bias)


def _packed_kernel(q_ref, k_ref, v_ref, seg_ref, start_ref, o_ref, *,
                   sm_scale, block_q, block_k):
    """One (query block, query head) program. k/v refs hold the whole
    stream of this head's KV head; seg/start hold every token's segment id
    and the index where its segment begins."""
    iq = pl.program_id(0)
    q_slice = pl.ds(iq * block_q, block_q)
    q = q_ref[...]                                               # (BQ, D)
    q_seg = seg_ref[q_slice]
    # segments ascend, so the block's first token has the earliest start;
    # key blocks before it belong to other rows and are never visited
    lo = jnp.min(start_ref[q_slice]) // block_k
    hi = lax.div(block_q * (iq + 1) + block_k - 1, block_k)      # diagonal
    q_pos = iq * block_q + jnp.arange(block_q)
    scale = sm_scale * math.log2(math.e)                         # exp2 domain

    def body(kb, carry):
        o, m, l = carry
        k_slice = pl.ds(kb * block_k, block_k)
        s = pl.dot(q, k_ref[k_slice, :].T) * scale               # (BQ, BK)
        k_pos = kb * block_k + jnp.arange(block_k)
        ok = ((q_seg[:, None] == seg_ref[k_slice][None, :])
              & (q_pos[:, None] >= k_pos[None, :]))
        s = jnp.where(ok, s, _MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=-1))
        corr = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        l_new = corr * l + jnp.sum(p, axis=-1)
        o_new = corr[:, None] * o + pl.dot(p.astype(v_ref.dtype),
                                           v_ref[k_slice, :])
        return o_new, m_new, l_new

    d = q.shape[-1]
    init = (jnp.zeros((block_q, d), jnp.float32),
            jnp.full((block_q,), -jnp.inf, jnp.float32),
            jnp.zeros((block_q,), jnp.float32))
    o, _, l = lax.fori_loop(lo, hi, body, init)
    o_ref[...] = (o / l[:, None]).astype(o_ref.dtype)


@functools.partial(jax.jit, static_argnames=("block_q", "block_k",
                                             "num_warps", "interpret"))
def packed_attention_pallas(
    q: jax.Array,          # (1, T, Hq, D) packed token stream
    k: jax.Array,          # (1, T, Hk, D)
    v: jax.Array,          # (1, T, Hk, D)
    seg: jax.Array,        # (1, T) int32 ascending segment ids; pads at the tail
    block_q: int = 128,
    block_k: int = 64,
    num_warps: int = 4,
    interpret: bool = False,
) -> jax.Array:
    """Packed causal attention through the Pallas kernel (Triton route).
    `interpret=True` runs it on the CPU for tests only. The default blocks
    and warps are the fastest of a sweep on an H100 at the squad_real packed
    shape (T=12288, 32 rows; scripts/compare_prefill.py --sweep)."""
    from jax.experimental.pallas import triton as pl_triton

    _, t, hq, d = q.shape
    hk = k.shape[2]
    group = hq // hk
    if t % block_q or t % block_k:
        raise ValueError(f"packed length {t} must be a multiple of the block "
                         f"sizes ({block_q}, {block_k})")
    seg_t = seg[0].astype(jnp.int32)
    start = jnp.searchsorted(seg_t, seg_t, side="left").astype(jnp.int32)
    kernel = functools.partial(_packed_kernel, sm_scale=1.0 / math.sqrt(d),
                               block_q=block_q, block_k=block_k)
    out = pl.pallas_call(
        kernel,
        grid=(t // block_q, hq),
        in_specs=[
            pl.BlockSpec((block_q, None, d), lambda i, h: (i, h, 0)),
            pl.BlockSpec((t, None, d), lambda i, h: (0, h // group, 0)),
            pl.BlockSpec((t, None, d), lambda i, h: (0, h // group, 0)),
            pl.BlockSpec((t,), lambda i, h: (0,)),
            pl.BlockSpec((t,), lambda i, h: (0,)),
        ],
        out_specs=pl.BlockSpec((block_q, None, d), lambda i, h: (i, h, 0)),
        out_shape=jax.ShapeDtypeStruct((t, hq, d), q.dtype),
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=2),
        interpret=interpret,
        name="packed_attention",
    )(q[0], k[0], v[0], seg_t, start)
    return out[None]


def packed_attention(q, k, v, seg, *, impl: str) -> jax.Array:
    """Packed causal attention with the implementation `impl` names."""
    if impl == "einsum":
        return packed_attention_reference(q, k, v, seg)
    if impl == "pallas_triton":
        return packed_attention_pallas(q, k, v, seg)
    raise ValueError(f"unknown packed attention implementation {impl!r}")
