"""Qwen2-family causal decoder (Qwen2.5-1.5B-Instruct) as pure-JAX functions.

Replaces the reference's HF text-generation pipeline stage
(reference: rag_service/core/batch_processor.py:104-105: left-padded batch,
`max_new_tokens=10, do_sample=True`). Design choices:

- Prefill is one full-attention forward over the (left-padded) prompt bucket;
  decode is a `lax.scan` of single-token steps against a static-shape KV cache
  — the whole generate() is ONE compiled XLA program per (batch, prompt-len)
  bucket; no per-token Python dispatch like the reference's HF pipeline.
- GQA (12 query heads / 2 KV heads) is computed grouped — KV heads are never
  materialized repeated.
- Left padding means real tokens are right-aligned, so generated tokens are
  contiguous after the prompt: cache writes are static-offset dynamic slices.

Params pytree layout (dense weights stored (in, out); QKV fused into one
(H, Hq*D + 2*Hk*D) matmul and gate+up into one (H, 2F) matmul — fewer,
larger matmuls). Layer weights are STACKED on a leading L axis and the
forwards `lax.scan` over them: the compiled program contains one layer body
instead of L unrolled copies, which cuts XLA compile time ~L-fold:
  {"embed": (V, H),
   "layers": {"ln1": (L,H), "qkv_w": (L,H,·), "qkv_b": (L,·), "o_w": (L,·,H),
              "ln2": (L,H), "gu_w": (L,H,2F), "down_w": (L,F,H)},
   "ln_f": (H,), "lm_head": (H, V) — omitted when tied (lm_head = embed.T)}
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rag_serving_system.backend import kernels
from rag_serving_system.models.configs import DecoderConfig
from rag_serving_system.models.layers import (
    NEG_INF,
    apply_rope,
    attention,
    causal_padding_bias,
    dense,
    dense_w8a8,
    rms_norm,
    rope_freqs,
    silu,
)
from rag_serving_system.ops.attention import (biased_attention,
                                             packed_attention, self_attention)


class KVCache(NamedTuple):
    # STACKED (L, B, T_max, Hk, D) arrays — the layer scan slices its row per
    # step (cache.k[li] still reads layer li, e.g. in tests)
    k: jax.Array
    v: jax.Array


def _qkv(params, cfg, x, b, s, act_quant=False):
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    mm = dense_w8a8 if act_quant else dense
    qkv = mm(x, params["qkv_w"], params.get("qkv_b"))  # Llama: no bias
    q = qkv[..., :qd].reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = qkv[..., qd:qd + kvd].reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = qkv[..., qd + kvd:].reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _mlp(params, x, act_quant=False):
    mm = dense_w8a8 if act_quant else dense
    gu = mm(x, params["gu_w"])
    f = gu.shape[-1] // 2
    return mm(silu(gu[..., :f]) * gu[..., f:], params["down_w"])


def _layer_forward(layer, cfg, x, positions, inv_freq, b, p, act_quant,
                   attend):
    """One transformer block shared by prefill and compute_prefix_kv:
    norm → fused QKV → RoPE → `attend` (caller supplies attention + any
    prefix-KV concat, returning (attn_out, k, v)) → output proj → MLP.
    Returns (x, k, v) with k/v as seen by attention (post-concat)."""
    h = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
    q, k, v = _qkv(layer, cfg, h, b, p, act_quant=act_quant)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    a, k, v = attend(q, k, v)
    a = a.reshape(b, p, cfg.num_heads * cfg.head_dim)
    mm = dense_w8a8 if act_quant else dense
    x = x + mm(a, layer["o_w"])
    h = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
    return x + _mlp(layer, h, act_quant=act_quant), k, v


def embed_lookup(params: dict, ids: jax.Array, dtype) -> jax.Array:
    """Token embedding gather; supports an int8 per-row QuantizedWeight."""
    emb = params["embed"]
    if hasattr(emb, "q"):
        rows = jnp.take(emb.q, ids, axis=0).astype(jnp.float32)
        scale = jnp.take(emb.scale, ids, axis=0)
        return (rows * scale).astype(dtype)
    return jnp.take(emb, ids, axis=0).astype(dtype)


def logits_from_hidden(params: dict, cfg: DecoderConfig, x: jax.Array) -> jax.Array:
    x = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is not None:
        if hasattr(head, "q"):
            # scale applied to the output column — no dequantized copy
            raw = jnp.einsum("...h,hv->...v", x, head.q.astype(x.dtype),
                             preferred_element_type=jnp.float32)
            return raw * head.scale[0]
        return jnp.einsum("...h,hv->...v", x, head.astype(x.dtype),
                          preferred_element_type=jnp.float32)
    emb = params["embed"]
    if hasattr(emb, "q"):
        # tied int8 head: logits_v = scale_v * (x · q_v)
        raw = jnp.einsum("...h,vh->...v", x, emb.q.astype(x.dtype),
                         preferred_element_type=jnp.float32)
        return raw * emb.scale[:, 0]
    return jnp.einsum("...h,vh->...v", x, emb.astype(x.dtype),
                      preferred_element_type=jnp.float32)


def prefill(
    params: dict,
    cfg: DecoderConfig,
    input_ids: jax.Array,       # (B, P) int32, LEFT-padded
    attention_mask: jax.Array,  # (B, P) int32
    max_new_tokens: int,
    dtype=jnp.bfloat16,
    act_quant: bool = False,    # W8A8 matmuls (prefill is compute-bound)
    prefix_kv=None,                       # (B, L, 2, PL, Hk, D) cached ctx KV
    prefix_len: jax.Array | None = None,  # (B,) int32 valid prefix tokens
    attn_impl: str | None = None,         # None: the platform's kernel
) -> tuple[jax.Array, KVCache]:
    """Full forward over the prompt. Returns (last-position logits (B, V) f32,
    KV cache sized [PL +] P + max_new_tokens).

    With `prefix_kv` (exact prefix-KV reuse — the static-shape answer to
    vLLM-style automatic prefix caching): per-row cached context KV,
    LEFT-aligned and
    valid for the first `prefix_len[b]` slots, computed by
    `compute_prefix_kv` with RoPE positions 0..len-1. The suffix tokens in
    `input_ids` continue at positions prefix_len[b].., attend to
    [valid prefix slots] + [causal suffix], and the returned cache is the
    concatenation — numerically identical attention to prefilling the whole
    prompt, but only the suffix pays matmul FLOPs.

    `prefix_kv` may also be an (int8 values, scales) pair (see
    `quantize_prefix_kv`) — halves cache memory per entry.

    `attn_impl` overrides the platform's prompt-attention kernel; reference
    forwards pass "einsum"."""
    b, p = input_ids.shape
    px_q, px_s = (prefix_kv if isinstance(prefix_kv, (tuple, list))
                  else (prefix_kv, None))
    pl_ = 0 if prefix_kv is None else px_q.shape[3]
    t_max = pl_ + p + max_new_tokens
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta)
    # left-padded → positions count real tokens from the left edge of content
    positions = jnp.cumsum(attention_mask, axis=-1) - 1
    positions = jnp.maximum(positions, 0)
    if prefix_kv is not None:
        positions = positions + prefix_len[:, None]

    x = embed_lookup(params, input_ids, dtype)

    # prompt self-attention goes through the platform's prefill kernel; the
    # prefix-KV path (short suffix queries against [prefix | suffix] keys,
    # two disjoint valid ranges per row) passes the same kernel a bias
    impl = attn_impl or kernels().prefill_attention
    bias = None
    if prefix_kv is not None:
        # (B, 1, P, PL + P): prefix slots valid iff slot < prefix_len (every
        # prefix position precedes every suffix position, so no causal term);
        # suffix block is the usual left-padded causal mask
        pref_valid = jnp.arange(pl_)[None, :] < prefix_len[:, None]   # (B, PL)
        pref_bias = jnp.where(pref_valid, 0.0, NEG_INF)[:, None, None, :]
        bias = jnp.concatenate(
            [jnp.broadcast_to(pref_bias, (b, 1, p, pl_)).astype(jnp.float32),
             causal_padding_bias(attention_mask)], axis=-1)

    # scan over the stacked layer weights: the XLA program holds ONE layer
    # body (compile time ∝ 1 layer, not L — a 28-layer unroll compiled for
    # tens of minutes per shape bucket); weight slices stream per step
    xs = {"layer": params["layers"]}
    if prefix_kv is not None:
        xs["px"] = jnp.moveaxis(px_q, 1, 0)        # (L, B, 2, PL, Hk, D)
        if px_s is not None:
            xs["px_s"] = jnp.moveaxis(px_s, 1, 0)

    def body(x, xs_l):
        def attend(q, k, v):
            if prefix_kv is not None:
                px_l = xs_l["px"]                   # (B, 2, PL, Hk, D)
                pk, pv = px_l[:, 0], px_l[:, 1]
                if px_s is not None:  # int8 storage: dequant fuses into read
                    s_l = xs_l["px_s"]
                    pk = pk.astype(k.dtype) * s_l[:, 0].astype(k.dtype)
                    pv = pv.astype(v.dtype) * s_l[:, 1].astype(v.dtype)
                k = jnp.concatenate([pk.astype(k.dtype), k], axis=1)
                v = jnp.concatenate([pv.astype(v.dtype), v], axis=1)
            if bias is None:
                a = self_attention(q, k, v, attention_mask, causal=True,
                                   impl=impl)
            else:
                a = biased_attention(q, k, v, bias, impl=impl)
            return a, k, v

        x, k, v = _layer_forward(xs_l["layer"], cfg, x, positions, inv_freq,
                                 b, p, act_quant, attend)
        return x, (k, v)

    x, (ks, vs) = jax.lax.scan(body, x, xs)
    # (L, B, PL+P, Hk, D) → pad the time axis out to t_max decode slots
    pad_t = t_max - ks.shape[2]
    ks = jnp.pad(ks, ((0, 0), (0, 0), (0, pad_t), (0, 0), (0, 0)))
    vs = jnp.pad(vs, ((0, 0), (0, 0), (0, pad_t), (0, 0), (0, 0)))

    logits = logits_from_hidden(params, cfg, x[:, -1, :])
    return logits, KVCache(k=ks, v=vs)


@functools.partial(jax.jit, static_argnames=("cfg", "dtype", "act_quant"))
def compute_prefix_kv(
    params: dict,
    cfg: DecoderConfig,
    input_ids: jax.Array,       # (M, PL) int32, RIGHT-padded prefix tokens
    attention_mask: jax.Array,  # (M, PL) int32
    dtype=jnp.bfloat16,
    act_quant: bool = False,
) -> jax.Array:
    """Forward the transformer over a batch of context prefixes and return
    their post-RoPE KV stacked as (M, L, 2, PL, Hk, D) — the payload of one
    prefix-cache entry per row, LEFT-aligned (right padding).

    RoPE positions run 0..n-1 exactly as they would at the front of a full
    prompt, so a cached entry is position-exact for any later prompt that
    starts with the same tokens. Rows only attend causally within themselves
    (trailing pad keys are causally invisible to real queries), which makes
    the per-row KV independent of what else shares the batch."""
    b, p = input_ids.shape
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta)
    positions = jnp.cumsum(attention_mask, axis=-1) - 1
    positions = jnp.maximum(positions, 0)

    x = embed_lookup(params, input_ids, dtype)
    impl = kernels().prefill_attention

    def attend(q, k, v):
        return self_attention(q, k, v, attention_mask, causal=True,
                              impl=impl), k, v

    def body(x, layer):
        x, k, v = _layer_forward(layer, cfg, x, positions, inv_freq, b, p,
                                 act_quant, attend)
        return x, (k, v)

    _, (ks, vs) = jax.lax.scan(body, x, params["layers"])
    # (L, M, PL, Hk, D) pair → (M, L, 2, PL, Hk, D) in the cache's storage dtype
    kv = jnp.stack([ks, vs], axis=1)
    return jnp.transpose(kv, (2, 0, 1, 3, 4, 5)).astype(dtype)


@jax.jit
def quantize_prefix_kv(kv: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Symmetric int8 quantization of prefix KV along the head dim:
    (..., Hk, D) → int8 values + per-(token, head) f32 scale (..., Hk, 1).

    Halves prefix-cache HBM per entry vs bf16 (the scale is 4 bytes per 128
    values); the dequant in `prefill` is a broadcast multiply that XLA fuses
    into the attention operand read. Standard KV-cache quantization — NOT
    bit-exact, opt into with PREFIX_CACHE_DTYPE=int8 (quality bound pinned in
    tests/test_prefix_cache.py)."""
    amax = jnp.max(jnp.abs(kv.astype(jnp.float32)), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(kv.astype(jnp.float32) / scale), -127, 127)
    return q.astype(jnp.int8), scale.astype(jnp.float32)


def decode_step(
    params: dict,
    cfg: DecoderConfig,
    cache: KVCache,
    token: jax.Array,          # (B,) int32
    step: jax.Array,           # scalar int32: index of generated token (0-based)
    prompt_len: int,           # static P
    prompt_mask: jax.Array,    # (B, P) int32
    dtype=jnp.bfloat16,
) -> tuple[jax.Array, KVCache]:
    """One token for every sequence in the batch. Returns ((B, V) f32 logits,
    updated cache)."""
    b = token.shape[0]
    t_max = cache.k.shape[2]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta)
    n_real = jnp.sum(prompt_mask, axis=-1)          # (B,)
    positions = (n_real + step)[:, None]            # (B, 1)
    write_at = prompt_len + step                    # same for all rows (left-pad)

    # attention bias over the cache: prompt pads masked; generated slots
    # valid iff slot index <= current step
    slot = jnp.arange(t_max - prompt_len)
    gen_valid = (slot <= step)[None, :]
    valid = jnp.concatenate(
        [prompt_mask > 0, jnp.broadcast_to(gen_valid, (b, t_max - prompt_len))], axis=1)
    bias = jnp.where(valid, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)

    x = embed_lookup(params, token[:, None], dtype)  # (B, 1, H)

    # Layer scan with the KV cache in the CARRY: each layer writes only its
    # token's (1, B, 1, Hk, D) row into the stacked (L, B, T, Hk, D) arrays
    # via dynamic_update_slice, then reads its layer slice back — XLA
    # aliases scan carries, so the write is in place and the only big
    # memory traffic is the unavoidable attention read of the cache.
    # (Streaming the cache through scan xs and re-emitting it as stacked ys
    # would force a full old-cache read + new-cache write every decode
    # step: ~1 GB extra traffic per token at prompt 512.)
    n_layers = cache.k.shape[0]

    def body(carry, xs_l):
        x, K, V = carry
        layer, li = xs_l
        h = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, cfg, h, b, 1)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        K = jax.lax.dynamic_update_slice(
            K, k[None].astype(K.dtype), (li, 0, write_at, 0, 0))
        V = jax.lax.dynamic_update_slice(
            V, v[None].astype(V.dtype), (li, 0, write_at, 0, 0))
        ck = jax.lax.dynamic_slice_in_dim(K, li, 1, 0)[0]
        cv = jax.lax.dynamic_slice_in_dim(V, li, 1, 0)[0]
        a = attention(q, ck.astype(dtype), cv.astype(dtype), bias)
        a = a.reshape(b, 1, cfg.num_heads * cfg.head_dim)
        x = x + dense(a, layer["o_w"])
        h = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
        x = x + _mlp(layer, h)
        return (x, K, V), None

    (x, new_k, new_v), _ = jax.lax.scan(
        body, (x, cache.k, cache.v),
        (params["layers"], jnp.arange(n_layers)))

    logits = logits_from_hidden(params, cfg, x[:, 0, :])
    return logits, KVCache(k=new_k, v=new_v)


def decode_step_spec(
    params: dict,
    cfg: DecoderConfig,
    cache: KVCache,
    toks: jax.Array,           # (B, S) int32: [last accepted token, S-1 drafts]
    step0: jax.Array,          # (B,) int32: gen index of toks[:, 0] (0-based)
    prompt_len: int,           # static P (cache slots before the gen region)
    prompt_mask: jax.Array,    # (B, P) int32
    dtype=jnp.bfloat16,
) -> tuple[jax.Array, KVCache]:
    """Multi-token decode step for speculative verification: one forward over
    S consecutive positions per row against the KV cache. Returns
    ((B, S, V) f32 logits — logits[:, j] predicts gen index step0+j+1 — and
    the cache with all S tokens' KV written at per-row offsets).

    Unlike `decode_step`, rows sit at DIFFERENT gen offsets (each row accepts
    a different number of drafts per iteration), so cache writes are a scatter
    at (layer, row, prompt_len + step0[b] + j) instead of one aligned
    dynamic_update_slice. The attention bias is banded-causal within the
    chunk: query j sees prompt-valid slots plus gen slots <= step0[b] + j
    (slots past a row's frontier hold stale rejected-draft KV; the band mask
    excludes them, and the next iteration's writes start at the new frontier,
    which by construction covers every stale slot before it can be read).

    Weight-streaming economics (the whole point): the S-token forward streams
    the decoder weights from HBM ONCE — same traffic as a 1-token step — so
    per-iteration cost is ~max(weight stream, S*B-token matmul compute), and
    every accepted draft is a token that skipped its own weight stream
    (1-token decode at small batch is bound by the weight stream)."""
    b, s = toks.shape
    t_max = cache.k.shape[2]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta)
    n_real = jnp.sum(prompt_mask, axis=-1)                     # (B,)
    gidx = step0[:, None] + jnp.arange(s)[None, :]             # (B, S)
    positions = n_real[:, None] + gidx                         # (B, S)
    tidx = prompt_len + gidx                                   # (B, S) slots

    slot = jnp.arange(t_max - prompt_len)
    gen_valid = slot[None, None, :] <= gidx[:, :, None]        # (B, S, Tg)
    valid = jnp.concatenate(
        [jnp.broadcast_to((prompt_mask > 0)[:, None, :], (b, s, prompt_len)),
         gen_valid], axis=-1)
    bias = jnp.where(valid, 0.0, NEG_INF)[:, None, :, :].astype(jnp.float32)

    x = embed_lookup(params, toks, dtype)                      # (B, S, H)
    batch_idx = jnp.arange(b)[:, None]                         # (B, 1)
    n_layers = cache.k.shape[0]

    def body(carry, xs_l):
        x, K, V = carry
        layer, li = xs_l
        h = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, cfg, h, b, s)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        # per-row-offset scatter (indices unique: one (li, b, t) per value);
        # XLA scatters in place on the scan carry like dynamic_update_slice
        K = K.at[li, batch_idx, tidx].set(k.astype(K.dtype),
                                          unique_indices=True)
        V = V.at[li, batch_idx, tidx].set(v.astype(V.dtype),
                                          unique_indices=True)
        ck = jax.lax.dynamic_slice_in_dim(K, li, 1, 0)[0]
        cv = jax.lax.dynamic_slice_in_dim(V, li, 1, 0)[0]
        a = attention(q, ck.astype(dtype), cv.astype(dtype), bias)
        a = a.reshape(b, s, cfg.num_heads * cfg.head_dim)
        x = x + dense(a, layer["o_w"])
        h = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
        x = x + _mlp(layer, h)
        return (x, K, V), None

    (x, new_k, new_v), _ = jax.lax.scan(
        body, (x, cache.k, cache.v),
        (params["layers"], jnp.arange(n_layers)))

    logits = logits_from_hidden(params, cfg, x)                # (B, S, V)
    return logits, KVCache(k=new_k, v=new_v)


def draft_ngram(
    hist: jax.Array,        # (B, H) int32 token history (prompt ++ generated)
    cur: jax.Array,         # (B,) int32: next free history index per row
    gamma: int,
    pad_id: int,
) -> jax.Array:
    """Prompt-lookup drafting (PLD), fully on-device: find the most recent
    earlier occurrence of each row's last bigram in its history and propose
    the gamma tokens that followed it; if none, propose the last token
    repeated (catches single-token fixed points the bigram can't).

    This is the self-speculative draft that needs NO auxiliary model: RAG
    answers copy spans from the retrieved context (the prompt), and greedy
    decoders that loop repeat their own history — both are n-gram-predictable.
    Longest-match ladder: a trigram match (more specific → fewer false
    continuations) wins over a bigram match, which wins over the repeat
    fallback. Cost is two (B, H) comparison passes per iteration: noise
    next to a forward.
    """
    b, h = hist.shape
    idx = jnp.arange(h - 1)[None, :]
    t0 = jnp.take_along_axis(hist, jnp.maximum(cur - 3, 0)[:, None], axis=1)
    t1 = jnp.take_along_axis(hist, (cur - 2)[:, None], axis=1)   # (B, 1)
    t2 = jnp.take_along_axis(hist, (cur - 1)[:, None], axis=1)

    # bigram [t1 t2] at window i (tokens i, i+1), continuation from i+2;
    # i <= cur-3 excludes the current occurrence itself
    win2 = (hist[:, :-1] == t1) & (hist[:, 1:] == t2)
    pos2 = jnp.max(jnp.where(win2 & (idx <= (cur - 3)[:, None]), idx, -1),
                   axis=-1)                                      # (B,) latest
    # trigram [t0 t1 t2] at window i (tokens i..i+2), continuation from i+3;
    # i <= cur-4 excludes the current occurrence; rows with <3 tokens of
    # history can't spuriously win (their t0 index clamps onto the bigram's
    # own region, which the position bound excludes)
    win3 = (hist[:, :-2] == t0) & (hist[:, 1:-1] == t1) & (hist[:, 2:] == t2)
    idx3 = jnp.arange(h - 2)[None, :]
    pos3 = jnp.max(jnp.where(win3 & (idx3 <= (cur - 4)[:, None]), idx3, -1),
                   axis=-1)

    use3 = pos3 >= 0
    start = jnp.where(use3, pos3 + 3, pos2 + 2)   # continuation start index
    found = use3 | (pos2 >= 0)
    cont = jnp.clip(start[:, None] + jnp.arange(gamma)[None, :], 0, h - 1)
    looked_up = jnp.take_along_axis(hist, cont, axis=1)          # (B, gamma)
    return jnp.where(found[:, None], looked_up,
                     jnp.broadcast_to(t2, (b, gamma))).astype(jnp.int32)


def _spec_decode_loop(params, cfg, logits0, cache, attention_mask,
                      max_new_tokens, gamma, dtype, row_valid, p,
                      input_ids, row_budget=None, eos_bias=0.0,
                      draft_source=None):
    """Greedy speculative decode over a prefilled cache: per iteration, draft
    `gamma` tokens by history lookup (`draft_ngram`), verify them in ONE
    multi-position forward (`decode_step_spec`), and emit the longest
    matching prefix plus the bonus token — 1..gamma+1 tokens per weight
    stream instead of exactly 1.

    GREEDY ONLY and output-preserving in exact arithmetic: position j's
    greedy argmax comes from the true model logits whenever drafts 0..j-1
    matched, so every emitted token equals what the sequential loop would
    emit under the same numerics (tests/test_spec_decode.py pins exact
    equality against `_decode_loop` at f32). At bf16 the chunk-shaped
    forward's reduction order differs from the 1-token step's, so a model
    whose top-2 logit gap sits below that noise (random init: a median of
    about a quarter of the logits' std) can flip near-tie argmaxes —
    trained checkpoints sit orders of magnitude above it.
    Sampling would need rejection resampling to preserve the distribution —
    out of scope; the engine routes here only when do_sample is off.

    Returns (out (B, max_new_tokens) int32, n_iters scalar int32). The
    emitted-token semantics (EOS included then pad, per-row budgets, pad rows
    born done, early exit when all rows finish) match `_decode_loop`.

    `input_ids` (B, P_in) seeds the lookup history (with prefix-KV serving
    this is just the suffix — the cached context's ids aren't available here;
    self-repetition and suffix copying still draft well).
    """
    b = attention_mask.shape[0]
    s = gamma + 1
    eos_ids = eos_id_set(cfg)
    pad = jnp.int32(cfg.pad_token_id)
    mnt = max_new_tokens

    budget = (jnp.clip(row_budget, 1, mnt) if row_budget is not None
              else jnp.full((b,), mnt, jnp.int32))

    tok0 = jnp.argmax(bias_eos(logits0, eos_ids, eos_bias),
                      axis=-1).astype(jnp.int32)
    if row_valid is not None:
        tok0 = jnp.where(row_valid, tok0, pad)
    done0 = token_is_eos(tok0, eos_ids) | (budget <= 1)
    if row_valid is not None:
        done0 = done0 | jnp.logical_not(row_valid)

    # out has one spill column (masked writes land there); sliced off at exit
    out0 = jnp.full((b, mnt + 1), cfg.pad_token_id, jnp.int32)
    out0 = out0.at[:, 0].set(tok0)
    if mnt == 1:
        return out0[:, :mnt], jnp.int32(0)

    # history = [prompt tokens (left-padded) | generated... | spill column].
    # The spill column is PAST the last legitimate write slot (p_in + mnt - 1
    # holds a full row's final token), so a masked dump can never collide
    # with a real token's scatter write in the same call.
    p_in = input_ids.shape[1]
    hlen = p_in + mnt + 1
    hist0 = jnp.concatenate(
        [input_ids.astype(jnp.int32),
         jnp.full((b, mnt + 1), pad, jnp.int32)], axis=1)
    hist0 = hist0.at[:, p_in].set(tok0)
    cur0 = jnp.full((b,), p_in + 1, jnp.int32)   # next free history slot

    batch_idx = jnp.arange(b)[:, None]
    jarange = jnp.arange(s)[None, :]

    def cond(carry):
        it, _, _, done, _, _, _, _ = carry
        return (it < mnt) & jnp.logical_not(jnp.all(done))

    def body(carry):
        it, last, gc, done, cache, hist, cur, out = carry
        if draft_source is not None:
            # measurement mode: draft gen indices gc..gc+gamma-1 straight
            # from a provided (B, >=mnt+gamma) token array — used to measure
            # the acceptance→speedup curve on silicon with CONTROLLED draft
            # quality (scripts/profile_spec_decode.py), independent of what
            # the n-gram drafter can find in a given workload
            didx = jnp.clip(gc[:, None] + jnp.arange(gamma)[None, :],
                            0, draft_source.shape[1] - 1)
            drafts = jnp.take_along_axis(draft_source, didx, axis=1)
        else:
            drafts = draft_ngram(hist, cur, gamma, cfg.pad_token_id)
        chunk = jnp.concatenate([last[:, None], drafts], axis=1)   # (B, S)
        logits, cache = decode_step_spec(
            params, cfg, cache, chunk, gc - 1, p, attention_mask, dtype=dtype)
        if eos_bias:
            for e in eos_ids:
                logits = logits.at[:, :, e].add(jnp.float32(eos_bias))
        g = jnp.argmax(logits, axis=-1).astype(jnp.int32)          # (B, S)
        # draft j (= chunk[:, j+1], gen index gc+j) is correct iff it equals
        # the model's own greedy pick g[:, j]; accept the longest prefix
        match = chunk[:, 1:] == g[:, :-1]                          # (B, S-1)
        accept = jnp.sum(jnp.cumprod(match.astype(jnp.int32), axis=-1),
                         axis=-1)                                  # (B,)
        e = g                                                      # emit cands
        e_eos = token_is_eos(e, eos_ids)                           # (B, S)
        eos_before = jnp.cumsum(e_eos.astype(jnp.int32), axis=-1) - \
            e_eos.astype(jnp.int32)                                # exclusive
        emit = ((~done)[:, None]
                & (jarange <= accept[:, None])
                & (jarange < (budget - gc)[:, None])
                & (eos_before == 0))                               # (B, S)
        n_emit = jnp.sum(emit.astype(jnp.int32), axis=-1)          # (B,)
        col = jnp.where(emit, gc[:, None] + jarange, mnt)          # spill=mnt
        out = out.at[batch_idx, col].set(jnp.where(emit, e, pad))
        hcol = jnp.where(emit, cur[:, None] + jarange, hlen - 1)
        hist = hist.at[batch_idx, hcol].set(jnp.where(emit, e, pad))
        emitted_eos = jnp.any(emit & e_eos, axis=-1)
        gc_new = gc + n_emit
        done = done | emitted_eos | (gc_new >= budget)
        last_idx = jnp.clip(n_emit - 1, 0, s - 1)
        last_new = jnp.take_along_axis(e, last_idx[:, None], axis=1)[:, 0]
        last = jnp.where(n_emit > 0, last_new, last)
        cur = cur + n_emit
        return (it + 1, last, gc_new, done, cache, hist, cur, out)

    init = (jnp.int32(0), tok0, jnp.full((b,), 1, jnp.int32), done0,
            cache, hist0, cur0, out0)
    it, _, _, _, _, _, _, out = jax.lax.while_loop(cond, body, init)
    return out[:, :mnt], it


def sample_token(
    logits: jax.Array,   # (B, V) f32
    rng: jax.Array,
    temperature: float = 0.7,
    top_k: int = 20,
    top_p: float = 0.8,
) -> jax.Array:
    """Qwen2.5-Instruct default sampling: temperature + top-k + nucleus.

    Runs entirely in the (B, top_k) candidate space: one vocab-wide exact
    top_k, then temperature/top-p/categorical over K values, then an index
    map back — avoids a second 150k-wide pass and a full-vocab gumbel."""
    vals, idx = jax.lax.top_k(logits, top_k)                 # (B, K) desc
    vals = vals / jnp.float32(max(temperature, 1e-5))
    probs = jax.nn.softmax(vals, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    # smallest prefix with cumulative prob >= top_p (always keeps the argmax)
    keep = cum - probs < top_p
    vals = jnp.where(keep, vals, NEG_INF)
    choice = jax.random.categorical(rng, vals, axis=-1)      # (B,) in [0, K)
    return jnp.take_along_axis(idx, choice[:, None], axis=1)[:, 0]


def eos_id_set(cfg: DecoderConfig) -> tuple:
    """All stop ids for the model (instruct models often declare several —
    Qwen2.5: <|im_end|> AND <|endoftext|>); deduped, order-stable."""
    return tuple(dict.fromkeys(
        (cfg.eos_token_id,) + tuple(getattr(cfg, "eos_token_ids", ()))))


def token_is_eos(tok: jax.Array, eos_ids: tuple) -> jax.Array:
    hit = tok == eos_ids[0]
    for e in eos_ids[1:]:
        hit = hit | (tok == e)
    return hit


def bias_eos(logits, eos_ids: tuple, eos_bias: float):
    """Add a constant to the stop-token logits (EOS_BIAS knob). Zero (the
    default) is a no-op and compiles away. Purpose: controlled
    completion-length variance for workload studies — random-init weights
    essentially never emit EOS, so every row decodes to max_new_tokens and
    the continuous-batching pool's reason to exist (rows finishing at
    different lengths) can't be exercised; a positive bias under sampling
    gives geometric-ish completion lengths whose mean the bias controls."""
    if not eos_bias:
        return logits
    for e in eos_ids:
        logits = logits.at[:, e].add(jnp.float32(eos_bias))
    return logits


def pick_token(logits, rng, do_sample, temperature=0.7, top_k=20, top_p=0.8,
               eos_bias=0.0, eos_ids=()):
    """Shared next-token choice: Qwen2.5 default sampling or greedy."""
    logits = bias_eos(logits, eos_ids, eos_bias)
    if do_sample:
        return sample_token(logits, rng, temperature, top_k, top_p)
    return jnp.argmax(logits, axis=-1)


def _decode_loop(params, cfg, logits0, cache, attention_mask, rng,
                 max_new_tokens, temperature, top_k, top_p, do_sample,
                 dtype, row_valid, p, row_budget=None, eos_bias=0.0):
    """Shared sample + while_loop decode over a prefilled cache (see
    `generate` for semantics: EOS early exit, pad rows born done, fixed
    (B, max_new_tokens) output). `p` is the static combined prompt length
    the cache was built with; `attention_mask` is (B, p).

    `row_budget` ((B,) int32, values in [1, max_new_tokens]) gives each row
    its OWN generation budget (per-request max_new_tokens): a row is done
    once it has emitted its budget, and — because the early exit is
    `all(done)` — the while_loop runs only max(row_budget) trips, so a
    batch of short budgets pays max(batch), not the engine-wide cap. The
    continuous decode pool does strictly better (each slot frees at its own
    budget); this is the fixed path's bounded version of the same feature."""
    b = attention_mask.shape[0]

    eos_ids = eos_id_set(cfg)

    def pick(logits, rng):
        return pick_token(logits, rng, do_sample, temperature, top_k, top_p,
                          eos_bias, eos_ids)

    def is_eos(tok):
        return token_is_eos(tok, eos_ids)

    rng, rng0 = jax.random.split(rng)
    tok0 = pick(logits0, rng0).astype(jnp.int32)
    if row_valid is not None:
        tok0 = jnp.where(row_valid, tok0, jnp.int32(cfg.pad_token_id))
    done0 = is_eos(tok0)
    if row_valid is not None:
        done0 = done0 | jnp.logical_not(row_valid)
    if row_budget is not None:
        done0 = done0 | (row_budget <= 1)
    out0 = jnp.full((b, max_new_tokens), cfg.pad_token_id, jnp.int32)
    out0 = out0.at[:, 0].set(tok0)

    if max_new_tokens == 1:
        return out0

    def cond(carry):
        step, _, done, _, _, _ = carry
        return (step < max_new_tokens - 1) & jnp.logical_not(jnp.all(done))

    def body(carry):
        step, tok, done, cache, rng, out = carry
        rng, step_rng = jax.random.split(rng)
        logits, cache = decode_step(params, cfg, cache, tok, step, p,
                                    attention_mask, dtype=dtype)
        nxt = pick(logits, step_rng).astype(jnp.int32)
        nxt = jnp.where(done, jnp.int32(cfg.pad_token_id), nxt)
        done = done | is_eos(nxt)
        if row_budget is not None:
            # column step+1 just emitted → the row holds step+2 tokens
            done = done | (step + 2 >= row_budget)
        out = jax.lax.dynamic_update_slice(out, nxt[:, None], (0, step + 1))
        return (step + 1, nxt, done, cache, rng, out)

    init = (jnp.int32(0), tok0, done0, cache, rng, out0)
    _, _, _, _, _, out = jax.lax.while_loop(cond, body, init)
    return out


def prefill_packed(
    params: dict,
    cfg: DecoderConfig,
    input_ids: jax.Array,     # (1, T) packed token stream
    seg: jax.Array,           # (1, T) int32 ascending row ids; pads = B (or >)
    positions: jax.Array,     # (1, T) int32 within-row positions
    last_idx: jax.Array,      # (B,) packed index of each row's last token
    gather_idx: jax.Array,    # (B, P) packed index feeding cache slot [b, p]
    prompt_mask: jax.Array,   # (B, P) {0,1} — left-pad-layout validity
    max_new_tokens: int,
    max_seg_len: int,         # static bound on any row's token count (<= P)
    dtype=jnp.bfloat16,
    act_quant: bool = False,
) -> tuple[jax.Array, KVCache]:
    """PACKED prefill (the cold-path answer to pad waste): the batch's real
    tokens run back-to-back in ONE (1, T) stream — matmul FLOPs and
    elementwise memory traffic scale with sum(len_b), not B * max(len_b).
    Attention is block-diagonal causal via `ops.attention.packed_attention`
    (the platform's kernel, backend.kernels()); the per-token KV is
    then unpacked into the standard left-padded (L, B, P + new, Hk, D) cache
    with one gather, so decode is IDENTICAL to the padded path.

    Returns (last-token logits (B, V) f32, KVCache). Rows must be packed in
    ascending segment order with pad tokens at the tail (seg >= B there)."""
    b, p = gather_idx.shape
    _, t = input_ids.shape
    t_max = p + max_new_tokens
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta)

    x = embed_lookup(params, input_ids, dtype)

    impl = kernels().packed_attention

    def attend(q, k, v):
        return packed_attention(q, k, v, seg, impl=impl), k, v

    def body(x, layer):
        x, k, v = _layer_forward(layer, cfg, x, positions, inv_freq,
                                 1, t, act_quant, attend)
        return x, (k, v)

    x, (ks, vs) = jax.lax.scan(body, x, params["layers"])  # (L, 1, T, Hk, D)

    # unpack packed KV into the per-row left-padded cache layout: slot [b, p]
    # reads packed position gather_idx[b, p]; invalid slots are zeroed by the
    # prompt mask (gather_idx may point anywhere there)
    flat = gather_idx.reshape(-1)                          # (B*P,)
    mk = prompt_mask.reshape(1, b, p, 1, 1).astype(ks.dtype)
    ks = jnp.take(ks[:, 0], flat, axis=1).reshape(
        ks.shape[0], b, p, cfg.num_kv_heads, cfg.head_dim) * mk
    vs = jnp.take(vs[:, 0], flat, axis=1).reshape(
        vs.shape[0], b, p, cfg.num_kv_heads, cfg.head_dim) * mk
    ks = jnp.pad(ks, ((0, 0), (0, 0), (0, t_max - p), (0, 0), (0, 0)))
    vs = jnp.pad(vs, ((0, 0), (0, 0), (0, t_max - p), (0, 0), (0, 0)))

    logits = logits_from_hidden(params, cfg, x[0, last_idx, :])
    return logits, KVCache(k=ks, v=vs)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "max_new_tokens", "max_seg_len", "temperature",
                     "top_k", "top_p", "do_sample", "dtype", "act_quant",
                     "spec_gamma", "eos_bias"),
)
def generate_packed(
    params: dict,
    cfg: DecoderConfig,
    input_ids: jax.Array,     # (1, T) packed stream
    seg: jax.Array,           # (1, T)
    positions: jax.Array,     # (1, T)
    last_idx: jax.Array,      # (B,)
    gather_idx: jax.Array,    # (B, P)
    prompt_mask: jax.Array,   # (B, P)
    rng: jax.Array,
    max_new_tokens: int = 10,
    max_seg_len: int = 512,
    temperature: float = 0.7,
    top_k: int = 20,
    top_p: float = 0.8,
    do_sample: bool = True,
    dtype=jnp.bfloat16,
    row_valid: jax.Array | None = None,
    act_quant: bool = False,
    row_budget: jax.Array | None = None,  # (B,) per-row generation budget
    spec_gamma: int = 0,                  # >0: speculative decode (greedy only)
    eos_bias: float = 0.0,
) -> jax.Array:
    """Packed-prefill + standard decode. Same contract as `generate` (fixed
    (B, max_new_tokens) output, EOS early exit) with the prompt batch in
    packed layout; decode runs on the unpacked per-row cache, so everything
    after the first token is byte-identical to the padded path (including
    the `spec_gamma` speculative loop — its lookup history is the per-row
    ids reconstructed from the packed stream via `gather_idx`)."""
    use_spec = spec_gamma > 0 and not do_sample and max_new_tokens > 1
    alloc = max_new_tokens + (spec_gamma if use_spec else 0)
    logits0, cache = prefill_packed(
        params, cfg, input_ids, seg, positions, last_idx, gather_idx,
        prompt_mask, alloc, max_seg_len, dtype=dtype,
        act_quant=act_quant)
    p = gather_idx.shape[1]
    if use_spec:
        row_ids = jnp.where(prompt_mask > 0,
                            jnp.take(input_ids[0], gather_idx),
                            jnp.int32(cfg.pad_token_id))
        out, _ = _spec_decode_loop(params, cfg, logits0, cache, prompt_mask,
                                   max_new_tokens, spec_gamma, dtype,
                                   row_valid, p, row_ids,
                                   row_budget=row_budget, eos_bias=eos_bias)
        return out
    return _decode_loop(params, cfg, logits0, cache, prompt_mask, rng,
                        max_new_tokens, temperature, top_k, top_p, do_sample,
                        dtype, row_valid, p, row_budget=row_budget,
                        eos_bias=eos_bias)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "temperature", "top_k", "top_p", "do_sample",
                     "dtype", "act_quant", "eos_bias"),
)
def prefill_for_pool(
    params: dict,
    cfg: DecoderConfig,
    input_ids: jax.Array,       # (B, P) int32 LEFT-padded (suffix if prefix_kv)
    attention_mask: jax.Array,  # (B, P)
    rng: jax.Array,
    temperature: float = 0.7,
    top_k: int = 20,
    top_p: float = 0.8,
    do_sample: bool = True,
    dtype=jnp.bfloat16,
    row_valid: jax.Array | None = None,
    act_quant: bool = False,
    prefix_kv=None,
    prefix_len: jax.Array | None = None,
    eos_bias: float = 0.0,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Prefill + first-token sample for the continuous decode pool
    (core/decode_pool.py): the same prefill `generate` runs, but instead of
    entering the fixed while_loop the prompt KV and first sampled token are
    returned for insertion into a persistent slot pool, where decoding
    continues one token per *pool* step alongside unrelated requests.

    Returns (tok0 (B,), k (L, B, T, Hk, D), v, combined_mask (B, T)) with
    T = [prefix pool len +] P — exactly the prompt KV, no decode padding.
    Pad rows (row_valid False) get tok0 = pad_token_id."""
    logits0, cache = prefill(params, cfg, input_ids, attention_mask,
                             max_new_tokens=0, dtype=dtype,
                             act_quant=act_quant,
                             prefix_kv=prefix_kv, prefix_len=prefix_len)
    tok0 = pick_token(logits0, rng, do_sample, temperature, top_k,
                      top_p, eos_bias, eos_id_set(cfg)).astype(jnp.int32)
    if row_valid is not None:
        tok0 = jnp.where(row_valid, tok0, jnp.int32(cfg.pad_token_id))
    if prefix_kv is not None:
        pl_ = (prefix_kv[0] if isinstance(prefix_kv, (tuple, list))
               else prefix_kv).shape[3]
        pref_mask = (jnp.arange(pl_)[None, :] < prefix_len[:, None]).astype(
            attention_mask.dtype)
        attention_mask = jnp.concatenate([pref_mask, attention_mask], axis=1)
    return tok0, cache.k, cache.v, attention_mask


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "max_seg_len", "temperature", "top_k", "top_p",
                     "do_sample", "dtype", "act_quant", "eos_bias"),
)
def prefill_packed_for_pool(
    params: dict,
    cfg: DecoderConfig,
    input_ids: jax.Array,     # (1, T) packed stream
    seg: jax.Array,
    positions: jax.Array,
    last_idx: jax.Array,      # (B,)
    gather_idx: jax.Array,    # (B, P)
    prompt_mask: jax.Array,   # (B, P)
    rng: jax.Array,
    max_seg_len: int = 512,
    temperature: float = 0.7,
    top_k: int = 20,
    top_p: float = 0.8,
    do_sample: bool = True,
    dtype=jnp.bfloat16,
    row_valid: jax.Array | None = None,
    act_quant: bool = False,
    eos_bias: float = 0.0,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Packed-prefill variant of `prefill_for_pool`: the cold-path packed
    stream prefills, unpacks into per-row KV, and hands rows to the pool.
    Returns (tok0 (B,), k (L, B, P, Hk, D), v, prompt_mask)."""
    logits0, cache = prefill_packed(
        params, cfg, input_ids, seg, positions, last_idx, gather_idx,
        prompt_mask, max_new_tokens=0, max_seg_len=max_seg_len, dtype=dtype,
        act_quant=act_quant)
    tok0 = pick_token(logits0, rng, do_sample, temperature, top_k,
                      top_p, eos_bias, eos_id_set(cfg)).astype(jnp.int32)
    if row_valid is not None:
        tok0 = jnp.where(row_valid, tok0, jnp.int32(cfg.pad_token_id))
    return tok0, cache.k, cache.v, prompt_mask


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "chunk", "temperature", "top_k", "top_p",
                     "do_sample", "dtype", "eos_bias"),
    donate_argnums=(2, 3, 4, 5, 6, 7, 8, 9),
)
def decode_chunk(
    params: dict,
    cfg: DecoderConfig,
    pool_k: jax.Array,      # (L, S, W, Hk, D) ring KV pool (donated)
    pool_v: jax.Array,
    valid: jax.Array,       # (S, W) bool — attendable columns per slot
    last_tok: jax.Array,    # (S,) int32 — token each slot processes next
    next_pos: jax.Array,    # (S,) int32 — its RoPE position
    active: jax.Array,      # (S,) bool
    remaining: jax.Array,   # (S,) int32 — tokens each slot may still emit
    cursor: jax.Array,      # () int32 — global ring write column
    rng: jax.Array,
    chunk: int = 8,
    temperature: float = 0.7,
    top_k: int = 20,
    top_p: float = 0.8,
    do_sample: bool = True,
    dtype=jnp.bfloat16,
    eos_bias: float = 0.0,
):
    """`chunk` continuous-batching decode steps over the slot pool — the
    static-shape core of in-flight batching (vLLM's role, reimagined for
    XLA's static shapes; same orchestration shape as JetStream):

    - The pool is a RING over the W axis with ONE global cursor: every step,
      every active slot writes its new token's KV at column `cursor`, so the
      cache write stays a scalar-index `dynamic_update_slice` (no per-row
      scatter). RoPE positions are baked into K at write time and attention
      masks by the per-slot `valid` bitmap, so a slot's tokens may live at
      ARBITRARY ring columns — softmax is permutation-invariant over keys.
    - Inserts (decode_pool.py) place a prefilled prompt right-aligned at the
      cursor; an active slot then emits exactly one token per pool step, so
      a slot inserted with T prompt columns is overwritten-safe for W - T
      steps — the pool guarantees T + max_new_tokens <= W.
    - `chunk` steps run as one lax.scan per dispatch: one XLA program, one
      host round trip per `chunk` tokens instead of one per token.
    - EOS/budget exhaustion flips `active` ON DEVICE mid-chunk, so finished
      slots stop sampling immediately; the host notices when it consumes the
      chunk's (chunk, S) token block and recycles the slot.

    Returns (pool_k, pool_v, valid, last_tok, next_pos, active, remaining,
    cursor, toks (chunk, S) int32). Inactive slots emit pad_token_id."""
    s_slots, w = valid.shape
    n_layers = pool_k.shape[0]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta)
    eos_ids = eos_id_set(cfg)
    step_rngs = jax.random.split(rng, chunk)

    def step(carry, step_rng):
        pool_k, pool_v, valid, last_tok, next_pos, active, remaining, cursor = carry
        # the column being written is attendable iff its row is active
        valid = jax.lax.dynamic_update_slice(
            valid, active[:, None], (0, cursor))
        bias = jnp.where(valid, 0.0, NEG_INF)[:, None, None, :].astype(
            jnp.float32)
        x = embed_lookup(params, last_tok[:, None], dtype)   # (S, 1, H)
        positions = next_pos[:, None]

        def body(carry, xs_l):
            x, K, V = carry
            layer, li = xs_l
            h = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
            q, k, v = _qkv(layer, cfg, h, s_slots, 1)
            q = apply_rope(q, positions, inv_freq)
            k = apply_rope(k, positions, inv_freq)
            K = jax.lax.dynamic_update_slice(
                K, k[None].astype(K.dtype), (li, 0, cursor, 0, 0))
            V = jax.lax.dynamic_update_slice(
                V, v[None].astype(V.dtype), (li, 0, cursor, 0, 0))
            ck = jax.lax.dynamic_slice_in_dim(K, li, 1, 0)[0]
            cv = jax.lax.dynamic_slice_in_dim(V, li, 1, 0)[0]
            a = attention(q, ck.astype(dtype), cv.astype(dtype), bias)
            a = a.reshape(s_slots, 1, cfg.num_heads * cfg.head_dim)
            x = x + dense(a, layer["o_w"])
            h = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
            x = x + _mlp(layer, h)
            return (x, K, V), None

        (x, pool_k, pool_v), _ = jax.lax.scan(
            body, (x, pool_k, pool_v),
            (params["layers"], jnp.arange(n_layers)))
        logits = logits_from_hidden(params, cfg, x[:, 0, :])
        tok = pick_token(logits, step_rng, do_sample, temperature, top_k,
                         top_p, eos_bias, eos_ids).astype(jnp.int32)
        tok = jnp.where(active, tok, jnp.int32(cfg.pad_token_id))
        next_pos = next_pos + active.astype(jnp.int32)
        remaining = remaining - active.astype(jnp.int32)
        active = active & ~token_is_eos(tok, eos_ids) & (remaining > 0)
        last_tok = jnp.where(active, tok, last_tok)
        cursor = jnp.mod(cursor + 1, w)
        return ((pool_k, pool_v, valid, last_tok, next_pos, active,
                 remaining, cursor), tok)

    init = (pool_k, pool_v, valid, last_tok, next_pos, active, remaining,
            cursor)
    carry, toks = jax.lax.scan(step, init, step_rngs)
    return (*carry, toks)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "max_new_tokens", "temperature", "top_k", "top_p",
                     "do_sample", "dtype", "act_quant", "spec_gamma",
                     "eos_bias"),
)
def generate(
    params: dict,
    cfg: DecoderConfig,
    input_ids: jax.Array,       # (B, P) int32 LEFT-padded
    attention_mask: jax.Array,  # (B, P)
    rng: jax.Array,
    max_new_tokens: int = 10,
    temperature: float = 0.7,
    top_k: int = 20,
    top_p: float = 0.8,
    do_sample: bool = True,
    dtype=jnp.bfloat16,
    row_valid: jax.Array | None = None,   # (B,) bool — False for pad rows
    act_quant: bool = False,              # W8A8 prefill (decode unaffected)
    prefix_kv: jax.Array | None = None,   # (B, L, 2, PL, Hk, D) cached ctx KV
    prefix_len: jax.Array | None = None,  # (B,) int32
    row_budget: jax.Array | None = None,  # (B,) int32 per-row token budget
    spec_gamma: int = 0,                  # >0: speculative decode (greedy only)
    eos_bias: float = 0.0,                # EOS logit bias (see bias_eos)
) -> jax.Array:
    """Prefill + while_loop decode. Returns (B, max_new_tokens) int32 ids.

    `spec_gamma` > 0 switches the decode loop to greedy speculative decoding
    (`_spec_decode_loop`: gamma history-lookup drafts verified per forward,
    output-preserving in exact arithmetic). Requires do_sample=False —
    sampling ignores the knob and keeps the 1-token loop.

    Fixed output shape (the XLA way): past-EOS positions are pad_token_id and
    the host strips them — but the loop EXITS as soon as every sequence in
    the batch has emitted EOS, so short answers don't pay for max_new_tokens
    (the reference's HF pipeline decodes all 10 tokens unconditionally).
    Batch-padding rows (row_valid False) are born done so they never defeat
    the early exit and emit only pad_token_id.

    With `prefix_kv`/`prefix_len` (see `prefill`), `input_ids` holds only the
    per-row SUFFIX (everything after the cached context prefix) and decode
    attends over the [prefix | suffix | generated] concatenated cache.
    """
    b, p = input_ids.shape
    use_spec = spec_gamma > 0 and not do_sample and max_new_tokens > 1
    # spec verification writes up to gamma slots past a row's final token —
    # give the cache that headroom so scatter indices stay in bounds
    alloc = max_new_tokens + (spec_gamma if use_spec else 0)
    logits0, cache = prefill(params, cfg, input_ids, attention_mask,
                             alloc, dtype=dtype, act_quant=act_quant,
                             prefix_kv=prefix_kv, prefix_len=prefix_len)
    if prefix_kv is not None:
        # decode sees one combined "prompt" of length PL + P: the prefix part
        # is LEFT-aligned valid-for-prefix_len, the suffix part left-padded
        pl_ = (prefix_kv[0] if isinstance(prefix_kv, (tuple, list))
               else prefix_kv).shape[3]
        pref_mask = (jnp.arange(pl_)[None, :] < prefix_len[:, None]).astype(
            attention_mask.dtype)
        attention_mask = jnp.concatenate([pref_mask, attention_mask], axis=1)
        p = pl_ + p

    # Note on stop ids (applies inside _decode_loop): instruct models often
    # declare SEVERAL (Qwen2.5: <|im_end|> AND <|endoftext|>); a row must
    # stop on any of them — missing one both defeats the early exit and
    # leaks post-EOS samples into the answer.
    if use_spec:
        out, _ = _spec_decode_loop(params, cfg, logits0, cache,
                                   attention_mask, max_new_tokens, spec_gamma,
                                   dtype, row_valid, p, input_ids,
                                   row_budget=row_budget, eos_bias=eos_bias)
        return out
    return _decode_loop(params, cfg, logits0, cache, attention_mask, rng,
                        max_new_tokens, temperature, top_k, top_p, do_sample,
                        dtype, row_valid, p, row_budget=row_budget,
                        eos_bias=eos_bias)
