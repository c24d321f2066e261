"""XLM-RoBERTa-family encoder (e5-large) as pure-JAX functions.

Replaces the reference's torch `AutoModel` forward + mean-pool embedding stage
(reference: rag_service/core/batch_processor.py:81-92). Parity notes:

- The reference pools with an UNMASKED mean over all positions, pads included
  (`last_hidden_state.mean(dim=1)`, batch_processor.py:91). We reproduce that
  by default (`pooling="mean_all"`) so retrieval ranks match; a masked-mean
  option is available and is what the corpus scripts use when they do
  mask-weighted pooling.
- Queries are prefixed "query: " and passages "passage: " at tokenize time by
  the callers (batch_processor.py:83, scripts/fact_dataset.py:189).

Params pytree layout (dense weights stored (in, out); QKV fused into one
(H, 3H) matmul — one big matmul instead of three smaller dispatches; layer
weights STACKED on a leading L axis and scanned, see models/qwen2.py):
  {"embed": {"word", "pos", "type", "ln_scale", "ln_bias"},
   "layers": {"qkv_w": (L,H,3H), "qkv_b": (L,3H), "o_w", "o_b",
              "attn_ln_scale", "attn_ln_bias",
              "ff_w1", "ff_b1", "ff_w2", "ff_b2",
              "ff_ln_scale", "ff_ln_bias"}}
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rag_serving_system.models.configs import EncoderConfig
from rag_serving_system.backend import kernels
from rag_serving_system.models.layers import dense, gelu, layer_norm
from rag_serving_system.ops.attention import self_attention


def roberta_position_ids(input_ids: jax.Array, pad_token_id: int) -> jax.Array:
    """RoBERTa quirk: positions count non-pad tokens and are offset by
    pad_token_id + 1; pad positions get pad_token_id."""
    mask = (input_ids != pad_token_id).astype(jnp.int32)
    incremental = jnp.cumsum(mask, axis=-1) * mask
    return incremental + pad_token_id


def position_ids(cfg: EncoderConfig, input_ids: jax.Array) -> jax.Array:
    """Per-family position ids: RoBERTa's pad-offset cumsum (e5/XLM-R) or
    BERT's plain 0..L-1 absolute positions."""
    if cfg.position_style == "roberta":
        return roberta_position_ids(input_ids, cfg.pad_token_id)
    b, l = input_ids.shape
    return jnp.broadcast_to(jnp.arange(l, dtype=jnp.int32)[None, :], (b, l))


def encoder_forward(
    params: dict,
    cfg: EncoderConfig,
    input_ids: jax.Array,       # (B, L) int32
    attention_mask: jax.Array,  # (B, L) int32 {0,1}
    dtype=jnp.bfloat16,
) -> jax.Array:
    """Returns last_hidden_state (B, L, H)."""
    emb = params["embed"]
    # guard the position table: jnp.take CLAMPS out-of-range ids, so an
    # over-long sequence would silently share the last position embedding
    # across its tail instead of erroring like HF. The engine's encode
    # buckets cap at 512, but direct callers get a real error.
    max_l = emb["pos"].shape[0] - (cfg.pad_token_id + 1
                                   if cfg.position_style == "roberta" else 0)
    if input_ids.shape[1] > max_l:
        raise ValueError(
            f"sequence length {input_ids.shape[1]} exceeds the position "
            f"table ({max_l} usable rows); truncate or bucket the input")
    pos_ids = position_ids(cfg, input_ids)
    x = (
        jnp.take(emb["word"], input_ids, axis=0)
        + jnp.take(emb["pos"], pos_ids, axis=0)
        + emb["type"][0][None, None, :]
    ).astype(dtype)
    x = layer_norm(x, emb["ln_scale"], emb["ln_bias"], cfg.layer_norm_eps)

    impl = kernels().prefill_attention
    b, l = input_ids.shape
    h, d = cfg.num_heads, cfg.head_dim

    # scan over the stacked (L, ...) layer weights — one compiled layer body
    # instead of L unrolled copies (see models/qwen2.py module docstring)
    def body(x, layer):
        hd = h * d
        qkv = dense(x, layer["qkv_w"], layer["qkv_b"])
        q = qkv[..., :hd].reshape(b, l, h, d)
        k = qkv[..., hd:2 * hd].reshape(b, l, h, d)
        v = qkv[..., 2 * hd:].reshape(b, l, h, d)
        a = self_attention(q, k, v, attention_mask, causal=False,
                           impl=impl).reshape(b, l, h * d)
        a = dense(a, layer["o_w"], layer["o_b"])
        x = layer_norm(x + a, layer["attn_ln_scale"], layer["attn_ln_bias"],
                       cfg.layer_norm_eps)
        f = dense(gelu(dense(x, layer["ff_w1"], layer["ff_b1"])),
                  layer["ff_w2"], layer["ff_b2"])
        x = layer_norm(x + f, layer["ff_ln_scale"], layer["ff_ln_bias"],
                       cfg.layer_norm_eps)
        return x, None

    x, _ = jax.lax.scan(body, x, params["layers"])
    return x


def encode(
    params: dict,
    cfg: EncoderConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    pooling: str = "mean_all",
    dtype=jnp.bfloat16,
) -> jax.Array:
    """Returns pooled (B, H) f32 query/passage embeddings."""
    hidden = encoder_forward(params, cfg, input_ids, attention_mask, dtype=dtype)
    hf = hidden.astype(jnp.float32)
    if pooling == "mean_all":
        # reference parity: pads included (batch_processor.py:91)
        return jnp.mean(hf, axis=1)
    if pooling == "mean_masked":
        m = attention_mask.astype(jnp.float32)[:, :, None]
        return jnp.sum(hf * m, axis=1) / jnp.maximum(jnp.sum(m, axis=1), 1.0)
    if pooling == "cls":
        return hf[:, 0, :]
    raise ValueError(f"unknown pooling: {pooling}")
