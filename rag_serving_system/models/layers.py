"""Shared neural-net building blocks (pure jnp).

All matmuls specify `preferred_element_type` so XLA accumulates in f32 even
with bf16 operands; shapes are kept static so every forward jit-compiles to a
single fused XLA program per shape bucket.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -1.0e9  # additive attention-mask value (f32-safe, avoids NaN in softmax)


def dense(x: jax.Array, w, b: jax.Array | None = None) -> jax.Array:
    """x: (..., in) @ w: (in, out) [+ b]. `w` may be a plain array or an
    ops.quant.QuantizedWeight (int8 + per-output-channel scale).

    int8 path: matmul against the raw int8 matrix (cast to bf16 on load —
    int8 magnitudes ≤127 are exact in bf16) and apply the (1, out) scale to
    the OUTPUT. This is mathematically identical to dequant-then-matmul; the
    weight stream stays 1 byte/element only if XLA fuses the convert into
    the matmul's operand load, which is not verified on the GPU yet."""
    if hasattr(w, "q") and w.q.ndim == 3:  # QuantizedWeight4 (grouped int4)
        from rag_serving_system.ops.quant import unpack_int4

        gq, g2, o = w.q.shape
        xg = x.reshape(*x.shape[:-1], gq, 2 * g2)
        # per-group partial products, scaled per (group, out), summed — the
        # packed int4 bytes are the only weight stream (the nibble unpack is
        # elementwise and fuses into the operand read); scale is tiny
        y = jnp.einsum("...gi,gio->...go", xg, unpack_int4(w.q).astype(x.dtype),
                       preferred_element_type=jnp.float32)
        y = jnp.sum(y * w.scale[:, 0, :], axis=-2)
    elif hasattr(w, "q"):  # QuantizedWeight (int8)
        y = jnp.einsum("...i,io->...o", x, w.q.astype(x.dtype),
                       preferred_element_type=jnp.float32)
        y = y * w.scale  # (1, out) f32 — fused epilogue, not a weight copy
    else:
        y = jnp.einsum("...i,io->...o", x, w, preferred_element_type=jnp.float32)
    if b is not None:
        y = y + b.astype(y.dtype)
    return y.astype(x.dtype)


def dense_w8a8(x: jax.Array, w, b: jax.Array | None = None) -> jax.Array:
    """W8A8 matmul: dynamic per-token int8 activations x per-channel int8
    weights as an s8 x s8 -> s32 dot, rescaled in f32.

    Only worth it when the matmul is COMPUTE-bound (prefill); decode is
    weight-bandwidth-bound and gains nothing from quantizing activations.
    Falls back to `dense` for un-quantized weights."""
    if not hasattr(w, "q"):
        return dense(x, w, b)
    from rag_serving_system.ops.quant import quantize_act_int8

    xq, xs = quantize_act_int8(x)
    if w.q.ndim == 3:  # grouped int4 weights → W4A8 per-group int8 matmuls
        from rag_serving_system.ops.quant import unpack_int4

        gq, g2, o = w.q.shape
        xqg = xq.reshape(*xq.shape[:-1], gq, 2 * g2)
        acc = jnp.einsum("...gi,gio->...go", xqg, unpack_int4(w.q),
                         preferred_element_type=jnp.int32)
        y = jnp.sum(acc.astype(jnp.float32) * w.scale[:, 0, :], axis=-2) * xs
    else:
        acc = jnp.einsum("...i,io->...o", xq, w.q,
                         preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * xs * w.scale  # (...,1)*(1,out) broadcast
    if b is not None:
        y = y + b.astype(y.dtype)
    return y.astype(x.dtype)


def layer_norm(x: jax.Array, scale: jax.Array, bias: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mu), axis=-1, keepdims=True)
    y = (xf - mu) * jax.lax.rsqrt(var + eps)
    return (y * scale.astype(jnp.float32) + bias.astype(jnp.float32)).astype(x.dtype)


def rms_norm(x: jax.Array, scale: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    y = xf * jax.lax.rsqrt(var + eps)
    return (y * scale.astype(jnp.float32)).astype(x.dtype)


def gelu(x: jax.Array) -> jax.Array:
    # erf-based (exact) GELU, matching BERT-family 'gelu'
    return jax.nn.gelu(x, approximate=False)


def silu(x: jax.Array) -> jax.Array:
    return jax.nn.silu(x)


# ---------------------------------------------------------------------------
# Rotary position embeddings (Qwen2/Llama "half-rotation" layout)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> jax.Array:
    """(head_dim/2,) inverse frequencies."""
    return 1.0 / (theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim))


def apply_rope(x: jax.Array, positions: jax.Array, inv_freq: jax.Array) -> jax.Array:
    """x: (B, S, H, D), positions: (B, S) int32 → rotated x (same dtype).

    Uses the HF 'rotate_half' convention: x split as [x1, x2] halves,
    out = x*cos + rotate_half(x)*sin with angles tiled over both halves.
    """
    angles = positions.astype(jnp.float32)[..., None] * inv_freq  # (B, S, D/2)
    cos = jnp.cos(angles)[:, :, None, :]  # (B, S, 1, D/2)
    sin = jnp.sin(angles)[:, :, None, :]
    xf = x.astype(jnp.float32)
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1)
    return out.astype(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention(
    q: jax.Array,          # (B, S, Hq, D)
    k: jax.Array,          # (B, T, Hk, D)
    v: jax.Array,          # (B, T, Hk, D)
    bias: jax.Array,       # (B, 1, S, T) additive f32 mask (0 / NEG_INF)
) -> jax.Array:
    """Grouped-query scaled dot-product attention. Hq must be a multiple of Hk.

    The plain einsum path: it writes the (B, Hk, G, S, T) float32 scores to
    device memory. Prompt prefill goes through ops/attention.py, which picks
    the platform's fused kernel; this stays the oracle, the CPU path, and
    the path of short-query attention (decode, prefix + suffix).
    """
    b, s, hq, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    group = hq // hk
    qf = q.reshape(b, s, hk, group, d)
    scores = jnp.einsum("bshgd,bthd->bhgst", qf, k,
                        preferred_element_type=jnp.float32)
    scores = scores * (1.0 / jnp.sqrt(jnp.float32(d)))
    scores = scores + bias[:, :, None, :, :]
    probs = jax.nn.softmax(scores.astype(jnp.float32), axis=-1)
    out = jnp.einsum("bhgst,bthd->bshgd", probs.astype(v.dtype), v,
                     preferred_element_type=jnp.float32)
    return out.reshape(b, s, hq, d).astype(q.dtype)


def padding_bias(mask: jax.Array, dtype=jnp.float32) -> jax.Array:
    """(B, T) {0,1} → (B, 1, 1, T) additive bias."""
    return jnp.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).astype(dtype)


def causal_padding_bias(mask: jax.Array) -> jax.Array:
    """(B, S) {0,1} → (B, 1, S, S) causal + padding additive bias."""
    s = mask.shape[-1]
    causal = jnp.tril(jnp.ones((s, s), dtype=bool))
    allowed = causal[None, :, :] & (mask[:, None, :] > 0)
    return jnp.where(allowed, 0.0, NEG_INF)[:, None, :, :].astype(jnp.float32)
