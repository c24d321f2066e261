"""Weight-only int8 / int4 quantization (opt-in, QUANT_WEIGHTS=int8|int4).

Decode steps are weight-bandwidth-bound: every generated token re-reads all
decoder weights from device memory (~3.1 GB in bf16 for Qwen2.5-1.5B).
Per-output-channel symmetric int8 halves those bytes — provided XLA fuses
the dequant (convert + scale) into the matmul's operand load instead of
writing a bf16 copy of the weight first. Whether it does on the GPU is not
verified yet (ROADMAP Speed 3: read it off a trace).

int4 halves the stream AGAIN for the 2-D matmul weights. Per-output-channel
scaling is too coarse at 4 bits, so int4 uses the standard GROUP-WISE scheme
(one scale per `group` input elements per output channel, default 128 — the
AWQ/GPTQ granularity); the matmul becomes a grouped einsum with the scale
applied per (group, out) partial product. Embedding / tied LM head stay int8
per-row in int4 mode: they're the precision-sensitive leaves and the smaller
share of the stream.

Storage is TWO NIBBLES PACKED PER int8 BYTE (group half j pairs with half
j + g/2), NOT the jnp.int4 dtype: a packed-int8 representation is exactly
as small in memory while staying a plain dtype everywhere (whether the GPU
runtime passes sub-byte arrays across jit boundaries is not verified). The
consuming matmul sign-extends the nibbles with two arithmetic shifts —
elementwise ops XLA can fuse into the operand read.

Representation: `QuantizedWeight(q, scale)` (int8, q 2-D) or
`QuantizedWeight4(q, scale)` (packed int4-in-int8, q 3-D grouped) pytree
nodes wherever a 2-D dense weight lived; `models.layers.dense` accepts
plain arrays or either node. Norms/biases stay bf16.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Union

import jax
import jax.numpy as jnp


class QuantizedWeight(NamedTuple):
    q: jax.Array        # (in, out) int8
    scale: jax.Array    # (1, out) f32 — per-output-channel


class QuantizedWeight4(NamedTuple):
    # input dim split into G groups of g; two int4 values packed per byte:
    # byte [G, j, out] holds nibbles for group rows j (low) and j + g/2 (high)
    q: jax.Array        # (G, g/2, out) int8 — packed int4 pairs
    scale: jax.Array    # (G, 1, out) f32 — per-(group, output-channel)


WeightLike = Union[jax.Array, QuantizedWeight, QuantizedWeight4]


def quantize_int8(w: jax.Array) -> QuantizedWeight:
    """Per-output-channel symmetric quantization of an (in, out) weight."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=0, keepdims=True)          # (1, out)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(wf / scale), -127, 127).astype(jnp.int8)
    return QuantizedWeight(q=q, scale=scale)


def unpack_int4(packed: jax.Array) -> jax.Array:
    """(G, g/2, out) packed int8 → (G, g, out) int8 nibble values in [-8, 7].

    Sign extension = two arithmetic shifts (int8 stays int8 throughout);
    these are elementwise VPU ops that fuse into the consuming matmul's
    operand read, so only the packed bytes stream from HBM."""
    lo = jnp.right_shift(jnp.left_shift(packed, 4), 4)   # low nibble
    hi = jnp.right_shift(packed, 4)                       # high nibble
    return jnp.concatenate([lo, hi], axis=1)


def dequantize(qw, dtype=jnp.bfloat16) -> jax.Array:
    """Materialize the fp weight (tests / oracles only — the serving matmuls
    never call this). Accepts QuantizedWeight or QuantizedWeight4."""
    if qw.q.ndim == 3:  # grouped packed int4 → (in, out)
        w = unpack_int4(qw.q).astype(jnp.float32) * qw.scale
        return w.reshape(-1, w.shape[-1]).astype(dtype)
    return (qw.q.astype(jnp.float32) * qw.scale).astype(dtype)


@functools.partial(jax.jit, static_argnames=("group",))
def quantize_int4(w: jax.Array, group: int = 128) -> QuantizedWeight4:
    """Group-wise symmetric int4 quantization of an (in, out) weight,
    packed two nibbles per byte (see QuantizedWeight4)."""
    i, o = w.shape
    g = min(group, i)
    if i % g or g % 2:  # need an even group size dividing the input dim
        g = i
    if g % 2:
        raise ValueError(
            f"int4 nibble packing needs an even input dim, got {w.shape}; "
            "quantize_decoder_params falls back to int8 for such weights")
    wf = w.astype(jnp.float32).reshape(i // g, g, o)
    amax = jnp.max(jnp.abs(wf), axis=1, keepdims=True)           # (G, 1, out)
    scale = jnp.maximum(amax, 1e-8) / 7.0
    q = jnp.clip(jnp.round(wf / scale), -8, 7).astype(jnp.int32)
    lo, hi = q[:, : g // 2], q[:, g // 2:]
    packed = ((hi << 4) | (lo & 0xF)).astype(jnp.int8)  # wraps to bit pattern
    return QuantizedWeight4(q=packed, scale=scale)


def quantize_act_int8(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Dynamic per-row (per-token) symmetric int8 quantization of an
    activation tensor (..., d). Returns (int8 values, (..., 1) f32 scales).

    Used by the W8A8 prefill path: int8 activations against the already-int8
    weights make s8 x s8 -> s32 dots (the card's int8 tensor-core rate is
    twice bf16's on paper; what XLA reaches with it is not measured yet).
    Per-token scales keep the quantization error ~0.3% relative — the
    scale is an exact power-free f32, and |x| <= 127 rounds once."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    return q, scale


def quantize_rows_int8(w: jax.Array) -> QuantizedWeight:
    """Per-ROW symmetric quantization — for (V, H) embedding / tied LM-head
    matrices, one scale per vocabulary row."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=1, keepdims=True)          # (V, 1)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(wf / scale), -127, 127).astype(jnp.int8)
    return QuantizedWeight(q=q, scale=scale)


def quantize_decoder_params(params: dict, bits: int = 8,
                            group: int = 128) -> dict:
    """Quantize every 2-D matmul weight in a decoder pytree, plus the (tied)
    token-embedding matrix — the LM head re-reads it every decode step, so
    it is the single largest weight stream. Norms and biases stay bf16.
    Returns a new pytree with QuantizedWeight(4) leaves (same key names, so
    TP sharding rules still apply to `.q`).

    bits=4: matmul weights go group-wise int4 (see `quantize_int4`); the
    embedding / tied LM head and any untied `lm_head` STAY int8 — per-row
    int8 is already within 0.4% on those and they are the quality-critical
    leaves."""
    assert bits in (4, 8), bits
    quant_keys = {"qkv_w", "o_w", "gu_w", "down_w", "ff_w1", "ff_w2"}

    def quant_mat(w):
        """(in, out) 2-D weight, or a STACKED (L, in, out) scan leaf — the
        stacked case vmaps the same per-matrix scheme over the layer axis, so
        the scan body slices out an identical QuantizedWeight(4) per layer."""
        if w.ndim == 3:
            if bits == 8 or w.shape[1] % 2:
                return jax.vmap(quantize_int8)(w)
            return jax.vmap(lambda m: quantize_int4(m, group=group))(w)
        if bits == 8 or w.shape[0] % 2:  # odd input dim can't nibble-pack
            return quantize_int8(w)
        return quantize_int4(w, group=group)

    def walk(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k == "embed" and getattr(v, "ndim", 0) == 2:
                    out[k] = quantize_rows_int8(v)
                elif k == "lm_head" and getattr(v, "ndim", 0) == 2:
                    out[k] = quantize_int8(v)
                elif k in quant_keys and getattr(v, "ndim", 0) in (2, 3):
                    out[k] = quant_mat(v)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(params)
