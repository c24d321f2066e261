"""Weight-only int8 quantization: error bounds, decode still works, greedy
outputs mostly agree with fp at tiny scale, engine integration."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rag_serving_system.models.configs import QWEN2_TINY
from rag_serving_system.models.layers import dense
from rag_serving_system.models.qwen2 import generate, prefill
from rag_serving_system.models.weights import init_decoder_params
from rag_serving_system.ops.quant import (
    QuantizedWeight,
    dequantize,
    quantize_decoder_params,
    quantize_int8,
)


def test_quantize_roundtrip_error(rng):
    w = jnp.asarray(rng.standard_normal((64, 128)).astype(np.float32) * 0.02)
    qw = quantize_int8(w)
    assert qw.q.dtype == jnp.int8 and qw.scale.shape == (1, 128)
    err = np.abs(np.asarray(dequantize(qw, jnp.float32)) - np.asarray(w))
    # max error is half a quantization step per channel
    steps = np.asarray(qw.scale)[0]
    assert (err <= steps * 0.51 + 1e-8).all()


def test_dense_accepts_quantized(rng):
    x = jnp.asarray(rng.standard_normal((4, 64)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((64, 32)).astype(np.float32) * 0.02)
    y_fp = dense(x, w)
    y_q = dense(x, quantize_int8(w))
    np.testing.assert_allclose(np.asarray(y_q), np.asarray(y_fp),
                               rtol=0.05, atol=5e-3)


def test_quantize_decoder_params_structure():
    params = init_decoder_params(QWEN2_TINY, dtype=jnp.float32)
    qparams = quantize_decoder_params(params)
    layer = jax.tree.map(lambda a: a[0], qparams["layers"])  # slice layer 0
    for key in ("qkv_w", "o_w", "gu_w", "down_w"):
        assert isinstance(layer[key], QuantizedWeight), key
    # norms/biases untouched; embed quantized per-row (tied LM head)
    assert not isinstance(layer["ln1"], QuantizedWeight)
    assert not isinstance(qparams["ln_f"], QuantizedWeight)
    assert isinstance(qparams["embed"], QuantizedWeight)
    assert qparams["embed"].scale.shape == (QWEN2_TINY.vocab_size, 1)


def test_quantized_generate_runs_and_tracks_fp():
    cfg = QWEN2_TINY
    params = init_decoder_params(cfg, seed=1, dtype=jnp.float32)
    qparams = quantize_decoder_params(params)
    ids = jnp.asarray([[7, 23, 99, 45, 12, 88]], dtype=jnp.int32)
    mask = jnp.ones_like(ids)
    logits_fp, _ = prefill(params, cfg, ids, mask, 1, dtype=jnp.float32)
    logits_q, _ = prefill(qparams, cfg, ids, mask, 1, dtype=jnp.float32)
    # logits correlation should be very high even at tiny scale
    a, b = np.asarray(logits_fp[0]), np.asarray(logits_q[0])
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.99, corr
    toks = generate(qparams, cfg, ids, mask, jax.random.PRNGKey(0),
                    max_new_tokens=4, do_sample=False, dtype=jnp.float32)
    assert toks.shape == (1, 4)


def test_engine_with_int8(rng):
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    docs = [f"Fact {i}." for i in range(20)]
    emb = rng.standard_normal((20, 64)).astype(np.float32)
    settings = Settings(model_preset="tiny", dtype="float32",
                        batch_buckets=[2], encode_len_buckets=[16],
                        prompt_len_buckets=[64], max_new_tokens=2, max_k=4,
                        quant_weights="int8")
    engine = RagEngine(settings, docs, emb)
    results = engine.process(["q one", "q two"], [2, 2])
    assert len(results) == 2 and all("result" in r for r in results)


def test_w8a8_dense_matches_f32():
    """W8A8 (per-token act scales x per-channel weight scales) must track the
    f32 matmul within combined quantization error (~1%)."""
    from rag_serving_system.models.layers import dense_w8a8
    from rag_serving_system.ops.quant import quantize_int8

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((8, 64)), dtype=jnp.float32)
    w = jnp.asarray(rng.standard_normal((64, 96)), dtype=jnp.float32)
    exact = np.asarray(x) @ np.asarray(w)
    got = np.asarray(dense_w8a8(x, quantize_int8(w)))
    rms_rel = np.sqrt(np.mean((got - exact) ** 2) / np.mean(exact ** 2))
    assert rms_rel < 0.02, rms_rel


def test_w8a8_generate_close_to_bf16_path():
    """Greedy decode with W8A8 prefill on a tiny model: prefill logits stay
    close and the top-1 token usually agrees; the contract here is that the
    path runs end-to-end and does not corrupt the cache/positions."""
    from rag_serving_system.models.configs import QWEN2_TINY
    from rag_serving_system.models.qwen2 import prefill
    from rag_serving_system.models.weights import init_decoder_params
    from rag_serving_system.ops.quant import quantize_decoder_params

    cfg = QWEN2_TINY
    params = quantize_decoder_params(init_decoder_params(cfg, dtype=jnp.float32))
    ids = jnp.asarray([[7, 23, 99, 45, 3, 8, 101, 55]], dtype=jnp.int32)
    mask = jnp.ones_like(ids)
    base, _ = prefill(params, cfg, ids, mask, 1, dtype=jnp.float32)
    w8a8, _ = prefill(params, cfg, ids, mask, 1, dtype=jnp.float32,
                      act_quant=True)
    base, w8a8 = np.asarray(base), np.asarray(w8a8)
    cos = (base * w8a8).sum() / (np.linalg.norm(base) * np.linalg.norm(w8a8))
    assert cos > 0.999, cos


def test_engine_serves_with_int8_and_w8a8():
    """The production quant config (QUANT_WEIGHTS=int8 + QUANT_ACT=int8)
    must serve end-to-end: quantized pytree through prefill/decode, pad-row
    handling, detokenize."""
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    rng = np.random.default_rng(0)
    docs = [f"Fact {i}: the answer is {i * i}." for i in range(20)]
    emb = rng.standard_normal((20, 64)).astype(np.float32)
    settings = Settings(model_preset="tiny", dtype="float32",
                        batch_buckets=[1, 4], max_batch_size=4,
                        encode_len_buckets=[16, 32], prompt_len_buckets=[64],
                        max_new_tokens=3, max_k=4,
                        quant_weights="int8", quant_act="int8")
    engine = RagEngine(settings, docs, emb)
    assert engine.act_quant
    results = engine.process(["what is four times four?", "nine?"], [2, 2])
    assert len(results) == 2 and all(isinstance(r["result"], str) for r in results)


# ---------------------------------------------------------------------------
# int4 (group-wise) — QUANT_WEIGHTS=int4
# ---------------------------------------------------------------------------

def test_quantize_int4_roundtrip_error(rng):
    from rag_serving_system.ops.quant import quantize_int4

    w = jnp.asarray(rng.standard_normal((256, 96)).astype(np.float32) * 0.02)
    qw = quantize_int4(w, group=128)
    # two nibbles packed per int8 byte: (G, g/2, out)
    assert qw.q.dtype == jnp.int8 and qw.q.shape == (2, 64, 96)
    assert qw.scale.shape == (2, 1, 96)
    err = np.abs(np.asarray(dequantize(qw, jnp.float32)) - np.asarray(w))
    steps = np.repeat(np.asarray(qw.scale)[:, 0, :], 128, axis=0)  # (256, 96)
    assert (err <= steps * 0.51 + 1e-8).all()


def test_dense_int4_matches_dequant_oracle(rng):
    from rag_serving_system.ops.quant import quantize_int4

    x = jnp.asarray(rng.standard_normal((4, 256)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((256, 64)).astype(np.float32) * 0.02)
    qw = quantize_int4(w, group=128)
    y_grouped = np.asarray(dense(x, qw))
    y_oracle = np.asarray(x) @ np.asarray(dequantize(qw, jnp.float32))
    np.testing.assert_allclose(y_grouped, y_oracle, rtol=1e-4, atol=1e-5)


def test_w4a8_dense_tracks_int4_oracle(rng):
    """The int8-activation leg of W4A8 must add almost nothing on top of the
    int4 weight error: compare against dequant(int4) @ x in f32. (Against the
    UNquantized f32 matmul, int4 g=128 on gaussian weights is ~12% RMS — the
    intrinsic 4-bit error, which real trained weights tolerate far better
    than white noise does.)"""
    from rag_serving_system.models.layers import dense_w8a8
    from rag_serving_system.ops.quant import quantize_int4

    x = jnp.asarray(rng.standard_normal((8, 256)), dtype=jnp.float32)
    w = jnp.asarray(rng.standard_normal((256, 96)), dtype=jnp.float32)
    qw = quantize_int4(w, group=128)
    oracle = np.asarray(x) @ np.asarray(dequantize(qw, jnp.float32))
    got = np.asarray(dense_w8a8(x, qw))
    rms_rel = np.sqrt(np.mean((got - oracle) ** 2) / np.mean(oracle ** 2))
    assert rms_rel < 0.02, rms_rel  # the A8 part: ~0.4% per-token act error


def test_quantize_decoder_params_int4_structure():
    from rag_serving_system.ops.quant import QuantizedWeight4

    params = init_decoder_params(QWEN2_TINY, dtype=jnp.float32)
    qparams = quantize_decoder_params(params, bits=4)
    layer = jax.tree.map(lambda a: a[0], qparams["layers"])  # slice layer 0
    for key in ("qkv_w", "o_w", "gu_w", "down_w"):
        assert isinstance(layer[key], QuantizedWeight4), key
        assert layer[key].q.dtype == jnp.int8 and layer[key].q.ndim == 3
    # embed (tied head) stays int8 per-row — the precision-sensitive leaf
    assert isinstance(qparams["embed"], QuantizedWeight)
    assert qparams["embed"].q.dtype == jnp.int8


def test_int4_generate_runs_and_correlates():
    cfg = QWEN2_TINY
    params = init_decoder_params(cfg, seed=1, dtype=jnp.float32)
    qparams = quantize_decoder_params(params, bits=4)
    ids = jnp.asarray([[7, 23, 99, 45, 12, 88]], dtype=jnp.int32)
    mask = jnp.ones_like(ids)
    logits_fp, _ = prefill(params, cfg, ids, mask, 1, dtype=jnp.float32)
    logits_q, _ = prefill(qparams, cfg, ids, mask, 1, dtype=jnp.float32)
    a, b = np.asarray(logits_fp[0]), np.asarray(logits_q[0])
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.97, corr
    toks = generate(qparams, cfg, ids, mask, jax.random.PRNGKey(0),
                    max_new_tokens=4, do_sample=False, dtype=jnp.float32)
    assert toks.shape == (1, 4)


def test_engine_serves_with_int4():
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    rng = np.random.default_rng(0)
    docs = [f"Fact {i}: the answer is {i * i}." for i in range(20)]
    emb = rng.standard_normal((20, 64)).astype(np.float32)
    settings = Settings(model_preset="tiny", dtype="float32",
                        batch_buckets=[2], encode_len_buckets=[16],
                        prompt_len_buckets=[64], max_new_tokens=2, max_k=4,
                        quant_weights="int4", quant_act="int8")
    engine = RagEngine(settings, docs, emb)
    assert engine.act_quant
    results = engine.process(["q one", "q two"], [2, 2])
    assert len(results) == 2 and all("result" in r for r in results)
