"""HF safetensors loader tests against synthetic checkpoints with real HF
naming — validates the name mapping, (out,in)->(in,out) transposes, QKV/gate
fusion concatenation order, and tied-head handling without network access."""

import numpy as np
import pytest

import jax.numpy as jnp

from rag_serving_system.models.configs import E5_TINY, QWEN2_TINY
from rag_serving_system.models.e5 import encoder_forward
from rag_serving_system.models.qwen2 import prefill
from rag_serving_system.models.weights import (
    find_snapshot,
    load_decoder_params,
    load_encoder_params,
)

st = pytest.importorskip("safetensors.numpy")


def _save(tmp_path, tensors):
    st.save_file(tensors, str(tmp_path / "model.safetensors"))
    return str(tmp_path)


@pytest.fixture
def enc_ckpt(tmp_path):
    rng = np.random.default_rng(0)
    cfg = E5_TINY
    h, ff = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    t = {
        "embeddings.word_embeddings.weight": w(cfg.vocab_size, h),
        "embeddings.position_embeddings.weight": w(cfg.max_position_embeddings, h),
        "embeddings.token_type_embeddings.weight": w(cfg.type_vocab_size, h),
        "embeddings.LayerNorm.weight": np.ones(h, np.float32),
        "embeddings.LayerNorm.bias": np.zeros(h, np.float32),
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        t.update({
            p + "attention.self.query.weight": w(h, h),
            p + "attention.self.query.bias": w(h),
            p + "attention.self.key.weight": w(h, h),
            p + "attention.self.key.bias": w(h),
            p + "attention.self.value.weight": w(h, h),
            p + "attention.self.value.bias": w(h),
            p + "attention.output.dense.weight": w(h, h),
            p + "attention.output.dense.bias": w(h),
            p + "attention.output.LayerNorm.weight": np.ones(h, np.float32),
            p + "attention.output.LayerNorm.bias": np.zeros(h, np.float32),
            p + "intermediate.dense.weight": w(ff, h),      # HF: (out, in)
            p + "intermediate.dense.bias": w(ff),
            p + "output.dense.weight": w(h, ff),
            p + "output.dense.bias": w(h),
            p + "output.LayerNorm.weight": np.ones(h, np.float32),
            p + "output.LayerNorm.bias": np.zeros(h, np.float32),
        })
    return _save(tmp_path, t), t


def test_encoder_loader_mapping(enc_ckpt):
    snap, t = enc_ckpt
    params = load_encoder_params(E5_TINY, snap, dtype=jnp.float32)
    # transpose check: our (in, out) == HF (out, in).T
    got = np.asarray(params["layers"]["ff_w1"][0])
    want = t["encoder.layer.0.intermediate.dense.weight"].T
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # qkv fusion order: [q | k | v] along the output axis
    h = E5_TINY.hidden_size
    qkv = np.asarray(params["layers"]["qkv_w"][0])
    np.testing.assert_allclose(
        qkv[:, :h], t["encoder.layer.0.attention.self.query.weight"].T, rtol=1e-6)
    np.testing.assert_allclose(
        qkv[:, 2 * h:], t["encoder.layer.0.attention.self.value.weight"].T, rtol=1e-6)
    # forward runs
    ids = jnp.asarray([[5, 6, 7]], jnp.int32)
    out = encoder_forward(params, E5_TINY, ids, jnp.ones_like(ids), dtype=jnp.float32)
    assert out.shape == (1, 3, h) and np.isfinite(np.asarray(out)).all()


def test_encoder_loader_accepts_roberta_prefix(enc_ckpt, tmp_path):
    snap, t = enc_ckpt
    prefixed = {"roberta." + k: v for k, v in t.items()}
    d = tmp_path / "prefixed"
    d.mkdir()
    st.save_file(prefixed, str(d / "model.safetensors"))
    params = load_encoder_params(E5_TINY, str(d), dtype=jnp.float32)
    assert params["embed"]["word"].shape == (E5_TINY.vocab_size, E5_TINY.hidden_size)


@pytest.fixture
def dec_ckpt(tmp_path):
    rng = np.random.default_rng(1)
    cfg = QWEN2_TINY
    h, ff = cfg.hidden_size, cfg.intermediate_size
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    t = {
        "model.embed_tokens.weight": w(cfg.vocab_size, h),
        "model.norm.weight": np.ones(h, np.float32),
    }
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": np.ones(h, np.float32),
            p + "self_attn.q_proj.weight": w(qd, h),
            p + "self_attn.q_proj.bias": w(qd),
            p + "self_attn.k_proj.weight": w(kvd, h),
            p + "self_attn.k_proj.bias": w(kvd),
            p + "self_attn.v_proj.weight": w(kvd, h),
            p + "self_attn.v_proj.bias": w(kvd),
            p + "self_attn.o_proj.weight": w(h, qd),
            p + "post_attention_layernorm.weight": np.ones(h, np.float32),
            p + "mlp.gate_proj.weight": w(ff, h),
            p + "mlp.up_proj.weight": w(ff, h),
            p + "mlp.down_proj.weight": w(h, ff),
        })
    return _save(tmp_path, t), t


def test_decoder_loader_mapping_and_forward(dec_ckpt):
    snap, t = dec_ckpt
    cfg = QWEN2_TINY
    params = load_decoder_params(cfg, snap, dtype=jnp.float32)
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    qkv = np.asarray(params["layers"]["qkv_w"][0])
    np.testing.assert_allclose(
        qkv[:, :qd], t["model.layers.0.self_attn.q_proj.weight"].T, rtol=1e-6)
    np.testing.assert_allclose(
        qkv[:, qd:qd + kvd], t["model.layers.0.self_attn.k_proj.weight"].T, rtol=1e-6)
    gu = np.asarray(params["layers"]["gu_w"][0])
    np.testing.assert_allclose(
        gu[:, :cfg.intermediate_size], t["model.layers.0.mlp.gate_proj.weight"].T,
        rtol=1e-6)
    # tied head: no lm_head key; forward runs
    assert "lm_head" not in params
    ids = jnp.asarray([[3, 9, 27]], jnp.int32)
    logits, _ = prefill(params, cfg, ids, jnp.ones_like(ids), 1, dtype=jnp.float32)
    assert logits.shape == (1, cfg.vocab_size)
    assert np.isfinite(np.asarray(logits)).all()


def test_missing_tensor_is_loud(tmp_path):
    st.save_file({"model.embed_tokens.weight":
                  np.zeros((8, 8), np.float32)}, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError):
        load_decoder_params(QWEN2_TINY, str(tmp_path))


def test_find_snapshot_misses_cleanly(tmp_path):
    assert find_snapshot(str(tmp_path), "no/model") is None
