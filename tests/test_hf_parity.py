"""Numerical parity of the JAX model ports against real HF/torch checkpoints.

The reference serves torch `AutoModel` e5 (XLM-RoBERTa) + a Qwen2.5 pipeline
(reference: main.py:26-32); our ports must be *the same models*. These tests
build tiny random-weight checkpoints with the REAL HF implementations
(`save_pretrained`), load them through `models/weights.py`, and assert:

- encoder last_hidden_state and the reference's unmasked mean-pool
  (reference: rag_service/core/batch_processor.py:89-92) match torch ≤1e-4
  at f32 — pins the RoBERTa position-id offset, LayerNorm placement, GELU
  flavor, and the QKV fusion/transposes in the loader;
- decoder prefill logits match torch ≤1e-4 and greedy `generate` tokens
  match `model.generate(do_sample=False)` EXACTLY, including left-padded
  batches — pins RoPE layout/positions, GQA, KV-cache writes, tied
  embeddings, and EOS/pad semantics.

Everything runs offline (no hub access): the checkpoints are constructed
in-process at toy sizes.
"""

import os

os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from rag_serving_system.models.configs import DecoderConfig, EncoderConfig
from rag_serving_system.models.e5 import encode, encoder_forward
from rag_serving_system.models.qwen2 import generate, prefill
from rag_serving_system.models.weights import (
    load_decoder_params,
    load_encoder_params,
)

ATOL = 1e-4


# ---------------------------------------------------------------------------
# encoder: XLM-RoBERTa
# ---------------------------------------------------------------------------

ENC_JAX_CFG = EncoderConfig(
    vocab_size=211, hidden_size=64, num_layers=3, num_heads=4,
    intermediate_size=96, max_position_embeddings=80, type_vocab_size=1,
    layer_norm_eps=1e-5, pad_token_id=1)


@pytest.fixture(scope="module")
def enc_pair(tmp_path_factory):
    from transformers import XLMRobertaConfig, XLMRobertaModel

    hf_cfg = XLMRobertaConfig(
        vocab_size=211, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=96,
        max_position_embeddings=80, type_vocab_size=1,
        layer_norm_eps=1e-5, pad_token_id=1, hidden_act="gelu",
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    model = XLMRobertaModel(hf_cfg).eval()
    d = tmp_path_factory.mktemp("enc_ckpt")
    model.save_pretrained(d)
    params = load_encoder_params(ENC_JAX_CFG, str(d), dtype=jnp.float32)
    return model, params


def _enc_batch():
    # right-padded batch with genuinely different lengths (pad_token_id=1)
    ids = np.array([
        [5, 17, 42, 8, 150, 1, 1, 1],
        [9, 30, 2, 77, 61, 45, 12, 3],
        [88, 1, 1, 1, 1, 1, 1, 1],
    ], dtype=np.int32)
    mask = (ids != 1).astype(np.int32)
    return ids, mask


def test_encoder_last_hidden_state_matches_torch(enc_pair):
    model, params = enc_pair
    ids, mask = _enc_batch()
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids, dtype=torch.long),
                    attention_mask=torch.tensor(mask, dtype=torch.long)
                    ).last_hidden_state.numpy()
    ours = np.asarray(encoder_forward(
        params, ENC_JAX_CFG, jnp.asarray(ids), jnp.asarray(mask),
        dtype=jnp.float32))
    # compare REAL positions everywhere (padding positions are attended
    # nowhere and carry no contract)
    for b in range(ids.shape[0]):
        n = int(mask[b].sum())
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], atol=ATOL,
                                   err_msg=f"row {b}")


def test_encoder_mean_pool_matches_reference_semantics(enc_pair):
    """The reference pools with an UNMASKED mean over all positions
    (batch_processor.py:91) — ours must reproduce it on a real checkpoint,
    pads included."""
    model, params = enc_pair
    ids, mask = _enc_batch()
    with torch.no_grad():
        hs = model(input_ids=torch.tensor(ids, dtype=torch.long),
                   attention_mask=torch.tensor(mask, dtype=torch.long)
                   ).last_hidden_state
        ref = hs.mean(dim=1).numpy()   # the reference's exact pooling line
    ours = np.asarray(encode(params, ENC_JAX_CFG, jnp.asarray(ids),
                             jnp.asarray(mask), pooling="mean_all",
                             dtype=jnp.float32))
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_encoder_position_id_offset_is_load_bearing(enc_pair):
    """Sanity guard: shifting positions by one must CHANGE the output — i.e.
    the RoBERTa pad_token_id+1 offset in roberta_position_ids is actually
    exercised by this checkpoint, so the parity above is meaningful."""
    model, params = enc_pair
    ids, mask = _enc_batch()
    base = np.asarray(encoder_forward(
        params, ENC_JAX_CFG, jnp.asarray(ids), jnp.asarray(mask),
        dtype=jnp.float32))
    shifted = dict(params)
    emb = dict(params["embed"])
    emb["pos"] = jnp.roll(params["embed"]["pos"], 1, axis=0)
    shifted["embed"] = emb
    moved = np.asarray(encoder_forward(
        shifted, ENC_JAX_CFG, jnp.asarray(ids), jnp.asarray(mask),
        dtype=jnp.float32))
    assert not np.allclose(base, moved, atol=ATOL)


# ---------------------------------------------------------------------------
# decoder: Qwen2
# ---------------------------------------------------------------------------

DEC_JAX_CFG = DecoderConfig(
    vocab_size=199, hidden_size=64, num_layers=3, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=96, rms_norm_eps=1e-6,
    rope_theta=10000.0, tie_word_embeddings=True,
    max_position_embeddings=512, eos_token_id=5, pad_token_id=0)


def _make_qwen(tmp_path_factory, tie: bool):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    hf_cfg = Qwen2Config(
        vocab_size=199, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
        max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=tie, pad_token_id=0, eos_token_id=5,
        bos_token_id=4, attention_dropout=0.0, use_sliding_window=False)
    torch.manual_seed(1 if tie else 2)
    model = Qwen2ForCausalLM(hf_cfg).eval()
    d = tmp_path_factory.mktemp(f"qwen_ckpt_{tie}")
    model.save_pretrained(d)
    import dataclasses
    jax_cfg = dataclasses.replace(DEC_JAX_CFG, tie_word_embeddings=tie)
    params = load_decoder_params(jax_cfg, str(d), dtype=jnp.float32)
    return model, params, jax_cfg


@pytest.fixture(scope="module")
def dec_pair(tmp_path_factory):
    return _make_qwen(tmp_path_factory, tie=True)


@pytest.fixture(scope="module")
def dec_pair_untied(tmp_path_factory):
    return _make_qwen(tmp_path_factory, tie=False)


def test_decoder_prefill_logits_match_torch(dec_pair):
    model, params, cfg = dec_pair
    ids = np.array([[7, 23, 99, 45, 12, 8],
                    [100, 3, 88, 12, 9, 77]], dtype=np.int32)
    mask = np.ones_like(ids)
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids, dtype=torch.long),
                    attention_mask=torch.tensor(mask, dtype=torch.long)
                    ).logits[:, -1, :].numpy()
    ours, _ = prefill(params, cfg, jnp.asarray(ids), jnp.asarray(mask),
                      max_new_tokens=1, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=ATOL)


def test_decoder_prefill_logits_match_torch_untied(dec_pair_untied):
    """Untied lm_head exercises the separate-head loading path."""
    model, params, cfg = dec_pair_untied
    assert "lm_head" in params
    ids = np.array([[7, 23, 99, 45]], dtype=np.int32)
    mask = np.ones_like(ids)
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids, dtype=torch.long),
                    attention_mask=torch.tensor(mask, dtype=torch.long)
                    ).logits[:, -1, :].numpy()
    ours, _ = prefill(params, cfg, jnp.asarray(ids), jnp.asarray(mask),
                      max_new_tokens=1, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=ATOL)


def _hf_greedy(model, ids, mask, n_new):
    with torch.no_grad():
        out = model.generate(
            input_ids=torch.tensor(ids, dtype=torch.long),
            attention_mask=torch.tensor(mask, dtype=torch.long),
            max_new_tokens=n_new, do_sample=False, num_beams=1,
            pad_token_id=0, eos_token_id=5, use_cache=True)
    return out[:, ids.shape[1]:].numpy()


def test_decoder_greedy_generate_matches_hf(dec_pair):
    model, params, cfg = dec_pair
    ids = np.array([[7, 23, 99, 45, 12, 8],
                    [100, 3, 88, 12, 9, 77]], dtype=np.int32)
    mask = np.ones_like(ids)
    n_new = 8
    ref = _hf_greedy(model, ids, mask, n_new)
    ours = np.asarray(generate(params, cfg, jnp.asarray(ids),
                               jnp.asarray(mask), jax.random.PRNGKey(0),
                               max_new_tokens=n_new, do_sample=False,
                               dtype=jnp.float32))
    # rows that stopped early: HF pads with pad_token_id=0, ours too
    np.testing.assert_array_equal(ours, ref)


def test_decoder_greedy_generate_matches_hf_left_padded(dec_pair):
    """Left-padded batch (the serving layout, reference main.py:31
    padding_side='left'): position ids and causal masking must line up with
    HF's mask-aware generate path."""
    model, params, cfg = dec_pair
    ids = np.array([[0, 0, 7, 23, 99, 45],
                    [100, 3, 88, 12, 9, 77],
                    [0, 0, 0, 0, 42, 17]], dtype=np.int32)
    mask = (np.cumsum(ids != 0, axis=1) > 0).astype(np.int32)
    mask[:] = (ids != 0).astype(np.int32)  # left pads are the only zeros here
    n_new = 6
    ref = _hf_greedy(model, ids, mask, n_new)
    ours = np.asarray(generate(params, cfg, jnp.asarray(ids),
                               jnp.asarray(mask), jax.random.PRNGKey(0),
                               max_new_tokens=n_new, do_sample=False,
                               dtype=jnp.float32))
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# family generalization: Llama-style decoder (no QKV bias), BERT encoder
# ---------------------------------------------------------------------------

def test_llama_decoder_greedy_matches_hf(tmp_path_factory):
    """Llama architecture (attention_bias=False, untied-by-default GQA,
    explicit head_dim) loaded through the same pytree/config-from-hf path:
    greedy tokens must match HF exactly, including a left-padded batch."""
    from transformers import LlamaConfig, LlamaForCausalLM

    from rag_serving_system.models.configs import decoder_config_from_hf

    hf_cfg = LlamaConfig(
        vocab_size=173, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=112,
        max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=True, pad_token_id=0, eos_token_id=5,
        bos_token_id=4, attention_bias=False, attention_dropout=0.0)
    torch.manual_seed(3)
    model = LlamaForCausalLM(hf_cfg).eval()
    d = tmp_path_factory.mktemp("llama_ckpt")
    model.save_pretrained(d)

    import json as _json
    cfg = decoder_config_from_hf(_json.load(open(f"{d}/config.json")))
    assert not cfg.qkv_bias and cfg.num_kv_heads == 2 and cfg.head_dim == 16
    params = load_decoder_params(cfg, str(d), dtype=jnp.float32)
    assert "qkv_b" not in params["layers"]

    ids = np.array([[0, 0, 7, 23, 99, 45],
                    [101, 3, 88, 12, 9, 77]], dtype=np.int32)
    mask = (ids != 0).astype(np.int32)
    mask[1] = 1
    n_new = 6
    with torch.no_grad():
        out = model.generate(
            input_ids=torch.tensor(ids, dtype=torch.long),
            attention_mask=torch.tensor(mask, dtype=torch.long),
            max_new_tokens=n_new, do_sample=False, num_beams=1,
            pad_token_id=0, eos_token_id=5, use_cache=True)
    ref = out[:, ids.shape[1]:].numpy()
    ours = np.asarray(generate(params, cfg, jnp.asarray(ids),
                               jnp.asarray(mask), jax.random.PRNGKey(0),
                               max_new_tokens=n_new, do_sample=False,
                               dtype=jnp.float32))
    np.testing.assert_array_equal(ours, ref)


def test_bert_encoder_matches_hf(tmp_path_factory):
    """BERT-family encoder (absolute 0..L-1 positions, pad_token_id=0,
    type_vocab_size=2) through the same loader: last_hidden_state must match
    torch <=1e-4 — pins the position_style switch."""
    from transformers import BertConfig, BertModel

    from rag_serving_system.models.configs import encoder_config_from_hf

    hf_cfg = BertConfig(
        vocab_size=191, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=96,
        max_position_embeddings=64, type_vocab_size=2, pad_token_id=0,
        hidden_act="gelu", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(4)
    model = BertModel(hf_cfg).eval()
    d = tmp_path_factory.mktemp("bert_ckpt")
    model.save_pretrained(d)

    import json as _json
    cfg = encoder_config_from_hf(_json.load(open(f"{d}/config.json")))
    assert cfg.position_style == "absolute" and cfg.pad_token_id == 0
    params = load_encoder_params(cfg, str(d), dtype=jnp.float32)

    ids = np.array([[5, 17, 42, 8, 0, 0],
                    [9, 30, 2, 77, 61, 45]], dtype=np.int32)
    mask = (ids != 0).astype(np.int32)
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids, dtype=torch.long),
                    attention_mask=torch.tensor(mask, dtype=torch.long)
                    ).last_hidden_state.numpy()
    ours = np.asarray(encoder_forward(params, cfg, jnp.asarray(ids),
                                      jnp.asarray(mask), dtype=jnp.float32))
    for b in range(ids.shape[0]):
        n = int(mask[b].sum())
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], atol=ATOL,
                                   err_msg=f"row {b}")


def test_qwen2_config_from_hf_roundtrip(dec_pair, tmp_path_factory):
    """decoder_config_from_hf on a Qwen2 config.json must reproduce the
    handwritten config (QKV bias on, tied embeddings)."""
    from transformers import Qwen2Config

    from rag_serving_system.models.configs import decoder_config_from_hf

    hf_cfg = Qwen2Config(
        vocab_size=199, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
        max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=True, pad_token_id=0, eos_token_id=5)
    cfg = decoder_config_from_hf(hf_cfg.to_dict())
    assert cfg.qkv_bias and cfg.tie_word_embeddings
    assert cfg.vocab_size == 199 and cfg.head_dim == 16
