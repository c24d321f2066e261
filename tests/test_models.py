"""Encoder/decoder correctness tests on tiny configs (CPU).

The decisive test is greedy KV-cache decode == naive full-recompute decode;
that pins RoPE positions, GQA, cache writes, and left-pad masking all at once.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rag_serving_system.models.configs import E5_TINY, QWEN2_TINY
from rag_serving_system.models.e5 import encode, encoder_forward
from rag_serving_system.models.qwen2 import generate, prefill, logits_from_hidden
from rag_serving_system.models.weights import init_decoder_params, init_encoder_params
from rag_serving_system.models.layers import causal_padding_bias


@pytest.fixture(scope="module")
def enc_params():
    return init_encoder_params(E5_TINY, seed=0, dtype=jnp.float32)


@pytest.fixture(scope="module")
def dec_params():
    return init_decoder_params(QWEN2_TINY, seed=1, dtype=jnp.float32)


def test_encoder_shapes_and_determinism(enc_params):
    ids = jnp.array([[5, 6, 7, 1, 1], [8, 9, 10, 11, 12]], dtype=jnp.int32)
    mask = jnp.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], dtype=jnp.int32)
    e1 = encode(enc_params, E5_TINY, ids, mask, dtype=jnp.float32)
    e2 = encode(enc_params, E5_TINY, ids, mask, dtype=jnp.float32)
    assert e1.shape == (2, E5_TINY.hidden_size)
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))


def test_encoder_mask_blocks_pad_attention(enc_params):
    # same real tokens, different pad garbage → masked positions must not
    # change real-token hidden states
    ids_a = jnp.array([[5, 6, 7, 1, 1]], dtype=jnp.int32)
    ids_b = jnp.array([[5, 6, 7, 400, 401]], dtype=jnp.int32)
    mask = jnp.array([[1, 1, 1, 0, 0]], dtype=jnp.int32)
    ha = encoder_forward(enc_params, E5_TINY, ids_a, mask, dtype=jnp.float32)
    hb = encoder_forward(enc_params, E5_TINY, ids_b, mask, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(ha[:, :3]), np.asarray(hb[:, :3]),
                               rtol=1e-5, atol=1e-5)


def test_encoder_pooling_modes(enc_params):
    ids = jnp.array([[5, 6, 7, 1, 1]], dtype=jnp.int32)
    mask = jnp.array([[1, 1, 1, 0, 0]], dtype=jnp.int32)
    mean_all = encode(enc_params, E5_TINY, ids, mask, pooling="mean_all", dtype=jnp.float32)
    mean_masked = encode(enc_params, E5_TINY, ids, mask, pooling="mean_masked", dtype=jnp.float32)
    # with pads present they must differ (reference uses mean_all, bp.py:91)
    assert not np.allclose(np.asarray(mean_all), np.asarray(mean_masked))


def _naive_greedy(params, cfg, prompt, n_steps):
    """Greedy decode by full re-prefill each step (no KV cache) — oracle."""
    import rag_serving_system.models.qwen2 as q

    seq = list(map(int, prompt))
    out = []
    for _ in range(n_steps):
        ids = jnp.asarray([seq], dtype=jnp.int32)
        mask = jnp.ones_like(ids)
        logits, _ = prefill(params, cfg, ids, mask, 1, dtype=jnp.float32)
        nxt = int(jnp.argmax(logits, axis=-1)[0])
        out.append(nxt)
        seq.append(nxt)
    return out


def test_kv_cache_decode_matches_naive(dec_params):
    cfg = QWEN2_TINY
    prompt = [7, 23, 99, 45]
    naive = _naive_greedy(dec_params, cfg, prompt, 5)
    ids = jnp.asarray([prompt], dtype=jnp.int32)
    mask = jnp.ones_like(ids)
    toks = generate(dec_params, cfg, ids, mask, jax.random.PRNGKey(0),
                    max_new_tokens=5, do_sample=False, dtype=jnp.float32)
    assert list(map(int, np.asarray(toks)[0])) == naive


def test_left_padding_invariance(dec_params):
    """Left-padded prompt must generate the same greedy tokens as unpadded."""
    cfg = QWEN2_TINY
    prompt = [7, 23, 99, 45]
    ids = jnp.asarray([prompt], dtype=jnp.int32)
    mask = jnp.ones_like(ids)
    base = generate(dec_params, cfg, ids, mask, jax.random.PRNGKey(0),
                    max_new_tokens=4, do_sample=False, dtype=jnp.float32)
    pad = 3
    ids_p = jnp.asarray([[cfg.pad_token_id] * pad + prompt], dtype=jnp.int32)
    mask_p = jnp.asarray([[0] * pad + [1] * len(prompt)], dtype=jnp.int32)
    padded = generate(dec_params, cfg, ids_p, mask_p, jax.random.PRNGKey(0),
                      max_new_tokens=4, do_sample=False, dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(padded))


def test_generate_batch_matches_single(dec_params):
    """Batching must not change per-row greedy outputs."""
    cfg = QWEN2_TINY
    p1, p2 = [7, 23, 99, 45], [100, 3, 88, 12]
    def gen(prompts):
        ids = jnp.asarray(prompts, dtype=jnp.int32)
        mask = jnp.ones_like(ids)
        return np.asarray(generate(dec_params, cfg, ids, mask, jax.random.PRNGKey(0),
                                   max_new_tokens=3, do_sample=False, dtype=jnp.float32))
    both = gen([p1, p2])
    np.testing.assert_array_equal(both[0], gen([p1])[0])
    np.testing.assert_array_equal(both[1], gen([p2])[0])


def test_eos_stops_and_pads(dec_params):
    """After EOS is sampled, subsequent tokens must be pad_token_id."""
    cfg = QWEN2_TINY
    # find a prompt whose 2nd greedy token becomes EOS by brute force is
    # fragile; instead just check the contract on the output directly:
    ids = jnp.asarray([[7, 23, 99, 45]], dtype=jnp.int32)
    mask = jnp.ones_like(ids)
    toks = np.asarray(generate(dec_params, cfg, ids, mask, jax.random.PRNGKey(3),
                               max_new_tokens=8, do_sample=True, dtype=jnp.float32))[0]
    seen_eos = False
    for t in toks:
        if seen_eos:
            assert t == cfg.pad_token_id
        if t == cfg.eos_token_id:
            seen_eos = True


def test_row_valid_pad_rows_emit_only_pad(dec_params):
    """Batch-padding rows (row_valid=False) are born done: they emit only
    pad_token_id and never defeat the all-done early exit."""
    cfg = QWEN2_TINY
    prompts = [[7, 23, 99, 45], [100, 3, 88, 12], [1, 2, 3, 4], [9, 9, 9, 9]]
    ids = jnp.asarray(prompts, dtype=jnp.int32)
    mask = jnp.ones_like(ids)
    row_valid = jnp.asarray([True, True, False, False])
    toks = np.asarray(generate(dec_params, cfg, ids, mask, jax.random.PRNGKey(0),
                               max_new_tokens=6, do_sample=True,
                               dtype=jnp.float32, row_valid=row_valid))
    assert (toks[2:] == cfg.pad_token_id).all()
    # real rows unaffected by the pad rows being marked done
    base = np.asarray(generate(dec_params, cfg, ids, mask, jax.random.PRNGKey(0),
                               max_new_tokens=6, do_sample=True,
                               dtype=jnp.float32))
    np.testing.assert_array_equal(toks[:2], base[:2])


def test_early_exit_with_pad_rows(dec_params):
    """When every REAL row hits EOS, decode stops even though pad rows never
    sample EOS: everything after the real rows' EOS must be pad."""
    import dataclasses

    cfg = QWEN2_TINY
    prompt = [7, 23, 99, 45]
    ids = jnp.asarray([prompt, prompt], dtype=jnp.int32)
    mask = jnp.ones_like(ids)
    # find the greedy first token, then make THAT token the EOS id so the
    # real row finishes at step 0
    first = int(np.asarray(generate(dec_params, cfg, ids, mask,
                                    jax.random.PRNGKey(0), max_new_tokens=1,
                                    do_sample=False, dtype=jnp.float32))[0, 0])
    cfg_eos = dataclasses.replace(cfg, eos_token_id=first)
    row_valid = jnp.asarray([True, False])
    toks = np.asarray(generate(dec_params, cfg_eos, ids, mask,
                               jax.random.PRNGKey(0), max_new_tokens=6,
                               do_sample=False, dtype=jnp.float32,
                               row_valid=row_valid))
    assert toks[0, 0] == first
    assert (toks[0, 1:] == cfg_eos.pad_token_id).all()
    assert (toks[1] == cfg_eos.pad_token_id).all()


def test_generate_stops_on_any_eos_id():
    """Instruct models declare several stop ids (Qwen2.5: im_end AND
    endoftext); generate must stop a row on ANY of them. Constructed so the
    very first emitted token is a secondary EOS: everything after must be
    pad and the early exit must have fired."""
    import dataclasses

    from rag_serving_system.models.configs import QWEN2_TINY
    from rag_serving_system.models.qwen2 import generate
    from rag_serving_system.models.weights import init_decoder_params

    cfg = dataclasses.replace(QWEN2_TINY, eos_token_ids=tuple(range(512)))
    params = init_decoder_params(cfg, seed=3, dtype=jnp.float32)
    ids = jnp.asarray([[5, 9, 17, 4]], dtype=jnp.int32)
    out = np.asarray(generate(params, cfg, ids, jnp.ones_like(ids),
                              jax.random.PRNGKey(0), max_new_tokens=6,
                              do_sample=False, dtype=jnp.float32))
    assert (out[:, 1:] == cfg.pad_token_id).all()
