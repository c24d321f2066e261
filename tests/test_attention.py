"""Prefill attention wrapper (jax.nn.dot_product_attention formulation, run
with implementation="xla" on the CPU — the cuDNN route differs only in the
implementation string) and the packed Pallas kernel (interpret mode) against
the einsum oracle."""

import numpy as np
import pytest
import jax.numpy as jnp

from rag_serving_system.models.layers import (
    attention,
    causal_padding_bias,
    padding_bias,
)
from rag_serving_system.ops.attention import (
    biased_attention,
    packed_attention,
    packed_attention_pallas,
    self_attention,
)


def _make(rng, b, s, hq, hk, d):
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    return jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)


@pytest.mark.parametrize("b,s,hq,hk,d", [
    (2, 128, 4, 2, 64),     # GQA group 2
    (1, 256, 2, 2, 32),     # MHA
    (2, 128, 6, 2, 32),     # group 3
])
def test_self_attention_causal_matches_oracle(rng, b, s, hq, hk, d):
    q, k, v = _make(rng, b, s, hq, hk, d)
    mask = jnp.ones((b, s), jnp.int32)
    ref = attention(q, k, v, causal_padding_bias(mask))
    out = self_attention(q, k, v, mask, causal=True, impl="xla")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_self_attention_left_padding(rng):
    """Decoder prompts: left-padded rows (each with its own pad count)."""
    b, s, hq, hk, d = 3, 128, 4, 2, 64
    q, k, v = _make(rng, b, s, hq, hk, d)
    mask = np.ones((b, s), np.int32)
    mask[0, :40] = 0
    mask[2, :127] = 0          # a single real token
    mask = jnp.asarray(mask)
    ref = attention(q, k, v, causal_padding_bias(mask))
    out = self_attention(q, k, v, mask, causal=True, impl="xla")
    m = np.asarray(mask).astype(bool)
    np.testing.assert_allclose(np.asarray(out)[m], np.asarray(ref)[m],
                               rtol=2e-4, atol=2e-4)
    # padding queries are defined as zeros
    np.testing.assert_array_equal(np.asarray(out)[~m], 0.0)


def test_self_attention_right_padded_causal(rng):
    """Prefix-KV rows are right-padded: real queries see only real keys."""
    b, s, hq, hk, d = 2, 128, 4, 2, 64
    q, k, v = _make(rng, b, s, hq, hk, d)
    mask = np.ones((b, s), np.int32)
    mask[1, 70:] = 0
    mask = jnp.asarray(mask)
    ref = attention(q, k, v, causal_padding_bias(mask))
    out = self_attention(q, k, v, mask, causal=True, impl="xla")
    m = np.asarray(mask).astype(bool)
    np.testing.assert_allclose(np.asarray(out)[m], np.asarray(ref)[m],
                               rtol=2e-4, atol=2e-4)


def test_self_attention_noncausal_matches_oracle(rng):
    """Encoder mode: right padding, and padding QUERIES keep their outputs
    (the encoder's unmasked mean pool reads every position)."""
    b, s, hq, hk, d = 2, 128, 4, 4, 64
    q, k, v = _make(rng, b, s, hq, hk, d)
    mask = np.ones((b, s), np.int32)
    mask[1, 100:] = 0
    mask = jnp.asarray(mask)
    ref = attention(q, k, v, padding_bias(mask))
    out = self_attention(q, k, v, mask, causal=False, impl="xla")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_biased_attention_prefix_suffix_matches_oracle(rng):
    """Prefix + suffix: suffix queries see the valid prefix slots and the
    causal, left-padded suffix."""
    from rag_serving_system.models.layers import NEG_INF

    b, s, pl_, hq, hk, d = 2, 16, 48, 4, 2, 64
    q, _, _ = _make(rng, b, s, hq, hk, d)
    _, k, v = _make(rng, b, pl_ + s, hq, hk, d)
    plen = np.array([48, 5])
    smask = np.ones((b, s), np.int32)
    smask[1, :9] = 0
    pvalid = np.arange(pl_)[None, :] < plen[:, None]
    bias = jnp.concatenate(
        [jnp.broadcast_to(jnp.where(jnp.asarray(pvalid), 0.0, NEG_INF)
                          [:, None, None, :], (b, 1, s, pl_)),
         causal_padding_bias(jnp.asarray(smask))], axis=-1)
    ref = attention(q, k, v, bias)
    out = biased_attention(q, k, v, bias, impl="xla")
    m = smask.astype(bool)
    np.testing.assert_allclose(np.asarray(out)[m], np.asarray(ref)[m],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(
        np.asarray(biased_attention(q, k, v, bias, impl="einsum")),
        np.asarray(ref))


def test_self_attention_rejects_unknown_impl(rng):
    q, k, v = _make(rng, 1, 16, 2, 2, 32)
    with pytest.raises(ValueError):
        self_attention(q, k, v, jnp.ones((1, 16), jnp.int32), causal=True,
                       impl="mosaic")
    with pytest.raises(ValueError):
        packed_attention(q, k, v, jnp.zeros((1, 16), jnp.int32),
                         impl="mosaic")
    with pytest.raises(ValueError):
        biased_attention(q, k, v, jnp.zeros((1, 1, 16, 16)), impl="mosaic")


def test_packed_kernel_rejects_ragged_blocks(rng):
    q, k, v = _make(rng, 1, 96, 2, 2, 32)
    with pytest.raises(ValueError):
        packed_attention_pallas(q, k, v, jnp.zeros((1, 96), jnp.int32),
                                block_q=64, block_k=64, interpret=True)


@pytest.mark.parametrize("causal", [False, True])
def test_self_attention_fully_masked_rows_emit_zeros(causal):
    """A row whose keys are ALL masked must output zeros, not an average of
    V (which is what a softmax over equal mask values would give)."""
    rng = np.random.default_rng(0)
    b, s, hq, hk, d = 2, 8, 2, 2, 128
    q = jnp.asarray(rng.standard_normal((b, s, hq, d)), dtype=jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, s, hk, d)), dtype=jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, s, hk, d)), dtype=jnp.float32)
    mask = jnp.asarray(np.array([[0] * s, [1] * s], np.int32))
    out = self_attention(q, k, v, mask, causal=causal, impl="xla")
    np.testing.assert_array_equal(np.asarray(out)[0], 0.0)
    assert np.isfinite(np.asarray(out)).all()
