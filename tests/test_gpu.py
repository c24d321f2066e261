"""Card-only checks (marker `gpu`): the GPU routes of the kernel table,
compiled for the card, against the plain references. Skipped without a GPU;
chip_smoke.py runs them on the card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _f32_attention(q, k, v, bias):
    from rag_serving_system.models.layers import attention

    with jax.default_matmul_precision("highest"):
        return attention(q.astype(jnp.float32), k.astype(jnp.float32),
                         v.astype(jnp.float32), bias)


def test_kernel_table_on_card(gpu):
    from rag_serving_system.backend import kernels

    assert kernels().prefill_attention == "cudnn"
    assert kernels().packed_attention == "pallas_triton"


def test_cudnn_self_attention_matches_einsum(gpu):
    from rag_serving_system.models.layers import causal_padding_bias
    from rag_serving_system.ops.attention import self_attention

    b, s, hq, hk, d = 4, 256, 12, 2, 128
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(ks[0], (b, s, hq, d), jnp.bfloat16)
    k = jax.random.normal(ks[1], (b, s, hk, d), jnp.bfloat16)
    v = jax.random.normal(ks[2], (b, s, hk, d), jnp.bfloat16)
    mask = np.ones((b, s), np.int32)
    mask[1, :100] = 0
    mask[3, :255] = 0
    out = self_attention(q, k, v, jnp.asarray(mask), causal=True, impl="cudnn")
    ref = _f32_attention(q, k, v, causal_padding_bias(jnp.asarray(mask)))
    m = mask.astype(bool)
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref))[m].max()
    assert err <= 2e-2, err


def test_packed_kernel_compiled_matches_reference(gpu):
    from rag_serving_system.ops.attention import (packed_attention_pallas,
                                                  packed_attention_reference)

    t, hq, hk, d = 1024, 12, 2, 128
    lens = [300, 150, 260, 200]
    seg = np.full(t, len(lens), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        off += n
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    q = jax.random.normal(ks[0], (1, t, hq, d), jnp.bfloat16)
    k = jax.random.normal(ks[1], (1, t, hk, d), jnp.bfloat16)
    v = jax.random.normal(ks[2], (1, t, hk, d), jnp.bfloat16)
    segj = jnp.asarray(seg)[None]
    out = packed_attention_pallas(q, k, v, segj)
    with jax.default_matmul_precision("highest"):
        ref = packed_attention_reference(q.astype(jnp.float32),
                                         k.astype(jnp.float32),
                                         v.astype(jnp.float32), segj)
    err = np.abs(np.asarray(out, np.float32)[0, :off]
                 - np.asarray(ref)[0, :off]).max()
    assert err <= 2e-2, err


def test_topk_on_card_matches_numpy(gpu):
    from rag_serving_system.ops.topk import cosine_topk

    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((4096, 1024)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((32, 1024)).astype(np.float32)
    _, idx = cosine_topk(jnp.asarray(corpus), jnp.asarray(queries), 8)
    q = queries.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want = np.argsort(-(q @ corpus.astype(np.float64).T), axis=1,
                      kind="stable")[:, :8]
    np.testing.assert_array_equal(np.asarray(idx), want)
