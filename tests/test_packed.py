"""Packed (ragged) prefill: kernel, generate, and engine-level parity.

The cold no-prefix path packs the batch's real tokens into one (1, T)
stream (engine `_stage_packed` → models/qwen2.py `prefill_packed` →
ops/attention.py `packed_attention`), cutting prefill FLOPs from
B*max(len) to sum(len). These tests pin exactness: the packed path must be
BIT-IDENTICAL to the padded path under greedy decoding."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rag_serving_system.models.configs import decoder_config_for
from rag_serving_system.models.weights import init_decoder_params
from rag_serving_system.models.qwen2 import generate, generate_packed
from rag_serving_system.ops.attention import (
    packed_attention_pallas, packed_attention_reference)


def _pack(rows, t, b_cap, p, pad_id=0):
    """Host-side packing identical to RagEngine._stage_packed."""
    stream = np.zeros((3, t), np.int32)
    stream[0] = pad_id
    stream[1] = b_cap
    gather = np.full((b_cap, p), -1, np.int32)
    last = np.full((b_cap,), -1, np.int32)
    off = 0
    for b, r in enumerate(rows):
        n = len(r)
        stream[0, off:off + n] = r
        stream[1, off:off + n] = b
        stream[2, off:off + n] = np.arange(n)
        gather[b, p - n:] = off + np.arange(n)
        last[b] = off + n - 1
        off += n
    return stream, gather, last


def test_packed_kernel_matches_reference():
    """The packed Pallas kernel (interpret mode) == jnp block-diagonal
    oracle on real tokens; pad-region outputs are never consumed."""
    rng = np.random.default_rng(0)
    t, hq, hk, d = 1024, 4, 2, 128
    lens = [300, 150, 260, 200]
    seg = np.full(t, len(lens), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        off += n
    q = (rng.standard_normal((1, t, hq, d)) * 0.1).astype(np.float32)
    k = (rng.standard_normal((1, t, hk, d)) * 0.1).astype(np.float32)
    v = (rng.standard_normal((1, t, hk, d)) * 0.1).astype(np.float32)
    segj = jnp.asarray(seg)[None]
    out = packed_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segj, interpret=True)
    ref = packed_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segj)
    np.testing.assert_allclose(np.asarray(out)[0, :off],
                               np.asarray(ref)[0, :off], atol=3e-5)


def test_packed_kernel_rows_are_isolated():
    """A row's attention output must not depend on what else shares the
    pack: compare row 0 packed alone vs packed with three other rows."""
    rng = np.random.default_rng(1)
    hq, hk, d = 4, 2, 128
    n0 = 200
    q0 = (rng.standard_normal((1, 256, hq, d)) * 0.1).astype(np.float32)
    k0 = (rng.standard_normal((1, 256, hk, d)) * 0.1).astype(np.float32)
    v0 = (rng.standard_normal((1, 256, hk, d)) * 0.1).astype(np.float32)
    seg_alone = np.where(np.arange(256) < n0, 0, 9).astype(np.int32)[None]
    alone = packed_attention_reference(
        jnp.asarray(q0), jnp.asarray(k0), jnp.asarray(v0),
        jnp.asarray(seg_alone))
    # same row 0 content packed with others
    t = 1024
    q = (rng.standard_normal((1, t, hq, d)) * 0.1).astype(np.float32)
    k = (rng.standard_normal((1, t, hk, d)) * 0.1).astype(np.float32)
    v = (rng.standard_normal((1, t, hk, d)) * 0.1).astype(np.float32)
    q[:, :n0], k[:, :n0], v[:, :n0] = q0[:, :n0], k0[:, :n0], v0[:, :n0]
    seg = np.full(t, 9, np.int32)
    seg[:n0] = 0
    seg[n0:n0 + 300] = 1
    seg[n0 + 300:n0 + 500] = 2
    packed = packed_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(seg)[None], interpret=True)
    np.testing.assert_allclose(np.asarray(packed)[0, :n0],
                               np.asarray(alone)[0, :n0], atol=3e-5)


def test_generate_packed_matches_padded_greedy():
    """generate_packed == generate, token-for-token, under greedy decode
    (same weights, same rows, f32 on CPU → bit-exact expectations)."""
    cfg = decoder_config_for("tiny")
    params = init_decoder_params(cfg, 0, jnp.float32)
    rng = jax.random.PRNGKey(3)
    b, p = 4, 64
    lens = [37, 12, 55, 23]
    rows = [list(np.random.default_rng(i).integers(10, cfg.vocab_size, n))
            for i, n in enumerate(lens)]
    ids = np.zeros((b, p), np.int32)
    mask = np.zeros((b, p), np.int32)
    for i, r in enumerate(rows):
        ids[i, p - len(r):] = r
        mask[i, p - len(r):] = 1
    out_pad = np.asarray(generate(
        params, cfg, jnp.asarray(ids), jnp.asarray(mask), rng,
        max_new_tokens=6, do_sample=False, dtype=jnp.float32,
        row_valid=jnp.ones(b, bool)))
    stream, gather, last = _pack(rows, 256, b, p)
    out_pk = np.asarray(generate_packed(
        params, cfg, jnp.asarray(stream[0])[None], jnp.asarray(stream[1])[None],
        jnp.asarray(stream[2])[None], jnp.asarray(np.maximum(last, 0)),
        jnp.asarray(np.maximum(gather, 0)),
        jnp.asarray((gather >= 0).astype(np.int32)), rng,
        max_new_tokens=6, max_seg_len=p, do_sample=False, dtype=jnp.float32,
        row_valid=jnp.asarray(last >= 0)))
    assert np.array_equal(out_pad, out_pk)


def test_generate_packed_pad_rows_emit_pad():
    """Pad rows (last == -1) are born done: only pad_token_id comes out."""
    cfg = decoder_config_for("tiny")
    params = init_decoder_params(cfg, 0, jnp.float32)
    rows = [[11, 12, 13]]
    b_cap, p = 4, 32
    stream, gather, last = _pack(rows, 256, b_cap, p)
    out = np.asarray(generate_packed(
        params, cfg, jnp.asarray(stream[0])[None], jnp.asarray(stream[1])[None],
        jnp.asarray(stream[2])[None], jnp.asarray(np.maximum(last, 0)),
        jnp.asarray(np.maximum(gather, 0)),
        jnp.asarray((gather >= 0).astype(np.int32)), jax.random.PRNGKey(0),
        max_new_tokens=4, max_seg_len=p, do_sample=False, dtype=jnp.float32,
        row_valid=jnp.asarray(last >= 0)))
    assert (out[1:] == cfg.pad_token_id).all()
    assert out.shape == (b_cap, 4)


@pytest.fixture(scope="module")
def corpus():
    docs = [f"document {i} states fact number {i} about subject {i} "
            f"{'with extra detail ' * (i % 7)}" for i in range(24)]
    emb = np.random.default_rng(0).standard_normal((24, 64)).astype(np.float32)
    return docs, emb


def _engine(corpus, packed: bool):
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    docs, emb = corpus
    s = Settings(model_preset="tiny", batch_buckets=[4], max_batch_size=4,
                 encode_len_buckets=[16], prompt_len_buckets=[64, 128],
                 max_new_tokens=4, do_sample=False, prefix_cache=False,
                 packed_prefill=packed)
    return RagEngine(s, docs, emb)


def test_engine_packed_matches_padded(corpus):
    """Full-engine A/B: PACKED_PREFILL on vs off, greedy, prefix cache off —
    identical answers for full and partial batches."""
    qs = ["document 3 states fact number 3",
          "document 11 states fact number 11 about subject 11",
          "what does document 7 say?"]
    eng_pk = _engine(corpus, packed=True)
    eng_pd = _engine(corpus, packed=False)
    assert eng_pk.packed and not eng_pd.packed
    for n in (3, 1):
        a = eng_pk.process(qs[:n], [2] * n)
        b = eng_pd.process(qs[:n], [2] * n)
        assert a == b, (n, a, b)


def test_engine_packed_margin_gate(corpus):
    """stage_prompts only stages packed when the packed T bucket undercuts
    PACKED_MARGIN * bsz * plen; otherwise it falls back to the padded trace
    (round 4: a sum just past a bucket edge must never pay MORE padding
    packed than padded would)."""
    eng = _engine(corpus, packed=True)
    qs = ["document 3 states fact number 3"] * 4
    prepared = eng.prepare(qs, [2] * 4)
    staged = eng.stage_prompts(prepared)
    # with the margin forced to 0 the gate can never pass -> padded staging
    import rag_serving_system.core.engine as eng_mod
    old = eng_mod.PACKED_MARGIN
    try:
        eng_mod.PACKED_MARGIN = 0.0
        staged_forced = eng.stage_prompts(prepared)
        assert staged_forced[0] == "padded"
        # and the padded fallback produces the same answers as packed
        eng_mod.PACKED_MARGIN = 10.0   # always pack
        staged_pk = eng.stage_prompts(prepared)
        assert staged_pk[0] == "packed"
        a = eng.finalize_tokens(eng.generate_tokens(staged=staged_pk))
        b = eng.finalize_tokens(eng.generate_tokens(staged=staged_forced))
        assert a == b
    finally:
        eng_mod.PACKED_MARGIN = old
    # default staging picks whichever the gate says; both are valid programs
    assert staged[0] in ("packed", "padded")


def test_engine_packed_overlong_prompt_takes_padded_path(corpus):
    """Rows longer than the packed P bucket must take the PADDED trace:
    _stage_packed would truncate them to packed_p while the padded path's
    larger plen buckets keep more tail — staging packed would silently
    serve less context than the bit-identical guarantee promises
    (review finding, round 4)."""
    eng = _engine(corpus, packed=True)
    long_q = "filler " * 400 + "what does document 5 say?"
    prepared = eng.prepare([long_q], [2])
    rows = eng._prompt_tokens_batch(list(prepared))
    assert max(len(r) for r in rows) > eng.packed_p  # premise: truly overlong
    staged = eng.stage_prompts(prepared)
    assert staged[0] == "padded"
    out = eng.process([long_q], [2])
    assert len(out) == 1 and "result" in out[0]
