"""Speculative (multi-token) greedy decode — exactness and drafting tests.

The claim under test: `generate(..., spec_gamma=g, do_sample=False)` is
BIT-IDENTICAL to the sequential greedy loop — at f32, where arithmetic is
effectively exact for these sizes — for every gamma, batch shape, padding
pattern, EOS placement, per-row budget, and the prefix-KV serving path;
acceptance only changes how many weight streams the output costs, never the
output (models/qwen2.py::_spec_decode_loop). bf16 trajectory stability is a
model-confidence property (random-init logit gaps sit below chunk-vs-step
reduction noise; trained checkpoints far above).

The reference has no decode loop of its own (HF pipeline,
rag_service/core/batch_processor.py:104-105); this feature is how the
decode-heavy regime gets past the 1-token weight-streaming bound.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rag_serving_system.models.configs import QWEN2_TINY
from rag_serving_system.models.qwen2 import (
    compute_prefix_kv,
    draft_ngram,
    generate,
)
from rag_serving_system.models.weights import init_decoder_params

CFG = QWEN2_TINY


@pytest.fixture(scope="module")
def params():
    return init_decoder_params(CFG, dtype=jnp.float32)


def _gen(params, ids, mask, *, spec_gamma=0, cfg=CFG, **kw):
    kw.setdefault("max_new_tokens", 12)
    return np.asarray(generate(
        params, cfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
        jax.random.PRNGKey(0), do_sample=False, dtype=jnp.float32,
        spec_gamma=spec_gamma, **kw))


PROMPTS = [[7, 23, 99, 45, 3, 8], [100, 3, 88, 12, 55, 2],
           [1, 2, 1, 2, 1, 2], [9, 9, 9, 9, 9, 9]]
MASK = [[1] * 6] * 4


@pytest.mark.parametrize("gamma", [1, 3, 7])
def test_spec_matches_sequential_greedy(params, gamma):
    base = _gen(params, PROMPTS, MASK)
    spec = _gen(params, PROMPTS, MASK, spec_gamma=gamma)
    np.testing.assert_array_equal(spec, base)


def test_spec_with_left_padding(params):
    ids = [[0, 0, 7, 23, 99, 45], [0, 0, 0, 100, 3, 88],
           [1, 2, 1, 2, 1, 2], [0, 9, 9, 9, 9, 9]]
    mask = [[0, 0, 1, 1, 1, 1], [0, 0, 0, 1, 1, 1],
            [1, 1, 1, 1, 1, 1], [0, 1, 1, 1, 1, 1]]
    np.testing.assert_array_equal(
        _gen(params, ids, mask, spec_gamma=4), _gen(params, ids, mask))


def test_spec_honors_row_budgets(params):
    budgets = jnp.asarray([3, 12, 1, 7], jnp.int32)
    base = _gen(params, PROMPTS, MASK, row_budget=budgets)
    spec = _gen(params, PROMPTS, MASK, row_budget=budgets, spec_gamma=3)
    np.testing.assert_array_equal(spec, base)
    # budget semantics themselves: row b holds exactly budget[b] non-pad
    # tokens (greedy tiny model never emits EOS here in 12 tokens)
    for b, n in enumerate([3, 12, 1, 7]):
        row = spec[b]
        assert (row[n:] == CFG.pad_token_id).all()


def test_spec_row_valid_pad_rows(params):
    rv = jnp.asarray([True, True, False, False])
    base = _gen(params, PROMPTS, MASK, row_valid=rv)
    spec = _gen(params, PROMPTS, MASK, row_valid=rv, spec_gamma=5)
    np.testing.assert_array_equal(spec, base)
    assert (spec[2:] == CFG.pad_token_id).all()


def test_spec_eos_early_stop(params):
    """Make the observed 3rd greedy token the EOS id: the spec path must emit
    it and pad everything after, exactly like the sequential loop — including
    when the EOS lands MID-ACCEPTED-CHUNK."""
    base = _gen(params, PROMPTS, MASK)
    third = int(base[0, 2])
    cfg_eos = dataclasses.replace(CFG, eos_token_id=third)
    b2 = _gen(params, PROMPTS, MASK, cfg=cfg_eos)
    s2 = _gen(params, PROMPTS, MASK, cfg=cfg_eos, spec_gamma=4)
    np.testing.assert_array_equal(s2, b2)


def test_spec_with_prefix_kv(params):
    """The prefix-KV serving path (cached context + suffix ids) must stay
    bit-exact under spec decode too — the history seeds from the suffix
    only, which may change ACCEPTANCE but never the tokens."""
    rng = np.random.default_rng(7)
    b, pl, sfx = 2, 8, 6
    ctx = jnp.asarray(rng.integers(10, CFG.vocab_size - 10, (b, pl)), jnp.int32)
    ctx_mask = jnp.ones((b, pl), jnp.int32)
    kv = compute_prefix_kv(params, CFG, ctx, ctx_mask, dtype=jnp.float32)
    plen = jnp.full((b,), pl, jnp.int32)
    sids = jnp.asarray(rng.integers(10, CFG.vocab_size - 10, (b, sfx)), jnp.int32)
    smask = jnp.ones((b, sfx), jnp.int32)

    def run(gamma):
        return np.asarray(generate(
            params, CFG, sids, smask, jax.random.PRNGKey(0),
            max_new_tokens=10, do_sample=False, dtype=jnp.float32,
            prefix_kv=kv, prefix_len=plen, spec_gamma=gamma))

    np.testing.assert_array_equal(run(4), run(0))


def test_spec_gamma_ignored_when_sampling(params):
    """Sampling has no rejection-resampling path: spec_gamma must be a no-op
    (same program, same samples) rather than silently changing outputs."""
    ids = jnp.asarray(PROMPTS, jnp.int32)
    mask = jnp.ones_like(ids)
    a = np.asarray(generate(params, CFG, ids, mask, jax.random.PRNGKey(5),
                            max_new_tokens=6, do_sample=True,
                            dtype=jnp.float32))
    bb = np.asarray(generate(params, CFG, ids, mask, jax.random.PRNGKey(5),
                             max_new_tokens=6, do_sample=True,
                             dtype=jnp.float32, spec_gamma=4))
    np.testing.assert_array_equal(a, bb)


# ---------------------------------------------------------------------------
# draft_ngram unit behavior
# ---------------------------------------------------------------------------

def test_draft_ngram_finds_latest_bigram_continuation():
    #        0  1  2  3  4  5  6  7   (cur=8; last bigram = [5, 6] at 6,7)
    hist = jnp.asarray([[9, 5, 6, 1, 2, 3, 5, 6, 0, 0, 0, 0]], jnp.int32)
    cur = jnp.asarray([8], jnp.int32)
    # earlier [5, 6] at positions 1,2 → continuation 1, 2, 3
    d = np.asarray(draft_ngram(hist, cur, 3, pad_id=0))
    np.testing.assert_array_equal(d, [[1, 2, 3]])


def test_draft_ngram_picks_most_recent_match():
    #        0  1  2  3  4  5  6  7  8  9  (cur=10; bigram [1,2] at 8,9)
    hist = jnp.asarray([[1, 2, 7, 0, 0, 1, 2, 8, 1, 2, 0, 0, 0]], jnp.int32)
    cur = jnp.asarray([10], jnp.int32)
    # matches at 0 (→7) and 5 (→8): most recent wins → 8
    d = np.asarray(draft_ngram(hist, cur, 1, pad_id=0))
    np.testing.assert_array_equal(d, [[8]])


def test_draft_ngram_fallback_repeats_last_token():
    hist = jnp.asarray([[4, 9, 17, 0, 0, 0]], jnp.int32)  # no earlier [9, 17]
    cur = jnp.asarray([3], jnp.int32)
    d = np.asarray(draft_ngram(hist, cur, 4, pad_id=0))
    np.testing.assert_array_equal(d, [[17, 17, 17, 17]])


def test_draft_ngram_never_matches_its_own_bigram():
    # the current bigram occurrence itself (ending at cur-1) must not count
    hist = jnp.asarray([[3, 8, 8, 3, 8, 0]], jnp.int32)  # cur=5, bigram [3,8]
    cur = jnp.asarray([5], jnp.int32)
    # earlier [3, 8] at 0,1 → continuation hist[2] = 8
    d = np.asarray(draft_ngram(hist, cur, 1, pad_id=0))
    np.testing.assert_array_equal(d, [[8]])


def test_spec_accepts_on_repetitive_output(params):
    """A self-repeating greedy stream must let spec decode finish in far
    fewer verify iterations than tokens emitted — the economics the feature
    exists for. We can't force repetition out of random weights, so drive
    _spec_decode_loop's machinery through a crafted check: a prompt that IS
    a repeated bigram gives the drafter instant coverage of any output that
    continues the loop; at minimum the iteration count must never exceed the
    sequential trip count."""
    from rag_serving_system.models.qwen2 import _spec_decode_loop, prefill

    ids = jnp.asarray(PROMPTS, jnp.int32)
    mask = jnp.ones_like(ids)
    mnt, gamma = 12, 4
    logits0, cache = prefill(params, CFG, ids, mask, mnt + gamma,
                             dtype=jnp.float32)
    out, iters = _spec_decode_loop(params, CFG, logits0, cache, mask,
                                   mnt, gamma, jnp.float32, None,
                                   ids.shape[1], ids)
    base = _gen(params, PROMPTS, MASK, max_new_tokens=mnt)
    np.testing.assert_array_equal(np.asarray(out), base)
    assert int(iters) <= mnt - 1


# ---------------------------------------------------------------------------
# engine integration: SPEC_DECODE through RagEngine, both staging layouts
# ---------------------------------------------------------------------------

def _mk_engine(spec_gamma, packed, rng):
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    docs = [f"doc {i} " + " ".join(f"w{i}t{j}" for j in range(18))
            for i in range(32)]
    emb = rng.standard_normal((32, 64)).astype(np.float32)
    s = Settings(model_preset="tiny", dtype="float32", batch_buckets=[4],
                 max_batch_size=4, encode_len_buckets=[16],
                 prompt_len_buckets=[64], max_new_tokens=8, max_k=4,
                 do_sample=False, prefix_cache=False,
                 packed_prefill=packed, spec_gamma=spec_gamma)
    return RagEngine(s, docs, emb)


@pytest.mark.parametrize("packed", [False, True])
def test_engine_spec_parity(packed):
    rng = np.random.default_rng(0)
    queries = [f"query {i}" for i in range(4)]
    base = _mk_engine(0, packed, np.random.default_rng(0)).process(
        queries, [2] * 4)
    spec = _mk_engine(4, packed, np.random.default_rng(0)).process(
        queries, [2] * 4)
    assert spec == base


def test_engine_spec_parity_with_budgets():
    rng = np.random.default_rng(0)
    queries = [f"query {i}" for i in range(4)]
    budgets = [2, 8, 1, 5]
    base = _mk_engine(0, False, np.random.default_rng(0)).process(
        queries, [2] * 4, budgets=budgets)
    spec = _mk_engine(3, False, np.random.default_rng(0)).process(
        queries, [2] * 4, budgets=budgets)
    assert spec == base


def test_engine_spec_ignored_when_sampling():
    """DO_SAMPLE=1 + SPEC_DECODE set: the engine must zero the knob."""
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    rng = np.random.default_rng(0)
    docs = [f"d{i} x y z" for i in range(8)]
    emb = rng.standard_normal((8, 64)).astype(np.float32)
    s = Settings(model_preset="tiny", dtype="float32", batch_buckets=[2],
                 max_batch_size=2, encode_len_buckets=[16],
                 prompt_len_buckets=[64], max_new_tokens=4, max_k=2,
                 do_sample=True, prefix_cache=False, packed_prefill=False,
                 spec_gamma=4)
    assert RagEngine(s, docs, emb).spec_gamma == 0


def test_draft_ngram_trigram_beats_bigram():
    """Longest-match ladder: when both a trigram and a (different,
    more recent) bigram occurrence exist, the trigram's continuation wins."""
    #        0  1  2  3  4  5  6  7  8  9 10  (cur=11; last 3 = [5, 1, 2])
    hist = jnp.asarray([[5, 1, 2, 9, 9, 1, 2, 7, 5, 1, 2, 0, 0]], jnp.int32)
    cur = jnp.asarray([11], jnp.int32)
    # bigram [1,2] latest earlier at 5,6 → continuation 7
    # trigram [5,1,2] at 0..2 → continuation 9 — must win
    d = np.asarray(draft_ngram(hist, cur, 1, pad_id=0))
    np.testing.assert_array_equal(d, [[9]])


def test_draft_ngram_trigram_excludes_own_occurrence():
    # only the current trigram occurrence exists → falls to bigram/none
    hist = jnp.asarray([[4, 1, 2, 3, 0, 0]], jnp.int32)  # cur=4, last3=[1,2,3]
    cur = jnp.asarray([4], jnp.int32)
    d = np.asarray(draft_ngram(hist, cur, 2, pad_id=0))
    # no earlier trigram or bigram [2,3] → repeat-last fallback
    np.testing.assert_array_equal(d, [[3, 3]])
