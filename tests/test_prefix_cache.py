"""Prefix-KV cache: exactness vs full prefill, LRU semantics, engine wiring.

The prefix path must be *numerically equivalent* to prefilling the whole
prompt (same RoPE positions, same attention sets) — greedy generation with
and without the cache must emit identical tokens (reference behavior contract:
rag_service/core/batch_processor.py:100-105 builds one flat prompt string;
splitting it for KV reuse is purely an execution-strategy change)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rag_serving_system.core.prefix_cache import (
    PrefixKVCache,
    PromptSpec,
    split_prefix_tokens,
)
from rag_serving_system.models.configs import QWEN2_TINY
from rag_serving_system.models.qwen2 import (
    compute_prefix_kv,
    generate,
    prefill,
)
from rag_serving_system.models.weights import init_decoder_params


def _left_pad(rows, width, pad_id=0):
    ids = np.full((len(rows), width), pad_id, np.int32)
    mask = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        ids[i, width - len(r):] = r
        mask[i, width - len(r):] = 1
    return jnp.asarray(ids), jnp.asarray(mask)


def _right_pad(rows, width, pad_id=0):
    ids = np.full((len(rows), width), pad_id, np.int32)
    mask = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return jnp.asarray(ids), jnp.asarray(mask)


@pytest.fixture(scope="module")
def tiny_decoder():
    cfg = QWEN2_TINY
    params = init_decoder_params(cfg, seed=7, dtype=jnp.float32)
    return cfg, params


def test_compute_prefix_kv_matches_prefill_cache(tiny_decoder):
    """Entry payloads must equal the KV a full prefill would produce for the
    same leading tokens (positions 0..n-1)."""
    cfg, params = tiny_decoder
    rng = np.random.default_rng(3)
    prefix = rng.integers(2, cfg.vocab_size, size=14).tolist()

    ids, mask = _right_pad([prefix], 16)
    kv = compute_prefix_kv(params, cfg, ids, mask,
                           dtype=jnp.float32)          # (1, L, 2, 16, Hk, D)

    fids, fmask = _left_pad([prefix], 14)  # exact length: no padding at all
    _, cache = prefill(params, cfg, fids, fmask, max_new_tokens=1,
                       dtype=jnp.float32)
    for li in range(cfg.num_layers):
        np.testing.assert_allclose(np.asarray(kv[0, li, 0, :14]),
                                   np.asarray(cache.k[li][0, :14]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(kv[0, li, 1, :14]),
                                   np.asarray(cache.v[li][0, :14]),
                                   rtol=1e-5, atol=1e-5)


def test_generate_with_prefix_matches_vanilla(tiny_decoder):
    """Greedy decode over [cached prefix + suffix] == greedy decode over the
    full prompt, including mixed batches with a zero-prefix (bypass) row."""
    cfg, params = tiny_decoder
    rng = np.random.default_rng(11)
    pre_lens = [20, 12, 0]          # third row bypasses (no cached prefix)
    suf_lens = [6, 9, 18]
    pres = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in pre_lens]
    sufs = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in suf_lens]
    fulls = [p + s for p, s in zip(pres, sufs)]

    key = jax.random.PRNGKey(0)
    fids, fmask = _left_pad(fulls, 32)
    want = generate(params, cfg, fids, fmask, key, max_new_tokens=4,
                    do_sample=False, dtype=jnp.float32)

    pool_len = 24
    pids, pmask = _right_pad(pres, pool_len)
    pmask = np.asarray(pmask).copy()
    pmask[2, 0] = 1  # keep the empty row well-defined (engine does the same)
    kv = compute_prefix_kv(params, cfg, pids, jnp.asarray(pmask),
                           dtype=jnp.float32)
    sids, smask = _left_pad(sufs, 24)
    got = generate(params, cfg, sids, smask, key, max_new_tokens=4,
                   do_sample=False, dtype=jnp.float32,
                   prefix_kv=kv,
                   prefix_len=jnp.asarray(pre_lens, jnp.int32))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


def test_generate_with_prefix_sampled_shapes(tiny_decoder):
    """Sampling path through the prefix branch: right shapes, valid ids."""
    cfg, params = tiny_decoder
    rng = np.random.default_rng(5)
    pres = [rng.integers(2, cfg.vocab_size, size=10).tolist()]
    sufs = [rng.integers(2, cfg.vocab_size, size=5).tolist()]
    kv = compute_prefix_kv(params, cfg, *_right_pad(pres, 16),
                           dtype=jnp.float32)
    sids, smask = _left_pad(sufs, 8)
    out = generate(params, cfg, sids, smask, jax.random.PRNGKey(2),
                   max_new_tokens=3, do_sample=True, dtype=jnp.float32,
                   prefix_kv=kv, prefix_len=jnp.asarray([10], jnp.int32))
    out = np.asarray(out)
    assert out.shape == (1, 3)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()


def test_quantize_prefix_kv_error_bound(tiny_decoder):
    """int8 storage: per-(token, head) symmetric quant, |err| <= scale/2."""
    from rag_serving_system.models.qwen2 import quantize_prefix_kv

    cfg, params = tiny_decoder
    rng = np.random.default_rng(9)
    pres = [rng.integers(2, cfg.vocab_size, size=12).tolist()]
    kv = compute_prefix_kv(params, cfg, *_right_pad(pres, 16),
                           dtype=jnp.float32)
    q, s = quantize_prefix_kv(kv)
    assert q.dtype == jnp.int8 and s.shape == kv.shape[:-1] + (1,)
    err = np.abs(np.asarray(kv, np.float32)
                 - np.asarray(q, np.float32) * np.asarray(s))
    assert (err <= np.asarray(s) * 0.5 + 1e-7).all()


def test_generate_with_int8_prefix_close_to_exact(tiny_decoder):
    """int8-stored prefix KV: same shapes, near-identical logits/tokens as
    the exact (full-precision) prefix path."""
    cfg, params = tiny_decoder
    from rag_serving_system.models.qwen2 import prefill, quantize_prefix_kv

    rng = np.random.default_rng(21)
    pres = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (14, 9)]
    sufs = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 7)]
    kv = compute_prefix_kv(params, cfg, *_right_pad(pres, 16),
                           dtype=jnp.float32)
    plen = jnp.asarray([14, 9], jnp.int32)
    sids, smask = _left_pad(sufs, 8)

    exact, _ = prefill(params, cfg, sids, smask, 1, dtype=jnp.float32,
                       prefix_kv=kv, prefix_len=plen)
    quant, _ = prefill(params, cfg, sids, smask, 1, dtype=jnp.float32,
                       prefix_kv=quantize_prefix_kv(kv), prefix_len=plen)
    exact, quant = np.asarray(exact), np.asarray(quant)
    # int8 KV error perturbs logits slightly; cosine similarity stays ~1
    cos = (exact * quant).sum(-1) / (
        np.linalg.norm(exact, axis=-1) * np.linalg.norm(quant, axis=-1))
    assert (cos > 0.999).all()

    key = jax.random.PRNGKey(0)
    out = generate(params, cfg, sids, smask, key, max_new_tokens=3,
                   do_sample=False, dtype=jnp.float32,
                   prefix_kv=quantize_prefix_kv(kv), prefix_len=plen)
    assert np.asarray(out).shape == (2, 3)


def test_engine_int8_prefix_cache():
    mk = _engines()
    on = mk(prefix_cache=True, prefix_cache_dtype="int8")
    bf = mk(prefix_cache=True)
    assert on.prefix_cache.entry_bytes < bf.prefix_cache.entry_bytes
    queries = ["what is the answer about topic three?"]
    r1 = [r["result"] for r in on.process(queries, [2])]
    r2 = [r["result"] for r in on.process(queries, [2])]  # hit path
    assert r1 == r2  # same cached entry → deterministic greedy output
    assert on.prefix_cache.stats()["hits"] > 0


def test_split_prefix_tokens():
    full = [5, 6, 7, 8, 9, 10]
    assert split_prefix_tokens(full, [5, 6, 7], 16) == 3
    # boundary merge: separately-tokenized prefix ends differently → trim
    assert split_prefix_tokens(full, [5, 6, 99], 16) == 2
    assert split_prefix_tokens(full, [5, 6, 7, 8], 3) == 3   # pool cap
    assert split_prefix_tokens(full, [99], 16) == 0


def test_lru_eviction_and_verify():
    shape = (2, 2, 8, 2, 4)
    cache = PrefixKVCache(pool_len=8, entry_bytes=1 << 20, budget_mb=2,
                          entry_shape=shape, dtype=jnp.float32)
    assert cache.capacity == 2
    def put(key, toks, fill):
        rows = jnp.full((1,) + shape, fill, jnp.float32)
        return cache.put_batch([key], [toks], rows)[key]

    ea = put("a", (1, 2), 1.0)
    put("b", (3, 4), 2.0)
    assert cache.get("a", (1, 2)) is not None     # refreshes 'a'
    ec = put("c", (5, 6), 3.0)                    # evicts LRU 'b', reuses slot
    assert ec.slot != ea.slot
    assert len(cache) == 2
    assert cache.get("b", (3, 4)) is None
    assert cache.get("a", (1, 2)) is not None
    # key collision with different tokens must MISS, never serve wrong KV
    assert cache.get("c", (5, 999)) is None
    s = cache.stats()
    assert s["entries"] == 2 and s["hits"] == 2 and s["misses"] == 2
    # gather returns each entry's own payload + zeros for the no-prefix slot
    g = np.asarray(cache.gather([ea.slot, ec.slot, cache.zero_slot]))
    assert (g[0] == 1.0).all() and (g[1] == 3.0).all() and (g[2] == 0.0).all()


def test_concurrent_gather_put_batch_is_safe():
    """put_batch's scatter DONATES the pool buffer; gathers racing with it
    from other threads (parallel warmup jobs, stage-1 workers) must never
    observe the deleted array. Regression for the round-3 parallel-warmup
    race — flaked ~1 in 3 runs before gather/scatter were fully locked."""
    import threading

    shape = (2, 2, 8, 2, 4)
    cache = PrefixKVCache(pool_len=8, entry_bytes=1 << 12, budget_mb=4,
                          entry_shape=shape, dtype=jnp.float32)
    errs: list = []

    def putter(t):
        try:
            for i in range(40):
                rows = jnp.full((1,) + shape, float(i), jnp.float32)
                cache.put_batch([(t, i)], [(i,)], rows)
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    def gatherer():
        try:
            for _ in range(120):
                np.asarray(cache.gather([cache.zero_slot, cache.scratch_slot]))
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    threads = ([threading.Thread(target=putter, args=(t,)) for t in range(2)]
               + [threading.Thread(target=gatherer) for _ in range(2)])
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs, errs
    # zero slot must still be all-zeros after the storm
    g = np.asarray(cache.gather([cache.zero_slot]))
    assert (g == 0.0).all()


def test_prompt_spec_is_a_string():
    p = PromptSpec("hello world", prefix_text="hello", cache_key=("ctx", (1,)))
    assert p == "hello world" and len(p) == 11
    assert p.prefix_text == "hello" and p.cache_key == ("ctx", (1,))
    assert isinstance(p, str)
    assert p.sort_len == 6  # suffix chars drive length-aware regrouping


# ---------------------------------------------------------------------------
# engine wiring
# ---------------------------------------------------------------------------

def _engines():
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    rng = np.random.default_rng(0)
    docs = [(f"Fact number {i}: the answer to the question about topic {i} "
             f"is {i * i}, which was established in study {i}.")
            for i in range(30)]
    emb = rng.standard_normal((30, 64)).astype(np.float32)

    def mk(**over):
        base = dict(model_preset="tiny", dtype="float32",
                    batch_buckets=[1, 2, 4], encode_len_buckets=[16, 32],
                    prompt_len_buckets=[64, 128], max_new_tokens=4, max_k=4,
                    max_batch_size=4, do_sample=False,
                    prefix_pool_len=48)
        base.update(over)
        return RagEngine(Settings(**base), docs, emb)

    return mk


def test_engine_prefix_cache_answers_match_and_hit():
    mk = _engines()
    on = mk(prefix_cache=True)
    off = mk(prefix_cache=False)
    assert on.prefix_cache is not None and off.prefix_cache is None

    queries = ["what is the answer about topic three?",
               "tell me about study seven please"]
    a1 = [r["result"] for r in on.process(queries, [2, 2])]
    b = [r["result"] for r in off.process(queries, [2, 2])]
    assert a1 == b

    # deterministic retrieval → same contexts → cache hits on the rerun
    before = on.prefix_cache.stats()
    a2 = [r["result"] for r in on.process(queries, [2, 2])]
    after = on.prefix_cache.stats()
    assert a2 == a1
    assert after["hits"] > before["hits"]
    assert after["entries"] >= 1


def test_engine_prefix_cache_dedups_within_batch():
    mk = _engines()
    on = mk(prefix_cache=True)
    # identical query twice → identical context → ONE cache entry
    on.process(["what is the answer about topic three?"] * 2, [2, 2])
    st = on.prefix_cache.stats()
    assert st["entries"] == 1


def test_put_batch_never_clobbers_protected_slots():
    """Slot reuse must skip slots the current batch's gather will read (its
    hits) and the batch's own fresh inserts — otherwise a row silently
    generates from another request's context KV."""
    shape = (2, 2, 8, 2, 4)
    cache = PrefixKVCache(pool_len=8, entry_bytes=1 << 20, budget_mb=3,
                          entry_shape=shape, dtype=jnp.float32)
    assert cache.capacity == 3
    rows = lambda n, fill: jnp.full((n,) + shape, fill, jnp.float32)  # noqa: E731
    ea = cache.put_batch(["a"], [(1,)], rows(1, 1.0))["a"]
    cache.put_batch(["b"], [(2,)], rows(1, 2.0))
    cache.put_batch(["c"], [(3,)], rows(1, 3.0))
    # cache full; batch hits 'a' then inserts two misses protecting a's slot
    fresh = cache.put_batch(["d", "e"], [(4,), (5,)], rows(2, 9.0),
                            protected={ea.slot})
    assert ea.slot not in {e.slot for e in fresh.values()}
    g = np.asarray(cache.gather([ea.slot]))
    assert (g == 1.0).all()  # a's payload untouched


def test_put_batch_reinsert_recycles_slot():
    """Re-inserting an existing key (token-split variant) must recycle the
    old entry's slot, not leak it."""
    shape = (2, 2, 8, 2, 4)
    cache = PrefixKVCache(pool_len=8, entry_bytes=1 << 20, budget_mb=2,
                          entry_shape=shape, dtype=jnp.float32)
    rows = lambda n, fill: jnp.full((n,) + shape, fill, jnp.float32)  # noqa: E731
    for i in range(6):  # alternate two token variants of the same key
        cache.put_batch(["k"], [(i,)], rows(1, float(i)))
        assert len(cache) == 1
        # free + entry slots must always account for the full capacity
        assert len(cache._free) + 1 == cache.capacity


def test_put_batch_scatters_padded_rows_to_scratch():
    """put_batch scatters the full bucketed row count (pads -> scratch slot)
    so the scatter program shape is fixed per compute bucket."""
    shape = (2, 2, 8, 2, 4)
    cache = PrefixKVCache(pool_len=8, entry_bytes=1 << 20, budget_mb=8,
                          entry_shape=shape, dtype=jnp.float32)
    rows = jnp.concatenate([jnp.full((1,) + shape, 5.0, jnp.float32),
                            jnp.full((7,) + shape, -1.0, jnp.float32)])
    e = cache.put_batch(["x"], [(1,)], rows)["x"]  # 1 real + 7 pad rows
    g = np.asarray(cache.gather([e.slot, cache.zero_slot]))
    assert (g[0] == 5.0).all()
    assert (g[1] == 0.0).all()  # zero slot untouched by pad scatter


def test_min_slots_overrides_budget():
    cache = PrefixKVCache(pool_len=8, entry_bytes=1 << 20, budget_mb=2,
                          entry_shape=(2, 2, 8, 2, 4), dtype=jnp.float32,
                          min_slots=65)
    assert cache.capacity == 65


def test_engine_clamps_cache_capacity_to_batch_headroom():
    """Even with a byte budget far below one batch's worth of entries, the
    engine must reserve enough slots that a full batch of distinct misses +
    hits can never deadlock the allocator (min_slots = 2*max_batch + 1)."""
    mk = _engines()
    eng = mk(prefix_cache=True, prefix_cache_mb=1)  # ~nothing
    assert eng.prefix_cache.capacity >= 2 * eng.batch_buckets[-1] + 1
    queries = [f"what about topic {i}?" for i in range(4)]
    results = eng.process(queries, [2] * 4)
    assert len(results) == 4 and all("result" in r for r in results)


def test_lazy_pool_growth_preserves_slots_and_grows_to_capacity():
    """The pool starts small (initial_slots), doubles on demand, and live
    slot indices stay valid across growth (zero/scratch rows are pinned at
    0/1). LRU eviction only begins at full capacity."""
    cache = PrefixKVCache(pool_len=8, entry_bytes=1 << 10, budget_mb=1,
                          entry_shape=(2, 2, 8, 2, 4), dtype=jnp.float32,
                          initial_slots=2, min_slots=0)
    assert cache.capacity > 4 and cache.n_slots == 2
    rows0 = cache._pool.shape[0]
    kv = jnp.ones((1, 2, 2, 8, 2, 4), jnp.float32)
    first = cache.put_batch([("k", 0)], [(1, 2)], kv)[("k", 0)]
    for i in range(1, 5):  # force two doublings
        cache.put_batch([("k", i)], [(1, 2)], kv * (i + 1))
    assert cache.grows >= 1 and cache._pool.shape[0] > rows0
    st = cache.stats()
    assert st["slots"] >= 5
    assert st["pool_reserved_bytes"] == (cache.n_slots + 2) * cache.entry_bytes
    # entry inserted BEFORE growth still reads back intact after growth
    g = np.asarray(cache.gather([first.slot, cache.zero_slot]))
    assert (g[0] == 1.0).all() and (g[1] == 0.0).all()
    # misses so far; no eviction yet below capacity
    assert len(cache) == 5


def test_adaptive_bypass_engages_on_thrash_and_recovers():
    """Cyclic access over a working set >> capacity must flip the cache into
    bypass mode (only probe batches attempt the prefix path); a cacheable
    workload must bring it back."""
    cache = PrefixKVCache(pool_len=8, entry_bytes=1 << 20, budget_mb=4,
                          entry_shape=(2, 2, 8, 2, 4), dtype=jnp.float32,
                          adaptive=True, window=64, low_hit_rate=0.25,
                          probe_every=4, min_slots=0)
    cap = cache.capacity
    assert cap < 32

    # thrash: every lookup a distinct never-repeating key
    k = 0
    attempts = 0
    for batch in range(64):
        if cache.should_attempt():
            attempts += 1
            for _ in range(8):
                assert cache.get(("c", k), (k,)) is None
                cache.put_batch([("c", k)], [(k,)],
                                jnp.zeros((1, 2, 2, 8, 2, 4), jnp.float32))
                k += 1
    st = cache.stats()
    assert st["bypass_mode"] is True
    assert st["probes"] > 0
    # most batches were skipped once the window filled
    assert attempts < 40, attempts

    # cacheable phase: the same few keys repeat; probes hit, window refills,
    # bypass lifts
    keys = [("h", i) for i in range(4)]
    for key in keys:  # seed entries via a probe-independent insert
        cache.put_batch([key], [(0,)],
                        jnp.zeros((1, 2, 2, 8, 2, 4), jnp.float32))
    recovered = False
    for batch in range(200):
        if cache.should_attempt():
            for key in keys * 4:
                cache.get(key, (0,))
        if not cache.bypass_mode:
            recovered = True
            break
    assert recovered, cache.stats()


def test_adaptive_bypass_never_fires_during_warmup_misses():
    """Cold-start misses must not flip bypass before the window fills once."""
    cache = PrefixKVCache(pool_len=8, entry_bytes=1 << 10, budget_mb=64,
                          entry_shape=(2, 2, 8, 2, 4), dtype=jnp.float32,
                          adaptive=True, window=256, min_slots=0)
    for i in range(100):  # 100 < window: all misses, still warming
        assert cache.should_attempt() is True
        cache.get(("w", i), (i,))
    assert cache.bypass_mode is False


def test_auto_pool_len_sizes_from_corpus():
    """PREFIX_POOL_LEN unset → the engine sizes the pool from sampled 2-doc
    context prefixes (max, rounded to 128): long-doc corpora get a bigger
    pool than short-doc corpora, and an explicit setting wins."""
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((20, 64)).astype(np.float32)
    short_docs = [f"short doc {i}" for i in range(20)]
    long_docs = [f"long doc {i} " + " ".join(f"w{i}_{j}" for j in range(300))
                 for i in range(20)]

    def mk(docs, pool_len):
        s = Settings(model_preset="tiny", dtype="float32",
                     batch_buckets=[1, 2], encode_len_buckets=[16],
                     prompt_len_buckets=[64, 512], max_new_tokens=2,
                     max_batch_size=2, do_sample=False, prefix_cache=True,
                     prefix_pool_len=pool_len)
        return RagEngine(s, docs, emb)

    assert mk(short_docs, None).prefix_cache.pool_len == 128
    auto_long = mk(long_docs, None).prefix_cache.pool_len
    assert auto_long > 128
    assert mk(long_docs, 256).prefix_cache.pool_len == 256


def test_suffix_len_buckets_env_knob():
    """SUFFIX_LEN_BUCKETS is parsed/sorted from the env at import time; the
    default stays [32, 64] and pick_bucket routes a 20-token suffix to the
    tightest configured bucket."""
    from rag_serving_system.core import engine as eng

    assert eng.SUFFIX_LEN_BUCKETS == [32, 64]
    buckets = eng._parse_len_buckets("64,24,32")
    assert buckets == [24, 32, 64]
    assert eng.pick_bucket(buckets, 20) == 24
