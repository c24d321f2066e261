"""Continuous (in-flight) batching tests: the ring-buffer decode pool
(core/decode_pool.py + models/qwen2.py decode_chunk) must produce the SAME
tokens as the fixed-scan `generate` under greedy decode — for aligned
inserts, for wrap-around ring layouts, and for requests inserted mid-flight
next to unrelated in-progress slots (row isolation). Then the host
orchestrator end-to-end: per-request delivery, slot starvation/reuse, the
window-overflow fallback, and prefix-cache interplay.

Reference has no equivalent feature (its HF pipeline decodes fixed batches:
rag_service/core/batch_processor.py:104-105); parity target is our own
fixed path, which is itself reference-parity-tested."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rag_serving_system.config import Settings
from rag_serving_system.core.decode_pool import DecodePool, _insert_rows
from rag_serving_system.core.engine import RagEngine
from rag_serving_system.models.configs import decoder_config_for
from rag_serving_system.models.qwen2 import (decode_chunk, eos_id_set,
                                             generate, prefill_for_pool)
from rag_serving_system.models.weights import init_decoder_params


def _left_pad(rows, p):
    b = len(rows)
    ids = np.zeros((b, p), np.int32)
    mask = np.zeros((b, p), np.int32)
    for i, r in enumerate(rows):
        ids[i, p - len(r):] = r
        mask[i, p - len(r):] = 1
    return jnp.asarray(ids), jnp.asarray(mask)


class _Pool:
    """Minimal host mirror of DecodePool's device state for device-level
    tests (no threads): insert rows, run chunks, collect per-slot tokens."""

    def __init__(self, cfg, params, slots, window, dtype=jnp.float32,
                 cursor=0):
        self.cfg, self.params, self.dtype = cfg, params, dtype
        shape = (cfg.num_layers, slots, window, cfg.num_kv_heads,
                 cfg.head_dim)
        self.k = jnp.zeros(shape, dtype)
        self.v = jnp.zeros(shape, dtype)
        self.valid = jnp.zeros((slots, window), bool)
        self.last = jnp.full((slots,), cfg.pad_token_id, jnp.int32)
        self.pos = jnp.zeros((slots,), jnp.int32)
        self.active = jnp.zeros((slots,), bool)
        self.rem = jnp.zeros((slots,), jnp.int32)
        self.cursor = jnp.int32(cursor)
        self.eos = eos_id_set(cfg)

    def insert(self, ids, mask, slot_ids, rng, mnt, budgets=None):
        b = ids.shape[0]
        if budgets is None:
            budgets = [mnt] * b
        tok0, k, v, cmask = prefill_for_pool(
            self.params, self.cfg, ids, mask, rng, do_sample=False,
            dtype=self.dtype, row_valid=jnp.ones(b, bool))
        (self.k, self.v, self.valid, self.last, self.pos, self.active,
         self.rem) = _insert_rows(
            self.k, self.v, self.valid, self.last, self.pos, self.active,
            self.rem, k, v, cmask, tok0,
            jnp.asarray(slot_ids, jnp.int32), self.cursor,
            jnp.ones(b, bool), jnp.asarray(budgets, jnp.int32), self.eos)
        return np.asarray(tok0)

    def chunk(self, rng, n):
        (self.k, self.v, self.valid, self.last, self.pos, self.active,
         self.rem, self.cursor, toks) = decode_chunk(
            self.params, self.cfg, self.k, self.v, self.valid, self.last,
            self.pos, self.active, self.rem, self.cursor, rng, chunk=n,
            do_sample=False, dtype=self.dtype)
        return np.asarray(toks)      # (n, S)


def _strip(row, pad_id):
    return [int(t) for t in row if t != pad_id]


def test_pool_matches_generate_greedy_aligned():
    """Aligned insert (cursor == prompt bucket): ring layout matches the
    fixed cache layout exactly — token-for-token greedy parity."""
    cfg = decoder_config_for("tiny")
    params = init_decoder_params(cfg, 0, jnp.float32)
    rng = jax.random.PRNGKey(3)
    p, mnt = 64, 6
    lens = [37, 12, 55, 23]
    rows = [list(np.random.default_rng(i).integers(10, cfg.vocab_size, n))
            for i, n in enumerate(lens)]
    ids, mask = _left_pad(rows, p)
    fixed = np.asarray(generate(params, cfg, ids, mask, rng,
                                max_new_tokens=mnt, do_sample=False,
                                dtype=jnp.float32,
                                row_valid=jnp.ones(4, bool)))
    pool = _Pool(cfg, params, slots=8, window=128, cursor=p)
    tok0 = pool.insert(ids, mask, [0, 1, 2, 3], rng, mnt)
    toks = np.concatenate([pool.chunk(rng, 3), pool.chunk(rng, 3)], axis=0)
    for i in range(4):
        got = [int(tok0[i])] + [int(t) for t in toks[:, i]]
        got = _strip(got, cfg.pad_token_id)[:mnt]
        want = _strip(fixed[i], cfg.pad_token_id)
        assert got == want, (i, got, want)


def test_pool_matches_generate_greedy_wrapped():
    """Wrap-around insert (cursor=0 → prompt occupies the ring tail, decode
    wraps through column 0): attention is key-order invariant, so tokens
    still match the fixed path."""
    cfg = decoder_config_for("tiny")
    params = init_decoder_params(cfg, 0, jnp.float32)
    rng = jax.random.PRNGKey(5)
    p, mnt = 64, 5
    rows = [list(np.random.default_rng(7 + i).integers(10, cfg.vocab_size, n))
            for i, n in enumerate([29, 61])]
    ids, mask = _left_pad(rows, p)
    fixed = np.asarray(generate(params, cfg, ids, mask, rng,
                                max_new_tokens=mnt, do_sample=False,
                                dtype=jnp.float32,
                                row_valid=jnp.ones(2, bool)))
    pool = _Pool(cfg, params, slots=4, window=96, cursor=0)
    tok0 = pool.insert(ids, mask, [2, 0], rng, mnt)
    toks = pool.chunk(rng, mnt - 1)
    for i, s in enumerate([2, 0]):
        got = _strip([int(tok0[i])] + [int(t) for t in toks[:, s]],
                     cfg.pad_token_id)[:mnt]
        want = _strip(fixed[i], cfg.pad_token_id)
        assert got == want, (i, got, want)


def test_pool_mid_flight_insert_isolated():
    """A request inserted while another is mid-decode must not perturb
    either: both match their isolated fixed-path generations."""
    cfg = decoder_config_for("tiny")
    params = init_decoder_params(cfg, 0, jnp.float32)
    rng = jax.random.PRNGKey(11)
    p, mnt = 64, 6
    row_a = list(np.random.default_rng(1).integers(10, cfg.vocab_size, 40))
    row_b = list(np.random.default_rng(2).integers(10, cfg.vocab_size, 17))
    ids_a, mask_a = _left_pad([row_a], p)
    ids_b, mask_b = _left_pad([row_b], p)
    want = {}
    for name, ids, mask in (("a", ids_a, mask_a), ("b", ids_b, mask_b)):
        out = np.asarray(generate(params, cfg, ids, mask, rng,
                                  max_new_tokens=mnt, do_sample=False,
                                  dtype=jnp.float32,
                                  row_valid=jnp.ones(1, bool)))
        want[name] = _strip(out[0], cfg.pad_token_id)
    pool = _Pool(cfg, params, slots=4, window=160, cursor=p)
    t0a = pool.insert(ids_a, mask_a, [1], rng, mnt)
    toks1 = pool.chunk(rng, 2)          # A decodes 2 tokens alone
    t0b = pool.insert(ids_b, mask_b, [3], rng, mnt)   # B joins mid-flight
    toks2 = pool.chunk(rng, mnt - 1)
    got_a = _strip([int(t0a[0])] + [int(t) for t in toks1[:, 1]]
                   + [int(t) for t in toks2[:, 1]], cfg.pad_token_id)[:mnt]
    got_b = _strip([int(t0b[0])] + [int(t) for t in toks2[:, 3]],
                   cfg.pad_token_id)[:mnt]
    assert got_a == want["a"], (got_a, want["a"])
    assert got_b == want["b"], (got_b, want["b"])


# ---------------------------------------------------------------------------
# host orchestrator end-to-end (RagEngine + DecodePool)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    docs = [f"document {i} states fact number {i} about subject {i} "
            f"{'with extra detail ' * (i % 7)}" for i in range(24)]
    emb = np.random.default_rng(0).standard_normal((24, 64)).astype(np.float32)
    return docs, emb


def _engine(corpus, mode, **kw):
    docs, emb = corpus
    defaults = dict(model_preset="tiny", batch_buckets=[4], max_batch_size=4,
                    encode_len_buckets=[16], prompt_len_buckets=[64, 128],
                    max_new_tokens=4, do_sample=False, prefix_cache=False,
                    packed_prefill=False, decode_mode=mode, dtype="float32",
                    query_cache_size=0)
    defaults.update(kw)
    return RagEngine(Settings(**defaults), docs, emb)


def _run_pool(eng, qs, ks, timeout=120.0):
    pool = eng.decode_pool
    if not pool._running:
        pool.start()
    results = {}
    prompts = eng.prepare(qs, ks)
    rids = [f"r{i}" for i in range(len(qs))]
    pool.submit(rids, prompts, lambda rid, res: results.__setitem__(rid, res))
    assert pool.wait_idle(timeout)
    assert set(results) == set(rids), (set(results), set(rids))
    return [results[r] for r in rids]


QS = ["document 3 states fact number 3",
      "document 11 states fact number 11 about subject 11",
      "what does document 7 say?",
      "tell me about subject 19"]


def test_pool_end_to_end_matches_fixed(corpus):
    eng_c = _engine(corpus, "continuous")
    eng_f = _engine(corpus, "fixed")
    assert eng_c.decode_pool is not None and eng_f.decode_pool is None
    for n in (4, 2):
        got = _run_pool(eng_c, QS[:n], [2] * n)
        want = eng_f.process(QS[:n], [2] * n)
        assert got == want, (n, got, want)
    eng_c.decode_pool.stop()


def test_pool_slot_starvation_and_reuse(corpus):
    """More concurrent requests than slots: FIFO head waits for completions,
    slots recycle, every request still delivers the fixed-path answer."""
    eng_c = _engine(corpus, "continuous", decode_slots=4)
    eng_f = _engine(corpus, "fixed")
    pool = eng_c.decode_pool
    assert pool.slots == 4
    pool.start()
    results = {}
    rids = []
    for wave in range(3):
        qs = [QS[(wave + i) % 4] for i in range(4)]
        prompts = eng_c.prepare(qs, [2] * 4)
        w_ids = [f"w{wave}_{i}" for i in range(4)]
        rids.extend(zip(w_ids, qs))
        pool.submit(w_ids, prompts,
                    lambda rid, res: results.__setitem__(rid, res))
    assert pool.wait_idle(180.0)
    assert pool.completed >= 12
    for rid, q in rids:
        want = eng_f.process([q], [2])[0]
        assert results[rid] == want, (rid, results[rid], want)
    pool.stop()


def test_pool_wave_insert_smaller_than_batch(corpus):
    """A pool SMALLER than the batch bucket: rows enter in waves as slots
    free (drop-mode scatter), so a 4-row batch decodes on 2 slots — the
    configuration batch-granular insert could never serve (it would wait
    forever for 4 free slots). Greedy answers still match the fixed path
    row-for-row, and a second submission queued behind it completes too."""
    eng_c = _engine(corpus, "continuous", decode_slots=2)
    eng_f = _engine(corpus, "fixed")
    pool = eng_c.decode_pool
    assert pool.slots == 2
    pool.start()
    results = {}
    p1 = eng_c.prepare(QS, [2] * 4)
    p2 = eng_c.prepare(QS[:2], [2] * 2)
    pool.submit([f"a{i}" for i in range(4)], p1,
                lambda rid, res: results.__setitem__(rid, res))
    pool.submit(["b0", "b1"], p2,
                lambda rid, res: results.__setitem__(rid, res))
    assert pool.wait_idle(180.0)
    want4 = eng_f.process(QS, [2] * 4)
    want2 = eng_f.process(QS[:2], [2] * 2)
    assert [results[f"a{i}"] for i in range(4)] == want4
    assert [results[f"b{i}"] for i in range(2)] == want2
    assert pool.inserted == 6 and pool.completed == 6
    pool.stop()


def test_pool_window_overflow_falls_back_to_fixed(corpus):
    """A staged bucket that cannot fit the ring (T + mnt > window) must run
    the fixed path transparently and still deliver correct results."""
    eng_c = _engine(corpus, "continuous", decode_window=64,
                    prompt_len_buckets=[64, 128])
    eng_f = _engine(corpus, "fixed", prompt_len_buckets=[64, 128])
    long_q = "filler word " * 40 + "what does document 5 say?"
    got = _run_pool(eng_c, [long_q], [2])
    want = eng_f.process([long_q], [2])
    assert got == want
    eng_c.decode_pool.stop()


def test_pool_with_prefix_cache_matches_fixed(corpus):
    """Prefix-KV staged batches insert [prefix | suffix] KV rows; answers
    match the fixed path's prefix-cache answers (both exact)."""
    eng_c = _engine(corpus, "continuous", prefix_cache=True,
                    prefix_pool_len=128, decode_window=256)
    eng_f = _engine(corpus, "fixed", prefix_cache=True, prefix_pool_len=128)
    for _ in range(2):   # second pass = prefix-cache hits
        got = _run_pool(eng_c, QS, [2] * 4)
        want = eng_f.process(QS, [2] * 4)
        assert got == want
    eng_c.decode_pool.stop()


def test_pool_packed_staging_matches_fixed(corpus):
    """Packed (ragged) prefill feeding the pool: same answers as fixed."""
    eng_c = _engine(corpus, "continuous", packed_prefill=True)
    eng_f = _engine(corpus, "fixed", packed_prefill=False)
    import rag_serving_system.core.engine as eng_mod
    old = eng_mod.PACKED_MARGIN
    try:
        eng_mod.PACKED_MARGIN = 10.0   # force the packed trace
        got = _run_pool(eng_c, QS[:3], [2] * 3)
    finally:
        eng_mod.PACKED_MARGIN = old
    want = eng_f.process(QS[:3], [2] * 3)
    assert got == want
    eng_c.decode_pool.stop()


def test_pool_sharded_over_mesh_matches_fixed(corpus):
    """Continuous mode under a dp×tp mesh: the pool's slot axis shards over
    "data"; greedy answers must match the single-device fixed path."""
    from rag_serving_system.parallel.mesh import make_mesh

    docs, emb = corpus
    assert len(jax.devices()) == 8
    s = Settings(model_preset="tiny", dtype="float32", batch_buckets=[4],
                 max_batch_size=4, encode_len_buckets=[16],
                 prompt_len_buckets=[64, 128], max_new_tokens=4,
                 do_sample=False, prefix_cache=False, packed_prefill=False,
                 decode_mode="continuous", decode_slots=8,
                 query_cache_size=0, mesh_shape="4,2")
    eng_c = RagEngine(s, docs, emb, mesh=make_mesh("4,2"))
    assert eng_c.decode_pool is not None
    eng_f = _engine(corpus, "fixed")
    got = _run_pool(eng_c, QS, [2] * 4, timeout=240.0)
    want = eng_f.process(QS, [2] * 4)
    assert got == want, (got, want)
    eng_c.decode_pool.stop()


def test_pool_through_batch_processor(corpus):
    """BatchProcessor routes stage-2 to the pool in continuous mode; results
    land in the request queue per request."""
    from rag_serving_system.core.batch_processor import BatchProcessor
    from rag_serving_system.core.request_queue import RequestQueue

    eng = _engine(corpus, "continuous")
    q = RequestQueue(max_batch_size=4, max_wait_time=0.05)
    bp = BatchProcessor(q, eng, polling_interval=0.02)
    bp.start()
    try:
        rids = [q.add_request(QS[i % 4], k=2) for i in range(6)]
        results = {rid: q.get_result(rid, timeout=120) for rid in rids}
        assert all(r is not None for r in results.values()), results
        eng_f = _engine(corpus, "fixed")
        for i, rid in enumerate(rids):
            want = eng_f.process([QS[i % 4]], [2])[0]
            assert results[rid] == want
    finally:
        bp.stop(drain_timeout=5.0)
