"""Per-request generation budgets (request-level ``max_new_tokens``).

The reference decodes every request to a fixed ``max_new_tokens=10``
(rag_service/core/batch_processor.py:105) — there is no per-request control.
This framework adds it end-to-end: API field → queue payload → PromptSpec →
(a) the fixed path's ``row_budget`` (the while_loop early-exits at
max(batch budgets), so a batch of short budgets pays max, not the engine
cap) and (b) the decode pool's per-slot ``remaining`` counter (each slot
frees at ITS OWN budget — the workload continuous batching exists for).

Invariants pinned here:
- budgeted rows emit exactly the unbudgeted generation truncated to the
  budget (greedy) — the budget changes WHEN a row stops, never WHAT it says;
- a budget equal to the engine cap is bit-identical to no budget;
- both staging layouts (padded, packed) and both decode modes (fixed,
  continuous) honor budgets;
- the wire contracts (queue payload, HTTP JSON, native-front drain record)
  carry the field, omitting it when unset."""

import http.client
import json
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rag_serving_system.config import Settings
from rag_serving_system.core.engine import RagEngine
from rag_serving_system.core.request_queue import RequestQueue
from rag_serving_system.models.configs import decoder_config_for
from rag_serving_system.models.qwen2 import generate
from rag_serving_system.models.weights import init_decoder_params


def _left_pad(rows, p):
    b = len(rows)
    ids = np.zeros((b, p), np.int32)
    mask = np.zeros((b, p), np.int32)
    for i, r in enumerate(rows):
        ids[i, p - len(r):] = r
        mask[i, p - len(r):] = 1
    return jnp.asarray(ids), jnp.asarray(mask)


# ---------------------------------------------------------------------------
# model level: fixed path
# ---------------------------------------------------------------------------

def test_generate_row_budget_prefix_parity():
    """Each budgeted row emits the unbudgeted row's tokens truncated to its
    budget; rows past their budget emit only pad."""
    cfg = decoder_config_for("tiny")
    params = init_decoder_params(cfg, 0, jnp.float32)
    rng = jax.random.PRNGKey(7)
    p, mnt = 48, 8
    rows = [list(np.random.default_rng(i).integers(10, cfg.vocab_size, n))
            for i, n in enumerate([31, 12, 44, 20])]
    ids, mask = _left_pad(rows, p)
    rv = jnp.ones(4, bool)
    full = np.asarray(generate(params, cfg, ids, mask, rng,
                               max_new_tokens=mnt, do_sample=False,
                               dtype=jnp.float32, row_valid=rv))
    budgets = [3, 1, 8, 5]
    out = np.asarray(generate(params, cfg, ids, mask, rng,
                              max_new_tokens=mnt, do_sample=False,
                              dtype=jnp.float32, row_valid=rv,
                              row_budget=jnp.asarray(budgets, jnp.int32)))
    pad = cfg.pad_token_id
    for i, b in enumerate(budgets):
        want = [t for t in full[i][:b]]
        # the full row may itself have stopped early on EOS before b
        got = list(out[i][:b])
        assert got == want, (i, got, want)
        assert all(t == pad for t in out[i][b:]), (i, out[i])


def test_generate_full_budget_matches_unbudgeted():
    """budget == cap must be bit-identical to passing no budget (the always-
    staged budgets array cannot perturb default requests)."""
    cfg = decoder_config_for("tiny")
    params = init_decoder_params(cfg, 0, jnp.float32)
    rng = jax.random.PRNGKey(11)
    p, mnt = 32, 6
    rows = [list(np.random.default_rng(40 + i).integers(10, cfg.vocab_size, n))
            for i, n in enumerate([17, 29])]
    ids, mask = _left_pad(rows, p)
    rv = jnp.ones(2, bool)
    a = np.asarray(generate(params, cfg, ids, mask, rng, max_new_tokens=mnt,
                            do_sample=False, dtype=jnp.float32, row_valid=rv))
    b = np.asarray(generate(params, cfg, ids, mask, rng, max_new_tokens=mnt,
                            do_sample=False, dtype=jnp.float32, row_valid=rv,
                            row_budget=jnp.full((2,), mnt, jnp.int32)))
    assert (a == b).all()


# ---------------------------------------------------------------------------
# device level: decode pool per-slot budgets
# ---------------------------------------------------------------------------

def test_pool_slots_free_at_own_budget():
    """Slots inserted together with different budgets deactivate at their own
    step; each slot's tokens are the fixed path's truncated to its budget."""
    from tests.test_decode_pool import _Pool

    cfg = decoder_config_for("tiny")
    params = init_decoder_params(cfg, 0, jnp.float32)
    rng = jax.random.PRNGKey(3)
    p, mnt = 48, 8
    rows = [list(np.random.default_rng(9 + i).integers(10, cfg.vocab_size, n))
            for i, n in enumerate([25, 33, 14])]
    ids, mask = _left_pad(rows, p)
    full = np.asarray(generate(params, cfg, ids, mask, rng,
                               max_new_tokens=mnt, do_sample=False,
                               dtype=jnp.float32,
                               row_valid=jnp.ones(3, bool)))
    budgets = [2, 8, 4]
    pool = _Pool(cfg, params, slots=4, window=96, cursor=p)
    tok0 = pool.insert(ids, mask, [0, 1, 2], rng, mnt, budgets=budgets)
    toks = np.concatenate([pool.chunk(rng, 4), pool.chunk(rng, 4)], axis=0)
    pad = cfg.pad_token_id
    for i, b in enumerate(budgets):
        got = [int(tok0[i])] + [int(t) for t in toks[:, i]]
        got = [t for t in got if t != pad][:b]
        want = [int(t) for t in full[i][:b] if t != pad]
        assert got == want, (i, got, want)
    # the budget-2 slot must be inactive well before the budget-8 slot
    assert not bool(np.asarray(pool.active)[0])
    assert not bool(np.asarray(pool.active)[2])


# ---------------------------------------------------------------------------
# engine level: both staging layouts, both decode modes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    docs = [f"document {i} states fact number {i} about subject {i}"
            for i in range(16)]
    emb = np.random.default_rng(1).standard_normal((16, 64)).astype(np.float32)
    return docs, emb


def _disable_eos(eng):
    """Point the engine's EOS ids past the vocab so greedy decode can never
    stop early, and render EVERY emitted id in decode. The tiny random-init
    model's greedy argmax after a text prompt IS the EOS/special token, which
    the hash tokenizer's decode also drops — together they would make every
    budget assertion vacuously compare empty strings ('' == ''). With EOS
    unreachable the decode runs to exactly the budget, and the raw-id decode
    makes answer LENGTH visible, so budget effects genuinely assert."""
    import dataclasses
    import types

    from rag_serving_system.models.qwen2 import eos_id_set

    v = eng.dec_cfg.vocab_size
    eng.dec_cfg = dataclasses.replace(eng.dec_cfg, eos_token_id=v + 7,
                                      eos_token_ids=(v + 7,))
    pool = getattr(eng, "decode_pool", None)
    if pool is not None:   # the pool snapshots cfg/eos at construction
        pool.cfg = eng.dec_cfg
        pool.eos_ids = eos_id_set(eng.dec_cfg)
    eng.dec_tok.decode = types.MethodType(
        lambda self, ids: " ".join(f"<{int(i)}>" for i in ids), eng.dec_tok)
    return eng


def _engine(corpus, **kw):
    docs, emb = corpus
    defaults = dict(model_preset="tiny", batch_buckets=[4], max_batch_size=4,
                    encode_len_buckets=[16], prompt_len_buckets=[64, 128],
                    max_new_tokens=6, do_sample=False, prefix_cache=False,
                    packed_prefill=False, decode_mode="fixed", dtype="float32",
                    query_cache_size=0)
    defaults.update(kw)
    return _disable_eos(RagEngine(Settings(**defaults), docs, emb))


QS = ["what does document 3 say?", "tell me about subject 7",
      "document 11 states what?"]


def test_engine_budget_equals_smaller_cap(corpus):
    """process(budgets=[b]*n) on a cap-6 engine == process() on a cap-b
    engine: the budget is exactly 'this request's own max_new_tokens'."""
    eng6 = _engine(corpus)
    eng2 = _engine(corpus, max_new_tokens=2)
    got = eng6.process(QS, [2] * 3, budgets=[2, 2, 2])
    want = eng2.process(QS, [2] * 3)
    assert got == want, (got, want)
    # non-vacuous: answers exist and the budget genuinely shortened them
    full = eng6.process(QS, [2] * 3)
    assert all(r["result"] for r in full)
    assert got != full, "budget had no observable effect"
    # mixed budgets: each row equals the matching-cap engine's answer
    mixed = eng6.process(QS, [2] * 3, budgets=[2, None, 6])
    assert mixed[0] == want[0]
    assert mixed[1] == full[1] and mixed[2] == full[2]


def test_engine_budget_packed_staging(corpus):
    """Budgets ride the packed (ragged) prefill layout too."""
    import rag_serving_system.core.engine as eng_mod

    eng6 = _engine(corpus, packed_prefill=True)
    eng2 = _engine(corpus, packed_prefill=True, max_new_tokens=2)
    old = eng_mod.PACKED_MARGIN
    try:
        eng_mod.PACKED_MARGIN = 10.0   # force the packed trace
        got = eng6.process(QS, [2] * 3, budgets=[2, 2, 2])
        want = eng2.process(QS, [2] * 3)
    finally:
        eng_mod.PACKED_MARGIN = old
    assert got == want, (got, want)
    assert all(r["result"] for r in got)   # non-vacuous


def test_engine_budget_continuous_pool(corpus):
    """The decode pool honors per-request budgets per SLOT: one submit with
    mixed budgets delivers each request at its own length."""
    eng_c = _engine(corpus, decode_mode="continuous")
    eng2 = _engine(corpus, max_new_tokens=2)
    eng6 = _engine(corpus)
    pool = eng_c.decode_pool
    pool.start()
    try:
        results = {}
        prompts = eng_c.prepare(QS, [2] * 3, budgets=[2, None, 2])
        pool.submit(["a", "b", "c"], prompts,
                    lambda rid, res: results.__setitem__(rid, res))
        assert pool.wait_idle(120.0)
        want2 = eng2.process(QS, [2] * 3)
        want6 = eng6.process(QS, [2] * 3)
        assert results["a"] == want2[0], (results["a"], want2[0])
        assert results["b"] == want6[1], (results["b"], want6[1])
        assert results["c"] == want2[2], (results["c"], want2[2])
        # non-vacuous: the full-budget row is strictly longer
        assert results["b"]["result"]
        assert len(results["b"]["result"]) > len(results["a"]["result"])
    finally:
        pool.stop()


def test_budget_clamped_to_engine_cap(corpus):
    """A budget above the cap clamps to the cap (the compiled decode length
    is the ceiling); 0/negative clamp to 1."""
    eng = _engine(corpus)
    full = eng.process(QS[:1], [2])
    assert full[0]["result"]   # non-vacuous
    over = eng.process(QS[:1], [2], budgets=[999])
    assert over == full
    one = eng.process(QS[:1], [2], budgets=[0])
    one_ref = _engine(corpus, max_new_tokens=1).process(QS[:1], [2])
    assert one == one_ref and one != full


# ---------------------------------------------------------------------------
# wire contracts
# ---------------------------------------------------------------------------

def test_queue_payload_carries_optional_budget():
    q = RequestQueue(max_batch_size=4, max_wait_time=0.01)
    q.add_request("plain", 2)
    q.add_request("budgeted", 2, max_new_tokens=5)
    batch = q.get_batch()
    assert "max_new_tokens" not in batch[0]   # default contract unchanged
    assert batch[1]["max_new_tokens"] == 5


def test_api_accepts_and_validates_budget(corpus):
    from rag_serving_system.api.endpoints import create_api, ServerThread
    from rag_serving_system.core.batch_processor import BatchProcessor
    import requests as rq

    eng6 = _engine(corpus)
    queue = RequestQueue(max_batch_size=4, max_wait_time=0.05)
    bp = BatchProcessor(queue, eng6, polling_interval=0.02)
    bp.start()
    server = ServerThread(create_api(queue, bp)).start()
    try:
        url = server.url
        r = rq.post(url + "/rag?wait=30",
                    json={"query": QS[0], "k": 2, "max_new_tokens": 2},
                    timeout=60)
        assert r.status_code == 200 and r.json()["status"] == "complete"
        want = _engine(corpus, max_new_tokens=2).process(QS[:1], [2])[0]
        assert r.json()["result"] == want   # the stored {"result": ans} dict
        assert want["result"]               # non-vacuous
        # pydantic bounds: 0 is rejected before the queue
        bad = rq.post(url + "/rag", json={"query": "x", "max_new_tokens": 0},
                      timeout=30)
        assert bad.status_code == 422
        # omitted field keeps the engine default
        r2 = rq.post(url + "/rag?wait=30", json={"query": QS[0], "k": 2},
                     timeout=60)
        want_full = eng6.process(QS[:1], [2])[0]
        assert r2.json()["result"] == want_full
    finally:
        bp.stop(drain_timeout=5.0)
        server.stop()


def test_native_front_drain_carries_budget():
    """The C front parses max_new_tokens and the drain record delivers it
    (0 = unset → None)."""
    from rag_serving_system.native import get_httpfront_lib

    if get_httpfront_lib() is None:
        pytest.skip("no C++ toolchain for the native front")
    from rag_serving_system.api.native_front import NativeFront, FrontQueue

    inner = RequestQueue(max_batch_size=8, max_wait_time=0.02)
    nf = NativeFront(inner, port=0).start()
    q = FrontQueue(inner, nf)
    seen = {}

    def echo_loop():
        deadline = time.time() + 10
        while len(seen) < 3 and time.time() < deadline:
            for item in q.get_batch():
                seen[item["query"]] = item.get("max_new_tokens")
                q.store_result(item["id"], {"result": "ok"})

    t = threading.Thread(target=echo_loop, daemon=True)
    t.start()
    try:
        c = http.client.HTTPConnection("127.0.0.1", nf.port, timeout=10)
        for body in ({"query": "a", "max_new_tokens": 7},
                     {"query": "b"},
                     {"query": "c", "max_new_tokens": None}):
            payload = json.dumps(body)
            c.request("POST", "/rag?wait=5", body=payload,
                      headers={"Content-Type": "application/json",
                               "Content-Length": str(len(payload))})
            r = c.getresponse()
            assert r.status == 200, r.read()
            r.read()
        t.join(timeout=10)
        assert seen == {"a": 7, "b": None, "c": None}, seen
        # out-of-range budget is a 422 at the C parser, like pydantic
        bad = json.dumps({"query": "x", "max_new_tokens": 0})
        c.request("POST", "/rag", body=bad,
                  headers={"Content-Type": "application/json",
                           "Content-Length": str(len(bad))})
        r = c.getresponse()
        assert r.status == 422, r.read()
        r.read()
        c.close()
    finally:
        nf.stop()


def test_budget_aware_regrouping_partitions_by_budget():
    """When the two-batch window regroups, budgets sort FIRST: short-budget
    requests land in the same batch (the fixed decode pays max(batch
    budgets) per batch, so mixing a budget-64 row into a budget-8 batch
    costs the whole batch 56 extra steps). Every request still gets its own
    answer, and with uniform budgets the key reduces to the length sort."""
    from rag_serving_system.core.batch_processor import BatchProcessor
    from rag_serving_system.core.prefix_cache import PromptSpec

    groups: list = []

    class _Stub:
        class settings:
            max_new_tokens = 64

        def prepare(self, queries, ks, budgets=None):
            budgets = budgets or [None] * len(queries)
            return [PromptSpec(f"P:{q}", gen_budget=b)
                    for q, b in zip(queries, budgets)]

        def generate_tokens(self, prompts, staged=None):
            groups.append([p.gen_budget for p in prompts])
            return list(prompts)

        def finalize_tokens(self, handle):
            return [f"ans:{p}" for p in handle]

        def generate_answers(self, prompts):
            return self.finalize_tokens(self.generate_tokens(prompts))

    q = RequestQueue(max_batch_size=4, max_wait_time=0.05,
                     polling_interval=0.01)
    # a full two-batch window of interleaved budgets: FIFO slices would mix
    # 2s and 60s in both batches; budget-aware regrouping separates them
    budgets = [2, 60, 2, 60, 2, 60, 2, 60]
    rids = [q.add_request(f"query number {i}", 1, max_new_tokens=b)
            for i, b in enumerate(budgets)]
    bp = BatchProcessor(q, _Stub(), polling_interval=0.01)
    bp.start()
    try:
        for i, rid in enumerate(rids):
            res = q.get_result(rid, timeout=10)
            assert res is not None
            assert res["result"] == f"ans:P:query number {i}"
    finally:
        bp.stop()
    two_batch = [g for g in groups if len(g) == 4]
    assert any(set(g) == {2} for g in two_batch), groups
    assert any(set(g) == {60} for g in two_batch), groups


def test_pool_occupancy_stats(corpus):
    """tokens_emitted counts DECODE-step tokens only (each request's tok0
    is sampled by the prefill dispatch and lands in tokens_prefill), so
    occupancy's numerator matches its slot-step denominator; the two
    counters together equal the sum of budgets."""
    eng = _engine(corpus, decode_mode="continuous")
    pool = eng.decode_pool
    pool.start()
    try:
        results = {}
        prompts = eng.prepare(QS, [2] * 3, budgets=[1, 6, 3])
        pool.submit(["a", "b", "c"], prompts,
                    lambda rid, res: results.__setitem__(rid, res))
        assert pool.wait_idle(120.0)
        st = pool.stats()
        assert st["tokens_prefill"] == 3, st           # one tok0 per request
        assert st["tokens_emitted"] == (1 - 1) + (6 - 1) + (3 - 1), st
        assert st["tokens_emitted"] + st["tokens_prefill"] == 1 + 6 + 3
        assert st["completed"] == 3
        assert 0 < st["occupancy"] <= 1.0
    finally:
        pool.stop()


def test_pool_window_gate_uses_batch_budget(corpus):
    """The ring-overflow fallback gates on the BATCH's max budget, not the
    engine cap: a window that can't hold prompt+cap but CAN hold
    prompt+max(batch budgets) must stay on the pool path (review finding,
    round 4). Pad rows carry the cap but are born done, so they don't
    count either."""
    # plen bucket 64; cap 6; window 68: 64+6 > 68 (old gate falls back)
    # but 64+2 <= 68 (batch budget fits the per-slot ring invariant)
    eng = _engine(corpus, decode_mode="continuous", decode_window=68,
                  decode_slots=8)
    pool = eng.decode_pool
    fallbacks = []
    orig = eng.generate_tokens
    eng.generate_tokens = lambda *a, **k: (fallbacks.append(1),
                                           orig(*a, **k))[1]
    pool.start()
    try:
        results = {}
        prompts = eng.prepare(QS, [2] * 3, budgets=[2, 2, 2])
        pool.submit(["a", "b", "c"], prompts,
                    lambda rid, res: results.__setitem__(rid, res))
        assert pool.wait_idle(120.0)
        assert not fallbacks, "batch-budget-fitting batch took fixed fallback"
        want = _engine(corpus, max_new_tokens=2).process(QS, [2] * 3)
        assert [results[r]["result"] for r in "abc"] == \
            [w["result"] for w in want]
        # and a batch whose budget genuinely overflows DOES fall back
        prompts6 = eng.prepare(QS, [2] * 3, budgets=[6, 2, 2])
        pool.submit(["d", "e", "f"], prompts6,
                    lambda rid, res: results.__setitem__(rid, res))
        assert pool.wait_idle(120.0)
        assert fallbacks, "overflowing batch must take the fixed fallback"
        assert all(r in results for r in "def")
    finally:
        pool.stop()
