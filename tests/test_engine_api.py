"""Integration tests: RagEngine pipeline + HTTP surface (tiny models, CPU).

Plays the role the reference delegates entirely to live load-testing
(SURVEY §4): here the full queue→processor→engine→result loop runs in-process
behind a live asyncio HTTP server."""

import time

import numpy as np
import pytest
import requests

from rag_serving_system.config import Settings
from rag_serving_system.core.engine import RagEngine, pick_bucket
from rag_serving_system.core.batch_processor import BatchProcessor
from rag_serving_system.core.request_queue import RequestQueue
from rag_serving_system.api.endpoints import create_api, ServerThread


class _Client:
    """requests-backed client against a live HTTP server."""

    def __init__(self, base_url):
        self.base = base_url

    def get(self, path):
        return requests.get(self.base + path, timeout=30)

    def post(self, path, json=None):
        return requests.post(self.base + path, json=json, timeout=30)


def tiny_settings(**over):
    base = dict(model_preset="tiny", dtype="float32",
                batch_buckets=[1, 2, 4, 8],
                encode_len_buckets=[16, 32],
                prompt_len_buckets=[64, 128],
                max_new_tokens=4, max_k=4,
                max_batch_size=4, max_wait_time=0.2, polling_interval=0.05)
    base.update(over)
    return Settings(**base)


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(0)
    docs = [f"Fact {i}: the answer to question {i} is {i * i}." for i in range(30)]
    emb = rng.standard_normal((30, 64)).astype(np.float32)
    return RagEngine(tiny_settings(), docs, emb)


def test_pick_bucket():
    assert pick_bucket([1, 2, 4, 8], 3) == 4
    assert pick_bucket([1, 2, 4, 8], 8) == 8
    assert pick_bucket([1, 2, 4, 8], 9) == 8  # clamps to largest


def test_engine_process_end_to_end(engine):
    results = engine.process(["what is two plus two?", "who wrote hamlet?"], [2, 3])
    assert len(results) == 2
    for r in results:
        assert "result" in r and isinstance(r["result"], str)


def test_engine_variable_k(engine):
    idx = engine.embed_and_retrieve(["q1", "q2", "q3"], [1, 2, 4])
    assert [len(row) for row in idx] == [1, 2, 4]
    assert all(0 <= i < 30 for row in idx for i in row)


def test_engine_huge_k_is_clamped_not_compiled(engine):
    """k beyond max_k must clamp (single compiled shape), never trigger an
    attacker-controlled recompile with a k-times-unrolled merge loop."""
    idx = engine.embed_and_retrieve(["q"], [10_000_000])
    assert len(idx[0]) == engine.max_k


def test_prompt_truncation_keeps_tail():
    """Over-long prompts must keep the question/answer cue at the END."""
    from rag_serving_system.models.tokenizer import HashTokenizer, pad_and_stack

    tok = HashTokenizer(1000)
    long_prompt = ("filler " * 100) + "QUESTION_MARKER"
    rows = [tok.encode(long_prompt)]
    ids, mask = pad_and_stack(rows, 16, tok.pad_id, pad_side="left",
                              truncate_side="left")
    marker_id = tok._tok2id("QUESTION_MARKER")
    assert marker_id in ids[0], "tail (question) was truncated away"


def test_engine_empty_batch(engine):
    assert engine.process([], []) == []


def test_engine_oversize_batch_pads_to_largest_bucket(engine):
    # 9 queries > largest bucket 8: engine must still answer all 9
    queries = [f"query number {i}" for i in range(9)]
    results = engine.process(queries, [1] * 9)
    assert len(results) == 9


@pytest.fixture(scope="module")
def serving_stack(engine):
    queue = RequestQueue(max_batch_size=4, max_wait_time=0.2, polling_interval=0.02)
    processor = BatchProcessor(queue, engine, polling_interval=0.02)
    processor.start()
    app = create_api(queue, processor)
    server = ServerThread(app).start()
    client = _Client(server.url)
    yield client, queue, processor
    processor.stop()
    server.stop()


def test_api_health(serving_stack):
    client, _, _ = serving_stack
    assert client.get("/health").json() == {"status": "healthy"}


def test_api_full_request_cycle(serving_stack):
    client, _, _ = serving_stack
    resp = client.post("/rag", json={"query": "what is the speed of light?", "k": 2})
    assert resp.status_code == 200
    body = resp.json()
    assert body["status"] == "processing"
    rid = body["request_id"]

    deadline = time.time() + 60
    result = None
    while time.time() < deadline:
        r = client.get(f"/rag/result/{rid}").json()
        if r["status"] == "complete":
            result = r["result"]
            break
        time.sleep(0.05)
    assert result is not None, "request never completed"
    assert "result" in result

    # consume-once: a second poll reports processing again (reference semantics,
    # request_queue.py:132)
    assert client.get(f"/rag/result/{rid}").json() == {"status": "processing"}


def test_api_default_k(serving_stack):
    client, _, _ = serving_stack
    resp = client.post("/rag", json={"query": "no k supplied"})
    assert resp.status_code == 200


def test_api_rejects_malformed_body(serving_stack):
    client, _, _ = serving_stack
    assert client.post("/rag", json={"k": 2}).status_code == 422
    assert client.post("/rag", json={"query": "x", "k": "lots"}).status_code == 422


def test_api_stats_endpoint(serving_stack):
    client, _, _ = serving_stack
    body = client.get("/stats").json()
    assert "queue_size" in body and "batches_processed" in body


def test_api_backpressure_503():
    """POST /rag must shed load with 503 once the queue is full."""
    queue = RequestQueue(max_batch_size=4, max_wait_time=0.2)
    # no processor draining — the queue just fills
    app = create_api(queue, max_queue_size=3)
    server = ServerThread(app).start()
    try:
        client = _Client(server.url)
        codes = [client.post("/rag", json={"query": f"q{i}"}).status_code
                 for i in range(5)]
        assert codes[:3] == [200, 200, 200]
        assert codes[3] == 503 and codes[4] == 503
        # metrics reflect the rejections
        assert "rag_requests_rejected_total 2.0" in client.get("/metrics").text
    finally:
        server.stop()


def test_api_metrics_registered(serving_stack):
    """The reference's /metrics was dead code (endpoints.py:47 missing @);
    ours must actually serve Prometheus text."""
    client, _, _ = serving_stack
    resp = client.get("/metrics")
    assert resp.status_code == 200
    assert "rag_queue_size" in resp.text
    assert "rag_queue_wait_time" in resp.text


def test_failed_batch_fans_out_errors(engine):
    """Engine failure must store an error result for every request in the
    batch (reference bp.py:118-125)."""
    queue = RequestQueue(max_batch_size=4, max_wait_time=0.1)

    class BrokenEngine:
        def prepare(self, queries, ks, budgets=None):
            raise RuntimeError("boom")

        def generate_answers(self, prompts):
            raise RuntimeError("boom")

        def process(self, queries, ks):
            raise RuntimeError("boom")

    proc = BatchProcessor(queue, BrokenEngine(), polling_interval=0.02)
    proc.start()
    rid = queue.add_request("will fail", 2)
    res = queue.get_result(rid, timeout=10)
    proc.stop()
    assert res is not None
    assert res["status"] == "failed" and "boom" in res["error"]


def test_batch_buckets_cover_max_batch_size():
    """MAX_BATCH_SIZE beyond the largest bucket must be auto-covered so the
    engine never runs unbucketed shapes (one XLA compile per distinct size)."""
    from rag_serving_system.core.engine import _batch_buckets, pick_bucket
    from rag_serving_system.config import Settings

    s = Settings(model_preset="tiny", batch_buckets=[1, 4], max_batch_size=9)
    buckets = _batch_buckets(s)
    assert buckets[-1] == 9
    assert pick_bucket(buckets, 7) == 9
    s2 = Settings(model_preset="tiny", batch_buckets=[1, 4, 8], max_batch_size=8)
    assert _batch_buckets(s2) == [1, 4, 8]


class _StubEngine:
    """Minimal engine double: prompt = query text, answer = f(prompt)."""

    def prepare(self, queries, ks, budgets=None):
        return [f"P:{q}" for q in queries]

    def generate_tokens(self, prompts, staged=None):
        return list(prompts)

    def finalize_tokens(self, handle):
        return [f"ans:{p}" for p in handle]

    def generate_answers(self, prompts):
        return self.finalize_tokens(self.generate_tokens(prompts))


def test_length_aware_regrouping_preserves_request_mapping():
    """The two-batch length-sorted regrouping must deliver every request its
    OWN answer (no index mixups across the reordered window)."""
    q = RequestQueue(max_batch_size=4, max_wait_time=0.05, polling_interval=0.01)
    # enqueue before starting the processor so the first get_batch sees a
    # full batch AND a deep queue (triggers the two-batch window)
    queries = [("long " * (50 if i % 2 else 1)) + f"q{i}" for i in range(12)]
    rids = [q.add_request(text, 1) for text in queries]
    proc = BatchProcessor(q, _StubEngine(), polling_interval=0.01)
    proc.start()
    try:
        for rid, text in zip(rids, queries):
            res = q.get_result(rid, timeout=10)
            assert res is not None
            assert res["result"] == f"ans:P:{text}"
    finally:
        proc.stop()


def test_result_long_poll(serving_stack):
    """GET /rag/result?timeout=N holds until the result is ready (server-side
    long-poll extension; default stays the reference's quick check)."""
    client, _, _ = serving_stack
    rid = client.post("/rag", json={"query": "long poll?", "k": 1}).json()["request_id"]
    t0 = time.time()
    r = client.get(f"/rag/result/{rid}?timeout=20").json()
    assert r["status"] == "complete", r
    assert time.time() - t0 < 20


def test_warmup_full_covers_full_prompt_buckets(monkeypatch):
    """With the prefix cache OFF, WARMUP_FULL must pre-compile the full-prompt
    generate for every (batch, prompt-len) bucket — otherwise the first real
    long-context batch pays a multi-minute XLA compile mid-serving (observed
    live on the squad_real no-cache sweep)."""
    monkeypatch.setenv("WARMUP_FULL", "1")
    rng = np.random.default_rng(0)
    docs = [f"Doc {i} text." for i in range(16)]
    emb = rng.standard_normal((16, 64)).astype(np.float32)
    settings = tiny_settings(prefix_cache=False,
                             batch_buckets=[2], max_batch_size=2)
    engine = RagEngine(settings, docs, emb)
    assert engine.prefix_cache is None
    engine.warmup([2])
    # warmup resets stage timings (compile times must not pollute /stats)
    assert engine.timer.summary() == {}
    # a full-bucket prompt now runs through already-compiled programs
    long_prompt = " ".join(f"w{i}" for i in range(120))  # → 128 bucket
    out = engine.generate_answers([long_prompt, long_prompt])
    assert len(out) == 2


def test_warmup_matrix_covers_every_suffix_bucket():
    """The PARALLEL warmup matrix must include a prefix-generate job for
    every SUFFIX_LEN_BUCKETS entry (32 and 64) — short questions land in the
    32 bucket, and a bucket missing from the matrix compiles serially during
    the sanity batches (dead cold-start time) or, worse, mid-serving."""
    from rag_serving_system.core.engine import SUFFIX_LEN_BUCKETS

    rng = np.random.default_rng(0)
    docs = [f"Doc {i} " + " ".join(f"w{i}t{j}" for j in range(20))
            for i in range(16)]
    emb = rng.standard_normal((16, 64)).astype(np.float32)
    engine = RagEngine(tiny_settings(batch_buckets=[2], max_batch_size=2,
                                     prefix_pool_len=48), docs, emb)
    labels = [label for label, _ in engine._prefix_suffix_jobs()]
    for s in SUFFIX_LEN_BUCKETS:
        assert any(f" s{s}" in lbl for lbl in labels), (s, labels)


def test_role_split_api_and_engine_processes(tmp_path):
    """ROLE=api / ROLE=engine split one service across processes over the
    shared queue (main.py): the api role serves HTTP with NO engine in
    process; the engine role consumes the queue with NO HTTP. Wire both to
    one (stubbed-Redis-equivalent) queue and run a request through."""
    import json

    import main as main_mod
    from rag_serving_system.core import request_queue as rq_mod

    # tiny corpus files for the engine role (which loads from settings paths)
    rng = np.random.default_rng(0)
    docs = [f"Fact {i}: item {i} equals {i + 1}." for i in range(16)]
    emb = rng.standard_normal((16, 64)).astype(np.float32)
    ctx = tmp_path / "ctx.json"
    ctx.write_text(json.dumps(docs))
    npy = tmp_path / "emb.npy"
    np.save(npy, emb)

    shared = RequestQueue(max_batch_size=2, max_wait_time=0.1,
                          polling_interval=0.01)
    orig = rq_mod.make_queue
    rq_mod.make_queue = lambda settings: shared
    try:
        s = tiny_settings(redis_url="redis://stub:6379",
                          document_text_file=str(ctx),
                          document_embeddings_file=str(npy))
        # api front: no engine, no processor, no jax
        app, proc, eng, _ = main_mod.build_app(settings=s, role="api")
        assert proc is None and eng is None
        # engine back: processor running, no app
        app2, proc2, eng2, _ = main_mod.build_app(settings=s, warmup=False,
                                                  role="engine")
        assert app2 is None and proc2 is not None and eng2 is not None

        srv = ServerThread(app).start()
        try:
            client = _Client(srv.url)
            rid = client.post("/rag", json={"query": "what is item 3?",
                                            "k": 2}).json()["request_id"]
            out = None
            for _ in range(400):
                res = client.get(f"/rag/result/{rid}").json()
                if res["status"] == "complete":
                    out = res
                    break
                time.sleep(0.05)
            assert out is not None and "result" in out["result"]
        finally:
            srv.stop()
            proc2.stop()
    finally:
        rq_mod.make_queue = orig


def test_role_api_requires_redis():
    import main as main_mod

    s = tiny_settings()
    assert s.redis_url is None
    with pytest.raises(SystemExit):
        main_mod.build_app(settings=s, role="api")


def test_async_finalize_delivers_without_followup_batch():
    """FINALIZE_ASYNC (default on): a single batch's results must be
    delivered promptly by the finalize worker — the old single-slot defer
    held them until the NEXT batch (or an idle poll) arrived."""
    q = RequestQueue(max_batch_size=4, max_wait_time=0.05,
                     polling_interval=0.01)
    proc = BatchProcessor(q, _StubEngine(), polling_interval=0.01)
    assert proc.finalize_async  # default on
    proc.start()
    try:
        rid = q.add_request("solo", 1)
        t0 = time.time()
        res = q.get_result(rid, timeout=10)
        assert res is not None and res["result"] == "ans:P:solo"
        assert time.time() - t0 < 2.0
    finally:
        proc.stop()


def test_async_finalize_backpressure_and_order_independence(monkeypatch):
    """The bounded finalize queue must apply backpressure (dispatch blocks at
    FINALIZE_DEPTH in-flight batches) while every request still gets its own
    answer when the device (here: finalize) is the slow stage."""
    monkeypatch.setenv("FINALIZE_DEPTH", "2")

    class _SlowFinalize(_StubEngine):
        def finalize_tokens(self, handle):
            time.sleep(0.05)  # device + transfer stand-in
            return super().finalize_tokens(handle)

    q = RequestQueue(max_batch_size=2, max_wait_time=0.02,
                     polling_interval=0.01)
    rids = [q.add_request(f"q{i}", 1) for i in range(12)]
    proc = BatchProcessor(q, _SlowFinalize(), polling_interval=0.01)
    assert proc._finalize_q.maxsize == 2
    proc.start()
    try:
        for i, rid in enumerate(rids):
            res = q.get_result(rid, timeout=10)
            assert res is not None
            assert res["result"] == f"ans:P:q{i}"
    finally:
        proc.stop()


def test_sync_finalize_fallback(monkeypatch):
    """FINALIZE_ASYNC=0 restores the single-slot deferred-finalize path."""
    monkeypatch.setenv("FINALIZE_ASYNC", "0")
    q = RequestQueue(max_batch_size=4, max_wait_time=0.05,
                     polling_interval=0.01)
    proc = BatchProcessor(q, _StubEngine(), polling_interval=0.01)
    assert not proc.finalize_async
    proc.start()
    try:
        rids = [q.add_request(f"s{i}", 1) for i in range(8)]
        for i, rid in enumerate(rids):
            res = q.get_result(rid, timeout=10)
            assert res is not None and res["result"] == f"ans:P:s{i}"
    finally:
        proc.stop()


def test_query_cache_exactness_and_lru(monkeypatch):
    """The exact query-result cache must return bit-identical indices to the
    uncached path (retrieval is deterministic), dedup in-batch misses, slice
    per-request k from the cached max_k row, and evict LRU at capacity."""
    rng = np.random.default_rng(1)
    docs = [f"Doc {i} about topic {i}." for i in range(30)]
    emb = rng.standard_normal((30, 64)).astype(np.float32)
    cached = RagEngine(tiny_settings(query_cache_size=4), docs, emb)
    monkeypatch.setenv("QUERY_CACHE_SIZE", "0")
    plain = RagEngine(tiny_settings(query_cache_size=0), docs, emb)
    assert plain.query_cache_stats() is None

    queries = ["alpha", "beta", "alpha", "gamma"]
    ks = [1, 2, 3, 4]
    want = plain.embed_and_retrieve(queries, ks)
    got = cached.embed_and_retrieve(queries, ks)
    assert got == want
    st = cached.query_cache_stats()
    # first batch: "alpha" repeats in-batch but both rows were misses at
    # lookup time; the device path ran once per DISTINCT query
    assert st["misses"] == 4 and st["entries"] == 3

    # steady state: identical batch is all hits, still identical results
    got2 = cached.embed_and_retrieve(queries, ks)
    assert got2 == want
    st = cached.query_cache_stats()
    assert st["hits"] == 4 and st["misses"] == 4

    # capacity 4: the all-hit batch above move_to_end'ed entries in lookup
    # order (alpha, beta, alpha, gamma), leaving recency LRU→MRU as
    # beta, alpha, gamma — so adding delta+epsilon must evict exactly beta
    cached.embed_and_retrieve(["delta", "epsilon"], [2, 2])
    st = cached.query_cache_stats()
    assert st["entries"] == 4
    assert set(cached._query_cache) == {"alpha", "gamma", "delta", "epsilon"}
    # the evicted query re-misses but stays exact
    misses_before = st["misses"]
    assert cached.embed_and_retrieve(["beta"], [3]) == \
        plain.embed_and_retrieve(["beta"], [3])
    assert cached.query_cache_stats()["misses"] == misses_before + 1


def test_warmup_encode_jobs_survive_query_cache():
    """Warmup's encode jobs must dispatch the device path at EVERY batch
    bucket even with the query-result cache on — dedup of repeated warmup
    queries previously collapsed every job to a one-query dispatch, leaving
    the larger encode buckets uncompiled (mid-serving XLA compile)."""
    rng = np.random.default_rng(0)
    docs = [f"Doc {i}." for i in range(20)]
    emb = rng.standard_normal((20, 64)).astype(np.float32)
    eng = RagEngine(tiny_settings(batch_buckets=[2, 4], max_batch_size=4),
                    docs, emb)
    assert eng._query_cache is not None  # default on
    seen = []
    orig = eng._retrieve_full

    def spy(queries):
        seen.append(pick_bucket(eng.batch_buckets, len(queries)))
        return orig(queries)

    eng._retrieve_full = spy
    eng.warmup([2, 4])
    assert {2, 4} <= set(seen), seen


def test_finalize_worker_survives_store_failure():
    """A result-backend failure inside the finalize stage must not kill the
    finalize worker — a dead worker wedges the dispatch loop on the bounded
    queue and the processor stops serving forever."""
    class _FlakyQueue(RequestQueue):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.fail_next = 0

        def store_result(self, rid, result):
            if self.fail_next > 0:
                self.fail_next -= 1
                raise ConnectionError("backend down")
            super().store_result(rid, result)

    q = _FlakyQueue(max_batch_size=2, max_wait_time=0.02,
                    polling_interval=0.01)
    proc = BatchProcessor(q, _StubEngine(), polling_interval=0.01)
    assert proc.finalize_async
    proc.start()
    try:
        # both store attempts of the first batch fail (result path AND the
        # error fan-out path) — the worker must swallow it and keep going
        q.fail_next = 4
        lost = [q.add_request("l0", 1), q.add_request("l1", 1)]
        time.sleep(0.5)
        q.fail_next = 0
        rids = [q.add_request(f"q{i}", 1) for i in range(6)]
        for i, rid in enumerate(rids):
            res = q.get_result(rid, timeout=10)
            assert res is not None and res["result"] == f"ans:P:q{i}"
        for rid in lost:  # dropped, but the pipeline survived
            assert q.get_result(rid, timeout=0.1) is None
    finally:
        proc.stop()


def test_sync_post_returns_completed_result(serving_stack):
    """POST /rag?wait=N (synchronous extension) must return the completed
    result in the POST exchange itself; wait=0 keeps the async protocol."""
    client, _, _ = serving_stack
    body = client.post("/rag?wait=20", json={"query": "sync wait?", "k": 1}).json()
    assert body["status"] == "complete", body
    assert "result" in body and "request_id" in body
    # the result was consumed by the sync response (consume-once)
    assert client.get(f"/rag/result/{body['request_id']}").json() == \
        {"status": "processing"}


def test_sync_post_times_out_to_async_protocol():
    """When the result isn't ready within ?wait=, the response degrades to
    the async contract (request_id + processing) and the request is still
    served later."""
    q = RequestQueue(max_batch_size=4, max_wait_time=0.2, polling_interval=0.02)
    app = create_api(q)  # no processor draining yet
    server = ServerThread(app).start()
    try:
        client = _Client(server.url)
        body = client.post("/rag?wait=0.2", json={"query": "slow", "k": 1}).json()
        assert body["status"] == "processing" and "request_id" in body
        # a processor comes up and drains the queued request
        proc = BatchProcessor(q, _StubEngine(), polling_interval=0.02)
        proc.start()
        try:
            r = client.get(f"/rag/result/{body['request_id']}?timeout=10").json()
            assert r["status"] == "complete"
        finally:
            proc.stop()
    finally:
        server.stop()


def test_locked_lru_semantics():
    """utils.lru.LockedLRU: recency eviction, capacity<=0 disables, and
    concurrent put/get never corrupts the map."""
    import threading

    from rag_serving_system.utils.lru import LockedLRU

    lru = LockedLRU(2)
    lru.put("a", 1)
    lru.put("b", 2)
    assert lru.get("a") == 1        # refresh a → b is now LRU
    lru.put("c", 3)                 # evicts b
    assert lru.get("b") is None and lru.get("a") == 1 and lru.get("c") == 3
    assert len(lru) == 2

    off = LockedLRU(0)
    off.put("x", 1)
    assert off.get("x") is None and len(off) == 0

    big = LockedLRU(64)
    errs = []

    def worker(t):
        try:
            for i in range(500):
                big.put((t, i % 80), i)
                big.get((t, (i * 7) % 80))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs and len(big) <= 64


def test_warmup_jobs_retry_resource_exhausted_serially():
    """Parallel warmup executes N programs' temp buffers at once; a job that
    OOMs under that transient pressure must be retried SERIALLY (one
    program's working set = serving's memory profile), not crash the
    startup. Other exceptions still propagate."""
    calls = []

    def ok():
        calls.append("ok")

    class _Exhausted(RuntimeError):
        pass

    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] == 1:
            raise _Exhausted("backend error (ResourceExhausted): "
                             "RESOURCE_EXHAUSTED while allocating")
        calls.append("flaky-retry")

    eng = RagEngine.__new__(RagEngine)  # method touches no engine state
    eng._run_warmup_jobs([("a", ok), ("b", flaky), ("c", ok)])
    assert calls.count("ok") == 2 and calls.count("flaky-retry") == 1
    assert state["n"] == 2  # exactly one serial retry

    def boom():
        raise ValueError("not a capacity error")

    with pytest.raises(ValueError):
        eng._run_warmup_jobs([("x", boom)] * 2)  # >1 job → pool path
