"""Queue semantics tests: batch formation bounds, consume-once results,
Redis wire contract (via fakeredis if present, else a minimal stub)."""

import json
import threading
import time

import pytest

from rag_serving_system.core.request_queue import RequestQueue, RedisRequestQueue


def test_batch_is_size_bounded():
    q = RequestQueue(max_batch_size=4, max_wait_time=5.0)
    for i in range(10):
        q.add_request(f"q{i}", k=1)
    batch = q.get_batch()
    assert len(batch) == 4
    assert [b["query"] for b in batch] == ["q0", "q1", "q2", "q3"]


def test_batch_is_time_bounded():
    q = RequestQueue(max_batch_size=100, max_wait_time=0.3)
    q.add_request("only", k=1)
    t0 = time.time()
    batch = q.get_batch()
    assert len(batch) == 1
    assert time.time() - t0 < 2.0


def test_empty_queue_returns_empty_batch():
    q = RequestQueue(max_batch_size=4, max_wait_time=0.2)
    assert q.get_batch() == []


def test_items_carry_timestamp_and_k():
    q = RequestQueue()
    q.add_request("hello", k=7)
    item = q.get_batch()[0]
    assert item["k"] == 7 and "timestamp" in item and "id" in item


def test_result_ttl_eviction():
    q = RequestQueue(result_ttl_s=0.05)
    rid = q.add_request("x")
    q.store_result(rid, {"result": "stale"})
    time.sleep(0.1)
    # force the amortized sweep
    q._stores_since_sweep = 255
    q.store_result("other", {"result": "fresh"})
    assert rid not in q._results          # expired entry evicted
    assert q.get_result("other", timeout=0.1) == {"result": "fresh"}


def test_get_result_timeout_zero_nonblocking():
    q = RequestQueue()
    t0 = time.time()
    assert q.get_result("missing", timeout=0) is None
    assert time.time() - t0 < 0.05


def test_result_consume_once():
    q = RequestQueue()
    rid = q.add_request("x")
    q.store_result(rid, {"result": "a"})
    assert q.get_result(rid, timeout=1) == {"result": "a"}
    assert q.get_result(rid, timeout=0.05) is None


def test_result_event_wakeup_is_fast():
    q = RequestQueue(polling_interval=5.0)  # event path must ignore this
    rid = q.add_request("x")

    def worker():
        time.sleep(0.15)
        q.store_result(rid, {"result": "done"})

    threading.Thread(target=worker, daemon=True).start()
    t0 = time.time()
    assert q.get_result(rid, timeout=3) == {"result": "done"}
    assert time.time() - t0 < 1.0  # woke on the event, not a 5 s poll


class _StubRedis:
    """Minimal in-process Redis lookalike covering the ops we use."""

    def __init__(self):
        self.lists = {}
        self.kv = {}

    def rpush(self, key, val):
        self.lists.setdefault(key, []).append(val)

    def lpop(self, key):
        lst = self.lists.get(key)
        return lst.pop(0) if lst else None

    def blpop(self, key, timeout=0):
        v = self.lpop(key)
        if v is None:
            time.sleep(min(timeout, 0.01))
            return None
        return (key, v)

    def llen(self, key):
        return len(self.lists.get(key, []))

    def lindex(self, key, i):
        lst = self.lists.get(key, [])
        return lst[i] if -len(lst) <= i < len(lst) else None

    def setex(self, key, ttl, val):
        self.kv[key] = val

    def get(self, key):
        return self.kv.get(key)

    def delete(self, key):
        self.kv.pop(key, None)

    def pipeline(self):
        outer = self

        class _Pipe:
            def __init__(self):
                self.ops = []

            def lpop(self, key):
                self.ops.append(key)

            def execute(self):
                return [outer.lpop(k) for k in self.ops]

        return _Pipe()


@pytest.fixture
def redis_queue():
    try:
        import fakeredis
        client = fakeredis.FakeRedis()
    except ImportError:
        client = _StubRedis()
    return RedisRequestQueue(client=client, max_batch_size=4, max_wait_time=0.3,
                             polling_interval=0.02)


def test_redis_wire_contract(redis_queue):
    rid = redis_queue.add_request("what is jax", k=3)
    raw = redis_queue.redis.lindex("rag_service:requests", 0)
    payload = json.loads(raw)
    assert payload["id"] == rid
    assert payload["query"] == "what is jax"
    assert payload["k"] == 3
    assert "timestamp" in payload  # the autoscaler contract (auto_scaler.py:36-39)


def test_redis_batch_and_results(redis_queue):
    ids = [redis_queue.add_request(f"q{i}") for i in range(6)]
    batch = redis_queue.get_batch()
    assert len(batch) == 4  # size-bounded
    assert [b["id"] for b in batch] == ids[:4]
    redis_queue.store_result(ids[0], {"result": "r0"})
    key = "rag_service:result:" + ids[0]
    assert redis_queue.redis.get(key) is not None
    assert redis_queue.get_result(ids[0], timeout=1) == {"result": "r0"}
    assert redis_queue.redis.get(key) is None  # consumed
    assert redis_queue.get_result("missing", timeout=0.05) is None


def test_redis_queue_metrics(redis_queue):
    assert redis_queue.queue_size() == 0
    assert redis_queue.oldest_wait_time() == 0.0
    redis_queue.add_request("a")
    time.sleep(0.05)
    assert redis_queue.queue_size() == 1
    assert redis_queue.oldest_wait_time() >= 0.04


def test_in_memory_oldest_wait_time():
    """The in-memory backend must report the oldest queued item's wait (the
    Redis backend's lindex-0 semantics) so /metrics and wait-based
    backpressure work in single-replica mode."""
    q = RequestQueue(max_batch_size=4, max_wait_time=0.05)
    assert q.oldest_wait_time() == 0.0
    q.add_request("a", 1)
    time.sleep(0.05)
    q.add_request("b", 1)
    w = q.oldest_wait_time()
    assert w >= 0.05
    # oldest reflects the FIRST item, not the latest
    assert q.oldest_wait_time() >= w
    q.get_batch()  # drains both
    assert q.oldest_wait_time() == 0.0


def test_replica_failover_drains_remaining_work(redis_queue):
    """Replica death semantics (SURVEY §5): the Redis queue survives a dead
    processor; a replacement replica drains everything still queued. Items
    already popped by the dead replica are lost (at-most-once, same tradeoff
    as the reference's BLPOP path) — here the dead replica is stopped BEFORE
    popping, so nothing is lost."""
    import threading

    from rag_serving_system.core.batch_processor import BatchProcessor

    class _Engine:
        def prepare(self, queries, ks, budgets=None):
            return queries

        def generate_tokens(self, prompts, staged=None):
            return list(prompts)

        def finalize_tokens(self, handle):
            return [f"ans:{p}" for p in handle]

        def generate_answers(self, prompts):
            return self.finalize_tokens(self.generate_tokens(prompts))

    rids = [redis_queue.add_request(f"q{i}", 1) for i in range(10)]
    # replica A dies before doing any work (stopped pre-start)
    dead = BatchProcessor(redis_queue, _Engine(), polling_interval=0.01)
    dead.stop()
    assert redis_queue.queue_size() == 10  # nothing lost
    # replacement replica B picks up the same Redis queue
    alive = BatchProcessor(redis_queue, _Engine(), polling_interval=0.01)
    alive.start()
    try:
        for rid in rids:
            res = redis_queue.get_result(rid, timeout=10)
            assert res is not None and "result" in res
    finally:
        alive.stop()


# ---------------------------------------------------------------------------
# async-notification callbacks (the API long-poll's zero-thread wait path)
# ---------------------------------------------------------------------------

def test_result_callback_notifies_on_store():
    from rag_serving_system.core.request_queue import RequestQueue

    q = RequestQueue()
    rid = q.add_request("hello", 2)
    fired = threading.Event()
    assert q.add_result_callback(rid, fired.set) is None
    q.store_result(rid, {"result": "x"})
    assert fired.wait(1.0)
    # notification-only: the result is still stored until popped
    assert q.get_result(rid, timeout=0) == {"result": "x"}
    assert q.get_result(rid, timeout=0) is None  # consume-once


def test_result_callback_immediate_when_already_stored():
    from rag_serving_system.core.request_queue import RequestQueue

    q = RequestQueue()
    rid = q.add_request("hello", 2)
    q.store_result(rid, {"result": "y"})
    got = q.add_result_callback(rid, lambda: (_ for _ in ()).throw(
        AssertionError("must not register")))
    assert got == {"result": "y"}


def test_result_callback_cancel():
    from rag_serving_system.core.request_queue import RequestQueue

    q = RequestQueue()
    rid = q.add_request("hello", 2)
    fired = threading.Event()
    q.add_result_callback(rid, fired.set)
    q.cancel_result_callback(rid, fired.set)
    q.store_result(rid, {"result": "z"})
    assert not fired.wait(0.1)
    assert q.get_result(rid, timeout=0) == {"result": "z"}
