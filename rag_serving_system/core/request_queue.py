"""Request queues: in-memory and Redis backends.

Keeps the reference's duck-typed queue contract byte-for-byte
(reference: rag_service/core/request_queue.py):

- `add_request(query, k) -> request_id`
- `get_batch() -> list[{"id", "query", "k", ("timestamp")}]`
  (size-bounded by max_batch_size; time-bounded by max_wait_time once
   at least one item is held)
- `store_result(request_id, result)`
- `get_result(request_id, timeout) -> result | None` (consume-once)

Redis wire contract preserved exactly — list key `rag_service:requests` with
JSON `{id, query, k, timestamp}` items and results at
`rag_service:result:<id>` with 3600 s TTL (request_queue.py:25-36,63-66) —
so the reference's Kubernetes autoscaler policy (which reads these keys)
works against this service unchanged.

Improvements over the reference:
- in-memory results signal via per-request `threading.Event` instead of a
  polling loop, so `get_result` wakes immediately (the reference sleeps
  `polling_interval` between checks, request_queue.py:125-134);
- in-memory items also carry `timestamp` so /metrics can report queue wait
  for both backends.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import threading
import time
import uuid
from typing import Any, Optional

logger = logging.getLogger(__name__)


class RequestQueue:
    """Thread-safe in-memory FIFO + result store (single-replica mode)."""

    RESULT_TTL_S = 3600  # match the Redis backend's SETEX TTL

    def __init__(self, max_batch_size: int = 32, max_wait_time: float = 1.0,
                 polling_interval: float = 0.1, result_ttl_s: float | None = None):
        self.queue: "queue.Queue[dict]" = queue.Queue()
        self._pending_ts: "collections.deque[float]" = collections.deque()
        self.max_batch_size = max_batch_size
        self.max_wait_time = max_wait_time
        self.polling_interval = polling_interval
        self.result_ttl_s = result_ttl_s if result_ttl_s is not None else self.RESULT_TTL_S
        self._lock = threading.Lock()
        self._results: dict[str, tuple[float, Any]] = {}  # id → (stored_at, result)
        self._events: dict[str, threading.Event] = {}
        self._callbacks: dict[str, list] = {}  # id → notification callbacks
        self._stores_since_sweep = 0

    def add_request(self, query: str, k: int = 2,
                    max_new_tokens: int | None = None) -> str:
        return self.add_request_with_id(str(uuid.uuid4()), query, k,
                                        max_new_tokens)

    def add_request_with_id(self, request_id: str, query: str, k: int = 2,
                            max_new_tokens: int | None = None) -> str:
        """Enqueue with a caller-assigned id (the native HTTP front mints its
        own ids on the epoll thread so submission needs no Python round trip).
        `max_new_tokens` (optional) is the request's own generation budget;
        omitted from the payload when unset so the default wire contract is
        unchanged."""
        ts = time.time()
        # side deque of enqueue timestamps so oldest_wait_time() can peek
        # (queue.Queue has no peek); appended BEFORE put so a racing consumer
        # always finds a timestamp to pop; popped as items are dequeued below
        self._pending_ts.append(ts)
        item = {"id": request_id, "query": query, "k": k, "timestamp": ts}
        if max_new_tokens is not None:
            item["max_new_tokens"] = max_new_tokens
        self.queue.put(item)
        return request_id

    def get_batch(self) -> list:
        """Blocks up to max_wait_time once an item is held; returns as soon as
        the batch is full. Empty list if nothing arrived."""
        batch: list[dict] = []
        start = time.time()
        while len(batch) < self.max_batch_size:
            elapsed = time.time() - start
            if elapsed >= self.max_wait_time and batch:
                break
            try:
                item = self.queue.get(timeout=max(0.05, self.max_wait_time - elapsed))
                batch.append(item)
                self.queue.task_done()
                try:
                    self._pending_ts.popleft()
                except IndexError:
                    pass
            except queue.Empty:
                break
        return batch

    def _sweep_expired_locked(self) -> None:
        """Drop results abandoned by clients (TTL like the Redis SETEX,
        request_queue.py:66) so sustained load with client timeouts can't
        grow the dict without bound. Amortized: runs every 256 stores."""
        cutoff = time.time() - self.result_ttl_s
        expired = [rid for rid, (ts, _) in self._results.items() if ts < cutoff]
        for rid in expired:
            del self._results[rid]

    def store_result(self, request_id: str, result: Any) -> None:
        with self._lock:
            self._results[request_id] = (time.time(), result)
            ev = self._events.pop(request_id, None)
            cbs = self._callbacks.pop(request_id, ())
            self._stores_since_sweep += 1
            if self._stores_since_sweep >= 256:
                self._stores_since_sweep = 0
                self._sweep_expired_locked()
        if ev is not None:
            ev.set()
        for cb in cbs:  # outside the lock — callbacks may do arbitrary work
            try:
                cb()
            except Exception:  # a dead waiter (e.g. closed event loop at
                # shutdown) must not break result delivery to anyone else
                logger.exception("result callback failed for %s", request_id)

    def _pop_locked(self, request_id: str) -> Optional[Any]:
        entry = self._results.pop(request_id, None)
        return entry[1] if entry is not None else None

    def get_result(self, request_id: str, timeout: float = 30) -> Optional[Any]:
        with self._lock:
            if request_id in self._results:
                return self._pop_locked(request_id)
            if timeout <= 0:
                return None
            ev = self._events.setdefault(request_id, threading.Event())
        if not ev.wait(timeout):
            with self._lock:
                # avoid leaking events for requests nobody will answer
                if self._events.get(request_id) is ev and request_id not in self._results:
                    self._events.pop(request_id, None)
                return self._pop_locked(request_id)
        with self._lock:
            return self._pop_locked(request_id)

    # -- async-friendly result notification (used by the API's long-poll) ---
    #
    # The callback is a pure NOTIFICATION — it consumes nothing. The waiter
    # pops the result with get_result(id, timeout=0) when notified, so
    # consume-once semantics and the abandoned-result TTL sweep are shared
    # with the threaded path, and a callback that fires after the waiter
    # gave up loses nothing.

    def add_result_callback(self, request_id: str, cb) -> Optional[Any]:
        """If the result is already stored, pop and return it immediately
        (no callback registered). Otherwise register `cb` to be invoked
        (from the processor thread) when store_result lands, and return
        None."""
        with self._lock:
            if request_id in self._results:
                return self._pop_locked(request_id)
            self._callbacks.setdefault(request_id, []).append(cb)
            return None

    def cancel_result_callback(self, request_id: str, cb) -> None:
        with self._lock:
            lst = self._callbacks.get(request_id)
            if lst is not None:
                try:
                    lst.remove(cb)
                except ValueError:
                    pass
                if not lst:
                    del self._callbacks[request_id]

    # introspection used by /metrics
    def queue_size(self) -> int:
        return self.queue.qsize()

    def oldest_wait_time(self) -> float:
        """Wait of the oldest still-queued request (matches the Redis
        backend's lindex-0 semantics). Approximate under concurrent dequeue —
        it's a metrics gauge, not a synchronization primitive."""
        try:
            return max(0.0, time.time() - self._pending_ts[0])
        except IndexError:
            return 0.0


class RedisRequestQueue:
    """Redis-backed distributed queue (multi-replica mode).

    Same keys/payloads as the reference so its autoscaler works unchanged.
    """

    QUEUE_KEY = "rag_service:requests"
    RESULT_PREFIX = "rag_service:result:"
    RESULT_TTL_S = 3600

    def __init__(self, redis_url: str = "redis://localhost:6379/0",
                 max_batch_size: int = 32, max_wait_time: float = 1.0,
                 polling_interval: float = 0.1, client=None):
        if client is not None:
            self.redis = client  # injection point for fakeredis in tests
        else:
            # redis-py when installed, else the in-repo RESP client (pairs
            # with native/miniredis.cc for redis-free deployments)
            from rag_serving_system.utils.resp import client_from_url
            self.redis = client_from_url(redis_url)
        self.max_batch_size = max_batch_size
        self.max_wait_time = max_wait_time
        self.polling_interval = polling_interval
        self.queue_key = self.QUEUE_KEY
        self.results_key_prefix = self.RESULT_PREFIX

    def add_request(self, query: str, k: int = 2,
                    max_new_tokens: int | None = None) -> str:
        return self.add_request_with_id(str(uuid.uuid4()), query, k,
                                        max_new_tokens)

    def add_request_with_id(self, request_id: str, query: str, k: int = 2,
                            max_new_tokens: int | None = None) -> str:
        item = {"id": request_id, "query": query, "k": k,
                "timestamp": time.time()}
        if max_new_tokens is not None:
            # optional field: absent for default requests, so the reference
            # wire contract (id/query/k/timestamp) stays byte-compatible
            item["max_new_tokens"] = max_new_tokens
        self.redis.rpush(self.queue_key, json.dumps(item))
        return request_id

    def get_batch(self) -> list:
        batch: list[dict] = []
        start = time.time()
        while len(batch) < self.max_batch_size:
            if time.time() - start >= self.max_wait_time and batch:
                break
            # grab everything already queued in one round trip (the reference
            # BLPOPs one item per round trip, request_queue.py:49)
            want = self.max_batch_size - len(batch)
            pipe = self.redis.pipeline()
            for _ in range(want):
                pipe.lpop(self.queue_key)
            got = [g for g in pipe.execute() if g]
            batch.extend(json.loads(g) for g in got)
            if len(batch) >= self.max_batch_size:
                break
            if not got:
                if batch:
                    break
                item = self.redis.blpop(self.queue_key, timeout=0.1)
                if item:
                    batch.append(json.loads(item[1]))
                elif time.time() - start >= self.max_wait_time:
                    break
        return batch

    def store_result(self, request_id: str, result: Any) -> None:
        self.redis.setex(self.results_key_prefix + request_id,
                         self.RESULT_TTL_S, json.dumps(result))

    def get_result(self, request_id: str, timeout: float = 30) -> Optional[Any]:
        key = self.results_key_prefix + request_id
        start = time.time()
        while True:
            raw = self.redis.get(key)
            if raw:
                self.redis.delete(key)
                return json.loads(raw)
            if time.time() - start >= timeout:
                return None
            time.sleep(self.polling_interval)

    def queue_size(self) -> int:
        return int(self.redis.llen(self.queue_key))

    def oldest_wait_time(self) -> float:
        oldest = self.redis.lindex(self.queue_key, 0)
        if not oldest:
            return 0.0
        try:
            data = json.loads(oldest)
            ts = data.get("timestamp")
            return max(0.0, time.time() - ts) if ts else 0.0
        except Exception:
            return 0.0


def make_queue(settings) -> "RequestQueue | RedisRequestQueue":
    """Backend selection: Redis iff REDIS_URL is set (reference: main.py:35-49)."""
    kwargs = dict(max_batch_size=settings.max_batch_size,
                  max_wait_time=settings.max_wait_time,
                  polling_interval=min(settings.polling_interval, 0.1))
    if settings.redis_url:
        return RedisRequestQueue(settings.redis_url, **kwargs)
    return RequestQueue(**kwargs)
