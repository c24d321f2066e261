"""Real-TCP wire tests for the native miniredis server + RespClient pair.

The other Redis-queue tests (`test_queue.py`) exercise the wire contract
against an in-process stub; these run the SAME queue over an actual socket
to the C++ server (`native/miniredis.cc`) with the pure-Python RESP client
(`utils/resp.py`) — the dependency-free split-role topology
(ROLE=api / ROLE=engine, main.py) uses exactly this pair when redis-py /
a real Redis are absent (reference pins both; this repo degrades
gracefully)."""

import socket
import subprocess
import threading
import time

import pytest

from rag_serving_system.core.request_queue import RedisRequestQueue
from rag_serving_system.native import get_miniredis_path
from rag_serving_system.utils.resp import RespClient


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def server():
    path = get_miniredis_path()
    if path is None:
        pytest.skip("no C++ toolchain to build miniredis")
    port = _free_port()
    proc = subprocess.Popen([path, str(port)], stderr=subprocess.PIPE)
    # wait for the listening line / accepting socket
    deadline = time.time() + 5
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            break
        except OSError:
            time.sleep(0.05)
    else:
        proc.kill()
        pytest.fail("miniredis did not come up")
    yield port
    proc.terminate()
    proc.wait(timeout=5)


@pytest.fixture()
def client(server):
    c = RespClient("127.0.0.1", server)
    c.flushall()
    yield c
    c.close()


def test_ping_and_strings(client):
    assert client.ping()
    assert client.get("missing") is None
    client.set("k", "v")
    assert client.get("k") == b"v"
    assert client.delete("k", "missing") == 1
    assert client.get("k") is None


def test_setex_expires(client):
    client.setex("tmp", 1, "payload")
    assert client.get("tmp") == b"payload"
    time.sleep(1.1)
    assert client.get("tmp") is None


def test_list_ops_and_pipeline(client):
    assert client.rpush("q", "a", "b", "c") == 3
    assert client.llen("q") == 3
    assert client.lindex("q", 0) == b"a"
    assert client.lindex("q", -1) == b"c"
    pipe = client.pipeline()
    for _ in range(5):
        pipe.lpop("q")
    got = pipe.execute()
    assert got == [b"a", b"b", b"c", None, None]
    assert client.llen("q") == 0


def test_blpop_timeout_and_wakeup(client, server):
    t0 = time.time()
    assert client.blpop("empty", timeout=0.3) is None
    assert 0.2 <= time.time() - t0 < 2.0
    # a blocked client must be woken by another connection's RPUSH
    other = RespClient("127.0.0.1", server)
    got = {}

    def blocker():
        got["item"] = client.blpop("wake", timeout=5)

    th = threading.Thread(target=blocker)
    th.start()
    time.sleep(0.2)
    other.rpush("wake", "hello")
    th.join(timeout=5)
    other.close()
    assert got["item"] == (b"wake", b"hello")


def test_pool_concurrency_and_blpop_nonblocking(client, server):
    """The pool must let commands proceed while another thread sits in
    BLPOP on the SAME client (single-socket designs deadlock here), and
    survive many threads hammering concurrently."""
    got = {}

    def blocker():
        got["item"] = client.blpop("poolwake", timeout=5)

    th = threading.Thread(target=blocker)
    th.start()
    time.sleep(0.1)
    # while blocker holds its pooled conn in BLPOP, these must not stall
    t0 = time.time()
    client.set("side", "v")
    assert client.get("side") == b"v"
    assert time.time() - t0 < 1.0
    client.rpush("poolwake", "x")
    th.join(timeout=5)
    assert got["item"] == (b"poolwake", b"x")

    errs = []

    def hammer(i):
        try:
            for j in range(50):
                client.set(f"h{i}", f"{j}")
                assert client.get(f"h{i}") == str(j).encode()
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs


def test_request_queue_over_real_socket(server):
    q = RedisRequestQueue(client=RespClient("127.0.0.1", server),
                          max_batch_size=4, max_wait_time=0.3,
                          polling_interval=0.01)
    rids = [q.add_request(f"query {i}", k=2) for i in range(6)]
    assert q.queue_size() == 6
    assert q.oldest_wait_time() >= 0.0
    batch = q.get_batch()
    assert [b["query"] for b in batch] == [f"query {i}" for i in range(4)]
    batch2 = q.get_batch()
    assert len(batch2) == 2
    # results round-trip, consume-once
    q.store_result(rids[0], {"result": "answer"})
    assert q.get_result(rids[0], timeout=5) == {"result": "answer"}
    assert q.get_result(rids[0], timeout=0.2) is None


def test_batch_processor_end_to_end_over_miniredis(server):
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

    q = RedisRequestQueue(client=RespClient("127.0.0.1", server),
                          max_batch_size=4, max_wait_time=0.1,
                          polling_interval=0.01)
    proc = BatchProcessor(q, _Engine(), polling_interval=0.01)
    proc.start()
    try:
        rids = [q.add_request(f"q{i}", 1) for i in range(10)]
        for i, rid in enumerate(rids):
            res = q.get_result(rid, timeout=10)
            assert res is not None and res["result"] == f"ans:q{i}"
    finally:
        proc.stop()


# ---------------------------------------------------------------------------
# bounded memory (MINIREDIS_MAX_BYTES) + active TTL sweep
# ---------------------------------------------------------------------------

import os

from rag_serving_system.utils.resp import RespError


@pytest.fixture()
def capped_server():
    path = get_miniredis_path()
    if path is None:
        pytest.skip("no C++ toolchain to build miniredis")
    port = _free_port()
    env = dict(os.environ, MINIREDIS_MAX_BYTES="8192")
    proc = subprocess.Popen([path, str(port)], stderr=subprocess.PIPE, env=env)
    deadline = time.time() + 5
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            break
        except OSError:
            time.sleep(0.05)
    else:
        proc.kill()
        pytest.fail("capped miniredis did not come up")
    c = RespClient("127.0.0.1", port)
    yield c
    c.close()
    proc.terminate()
    proc.wait(timeout=5)


def test_info_memory_accounting(client):
    base = client.info()["used_memory"]
    client.rpush("memq", "x" * 1000)
    grown = client.info()["used_memory"]
    assert grown >= base + 1000
    client.lpop("memq")
    assert client.info()["used_memory"] == base


def test_oom_rejects_writes_and_recovers(capped_server):
    c = capped_server
    assert c.info()["maxmemory"] == 8192
    # fill past the cap: each item ~1032 accounted bytes
    with pytest.raises(RespError, match="OOM"):
        for _ in range(20):
            c.rpush("q", "y" * 1000)
    # draining frees memory; writes work again (backpressure, not a wedge)
    while c.lpop("q") is not None:
        pass
    assert c.rpush("q", "z" * 1000) == 1
    # string writes are capped too
    with pytest.raises(RespError, match="OOM"):
        for i in range(20):
            c.setex(f"rag_service:result:{i}", 3600, "r" * 1000)


def test_expired_results_are_swept_without_access(capped_server):
    """Unclaimed SETEX results must be reaped by the periodic sweep — lazy
    expiry alone would hold them for the process lifetime (soak-test leak)."""
    c = capped_server
    base = c.info()["used_memory"]
    for i in range(5):
        c.setex(f"sweep:{i}", 1, "v" * 500)
    assert c.info()["used_memory"] > base
    time.sleep(3.5)  # ttl 1 s + sweep period 2 s
    c.ping()         # any event-loop wakeup after the sweep window
    assert c.info()["used_memory"] == base
