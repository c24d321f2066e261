"""Benchmark harness unit tests: trace generation semantics and the metrics
collector (the reference has none of these — SURVEY §4 'do better')."""

import time

import numpy as np
import pytest

from benchmarks.load_generator import generate_trace
from benchmarks.metrics.collector import MetricsCollector


@pytest.mark.parametrize("pattern", ["uniform", "poisson", "random"])
def test_trace_count_and_bounds(pattern):
    rps, duration = 10, 5
    ts = generate_trace(pattern, rps, duration, seed=42)
    assert all(0 <= t < duration * 1000 for t in ts)
    assert ts == sorted(ts)
    if pattern in ("uniform", "random"):
        assert len(ts) == rps * duration
    else:  # poisson drops arrivals past the horizon
        assert 0 < len(ts) <= rps * duration


def test_trace_seeded_reproducibility():
    a = generate_trace("poisson", 20, 3, seed=7)
    b = generate_trace("poisson", 20, 3, seed=7)
    c = generate_trace("poisson", 20, 3, seed=8)
    assert a == b
    assert a != c


def test_uniform_trace_spacing():
    ts = generate_trace("uniform", 4, 2, seed=1)  # 8 reqs over 2000ms
    gaps = np.diff(ts)
    assert np.allclose(gaps, 250, atol=1)


def test_trace_zero_requests():
    assert generate_trace("uniform", 0, 10) == []


def test_unknown_pattern_raises():
    with pytest.raises(ValueError):
        generate_trace("bursty", 1, 1)


def test_collector_metrics():
    c = MetricsCollector()
    c.start_test()
    for i in range(10):
        c.record_request_start(f"r{i}")
    for i in range(10):
        c.record_request_end(f"r{i}", success=(i != 9))
    time.sleep(0.01)
    c.end_test()
    m = c.calculate_metrics()
    assert m["total_requests"] == 10
    assert m["successful_requests"] == 9
    assert m["failed_requests"] == 1
    assert m["throughput_rps"] > 0
    lat = m["latency"]
    assert lat["min"] <= lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]


def test_collector_unknown_end_ignored():
    c = MetricsCollector()
    c.record_request_end("never-started", True)
    assert c.calculate_metrics()["total_requests"] == 0


def test_collector_save(tmp_path):
    c = MetricsCollector()
    c.record_request_start("a")
    c.record_request_end("a", True)
    out = tmp_path / "m.json"
    saved = c.save_results(str(out))
    import json
    assert json.loads(out.read_text()) == saved


# ---------------------------------------------------------------------------
# native load generator (benchmarks/loadgen_native.cc)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def native_loadgen(tmp_path_factory):
    import shutil
    import subprocess

    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    binary = tmp_path_factory.mktemp("lgn") / "loadgen_native"
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(binary),
                    "benchmarks/loadgen_native.cc"], check=True)
    return str(binary)


@pytest.fixture(scope="module")
def stub_rag_server():
    """Real serving stack over a stub engine: the full queue→processor→API
    loop, so the native client exercises POST + poll + result consumption."""
    from rag_serving_system.api.endpoints import ServerThread, create_api
    from rag_serving_system.core.batch_processor import BatchProcessor
    from rag_serving_system.core.request_queue import RequestQueue

    class _Stub:
        def prepare(self, queries, ks, budgets=None):
            return list(queries)

        def generate_tokens(self, prompts, staged=None):
            return list(prompts)

        def finalize_tokens(self, handle):
            return [f"ans:{p}" for p in handle]

        def generate_answers(self, prompts):
            return self.finalize_tokens(prompts)

    q = RequestQueue(max_batch_size=8, max_wait_time=0.02,
                     polling_interval=0.01)
    proc = BatchProcessor(q, _Stub(), polling_interval=0.01)
    proc.start()
    server = ServerThread(create_api(q, proc)).start()
    yield server.url
    proc.stop()
    server.stop()


def test_native_loadgen_end_to_end(native_loadgen, stub_rag_server, tmp_path):
    """The C++ client must drive the real API loop and emit the collector's
    JSON schema with all requests succeeding."""
    import json
    import subprocess

    qfile = tmp_path / "queries.json"
    qfile.write_text(json.dumps(
        [f"query with \"quotes\" and unicode \\u00e9 number {i}"
         for i in range(7)]))
    out = tmp_path / "out.json"
    r = subprocess.run(
        [native_loadgen, "--endpoint", stub_rag_server, "--pattern", "uniform",
         "--rps", "25", "--duration", "3", "--seed", "5", "--timeout", "20",
         "--poll-interval", "0.05", "--queries-file", str(qfile),
         "--output", str(out)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    m = json.loads(out.read_text())
    assert m["total_requests"] == 75
    assert m["successful_requests"] == 75 and m["failed_requests"] == 0
    for key in ("duration_seconds", "throughput_rps",
                "successful_throughput_rps"):
        assert key in m
    lat = m["latency"]
    assert 0 < lat["min"] <= lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]


def test_native_loadgen_counts_timeouts_as_failures(native_loadgen, tmp_path):
    """Against a server that never completes results, every request must be
    recorded as failed once its timeout expires (no hang)."""
    import json
    import subprocess

    from rag_serving_system.api.http import App, ServerThread, json_response

    app = App()

    async def rag(request):
        request.json()
        return json_response({"request_id": "r1", "status": "processing"})

    async def result(request):
        return json_response({"status": "processing"})

    app.add_post("/rag", rag)
    app.add_get("/rag/result/{rid}", result)
    server = ServerThread(app).start()
    try:
        qfile = tmp_path / "queries.json"
        qfile.write_text(json.dumps(["q"]))
        out = tmp_path / "out.json"
        r = subprocess.run(
            [native_loadgen, "--endpoint", server.url, "--pattern", "uniform",
             "--rps", "5", "--duration", "2", "--seed", "1", "--timeout", "1",
             "--poll-interval", "0.05", "--queries-file", str(qfile),
             "--output", str(out)],
            capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        m = json.loads(out.read_text())
        assert m["total_requests"] == 10
        assert m["failed_requests"] == 10 and m["successful_requests"] == 0
    finally:
        server.stop()


def test_native_loadgen_sync_post_mode(native_loadgen, stub_rag_server, tmp_path):
    """LOADGEN_SYNC_WAIT: the native client completes each request in the
    POST exchange (?wait=) with zero result polls."""
    import json
    import os
    import subprocess

    qfile = tmp_path / "queries.json"
    qfile.write_text(json.dumps(["sync query"]))
    out = tmp_path / "out.json"
    env = dict(os.environ, LOADGEN_SYNC_WAIT="10")
    r = subprocess.run(
        [native_loadgen, "--endpoint", stub_rag_server, "--pattern", "uniform",
         "--rps", "20", "--duration", "2", "--seed", "1", "--timeout", "20",
         "--queries-file", str(qfile), "--output", str(out)],
        capture_output=True, text=True, timeout=60, env=env)
    assert r.returncode == 0, r.stderr
    m = json.loads(out.read_text())
    assert m["successful_requests"] == 40 and m["failed_requests"] == 0
    # sync exchanges return as soon as the batch completes — no 0.3 s poll
    # quantization in the latency floor
    assert m["latency"]["p50"] < 0.25


def test_native_loadgen_unresponsive_server_hits_deadline(native_loadgen, tmp_path):
    """A server that ACCEPTS connections but never responds (the overload
    regime) must not hang the client: the deadline sweep fails every
    in-flight request at its timeout."""
    import json
    import socket
    import subprocess
    import threading

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(64)
    port = srv.getsockname()[1]
    stop = threading.Event()

    def sink():
        srv.settimeout(0.2)
        held = []
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
                held.append(conn)  # accept and hold, never respond
            except socket.timeout:
                continue

    t = threading.Thread(target=sink, daemon=True)
    t.start()
    try:
        qfile = tmp_path / "queries.json"
        qfile.write_text(json.dumps(["q"]))
        out = tmp_path / "out.json"
        r = subprocess.run(
            [native_loadgen, "--endpoint", f"http://127.0.0.1:{port}",
             "--pattern", "uniform", "--rps", "5", "--duration", "1",
             "--seed", "1", "--timeout", "1", "--queries-file", str(qfile),
             "--output", str(out)],
            capture_output=True, text=True, timeout=30)
        assert r.returncode == 0, r.stderr
        m = json.loads(out.read_text())
        assert m["total_requests"] == 5
        assert m["failed_requests"] == 5
    finally:
        stop.set()
        srv.close()


def test_native_loadgen_connection_refused_fails_fast(native_loadgen, tmp_path):
    """A down server (connection refused) must produce failures, not a hang
    or a reconnect busy-loop that outlives the deadline."""
    import json
    import socket
    import subprocess
    import time

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens here now
    qfile = tmp_path / "queries.json"
    qfile.write_text(json.dumps(["q"]))
    out = tmp_path / "out.json"
    t0 = time.time()
    r = subprocess.run(
        [native_loadgen, "--endpoint", f"http://127.0.0.1:{port}",
         "--pattern", "uniform", "--rps", "5", "--duration", "1",
         "--seed", "1", "--timeout", "1", "--queries-file", str(qfile),
         "--output", str(out)],
        capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr
    m = json.loads(out.read_text())
    assert m["failed_requests"] == 5 and m["successful_requests"] == 0
    assert time.time() - t0 < 15


def test_loadgen_budget_spread_reaches_engine(native_loadgen, tmp_path):
    """--budget-spread LO,HI on BOTH clients: every request carries a
    per-request max_new_tokens in [LO, HI], delivered through the API/queue
    to the engine's prepare(budgets=...) row-aligned with the queries."""
    import asyncio
    import json
    import subprocess

    from rag_serving_system.api.endpoints import ServerThread, create_api
    from rag_serving_system.core.batch_processor import BatchProcessor
    from rag_serving_system.core.request_queue import RequestQueue
    from benchmarks.load_generator import run_load_test

    seen: list = []

    class _Recorder:
        def prepare(self, queries, ks, budgets=None):
            seen.extend(budgets or [None] * len(queries))
            return list(queries)

        def generate_tokens(self, prompts, staged=None):
            return list(prompts)

        def finalize_tokens(self, handle):
            return [f"ans:{p}" for p in handle]

        def generate_answers(self, prompts):
            return self.finalize_tokens(prompts)

    q = RequestQueue(max_batch_size=8, max_wait_time=0.02,
                     polling_interval=0.01)
    proc = BatchProcessor(q, _Recorder(), polling_interval=0.01)
    proc.start()
    server = ServerThread(create_api(q, proc)).start()
    try:
        # python client
        m = asyncio.run(run_load_test(
            server.url, "uniform", 10, 2, seed=3, timeout=20,
            queries=["alpha", "beta"], poll_interval=0.05,
            budget_spread="2,9"))
        assert m.calculate_metrics()["successful_requests"] == 20
        py_budgets = list(seen)
        assert len(py_budgets) == 20
        assert all(isinstance(b, int) and 2 <= b <= 9 for b in py_budgets)
        assert len(set(py_budgets)) > 1, "no variance drawn"

        # native client
        seen.clear()
        qfile = tmp_path / "queries.json"
        qfile.write_text(json.dumps(["alpha", "beta"]))
        out = tmp_path / "out.json"
        r = subprocess.run(
            [native_loadgen, "--endpoint", server.url, "--pattern", "uniform",
             "--rps", "10", "--duration", "2", "--seed", "3",
             "--timeout", "20", "--poll-interval", "0.05",
             "--queries-file", str(qfile), "--budget-spread", "2,9",
             "--output", str(out)],
            capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        assert json.loads(out.read_text())["successful_requests"] == 20
        assert len(seen) == 20
        assert all(isinstance(b, int) and 2 <= b <= 9 for b in seen)
        assert len(set(seen)) > 1

        # without the flag: no budgets reach the engine
        seen.clear()
        m = asyncio.run(run_load_test(
            server.url, "uniform", 5, 1, seed=3, timeout=20,
            queries=["alpha"], poll_interval=0.05))
        assert m.calculate_metrics()["successful_requests"] == 5
        assert seen == [None] * 5
    finally:
        proc.stop()
        server.stop()
