"""Concurrency stress: many clients posting and polling a live server at
once — exercises queue locking, batch formation under contention, the
prefetch pipeline, and the poll executor (the closest thing to a race
detector this stack needs; the reference has no equivalent)."""

import threading
import time

import numpy as np
import pytest
import requests

from rag_serving_system.config import Settings
from rag_serving_system.core.engine import RagEngine
from rag_serving_system.core.batch_processor import BatchProcessor
from rag_serving_system.core.request_queue import RequestQueue
from rag_serving_system.api.endpoints import create_api, ServerThread


@pytest.fixture(scope="module", params=["async_finalize", "sync_finalize"])
def live_server(request, monkeypatch_module):
    monkeypatch_module.setenv(
        "FINALIZE_ASYNC", "1" if request.param == "async_finalize" else "0")
    rng = np.random.default_rng(0)
    docs = [f"Fact {i}: value {i}." for i in range(30)]
    emb = rng.standard_normal((30, 64)).astype(np.float32)
    settings = Settings(model_preset="tiny", dtype="float32",
                        batch_buckets=[1, 2, 4, 8], encode_len_buckets=[16, 32],
                        prompt_len_buckets=[64], max_new_tokens=2, max_k=4,
                        max_batch_size=8, max_wait_time=0.1)
    engine = RagEngine(settings, docs, emb)
    engine.warmup([8])
    queue = RequestQueue(max_batch_size=8, max_wait_time=0.1,
                         polling_interval=0.01)
    processor = BatchProcessor(queue, engine, polling_interval=0.01)
    processor.start()
    server = ServerThread(create_api(queue, processor, engine)).start()
    yield server.url
    processor.stop()
    server.stop()


@pytest.fixture(scope="module")
def monkeypatch_module():
    from _pytest.monkeypatch import MonkeyPatch

    mp = MonkeyPatch()
    yield mp
    mp.undo()


def test_concurrent_clients_all_complete(live_server):
    n_clients, results, lock = 40, [], threading.Lock()

    def client(i):
        try:
            r = requests.post(f"{live_server}/rag",
                              json={"query": f"what is value {i}?", "k": 2},
                              timeout=10)
            rid = r.json()["request_id"]
            deadline = time.time() + 60
            while time.time() < deadline:
                body = requests.get(f"{live_server}/rag/result/{rid}",
                                    timeout=10).json()
                if body["status"] == "complete":
                    with lock:
                        results.append(("ok", i))
                    return
                time.sleep(0.05)
            with lock:
                results.append(("timeout", i))
        except Exception as e:
            with lock:
                results.append((f"error:{e}", i))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    statuses = [s for s, _ in results]
    assert len(results) == n_clients
    assert statuses.count("ok") == n_clients, statuses
