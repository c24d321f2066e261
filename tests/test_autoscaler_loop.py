"""Autoscaler integration loop: live miniredis → get_queue_metrics →
desired_replicas → fake scale client, driving a synthetic load/idle cycle
and asserting the replica trajectory.

This closes the gap left by `test_autoscaler.py` (pure-policy only): here the
REAL queue producer (`RedisRequestQueue.add_request` — the `timestamp` wire
contract the policy depends on, reference deployment/auto_scaler.py:27-43)
feeds a REAL RESP server (`native/miniredis.cc`), and the full
`AutoscaleController.step()` cycle (reference auto_scaler.py:66-111) runs
against it with only the K8s patch call faked.
"""

import socket
import subprocess
import time

import pytest

from deployment.auto_scaler import AutoscaleController, ScalerConfig
from rag_serving_system.core.request_queue import RedisRequestQueue
from rag_serving_system.native import get_miniredis_path
from rag_serving_system.utils.resp import RespClient

QUEUE_KEY = "rag_service:requests"


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


class FakeScaleClient:
    """Stands in for K8sScaleClient: records every patch as the trajectory."""

    def __init__(self, replicas: int = 1):
        self.replicas = replicas
        self.trajectory: list[int] = []

    def read_replicas(self) -> int:
        return self.replicas

    def set_replicas(self, n: int) -> None:
        self.replicas = n
        self.trajectory.append(n)


class FakeClock:
    """Starts at real time (so queue-item timestamps written by the real
    producer compare sensibly) and advances only when told."""

    def __init__(self):
        self.now = time.time()

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


CFG = ScalerConfig(min_replicas=1, max_replicas=4, queue_size_per_replica=30,
                   wait_threshold=5.0, low_wait_threshold=1.0,
                   idle_threshold=300, min_idle_replicas=0)


def _drain(client):
    while client.lpop(QUEUE_KEY) is not None:
        pass


def test_full_load_idle_cycle(client, server):
    queue = RedisRequestQueue(client=client)
    scale = FakeScaleClient(replicas=1)
    clock = FakeClock()
    ctl = AutoscaleController(client, scale, CFG, queue_key=QUEUE_KEY,
                              clock=clock)

    # 1. empty queue, not yet idle-threshold → hold at 1 (no patch issued)
    assert ctl.step() == 1
    assert scale.trajectory == []

    # 2. burst: 65 real enqueues → size-based 65//30+1 = 3
    for i in range(65):
        queue.add_request(f"q{i}", k=2)
    assert client.llen(QUEUE_KEY) == 65
    assert ctl.step() == 3
    assert scale.trajectory == [3]

    # 3. the oldest item ages past WAIT_THRESHOLD → +1 (clamped to max)
    clock.advance(10.0)
    assert ctl.step() == 4
    assert scale.trajectory == [3, 4]

    # 4. backlog cleared; a trickle of fresh items (low wait) → gradual -1
    _drain(client)
    clock.now = time.time()
    for i in range(5):
        queue.add_request(f"fresh{i}", k=2)
    assert ctl.step() == 3
    assert ctl.step() == 2
    assert ctl.step() == 1
    assert scale.trajectory == [3, 4, 3, 2, 1]

    # 5. queue empty: below idle threshold holds min, past it scales to zero
    _drain(client)
    assert ctl.step() == 1           # idle clock starts here
    clock.advance(CFG.idle_threshold + 1)
    assert ctl.step() == 0
    assert scale.trajectory == [3, 4, 3, 2, 1, 0]

    # 6. traffic returns → straight back up from zero (clock re-aligned to
    # real time so the fresh item doesn't read as a stale head)
    clock.now = time.time()
    queue.add_request("wakeup", k=2)
    scale.replicas = 0
    assert ctl.step() == 1
    assert scale.trajectory[-1] == 1


def test_wait_metric_rides_the_wire_timestamp(client):
    """The +1 branch must key off the `timestamp` JSON field exactly as the
    reference reads it (auto_scaler.py:27-43) — not client-side state."""
    queue = RedisRequestQueue(client=client)
    scale = FakeScaleClient(replicas=1)
    clock = FakeClock()
    ctl = AutoscaleController(client, scale, CFG, queue_key=QUEUE_KEY,
                              clock=clock)
    queue.add_request("only", k=2)
    assert ctl.step() == 1           # fresh item, wait ~0 → size-based 1
    clock.advance(6.0)               # > WAIT_THRESHOLD
    assert ctl.step() == 2           # size-based 1, +1 for the stale head
