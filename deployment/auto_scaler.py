"""Kubernetes autoscaler for the RAG service (reference: deployment/auto_scaler.py).

Reads Redis queue depth + oldest-item wait (the `timestamp` field contract in
the queue payload) and patches the Deployment's replica count. The policy is
identical to the reference's (auto_scaler.py:66-111) but factored into a pure
function (`desired_replicas`) so it is unit-testable without a cluster:

- queue empty for >= IDLE_THRESHOLD s       → MIN_IDLE_REPLICAS (scale-to-zero)
- else size-based: clamp(size // QUEUE_SIZE_PER_REPLICA + 1, MIN, MAX)
- wait > WAIT_THRESHOLD                     → +1 (clamped to MAX)
- wait < LOW_WAIT_THRESHOLD and current > size-based → gradual -1
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass


@dataclass
class ScalerConfig:
    min_replicas: int = int(os.environ.get("MIN_REPLICAS", "1"))
    max_replicas: int = int(os.environ.get("MAX_REPLICAS", "4"))
    queue_size_per_replica: int = int(os.environ.get("QUEUE_SIZE_PER_REPLICA", "30"))
    wait_threshold: float = float(os.environ.get("WAIT_THRESHOLD", "5.0"))
    low_wait_threshold: float = float(os.environ.get("LOW_WAIT_THRESHOLD", "1.0"))
    idle_threshold: float = float(os.environ.get("IDLE_THRESHOLD", "300"))
    min_idle_replicas: int = int(os.environ.get("MIN_IDLE_REPLICAS", "0"))
    check_interval: float = float(os.environ.get("CHECK_INTERVAL", "15"))


def desired_replicas(queue_size: int, wait_time: float, current_replicas: int,
                     idle_seconds: float, cfg: ScalerConfig) -> int:
    """Pure scaling policy. `idle_seconds` = how long the queue has been empty."""
    if queue_size == 0 and idle_seconds >= cfg.idle_threshold:
        return cfg.min_idle_replicas
    size_based = max(cfg.min_replicas,
                     min(cfg.max_replicas,
                         queue_size // cfg.queue_size_per_replica + 1))
    if wait_time > cfg.wait_threshold:
        return min(cfg.max_replicas, size_based + 1)
    if wait_time < cfg.low_wait_threshold and current_replicas > size_based:
        return max(size_based, current_replicas - 1)
    return size_based


def get_queue_metrics(redis_client, queue_key: str, clock=time.time) -> tuple[int, float]:
    queue_size = redis_client.llen(queue_key)
    wait_time = 0.0
    if queue_size > 0:
        try:
            oldest = redis_client.lindex(queue_key, 0)
            if oldest:
                data = json.loads(oldest)
                if "timestamp" in data:
                    wait_time = clock() - data["timestamp"]
        except Exception as e:
            print(f"error calculating wait time: {e}")
    return queue_size, wait_time


class AutoscaleController:
    """The metrics → policy → scale loop, with every dependency injectable so
    the full cycle is integration-testable against a live (mini)redis and a
    fake scale client (no cluster needed). `autoscale_loop` below is the thin
    production wrapper binding it to redis-py/RespClient + the K8s API.

    redis_client : anything with .llen/.lindex (redis-py or utils.resp.RespClient)
    scale_client : .read_replicas() -> int, .set_replicas(n) -> None
    clock        : time source; injectable so idle-threshold transitions can be
                   driven deterministically in tests
    """

    def __init__(self, redis_client, scale_client, cfg: ScalerConfig,
                 queue_key: str = "rag_service:requests", clock=time.time):
        self.redis = redis_client
        self.scale = scale_client
        self.cfg = cfg
        self.queue_key = queue_key
        self.clock = clock
        self._idle_start: float | None = None

    def step(self) -> int:
        """One autoscale cycle; returns the target replica count."""
        queue_size, wait_time = get_queue_metrics(
            self.redis, self.queue_key, clock=self.clock)
        now = self.clock()
        if queue_size == 0:
            self._idle_start = self._idle_start or now
        else:
            self._idle_start = None
        idle_seconds = now - self._idle_start if self._idle_start else 0.0

        current = self.scale.read_replicas()
        target = desired_replicas(queue_size, wait_time, current,
                                  idle_seconds, self.cfg)
        if target != current:
            print(f"scaling: {current} -> {target} "
                  f"(size={queue_size} wait={wait_time:.2f}s idle={idle_seconds:.0f}s)")
            self.scale.set_replicas(target)
        return target


class K8sScaleClient:
    """Production scale client: reads/patches the Deployment's replica count
    (reference behavior: deployment/auto_scaler.py:45-64)."""

    def __init__(self, apps_api, deployment: str, namespace: str):
        self.apps = apps_api
        self.deployment = deployment
        self.namespace = namespace

    def read_replicas(self) -> int:
        return self.apps.read_namespaced_deployment(
            name=self.deployment, namespace=self.namespace).spec.replicas

    def set_replicas(self, n: int) -> None:
        self.apps.patch_namespaced_deployment_scale(
            name=self.deployment, namespace=self.namespace,
            body={"spec": {"replicas": n}})


def autoscale_loop() -> None:
    from kubernetes import client, config

    config.load_incluster_config()
    apps = client.AppsV1Api()
    url = os.environ.get("REDIS_URL", "redis://redis-service:6379/0")
    try:
        import redis
        r = redis.from_url(url)
    except ImportError:  # degrade to the dependency-free RESP client
        from rag_serving_system.utils.resp import RespClient
        r = RespClient.from_url(url)

    controller = AutoscaleController(
        redis_client=r,
        scale_client=K8sScaleClient(
            apps,
            deployment=os.environ.get("DEPLOYMENT_NAME", "rag-service"),
            namespace=os.environ.get("NAMESPACE", "default")),
        cfg=ScalerConfig(),
        queue_key=os.environ.get("QUEUE_KEY", "rag_service:requests"))

    while True:
        try:
            controller.step()
        except Exception as e:
            print(f"autoscaler loop error: {e}")
        time.sleep(controller.cfg.check_interval)


if __name__ == "__main__":
    print("starting RAG service autoscaler")
    autoscale_loop()
