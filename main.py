"""Composition root (reference: main.py:15-76).

Wires: Settings → data → engine (models + device corpus) → queue backend
(Redis iff REDIS_URL, reference main.py:35-49) → BatchProcessor thread →
asyncio HTTP app (api/endpoints.py, api/http.py; optional C++ epoll native
front). One process owns the accelerator; ROLE=api processes never import
JAX.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

logging.basicConfig(
    level=logging.INFO,
    format="%(asctime)s %(levelname)s %(name)s: %(message)s",
)
logger = logging.getLogger("main")


def build_app(settings=None, warmup: bool = True, role: str = "all"):
    """Build (app, processor, engine) — separated from main() for tests.

    `role` splits the service across PROCESSES for multi-core hosts (the
    GIL binds one process's HTTP parsing + queue work + host staging to one
    core; reference replicas sidestep this by duplicating the whole model):
      - "all"    — API + engine in one process (the reference's layout)
      - "api"    — HTTP front only: accepts requests into the shared Redis
                   queue and serves result polls; NO jax, NO model. Run N of
                   these with REUSE_PORT=1 behind one port.
      - "engine" — queue consumer only: owns the accelerator, drains the
                   Redis queue, stores results. No HTTP surface.
    api/engine roles require REDIS_URL (the queue is the IPC boundary —
    same wire contract the reference's multi-replica deployment uses)."""
    from rag_serving_system.backend import configure_xla_flags
    from rag_serving_system.config import get_settings
    from rag_serving_system.core.request_queue import make_queue
    from rag_serving_system.api.endpoints import create_api

    import os

    settings = settings or get_settings()
    if role == "api":
        if not settings.redis_url:
            raise SystemExit("ROLE=api requires REDIS_URL (shared queue)")
        request_queue = make_queue(settings)
        logger.info("role=api: queue backend %s, no engine in-process",
                    type(request_queue).__name__)
        app = create_api(request_queue, None, None,
                         max_queue_size=int(os.environ.get("MAX_QUEUE_SIZE", "0")))
        return app, None, None, settings
    if role == "engine" and not settings.redis_url:
        raise SystemExit("ROLE=engine requires REDIS_URL (shared queue)")

    configure_xla_flags()     # before this process first touches JAX
    from rag_serving_system.core.engine import RagEngine
    from rag_serving_system.core.batch_processor import BatchProcessor
    from rag_serving_system.parallel.mesh import make_mesh

    import jax

    from rag_serving_system.backend import require_platform, setup_compile_cache

    setup_compile_cache()
    if settings.platform:
        # fails if the backend is already up on another platform, or the
        # platform has no device: never serve on a platform not asked for
        require_platform(settings.platform)

    logger.info("loading corpus: %s", settings.document_text_file)
    with open(settings.document_text_file, "r", encoding="utf-8") as f:
        documents = json.load(f)
    doc_embeddings = np.load(settings.document_embeddings_file)
    logger.info("corpus: %d docs, embeddings %s", len(documents), doc_embeddings.shape)

    n_dev = len(jax.devices())
    mesh = make_mesh(settings.mesh_shape) if n_dev > 1 else None
    if mesh is not None:
        logger.info("mesh: %s over %d devices", dict(mesh.shape), n_dev)

    engine = RagEngine(settings, documents, doc_embeddings, mesh=mesh)
    if warmup:
        # compile EVERY batch bucket up front: at low traffic the batch
        # former produces in-between sizes (2, 4, ...), and an XLA compile
        # landing on a live request means a 60 s latency spike (observed as
        # a false p99-gate hit in the first load sweeps). The persistent
        # compile cache makes this cheap on restarts.
        logger.info("warming up compiled buckets %s...", engine.batch_buckets)
        engine.warmup(engine.batch_buckets)

    request_queue = make_queue(settings)
    logger.info("queue backend: %s", type(request_queue).__name__)

    # NATIVE_FRONT_PORT=N adds the C++ epoll listener (native/httpfront.cc):
    # the hot POST/poll path bypasses the asyncio server and the GIL. The queue
    # the processor sees is wrapped so front-owned results route back through
    # the native layer.
    front_port = int(os.environ.get("NATIVE_FRONT_PORT", "0"))
    if front_port and settings.redis_url:
        # a shared queue means ANOTHER replica may process a front-submitted
        # request; its result would land in that replica's Redis store while
        # this front's parked waiter never learns of it. Refuse loudly
        # instead of silently dropping results.
        raise SystemExit(
            "NATIVE_FRONT_PORT requires the in-memory queue (single-replica "
            "role=all); unset REDIS_URL or the front")
    if front_port:
        import atexit

        from rag_serving_system.api.native_front import NativeFront, FrontQueue

        # overload protection must carry over to the hot path: an operator
        # who configured MAX_QUEUE_SIZE expects backpressure on BOTH
        # surfaces, so the native inflight cap defaults to it when unset
        # (0 = unbounded, only if neither knob is set)
        max_inflight = int(os.environ.get(
            "NATIVE_FRONT_MAX_INFLIGHT",
            os.environ.get("MAX_QUEUE_SIZE", "0")))
        try:
            front = NativeFront(request_queue, port=front_port,
                                max_inflight=max_inflight).start()
        except RuntimeError as e:
            # no C++ toolchain / prebuilt .so: serve the asyncio surface
            # only rather than crashloop a pod that could still do useful work
            logger.warning("native front disabled: %s", e)
        else:
            atexit.register(front.stop)  # join the epoll thread on shutdown
            request_queue = FrontQueue(request_queue, front)

    processor = BatchProcessor(request_queue, engine,
                               polling_interval=min(settings.polling_interval, 0.05))
    processor.start()

    if role == "engine":
        logger.info("role=engine: consuming the shared queue, no HTTP surface")
        return None, processor, engine, settings

    app = create_api(request_queue, processor, engine,
                     max_queue_size=int(os.environ.get("MAX_QUEUE_SIZE", "0")))
    return app, processor, engine, settings


def main():
    import signal
    import threading

    from rag_serving_system.api.endpoints import run_app

    role = os.environ.get("ROLE", "all")
    app, processor, _, settings = build_app(role=role)
    if role == "engine":
        # headless queue consumer: block until SIGTERM/SIGINT, then drain
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        try:
            stop.wait()
        finally:
            logger.info("draining in-flight work before exit...")
            processor.stop(drain_timeout=float(os.environ.get("DRAIN_TIMEOUT", "30")))
        return
    try:
        # run_app returns on SIGTERM/SIGINT
        run_app(app, host=settings.host, port=settings.port,
                reuse_port=os.environ.get("REUSE_PORT", "0") in ("1", "true"))
    finally:
        if processor is not None:
            # K8s sends SIGTERM before killing the pod: drain the in-flight
            # batch (plus one prefetched batch) so accepted requests get
            # their results delivered before exit. Requests still in the
            # queue survive in Redis for the replacement replica.
            logger.info("draining in-flight work before exit...")
            processor.stop(drain_timeout=float(os.environ.get("DRAIN_TIMEOUT", "30")))


if __name__ == "__main__":
    main()
