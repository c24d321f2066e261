"""HTTP surface (reference: rag_service/api/endpoints.py:14-75).

Same routes and response shapes as the reference's FastAPI app, served by
the standard library's asyncio (api/http.py):

- POST /rag                → {"request_id", "status": "processing"}
- GET  /rag/result/{id}    → {"status": "processing"} | {"status": "complete", "result": ...}
- GET  /health             → {"status": "healthy"}
- GET  /metrics            → Prometheus text exposition
- GET  /stats              → structured serving stats (JSON)

Validation mirrors FastAPI's: malformed bodies get HTTP 422 with error
details. The reference's /metrics route was never registered (missing `@` at
endpoints.py:47); here it is registered and extended with batch-pipeline
gauges fed by the BatchProcessor.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor

from rag_serving_system.api.http import (
    App,
    ServerThread,
    json_response,
    run_app,
    text_response,
)
from rag_serving_system.api.models import QueryRequest, ValidationError

__all__ = ["create_api", "run_app", "ServerThread"]


def _exposition(metrics: list[tuple[str, str, str, list]]) -> str:
    """Prometheus text format: (name, type, help, [(labels, value)])."""
    lines = []
    for name, kind, help_, samples in metrics:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in samples:
            lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
            lines.append(f"{name}{{{lab}}} {float(value)!r}" if lab
                         else f"{name} {float(value)!r}")
    return "\n".join(lines) + "\n"


def create_api(request_queue, processor=None, engine=None,
               max_queue_size: int = 0) -> App:
    """max_queue_size > 0 enables backpressure: POST /rag returns 503 once the
    queue holds that many requests (the reference accepts unboundedly and lets
    latency blow past the client timeout instead)."""
    app = App()
    # counters are touched only on the event-loop thread
    counts = {"accepted": 0, "rejected": 0}

    async def rag_endpoint(request):
        try:
            payload = QueryRequest.model_validate(request.json())
        except ValidationError as e:
            return json_response({"detail": e.errors()}, status=422)
        except ValueError as e:  # malformed JSON / encoding
            return json_response({"detail": str(e)}, status=422)
        if max_queue_size and request_queue.queue_size() >= max_queue_size:
            counts["rejected"] += 1
            return json_response(
                {"detail": "queue full", "status": "rejected"}, status=503)
        request_id = request_queue.add_request(payload.query, payload.k,
                                               payload.max_new_tokens)
        counts["accepted"] += 1
        # synchronous extension: POST /rag?wait=SECONDS holds the connection
        # and returns the COMPLETED result in this same exchange (one HTTP
        # round trip per request instead of POST + N result polls — on a
        # shared-core host the API layer's per-request cost drops ~3×).
        # Default wait=0 keeps the reference's async submit→poll protocol.
        try:
            wait = min(float(request.query.get("wait", 0)), 30.0)
        except ValueError:
            wait = 0.0
        if wait > 0:
            result = await _await_result(request_id, wait)
            if result is not None:
                return json_response(
                    {"request_id": request_id, "status": "complete",
                     "result": result})
        return json_response({"request_id": request_id, "status": "processing"})

    # in-memory backend: push notification → zero held threads per waiter,
    # so long-polls scale with the event loop instead of the pool size
    supports_push = hasattr(request_queue, "add_result_callback")
    # Redis get_result holds its worker thread up to 0.1 s per poll; a
    # dedicated wide pool keeps thousands of concurrent pollers from starving
    # the loop's default executor. The
    # push-capable in-memory backend never submits here, so don't build it.
    poll_pool = None if supports_push else ThreadPoolExecutor(
        max_workers=256, thread_name_prefix="result-poll")
    # Redis backend: each long wait blocks one pool thread for its full
    # duration, so long waiters are capped below the pool size — beyond the
    # cap a wait degrades to the reference's quick poll instead of queueing
    # unboundedly in the executor (which would hold connections far past
    # the advertised wait cap). The push backend holds no threads.
    long_wait_gate = None if supports_push else asyncio.Semaphore(192)

    async def _await_result(request_id: str, timeout: float):
        """Wait for a result: push-notified asyncio future on the in-memory
        backend (zero held threads), executor-poll on Redis."""
        if supports_push:
            loop = asyncio.get_running_loop()
            fut: asyncio.Future = loop.create_future()
            # runs on the processor thread — hop back to the event loop
            cb = lambda: loop.call_soon_threadsafe(  # noqa: E731
                lambda: fut.done() or fut.set_result(True))
            result = request_queue.add_result_callback(request_id, cb)
            if result is None:
                try:
                    await asyncio.wait_for(fut, timeout)
                except asyncio.TimeoutError:
                    pass
                finally:
                    # no-op after a successful notify (store popped the cb);
                    # required on timeout AND client-disconnect cancellation
                    request_queue.cancel_result_callback(request_id, cb)
                # pop whether notified or raced-at-timeout; the callback is
                # notification-only, so the result (if any) is still stored
                result = request_queue.get_result(request_id, timeout=0)
            return result
        if timeout > 0.5:
            if long_wait_gate.locked():  # saturated: degrade to quick poll
                timeout = 0.1
            else:
                async with long_wait_gate:
                    return await asyncio.get_running_loop().run_in_executor(
                        poll_pool,
                        lambda: request_queue.get_result(request_id, timeout))
        return await asyncio.get_running_loop().run_in_executor(
            poll_pool, lambda: request_queue.get_result(request_id, timeout))

    async def get_result(request):
        request_id = request.match_info["request_id"]
        # optional server-side long-poll (?timeout=SECONDS, capped at 30):
        # one held connection instead of 3-4 client poll round trips.
        # Default stays the reference's 0.1 s quick check.
        try:
            timeout = min(float(request.query.get("timeout", 0.1)), 30.0)
        except ValueError:
            timeout = 0.1
        result = await _await_result(request_id, timeout)
        if result is None:
            return json_response({"status": "processing"})
        return json_response({"status": "complete", "result": result})

    async def health_check(_):
        return json_response({"status": "healthy"})

    async def metrics(_):
        out = [
            ("rag_queue_size", "gauge", "Number of requests in queue",
             [({}, request_queue.queue_size())]),
            ("rag_queue_wait_time", "gauge",
             "Oldest-request wait time (seconds)",
             [({}, request_queue.oldest_wait_time())]),
            ("rag_last_batch_seconds", "gauge", "Wall time of the last batch",
             [({}, processor.last_batch_seconds if processor else 0.0)]),
            ("rag_requests_total", "counter", "Requests accepted",
             [({}, counts["accepted"])]),
            ("rag_requests_rejected_total", "counter",
             "Requests rejected by backpressure", [({}, counts["rejected"])]),
        ]
        if engine is not None:
            out.append(("rag_stage_seconds", "gauge",
                        "Mean seconds per pipeline stage",
                        [({"stage": st}, v["mean_s"])
                         for st, v in engine.timer.summary().items()]))
        # the native front counts its own accepts/rejects in C (the hot path
        # never touches the counters above) — export them at scrape time so
        # an operator's accepted/rejected view covers BOTH surfaces
        front = getattr(request_queue, "_front", None)  # FrontQueue proxy
        if front is not None:
            out.append(("rag_native_front", "gauge", "Native front counters",
                        [({"counter": n}, v) for n, v in front.stats().items()
                         if n != "port"]))
        return text_response(_exposition(out))

    async def stats(_):
        """Structured serving stats (stage timings, batch counters)."""
        body = {
            "queue_size": request_queue.queue_size(),
            "queue_wait_s": request_queue.oldest_wait_time(),
        }
        if processor is not None:
            body["batches_processed"] = processor.batches_processed
            body["requests_processed"] = processor.requests_processed
            body["last_batch_seconds"] = processor.last_batch_seconds
            # pipeline depth: batches staged by stage-1 workers awaiting
            # dispatch, and dispatched batches awaiting the finalize worker
            body["ready_backlog"] = getattr(processor, "ready_backlog", 0)
            body["finalize_backlog"] = getattr(processor, "finalize_backlog", 0)
        if engine is not None:
            body["stages"] = engine.timer.summary()
            body["packed_batches"] = getattr(engine, "packed_batches", 0)
            if getattr(engine, "prefix_cache", None) is not None:
                body["prefix_cache"] = engine.prefix_cache.stats()
            qstats = getattr(engine, "query_cache_stats", lambda: None)()
            if qstats is not None:
                body["query_cache"] = qstats
            pool = getattr(engine, "decode_pool", None)
            if pool is not None:
                body["decode_pool"] = pool.stats()
        front = getattr(request_queue, "_front", None)  # FrontQueue proxy
        if front is not None:
            body["native_front"] = front.stats()
        return json_response(body)

    app.add_post("/rag", rag_endpoint)
    app.add_get("/rag/result/{request_id}", get_result)
    app.add_get("/health", health_check)
    app.add_get("/metrics", metrics)
    app.add_get("/stats", stats)
    return app

