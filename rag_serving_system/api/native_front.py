"""Python side of the native HTTP front (native/httpfront.cc).

The C++ epoll thread owns accept/parse/respond; Python's involvement per
request is two cheap touches:

- a drain thread pulls accepted requests in ONE ctypes call per wakeup
  (packed binary records) and puts them on the in-process RequestQueue with
  the front-assigned ``nf-…`` ids;
- :class:`FrontQueue` wraps the queue handed to the BatchProcessor so
  ``store_result`` for a front-owned id becomes ONE ctypes call
  (json.dumps + memcpy) instead of the event-loop hop + asyncio write the
  Python surface pays.

Both ctypes calls release the GIL for their C duration, so the connection
byte-shuffling genuinely runs in parallel with the dispatch thread even on
CPython. The asyncio app keeps serving /stats, /metrics and the reference's
async protocol on its own port; the native front is an additional listener
(NATIVE_FRONT_PORT) for the hot POST/poll path.

Reference counterpart: the uvicorn/FastAPI front tier
(reference main.py:72-76, api/endpoints.py:14-75).
"""

from __future__ import annotations

import ctypes
import json
import logging
import struct
import threading

logger = logging.getLogger(__name__)

_DRAIN_BUF_BYTES = 1 << 20
_REC_HEADER = struct.Struct("<HIII")  # id_len, k, max_new_tokens(0=dflt), query_len


class NativeFront:
    """Owns the native listener + the drain thread. One instance per process
    (the C library is a singleton)."""

    def __init__(self, request_queue, port: int = 0, max_inflight: int = 0):
        from rag_serving_system.native import get_httpfront_lib

        self._lib = get_httpfront_lib()
        if self._lib is None:
            raise RuntimeError("native HTTP front unavailable (no C++ toolchain)")
        self._queue = request_queue
        self._want_port = port
        self._max_inflight = max_inflight
        self._buf = ctypes.create_string_buffer(_DRAIN_BUF_BYTES)
        self._thread: threading.Thread | None = None
        self._running = False
        self.port: int | None = None

    def start(self) -> "NativeFront":
        port = self._lib.httpfront_start(self._want_port, self._max_inflight)
        if port < 0:
            raise RuntimeError(
                f"native front failed to bind port {self._want_port}")
        self.port = port
        buf = ctypes.create_string_buffer(32)
        n = self._lib.httpfront_id_prefix(buf, 32)
        # ids minted by THIS front ("nf-<tag>-…"): only these may be routed
        # back through httpfront_complete — an nf- id with a foreign tag
        # (another replica via a shared Redis queue, or a restarted front)
        # has no waiter here and belongs in the wrapped queue's result store
        self.id_prefix = buf.raw[:n].decode("ascii")
        self._running = True
        self._thread = threading.Thread(target=self._drain_loop,
                                        name="front-drain", daemon=True)
        self._thread.start()
        logger.info("native HTTP front listening on :%d", port)
        return self

    def stop(self) -> None:
        self._running = False
        self._lib.httpfront_stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _drain_loop(self) -> None:
        # ctypes releases the GIL during httpfront_drain, which blocks on a
        # condvar until the epoll thread accepts work — this thread costs
        # nothing while idle and wakes once per burst, not per request.
        lib, buf = self._lib, self._buf
        put = self._queue.add_request_with_id
        while self._running:
            n = lib.httpfront_drain(buf, _DRAIN_BUF_BYTES, 200)
            if n < 0:
                break  # front stopped
            if n == 0:
                continue
            off = 0
            raw = ctypes.string_at(buf, n)  # copy only the filled bytes
            while off < n:
                id_len, k, mnt, q_len = _REC_HEADER.unpack_from(raw, off)
                off += _REC_HEADER.size
                rid = raw[off:off + id_len].decode("ascii")
                off += id_len
                query = raw[off:off + q_len].decode("utf-8", errors="replace")
                off += q_len
                # a transient enqueue failure (e.g. a dropped Redis
                # connection) must not kill the drain thread — and the front
                # has already accepted this request (client told "processing"
                # or parked on ?wait), so deliver a synthetic error completion:
                # the waiter is released immediately instead of timing out and
                # the C-side inflight counter is decremented (otherwise, with
                # NATIVE_FRONT_MAX_INFLIGHT set, repeated enqueue failures
                # would leak capacity toward permanent 503s)
                try:
                    put(rid, query, k, mnt if mnt > 0 else None)
                except Exception:  # noqa: BLE001
                    logger.exception("native front enqueue failed for %s", rid)
                    try:
                        self.complete(rid, {"error": "enqueue failed",
                                            "status": "failed"})
                    except Exception:  # noqa: BLE001
                        logger.exception("error completion failed for %s", rid)

    def complete(self, request_id: str, result) -> None:
        payload = json.dumps(result).encode("utf-8")
        rid = request_id.encode("ascii")
        self._lib.httpfront_complete(rid, len(rid), payload, len(payload))

    def stats(self) -> dict:
        out = (ctypes.c_longlong * 5)()
        self._lib.httpfront_stats(out)
        return {"accepted": out[0], "completed": out[1], "rejected": out[2],
                "bad_requests": out[3], "inflight": out[4], "port": self.port}


class FrontQueue:
    """Queue proxy handed to the BatchProcessor and the asyncio app: identical
    to the wrapped queue except results for front-owned ids (``nf-`` prefix)
    are delivered through the native front instead of the Python result store."""

    def __init__(self, inner, front: NativeFront):
        self._inner = inner
        self._front = front

    def store_result(self, request_id: str, result) -> None:
        if request_id.startswith(self._front.id_prefix):
            self._front.complete(request_id, result)
        else:
            self._inner.store_result(request_id, result)

    def __getattr__(self, name):  # everything else delegates
        return getattr(self._inner, name)
