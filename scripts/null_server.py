"""Null RAG server: the API surface with a zero-cost backend.

Answers POST /rag instantly with a request id and GET /rag/result/<id> with a
completed result on the second poll (first poll returns "processing" so the
client exercises its real poll loop). No jax, no queue, no engine.

Purpose: measure the HOST-side ceiling of the measurement setup itself. On a
single-core host the load generator and the server share one CPU, so the
observed "max sustainable RPS" of the real server is bounded by
client+server CPU, not necessarily by the serving process. The null server
bounds that: whatever ladder rung fails against it would fail against ANY
server on this host.

Usage: python scripts/null_server.py [port]     (default 8009)
"""

from __future__ import annotations

import itertools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rag_serving_system.api.http import App, json_response, run_app  # noqa: E402

_counter = itertools.count()
_seen: set[str] = set()


async def rag(request):
    request.json()
    rid = f"null-{next(_counter)}"
    return json_response({"request_id": rid, "status": "processing"})


async def result(request):
    rid = request.match_info["request_id"]
    if rid not in _seen:
        # first poll: still processing (forces one real poll round-trip,
        # like a sub-poll-interval batch completion would)
        _seen.add(rid)
        return json_response({"status": "processing"})
    _seen.discard(rid)
    return json_response({"status": "complete", "result": {"result": "null"}})


async def health(_):
    return json_response({"status": "healthy"})


def main() -> None:
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8009
    app = App()
    app.add_post("/rag", rag)
    app.add_get("/rag/result/{request_id}", result)
    app.add_get("/health", health)
    run_app(app, host="0.0.0.0", port=port)


if __name__ == "__main__":
    main()
