"""Minimal HTTP/1.1 server on the standard library's asyncio.

Just what the serving surface needs: routing by method and path (with
`{name}` path parameters), query strings, JSON bodies with Content-Length,
keep-alive, and a background-thread runner for tests and embedding. The
handlers are coroutines `async def handler(request) -> Response`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import signal
import socket
import threading
from urllib.parse import parse_qsl, urlsplit

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 1 << 20        # a /rag body is a query string and two ints
MAX_HEADER_LINES = 100

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            422: "Unprocessable Entity", 500: "Internal Server Error",
            503: "Service Unavailable"}


class Request:
    def __init__(self, method: str, path: str, query: dict, headers: dict,
                 body: bytes, match_info: dict):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.match_info = match_info

    def json(self):
        """Parsed JSON body; raises ValueError on malformed JSON."""
        return json.loads(self.body.decode("utf-8"))


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "application/json"):
        self.body = body
        self.status = status
        self.content_type = content_type


def json_response(obj, status: int = 200) -> Response:
    return Response(json.dumps(obj).encode("utf-8"), status=status)


def text_response(text: str, status: int = 200) -> Response:
    return Response(text.encode("utf-8"), status=status,
                    content_type="text/plain; version=0.0.4; charset=utf-8")


class App:
    """Route table: `add_get("/rag/result/{request_id}", handler)`."""

    def __init__(self):
        self._routes: list[tuple[str, re.Pattern, object]] = []

    def _add(self, method: str, path: str, handler) -> None:
        pattern = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", path)
        self._routes.append((method, re.compile(f"^{pattern}$"), handler))

    def add_get(self, path: str, handler) -> None:
        self._add("GET", path, handler)

    def add_post(self, path: str, handler) -> None:
        self._add("POST", path, handler)

    async def handle(self, request: Request) -> Response:
        allowed = False
        for method, pattern, handler in self._routes:
            m = pattern.match(request.path)
            if m is None:
                continue
            if method != request.method:
                allowed = True
                continue
            request.match_info = m.groupdict()
            return await handler(request)
        if allowed:
            return json_response({"detail": "method not allowed"}, status=405)
        return json_response({"detail": "not found"}, status=404)


async def _read_request(reader: asyncio.StreamReader):
    """Parse one request. Returns (Request, keep_alive), None at EOF, or a
    Response to send before closing when the request is malformed."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        return json_response({"detail": "malformed request line"}, 400)
    method, target, version = parts
    headers: dict[str, str] = {}
    for _ in range(MAX_HEADER_LINES):
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    else:
        return json_response({"detail": "too many headers"}, 400)
    if "chunked" in headers.get("transfer-encoding", "").lower():
        return json_response({"detail": "chunked bodies not supported"}, 400)
    try:
        length = int(headers.get("content-length", "0") or 0)
    except ValueError:
        return json_response({"detail": "bad content-length"}, 400)
    if length < 0 or length > MAX_BODY_BYTES:
        return json_response({"detail": "body too large"}, 413)
    body = await reader.readexactly(length) if length else b""
    url = urlsplit(target)
    conn = headers.get("connection", "").lower()
    keep_alive = (conn != "close" if version == "HTTP/1.1"
                  else conn == "keep-alive")
    return (Request(method.upper(), url.path, dict(parse_qsl(url.query)),
                    headers, body, {}), keep_alive)


def _encode(resp: Response, keep_alive: bool) -> bytes:
    head = (f"HTTP/1.1 {resp.status} {_REASONS.get(resp.status, 'Unknown')}\r\n"
            f"Content-Type: {resp.content_type}\r\n"
            f"Content-Length: {len(resp.body)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n")
    return head.encode("latin-1") + resp.body


def _connection_handler(app: App):
    async def handle(reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                parsed = await _read_request(reader)
                if parsed is None:
                    break
                if isinstance(parsed, Response):
                    writer.write(_encode(parsed, False))
                    await writer.drain()
                    break
                request, keep_alive = parsed
                try:
                    resp = await app.handle(request)
                except Exception:  # noqa: BLE001 — a handler bug is a 500
                    logger.exception("handler failed: %s %s", request.method,
                                     request.path)
                    resp = json_response({"detail": "internal error"}, 500)
                writer.write(_encode(resp, keep_alive))
                await writer.drain()
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass  # peer went away, or a line longer than the stream limit
        finally:
            writer.close()

    return handle


async def start_server(app: App, host: str, port: int,
                       reuse_port: bool = False) -> asyncio.base_events.Server:
    return await asyncio.start_server(
        _connection_handler(app), host, port, reuse_address=True,
        reuse_port=reuse_port or None, family=socket.AF_INET, backlog=1024)


def run_app(app: App, host: str, port: int, reuse_port: bool = False) -> None:
    """Serve until SIGTERM or SIGINT, then return (the caller drains)."""

    async def main() -> None:
        server = await start_server(app, host, port, reuse_port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        logger.info("serving HTTP on %s:%d", host, port)
        async with server:
            await stop.wait()

    asyncio.run(main())


class ServerThread:
    """Run an App on a background thread with its own event loop."""

    def __init__(self, app: App, host: str = "127.0.0.1", port: int = 0):
        self.app = app
        self.host = host
        self.port = port
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._server = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._server = self._loop.run_until_complete(
            start_server(self.app, self.host, self.port))
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        self._loop.run_forever()
        # stop listening, then cancel the open connections (keep-alive
        # clients and long-polls) instead of waiting for them to hang up
        self._server.close()
        tasks = asyncio.all_tasks(self._loop)
        for t in tasks:
            t.cancel()
        self._loop.run_until_complete(
            asyncio.gather(*tasks, return_exceptions=True))
        self._loop.close()

    def start(self) -> "ServerThread":
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("HTTP server did not start within 30 s")
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
