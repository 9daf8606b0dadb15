"""The port's HTTP/1.1 core on asyncio streams, server and client.

The reference serves its front, its metrics sidecars and the fleet hub's
routes through aiohttp, which the port does not depend on. This module
speaks the HTTP/1.1 subset those need: a request line, headers and a
``Content-Length`` (or chunked) body in; a ``Content-Length`` body, or a
chunked stream (the SSE answer, as aiohttp's ``StreamResponse`` sends
it), out; keep-alive between requests. :class:`RouteServer` maps
``(method, path)`` to a handler ``async (request, conn) -> Response``, with
``{name}`` path segments as ``request.match_info``; the OpenAI front
(``http/service.py``) and the metrics sidecar (``telemetry/server.py``)
are both route servers. :func:`http_get` is the client half the fleet
hub scrapes with.
"""

from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 409: "Conflict",
            500: "Internal Server Error", 501: "Not Implemented",
            502: "Bad Gateway", 503: "Service Unavailable"}
MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024


class Request:
    """One parsed HTTP request."""

    def __init__(self, method: str, path: str, headers: Dict[str, str],
                 body: bytes, query: Optional[Dict[str, str]] = None):
        self.method, self.path, self.headers, self.body = (
            method, path, headers, body)
        self.query = query or {}  # the last value of each query parameter
        self.match_info: Dict[str, str] = {}  # {name} path segments

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8") if self.body else "")


class Response:
    """A whole response: status, headers, body."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "application/json; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.body, self.status = body, status
        self.headers = {"Content-Type": content_type, **(headers or {})}


def json_response(obj: Any, status: int = 200,
                  headers: Optional[Dict[str, str]] = None,
                  default: Optional[Callable] = None) -> Response:
    return Response(json.dumps(obj, default=default).encode(), status,
                    headers=headers)


def _status_line(status: int) -> bytes:
    return f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n".encode()


class ClientGone(Exception):
    """The connection closed while a request was being read or answered."""


class StreamResponse:
    """A chunked response written as it is produced (the SSE stream)."""

    def __init__(self, conn: "Connection", headers: Dict[str, str]):
        self._conn = conn
        self.headers = headers
        self.status = 200

    async def prepare(self) -> None:
        self._conn.streaming = True
        head = _status_line(200) + b"".join(
            f"{k}: {v}\r\n".encode() for k, v in self.headers.items())
        await self._conn.send(head + b"Transfer-Encoding: chunked\r\n\r\n")

    async def write(self, data: bytes) -> None:
        if data:
            await self._conn.send(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        await self._conn.send(b"0\r\n\r\n")
        self._conn.streaming = False


async def _read_body(reader: asyncio.StreamReader,
                     headers: Dict[str, str]) -> bytes:
    if headers.get("transfer-encoding", "").lower() == "chunked":
        parts = []
        while True:
            size = int((await reader.readline()).split(b";")[0], 16)
            if size == 0:
                await reader.readline()
                break
            parts.append(await reader.readexactly(size))
            await reader.readexactly(2)
        return b"".join(parts)
    if "content-length" in headers:
        n = int(headers["content-length"])
        if n > MAX_BODY_BYTES:
            raise ValueError("body too large")
        return await reader.readexactly(n)
    return b""


def _parse_headers(lines) -> Dict[str, str]:
    headers: Dict[str, str] = {}
    for line in lines:
        if not line:
            continue
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    return headers


class Connection:
    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader, self.writer = reader, writer
        self.streaming = False  # a chunked answer's head went out

    async def send(self, data: bytes) -> None:
        """Write and drain; a peer that closed its side raises
        ``ConnectionResetError`` (the reference's aiohttp does the same)."""
        if self.writer.is_closing() or self.reader.at_eof():
            raise ConnectionResetError("client disconnected")
        self.writer.write(data)
        await self.writer.drain()

    async def read_request(self) -> Optional[Request]:
        try:
            head = await self.reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if e.partial.strip():
                raise ClientGone() from e
            return None
        except asyncio.LimitOverrunError as e:
            raise ValueError("request header too large") from e
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError as e:
            raise ValueError(f"bad request line {lines[0]!r}") from e
        headers = _parse_headers(lines[1:])
        try:
            body = await _read_body(self.reader, headers)
        except asyncio.IncompleteReadError as e:
            raise ClientGone() from e
        path, _, qs = target.partition("?")
        query = dict(urllib.parse.parse_qsl(qs, keep_blank_values=True))
        return Request(method.upper(), path, headers, body, query)


Handler = Callable[[Request, Connection], Awaitable[Any]]


def _match(pattern: str, path: str) -> Optional[Dict[str, str]]:
    """``/debug/trace/{rid}`` against a path → its segments, or None."""
    want, have = pattern.split("/"), path.split("/")
    if len(want) != len(have):
        return None
    out = {}
    for w, h in zip(want, have):
        if w.startswith("{") and w.endswith("}"):
            if not h:
                return None
            out[w[1:-1]] = urllib.parse.unquote(h)
        elif w != h:
            return None
    return out


class RouteServer:
    """Serves ``routes`` ((method, path pattern) → handler) on
    ``asyncio.start_server``; a handler returns a :class:`Response` or a
    :class:`StreamResponse` it already wrote."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.host = host
        self.port = port
        self.routes: Dict[Tuple[str, str], Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self.routes[(method.upper(), path)] = handler

    def _resolve(self, request: Request) -> Tuple[Optional[Handler], bool]:
        """The handler for a request (path segments filled in), and whether
        the path exists under another method."""
        handler = self.routes.get((request.method, request.path))
        if handler is not None:
            return handler, True
        known = False
        for (method, pattern), h in self.routes.items():
            info = (({} if pattern == request.path else None)
                    if "{" not in pattern else _match(pattern, request.path))
            if info is None:
                continue
            if method == request.method:
                request.match_info = info
                return h, True
            known = True
        return None, known

    # ---------- lifecycle ----------

    async def start(self) -> "RouteServer":
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port,
            limit=MAX_HEADER_BYTES)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop_accepting(self) -> None:
        """Close the listening socket but keep in-flight connections alive
        (the first phase of graceful shutdown: drain without accepting)."""
        if self._server is not None:
            self._server.close()
            self._server = None

    async def stop(self) -> None:
        await self.stop_accepting()
        tasks = list(self._conns)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    async def _serve_connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        conn = Connection(reader, writer)
        try:
            while True:
                try:
                    request = await conn.read_request()
                except ValueError as e:
                    await self._send(conn, error_response(400, str(e)), False)
                    return
                if request is None:
                    return
                keep = request.headers.get("connection", "").lower() != "close"
                handler, known = self._resolve(request)
                if handler is None:
                    resp = Response(
                        b"405: Method Not Allowed" if known else b"404: Not Found",
                        405 if known else 404, "text/plain; charset=utf-8")
                else:
                    try:
                        resp = await handler(request, conn)
                    except ConnectionResetError:
                        return
                    except Exception as e:  # noqa: BLE001 — the 500 answer
                        logger.exception("unhandled error in %s", request.path)
                        resp = error_response(500, str(e), "internal_error")
                if isinstance(resp, StreamResponse):
                    if not keep:
                        return
                    continue
                if conn.streaming:
                    # a failure after the stream's head went out: the
                    # connection cannot carry another answer
                    return
                await self._send(conn, resp, keep)
                if not keep:
                    return
        except (ClientGone, ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    @staticmethod
    async def _send(conn: Connection, resp: Response, keep: bool) -> None:
        headers = dict(resp.headers, **{
            "Content-Length": str(len(resp.body)),
            "Connection": "keep-alive" if keep else "close"})
        head = _status_line(resp.status) + b"".join(
            f"{k}: {v}\r\n".encode() for k, v in headers.items())
        await conn.send(head + b"\r\n" + resp.body)


def error_response(status: int, message: str,
                   err_type: str = "invalid_request_error") -> Response:
    """The OpenAI-shaped error body."""
    return json_response(
        {"error": {"message": message, "type": err_type, "code": status}},
        status=status)


class HttpError(Exception):
    """A non-2xx answer to :func:`http_get`."""

    def __init__(self, status: int, body: bytes):
        super().__init__(f"HTTP {status}: {body[:200]!r}")
        self.status = status
        self.body = body


async def http_get(url: str, timeout_s: float) -> bytes:
    """GET ``url`` (http only) on a fresh connection and return the body;
    raises :class:`HttpError` on a non-2xx status and
    ``asyncio.TimeoutError`` past ``timeout_s`` (connect, request and
    read together, as aiohttp's ``ClientTimeout(total=)``)."""
    parts = urllib.parse.urlsplit(url)
    if parts.scheme != "http":
        raise ValueError(f"http_get serves http:// URLs, not {url!r}")
    target = parts.path or "/"
    if parts.query:
        target += "?" + parts.query

    async def fetch() -> bytes:
        reader, writer = await asyncio.open_connection(
            parts.hostname, parts.port or 80, limit=MAX_HEADER_BYTES)
        try:
            writer.write(
                f"GET {target} HTTP/1.1\r\nHost: {parts.netloc}\r\n"
                "Connection: close\r\n\r\n".encode("latin-1"))
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            lines = head.decode("latin-1").split("\r\n")
            status = int(lines[0].split(" ", 2)[1])
            headers = _parse_headers(lines[1:])
            if ("content-length" in headers
                    or headers.get("transfer-encoding", "").lower() == "chunked"):
                body = await _read_body(reader, headers)
            else:
                body = await reader.read()  # until the server closes
        finally:
            writer.close()
        if not 200 <= status < 300:
            raise HttpError(status, body)
        return body

    return await asyncio.wait_for(fetch(), timeout_s)
