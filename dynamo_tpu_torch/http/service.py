"""OpenAI-compatible HTTP frontend on ``asyncio.start_server``.

The port's copy of ``dynamo_tpu/http/service.py`` (``ModelManager``,
``HttpService``). The reference serves through aiohttp, which the port
does not depend on; this module speaks the HTTP/1.1 subset the routes
need itself: a request line, headers and a ``Content-Length`` (or chunked)
body in; a ``Content-Length`` JSON body, or an SSE stream sent with
``Transfer-Encoding: chunked`` (as aiohttp's ``StreamResponse`` sends it),
out; keep-alive between requests. The status codes and error bodies are
the reference's.

Routes: POST /v1/chat/completions, POST /v1/completions, POST
/v1/embeddings (served by an engine that carries an ``embedder``, else
501), GET /v1/models, GET /metrics, GET /health, and POST
/admin/drain[?mode=migrate|fail][&respawn=1] (the rolling update through
the ``drainer`` the CLI's ``--self-heal`` attaches, a recovery
controller's ``admin_drain``; 501 without one). A client that goes away
mid-stream stops its request; a draining engine's request is a 503 with
Retry-After.

Discovery (the reference's ``register_model`` / ``ModelWatcher``): a
worker or processor registers its model under the discovery plane's
``{namespace}/models/`` prefix, lease-scoped, and a frontend's
``ModelWatcher`` adds a routed ``Client`` for each registration and drops
it when the registration goes (the worker's lease expired). Not ported
yet: the model registry's fleet cards (``register_model``'s ``card``, so
aliases, tenants and per-model pools), admission, quotas and pools, the
/debug and /fleet routes, and /admin's model management.
"""

from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse
from typing import Any, AsyncIterator, Dict, Optional, Tuple

from ..protocols import sse
from ..protocols.annotated import Annotated
from ..protocols.openai import (
    ChatCompletionChunk,
    ChatCompletionRequest,
    CompletionRequest,
    CompletionResponse,
    ModelInfo,
    ModelList,
    aggregate_chat_stream,
    aggregate_completion_stream,
)
from ..runtime.client import Client, RouterMode
from ..runtime.discovery import WatchEventType
from ..runtime.engine import (
    AsyncEngine,
    AsyncEngineContext,
    Context,
    EngineDrainingError,
    EngineError,
)
from ..runtime.wire import packb, unpackb
from .metrics import ServiceMetrics

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 500: "Internal Server Error",
            501: "Not Implemented", 502: "Bad Gateway",
            503: "Service Unavailable"}
MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024
MODEL_REGISTRY_PREFIX = "models/"  # under the http namespace


class ModelManager:
    """name → engine maps for chat and completion models."""

    def __init__(self) -> None:
        self.chat_engines: Dict[str, AsyncEngine] = {}
        self.completion_engines: Dict[str, AsyncEngine] = {}
        self.metadata: Dict[str, dict] = {}  # name → /v1/models extras

    def set_metadata(self, name: str, **meta) -> None:
        self.metadata.setdefault(name, {}).update(
            {k: v for k, v in meta.items() if v is not None}
        )

    def add_chat_model(self, name: str, engine: AsyncEngine) -> None:
        self.chat_engines[name] = engine

    def add_completion_model(self, name: str, engine: AsyncEngine) -> None:
        self.completion_engines[name] = engine

    def remove_model(self, name: str) -> None:
        self.chat_engines.pop(name, None)
        self.completion_engines.pop(name, None)
        self.metadata.pop(name, None)  # a re-registration starts clean

    def resolve(self, model: str) -> Optional[str]:
        """Requested name → served name, or None."""
        if model in self.chat_engines or model in self.completion_engines:
            return model
        return None

    def model_names(self) -> list:
        return sorted(set(self.chat_engines) | set(self.completion_engines))


class Request:
    """One parsed HTTP request."""

    def __init__(self, method: str, path: str, headers: Dict[str, str],
                 body: bytes, query: Optional[Dict[str, str]] = None):
        self.method, self.path, self.headers, self.body = (
            method, path, headers, body)
        self.query = query or {}  # the last value of each query parameter

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
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(json.dumps(obj).encode(), status, headers=headers)


def _status_line(status: int) -> bytes:
    return f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n".encode()


class _ClientGone(Exception):
    """The connection closed while a request was being read or answered."""


class StreamResponse:
    """A chunked response written as it is produced (the SSE stream)."""

    def __init__(self, conn: "_Connection", headers: Dict[str, str]):
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


class _Connection:
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
                raise _ClientGone() from e
            return None
        except asyncio.LimitOverrunError as e:
            raise ValueError("request header too large") from e
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError as e:
            raise ValueError(f"bad request line {lines[0]!r}") from e
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        body = b""
        try:
            if headers.get("transfer-encoding", "").lower() == "chunked":
                parts = []
                while True:
                    size = int((await self.reader.readline()).split(b";")[0], 16)
                    if size == 0:
                        await self.reader.readline()
                        break
                    parts.append(await self.reader.readexactly(size))
                    await self.reader.readexactly(2)
                body = b"".join(parts)
            elif "content-length" in headers:
                n = int(headers["content-length"])
                if n > MAX_BODY_BYTES:
                    raise ValueError("request body too large")
                body = await self.reader.readexactly(n)
        except asyncio.IncompleteReadError as e:
            raise _ClientGone() from e
        path, _, qs = target.partition("?")
        query = dict(urllib.parse.parse_qsl(qs, keep_blank_values=True))
        return Request(method.upper(), path, headers, body, query)


class HttpService:
    def __init__(
        self,
        manager: Optional[ModelManager] = None,
        host: str = "0.0.0.0",
        port: int = 8080,
        metrics_prefix: str = "dynamo",
    ):
        self.manager = manager or ModelManager()
        self.host = host
        self.port = port
        self.metrics = ServiceMetrics(metrics_prefix)
        self.routes = {
            ("POST", "/v1/chat/completions"): self.handle_chat,
            ("POST", "/v1/completions"): self.handle_completions,
            ("POST", "/v1/embeddings"): self.handle_embeddings,
            ("GET", "/v1/models"): self.handle_models,
            ("GET", "/metrics"): self.handle_metrics,
            ("GET", "/health"): self.handle_health,
            ("POST", "/admin/drain"): self.handle_admin_drain,
        }
        # zero-downtime rolling updates: drain and live-migrate the in-flight
        # requests to peers (recovery/controller.py). Set by the CLI when
        # --self-heal builds a RecoveryController; /admin/drain is 501 without
        self.drainer = None  # async (mode, respawn) -> summary dict
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    # ---------- lifecycle ----------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port,
            limit=MAX_HEADER_BYTES)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        logger.info("http service on %s:%d", self.host, self.port)

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
        conn = _Connection(reader, writer)
        try:
            while True:
                try:
                    request = await conn.read_request()
                except ValueError as e:
                    await self._send(conn, self._error(400, str(e)), False)
                    return
                if request is None:
                    return
                keep = request.headers.get("connection", "").lower() != "close"
                handler = self.routes.get((request.method, request.path))
                if handler is None:
                    known = any(p == request.path for _, p in self.routes)
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
                        resp = self._error(500, str(e), "internal_error")
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
        except (_ClientGone, ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    @staticmethod
    async def _send(conn: _Connection, resp: Response, keep: bool) -> None:
        headers = dict(resp.headers, **{
            "Content-Length": str(len(resp.body)),
            "Connection": "keep-alive" if keep else "close"})
        head = _status_line(resp.status) + b"".join(
            f"{k}: {v}\r\n".encode() for k, v in headers.items())
        await conn.send(head + b"\r\n" + resp.body)

    # ---------- helpers ----------

    @staticmethod
    def _error(status: int, message: str, err_type: str = "invalid_request_error"):
        return json_response(
            {"error": {"message": message, "type": err_type, "code": status}},
            status=status,
        )

    @staticmethod
    def _model_not_found(model: str):
        """The OpenAI 404 body."""
        return json_response(
            {"error": {
                "message": f"The model '{model}' does not exist or you "
                           "do not have access to it.",
                "type": "invalid_request_error",
                "param": "model",
                "code": "model_not_found",
            }},
            status=404,
        )

    async def _handle_inference(
        self, request: Request, conn: _Connection, request_cls,
        engines: Dict[str, AsyncEngine], chunk_cls, aggregate,
    ):
        try:
            body = request.json()
            api_req = request_cls.model_validate(body)
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
            return self._error(400, f"invalid request: {e}")

        name = self.manager.resolve(api_req.model)
        if name is None:
            return self._model_not_found(api_req.model)
        engine = engines.get(name)
        if engine is None:
            return self._model_not_found(api_req.model)
        rid = (request.headers.get("x-request-id") or "").strip()[:128]
        timer = self.metrics.track(name)
        status = "error"
        # the client's X-Request-Id is the trace id (correlation only: the
        # engine-side request id stays a fresh UUID)
        ctx = Context(api_req, AsyncEngineContext(trace_id=rid or None))
        ctx.add_stage("http")
        try:
            stream = engine.generate(ctx).__aiter__()
            # prime the first chunk BEFORE committing a status line so
            # request-validation errors (raised on first iteration of the
            # pipeline generator) still map to proper HTTP codes
            try:
                first = await stream.__anext__()
            except StopAsyncIteration:
                first = None
            if api_req.stream:
                resp, status = await self._stream_sse(conn, ctx, first, stream,
                                                      timer)
                return resp

            def _check_annotated(chunk):
                """None for data chunks; the envelope for annotations.
                Error envelopes raise — a swallowed error must not look ok."""
                ann = Annotated.maybe_from_wire(chunk)
                if ann is not None and ann.is_error:
                    raise EngineError(
                        ann.comment[0] if ann.comment else "engine error"
                    )
                return ann

            chunks = []
            if first is not None and _check_annotated(first) is None:
                chunks.append(chunk_cls.model_validate(_as_dict(first)))
            async for chunk in stream:
                if _check_annotated(chunk) is not None:
                    continue  # annotations are stream-only side channel
                d = _as_dict(chunk)
                if _has_payload(d):
                    timer.token(_payload_tokens(d))
                chunks.append(chunk_cls.model_validate(d))
            status = "success"
            return json_response(
                aggregate(chunks).model_dump(exclude_none=True),
                headers={"X-Request-Id": ctx.trace_id},
            )
        except EngineDrainingError as e:
            return json_response(
                {"error": {"message": str(e), "type": "service_unavailable",
                           "code": 503}},
                status=503, headers={"Retry-After": "1"},
            )
        except (EngineError, ValueError) as e:
            return self._error(400, str(e))
        except asyncio.TimeoutError as e:
            return self._error(502, str(e), "engine_error")
        except _StreamDisconnect:
            status = "disconnect"
            raise ConnectionResetError("client disconnected")
        except asyncio.CancelledError:
            ctx.context.stop_generating()
            status = "disconnect"
            raise
        finally:
            ctx.context.stop_generating()
            timer.finish(status)

    async def _stream_sse(
        self,
        conn: _Connection,
        ctx: Context,
        first: Any,
        chunks: AsyncIterator[Any],
        timer,
    ) -> Tuple[StreamResponse, str]:
        resp = StreamResponse(conn, {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
            "X-Request-Id": ctx.trace_id,
        })

        async def _write(chunk) -> bool:
            """Write one stream element; True = stream must terminate."""
            ann = Annotated.maybe_from_wire(chunk)
            if ann is not None:
                if ann.is_error:
                    # error payload on a data line, then end the stream
                    await resp.write(sse.encode_event(
                        {"error": {"message": ann.comment[0] if ann.comment
                                   else "engine error"}}
                    ))
                    return True
                # annotation events ride SSE event/comment lines with no
                # data payload (reference annotated.rs wire mapping)
                await resp.write(sse.encode_event(
                    None, event=ann.event,
                    comment=ann.comment[0] if ann.comment else None,
                ))
                return False
            d = _as_dict(chunk)
            if _has_payload(d):
                timer.token(_payload_tokens(d))
            await resp.write(sse.encode_event(d))
            return False

        try:
            await resp.prepare()
            failed = first is not None and await _write(first)
            if not failed:
                async for chunk in chunks:
                    if await _write(chunk):
                        failed = True
                        break
            await resp.write(sse.encode_done())
            await resp.write_eof()
            if failed:
                ctx.context.stop_generating()
                return resp, "error"
            return resp, "success"
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            # client went away — stop generation upstream
            ctx.context.stop_generating()
            raise _StreamDisconnect()
        except EngineError as e:
            # mid-stream failure: emit an error event, then end the stream
            await resp.write(sse.encode_event({"error": {"message": str(e)}}))
            await resp.write(sse.encode_done())
            await resp.write_eof()
            return resp, "error"

    # ---------- routes ----------

    async def handle_chat(self, request: Request, conn: _Connection):
        return await self._handle_inference(
            request, conn, ChatCompletionRequest, self.manager.chat_engines,
            ChatCompletionChunk, aggregate_chat_stream,
        )

    async def handle_completions(self, request: Request, conn: _Connection):
        return await self._handle_inference(
            request, conn, CompletionRequest, self.manager.completion_engines,
            CompletionResponse, aggregate_completion_stream,
        )

    async def handle_embeddings(self, request: Request, conn: _Connection):
        """POST /v1/embeddings: the prefill-only workload
        (``llm/embeddings.py``), OpenAI-shaped request (input: str | [str] |
        [ids] | [[ids]]) and response (data rows + usage counts). Served
        when the resolved engine carries an ``embedder``; engines without
        one (the echo chat engine, a frontend of discovered models) answer
        501, as in the reference."""
        import base64

        import numpy as np

        from ..llm.embeddings import EmbeddingError

        try:
            body = request.json()
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            return self._error(400, f"invalid request: {e}")
        if not isinstance(body, dict):
            return self._error(400, "request body must be a JSON object")
        model = body.get("model")
        if not isinstance(model, str) or not model:
            return self._error(400, "missing model")
        if "input" not in body:
            return self._error(400, "missing input")
        fmt = body.get("encoding_format", "float")
        if fmt not in ("float", "base64"):
            return self._error(
                400, "encoding_format must be 'float' or 'base64'")
        name = self.manager.resolve(model)
        if name is None:
            return self._model_not_found(model)
        engine = (self.manager.chat_engines.get(name)
                  or self.manager.completion_engines.get(name))
        embedder = getattr(engine, "embedder", None)
        if embedder is None:
            return self._error(
                501,
                f"model '{model}' does not serve embeddings on this "
                "frontend (embeddings ride the prefill path — route to "
                "a prefill-pool frontend)",
                err_type="not_implemented",
            )
        try:
            vectors, ntok = await embedder.embed(body["input"])
        except EmbeddingError as e:
            return self._error(400, str(e))
        data = []
        for i, vec in enumerate(vectors):
            emb = (base64.b64encode(np.asarray(vec, np.float32).tobytes()
                                    ).decode("ascii")
                   if fmt == "base64" else vec)
            data.append({"object": "embedding", "index": i, "embedding": emb})
        return json_response({
            "object": "list",
            "data": data,
            "model": model,
            "usage": {"prompt_tokens": ntok, "total_tokens": ntok},
        })

    async def handle_models(self, request: Request, conn: _Connection):
        data = [ModelInfo(id=name, **self.manager.metadata.get(name, {}))
                for name in self.manager.model_names()]
        return json_response(ModelList(data=data).model_dump(exclude_none=True))

    async def handle_metrics(self, request: Request, conn: _Connection):
        return Response(self.metrics.render().encode(),
                        content_type="text/plain; charset=utf-8")

    async def handle_health(self, request: Request, conn: _Connection):
        return json_response(
            {"status": "ok", "models": self.manager.model_names()})


    async def handle_admin_drain(self, request: Request, conn: _Connection):
        """POST /admin/drain[?mode=migrate|fail][&respawn=1]: stop
        admission, let committed bursts finish, live-migrate the rest to
        healthy peers and (optionally) respawn. Returns the drain's summary
        (requests finished, migrated and failed; seconds)."""
        if self.drainer is None:
            return json_response({"error": "no recovery controller attached "
                                           "(serve with --self-heal)"},
                                 status=501)
        mode = request.query.get("mode", "migrate")
        if mode not in ("migrate", "fail"):
            return json_response({"error": f"bad mode {mode!r}"}, status=400)
        respawn = request.query.get("respawn") in ("1", "true", "yes")
        return json_response(await self.drainer(mode=mode, respawn=respawn))


class _StreamDisconnect(Exception):
    """Internal: SSE client went away mid-stream."""


def _as_dict(chunk: Any) -> Any:
    if hasattr(chunk, "model_dump"):
        return chunk.model_dump(exclude_none=True)
    return chunk


def _payload_tokens(chunk: Any) -> int:
    """Token count of one payload chunk: token-level shapes expose
    token_ids; OpenAI chat/completions chunks carry one token each."""
    if isinstance(chunk, dict) and isinstance(chunk.get("token_ids"), list):
        return len(chunk["token_ids"])
    return 1


def _has_payload(chunk: Any) -> bool:
    """True if the chunk carries generated content (TTFT should fire)."""
    if not isinstance(chunk, dict):
        return True
    for choice in chunk.get("choices", []):
        if (choice.get("delta") or {}).get("content") or choice.get("text"):
            return True
    return False


# ---------- model registry + discovery watcher ----------


def model_registry_key(namespace: str, model_type: str, name: str) -> str:
    return f"{namespace}/{MODEL_REGISTRY_PREFIX}{model_type}/{name}"


async def register_model(
    drt,
    namespace: str,
    name: str,
    endpoint_path: str,
    model_type: str = "chat",
    mdc: Optional[dict] = None,
    lease_scoped: bool = True,
) -> None:
    """Register a served model in the discovery plane (llmctl analog).

    ``endpoint_path`` is a dyn://ns.comp.ep address whose workers accept
    OpenAI-level requests (preprocessing is worker-side, as in the
    reference's v0.1.1 layout). The reference's ``card`` (the fleet card
    of its model registry) is not taken: the registry is not ported.
    """
    entry = {"name": name, "endpoint": endpoint_path, "model_type": model_type}
    if mdc:
        entry["mdc"] = mdc
    lease = await drt.discovery.primary_lease() if lease_scoped else None
    await drt.discovery.kv_put(
        model_registry_key(namespace, model_type, name),
        packb(entry),
        lease_id=lease.id if lease else None,
    )


async def list_models(drt, namespace: str) -> list:
    kvs = await drt.discovery.kv_get_prefix(f"{namespace}/{MODEL_REGISTRY_PREFIX}")
    return [unpackb(v) for v in kvs.values()]


def parse_endpoint_path(path: str):
    """'dyn://ns.comp.ep' → (ns, comp, ep)."""
    body = path[len("dyn://"):] if path.startswith("dyn://") else path
    parts = body.split(".")
    if len(parts) != 3:
        raise ValueError(f"bad endpoint path {path!r}; want dyn://ns.comp.ep")
    return parts[0], parts[1], parts[2]


class ModelWatcher:
    """Hot-add/remove models from discovery-plane registrations. The
    reference's fleet cards (aliases, tenants, per-model pools) are left
    out: every registration serves the whole endpoint, as a card-less one
    does there."""

    def __init__(
        self,
        drt,
        manager: ModelManager,
        namespace: str = "public",
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
    ):
        self.drt = drt
        self.manager = manager
        self.namespace = namespace
        self.router_mode = router_mode
        self._clients: Dict[str, Client] = {}
        self._task: Optional[asyncio.Task] = None
        self._watcher = None
        # strong refs to in-flight client.close() tasks spawned from the
        # sync delete path: a bare ensure_future can be GC'd mid-close
        # and would drop any close() exception on the floor
        self._closing: set = set()

    async def start(self) -> None:
        prefix = f"{self.namespace}/{MODEL_REGISTRY_PREFIX}"
        snapshot, watcher = await self.drt.discovery.watch_prefix(prefix)
        self._watcher = watcher
        for key, value in snapshot.items():
            await self._handle_put(key, value)
        self._task = self.drt.runtime.spawn(self._loop(watcher))

    async def _loop(self, watcher) -> None:
        async for ev in watcher:
            try:
                if ev.type == WatchEventType.PUT:
                    await self._handle_put(ev.key, ev.value)
                else:
                    self._handle_delete(ev.key)
            except Exception:
                logger.exception("model watcher failed on %s", ev.key)

    async def _handle_put(self, key: str, value: bytes) -> None:
        entry = unpackb(value)
        name = entry["name"]
        ns, comp, ep = parse_endpoint_path(entry["endpoint"])
        endpoint = self.drt.namespace(ns).component(comp).endpoint(ep)
        client = await Client(endpoint, self.router_mode).start()
        previous = self._clients.pop(name, None)
        if previous is not None:
            # re-registration PUT: release the old client's watch task
            # instead of leaking one per worker churn event
            await previous.close()
        # start clean: a narrowed model_type must not leave the closed
        # client behind in the other engine map, nor stale metadata
        self.manager.remove_model(name)
        self._clients[name] = client
        model_type = entry.get("model_type", "chat")
        self.manager.set_metadata(
            name,
            model_type=model_type,
            max_model_len=(entry.get("mdc") or {}).get("context_length"),
        )
        if model_type in ("chat", "both"):
            self.manager.add_chat_model(name, client)
        if model_type in ("completions", "both"):
            self.manager.add_completion_model(name, client)
        logger.info("model %s → %s registered (%s)", name, entry["endpoint"], model_type)

    def _handle_delete(self, key: str) -> None:
        name = key.rsplit("/", 1)[-1]
        self.manager.remove_model(name)
        client = self._clients.pop(name, None)
        if client is not None:
            task = asyncio.ensure_future(client.close())
            self._closing.add(task)

            def _done(t: asyncio.Task, model: str = name) -> None:
                self._closing.discard(t)
                if not t.cancelled() and t.exception() is not None:
                    logger.warning("closing client for removed model %s "
                                   "failed: %s", model, t.exception())

            task.add_done_callback(_done)
        logger.info("model %s removed", name)

    async def stop(self) -> None:
        if self._watcher is not None:
            self._watcher.cancel()
        if self._task is not None:
            self._task.cancel()
        # drain close() tasks spawned by deletes racing shutdown, so their
        # exceptions are observed before the loop is torn down under them
        if self._closing:
            await asyncio.gather(*list(self._closing), return_exceptions=True)
        for client in self._clients.values():
            await client.close()
