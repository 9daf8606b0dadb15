"""OpenAI-compatible HTTP frontend on ``asyncio.start_server``.

The port's copy of ``dynamo_tpu/http/service.py`` (``ModelManager``,
``HttpService``). The reference serves through aiohttp, which the port
does not depend on; the service is a ``RouteServer`` of ``http/server.py``
(the port's own HTTP/1.1 on asyncio streams). The status codes and error
bodies are the reference's.

Routes: POST /v1/chat/completions, POST /v1/completions, POST
/v1/embeddings (served by an engine that carries an ``embedder``, else
501), GET /v1/models, GET /metrics, GET /health, and POST
/admin/drain[?mode=migrate|fail][&respawn=1] (the rolling update through
the ``drainer`` the CLI's ``--self-heal`` attaches, a recovery
controller's ``admin_drain``; 501 without one). A client that goes away
mid-stream stops its request; a draining engine's request is a 503 with
Retry-After.

Telemetry routes (``telemetry/``): GET /debug/requests[?limit=N] and
/debug/requests/{id} (completed traces: span breakdowns of the ingress
trace id, which honours ``X-Request-Id``), /debug/trace/{id} (the same
request's spans from every process it crossed, stitched onto one clock),
/debug/flight[?save=1][&request=<id>] (the flight artifact on demand),
/debug/incidents[?id=<bundle>] (incident bundles; 501 without a recorder),
/debug/profile?seconds=N (a ``torch.profiler`` capture; served only with
a ``profile_dir``), and /fleet/metrics and /fleet/workers (the fleet
hub's rollups; 501 without a hub).

Discovery (the reference's ``register_model`` / ``ModelWatcher``): a
worker or processor registers its model under the discovery plane's
``{namespace}/models/`` prefix, lease-scoped, and a frontend's
``ModelWatcher`` adds a routed ``Client`` for each registration and drops
it when the registration goes (the worker's lease expired). Not ported
yet: the model registry's fleet cards (``register_model``'s ``card``, so
aliases, tenants and per-model pools), admission, quotas and pools, and
/admin's model management.
"""

from __future__ import annotations

import asyncio
import json
import logging
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
from ..telemetry.tracing import TraceRecorder
from .metrics import ServiceMetrics
from .server import (
    Connection,
    Request,
    Response,
    RouteServer,
    StreamResponse,
    error_response,
    json_response,
)

logger = logging.getLogger(__name__)

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


class HttpService(RouteServer):
    def __init__(
        self,
        manager: Optional[ModelManager] = None,
        host: str = "0.0.0.0",
        port: int = 8080,
        metrics_prefix: str = "dynamo",
        profile_dir: Optional[str] = None,
        slo=None,        # telemetry.slo.SloTracker
        trace_ttl_s: Optional[float] = None,
        trace_capacity: Optional[int] = None,
        hub=None,        # telemetry.hub.FleetHub
        incidents=None,  # telemetry.incidents.IncidentRecorder
    ):
        super().__init__(host, port)
        self.manager = manager or ModelManager()
        self.metrics = ServiceMetrics(metrics_prefix)
        # optional SLO attainment + goodput accounting: per-request TTFT /
        # worst-ITL verdicts at the edge (telemetry/slo.py)
        if slo is not None:
            self.metrics.slo = slo
            self.metrics.registry.attach(slo.registry)
        # completed request traces: ingress-assigned trace ids (honoring
        # X-Request-Id) → span breakdowns at GET /debug/requests/{id},
        # cluster-stitched timelines at GET /debug/trace/{id}. Bounded by
        # max-entries LRU AND TTL (evictions counted on
        # dynamo_trace_evicted_total)
        self.traces = TraceRecorder(
            capacity=trace_capacity, ttl_s=trace_ttl_s,
            registry=self.metrics.registry)
        self.profile_dir = profile_dir
        for method, path, handler in (
            ("POST", "/v1/chat/completions", self.handle_chat),
            ("POST", "/v1/completions", self.handle_completions),
            ("POST", "/v1/embeddings", self.handle_embeddings),
            ("GET", "/v1/models", self.handle_models),
            ("GET", "/metrics", self.handle_metrics),
            ("GET", "/health", self.handle_health),
            ("GET", "/debug/requests", self.handle_debug_requests),
            ("GET", "/debug/requests/{rid}", self.handle_debug_request),
            ("GET", "/debug/trace/{rid}", self.handle_debug_trace),
            ("GET", "/debug/flight", self.handle_flight),
            ("POST", "/admin/drain", self.handle_admin_drain),
            ("GET", "/fleet/metrics", self.handle_fleet_metrics),
            ("GET", "/fleet/workers", self.handle_fleet_workers),
            ("GET", "/debug/incidents", self.handle_incidents),
        ):
            self.add_route(method, path, handler)
        if profile_dir:
            # opt-in only: a capture costs device time and writes disk
            self.add_route("GET", "/debug/profile", self.handle_profile)
            self._profile_lock = asyncio.Lock()
        # zero-downtime rolling updates: drain and live-migrate the in-flight
        # requests to peers (recovery/controller.py). Set by the CLI when
        # --self-heal builds a RecoveryController; /admin/drain is 501 without
        self.drainer = None  # async (mode, respawn) -> summary dict
        # fleet telemetry hub + incident recorder (telemetry/hub.py,
        # telemetry/incidents.py): wired by the CLI (--hub, --incident-dir);
        # their routes answer 501 while off, so an operator learns the flag
        self.hub = hub
        self.incidents = incidents
        if hub is not None:
            self.metrics.registry.attach(hub.registry)
        if incidents is not None:
            self.metrics.registry.attach(incidents.registry)

    async def start(self) -> "HttpService":
        if self.profile_dir:
            # CUPTI initialises at a process's first profiler start, on the
            # loop's thread: pay it before serving, not inside a capture
            from ..utils.profiling import prepare_profiler

            self.profiler_prepare_s = prepare_profiler()
        await super().start()
        logger.info("http service on %s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        await super().stop()
        # close() joins the trace writer thread: off the loop, so a hung
        # JSONL filesystem cannot stall the rest of shutdown
        await asyncio.get_running_loop().run_in_executor(
            None, self.traces.close)

    # ---------- helpers ----------

    _error = staticmethod(error_response)

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
        self, request: Request, conn: Connection, request_cls,
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
            self.traces.record(ctx.trace_id, name, status, ctx.stages,
                               ctx=ctx.context)

    async def _stream_sse(
        self,
        conn: Connection,
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

    async def handle_chat(self, request: Request, conn: Connection):
        return await self._handle_inference(
            request, conn, ChatCompletionRequest, self.manager.chat_engines,
            ChatCompletionChunk, aggregate_chat_stream,
        )

    async def handle_completions(self, request: Request, conn: Connection):
        return await self._handle_inference(
            request, conn, CompletionRequest, self.manager.completion_engines,
            CompletionResponse, aggregate_completion_stream,
        )

    async def handle_embeddings(self, request: Request, conn: Connection):
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

    async def handle_models(self, request: Request, conn: Connection):
        data = [ModelInfo(id=name, **self.manager.metadata.get(name, {}))
                for name in self.manager.model_names()]
        return json_response(ModelList(data=data).model_dump(exclude_none=True))

    async def handle_metrics(self, request: Request, conn: Connection):
        return Response(self.metrics.render().encode(),
                        content_type="text/plain; charset=utf-8")

    async def handle_health(self, request: Request, conn: Connection):
        return json_response(
            {"status": "ok", "models": self.manager.model_names()})


    async def handle_admin_drain(self, request: Request, conn: Connection):
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


    # ---------- telemetry routes ----------

    @staticmethod
    def _no_trace(rid: str) -> Response:
        return json_response(
            {"error": f"no completed trace for request id {rid!r} "
                      "(unknown, evicted, or still in flight)"},
            status=404)

    async def handle_debug_requests(self, request: Request, conn: Connection):
        """GET /debug/requests?limit=N: the most recent completed traces
        (newest last), for finding an id when the client picked none."""
        try:
            limit = int(request.query.get("limit", "20"))
        except ValueError:
            return json_response({"error": "bad limit"}, status=400)
        return json_response(
            {"traces": self.traces.recent(max(1, min(limit, 200)))})

    async def handle_debug_request(self, request: Request, conn: Connection):
        """GET /debug/requests/{id}: one completed request's span breakdown
        (stage names, offsets, durations). Send the request with an
        X-Request-Id header to pick the id."""
        rid = request.match_info["rid"]
        trace = self.traces.get(rid)
        if trace is None:
            return self._no_trace(rid)
        return json_response(trace)

    async def handle_debug_trace(self, request: Request, conn: Connection):
        """GET /debug/trace/{id}: the request X-ray. Every process's spans
        (frontend, router hop, decode engine, prefill worker, migration
        peer) on ONE clock-adjusted axis, with each hop's offset and rtt
        and the unattributed gaps."""
        from ..telemetry.stitch import stitched_timeline, timeline_gaps

        rid = request.match_info["rid"]
        trace = self.traces.get(rid)
        if trace is None:
            return self._no_trace(rid)
        stitched = stitched_timeline(trace)
        return json_response({
            "request_id": trace["request_id"],
            "model": trace.get("model"),
            "status": trace.get("status"),
            "total_s": trace.get("total_s"),
            "sources": stitched["sources"],
            "timeline": stitched["timeline"],
            "gaps": timeline_gaps(stitched["timeline"], min_gap_s=0.0005),
        })

    async def handle_flight(self, request: Request, conn: Connection):
        """GET /debug/flight[?save=1][&request=<id>]: the flight artifact
        on demand (ring events, optionally of one request; all-thread
        stacks; every registered engine's probe, request table and metrics;
        recent traces). ``save=1`` also writes it to DYN_FLIGHT_DIR."""
        from ..telemetry.watchdog import (
            build_flight_artifact,
            write_flight_artifact,
        )

        loop = asyncio.get_running_loop()
        # stack walking and metrics rendering off the loop: this is the
        # route an operator calls when the loop is ailing
        artifact = await loop.run_in_executor(
            None, lambda: build_flight_artifact(reason="debug_endpoint"))
        if request.query.get("save"):
            # persist the whole dump before any filtering of the answer
            artifact["artifact_path"] = await loop.run_in_executor(
                None, lambda: write_flight_artifact(artifact))
        rid = request.query.get("request")
        if rid:
            artifact["events"] = [
                e for e in artifact["events"]
                if e.get("request_id") == rid or e.get("trace_id") == rid]
            artifact["filtered_to_request"] = rid
        return json_response(artifact, default=str)

    async def handle_fleet_metrics(self, request: Request, conn: Connection):
        """GET /fleet/metrics: cluster rollups (sum/max/avg by role, counter
        rates) from the fleet hub's scraped histories."""
        if self.hub is None:
            return json_response(
                {"error": "no fleet hub attached (serve with --hub)"},
                status=501)
        return await self.hub.handle_fleet_metrics(request, conn)

    async def handle_fleet_workers(self, request: Request, conn: Connection):
        """GET /fleet/workers: per-worker KV, busy, roofline, SLO and drain
        rows."""
        if self.hub is None:
            return json_response(
                {"error": "no fleet hub attached (serve with --hub)"},
                status=501)
        return await self.hub.handle_fleet_workers(request, conn)

    async def handle_incidents(self, request: Request, conn: Connection):
        """GET /debug/incidents[?id=]: list or fetch incident bundles."""
        if self.incidents is None:
            return json_response(
                {"error": "no incident recorder attached (set "
                          "DYN_INCIDENT_DIR or --incident-dir)"},
                status=501)
        return await self.incidents.handle_debug_incidents(request, conn)

    async def handle_profile(self, request: Request, conn: Connection):
        """GET /debug/profile?seconds=N: a ``torch.profiler`` capture of
        live traffic (CPU and, on a card, CUDA activity) into the profile
        directory; the answer names the trace and sums its kernels."""
        from ..utils.profiling import (
            CaptureBusyError,
            capture_trace_async,
            read_summary,
        )

        try:
            seconds = float(request.query.get("seconds", "2"))
        except ValueError:
            return json_response({"error": "bad seconds"}, status=400)
        if seconds != seconds:  # NaN survives min/max clamping
            return json_response({"error": "bad seconds"}, status=400)
        seconds = min(max(seconds, 0.1), 60.0)
        # one capture per process: a concurrent one gets a clean 409
        if self._profile_lock.locked():
            return json_response(
                {"error": "a capture is already in flight"}, status=409)
        async with self._profile_lock:
            try:
                trace_dir = await capture_trace_async(
                    self.profile_dir, seconds)
            except CaptureBusyError as e:
                # the process-wide lock is held by a capture that did not
                # come through this route (an incident bundle's window)
                return json_response({"error": str(e)}, status=409)
        return json_response({"trace_dir": trace_dir, "seconds": seconds,
                              "summary": read_summary(trace_dir)})


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
