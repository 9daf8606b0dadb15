"""Endpoint client: live instance tracking + routed streaming requests.

Watches the endpoint's discovery prefix into a live instance map and routes
each request per ``RouterMode`` (reference:
lib/runtime/src/component/client.rs:95-319 — watch-backed endpoint set,
random/round_robin/direct/static modes, AsyncEngine impl on the client).

The port's copy of ``dynamo_tpu/runtime/client.py``. Not carried: the
cluster-stitched trace's clock-offset estimate (the reference's
``telemetry/stitch.py``); a worker's span export is kept as it arrived.
"""

from __future__ import annotations

import asyncio
import enum
import itertools
import logging
import random
import uuid
from typing import Any, AsyncIterator, Dict, Optional

from .component import Endpoint
from .discovery import WatchEventType
from .engine import AsyncEngine, Context
from .network import ResponseReceiver, open_response_stream
from .wire import packb, unpackb

logger = logging.getLogger(__name__)


class RouterMode(enum.Enum):
    RANDOM = "random"
    ROUND_ROBIN = "round_robin"
    DIRECT = "direct"
    STATIC = "static"
    KV = "kv"  # resolved by an external KV-aware router, then DIRECT


class NoInstancesError(ConnectionError):
    pass


class Client(AsyncEngine):
    """Streaming client for one endpoint."""

    def __init__(self, endpoint: Endpoint, mode: RouterMode = RouterMode.ROUND_ROBIN,
                 model: Optional[str] = None):
        self.endpoint = endpoint
        self.mode = mode
        # per-model pool filter (registry/): several model pools can
        # share one component endpoint — each instance's registration
        # metadata names the model it serves, and a model-bound client
        # only routes within its pool. Instances registered WITHOUT a
        # model are wildcard-eligible (legacy single-model workers).
        self.model = model
        self.instances: Dict[str, dict] = {}
        self._rr = itertools.count()
        self._watch_task: Optional[asyncio.Task] = None
        self._watcher = None
        self._started = False
        self._instances_changed = asyncio.Event()

    async def start(self) -> "Client":
        """Begin watching the discovery prefix (no-op in static mode)."""
        if self._started:
            return self
        self._started = True
        if self.mode == RouterMode.STATIC:
            return self
        drt = self.endpoint.drt
        prefix = f"{self.endpoint.component.etcd_prefix()}{self.endpoint.name}:"
        snapshot, watcher = await drt.discovery.watch_prefix(prefix)
        for key, value in snapshot.items():
            self._add(key, value)
        self._watcher = watcher
        self._watch_task = drt.runtime.spawn(self._watch_loop(watcher))
        return self

    def _add(self, key: str, value: bytes) -> None:
        try:
            info = unpackb(value)
        except Exception:
            logger.warning("bad endpoint info at %s", key)
            return
        self.instances[info["instance_id"]] = info
        self._instances_changed.set()

    async def _watch_loop(self, watcher) -> None:
        async for ev in watcher:
            if ev.type == WatchEventType.PUT:
                self._add(ev.key, ev.value)
            else:
                instance_id = ev.key.rsplit(":", 1)[-1]
                self.instances.pop(instance_id, None)
                self._instances_changed.set()

    def instance_ids(self) -> list:
        return sorted(self.instances)

    def eligible_ids(self, model: Optional[str] = None) -> list:
        """Instance ids in the routing pool: all of them for an
        unfiltered client, otherwise those whose registration metadata
        matches the model (missing metadata = wildcard)."""
        model = model if model is not None else self.model
        if model is None:
            return sorted(self.instances)
        return sorted(
            iid for iid, info in self.instances.items()
            if info.get("model") in (None, model)
        )

    async def wait_for_instances(self, n: int = 1, timeout: float = 30.0) -> None:
        async def _wait():
            while len(self.eligible_ids()) < n:
                self._instances_changed.clear()
                await self._instances_changed.wait()

        await asyncio.wait_for(_wait(), timeout)

    # --- routing ---

    def _pick(self, instance_id: Optional[str],
              model: Optional[str] = None) -> str:
        if self.mode == RouterMode.STATIC:
            return "static"
        if instance_id is not None:
            if instance_id not in self.instances:
                raise NoInstancesError(
                    f"instance {instance_id} not found for {self.endpoint.path()}"
                )
            return instance_id
        ids = self.eligible_ids(model)
        if not ids:
            model = model if model is not None else self.model
            pool = f" serving model {model!r}" if model else ""
            raise NoInstancesError(
                f"no instances{pool} for {self.endpoint.path()}")
        if self.mode == RouterMode.RANDOM:
            return random.choice(ids)
        return ids[next(self._rr) % len(ids)]

    async def open_stream(
        self, payload: Any, instance_id: Optional[str] = None,
        trace_id: Optional[str] = None, model: Optional[str] = None,
    ) -> ResponseReceiver:
        """Route, push the request, return the dialed-back response stream.

        ``trace_id`` rides the two-part message header so the worker-side
        engine context (and everything downstream of it — scheduler spans,
        remote-prefill requests, logs) keeps the ingress-assigned id.
        """
        if not self._started:
            await self.start()
        target = self._pick(instance_id, model)
        drt = self.endpoint.drt
        conn, receiver = await open_response_stream(drt.stream_server, drt.local)
        req_id = uuid.uuid4().hex
        # wire-serialize rich payloads (the protocols' request classes and
        # dataclasses) into the codec's primitives
        if hasattr(payload, "to_wire"):
            payload = payload.to_wire()
        elif hasattr(payload, "model_dump"):
            payload = payload.model_dump(exclude_none=True)
        header = {"req_id": req_id, "conn": conn}
        if trace_id:
            header["trace_id"] = trace_id
        two_part = {"header": header, "payload": payload}
        # request-send wall time, for the per-hop clock-offset estimate
        # when the worker's end frame ships its spans back
        import time as _time

        receiver.req_sent_at = _time.time()
        await drt.messaging.publish(
            self.endpoint.subject(target), packb(two_part)
        )
        return receiver

    async def generate(self, request: Context[Any]) -> AsyncIterator[Any]:
        """AsyncEngine over the network: request context controls propagate."""
        instance_id = request.baggage.get("instance_id")
        receiver = await self.open_stream(
            request.payload, instance_id, trace_id=request.trace_id,
            # the processor stamps the request's model so a shared-
            # endpoint fallback pick (router down / non-KV modes) still
            # lands inside the right pool
            model=request.baggage.get("model_pool"),
        )
        await receiver.wait_prologue()

        # propagate caller-side cancellation to the worker
        async def relay_cancel():
            await request.context.wait_stopped()
            if request.context.is_killed:
                receiver.kill()
            else:
                receiver.stop_generating()

        relay = asyncio.create_task(relay_cancel())
        exhausted = False
        try:
            async for item in receiver:
                yield item
            exhausted = True
        finally:
            relay.cancel()
            if not exhausted and not request.context.is_stopped:
                # caller stopped consuming early. For detokenizing
                # consumers (llm/backend.py) this is the NORMAL end of
                # every stream — they break at the finish chunk, and the
                # worker's end frame (carrying the span export for the
                # stitched trace) is right behind it on the wire. Give
                # the frame pump one bounded beat to deliver it before
                # killing; a genuinely abandoned mid-generation stream
                # just pays 50 ms of extra cancellation latency.
                try:
                    if (receiver.remote_spans is None
                            and receiver._pump_task is not None):
                        try:
                            await asyncio.wait_for(
                                asyncio.shield(receiver._pump_task), 0.05
                            )
                        # dynlint: allow(silent-except) - best-effort grace for the end frame; the finally's kill() is the real cleanup
                        except Exception:
                            pass
                finally:
                    # kill UNCONDITIONALLY — a cancellation escaping the
                    # grace wait (CancelledError is not an Exception)
                    # must not leave the worker generating into a dead
                    # queue; the caller abandoned the stream
                    receiver.kill()
            rs = receiver.remote_spans
            if rs is not None:
                # the worker's exported spans, as its end frame carried
                # them (the reference also estimates a clock offset here,
                # telemetry/stitch.py, which the port does not carry)
                request.context.add_remote_spans(dict(
                    source=rs.get("source", "worker"),
                    spans=rs.get("spans") or [],
                    children=rs.get("children") or []))

    async def direct(self, payload: Any, instance_id: str) -> ResponseReceiver:
        receiver = await self.open_stream(payload, instance_id)
        await receiver.wait_prologue()
        return receiver

    # --- stats scrape (reference: NATS $SRV.STATS service scrape) ---

    async def scrape_stats(self, timeout: float = 0.5) -> Dict[str, dict]:
        """Ask every live instance for its stats; missing answers are dropped."""
        drt = self.endpoint.drt
        out: Dict[str, dict] = {}

        async def one(iid: str):
            try:
                raw = await drt.messaging.request(
                    f"_stats.{self.endpoint.subject(iid)}", b"", timeout=timeout
                )
                out[iid] = unpackb(raw)
            except Exception as e:
                # dropping the answer is the contract; dropping the trace
                # of WHY an instance never answers is not
                logger.debug("stats scrape from %s failed: %s", iid, e)

        await asyncio.gather(*(one(i) for i in self.instance_ids()))
        return out

    async def close(self) -> None:
        if self._watcher is not None:
            self._watcher.cancel()
        if self._watch_task is not None:
            self._watch_task.cancel()
