"""Distributed runtime and the Namespace → Component → Endpoint model.

Naming scheme (mirrors the reference's etcd/NATS layout, reference:
lib/runtime/src/component.rs:104-345):

  discovery key : {ns}/components/{comp}/endpoints/{ep}:{lease_id_hex}
  subject       : {ns}.{comp}.{ep}.{lease_id_hex}       (instance push)
  static subject: {ns}.{comp}.{ep}.static               (no-discovery mode)

A serving endpoint = a queue subscription on its instance subject + a
discovery key attached to the worker's primary lease. Lease expiry (worker
death) deletes the key; clients watching the prefix drop the instance.

The port's copy of ``dynamo_tpu/runtime/component.py`` (its records
encoded by ``runtime/wire.py``).
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Any, AsyncIterator, Callable, Dict, Optional, Union

from .discovery import DiscoveryClient, WatchEventType
from .engine import AsyncEngine, AsyncEngineContext, Context, EngineError
from .messaging import MessagingClient
from .network import StreamServer, respond_to
from .wire import packb, unpackb

logger = logging.getLogger(__name__)

# Handler signature: async generator over response payloads.
Handler = Callable[[Any, AsyncEngineContext], AsyncIterator[Any]]


class Runtime:
    """Process-level runtime: identity + root cancellation + task tracking."""

    def __init__(self) -> None:
        self.worker_id: str = uuid.uuid4().hex[:16]
        self._shutdown = asyncio.Event()
        self._tasks: set = set()

    def spawn(self, coro) -> asyncio.Task:
        task = asyncio.create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    def shutdown(self) -> None:
        self._shutdown.set()
        for task in list(self._tasks):
            task.cancel()

    async def wait_shutdown(self) -> None:
        await self._shutdown.wait()


class DistributedRuntime:
    """Runtime + the two planes + the process's dial-back stream server.

    ``local`` means single-process mode: requester and workers share the
    process, so response streams use in-memory queues instead of TCP.
    """

    def __init__(
        self,
        discovery: DiscoveryClient,
        messaging: MessagingClient,
        runtime: Optional[Runtime] = None,
        local: bool = False,
        advertise_host: str = "127.0.0.1",
    ):
        self.runtime = runtime or Runtime()
        self.discovery = discovery
        self.messaging = messaging
        self.local = local
        self.stream_server = StreamServer(advertise_host=advertise_host)

    @classmethod
    def in_process(cls, hub=None) -> "DistributedRuntime":
        """Single-process runtime over the in-memory hub (tests)."""
        from .transports.memory import MemoryDiscoveryClient, MemoryMessagingClient, default_hub

        hub = hub or default_hub()
        return cls(
            MemoryDiscoveryClient(hub), MemoryMessagingClient(hub), local=True
        )

    @classmethod
    async def connect(
        cls, host: str = "127.0.0.1", port: Optional[int] = None,
        advertise_host: str = "127.0.0.1",
    ) -> "DistributedRuntime":
        """Multi-process runtime against a dynstore server."""
        from .transports.dynstore import DEFAULT_PORT, DynStoreClient

        client = DynStoreClient(host, port or DEFAULT_PORT)
        await client.connect()
        return cls(client, client, local=False, advertise_host=advertise_host)

    def namespace(self, name: str) -> "Namespace":
        return Namespace(self, name)

    async def close(self) -> None:
        self.runtime.shutdown()
        await self.stream_server.close()
        await self.discovery.close()
        if self.messaging is not self.discovery:
            await self.messaging.close()


class Namespace:
    def __init__(self, drt: DistributedRuntime, name: str):
        self.drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)

    # --- namespace-scoped events (reference: lib/runtime/src/traits/events.rs) ---

    def event_subject(self, name: str) -> str:
        return f"{self.name}._events.{name}"

    async def publish_event(self, name: str, data: Any) -> None:
        await self.drt.messaging.publish(
            self.event_subject(name), packb(data)
        )

    async def subscribe_event(self, name: str):
        return await self.drt.messaging.subscribe(self.event_subject(name))


class Component:
    def __init__(self, namespace: Namespace, name: str):
        self.namespace = namespace
        self.name = name

    @property
    def drt(self) -> DistributedRuntime:
        return self.namespace.drt

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    def etcd_prefix(self) -> str:
        return f"{self.namespace.name}/components/{self.name}/endpoints/"

    def event_subject(self, name: str) -> str:
        return f"{self.namespace.name}.{self.name}._events.{name}"

    async def publish_event(self, name: str, data: Any) -> None:
        await self.drt.messaging.publish(
            self.event_subject(name), packb(data)
        )

    async def subscribe_event(self, name: str):
        return await self.drt.messaging.subscribe(self.event_subject(name))


class Endpoint:
    def __init__(self, component: Component, name: str):
        self.component = component
        self.name = name

    @property
    def drt(self) -> DistributedRuntime:
        return self.component.drt

    def etcd_key(self, instance_id: str) -> str:
        return f"{self.component.etcd_prefix()}{self.name}:{instance_id}"

    def subject(self, instance_id: str) -> str:
        ns = self.component.namespace.name
        return f"{ns}.{self.component.name}.{self.name}.{instance_id}"

    def path(self) -> str:
        """dyn://ns.comp.ep address of this endpoint."""
        return f"dyn://{self.component.namespace.name}.{self.component.name}.{self.name}"

    async def serve(
        self,
        handler: Union[AsyncEngine, Handler],
        instance_id: Optional[str] = None,
        static: bool = False,
        metadata: Optional[dict] = None,
        stats_handler: Optional[Callable[[], dict]] = None,
        span_source: str = "worker",
    ) -> "ServingEndpoint":
        """Register this endpoint and start consuming requests.

        Returns a handle; requests are handled concurrently until stopped.
        In dynamic mode the instance is discoverable and lease-scoped; in
        static mode there is no discovery (reference: is_static runtimes).
        """
        drt = self.drt
        if static:
            instance_id = "static"
            lease = None
        else:
            lease = await drt.discovery.primary_lease()
            instance_id = instance_id or f"{lease.id:x}-{drt.runtime.worker_id[:8]}"

        subject = self.subject(instance_id)
        sub = await drt.messaging.service_subscribe(subject, queue_group=subject)

        serving = ServingEndpoint(self, instance_id, subject, sub, handler,
                                  stats_handler, span_source=span_source)
        serving.task = drt.runtime.spawn(serving._consume())

        # stats RPC subject (metrics scraping; reference scrapes NATS $SRV.STATS)
        stats_sub = await drt.messaging.subscribe(f"_stats.{subject}")
        serving.stats_task = drt.runtime.spawn(serving._serve_stats(stats_sub))

        if not static:
            info = {
                "instance_id": instance_id,
                "subject": subject,
                "worker_id": drt.runtime.worker_id,
                **(metadata or {}),
            }
            created = await drt.discovery.kv_create(
                self.etcd_key(instance_id),
                packb(info),
                lease_id=lease.id,
            )
            if not created:
                # the existing key belongs to another live instance — clean up
                # our half-started serving without touching their registration
                await serving.stop()
                raise RuntimeError(f"endpoint instance already registered: {instance_id}")
            serving.registered = True
        return serving


class ServingEndpoint:
    """A live endpoint consuming its subject; tracks in-flight requests."""

    def __init__(self, endpoint, instance_id, subject, subscription, handler,
                 stats_handler=None, span_source: str = "worker"):
        self.endpoint = endpoint
        self.instance_id = instance_id
        self.subject = subject
        self.subscription = subscription
        self.handler = handler
        self.stats_handler = stats_handler
        # how this process names itself in cluster-stitched traces
        # (telemetry/stitch.py): "decode_engine" for token-level engine
        # workers, "processor" for the router hop, "worker" otherwise
        self.span_source = span_source
        self.task: Optional[asyncio.Task] = None
        self.stats_task: Optional[asyncio.Task] = None
        self.inflight = 0
        self.requests_total = 0
        self.registered = False  # discovery key successfully created

    async def _consume(self) -> None:
        drt = self.endpoint.drt
        async for msg in self.subscription:
            try:
                two_part = unpackb(msg.payload)
                header = two_part["header"]
                payload = two_part["payload"]
            except Exception:
                logger.exception("malformed request on %s", self.subject)
                continue
            drt.runtime.spawn(self._handle_one(header, payload))

    async def _handle_one(self, header: dict, payload: Any) -> None:
        self.inflight += 1
        self.requests_total += 1
        try:
            def stream_fn(ctx: AsyncEngineContext) -> AsyncIterator[Any]:
                if isinstance(self.handler, AsyncEngine):
                    return self.handler.generate(Context(payload, ctx))
                return self.handler(payload, ctx)

            # req_id (a fresh per-hop UUID) becomes the worker-side engine
            # context id — it keys engine/disagg state, so it must be
            # unique; the ingress-assigned trace id (e.g. X-Request-Id)
            # rides alongside for span/log correlation end to end
            await respond_to(
                header["conn"], stream_fn,
                header.get("req_id", "?"),
                trace_id=header.get("trace_id"),
                span_source=self.span_source,
            )
        finally:
            self.inflight -= 1

    async def _serve_stats(self, stats_sub) -> None:
        drt = self.endpoint.drt
        async for msg in stats_sub:
            if msg.reply:
                stats = {
                    "instance_id": self.instance_id,
                    "subject": self.subject,
                    "inflight": self.inflight,
                    "requests_total": self.requests_total,
                }
                if self.stats_handler is not None:
                    try:
                        stats["data"] = self.stats_handler()
                    except Exception:
                        logger.exception("stats handler failed")
                await drt.messaging.publish(
                    msg.reply, packb(stats)
                )

    async def stop(self) -> None:
        self.subscription.cancel()
        if self.stats_task:
            self.stats_task.cancel()
        if self.task:
            self.task.cancel()
        drt = self.endpoint.drt
        if self.registered:
            self.registered = False
            try:
                await drt.discovery.kv_delete(self.endpoint.etcd_key(self.instance_id))
            except Exception as e:
                # shutdown proceeds regardless, but a failed deregistration
                # leaves a ghost instance for routers until the lease lapses
                # — that is worth a line in the log, not silence
                logger.warning("deregistering %s failed (instance stays "
                               "visible until its lease expires): %s",
                               self.endpoint.path(), e)
