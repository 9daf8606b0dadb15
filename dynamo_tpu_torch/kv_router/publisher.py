"""Worker-side KV plumbing: event publisher + metrics publisher.

Reference analog: lib/llm/src/kv_router/publisher.rs — KvEventPublisher
(engine block events → broker subject) and KvMetricsPublisher
(ForwardPassMetrics served via the endpoint stats handler).

The port's copy of ``dynamo_tpu/kv_router/publisher.py``. Each published
event also carries ``ts``, the wall time its hook fired, which a router
of this package reads as the event's lag (the reference's router ignores
the key); ``published`` counts the events handed to the broker.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import Callable, List, Optional

from ..engine.block_allocator import KvEventSink
from ..runtime.component import Component
from .protocols import KV_EVENT_SUBJECT, ForwardPassMetrics, KvCacheRemoved, KvCacheStored, RouterEvent

logger = logging.getLogger(__name__)


class KvEventPublisher:
    """Queue-decoupled publisher: engine hooks are sync, broker IO is async."""

    def __init__(self, component: Component, worker_id: str):
        self.component = component
        self.worker_id = worker_id
        self._queue: asyncio.Queue = asyncio.Queue()
        self._ids = itertools.count(1)
        self._task: Optional[asyncio.Task] = None
        self.published = 0  # events handed to the broker

    def start(self) -> None:
        self._task = self.component.drt.runtime.spawn(self._pump())

    async def _pump(self) -> None:
        while True:
            event, ts = await self._queue.get()
            try:
                await self.component.publish_event(
                    KV_EVENT_SUBJECT, dict(event.to_wire(), ts=ts))
                self.published += 1
            except Exception:
                logger.exception("kv event publish failed")

    def publish_stored(self, block_hashes: List[int],
                       parent_hash: Optional[int],
                       tier: str = "hbm") -> None:
        self._queue.put_nowait((
            RouterEvent(
                worker_id=self.worker_id,
                stored=KvCacheStored(block_hashes=list(block_hashes), parent_hash=parent_hash),
                event_id=next(self._ids),
                tier=tier,
            ), time.time()))

    def publish_removed(self, block_hashes: List[int],
                        tier: str = "hbm") -> None:
        self._queue.put_nowait((
            RouterEvent(
                worker_id=self.worker_id,
                removed=KvCacheRemoved(block_hashes=list(block_hashes)),
                event_id=next(self._ids),
                tier=tier,
            ), time.time()))

    def as_sink(self) -> KvEventSink:
        """Adapter plugged into the engine's BlockAllocator. The cold
        hooks advertise cold-tier residency (kv/cold_tier.py spills and
        evictions) so routers score rehydratable prefixes discounted."""
        return KvEventSink(
            on_stored=self.publish_stored,
            on_removed=self.publish_removed,
            on_stored_cold=lambda hashes, parent: self.publish_stored(
                hashes, parent, tier="cold"),
            on_removed_cold=lambda hashes: self.publish_removed(
                hashes, tier="cold"),
        )

    def stop(self) -> None:
        if self._task:
            self._task.cancel()


class KvMetricsPublisher:
    """Exposes ForwardPassMetrics through the endpoint stats scrape.

    ``stats_handler()`` goes into Endpoint.serve(stats_handler=...); callers
    (KvMetricsAggregator) see it under the ``data`` key of scraped stats.
    """

    def __init__(self, metrics_fn: Callable[[], dict]):
        self.metrics_fn = metrics_fn

    def stats_handler(self) -> dict:
        raw = self.metrics_fn()
        out = ForwardPassMetrics.from_wire(raw).to_wire()
        # engine-specific extras (e.g. disagg remote-prefill counters) ride
        # along; consumers key off the ForwardPassMetrics fields they know
        for key, value in raw.items():
            out.setdefault(key, value)
        return out
