"""Router-side metrics collection: periodic stats scrape of all instances.

Reference analog: lib/llm/src/kv_router/metrics_aggregator.rs — 100ms poll
loop with a short scrape timeout feeding a ProcessedEndpoints snapshot.

The port's copy of ``dynamo_tpu/kv_router/metrics_aggregator.py``;
``register_into`` renders the per-worker snapshot on the router's registry
(a processor's ``--metrics-port`` sidecar).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..runtime.client import Client
from .protocols import ForwardPassMetrics

logger = logging.getLogger(__name__)


class KvMetricsAggregator:
    def __init__(
        self,
        client: Client,
        poll_interval: float = 0.1,
        scrape_timeout: float = 0.3,
        on_update: Optional[Callable[[str, ForwardPassMetrics], None]] = None,
        on_remove: Optional[Callable[[str], None]] = None,
        on_sync: Optional[Callable[[set], None]] = None,
    ):
        self.client = client
        self.poll_interval = poll_interval
        self.scrape_timeout = scrape_timeout
        self.on_update = on_update
        self.on_remove = on_remove
        self.on_sync = on_sync
        self.endpoints: Dict[str, ForwardPassMetrics] = {}
        # monotonic time of each worker's last successful scrape — the
        # staleness age tells operators (and the scheduler cost function's
        # observers) how old a worker's load snapshot is
        self.last_update: Dict[str, float] = {}
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = self.client.endpoint.drt.runtime.spawn(self._loop())

    async def _loop(self) -> None:
        while True:
            try:
                await self.poll_once()
            except Exception:
                logger.exception("metrics poll failed")
            await asyncio.sleep(self.poll_interval)

    async def poll_once(self) -> Dict[str, ForwardPassMetrics]:
        stats = await self.client.scrape_stats(timeout=self.scrape_timeout)
        seen = set()
        for iid, s in stats.items():
            data = s.get("data")
            if data is None:
                continue
            m = ForwardPassMetrics.from_wire(data)
            self.endpoints[iid] = m
            self.last_update[iid] = time.monotonic()
            seen.add(iid)
            if self.on_update:
                self.on_update(iid, m)
        # drop workers that vanished from discovery
        live = set(self.client.instance_ids())
        for iid in list(self.endpoints):
            if iid not in live:
                del self.endpoints[iid]
                self.last_update.pop(iid, None)
                if self.on_remove:
                    self.on_remove(iid)
        if self.on_sync:
            # lets the owner purge state for workers that never produced a
            # successful scrape (e.g. died before their first poll)
            self.on_sync(live)
        return self.endpoints

    def register_into(self, registry, prefix: str = "dynamo") -> None:
        """Expose the per-worker snapshot as labelled gauges on a
        MetricsRegistry (the router-side /metrics surface)."""

        def per_worker(field: str) -> Callable[[], List[Tuple[dict, float]]]:
            # renders off the loop while the poll loop inserts and expires
            # workers: iterate a snapshot
            def collect():
                return [({"instance": iid}, float(getattr(m, field)))
                        for iid, m in list(self.endpoints.items())]
            return collect

        for name, help_, field in (
            ("kv_active_blocks",
             "Worker's in-use KV blocks (scraped ForwardPassMetrics)",
             "kv_active_blocks"),
            ("kv_total_blocks", "Worker's KV capacity in blocks (scraped)",
             "kv_total_blocks"),
            ("active_slots", "Worker's busy batch slots (scraped)",
             "request_active_slots"),
            ("waiting_requests", "Worker's admission-queue depth (scraped)",
             "num_requests_waiting"),
            ("prefix_hit_ratio", "Worker's prefix-cache hit rate (scraped)",
             "gpu_prefix_cache_hit_rate"),
        ):
            registry.callback_gauge(f"{prefix}_kv_router_worker_{name}",
                                    help_, per_worker(field))
        registry.callback_gauge(
            f"{prefix}_kv_router_worker_staleness_seconds",
            "Age of the worker's last successful stats scrape",
            lambda: [({"instance": iid}, time.monotonic() - t)
                     for iid, t in list(self.last_update.items())],
        )

    def stop(self) -> None:
        if self._task:
            self._task.cancel()
