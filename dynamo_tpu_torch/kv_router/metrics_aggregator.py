"""Router-side metrics collection: periodic stats scrape of all instances.

Reference analog: lib/llm/src/kv_router/metrics_aggregator.rs — 100ms poll
loop with a short scrape timeout feeding a ProcessedEndpoints snapshot.

The port's copy of ``dynamo_tpu/kv_router/metrics_aggregator.py``, without
``register_into`` (the per-worker gauges of the router's metrics sidecar,
which the port does not serve yet).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Dict, Optional

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

    def stop(self) -> None:
        if self._task:
            self._task.cancel()
