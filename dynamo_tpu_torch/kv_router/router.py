"""KvRouter: event-indexed, load-aware worker selection for one endpoint.

Ties together the indexer (fed by the workers' kv_events), the metrics
aggregator (stats scrape), and the scheduler cost function; publishes
KVHitRateEvents so observability tooling can track routing quality.

Reference analog: lib/llm/src/kv_router.rs:66-169.

The port's copy of ``dynamo_tpu/kv_router/router.py``. Its ``registry``
carries the decision counters and the aggregator's per-worker gauges (a
processor's ``--metrics-port`` sidecar renders it). Not carried: the
flight recorder's pick event and the ``num_shards`` option (the one-tree index is the only one a caller
builds). Added:
``stats()``, what a processor's stats scrape answers: the index's size
and events, the decisions, each decision's time and each event's lag from
its hook (the ``ts`` a port publisher stamps).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Optional

from ..runtime.client import Client
from ..runtime.component import Component
from ..runtime.wire import unpackb
from ..tokens import compute_block_hashes
from .indexer import KvIndexer
from ..telemetry.registry import MetricsRegistry
from .metrics_aggregator import KvMetricsAggregator
from .protocols import KV_EVENT_SUBJECT, KV_HIT_RATE_EVENT, RouterEvent
from .scheduler import KvScheduler, SchedulingDecision

logger = logging.getLogger(__name__)


class _Stat:
    """Count, sum and max of one observed quantity."""

    __slots__ = ("n", "total", "max", "last")

    def __init__(self) -> None:
        self.n, self.total, self.max, self.last = 0, 0.0, 0.0, 0.0

    def add(self, x: float) -> None:
        self.n += 1
        self.total += x
        self.max = max(self.max, x)
        self.last = x

    def summary(self) -> dict:
        return dict(n=self.n, mean=self.total / self.n if self.n else 0.0,
                    max=self.max, last=self.last)


class KvRouter:
    def __init__(
        self,
        component: Component,
        client: Client,
        block_size: int = 16,
        poll_interval: float = 0.1,
        staleness_bound_s: float = 0.0,
        rng: Optional[random.Random] = None,
    ):
        self.component = component
        self.client = client
        self.block_size = block_size
        self.indexer = KvIndexer(block_size)
        # staleness_bound_s > 0: the cost function skips workers whose
        # scraped snapshot is older than the bound (0 = trust forever)
        self.scheduler = KvScheduler(
            block_size, staleness_bound_s=staleness_bound_s or None, rng=rng)
        self.aggregator = KvMetricsAggregator(
            client,
            poll_interval=poll_interval,
            on_update=self.scheduler.update_metrics,
            on_remove=self._on_worker_gone,
            on_sync=self._sync_live_workers,
        )
        self._event_task: Optional[asyncio.Task] = None
        self._event_sub = None
        self.decision_us = _Stat()   # index lookup + cost function
        self.event_lag_ms = _Stat()  # publisher hook -> applied here
        self.decisions = 0
        # the router's own observability surface: per-worker scraped load
        # (active blocks, prefix hit rate, scrape staleness) and the routing
        # decision counters
        self.registry = MetricsRegistry()
        self.aggregator.register_into(self.registry)
        self._decisions = self.registry.counter(
            "dynamo_kv_router_decisions_total",
            "Scheduling decisions, labelled by chosen worker",
        )
        self._overlap_blocks = self.registry.counter(
            "dynamo_kv_router_overlap_blocks_total",
            "Prefix-overlap blocks credited to chosen workers",
        )
        self._stale_skips = self.registry.counter(
            "dynamo_kv_router_stale_worker_skips_total",
            "Workers excluded from a scheduling decision because their "
            "load snapshot exceeded the staleness bound",
        )
        self._draining_skips = self.registry.counter(
            "dynamo_kv_router_draining_worker_skips_total",
            "Workers excluded from a scheduling decision because their "
            "load snapshot carried the recovery-drain flag",
        )

    def _on_worker_gone(self, worker_id: str) -> None:
        self.scheduler.remove_worker(worker_id)
        self.indexer.remove_worker(worker_id)

    def _sync_live_workers(self, live: set) -> None:
        """Purge index entries for workers that died before ever scraping."""
        for wid in set(self.indexer.worker_ids) - live:
            self.indexer.remove_worker(wid)

    async def start(self) -> "KvRouter":
        await self.client.start()
        self._event_sub = await self.component.subscribe_event(KV_EVENT_SUBJECT)
        self._event_task = self.component.drt.runtime.spawn(self._consume_events())
        self.aggregator.start()
        return self

    async def _consume_events(self) -> None:
        async for msg in self._event_sub:
            try:
                wire = unpackb(msg.payload)
                self.indexer.apply_event(RouterEvent.from_wire(wire))
                if "ts" in wire:
                    self.event_lag_ms.add((time.time() - wire["ts"]) * 1e3)
            except Exception:
                logger.exception("bad kv event")

    def model_pool(self, model: Optional[str]) -> Optional[set]:
        """Instance ids registered as serving ``model`` (per-model pool
        partition). None = no filtering (no model named). Delegates to
        the client's eligibility predicate so routing and fallback
        picking can never diverge on wildcard semantics."""
        if model is None:
            return None
        return set(self.client.eligible_ids(model))

    async def schedule(self, token_ids, trace_id: Optional[str] = None,
                       model: Optional[str] = None) -> SchedulingDecision:
        """token ids → chosen worker instance id (+hit telemetry).
        ``model`` selects the per-model pool before prefix scoring;
        ``trace_id`` is the reference's (its flight event), unused here."""
        t0 = time.perf_counter()
        hashes = compute_block_hashes(token_ids, self.block_size)
        overlap = self.indexer.find_matches(hashes)
        decision = self.scheduler.schedule(
            len(token_ids), overlap, pool=self.model_pool(model))
        self.decision_us.add((time.perf_counter() - t0) * 1e6)
        self.decisions += 1
        # the scheduler counts exclusions; the series mirror its totals
        self._stale_skips.set_sample(float(self.scheduler.stale_skips))
        self._draining_skips.set_sample(float(self.scheduler.draining_skips))
        self._decisions.inc(worker=str(decision.worker_id))
        self._overlap_blocks.inc(decision.matched_blocks,
                                 worker=str(decision.worker_id))
        try:
            await self.component.namespace.publish_event(
                KV_HIT_RATE_EVENT,
                {
                    "worker_id": decision.worker_id,
                    "isl_blocks": -(-len(token_ids) // self.block_size),
                    "overlap_blocks": decision.matched_blocks,
                },
            )
        except Exception:
            logger.debug("hit-rate event publish failed", exc_info=True)
        return decision

    def stats(self) -> dict:
        """What a processor's stats scrape answers (``Endpoint.serve``'s
        ``stats_handler``): the index and its events, the decisions, and
        the timings (decision µs, event lag ms)."""
        return dict(
            indexer_blocks=len(self.indexer.tree),
            indexer_tree=("native" if getattr(self.indexer.tree, "native", False)
                          else "python"),
            events_applied=self.indexer.events_applied,
            workers_with_metrics=sorted(self.scheduler.workers),
            decisions=self.decisions,
            decision_us=self.decision_us.summary(),
            event_lag_ms=self.event_lag_ms.summary(),
            stale_skips=self.scheduler.stale_skips,
        )

    async def stop(self) -> None:
        if self._event_sub is not None:
            self._event_sub.cancel()
        if self._event_task is not None:
            self._event_task.cancel()
        self.aggregator.stop()
