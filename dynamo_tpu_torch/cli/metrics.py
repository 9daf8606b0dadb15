"""Namespace metrics aggregator: scrape the workers' stats → Prometheus.

The port's copy of ``dynamo_tpu/cli/metrics.py``. It scrapes a target
endpoint's ``_stats.*`` replies (``runtime/component.py``; their ``data``
field carries each worker's ``ForwardPassMetrics``), follows the
namespace's KV hit-rate events and serves the namespace-level exposition
on ``GET /metrics``. The reference serves it on aiohttp; the card's
machine has none, so this serves it on the port's own HTTP/1.1 core
(``http/server.py``).

    python3 -m dynamo_tpu_torch.cli.metrics --store-port 4871 \\
        --endpoint dyn://public.backend.generate --metrics-port 9091
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys
from typing import List

from ..http.server import Response, RouteServer
from ..http.service import parse_endpoint_path
from ..kv_router.protocols import KV_HIT_RATE_EVENT, ForwardPassMetrics
from ..runtime.client import Client
from ..runtime.component import DistributedRuntime
from ..runtime.wire import unpackb
from ..telemetry.registry import Counter, Gauge

logger = logging.getLogger(__name__)

# the ForwardPassMetrics fields that become gauges (labelled by instance)
_FPM_FIELDS = (
    "request_active_slots", "request_total_slots", "kv_active_blocks",
    "kv_total_blocks", "num_requests_waiting", "gpu_cache_usage_perc",
    "gpu_prefix_cache_hit_rate",
)


class MetricsAggregator:
    def __init__(self, drt: DistributedRuntime, endpoint_path: str,
                 prefix: str = "dynamo", poll_interval: float = 1.0):
        ns, comp, ep = parse_endpoint_path(endpoint_path)
        self.namespace = ns
        self.client = Client(drt.namespace(ns).component(comp).endpoint(ep))
        self.drt = drt
        self.poll_interval = poll_interval
        self.gauges = {f: Gauge(f"{prefix}_worker_{f}", f"worker {f} (scraped)")
                       for f in _FPM_FIELDS}
        self.inflight = Gauge(f"{prefix}_worker_inflight_requests",
                              "in-flight requests")
        # a scraped snapshot of the worker's monotonic request counter,
        # exposed as a counter (set, not incremented, each scrape: the
        # federation pattern)
        self.requests_total = Counter(f"{prefix}_worker_requests_total",
                                      "requests handled (scraped)")
        self.kv_hit_events = Counter(f"{prefix}_kv_hit_rate_events_total",
                                     "KVHitRateEvents by worker")
        self.kv_hit_blocks = Counter(f"{prefix}_kv_hit_overlap_blocks_total",
                                     "overlap blocks in hit events")
        self._tasks: List[asyncio.Task] = []

    async def start(self) -> None:
        await self.client.start()
        self._tasks.append(self.drt.runtime.spawn(self._poll_loop()))
        sub = await self.drt.namespace(self.namespace).subscribe_event(
            KV_HIT_RATE_EVENT)
        self._tasks.append(self.drt.runtime.spawn(self._consume_hit_events(sub)))

    async def collect_once(self) -> int:
        """One scrape pass; returns the number of instances that answered.
        Series of instances that stopped answering are dropped, so dead or
        restarted workers do not export phantom capacity."""
        stats = await self.client.scrape_stats()
        live = set(stats)
        for g in (self.inflight, self.requests_total, *self.gauges.values()):
            g.values = {k: v for k, v in g.values.items()
                        if dict(k).get("instance") in live}
        for iid, s in stats.items():
            self.inflight.set(float(s.get("inflight", 0)), instance=iid)
            self.requests_total.set_sample(float(s.get("requests_total", 0)),
                                           instance=iid)
            data = s.get("data")
            if data:
                fpm = ForwardPassMetrics.from_wire(data)
                for f in _FPM_FIELDS:
                    self.gauges[f].set(float(getattr(fpm, f)), instance=iid)
        return len(stats)

    async def _poll_loop(self) -> None:
        while True:
            try:
                await self.collect_once()
            except Exception:
                logger.exception("scrape failed")
            await asyncio.sleep(self.poll_interval)

    def on_hit_event(self, payload: bytes) -> None:
        """Count one KV hit-rate event (the router's wire bytes)."""
        ev = unpackb(payload)
        wid = str(ev.get("worker_id"))
        self.kv_hit_events.inc(worker=wid)
        self.kv_hit_blocks.inc(ev.get("overlap_blocks", 0), worker=wid)

    async def _consume_hit_events(self, sub) -> None:
        async for msg in sub:
            try:
                self.on_hit_event(msg.payload)
            except Exception:
                logger.exception("bad kv-hit-rate event")

    def render(self) -> str:
        lines: List[str] = []
        for m in (self.inflight, self.requests_total, self.kv_hit_events,
                  self.kv_hit_blocks, *self.gauges.values()):
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def stop(self) -> None:
        for t in self._tasks:
            t.cancel()


def metrics_server(agg: MetricsAggregator, host: str, port: int) -> RouteServer:
    """``GET /metrics`` → the aggregator's exposition."""
    server = RouteServer(host, port)

    async def handle(request, conn) -> Response:
        return Response(agg.render().encode(), content_type="text/plain")

    server.add_route("GET", "/metrics", handle)
    return server


async def amain(argv: List[str]) -> None:
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch metrics")
    p.add_argument("--store-host", default="127.0.0.1")
    p.add_argument("--store-port", type=int, required=True)
    p.add_argument("--endpoint", required=True, help="dyn://ns.comp.ep to scrape")
    p.add_argument("--metrics-host", default="0.0.0.0")
    p.add_argument("--metrics-port", type=int, default=9091)
    p.add_argument("--poll-interval", type=float, default=1.0)
    args = p.parse_args(argv)

    drt = await DistributedRuntime.connect(args.store_host, args.store_port)
    agg = MetricsAggregator(drt, args.endpoint, poll_interval=args.poll_interval)
    await agg.start()
    server = await metrics_server(agg, args.metrics_host, args.metrics_port).start()
    print(f"metrics on http://{args.metrics_host}:{server.port}/metrics",
          flush=True)
    try:
        await drt.runtime.wait_shutdown()
    finally:
        agg.stop()
        await server.stop()
        await drt.close()


def main() -> None:
    from ..utils.logging import setup_logging
    setup_logging(logging.INFO)
    try:
        asyncio.run(amain(sys.argv[1:]))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
