"""Standalone /metrics listener for processes with no HTTP frontend.

The port's copy of ``dynamo_tpu/telemetry/server.py``. The OpenAI front
renders its registry on the service's own ``GET /metrics``; router
processors, token-level workers and prefill workers serve dyn:// traffic
only, so their instruments (the router's per-worker scraped load, the
scheduler's and the runner's internals, the prefill worker's counters)
need a sidecar port, enabled with ``--metrics-port`` (0 = off). The
reference's sidecar is an aiohttp app; this one is a ``RouteServer`` of
the port's own HTTP/1.1 code (``http/server.py``).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..http.server import Response, RouteServer
from .registry import MetricsRegistry

logger = logging.getLogger(__name__)


class MetricsServer(RouteServer):
    """GET /metrics → the registry's exposition, plus any extra
    ``(method, path, handler)`` routes (a hub's /fleet/* beside it)."""

    def __init__(self, registry: MetricsRegistry,
                 host: str = "0.0.0.0", port: int = 9090, routes=None):
        super().__init__(host, port)
        self.registry = registry
        self.add_route("GET", "/metrics", self.handle_metrics)
        for method, path, handler in routes or []:
            self.add_route(method, path, handler)

    async def handle_metrics(self, request, conn) -> Response:
        # rendering walks every instrument and callback: off the loop
        text = await asyncio.get_running_loop().run_in_executor(
            None, self.registry.render)
        return Response(text.encode(),
                        content_type="text/plain; charset=utf-8")

    async def start(self) -> "MetricsServer":
        await super().start()
        logger.info("metrics exposition on %s:%d/metrics", self.host,
                    self.port)
        return self


async def maybe_start_metrics_server(
    registry: Optional[MetricsRegistry], port: int, host: str = "0.0.0.0",
    routes=None,
) -> Optional[MetricsServer]:
    """Start a sidecar exposition iff a registry exists and a port was
    requested: dyn:// roles call this unconditionally."""
    if registry is None or not port:
        return None
    return await MetricsServer(registry, host, port, routes=routes).start()
