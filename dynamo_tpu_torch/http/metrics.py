"""HTTP-edge metrics: the service's instrument set + request timing helper.

The port's copy of ``dynamo_tpu/http/metrics.py`` (reference analog:
lib/llm/src/http/service/metrics.rs:37-130):
``{prefix}_http_service_requests_total`` / ``_inflight_requests`` /
``_request_duration_seconds`` / ``_time_to_first_token_seconds``
labelled by model (and status), in a ``telemetry.registry`` exposition.
"""

from __future__ import annotations

import time
from typing import Optional

from ..telemetry.registry import MetricsRegistry


class ServiceMetrics:
    """The HTTP service's metric set + request timing helper; the engine's
    dict gauges render into the same registry (one ``GET /metrics``)."""

    def __init__(self, prefix: str = "dynamo",
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        self.requests_total = self.registry.counter(
            f"{prefix}_http_service_requests_total", "Total HTTP requests by model/status"
        )
        self.inflight = self.registry.gauge(
            f"{prefix}_http_service_inflight_requests", "In-flight requests by model"
        )
        self.duration = self.registry.histogram(
            f"{prefix}_http_service_request_duration_seconds",
            "Request duration by model",
        )
        self.ttft = self.registry.histogram(
            f"{prefix}_http_service_time_to_first_token_seconds",
            "Time to first streamed token by model",
        )

    def register_callback_gauges(self, prefix: str, fn) -> None:
        """Expose a dict-returning callback (the engine's ``metrics()``:
        slot and KV occupancy, preemptions, prefix hits, ...) as gauges,
        pulled fresh at every /metrics render."""
        self.registry.register_callback_gauges(prefix, fn)

    def inflight_total(self) -> float:
        """Sum of in-flight requests across models (graceful-drain gate)."""
        return sum(self.inflight.values.values())

    def render(self) -> str:
        return self.registry.render()

    class _Timer:
        def __init__(self, metrics: "ServiceMetrics", model: str):
            self.metrics = metrics
            self.model = model
            self.start = time.monotonic()
            self.first_token_seen = False

        def token(self, n: int = 1) -> None:
            """One payload chunk left the edge: TTFT on the first."""
            if not self.first_token_seen:
                self.first_token_seen = True
                self.metrics.ttft.observe(time.monotonic() - self.start,
                                          model=self.model)

        def finish(self, status: str = "success") -> None:
            self.metrics.inflight.dec(model=self.model)
            self.metrics.requests_total.inc(model=self.model, status=status)
            self.metrics.duration.observe(time.monotonic() - self.start, model=self.model)

    def track(self, model: str) -> "ServiceMetrics._Timer":
        self.inflight.inc(model=model)
        return self._Timer(self, model)
