"""HTTP-edge metrics: the service's instrument set + request timing helper.

The port's copy of ``dynamo_tpu/http/metrics.py`` (reference analog:
lib/llm/src/http/service/metrics.rs:37-130):
``{prefix}_http_service_requests_total`` / ``_inflight_requests`` /
``_request_duration_seconds`` / ``_time_to_first_token_seconds``
labelled by model (and status), in a ``telemetry.registry`` exposition.
The timer also measures what an SLO judges at the edge: TTFT, the worst
inter-token gap and the token count, reported at a successful finish to
the optional ``slo`` tracker (``telemetry/slo.py``).
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
        # optional SLO tracker (telemetry/slo.py): successful requests
        # report their edge-measured TTFT / worst inter-token gap / token
        # count at finish for attainment + goodput accounting
        self.slo = None
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
            # edge-side SLO accounting: TTFT, worst inter-token gap, and
            # token count for the request's attainment verdict
            self.ttft_s: Optional[float] = None
            self.itl_max_s: Optional[float] = None
            self.tokens = 0
            self._last_token_t: Optional[float] = None

        def token(self, n: int = 1) -> None:
            """One payload chunk left the edge: TTFT on the first, the
            inter-token gap on every later one. ``n`` is the chunk's token
            count where the payload carries one (token-level shapes)."""
            now = time.monotonic()
            if not self.first_token_seen:
                self.first_token_seen = True
                self.ttft_s = now - self.start
                self.metrics.ttft.observe(self.ttft_s, model=self.model)
            if self._last_token_t is not None:
                gap = now - self._last_token_t
                if self.itl_max_s is None or gap > self.itl_max_s:
                    self.itl_max_s = gap
            self._last_token_t = now
            self.tokens += max(1, n)

        def finish(self, status: str = "success") -> None:
            self.metrics.inflight.dec(model=self.model)
            self.metrics.requests_total.inc(model=self.model, status=status)
            self.metrics.duration.observe(time.monotonic() - self.start, model=self.model)
            if (self.metrics.slo is not None and status == "success"
                    and self.first_token_seen):
                # only completed streams get a verdict: an error or a
                # disconnect is its own failure, not an SLO miss
                self.metrics.slo.observe(self.ttft_s, self.itl_max_s,
                                         self.tokens)

    def track(self, model: str) -> "ServiceMetrics._Timer":
        self.inflight.inc(model=model)
        return self._Timer(self, model)
