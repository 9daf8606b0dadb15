"""The engine's telemetry: one metrics registry + per-request traces.

The port's copy of ``dynamo_tpu/telemetry/``. The HTTP front renders ONE
Prometheus exposition from a :class:`MetricsRegistry` that the scheduler,
the runner's compile and device-time trackers, the KV tiers, the recovery
ladder, the SLO tracker, the fleet hub and the incident recorder feed;
per-request spans ride :class:`~dynamo_tpu_torch.runtime.engine.
AsyncEngineContext` and are queryable at ``GET /debug/requests/{id}`` and,
stitched across processes, ``GET /debug/trace/{id}``. The flight ring and
the stall watchdog dump what the engine was doing when it stalled.
"""

from .flight import CompileTracker, FlightRecorder, flight_recorder
from .history import LocalHistorySampler, MetricHistory
from .hub import FleetHub
from .incidents import IncidentConfig, IncidentRecorder
from .registry import (
    DEFAULT_BUCKETS,
    CallbackGauge,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    escape_label_value,
    format_labels,
)
from .tracing import TraceRecorder, span_breakdown
from .watchdog import StallWatchdog, build_flight_artifact

__all__ = [
    "DEFAULT_BUCKETS",
    "CallbackGauge",
    "CompileTracker",
    "Counter",
    "FleetHub",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "IncidentConfig",
    "IncidentRecorder",
    "LocalHistorySampler",
    "MetricHistory",
    "MetricsRegistry",
    "StallWatchdog",
    "TraceRecorder",
    "build_flight_artifact",
    "escape_label_value",
    "flight_recorder",
    "format_labels",
    "span_breakdown",
]
