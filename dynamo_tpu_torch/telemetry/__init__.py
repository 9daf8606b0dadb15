"""The engine's telemetry: the metrics registry the HTTP front and engine
gauges render into, the flight recorder's ring and the stall watchdog."""

from .flight import FlightRecorder, flight_recorder
from .registry import MetricsRegistry
from .watchdog import StallWatchdog, build_flight_artifact

__all__ = [
    "FlightRecorder",
    "MetricsRegistry",
    "StallWatchdog",
    "build_flight_artifact",
    "flight_recorder",
]
