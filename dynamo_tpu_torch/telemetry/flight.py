"""In-engine flight recorder: the bounded ring of structured engine events.

The port's copy of the ring half of ``dynamo_tpu/telemetry/flight.py``.
When a serving worker stalls or dies, ``/metrics`` says *that* throughput
went flat, not *why*. The :class:`FlightRecorder` is a process-wide
bounded ring of structured engine events (the scheduler's extractions,
migrated admissions and abandoned bursts, the recovery ladder's drains,
migrations and respawns, watchdog trips, injected faults), each stamped
with monotonic and wall time and the request / trace id it belongs to.
One dict build and one deque append per event, no locks on the append
path, bounded (``DYN_FLIGHT_EVENTS``, default 4096 events; the oldest are
evicted and counted), so the last moments of engine decisions are always
reconstructable: the stall watchdog (``telemetry/watchdog.py``) and
SIGUSR2 dump it.

The :class:`CompileTracker` is the recompile-storm detector. On the TPU a
request shape missing the bucket ladder triggers an XLA compile on the hot
path; on a card the first dispatch of a (program, shape-bucket) key is the
same kind of first-time cost: cuBLAS planning for new GEMM shapes, growth
of the caching allocator, and the build (or library load) of a kernel form
the process has not launched yet (``ops/_build.py``). Every entry point of
``engine/model_runner.py`` runs through ``track(program, key)`` with the
reference's program names and keys, built from host ints only: the first
dispatch of a key is recorded with its wall time, lands in the flight ring
and counts on ``dynamo_engine_xla_compiles_total{program,phase}`` (the
reference's name, so the hub's rollups and dashboards read one series),
``phase`` being ``startup`` before ``mark_serving_started()`` and ``late``
after. A nonzero late rate is the storm signal: warmup should have swept
every serving shape.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

logger = logging.getLogger(__name__)

FLIGHT_DIR_ENV = "DYN_FLIGHT_DIR"
FLIGHT_EVENTS_ENV = "DYN_FLIGHT_EVENTS"
DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """Bounded ring of structured engine events.

    Append is O(1) and lock-free on CPython (``deque.append`` with a
    ``maxlen`` is atomic under the GIL; the monotonic ``appended`` counter
    makes the eviction count derivable without coordination), so recording
    from the scheduler loop, executor threads and transfer callbacks never
    contends. ``snapshot()`` is the only reader and copies the ring."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(FLIGHT_EVENTS_ENV, "")
                               or DEFAULT_CAPACITY)
            except ValueError:
                capacity = DEFAULT_CAPACITY
        self.capacity = max(16, capacity)
        self._ring: "collections.deque" = collections.deque(maxlen=self.capacity)
        self._seq = itertools.count()
        self.appended = 0  # lifetime events; dropped = appended - len(ring)

    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound (the newest survive: a flight
        recorder's job is the moments before the crash)."""
        return max(0, self.appended - len(self._ring))

    def record(self, kind: str, request_id: Optional[str] = None,
               trace_id: Optional[str] = None, **data) -> None:
        """Append one event. Never raises, never blocks, never touches the
        event loop: safe from any thread, any layer."""
        evt = {
            "seq": next(self._seq),
            "t": time.monotonic(),
            "wall": time.time(),
            "kind": kind,
        }
        if request_id is not None:
            evt["request_id"] = request_id
        if trace_id is not None and trace_id != request_id:
            evt["trace_id"] = trace_id
        if data:
            evt["data"] = data
        self.appended += 1
        self._ring.append(evt)

    def snapshot(self, request_id: Optional[str] = None,
                 n: Optional[int] = None) -> List[dict]:
        """Chronological copy of the ring, optionally filtered to one
        request (or trace) id and/or capped to the most recent ``n``."""
        events = list(self._ring)  # atomic under the GIL
        if request_id is not None:
            events = [e for e in events
                      if e.get("request_id") == request_id
                      or e.get("trace_id") == request_id]
        if n is not None:
            events = events[-n:]
        return events

    def __len__(self) -> int:
        return len(self._ring)


# the process-wide recorder every component records into by default; tests
# inject private recorders instead of resetting this one
_GLOBAL = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _GLOBAL


class CompileTracker:
    """First dispatch of each (program, shape-bucket key), timed at the
    dispatch seam.

    The tracker keeps the seen-key set (one lock, held only for the
    membership test: warmup runs in an executor thread while serving
    dispatches from the loop) and classifies each first dispatch by phase:
    ``startup`` until ``mark_serving_started()``, ``late`` after. Late ones
    also log a warning with the shape key. The time is the host's: the
    dispatch itself, which on a card includes any kernel build or library
    load and cuBLAS planning, not the device work it enqueued."""

    def __init__(self, flight: Optional[FlightRecorder] = None,
                 registry=None):
        from .registry import MetricsRegistry

        self.flight = flight if flight is not None else flight_recorder()
        # private registry by default; the scheduler and the prefill worker
        # attach it so the series render in the engine's scrape
        self.registry = registry or MetricsRegistry()
        self._compiles = self.registry.counter(
            "dynamo_engine_xla_compiles_total",
            "First dispatches of a program's shape-bucket key, labelled "
            "program= and phase=startup|late (late = after serving started: "
            "the recompile-storm signal; warmup should have swept every "
            "serving shape)",
        )
        self._duration = self.registry.histogram(
            "dynamo_engine_xla_compile_duration_seconds",
            "Host wall time of each first dispatch of a distinct "
            "shape-bucket key, labelled program=",
        )
        self._lock = threading.Lock()
        self._seen: set = set()
        self._serving = False
        self.records: List[dict] = []  # every first dispatch, for tests
        self.late_compiles = 0

    def mark_serving_started(self) -> None:
        """First dispatches from now on are ``late``: the engine is
        serving, so each stalls a real request."""
        self._serving = True

    @property
    def serving(self) -> bool:
        return self._serving

    @contextmanager
    def track(self, program: str, key: str):
        """Wrap ONE dispatch of ``program`` at shape-bucket ``key``; records
        it iff this (program, key) was never dispatched. ``key`` is built
        from host ints: reading a device tensor here would sync."""
        with self._lock:
            first = (program, key) not in self._seen
            if first:
                self._seen.add((program, key))
        if not first:
            yield False
            return
        t0 = time.monotonic()
        try:
            yield True
        finally:
            dt = time.monotonic() - t0
            phase = "late" if self._serving else "startup"
            self._compiles.inc(program=program, phase=phase)
            self._duration.observe(dt, program=program)
            self.records.append({"program": program, "key": key,
                                 "phase": phase, "duration_s": dt})
            self.flight.record("xla.compile", program=program, key=key,
                               phase=phase, duration_s=round(dt, 4))
            if phase == "late":
                self.late_compiles += 1
                logger.warning(
                    "late first dispatch: program=%s key=%s took %.2fs on "
                    "the serving path (a request shape missed warmup)",
                    program, key, dt)
