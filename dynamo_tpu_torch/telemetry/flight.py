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

Not in this slice: the reference's ``CompileTracker`` (its XLA compile
counter and the recompile-storm signal) waits for the rest of the port's
telemetry, beside tracing.
"""

from __future__ import annotations

import collections
import itertools
import os
import time
from typing import List, Optional

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
