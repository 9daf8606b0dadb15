"""Stall watchdog and flight-artifact dumps.

The port's copy of ``dynamo_tpu/telemetry/watchdog.py``. Answers "why is
the engine stuck right now": an asyncio task that samples the scheduler's
loop heartbeat, the event loop's own lag and queue depth against
throughput, and on a trip dumps a **flight artifact** (the flight ring of
``telemetry/flight.py``, all-thread stacks, a metrics snapshot and the
active request table, and the recent completed traces of every live
``TraceRecorder``) to ``DYN_FLIGHT_DIR`` while counting
``dynamo_watchdog_trips_total{reason}``. The same dump is written on
``SIGUSR2`` (``install_signal_dump``).

Trip conditions, each with its own ``reason`` label:

- ``decode_stall``: work is pending (active slots, queued requests, remote
  prefill or prefix-pull waits) but the scheduler loop's heartbeat is
  older than ``stall_s``. The loop stamps it at the top of every pass, so
  a healthy loop that is only waiting stays fresh; only a loop wedged
  inside a pass (a host sync stuck on a dead device, an executor job that
  never returns) goes stale.
- ``no_throughput``: requests are queued but the scheduler has not
  dispatched a step for ``stall_s`` while its heartbeat stays fresh: the
  loop spins without progress (e.g. leaked slots starving admission).
- ``event_loop_lag``: the sampled sleep drift exceeded ``stall_s``:
  something blocked the event loop itself that long (the drift is always
  exported as ``dynamo_runtime_event_loop_lag_seconds``).

After a trip the watchdog re-arms only once the tripping condition
clears, so a persistent wedge produces one artifact, not one per sampling
interval. It holds its task handle and cancels it on ``stop()``; every
filesystem write runs in an executor.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import sys
import threading
import time
import traceback
from typing import Callable, List, Optional

from .flight import FLIGHT_DIR_ENV, FlightRecorder, flight_recorder

logger = logging.getLogger(__name__)

# watchdogs register here so on-demand dumps (SIGUSR2) include every
# engine's probe, request table and metrics in one artifact
_SOURCES: List["StallWatchdog"] = []


def _thread_stacks() -> List[dict]:
    """All-thread stacks via sys._current_frames, with thread names."""
    names = {t.ident: t.name for t in threading.enumerate()}
    return [{
        "thread_id": ident,
        "name": names.get(ident, "?"),
        "stack": [line.rstrip("\n") for line in traceback.format_stack(frame)],
    } for ident, frame in sys._current_frames().items()]


def build_flight_artifact(reason: str = "on_demand",
                          flight: Optional[FlightRecorder] = None) -> dict:
    """Assemble one self-contained dump: ring + stacks + every registered
    watchdog's probe, request table and metrics snapshot.

    Events merge across rings: the process-wide recorder plus any private
    ring a registered engine records into (tests, multi-engine
    processes), chronological, deduplicated by ring identity."""
    rings = {}
    if flight is not None:
        rings[id(flight)] = flight
    else:
        g = flight_recorder()
        rings[id(g)] = g
        for wd in list(_SOURCES):
            if wd.flight is not None:
                rings.setdefault(id(wd.flight), wd.flight)
    events = sorted((e for r in rings.values() for e in r.snapshot()),
                    key=lambda e: e["t"])
    dropped = sum(r.dropped for r in rings.values())
    sources = []
    for wd in list(_SOURCES):
        entry: dict = {"name": wd.name}
        try:
            entry["probe"] = wd.probe() if wd.probe is not None else None
            entry["requests"] = (wd.requests() if wd.requests is not None
                                 else None)
            entry["metrics"] = (wd.registry.render() if wd.registry is not None
                                else None)
            entry["last_trip"] = wd.last_trip
        except Exception as e:
            # a dump must degrade, never fail: a half-torn-down engine still
            # contributes its name and the error
            logger.warning("flight source %s failed during dump: %s",
                           wd.name, e)
            entry["error"] = repr(e)
        sources.append(entry)
    # recent completed request traces (with their stitched remote span
    # sets): a request's X-ray can be rendered from the artifact alone
    from . import tracing

    traces: List[dict] = []
    for rec in tracing.recorders():
        try:
            traces.extend(rec.recent(32))
        except Exception:
            logger.debug("trace recorder snapshot failed", exc_info=True)
    return {
        "version": 1,
        "reason": reason,
        "time": time.time(),
        "monotonic": time.monotonic(),
        "pid": os.getpid(),
        "events": events,
        "dropped_events": dropped,
        "threads": _thread_stacks(),
        "sources": sources,
        "traces": traces,
    }


def flight_dir() -> Optional[str]:
    return os.environ.get(FLIGHT_DIR_ENV) or None


def write_flight_artifact(artifact: dict) -> Optional[str]:
    """Serialize one artifact to ``<DYN_FLIGHT_DIR>/flight-<pid>-<ns>-
    <reason>.json``. Blocking (disk IO): async callers run it in an
    executor. Returns the path, or None when no dump directory is
    configured."""
    out_dir = flight_dir()
    if not out_dir:
        return None
    os.makedirs(out_dir, exist_ok=True)
    # a monotonic-ns suffix: two dumps in the same second never collide
    path = os.path.join(
        out_dir, f"flight-{os.getpid()}-{time.monotonic_ns()}"
                 f"-{artifact.get('reason', 'dump')}.json")
    with open(path, "w") as f:
        json.dump(artifact, f, default=str, indent=1)
    return path


_signal_installed = False


def install_signal_dump() -> bool:
    """SIGUSR2 → write a flight artifact to DYN_FLIGHT_DIR (or log it as one
    JSON line when no directory is configured). Idempotent; main thread
    only (a signal module rule); returns whether installed.

    The handler spawns a short-lived thread for the dump, so the signal
    context only schedules, and a wedged event loop (the very situation
    that makes an operator reach for SIGUSR2) cannot block it."""
    global _signal_installed
    if _signal_installed:
        return True

    def _dump_in_thread(signum, frame):
        def work():
            try:
                artifact = build_flight_artifact(reason="sigusr2")
                path = write_flight_artifact(artifact)
                if path:
                    logger.warning("flight artifact dumped to %s", path)
                else:
                    logger.warning("flight artifact (no %s configured): %s",
                                   FLIGHT_DIR_ENV,
                                   json.dumps(artifact, default=str))
            except Exception:
                logger.exception("SIGUSR2 flight dump failed")

        threading.Thread(target=work, name="flight-dump", daemon=True).start()

    try:
        signal.signal(signal.SIGUSR2, _dump_in_thread)
    except (ValueError, AttributeError, OSError) as e:
        # a thread other than the main one, or a platform without SIGUSR2
        logger.debug("SIGUSR2 flight dump not installed: %s", e)
        return False
    _signal_installed = True
    return True


class StallWatchdog:
    """Samples one engine's liveness; dumps and counts on a trip.

    ``probe()`` returns the scheduler's liveness snapshot
    (``Scheduler.watchdog_probe``): ``heartbeat_t`` (monotonic stamp of the
    last loop pass), ``steps`` (the dispatch counter), ``queue_depth``,
    ``pending_remote``, ``pending_pull``, ``active`` (occupied slots) and
    ``stopping``. ``requests()`` returns the active request table for the
    artifact."""

    def __init__(
        self,
        probe: Callable[[], dict],
        requests: Optional[Callable[[], list]] = None,
        registry=None,
        flight: Optional[FlightRecorder] = None,
        interval_s: float = 1.0,
        stall_s: float = 30.0,
        name: str = "engine",
    ):
        self.probe = probe
        self.requests = requests
        self.flight = flight if flight is not None else flight_recorder()
        self.interval_s = max(0.02, interval_s)
        self.stall_s = max(self.interval_s, stall_s)
        self.name = name
        if registry is None:
            from .registry import MetricsRegistry

            registry = MetricsRegistry()
        self.registry = registry
        self._trips = registry.counter(
            "dynamo_watchdog_trips_total",
            "Stall-watchdog trips, labelled reason="
            "decode_stall|no_throughput|event_loop_lag")
        self._lag_gauge = registry.gauge(
            "dynamo_runtime_event_loop_lag_seconds",
            "Sampled asyncio event-loop lag: how late the watchdog's "
            "periodic sleep fired against its deadline")
        self._task: Optional[asyncio.Task] = None
        # trip subscribers (recovery/controller.py): called with the trip's
        # info dict AFTER the artifact is dumped, so detection stays useful
        # even when a subscriber's recovery goes wrong
        self._trip_listeners: List[Callable[[dict], None]] = []
        # (steps value, monotonic time it last changed) for no_throughput
        self._steps_mark: Optional[tuple] = None
        # reasons currently tripped; re-armed only when the condition clears
        self._tripped: set = set()
        self.trips: List[dict] = []  # public record for tests and inspection
        self.last_trip: Optional[dict] = None
        self.loop_lag_s = 0.0

    # ---------- lifecycle ----------

    def start(self) -> "StallWatchdog":
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name=f"watchdog-{self.name}")
            _SOURCES.append(self)
        return self

    async def stop(self) -> None:
        task, self._task = self._task, None
        if self in _SOURCES:
            _SOURCES.remove(self)
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    # ---------- the loop ----------

    async def _run(self) -> None:
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.interval_s)
            self.loop_lag_s = max(0.0, time.monotonic() - t0 - self.interval_s)
            self._lag_gauge.set(self.loop_lag_s)
            try:
                await self._check(time.monotonic())
            except asyncio.CancelledError:
                raise
            except Exception:
                # the watchdog must outlive a flaky probe: a dead watchdog
                # is a silent failure of its own
                logger.exception("watchdog check failed; continuing")

    async def _check(self, now: float) -> None:
        snap = self.probe()
        if snap.get("stopping"):
            return
        hb = snap.get("heartbeat_t")
        heartbeat = now if hb is None else float(hb)
        depth = int(snap.get("queue_depth") or 0)
        active = int(snap.get("active") or 0)
        # remote-prefill and prefix-pull waits carry their own deadline and
        # local fallback, so they count toward "the loop must be alive"
        # (decode_stall: a wedged loop runs neither fallback) but not
        # toward "the loop must be dispatching" (no_throughput)
        remote = (int(snap.get("pending_remote") or 0)
                  + int(snap.get("pending_pull") or 0))
        steps = snap.get("steps")
        # no_throughput bookkeeping: when did ``steps`` last advance? The
        # clock re-stamps while the queue is empty too (frozen steps with
        # nothing queued is rest), or the first sample after a long idle
        # gap that sees new arrivals would read the old mark and trip
        if steps is not None:
            if (depth == 0 or self._steps_mark is None
                    or self._steps_mark[0] != steps):
                self._steps_mark = (steps, now)
        pending = depth > 0 or active > 0 or remote > 0
        stale = pending and (now - heartbeat) > self.stall_s
        starved = (depth > 0 and self._steps_mark is not None
                   and (now - self._steps_mark[1]) > self.stall_s)
        lagged = self.loop_lag_s > self.stall_s
        await self._edge("decode_stall", stale, snap, now - heartbeat)
        # a stale heartbeat already explains frozen steps: one wedge is
        # not reported under a second reason
        await self._edge("no_throughput", starved and not stale, snap,
                         now - self._steps_mark[1] if self._steps_mark else 0.0)
        await self._edge("event_loop_lag", lagged, snap, self.loop_lag_s)

    async def _edge(self, reason: str, condition: bool, snap: dict,
                    stalled_for: float) -> None:
        """Edge-triggered trip: fire once when ``condition`` becomes true;
        re-arm when it clears."""
        if not condition:
            self._tripped.discard(reason)
            return
        if reason in self._tripped:
            return
        self._tripped.add(reason)
        await self.trip(reason, snap, stalled_for)

    async def trip(self, reason: str, snap: dict,
                   stalled_for: float) -> Optional[str]:
        self._trips.inc(reason=reason)
        self.flight.record(
            "watchdog.trip", reason=reason, name=self.name,
            stalled_for_s=round(stalled_for, 3),
            **{k: snap.get(k) for k in ("queue_depth", "active", "steps")})
        info = {
            "reason": reason,
            "name": self.name,
            "time": time.time(),
            "stalled_for_s": stalled_for,
            "probe": dict(snap),
        }
        self.trips.append(info)
        self.last_trip = info
        # the artifact walks scheduler state and renders metrics, and its
        # write is disk IO: both run in the executor, so a slow volume
        # cannot stall the loop this task watches
        path = await asyncio.get_running_loop().run_in_executor(
            None, self._dump, reason)
        info["artifact"] = path
        logger.error(
            "WATCHDOG TRIP [%s] %s: stalled for %.1fs (queue_depth=%s "
            "active=%s steps=%s)%s", self.name, reason, stalled_for,
            snap.get("queue_depth"), snap.get("active"), snap.get("steps"),
            f": flight artifact at {path}" if path
            else f": set {FLIGHT_DIR_ENV} to persist flight artifacts")
        for fn in list(self._trip_listeners):
            try:
                fn(info)
            except Exception:
                # recovery must never take detection down with it
                logger.exception("watchdog trip listener failed")
        return path

    def add_trip_listener(self, fn: Callable[[dict], None]) -> None:
        """Subscribe to trips (a sync callback; schedule a task of your own
        for anything long: the watchdog keeps sampling)."""
        self._trip_listeners.append(fn)

    def _dump(self, reason: str) -> Optional[str]:
        # no flight= argument: this watchdog is registered in _SOURCES, so
        # the artifact merges its ring with the process-wide one (transfer
        # and recovery events record into the global ring)
        return write_flight_artifact(build_flight_artifact(reason=reason))
