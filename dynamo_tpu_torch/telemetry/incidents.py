"""Incident recorder: trigger-driven capture bundles.

The port's copy of ``dynamo_tpu/telemetry/incidents.py``. The flight
recorder, history rings, and trace store all hold evidence, but an
operator has to *pull* it after noticing a problem, and by then the
RecoveryController has usually drained and respawned the wedged engine
and the in-memory evidence is gone. The
:class:`IncidentRecorder` flips the direction: it subscribes to the
degradation edges the repo already emits —

- ``StallWatchdog.add_trip_listener`` (decode_stall / no_throughput /
  event_loop_lag),
- ``RecoveryController.add_drain_listener`` (the recovery ladder
  engaging for any non-admin reason),
- SLO attainment falling through the policy floor (:func:`slo_probe`),
- a burst of late first dispatches from the CompileTracker
  (:func:`late_compile_probe`),

and on an edge captures ONE correlated bundle to ``DYN_INCIDENT_DIR``:

- ``manifest.json`` — reason, trigger info, wall/monotonic stamps, the
  affected request id, what was (and wasn't) captured;
- ``flight.json`` — the full flight artifact
  (telemetry/watchdog.build_flight_artifact: ring, stacks, probes,
  request tables, metrics snapshot);
- ``history.json`` — the last N minutes of local metric history rings
  (telemetry/history.py — the curve INTO the incident, not one point);
- ``traces.json`` — the stitched traces of affected requests from the
  live TraceRecorders (ids correlated through the flight ring);
- optionally ``profile/`` — a ``torch.profiler`` capture window
  (``--incident-profile-s``, ``utils/profiling.py``; skipped cleanly when
  another capture holds the process-wide profiler lock).

Bundles are rate-limited (per-reason cooldown + a global min interval,
so one wedge that trips the watchdog AND engages recovery yields ONE
bundle) and deduped per (reason, request). Every decision is counted:
``dynamo_incidents_total{reason}`` / ``dynamo_incidents_suppressed_
total{reason}``. ``GET /debug/incidents`` lists and fetches bundles
(``load_bundle_dir`` reads one offline).

Discipline: every capture task is held until done, all bundle IO rides
the executor, and a failing capture is logged — detection must survive
its own reporting.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import logging
import os
import re
import time
from typing import Callable, Dict, List, Optional

from .history import MetricHistory

logger = logging.getLogger(__name__)

INCIDENT_DIR_ENV = "DYN_INCIDENT_DIR"
MANIFEST = "manifest.json"
_BUNDLE_RE = re.compile(r"^incident-\d+-\d+-[a-z0-9_]+$")


def incident_dir() -> Optional[str]:
    return os.environ.get(INCIDENT_DIR_ENV) or None


def _safe_reason(reason: str) -> str:
    return re.sub(r"[^a-z0-9_]+", "_", reason.lower()).strip("_") or "unknown"


@dataclasses.dataclass
class IncidentConfig:
    out_dir: Optional[str] = None     # None → DYN_INCIDENT_DIR at capture
    cooldown_s: float = 60.0          # per-reason re-trigger floor
    min_interval_s: float = 30.0      # global floor: one wedge, one bundle
    dedup_s: float = 300.0            # (reason, request) re-trigger floor:
    #                                   the SAME request re-tripping the
    #                                   SAME reason is noise long after the
    #                                   per-reason cooldown has cleared
    settle_s: float = 0.75            # trip → capture delay, so the drain
    #                                   outcome and just-finished traces
    #                                   land in the bundle too
    history_window_s: float = 300.0   # how far back history.json reaches
    max_bundles: int = 32             # oldest pruned beyond this
    max_traces: int = 16
    profile_s: float = 0.0            # >0: torch.profiler capture window


class IncidentRecorder:
    """Edge-triggered capture of correlated incident bundles."""

    def __init__(
        self,
        config: Optional[IncidentConfig] = None,
        history: Optional[MetricHistory] = None,
        registry=None,
        flight=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        from .flight import flight_recorder
        from .registry import MetricsRegistry

        self.config = config or IncidentConfig()
        self.history = history
        self.flight = flight if flight is not None else flight_recorder()
        self.clock = clock
        self.registry = registry or MetricsRegistry()
        self._captured_c = self.registry.counter(
            "dynamo_incidents_total",
            "Incident bundles captured, labelled reason= (decode_stall|"
            "no_throughput|event_loop_lag|recovery_drain|slo_floor|"
            "late_compile_burst|manual|...)",
        )
        self._suppressed_c = self.registry.counter(
            "dynamo_incidents_suppressed_total",
            "Incident triggers suppressed by per-reason cooldown, the "
            "global min interval, or (reason, request) dedup",
        )
        self._last_by_reason: Dict[str, float] = {}
        self._last_any: Optional[float] = None
        self._last_key: Dict[tuple, float] = {}
        self._tasks: set = set()
        self._probes: List[Callable[[], Optional[dict]]] = []
        self._probe_active: Dict[int, bool] = {}
        self._probe_task: Optional[asyncio.Task] = None
        self._seq = 0
        self.bundles: List[dict] = []   # manifests, newest last (tests)
        self.captures = 0
        self.suppressed = 0

    # ---------- trigger sources ----------

    def watch_watchdog(self, watchdog) -> None:
        """Capture on every watchdog trip (the trip's own flight dump is
        a point-in-time artifact; the bundle adds history + traces and
        survives the recovery that follows)."""

        def on_trip(info: dict) -> None:
            probe = info.get("probe") or {}
            self.trigger(
                info.get("reason", "watchdog"),
                request_id=None,
                stalled_for_s=info.get("stalled_for_s"),
                queue_depth=probe.get("queue_depth"),
                active=probe.get("active"),
            )

        watchdog.add_trip_listener(on_trip)

    def watch_recovery(self, controller) -> None:
        """Capture when the recovery ladder engages for a real failure.
        Admin drains (rolling updates) are operator-intended and do not
        produce incident bundles."""

        def on_drain(info: dict) -> None:
            if info.get("reason") == "admin":
                return
            self.trigger("recovery_drain", reason_detail=info.get("reason"),
                         hard=info.get("hard"))

        controller.add_drain_listener(on_drain)

    def add_probe(self, probe: Callable[[], Optional[dict]]) -> None:
        """Register an edge probe: a callable returning None while
        healthy and ``{"reason": ..., **info}`` while degraded. The poll
        loop fires on the False→True edge and re-arms on clear."""
        self._probes.append(probe)

    # ---------- lifecycle ----------

    def start(self, probe_interval_s: float = 5.0) -> "IncidentRecorder":
        if self._probe_task is None and self._probes:
            self._probe_task = asyncio.get_running_loop().create_task(
                self._probe_loop(max(0.02, probe_interval_s)),
                name="incident-probes")
        return self

    async def stop(self) -> None:
        task, self._probe_task = self._probe_task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        # let in-flight captures finish — an incident bundle racing
        # shutdown is exactly the evidence worth waiting a moment for
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)

    async def _probe_loop(self, interval_s: float) -> None:
        while True:
            for i, probe in enumerate(self._probes):
                try:
                    result = probe()
                except Exception:
                    logger.exception("incident probe failed; continuing")
                    continue
                if result:
                    if not self._probe_active.get(i):
                        self._probe_active[i] = True
                        info = dict(result)
                        reason = info.pop("reason", "probe")
                        self.trigger(reason, **info)
                else:
                    self._probe_active[i] = False
            await asyncio.sleep(interval_s)

    # ---------- the trigger ----------

    def trigger(self, reason: str, request_id: Optional[str] = None,
                **info) -> bool:
        """Rate-limited capture entry (sync; callable from any listener
        on the event loop). Returns whether a capture was scheduled."""
        reason = _safe_reason(reason)
        now = self.clock()
        suppressed_by = None
        last = self._last_by_reason.get(reason)
        if last is not None and now - last < self.config.cooldown_s:
            suppressed_by = "cooldown"
        elif (self._last_any is not None
              and now - self._last_any < self.config.min_interval_s):
            # one wedge trips the watchdog AND engages recovery within
            # seconds — the global floor folds those into ONE bundle
            suppressed_by = "min_interval"
        elif request_id is not None:
            key = (reason, request_id)
            last_k = self._last_key.get(key)
            if last_k is not None and now - last_k < self.config.dedup_s:
                suppressed_by = "dedup"
        if suppressed_by is not None:
            self.suppressed += 1
            self._suppressed_c.inc(reason=reason)
            self.flight.record("incident.suppressed", reason=reason,
                               by=suppressed_by, request_id=request_id)
            return False
        self._last_by_reason[reason] = now
        self._last_any = now
        if request_id is not None:
            self._last_key[(reason, request_id)] = now
        self._seq += 1
        task = asyncio.get_running_loop().create_task(
            self._capture(reason, request_id, info, self._seq),
            name=f"incident-capture-{reason}")
        self._tasks.add(task)

        def _done(t: asyncio.Task) -> None:
            self._tasks.discard(t)
            if not t.cancelled() and t.exception() is not None:
                logger.error("incident capture failed: %r", t.exception())

        task.add_done_callback(_done)
        return True

    # ---------- the capture ----------

    async def _capture(self, reason: str, request_id: Optional[str],
                       info: dict, seq: int) -> Optional[str]:
        from .flight import flight_recorder
        from .watchdog import build_flight_artifact

        if self.config.settle_s > 0:
            await asyncio.sleep(self.config.settle_s)
        loop = asyncio.get_running_loop()
        # the global ring → merge-all artifact (every registered engine's
        # ring contributes); an injected private ring (tests, multi-
        # recorder processes) is captured explicitly
        ring = None if self.flight is flight_recorder() else self.flight

        def _assemble():
            # executor-side on purpose: the artifact walks every ring
            # and thread stack, and the history snapshot materializes
            # up to max_series x max_samples points — evidence capture
            # fires exactly when the loop is already degraded and must
            # not extend the very stall it documents (history reads are
            # off-loop safe; see telemetry/history.py)
            artifact = build_flight_artifact(
                reason=f"incident:{reason}", flight=ring)
            history_snap = (
                self.history.snapshot(self.config.history_window_s)
                if self.history is not None else None
            )
            traces = self._affected_traces(artifact, request_id)
            return artifact, history_snap, traces

        artifact, history_snap, traces = await loop.run_in_executor(
            None, _assemble)
        manifest = {
            "version": 1,
            "reason": reason,
            "time": time.time(),
            "monotonic": self.clock(),
            "pid": os.getpid(),
            "request_id": request_id,
            "info": {k: v for k, v in info.items() if v is not None},
            "flight_events": len(artifact.get("events") or []),
            "history_series": len((history_snap or {}).get("series") or []),
            "traces": [t.get("request_id") for t in traces],
        }
        # payload files land first; the profiler window (if any) captures
        # INTO the bundle; the manifest lands last to mark it complete —
        # list_bundles treats a manifest-less dir as a capture in flight
        path = await loop.run_in_executor(
            None, self._write_payload, artifact, history_snap,
            traces, reason,
        )
        profile_note = await self._maybe_profile(path)
        if profile_note:
            manifest["profile"] = profile_note
        await loop.run_in_executor(
            None, self._finalize_bundle, path, manifest)
        manifest["path"] = path
        self.captures += 1
        self._captured_c.inc(reason=reason)
        self.bundles.append(manifest)
        self.flight.record("incident.captured", reason=reason,
                           request_id=request_id, path=path)
        if path:
            logger.error("INCIDENT [%s] bundle captured at %s "
                         "(%d events, %d traces)", reason, path,
                         manifest["flight_events"], len(traces))
        else:
            logger.error("INCIDENT [%s] captured in memory only — set "
                         "%s to persist bundles", reason, INCIDENT_DIR_ENV)
        return path

    def _affected_traces(self, artifact: dict,
                         request_id: Optional[str]) -> List[dict]:
        """Completed traces correlated with the incident: the triggering
        request plus every id the flight ring saw recently."""
        affected = set()
        if request_id:
            affected.add(request_id)
        for e in artifact.get("events") or []:
            for k in ("request_id", "trace_id"):
                if e.get(k):
                    affected.add(e[k])
        for src in artifact.get("sources") or []:
            for row in src.get("requests") or []:
                for k in ("request_id", "trace_id"):
                    if row.get(k):
                        affected.add(row[k])
        out = []
        for trace in artifact.get("traces") or []:
            rid = trace.get("request_id")
            if rid in affected:
                out.append(trace)
        return out[-self.config.max_traces:]

    async def _maybe_profile(self, bundle: Optional[str]) -> Optional[dict]:
        if self.config.profile_s <= 0:
            return None
        if not bundle:
            return {"skipped": "no incident dir configured"}
        from ..utils.profiling import CaptureBusyError, capture_trace_async

        try:
            # captured INSIDE the bundle (profile/), so pruning the bundle
            # removes its multi-MB trace with it instead of orphaning it
            trace_dir = await capture_trace_async(
                os.path.join(bundle, "profile"), self.config.profile_s)
            return {"trace_dir": trace_dir,
                    "seconds": self.config.profile_s}
        except CaptureBusyError:
            # a manual /debug/profile (or a racing incident) holds the
            # process-wide profiler lock — skip, never crash mid-capture
            return {"skipped": "another profiler capture is in flight"}
        except Exception as e:
            logger.warning("incident profile capture failed: %s", e)
            return {"error": repr(e)}

    def _write_payload(self, artifact: dict, history_snap: Optional[dict],
                       traces: List[dict], reason: str) -> Optional[str]:
        """Blocking payload write (executor-side): the bundle dir + every
        file EXCEPT the manifest (see :meth:`_finalize_bundle`)."""
        out_dir = self.config.out_dir or incident_dir()
        if not out_dir:
            return None
        name = f"incident-{os.getpid()}-{time.monotonic_ns()}-{reason}"
        bundle = os.path.join(out_dir, name)
        os.makedirs(bundle, exist_ok=False)
        files = {"flight.json": artifact, "traces.json": traces}
        if history_snap is not None:
            files["history.json"] = history_snap
        for fname, payload in files.items():
            with open(os.path.join(bundle, fname), "w") as f:
                json.dump(payload, f, default=str, indent=1)
        return bundle

    def _finalize_bundle(self, bundle: Optional[str],
                         manifest: dict) -> None:
        """Blocking manifest write + prune (executor-side). The manifest
        lands LAST: its presence marks a complete bundle."""
        if not bundle:
            return
        files = [f for f in os.listdir(bundle) if f != MANIFEST]
        if os.path.isdir(os.path.join(bundle, "profile")):
            files = [f if f != "profile" else "profile/" for f in files]
        manifest["files"] = sorted([MANIFEST, *files])
        manifest["bundle"] = os.path.basename(bundle)
        with open(os.path.join(bundle, MANIFEST), "w") as f:
            json.dump(manifest, f, default=str, indent=1)
        self._prune_bundles(os.path.dirname(bundle))

    @staticmethod
    def _bundle_mtime(out_dir: str, name: str) -> float:
        """Chronological sort key: manifest mtime (= completion time),
        falling back to the dir's own for an in-flight capture. Bundle
        NAMES don't order — monotonic_ns isn't comparable across hosts
        sharing an incident volume, and a lexicographic sort would
        compare pid digits first (and break across digit-count
        boundaries), pruning fresh evidence while keeping stale."""
        for p in (os.path.join(out_dir, name, MANIFEST),
                  os.path.join(out_dir, name)):
            try:
                return os.path.getmtime(p)
            except OSError:
                continue
        return 0.0

    def _prune_bundles(self, out_dir: str) -> None:
        import shutil

        bundles = sorted(
            (d for d in os.listdir(out_dir)
             if _BUNDLE_RE.match(d)
             and os.path.isdir(os.path.join(out_dir, d))),
            key=lambda d: self._bundle_mtime(out_dir, d),
        )
        while len(bundles) > self.config.max_bundles:
            victim = bundles.pop(0)  # oldest completion first
            shutil.rmtree(os.path.join(out_dir, victim), ignore_errors=True)

    # ---------- listing / fetching ----------

    def list_bundles(self) -> List[dict]:
        """Manifests of every complete on-disk bundle, oldest first.
        Blocking (disk walk) — async callers use the executor."""
        out_dir = self.config.out_dir or incident_dir()
        if not out_dir or not os.path.isdir(out_dir):
            return []
        out = []
        for name in sorted(os.listdir(out_dir),
                           key=lambda d: self._bundle_mtime(out_dir, d)):
            if not _BUNDLE_RE.match(name):
                continue
            mpath = os.path.join(out_dir, name, MANIFEST)
            try:
                with open(mpath) as f:
                    out.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                continue  # incomplete bundle (capture in flight)
        return out

    def load_bundle(self, bundle_id: str) -> Optional[dict]:
        """One bundle's manifest + payload files. Blocking — executor."""
        out_dir = self.config.out_dir or incident_dir()
        if not out_dir or not _BUNDLE_RE.match(bundle_id):
            return None
        return load_bundle_dir(os.path.join(out_dir, bundle_id))

    async def handle_debug_incidents(self, request, conn=None):
        """GET /debug/incidents[?id=<bundle>] — list manifests, or fetch
        one bundle's full contents."""
        from ..http.server import json_response

        loop = asyncio.get_running_loop()
        bundle_id = request.query.get("id")
        if bundle_id:
            bundle = await loop.run_in_executor(
                None, self.load_bundle, bundle_id)
            if bundle is None:
                return json_response(
                    {"error": f"no bundle {bundle_id!r}"}, status=404)
            return json_response(bundle, default=str)
        manifests = await loop.run_in_executor(None, self.list_bundles)
        return json_response({
            "dir": self.config.out_dir or incident_dir(),
            "bundles": manifests,
        })


def load_bundle_dir(path: str) -> Optional[dict]:
    """Read one bundle directory (manifest + payload files): the
    recorder's endpoint, and any offline reader."""
    mpath = os.path.join(path, MANIFEST)
    try:
        with open(mpath) as f:
            out = {"manifest": json.load(f)}
    except (OSError, json.JSONDecodeError):
        return None
    for fname, key in (("flight.json", "flight"),
                       ("history.json", "history"),
                       ("traces.json", "traces")):
        fpath = os.path.join(path, fname)
        if os.path.exists(fpath):
            try:
                with open(fpath) as f:
                    out[key] = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                out[key] = None
                out.setdefault("errors", []).append(f"{fname}: {e}")
    return out


# ---------- edge-probe factories ----------


def slo_probe(tracker, floor: float = 0.9,
              min_requests: int = 5) -> Callable[[], Optional[dict]]:
    """Fires when windowed SLO attainment falls below ``floor`` — the
    reference's SlaPolicy shedding threshold (slo_attainment_floor)."""

    def probe() -> Optional[dict]:
        snap = tracker.snapshot() or {}
        attainment = snap.get("slo.attainment")
        if attainment is None:
            return None
        # a 1-request window breaching the floor is noise, not an incident
        judged = tracker.window_count()
        if judged < min_requests:
            return None
        if attainment < floor:
            return {"reason": "slo_floor", "attainment": round(attainment, 4),
                    "floor": floor, "window_requests": judged}
        return None

    return probe


def late_compile_probe(compiles, burst: int = 3, window_s: float = 60.0,
                       clock: Callable[[], float] = time.monotonic,
                       ) -> Callable[[], Optional[dict]]:
    """Fires when the CompileTracker records ``burst`` or more LATE first
    dispatches within ``window_s`` — the recompile-storm signal escalated
    from a log line to a bundle."""
    marks: collections.deque = collections.deque()
    seen = {"count": 0}

    def probe() -> Optional[dict]:
        now = clock()
        late = compiles.late_compiles
        new = late - seen["count"]
        seen["count"] = late
        for _ in range(max(0, new)):
            marks.append(now)
        while marks and marks[0] < now - window_s:
            marks.popleft()
        if len(marks) >= burst:
            return {"reason": "late_compile_burst",
                    "late_compiles_in_window": len(marks),
                    "window_s": window_s}
        return None

    return probe
