"""Metric history rings: bounded (t, value) series with rate queries.

The port's copy of ``dynamo_tpu/telemetry/history.py``.

A Prometheus server keeps history; this repo's registries keep only the
CURRENT value of every instrument — so the moment something goes wrong,
"what did KV usage look like over the last two minutes" is unanswerable
from inside the process, and an incident bundle captured at trip time
(telemetry/incidents.py) would carry a single point instead of a curve.
The :class:`MetricHistory` closes that gap: a bounded dict of per-series
rings — ``(name, sorted-labels)`` → deque of ``(t, value)`` — that a
scraper (telemetry/hub.py, one ring set per remote worker) or a local
sampler (:class:`LocalHistorySampler`, the process's own registry on a
cadence) appends into.

Counter semantics are first-class: a scraped counter that goes BACKWARD
means the remote process restarted, not that work un-happened. Each
series detects the reset, counts it, and accumulates a monotonic offset
so ``rate()``/``delta()`` stay correct across restarts instead of going
hugely negative for one window (the classic naive-scraper artifact).

Bounds are structural, like the flight ring's: ``max_samples`` per
series (oldest evicted), ``window_s`` age pruning, and ``max_series``
total — a cardinality explosion on a scraped worker drops NEW series
(counted on ``dropped_series``) rather than growing host memory.

Threading: writers (``observe``/``ingest``) run on the event loop only;
readers may run anywhere — the /fleet handlers ride the executor, and
``registry.render`` (which invokes the hub's callback gauges over these
rings) runs executor-side in both the sidecar server and the hub's
local scrape. Reads therefore never mutate and take GIL-atomic
``list()`` snapshots of the dict/deques before iterating, so a
concurrent loop-side insert/append can't raise mid-iteration.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, Iterable, List, Optional, Tuple

from .exposition import MetricFamily

LabelKey = Tuple[Tuple[str, str], ...]
SeriesKey = Tuple[str, LabelKey]

# exposition types treated as cumulative (reset-detected, rate-able);
# histogram _sum/_count samples are cumulative too and land as counters
_COUNTER_TYPES = ("counter", "histogram")


def label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    return tuple(sorted((labels or {}).items()))


class Series:
    """One bounded ring of (t, adjusted_value) samples.

    For counters ``adjusted`` is raw + the accumulated pre-reset offset,
    so the stored curve is monotonic across remote restarts and
    ``delta``/``rate`` never see a negative step.
    """

    __slots__ = ("kind", "points", "resets", "_offset", "_last_raw")

    def __init__(self, kind: str, max_samples: int):
        self.kind = kind  # "gauge" | "counter"
        self.points: Deque[Tuple[float, float]] = collections.deque(
            maxlen=max_samples)
        self.resets = 0
        self._offset = 0.0
        self._last_raw: Optional[float] = None

    def observe(self, t: float, raw: float) -> None:
        if self.kind == "counter":
            if self._last_raw is not None and raw < self._last_raw:
                # remote process restarted: fold the pre-reset total into
                # the offset so the adjusted curve keeps its monotonicity
                self.resets += 1
                self._offset += self._last_raw
            self._last_raw = raw
            raw = raw + self._offset
        self.points.append((t, raw))

    def prune(self, cutoff: float) -> None:
        while self.points and self.points[0][0] < cutoff:
            self.points.popleft()

    def latest(self) -> Optional[float]:
        try:
            return self.points[-1][1]  # deque[-1] is GIL-atomic
        except IndexError:
            return None

    def latest_in_window(self, cutoff: float) -> Optional[float]:
        """Newest value, or None when the series has aged past
        ``cutoff``. Non-mutating (off-loop safe) — the writer's
        ``observe`` does the real pruning."""
        try:
            t, v = self.points[-1]
        except IndexError:
            return None
        return v if t >= cutoff else None

    def delta(self, since: float) -> float:
        """adjusted(newest) - adjusted(oldest sample at/after ``since``);
        0.0 with fewer than two in-window samples."""
        window = [(t, v) for (t, v) in list(self.points) if t >= since]
        if len(window) < 2:
            return 0.0
        return window[-1][1] - window[0][1]

    def rate(self, since: float) -> float:
        """Per-second rate over the in-window samples (0.0 when the
        window holds fewer than two or spans no time)."""
        window = [(t, v) for (t, v) in list(self.points) if t >= since]
        if len(window) < 2:
            return 0.0
        dt = window[-1][0] - window[0][0]
        if dt <= 0:
            return 0.0
        return (window[-1][1] - window[0][1]) / dt


class MetricHistory:
    """Bounded per-series history rings + window queries.

    One instance per scraped worker (the hub) or per process (the local
    sampler feeding incident bundles). All methods are synchronous and
    lock-free: writers (``observe``/``ingest``) run on the event loop
    ONLY; readers never mutate and snapshot before iterating, so they
    are safe from executor threads too (the /fleet handlers, callback
    gauges invoked by an executor-side ``registry.render``).
    """

    def __init__(
        self,
        window_s: float = 600.0,
        max_samples: int = 512,
        max_series: int = 4096,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.window_s = window_s
        self.max_samples = max(2, max_samples)
        self.max_series = max(1, max_series)
        self.clock = clock
        self._series: Dict[SeriesKey, Series] = {}
        self.dropped_series = 0  # series refused by the max_series bound

    # ---------- writing ----------

    def observe(self, name: str, labels: Optional[Dict[str, str]],
                value: float, t: Optional[float] = None,
                kind: str = "gauge") -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        t = self.clock() if t is None else t
        key = (name, label_key(labels))
        series = self._series.get(key)
        if series is None:
            if len(self._series) >= self.max_series:
                self.dropped_series += 1
                return
            series = self._series[key] = Series(kind, self.max_samples)
        series.observe(t, float(value))
        series.prune(t - self.window_s)

    def ingest(self, families: Dict[str, MetricFamily],
               t: Optional[float] = None) -> None:
        """One parsed exposition (telemetry/exposition.py) → the rings.

        Histogram ``_bucket`` samples are skipped — per-``le`` series
        are the cardinality explosion the bounds exist to prevent, and
        ``_sum``/``_count`` carry everything rate queries need.
        """
        t = self.clock() if t is None else t
        for fam in families.values():
            kind = "counter" if fam.type in _COUNTER_TYPES else "gauge"
            for s in fam.samples:
                if s.name.endswith("_bucket"):
                    continue
                sample_kind = kind
                if fam.type == "histogram" and not (
                        s.name.endswith("_sum") or s.name.endswith("_count")):
                    sample_kind = "gauge"  # stray sample in a histogram family
                self.observe(s.name, s.labels, s.value, t=t,
                             kind=sample_kind)

    # ---------- reading ----------

    def series_count(self) -> int:
        return len(self._series)

    def names(self) -> List[str]:
        return sorted({name for (name, _) in list(self._series)})

    def kind(self, name: str) -> Optional[str]:
        """``"counter"`` if any series of ``name`` is cumulative,
        ``"gauge"`` otherwise, ``None`` for an unknown name."""
        kinds = {s.kind for _, s in self._match(name, None)}
        if not kinds:
            return None
        return "counter" if "counter" in kinds else "gauge"

    def name_summaries(self, window_s: Optional[float] = None,
                       prefix: str = "") -> Dict[str, dict]:
        """Single-pass per-name rollup over in-window series:
        ``{name: {"latest": label-set sum, "kind": counter-if-any,
        "rate": summed per-second rate (counter series only)}}``.

        The hub's ``GET /fleet/metrics`` walks every name of every
        worker on each poll — per-name ``latest``/
        ``kind``/``rate`` calls would each rescan the whole series dict,
        going quadratic in series count. Off-loop safe like every
        reader."""
        now = self.clock()
        cutoff = now - self.window_s
        since = now - (window_s if window_s is not None else self.window_s)
        out: Dict[str, dict] = {}
        for (name, _), series in list(self._series.items()):
            if prefix and not name.startswith(prefix):
                continue
            v = series.latest_in_window(cutoff)
            if v is None:
                continue
            entry = out.setdefault(
                name, {"latest": 0.0, "kind": series.kind, "rate": 0.0})
            entry["latest"] += v
            if series.kind == "counter":
                entry["kind"] = "counter"
                entry["rate"] += series.rate(since)
        return out

    def _match(self, name: str,
               labels: Optional[Dict[str, str]]) -> Iterable[Tuple[SeriesKey, Series]]:
        """Series of ``name`` whose labels are a superset of ``labels``.
        Iterates a GIL-atomic snapshot: safe against loop-side inserts
        when the caller runs off-loop."""
        want = (labels or {}).items()
        for key, series in list(self._series.items()):
            if key[0] != name:
                continue
            have = dict(key[1])
            if all(have.get(k) == v for k, v in want):
                yield key, series

    def samples(self, name: str,
                labels: Optional[Dict[str, str]] = None,
                ) -> List[Tuple[Dict[str, str], float]]:
        """Latest in-window value per matching label set."""
        cutoff = self.clock() - self.window_s
        out = []
        for key, series in self._match(name, labels):
            v = series.latest_in_window(cutoff)
            if v is not None:
                out.append((dict(key[1]), v))
        return out

    def latest(self, name: str, labels: Optional[Dict[str, str]] = None,
               default: Optional[float] = None) -> Optional[float]:
        """Newest in-window value summed across matching label sets
        (one series → its value; labelled counters → the family total)."""
        vals = [v for _, v in self.samples(name, labels)]
        if not vals:
            return default
        return sum(vals)

    def delta(self, name: str, labels: Optional[Dict[str, str]] = None,
              window_s: Optional[float] = None) -> float:
        since = self.clock() - (window_s if window_s is not None
                                else self.window_s)
        return sum(s.delta(since) for _, s in self._match(name, labels))

    def rate(self, name: str, labels: Optional[Dict[str, str]] = None,
             window_s: Optional[float] = None) -> float:
        since = self.clock() - (window_s if window_s is not None
                                else self.window_s)
        return sum(s.rate(since) for _, s in self._match(name, labels))

    def resets(self, name: str,
               labels: Optional[Dict[str, str]] = None) -> int:
        return sum(s.resets for _, s in self._match(name, labels))

    def window(self, name: str, labels: Optional[Dict[str, str]] = None,
               window_s: Optional[float] = None,
               ) -> List[Tuple[float, float]]:
        """Chronological in-window points, merged across matching label
        sets (single-series names — the common bundle/sparkline case)."""
        since = self.clock() - (window_s if window_s is not None
                                else self.window_s)
        pts: List[Tuple[float, float]] = []
        for _, series in self._match(name, labels):
            pts.extend(p for p in list(series.points) if p[0] >= since)
        pts.sort(key=lambda p: p[0])
        return pts

    def snapshot(self, window_s: Optional[float] = None,
                 names: Optional[Iterable[str]] = None) -> dict:
        """JSON-ready dump of every ring (the incident bundle's
        ``history.json``): per-series kind, labels, resets, and the
        in-window points with BOTH the monotonic t and a wall estimate
        so offline tooling can label the x axis."""
        window_s = self.window_s if window_s is None else window_s
        now = self.clock()
        wall_now = time.time()
        since = now - window_s
        keep = set(names) if names is not None else None
        series_out = []
        for (name, lk), series in sorted(list(self._series.items())):
            if keep is not None and name not in keep:
                continue
            pts = [(t, v) for (t, v) in list(series.points) if t >= since]
            if not pts:
                continue
            series_out.append({
                "name": name,
                "labels": dict(lk),
                "kind": series.kind,
                "resets": series.resets,
                "points": [
                    [round(t - now, 3), round(wall_now + (t - now), 3), v]
                    for (t, v) in pts
                ],
            })
        return {
            "window_s": window_s,
            "time": wall_now,
            "dropped_series": self.dropped_series,
            "series": series_out,
        }


class LocalHistorySampler:
    """Samples the process's OWN registry into a :class:`MetricHistory`.

    The in-process sibling of the hub's remote scrape: render → parse →
    ingest on a cadence, so the incident recorder always has the last
    few minutes of local metric history to bundle at trip time. Render
    and parse ride the executor (they walk every instrument), and the
    task is held and cancelled on ``stop()``.
    """

    def __init__(self, registry, history: Optional[MetricHistory] = None,
                 interval_s: float = 5.0,
                 window_s: float = 600.0):
        self.registry = registry
        self.history = history if history is not None else MetricHistory(
            window_s=window_s)
        self.interval_s = max(0.02, interval_s)
        self._task = None

    def start(self) -> "LocalHistorySampler":
        import asyncio

        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="metric-history-sampler")
        return self

    async def stop(self) -> None:
        import asyncio

        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def sample_once(self) -> None:
        import asyncio

        from .exposition import parse_exposition

        loop = asyncio.get_running_loop()
        families = await loop.run_in_executor(
            None, lambda: parse_exposition(self.registry.render()))
        self.history.ingest(families)

    async def _run(self) -> None:
        import asyncio
        import logging

        log = logging.getLogger(__name__)
        while True:
            try:
                await self.sample_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # a broken instrument must not kill history collection —
                # the ring's whole job is being there when things break
                log.exception("metric history sample failed; continuing")
            await asyncio.sleep(self.interval_s)
