"""Rolling-window signal store: the planner's view of live telemetry.

The port's copy of ``dynamo_tpu/planner/signals.py``.

Every planner input — scraped worker snapshots, admission-controller
state, registry series like prefill queue-wait or watchdog trips — lands
here as a named time series of ``(t, value)`` samples. The policy engine
(``planner/policy.py``) then asks window questions ("mean queue wait over
the last 10s", "did the watchdog trip counter move?") instead of acting
on single scrapes, which is what makes hysteresis possible: one noisy
sample must never flap a replica count.

The clock is injectable so policy tests can script a feed
deterministically (scripted samples at scripted times → pinned action
sequences), matching the FakeRunner discipline the decode-pipeline
tests use.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, Mapping, Optional, Tuple


class SignalStore:
    """Bounded per-series sample windows with time-window aggregates."""

    def __init__(
        self,
        window_s: float = 120.0,
        max_samples: int = 1024,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.window_s = window_s
        self.max_samples = max_samples
        self.clock = clock
        self._series: Dict[str, Deque[Tuple[float, float]]] = {}

    # ---------- writing ----------

    def observe(self, name: str, value: float, t: Optional[float] = None) -> None:
        if t is None:
            t = self.clock()
        series = self._series.get(name)
        if series is None:
            series = self._series[name] = collections.deque(
                maxlen=self.max_samples)
        series.append((t, float(value)))
        self._prune(series, t)

    def observe_many(self, values: Mapping[str, float],
                     t: Optional[float] = None) -> None:
        if t is None:
            t = self.clock()
        for name, value in values.items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                continue  # sources may carry non-numeric snapshot fields
            self.observe(name, value, t=t)

    def _prune(self, series: Deque[Tuple[float, float]], now: float) -> None:
        cutoff = now - self.window_s
        while series and series[0][0] < cutoff:
            series.popleft()

    # ---------- reading ----------

    def names(self):
        return sorted(self._series)

    def _window(self, name: str, window_s: Optional[float]):
        series = self._series.get(name)
        if not series:
            return []
        now = self.clock()
        self._prune(series, now)
        cutoff = now - (window_s if window_s is not None else self.window_s)
        return [v for (t, v) in series if t >= cutoff]

    def latest(self, name: str, default: Optional[float] = None):
        """Newest sample INSIDE the store window — a source that stopped
        reporting goes blind after ``window_s`` instead of serving its
        last value forever (the policy skips, rather than acts on, a
        dead signal)."""
        series = self._series.get(name)
        if not series:
            return default
        self._prune(series, self.clock())
        if not series:
            return default
        return series[-1][1]

    def age(self, name: str) -> Optional[float]:
        """Seconds since the newest sample; None if the series is empty."""
        series = self._series.get(name)
        if not series:
            return None
        return self.clock() - series[-1][0]

    def mean(self, name: str, window_s: Optional[float] = None,
             default: Optional[float] = None):
        vals = self._window(name, window_s)
        if not vals:
            return default
        return sum(vals) / len(vals)

    def max(self, name: str, window_s: Optional[float] = None,
            default: Optional[float] = None):
        vals = self._window(name, window_s)
        if not vals:
            return default
        return max(vals)

    def min(self, name: str, window_s: Optional[float] = None,
            default: Optional[float] = None):
        vals = self._window(name, window_s)
        if not vals:
            return default
        return min(vals)

    def delta(self, name: str, window_s: Optional[float] = None) -> float:
        """newest - oldest inside the window: the move of a cumulative
        counter (watchdog trips, shed count) over the window; 0.0 when
        fewer than two samples exist."""
        vals = self._window(name, window_s)
        if len(vals) < 2:
            return 0.0
        return vals[-1] - vals[0]
