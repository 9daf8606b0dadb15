"""SLO attainment + goodput accounting at the HTTP edge.

The port's copy of ``dynamo_tpu/telemetry/slo.py``.

Queue depths and slot occupancy are proxies; what the user experiences
is TTFT and inter-token latency. This module measures BOTH per request
at the edge (http/metrics.py stamps first-token and per-token times as
the chunks stream out) against configurable targets
(``--slo-ttft-ms`` / ``--slo-itl-ms``) and exports:

- ``dynamo_slo_attainment_total{slo=ttft|itl, met=true|false}`` — per-
  request attainment counters (ITL is judged on the request's WORST
  inter-token gap: one visible stall breaks the stream's feel, however
  good the mean looks);
- ``dynamo_slo_goodput_tokens_total`` — tokens produced by requests
  that met every configured target. ``rate()`` of this series is
  goodput: SLO-met tokens/s, the number a capacity plan should optimize
  instead of raw throughput;
- ``dynamo_slo_target_seconds{slo}`` — the configured targets, so
  dashboards label themselves.

``snapshot()`` is the reference's planner signal source: rolling-window
attainment fractions + goodput rate under the ``slo.*`` names. The port
has no planner yet; the incident recorder's ``slo_probe`` reads it.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Optional, Tuple


class SloTracker:
    """Per-request SLO verdicts + rolling attainment for the planner.

    ``ttft_s`` / ``itl_s``: targets in seconds; ``None`` leaves that
    dimension unjudged (a request meets it trivially). Construct with at
    least one target — the CLI only builds a tracker when an SLO flag is
    set.
    """

    def __init__(
        self,
        ttft_s: Optional[float] = None,
        itl_s: Optional[float] = None,
        window_s: float = 60.0,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        from .registry import MetricsRegistry

        self.ttft_s = ttft_s
        self.itl_s = itl_s
        self.window_s = window_s
        self.clock = clock
        self._created_t = clock()
        # rolling (t, ttft_ok, itl_ok, met, tokens) request verdicts
        self._window: Deque[Tuple[float, bool, bool, bool, int]] = (
            collections.deque(maxlen=4096)
        )
        self.requests = 0
        self.met_requests = 0
        self.goodput_tokens = 0

        self.registry = registry or MetricsRegistry()
        self._attain = self.registry.counter(
            "dynamo_slo_attainment_total",
            "Per-request SLO verdicts at the HTTP edge, labelled "
            "slo=ttft|itl and met=true|false (ITL judged on the worst "
            "inter-token gap of the stream)",
        )
        self._goodput = self.registry.counter(
            "dynamo_slo_goodput_tokens_total",
            "Tokens produced by requests that met every configured SLO "
            "— rate() of this series is goodput (SLO-met tokens/s)",
        )
        target = self.registry.gauge(
            "dynamo_slo_target_seconds",
            "Configured SLO targets, labelled slo=ttft|itl",
        )
        if ttft_s is not None:
            target.set(float(ttft_s), slo="ttft")
        if itl_s is not None:
            target.set(float(itl_s), slo="itl")

    # ---------- per-request verdicts ----------

    def observe(self, ttft_s: Optional[float], itl_max_s: Optional[float],
                tokens: int) -> bool:
        """One completed request: edge-measured TTFT, worst inter-token
        gap (None when the stream had < 2 tokens), and token count.
        Returns whether every configured target was met."""
        ttft_ok = (
            self.ttft_s is None
            or (ttft_s is not None and ttft_s <= self.ttft_s)
        )
        itl_ok = (
            self.itl_s is None
            or itl_max_s is None          # single-token: no gaps to judge
            or itl_max_s <= self.itl_s
        )
        judged = False
        if self.ttft_s is not None:
            self._attain.inc(slo="ttft", met="true" if ttft_ok else "false")
            judged = True
        if self.itl_s is not None and itl_max_s is not None:
            self._attain.inc(slo="itl", met="true" if itl_ok else "false")
            judged = True
        met = ttft_ok and itl_ok
        if judged:
            # the per-request conjunction, scrapeable: a remote consumer
            # (the fleet hub) can't recover "met EVERY configured SLO"
            # from the per-dimension series — blending dimensions
            # overstates attainment exactly when one dimension misses
            self._attain.inc(slo="request", met="true" if met else "false")
        self.requests += 1
        if met:
            self.met_requests += 1
            self.goodput_tokens += tokens
            self._goodput.inc(tokens)
        self._window.append((self.clock(), ttft_ok, itl_ok, met, tokens))
        # drop verdicts that have aged out of the window now, while the
        # deque head is cheap to test — snapshot()/window_count() scans
        # then touch only live rows instead of up to 4096 stale ones
        cutoff = self.clock() - self.window_s
        while self._window and self._window[0][0] < cutoff:
            self._window.popleft()
        return met

    def window_count(self) -> int:
        """Completed-request verdicts currently inside the window (the
        incident recorder's SLO probe gates on this so a 1-request blip
        can't read as a fleet incident)."""
        cutoff = self.clock() - self.window_s
        return sum(1 for r in self._window if r[0] >= cutoff)

    # ---------- planner signal source ----------

    def snapshot(self) -> dict:
        """Rolling-window SLO signals for the planner's SignalStore
        (the reference's planner/policy.py SIG_SLO_* vocabulary). Empty
        when no request completed inside the window — the policy skips
        a blind signal instead of acting on a stale one."""
        now = self.clock()
        cutoff = now - self.window_s
        # one pass over the window: verdict counts and SLO-met tokens
        n = met = ttft_met = itl_met = met_tokens = 0
        for t, ttft_ok, itl_ok, ok, tokens in self._window:
            if t >= cutoff:
                n += 1
                if ttft_ok:
                    ttft_met += 1
                if itl_ok:
                    itl_met += 1
                if ok:
                    met += 1
                    met_tokens += tokens
        if not n:
            return {}
        # goodput rate over the OBSERVATION SPAN, not the gap since the
        # oldest surviving sample: a single request completing 1 ms
        # before the poll must read as tokens-over-elapsed-serving-time,
        # never tokens-over-1ms (a 300k tok/s spike into the planner)
        span = max(min(now - self._created_t, self.window_s), 1e-9)
        if (len(self._window) == self._window.maxlen
                and self._window[0][0] > now - self.window_s):
            # capacity eviction truncated the window: in-window verdicts
            # older than the retained 4096 are gone, so dividing their
            # tokens' absence by the FULL window span would underreport
            # goodput (3x at ~200 req/s). The retained rows cover only
            # [oldest, now] — the rate over that span is the measured
            # truth, and with the deque full it's never a 1-sample spike
            span = max(now - self._window[0][0], 1e-9)
        out = {
            "slo.attainment": met / n,
            "slo.goodput_tokens_per_s": met_tokens / span,
        }
        if self.ttft_s is not None:
            out["slo.ttft_attainment"] = ttft_met / n
        if self.itl_s is not None:
            out["slo.itl_attainment"] = itl_met / n
        return out
