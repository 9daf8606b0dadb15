"""Live device-time accounting + serving-time roofline attribution.

The port's copy of ``dynamo_tpu/telemetry/device_time.py``. The scheduler
already observes every dispatch's completion (the synchronous path's
executor host sync, the dispatch-ahead pipeline's reconciliation, the
chained loop's ``HostCopy.ready()`` drain, which is an event query), so
each observation feeds a :class:`DeviceTimeTracker` that derives, with
**zero added host syncs on the hot path**:

- ``dynamo_engine_device_time_seconds{program,phase}`` — per-burst
  device-busy durations (histogram: the ``_sum`` is cumulative busy
  time, the buckets its distribution);
- ``dynamo_engine_device_busy_ratio{phase}`` — busy vs. bubble over a
  rolling window (1.0 = the device never waited for the host);
- ``dynamo_engine_roofline_fraction`` — achieved HBM bytes/s over the
  card's peak for the decode phase: every decode step must stream the
  weights once plus each live row's KV context, so
  ``bytes = steps × (param_bytes + Σ ctx_i × kv_bytes_per_token)`` and
  ``fraction = (bytes / busy_s) / peak``, the serving-time twin of the
  reference's ``bench.py`` ``vs_baseline``.

Busy time uses a serialized-interval estimator: the device executes its
queue in order, so for observations arriving in completion order the
busy contribution of one program is ``ready − max(dispatch,
previous_ready)`` and the gap ``dispatch − previous_ready`` (when
positive) is a bubble — the device genuinely ran dry. Under chained
dispatch the intervals overlap and the estimator correctly collapses
them instead of double-counting.

Measurement points are the host's EXISTING synchronization seams; the
only approximation is that a ready time is observed when the host
reconciles (is_ready probe or executor sync), which can trail the true
device completion by the drain lag. That skews busy UP and bubbles DOWN
— conservative in the direction that matters (a reported bubble is
always real).

What "busy" counts on a card: the reference's TPU dispatch is ONE device
program, so ``ready − max(dispatch, previous ready)`` is device time. An
eager PyTorch dispatch is hundreds of kernel launches issued by the host,
and the device waits between them; the interval still runs from dispatch
to ready, so the gaps between launches inside one dispatch count as busy.
With the dispatch-ahead loop the gauge reads near 1.0 while a profiler's
kernel-busy share of the same decode window is far lower (PERF.md §5
holds both, measured on the card). CUDA events bracket the same launch
gaps, so they would not change that; CUDA graphs would close it.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Callable, Deque, Optional, Tuple

# one card's HBM bandwidth, the roofline denominator: an H100 SXM's
# 3.35 TB/s (NVIDIA's data sheet); DYN_HBM_GBPS overrides it for another
# card (an H100 PCIe's 2,000, say)
HBM_GBPS_ENV = "DYN_HBM_GBPS"
H100_SXM_HBM_GBPS = 3350.0
DEFAULT_HBM_GBPS = H100_SXM_HBM_GBPS

# device-time histogram ladder: bursts are sub-millisecond to ~seconds
DEVICE_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0,
)


class DeviceTimeTracker:
    """Per-program device-busy accounting + live roofline fraction.

    ``observe()`` is called at host reconciliation seams only — it does
    pure float arithmetic and registry updates, never a device sync.
    """

    def __init__(
        self,
        param_bytes: float = 0.0,
        kv_bytes_per_token: float = 0.0,
        hbm_gbps: Optional[float] = None,
        window_s: float = 60.0,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        from .registry import MetricsRegistry

        self.param_bytes = float(param_bytes)
        self.kv_bytes_per_token = float(kv_bytes_per_token)
        if hbm_gbps is None:
            try:
                hbm_gbps = float(os.environ.get(HBM_GBPS_ENV, "")
                                 or DEFAULT_HBM_GBPS)
            except ValueError:
                hbm_gbps = DEFAULT_HBM_GBPS
        self.peak_bytes_per_s = float(hbm_gbps) * 1e9
        self.window_s = window_s
        self.clock = clock
        self._last_ready_t: Optional[float] = None
        # rolling (t, phase, busy_s, bubble_s, bytes) samples for the
        # live gauges; lifetime totals back them up when traffic pauses
        self._window: Deque[Tuple[float, str, float, float, float]] = (
            collections.deque(maxlen=4096)
        )
        self.busy_s: dict = {}      # phase → lifetime busy seconds
        self.bubble_s: dict = {}    # phase → lifetime bubble seconds
        self.decode_bytes = 0.0     # lifetime decode HBM-read bytes
        self.decode_tokens = 0
        # lifetime byte-carrying prefill observations (the SP ladder's
        # byte model) — folded into the roofline beside decode bytes
        self.prefill_bytes = 0.0
        self.prefill_byte_busy_s = 0.0
        self.observations = 0

        # private registry by default; the scheduler attaches it so the
        # series render in the engine's scrape (CompileTracker idiom)
        self.registry = registry or MetricsRegistry()
        self._time_hist = self.registry.histogram(
            "dynamo_engine_device_time_seconds",
            "Per-dispatch device-busy duration at the host's "
            "reconciliation seams, labelled program= and phase="
            "prefill|decode (the _sum series is cumulative device time)",
            buckets=DEVICE_TIME_BUCKETS,
        )
        self.registry.callback_gauge(
            "dynamo_engine_device_busy_ratio",
            "Device busy / (busy + bubble) per phase over the rolling "
            "window — 1.0 means the device never waited for the host",
            self._busy_ratios,
        )
        self.registry.callback_gauge(
            "dynamo_engine_roofline_fraction",
            "Achieved decode HBM bytes/s over the card's peak bandwidth "
            "(weights once + live rows' KV per step; DYN_HBM_GBPS, default "
            "an H100 SXM's 3350)",
            self._roofline,
        )

    # ---------- observations (host reconciliation seams) ----------

    def decode_read_bytes(self, k_steps: int,
                          context_tokens: int) -> float:
        """HBM bytes one K-step decode burst must stream: the weights
        once per step plus the live rows' KV contexts
        (``context_tokens`` = Σ context lengths across the rows)."""
        return float(k_steps) * (
            self.param_bytes + context_tokens * self.kv_bytes_per_token
        )

    def sp_prefill_read_bytes(self, chunks: int, context_tokens: int,
                              kernel: bool = False) -> float:
        """HBM bytes one sequence-parallel prefill LADDER must stream
        (the scheduler observes the whole ladder at its single drain
        seam, whose busy window covers every queued chunk): the weights
        once per chunk, each chunk's committed prefix (triangular sum
        ≈ ctx·(chunks−1)/2 tokens), and the full context's KV written
        once. ``kernel`` selects the kernel route's prefix traffic
        (kernel 6, ``ops/sp_prefix.py``, streams cache pages straight into
        the online softmax: one pass per prefix token; the route on a
        card); the plain gather route (the CPU's) pays three: the cache
        read, the materialized [W·bs]-token gather write, and its re-read
        by attention."""
        prefix = context_tokens * max(0, chunks - 1) / 2.0
        passes = 1.0 if kernel else 3.0
        return float(chunks) * self.param_bytes + (
            self.kv_bytes_per_token * (passes * prefix + context_tokens)
        )

    def observe(self, program: str, phase: str, dispatch_t: float,
                ready_t: float, read_bytes: float = 0.0,
                tokens: int = 0) -> float:
        """One program completion: dispatch and host-observed ready
        times (monotonic). Returns the busy seconds attributed."""
        last = self._last_ready_t
        if last is None:
            start, bubble = dispatch_t, 0.0
            self._last_ready_t = ready_t
        else:
            # max() spelled out: this runs once a program on the hot path
            start = last if last > dispatch_t else dispatch_t
            bubble = start - last if start > last else 0.0
            if not last:
                self._last_ready_t = ready_t
            elif ready_t > last:
                self._last_ready_t = ready_t
        busy = ready_t - start if ready_t > start else 0.0
        self.observations += 1
        self.busy_s[phase] = self.busy_s.get(phase, 0.0) + busy
        if bubble:
            self.bubble_s[phase] = self.bubble_s.get(phase, 0.0) + bubble
        if phase == "decode":
            self.decode_bytes += read_bytes
            self.decode_tokens += tokens
        elif program == "prefill_sp" and read_bytes:
            # the SP ladder's modelled bytes feed the roofline beside
            # decode — real HBM traffic either way. Other prefill
            # observations stay out even if a caller passes bytes: only
            # programs with an explicit byte model may shape the gauge.
            self.prefill_bytes += read_bytes
            self.prefill_byte_busy_s += busy
        self._time_hist.observe(busy, program=program, phase=phase)
        byte_sample = (
            read_bytes
            if (phase == "decode" or program == "prefill_sp") else 0.0
        )
        self._window.append((self.clock(), phase, busy, bubble,
                             byte_sample))
        return busy

    def idle(self) -> None:
        """The device ran out of work entirely (request-starved idle):
        reset the serialization point so the wait for the NEXT request
        is never charged as a bubble — matching the scheduler's own
        bubble-clock reset when it sleeps."""
        self._last_ready_t = None

    # ---------- live gauges ----------

    def _samples(self):
        cutoff = self.clock() - self.window_s
        # list() first: this renders off-loop while the reconciliation
        # seams append — iterating the live deque during an append
        # raises "deque mutated during iteration"
        return [s for s in list(self._window) if s[0] >= cutoff]

    # registry render callbacks — run wherever /metrics renders
    # dynrace: domain(executor)
    def _busy_ratios(self):
        samples = self._samples()
        agg: dict = {}
        for _, phase, busy, bubble, _b in samples:
            b, g = agg.get(phase, (0.0, 0.0))
            agg[phase] = (b + busy, g + bubble)
        out = []
        for phase, (busy, bubble) in sorted(agg.items()):
            if busy + bubble > 0:
                out.append(({"phase": phase}, busy / (busy + bubble)))
        return out

    # dynrace: domain(executor)
    def _roofline(self):
        if not self.peak_bytes_per_s:
            return []
        # every byte-carrying observation counts: decode steps always
        # model their reads; prefill observations carry bytes only when
        # the SP ladder modelled them (dense-ladder prefill stays out —
        # its bytes are unmodelled, so counting its busy time would
        # deflate the fraction)
        samples = [s for s in self._samples()
                   if s[1] == "decode" or s[4] > 0]
        busy = sum(s[2] for s in samples)
        read = sum(s[4] for s in samples)
        if busy <= 0 or read <= 0:
            # nothing inside the window: fall back to lifetime totals
            # so a scrape just after a burst of traffic isn't blind
            busy = (self.busy_s.get("decode", 0.0)
                    + self.prefill_byte_busy_s)
            read = self.decode_bytes + self.prefill_bytes
        if busy <= 0 or read <= 0:
            return []
        return [({}, (read / busy) / self.peak_bytes_per_s)]
