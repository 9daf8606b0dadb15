"""Per-request trace spans: recorder + breakdown rendering.

The port's copy of ``dynamo_tpu/telemetry/tracing.py``.

A request's trace id is assigned at ingress (the HTTP frontend honors
``X-Request-Id``) and travels on the request's
:class:`~dynamo_tpu_torch.runtime.engine.AsyncEngineContext` — the same object
the scheduler stamps stages onto (``admission`` → ``prefill`` →
``first_token`` → ``completion``) and whose id rides the runtime
messaging envelope so disaggregated remote-prefill hops carry context.

Completed traces land in a bounded ring buffer, queryable at
``GET /debug/requests/{id}``, and are optionally appended as JSONL to the
file named by ``DYN_TRACE_JSONL`` (one object per request — the
machine-shippable sibling of ``DYN_LOGGING_JSONL``).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import queue
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

TRACE_JSONL_ENV = "DYN_TRACE_JSONL"
TRACE_TTL_ENV = "DYN_TRACE_TTL_S"
TRACE_CAPACITY_ENV = "DYN_TRACE_CAPACITY"
DEFAULT_TTL_S = 600.0
DEFAULT_CAPACITY = 512

# live recorders, for the flight artifact's traces section (watchdog.
# build_flight_artifact) — weak so a torn-down service never pins one
_RECORDERS: "weakref.WeakSet" = weakref.WeakSet()


def recorders() -> List["TraceRecorder"]:
    return list(_RECORDERS)


def span_breakdown(stages: List[Tuple[str, float]],
                   end: Optional[float] = None) -> List[dict]:
    """[(name, t_monotonic)] → spans with offsets and durations.

    Span ``X`` is the time from the PREVIOUS mark to the moment ``X``
    was stamped — marks record phase completions (the scheduler stamps
    ``prefill`` when prefill finishes), so attributing each gap to its
    closing mark is what makes "prefill took 41ms" land under
    ``prefill`` rather than under whatever mark happened to precede it.
    The first mark anchors t=0; the tail from the last mark to ``end``
    (default: now) is reported as ``egress``.
    """
    if not stages:
        return []
    t0 = stages[0][1]
    closed = list(stages) + [("egress", end if end is not None else time.monotonic())]
    return [
        {
            "name": name_next,
            "offset_s": round(t - t0, 6),
            "duration_s": round(max(0.0, t_next - t), 6),
        }
        for (_, t), (name_next, t_next) in zip(closed, closed[1:])
    ]


class TraceRecorder:
    """Bounded ring of completed request traces (+ optional JSONL sink).

    Retention is bounded TWO ways so million-user traffic cannot grow
    trace memory without limit: ``capacity`` is a max-entries LRU bound
    (oldest completed trace evicted first) and ``ttl_s`` expires traces
    by age regardless of traffic (0 disables). Both are knobs
    (``--trace-capacity`` / ``--trace-ttl-s``, or the DYN_TRACE_* env
    vars) and every eviction counts on
    ``dynamo_trace_evicted_total{reason=capacity|ttl}``.
    """

    def __init__(self, capacity: Optional[int] = None,
                 jsonl_path: Optional[str] = None,
                 jsonl_queue_size: int = 1024,
                 ttl_s: Optional[float] = None,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic):
        if capacity is None:
            try:
                capacity = int(os.environ.get(TRACE_CAPACITY_ENV, "")
                               or DEFAULT_CAPACITY)
            except ValueError:
                capacity = DEFAULT_CAPACITY
        if ttl_s is None:
            try:
                ttl_s = float(os.environ.get(TRACE_TTL_ENV, "")
                              or DEFAULT_TTL_S)
            except ValueError:
                ttl_s = DEFAULT_TTL_S
        self.capacity = max(1, capacity)
        self.ttl_s = max(0.0, ttl_s)
        self.clock = clock
        self._ingest_t: Dict[str, float] = {}  # request id → ingest time
        # store mutations lock: record() runs on the event loop, but
        # get()/recent() prune too and are called from watchdog/executor
        # threads (flight-artifact assembly) — an unlocked prune racing
        # a record could evict a just-written trace or KeyError mid-pop
        self._store_lock = threading.Lock()
        self.evicted = 0  # lifetime evictions (both reasons)
        self._evicted_c = None
        if registry is not None:
            self.register_into(registry)
        _RECORDERS.add(self)
        self.jsonl_path = (
            jsonl_path if jsonl_path is not None
            else os.environ.get(TRACE_JSONL_ENV) or None
        )
        # record() runs on the event loop (HttpService calls it per
        # request), so ALL sink IO — the open included — happens on a
        # dedicated single writer thread behind a BOUNDED queue: FIFO
        # ordering is preserved, a slow (network) filesystem can't stall
        # concurrent requests, and a HUNG one can't grow memory without
        # bound — excess traces are dropped and counted instead
        self._sink = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, jsonl_queue_size))
        self._writer: Optional[threading.Thread] = None
        self._stop = threading.Event()  # close() signal; survives a full queue
        self._abandoned = False  # close() gave up: the writer owns the sink
        self.dropped = 0  # traces not written because the queue was full
        self._traces: "collections.OrderedDict[str, dict]" = collections.OrderedDict()

    def register_into(self, registry) -> None:
        """Register the eviction counter + store gauge into a
        MetricsRegistry (the HTTP service attaches its own)."""
        self._evicted_c = registry.counter(
            "dynamo_trace_evicted_total",
            "Completed traces evicted from the debug store, by reason="
            "capacity (max-entries LRU) | ttl (age bound)",
        )
        registry.callback_gauge(
            "dynamo_trace_store_requests",
            "Completed traces currently held in the debug store",
            # dynrace: domain(executor)
            lambda: len(self._traces),
        )

    def _evict(self, reason: str, n: int = 1) -> None:
        self.evicted += n
        if self._evicted_c is not None:
            self._evicted_c.inc(n, reason=reason)

    def _prune(self, now: Optional[float] = None) -> None:
        """TTL + capacity enforcement (lazy: on record and on reads).
        Callers hold ``_store_lock``."""
        now = self.clock() if now is None else now
        if self.ttl_s:
            cutoff = now - self.ttl_s
            expired = 0
            # insertion order == recency order: stop at the first fresh
            for rid in list(self._traces):
                if self._ingest_t.get(rid, now) > cutoff:
                    break
                self._traces.pop(rid, None)
                self._ingest_t.pop(rid, None)
                expired += 1
            if expired:
                self._evict("ttl", expired)
        while len(self._traces) > self.capacity:
            rid, _ = self._traces.popitem(last=False)
            self._ingest_t.pop(rid, None)
            self._evict("capacity")

    def _sink_write(self, line: str) -> None:
        try:
            if self._sink is None:
                self._sink = open(self.jsonl_path, "a", buffering=1)
            self._sink.write(line)
        except (OSError, ValueError):
            logger.warning("trace JSONL write to %s failed",
                           self.jsonl_path, exc_info=True)

    def _drain(self) -> None:
        try:
            while True:
                try:
                    line = self._queue.get(timeout=1.0)
                except queue.Empty:
                    # the stop flag (not just the sentinel) ends the loop:
                    # a sentinel can fail to enqueue into a full queue, and
                    # a writer that later recovers must still terminate
                    if self._stop.is_set():
                        return
                    continue
                if line is None:  # close() sentinel
                    return
                self._sink_write(line)
        finally:
            if self._abandoned and self._sink is not None:
                # close() already returned without the sink — it's ours now
                self._sink.close()
                self._sink = None

    def record(
        self,
        request_id: str,
        model: str,
        status: str,
        stages: List[Tuple[str, float]],
        end: Optional[float] = None,
        ctx=None,
    ) -> dict:
        """Record one completed request. ``ctx`` (the request's
        AsyncEngineContext, optional) contributes the cross-process
        pieces: the wall anchor of the first mark (``t0_wall``) and any
        remote span sets collected from downstream hops — what
        ``GET /debug/trace/{id}`` stitches into one timeline."""
        end = end if end is not None else time.monotonic()
        spans = span_breakdown(stages, end)
        trace = {
            "request_id": request_id,
            "model": model,
            "status": status,
            "time": time.time(),
            "total_s": round(end - stages[0][1], 6) if stages else 0.0,
            "spans": spans,
        }
        if ctx is not None and stages:
            trace["t0_wall"] = ctx.wall(stages[0][1])
            if ctx.remote_spans:
                trace["remote"] = list(ctx.remote_spans)
        with self._store_lock:
            self._traces[request_id] = trace  # a reused id replaces its trace
            self._traces.move_to_end(request_id)
            self._ingest_t[request_id] = self.clock()
            self._prune()
        if self.jsonl_path and not self._stop.is_set():  # no sink after close()
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._drain, name="trace-jsonl", daemon=True)
                self._writer.start()
            try:
                self._queue.put_nowait(
                    json.dumps(trace, ensure_ascii=False) + "\n")
            except queue.Full:
                self.dropped += 1
                if self.dropped == 1 or self.dropped % 1000 == 0:
                    logger.warning(
                        "trace JSONL sink backed up (%d dropped so far) — "
                        "is %s hung?", self.dropped, self.jsonl_path)
        return trace

    def close(self, timeout: float = 5.0) -> None:
        """Drain queued writes (bounded by ``timeout``) and close the sink.
        A writer wedged on a hung filesystem is abandoned — it's a daemon
        thread — rather than hanging shutdown forever."""
        writer, self._writer = self._writer, None
        if writer is not None:
            deadline = time.monotonic() + timeout
            self._stop.set()
            try:
                # bounded put sharing the overall budget: a backlogged-but-
                # healthy writer frees a slot for the sentinel; a wedged
                # one exhausts the deadline and is abandoned below
                self._queue.put(None, timeout=timeout)
            except queue.Full:
                pass
            writer.join(max(0.0, deadline - time.monotonic()))
            if writer.is_alive():
                # the stop flag guarantees the writer terminates (and
                # closes the sink itself) if the filesystem ever recovers
                self._abandoned = True
                if writer.is_alive():
                    logger.warning(
                        "trace JSONL writer did not drain within %.1fs "
                        "(%d queued, %d dropped); abandoning it — the "
                        "daemon thread finishes the backlog and exits if "
                        "the sink recovers",
                        timeout, self._queue.qsize(), self.dropped)
                    return  # the abandoned writer owns the sink now
                # it exited in the race window after join() — reclaim
                self._abandoned = False
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    def get(self, request_id: str) -> Optional[dict]:
        with self._store_lock:
            self._prune()
            return self._traces.get(request_id)

    def recent(self, n: int = 50) -> List[dict]:
        with self._store_lock:
            self._prune()
            return list(self._traces.values())[-n:]

    def __len__(self) -> int:
        return len(self._traces)
