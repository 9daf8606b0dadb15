"""HTTP-edge admission control: priority classes, bounded queues, shedding.

The actuated end of the planner's saturation decisions. Requests carry a
priority class in the ``X-Priority`` header (``high`` / ``normal`` /
``low``, or the numeric level); the controller admits up to ``limit``
concurrently, queues the overflow per priority class (bounded depth,
queue-wait deadline), and grants freed slots highest-priority-first.
When the planner signals saturation (``set_shed_level``), the lowest
classes are rejected at the door with 429 + ``Retry-After`` — and any of
their requests already queued are flushed with the same rejection, so a
spike degrades queued TTFT for the best traffic instead of toppling the
engines for all of it.

Every decision is observable: ``dynamo_planner_*`` instruments on the
controller's registry (attached into the HTTP service's scrape) and
flight-recorder events (``planner.shed`` / ``planner.admit_timeout``)
so `/debug/flight` can reconstruct exactly which requests were turned
away and why.

The port's copy of ``dynamo_tpu/planner/admission.py``: the same classes,
decisions, instrument names and flight events, over the port's
``telemetry`` registry and flight ring. The HTTP edge
(``http/service.py``) cancels a queued ``acquire`` whose client went away,
which gives its place back.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import math
import time
from typing import Callable, Deque, Dict, Optional

from ..telemetry.flight import FlightRecorder, flight_recorder
from ..telemetry.registry import MetricsRegistry

# index IS the priority level: 0 sheds first, the last class never sheds
PRIORITY_CLASSES = ("low", "normal", "high")
DEFAULT_PRIORITY = PRIORITY_CLASSES.index("normal")
PRIORITY_HEADER = "X-Priority"


def parse_priority(value: Optional[str]) -> int:
    """Header value → priority level. Unknown/absent values map to
    ``normal`` — a malformed header must degrade to default service,
    not to an error or (worse) to highest priority."""
    if not value:
        return DEFAULT_PRIORITY
    v = value.strip().lower()
    if v in PRIORITY_CLASSES:
        return PRIORITY_CLASSES.index(v)
    try:
        level = int(v)
    except ValueError:
        return DEFAULT_PRIORITY
    if 0 <= level < len(PRIORITY_CLASSES):
        return level
    return DEFAULT_PRIORITY


class AdmissionRejected(Exception):
    """Request turned away at the edge; carries the Retry-After hint."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 outcome: str = "shed"):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.outcome = outcome  # "shed" | "queue_full" | "timeout" | "draining"

    @property
    def retry_after_header(self) -> str:
        return str(max(1, math.ceil(self.retry_after_s)))


@dataclasses.dataclass
class AdmissionConfig:
    limit: int = 0               # concurrently admitted requests; 0 = unbounded
    queue_depth: int = 64        # per-priority-class queue bound
    queue_timeout_s: float = 10.0  # queue-wait deadline
    retry_after_s: float = 1.0   # hint on shed/queue-full rejections


class _Waiter:
    __slots__ = ("fut", "priority", "enqueued_t", "granted", "abandoned")

    def __init__(self, fut: asyncio.Future, priority: int, enqueued_t: float):
        self.fut = fut
        self.priority = priority
        self.enqueued_t = enqueued_t
        self.granted = False
        self.abandoned = False


class AdmissionController:
    """Priority-aware concurrency gate for the HTTP edge.

    Single-loop discipline: all state mutation happens on the event loop
    (no locks); the grant path runs synchronously inside ``release`` /
    ``set_limit`` / ``set_shed_level`` so admitted-vs-abandoned races
    reduce to flag checks within one loop iteration.
    """

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        registry: Optional[MetricsRegistry] = None,
        flight: Optional[FlightRecorder] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or AdmissionConfig()
        self.limit = self.config.limit
        self.shed_level = 0
        self.clock = clock
        self.flight = flight if flight is not None else flight_recorder()
        self._inflight = 0
        self._queues: Dict[int, Deque[_Waiter]] = {
            level: collections.deque()
            for level in range(len(PRIORITY_CLASSES))
        }
        self.shed_total = 0  # lifetime rejections, planner signal
        # recovery drain (recovery/controller.py): while True EVERY class
        # is rejected at the door — a draining worker takes nothing new,
        # regardless of shed level or free slots
        self.draining = False

        self.registry = registry or MetricsRegistry()
        self._admissions = self.registry.counter(
            "dynamo_planner_admissions_total",
            "Admission decisions by priority= class and outcome="
            "admitted|shed|queue_full|timeout|draining",
        )
        self._queue_wait = self.registry.histogram(
            "dynamo_planner_queue_wait_seconds",
            "Admission-queue wait of ADMITTED requests, by priority=",
        )
        self.registry.callback_gauge(
            "dynamo_planner_admission_queue_depth_requests",
            "Requests waiting in the admission queue, by priority=",
            lambda: [
                ({"priority": PRIORITY_CLASSES[level]}, self.queue_depth(level))
                for level in self._queues
            ],
        )
        self.registry.callback_gauge(
            "dynamo_planner_inflight_requests",
            "Requests admitted and not yet released",
            lambda: self._inflight,
        )
        self.registry.callback_gauge(
            "dynamo_planner_admission_limit_requests",
            "Current admission concurrency limit (0 = unbounded)",
            lambda: self.limit,
        )
        self.registry.callback_gauge(
            "dynamo_planner_shedding_info",
            "1 when the priority= class is currently being shed",
            lambda: [
                ({"priority": PRIORITY_CLASSES[level]},
                 1 if level < self.shed_level else 0)
                for level in range(len(PRIORITY_CLASSES))
            ],
        )

    # ---------- introspection ----------

    def queue_depth(self, level: Optional[int] = None) -> int:
        if level is not None:
            return sum(1 for w in self._queues[level] if not w.abandoned)
        return sum(self.queue_depth(lv) for lv in self._queues)

    @property
    def inflight(self) -> int:
        return self._inflight

    def snapshot(self) -> Dict[str, float]:
        """Planner signal source (names from planner/policy.py)."""
        limit = self.limit
        return {
            "admission.queue_depth": float(self.queue_depth()),
            "admission.inflight_ratio": (
                self._inflight / limit if limit > 0 else 0.0
            ),
            "admission.shed_total": float(self.shed_total),
        }

    # ---------- planner-facing knobs ----------

    def set_limit(self, limit: int) -> None:
        self.limit = max(0, int(limit))
        self._grant_free_slots()

    def set_shed_level(self, level: int) -> None:
        """Shed classes below ``level``; flush their queued waiters so a
        request already waiting doesn't burn its deadline just to be
        turned away anyway."""
        level = max(0, min(int(level), len(PRIORITY_CLASSES) - 1))
        self.shed_level = level
        for class_level in range(level):
            queue = self._queues[class_level]
            while queue:
                w = queue.popleft()
                if w.abandoned or w.fut.done():
                    continue
                w.fut.set_exception(self._rejection(class_level, "shed"))
        self._grant_free_slots()

    def set_draining(self, draining: bool = True) -> None:
        """Drain-aware admission: reject every class while the engine
        behind this edge drains (recovery ladder / rolling update), and
        flush already-queued waiters — their wait can only end in a
        migration or a restart, never an admission."""
        self.draining = draining
        if not draining:
            self._grant_free_slots()
            return
        for queue in self._queues.values():
            while queue:
                w = queue.popleft()
                if w.abandoned or w.fut.done():
                    continue
                w.fut.set_exception(self._rejection(w.priority, "draining"))

    # ---------- request path ----------

    async def acquire(self, priority: int, request_id: str = "") -> None:
        """Admit, queue, or reject one request. Raises
        :class:`AdmissionRejected` on shed / queue-full / deadline."""
        priority = max(0, min(int(priority), len(PRIORITY_CLASSES) - 1))
        cls = PRIORITY_CLASSES[priority]
        if self.draining:
            self._count_rejection(priority, "draining", request_id)
            raise self._rejection(priority, "draining")
        if priority < self.shed_level:
            self._count_rejection(priority, "shed", request_id)
            raise self._rejection(priority, "shed")
        if self.limit <= 0 or self._inflight < self.limit:
            self._inflight += 1
            self._admissions.inc(priority=cls, outcome="admitted")
            self._queue_wait.observe(0.0, priority=cls)
            return
        queue = self._queues[priority]
        if self.queue_depth(priority) >= self.config.queue_depth:
            self._count_rejection(priority, "queue_full", request_id)
            raise self._rejection(priority, "queue_full")
        loop = asyncio.get_running_loop()
        w = _Waiter(loop.create_future(), priority, self.clock())
        queue.append(w)
        try:
            # shield: a deadline must not cancel a grant that landed in
            # the same loop iteration — the granted flag disambiguates
            await asyncio.wait_for(
                asyncio.shield(w.fut), self.config.queue_timeout_s)
        except asyncio.TimeoutError:
            if w.granted:
                pass  # slot granted as the deadline fired: admitted
            else:
                self._discard(w)
                self._count_rejection(priority, "timeout", request_id)
                self.flight.record(
                    "planner.admit_timeout", request_id=request_id or None,
                    priority=cls,
                    waited_s=round(self.clock() - w.enqueued_t, 4),
                )
                raise self._rejection(priority, "timeout")
        except asyncio.CancelledError:
            # client went away while queued
            if not w.granted:
                self._discard(w)
                raise
            # granted and cancelled in the same iteration: give the slot
            # back before propagating
            self._inflight -= 1
            self._grant_free_slots()
            raise
        except AdmissionRejected as e:
            # set_shed_level / set_draining flushed this waiter mid-queue
            self._count_rejection(
                priority, getattr(e, "outcome", None) or "shed", request_id
            )
            raise
        self._admissions.inc(priority=cls, outcome="admitted")
        self._queue_wait.observe(
            self.clock() - w.enqueued_t, priority=cls)

    def release(self) -> None:
        """One admitted request finished; hand its slot to the best
        queued waiter."""
        self._inflight = max(0, self._inflight - 1)
        self._grant_free_slots()

    # ---------- internals ----------

    def _rejection(self, priority: int, outcome: str) -> AdmissionRejected:
        cls = PRIORITY_CLASSES[priority]
        if outcome == "shed":
            msg = (f"service saturated; priority class {cls!r} is being "
                   f"shed — retry later")
        elif outcome == "draining":
            msg = ("worker is draining (recovery or rolling update) — "
                   "retry against the pool")
        elif outcome == "queue_full":
            msg = f"admission queue full for priority class {cls!r}"
        else:
            msg = (f"request exceeded the admission queue-wait deadline "
                   f"({self.config.queue_timeout_s:.0f}s)")
        return AdmissionRejected(
            msg, retry_after_s=self.config.retry_after_s, outcome=outcome)

    def _count_rejection(self, priority: int, outcome: str,
                         request_id: str) -> None:
        cls = PRIORITY_CLASSES[priority]
        self.shed_total += 1
        self._admissions.inc(priority=cls, outcome=outcome)
        if outcome != "timeout":  # timeout records its own richer event
            self.flight.record(
                "planner.shed", request_id=request_id or None,
                priority=cls, outcome=outcome, shed_level=self.shed_level,
            )

    def _discard(self, w: _Waiter) -> None:
        """Remove a timed-out/cancelled waiter from its queue NOW — the
        abandoned flag alone would leave the object in the deque until a
        grant walks past it, which under a sustained retry storm (every
        client re-queueing each deadline) grows the deque without bound."""
        w.abandoned = True
        try:
            self._queues[w.priority].remove(w)
        except ValueError:
            pass  # already popped by a racing grant/flush

    def _pop_highest(self) -> Optional[_Waiter]:
        for level in range(len(PRIORITY_CLASSES) - 1, -1, -1):
            queue = self._queues[level]
            while queue:
                w = queue.popleft()
                if w.abandoned or w.fut.done():
                    continue
                return w
        return None

    def _grant_free_slots(self) -> None:
        while self.limit <= 0 or self._inflight < self.limit:
            w = self._pop_highest()
            if w is None:
                return
            self._inflight += 1
            w.granted = True
            w.fut.set_result(None)
