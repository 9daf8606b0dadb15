"""The planner loop: observe → decide → actuate, on a fixed cadence.

The port's copy of ``dynamo_tpu/planner/planner.py``; its sources read the
port's ``KvMetricsAggregator``, ``SloTracker`` and engine ``metrics()``.

The control plane between the telemetry the repo already gathers and
the knobs it already has (ROADMAP item 1; reference deployment plane,
PAPER.md §1 layer 9). Each cycle:

1. **observe** — poll every registered signal source (plain callables
   returning ``{signal_name: value}``; the KvMetricsAggregator snapshot,
   an AdmissionController, an engine's ForwardPassMetrics dict, a
   scripted test feed) into the rolling :class:`SignalStore`.
2. **decide** — run :class:`~dynamo_tpu_torch.planner.policy.SlaPolicy`
   against the store plus the current role→replica map.
3. **actuate** — offer each emitted action down the actuator list
   (planner/actuation.py); the first actuator that claims it wins.

Every decision is recorded: ``dynamo_planner_actions_total`` /
``dynamo_planner_replica_target_replicas`` on the planner's registry
and a ``planner.action`` flight-recorder event, so `/debug/flight`
shows the scaling/shedding timeline interleaved with the engine events
that caused it.

Discipline: the loop task is held
and cancelled on ``stop()``, sources/actuators that block ride an
executor inside their own implementations, and a failing source or
actuator is logged and skipped — the loop itself never dies to one bad
cycle.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import logging
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from ..telemetry.flight import FlightRecorder, flight_recorder
from ..telemetry.registry import MetricsRegistry
from .policy import Action, AdmissionAction, RebalanceAction, ScaleAction, SlaPolicy
from .signals import SignalStore

logger = logging.getLogger(__name__)

SignalSource = Callable[[], Mapping[str, float]]


@dataclasses.dataclass
class PlannerConfig:
    interval_s: float = 2.0


class Planner:
    """Drives one policy against pluggable sources and actuators."""

    def __init__(
        self,
        policy: Optional[SlaPolicy] = None,
        sources: Optional[Sequence[SignalSource]] = None,
        actuators: Optional[Sequence] = None,
        config: Optional[PlannerConfig] = None,
        signals: Optional[SignalStore] = None,
        replicas: Optional[Callable[[], Mapping[str, int]]] = None,
        registry: Optional[MetricsRegistry] = None,
        flight: Optional[FlightRecorder] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy or SlaPolicy(clock=clock)
        self.sources: List[SignalSource] = list(sources or [])
        self.actuators: List = list(actuators or [])
        self.config = config or PlannerConfig()
        self.signals = signals or SignalStore(clock=clock)
        self._replicas_fn = replicas
        self.flight = flight if flight is not None else flight_recorder()
        self.clock = clock
        self._task: Optional[asyncio.Task] = None
        self.actions_applied: List[Action] = []  # audit trail for tests

        self.registry = registry or MetricsRegistry()
        self._actions_c = self.registry.counter(
            "dynamo_planner_actions_total",
            "Planner actions by kind=scale_up|scale_down|rebalance|"
            "admission and applied=true|false",
        )
        self._cycles_c = self.registry.counter(
            "dynamo_planner_cycles_total",
            "Planner observe→decide→actuate cycles",
        )
        self._replica_target = self.registry.gauge(
            "dynamo_planner_replica_target_replicas",
            "Planner's current replica target, by role=",
        )
        self.registry.callback_gauge(
            "dynamo_planner_shed_level_depth",
            "Priority classes currently shed from the bottom (policy)",
            lambda: self.policy.shed_level,
        )
        self.registry.callback_gauge(
            "dynamo_planner_local_prefill_threshold_tokens",
            "Policy's current disagg local/remote prefill threshold",
            lambda: self.policy.local_prefill_length,
        )

    # ---------- wiring ----------

    def add_source(self, source: SignalSource) -> None:
        self.sources.append(source)

    def add_actuator(self, actuator) -> None:
        self.actuators.append(actuator)

    # ---------- lifecycle ----------

    def start(self, spawn=asyncio.create_task) -> "Planner":
        self._task = spawn(self._loop())
        return self

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        while True:
            try:
                await self.step()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("planner cycle failed")
            await asyncio.sleep(self.config.interval_s)

    # ---------- one cycle ----------

    async def _current_replicas(self) -> Mapping[str, int]:
        """role → replica count, from the configured provider or the
        first actuator that can report. Providers may be sync (pure CR
        reads) or async (REST lookups riding an executor)."""
        if self._replicas_fn is not None:
            r = self._replicas_fn()
            return (await r) if inspect.isawaitable(r) else r
        for actuator in self.actuators:
            fn = getattr(actuator, "replicas", None)
            if fn is not None:
                try:
                    r = fn()
                    return (await r) if inspect.isawaitable(r) else r
                except Exception:
                    logger.debug("replica lookup failed", exc_info=True)
        return {}

    async def step(self) -> List[Action]:
        """One observe→decide→actuate pass; returns the emitted actions
        (applied or not) so callers/tests can drive the loop manually."""
        self._cycles_c.inc()
        t = self.clock()
        for source in self.sources:
            try:
                self.signals.observe_many(source() or {}, t=t)
            except Exception:
                logger.exception("planner signal source failed")
        actions = self.policy.decide(
            self.signals, await self._current_replicas())
        for action in actions:
            applied = await self._dispatch(action)
            self._record(action, applied)
            if applied:
                self.actions_applied.append(action)
            else:
                # no actuator claimed it (or the actuator failed): undo
                # the pacing state the decision committed so the policy
                # retries instead of believing a change that never landed
                self.policy.rollback(action)
        return actions

    async def _dispatch(self, action: Action) -> bool:
        for actuator in self.actuators:
            try:
                if await actuator.apply(action):
                    return True
            except Exception:
                logger.exception("actuator %s failed on %s",
                                 type(actuator).__name__, action)
        return False

    def _record(self, action: Action, applied: bool) -> None:
        applied_s = "true" if applied else "false"
        if isinstance(action, ScaleAction):
            self._actions_c.inc(kind=f"scale_{action.direction}",
                                applied=applied_s)
            if applied:
                self._replica_target.set(
                    action.target_replicas, role=action.role)
            self.flight.record(
                "planner.action", action="scale", role=action.role,
                from_replicas=action.current_replicas,
                to_replicas=action.target_replicas,
                applied=applied, reason=action.reason,
            )
        elif isinstance(action, RebalanceAction):
            self._actions_c.inc(kind="rebalance", applied=applied_s)
            self.flight.record(
                "planner.action", action="rebalance",
                max_local_prefill_length=action.max_local_prefill_length,
                max_prefill_queue_size=action.max_prefill_queue_size,
                applied=applied, reason=action.reason,
            )
        elif isinstance(action, AdmissionAction):
            self._actions_c.inc(kind="admission", applied=applied_s)
            self.flight.record(
                "planner.action", action="admission",
                shed_level=action.shed_level, limit=action.limit,
                applied=applied, reason=action.reason,
            )
        if not applied:
            logger.warning("planner action had no actuator: %s", action)
        else:
            logger.info("planner action applied: %s", action)


def aggregator_source(aggregator) -> SignalSource:
    """KvMetricsAggregator → planner signals: pool-level decode slot
    occupancy, waiting depth, and KV usage across scraped workers."""

    def snapshot() -> Dict[str, float]:
        endpoints = getattr(aggregator, "endpoints", {})
        if not endpoints:
            return {}
        active = sum(m.request_active_slots for m in endpoints.values())
        total = sum(m.request_total_slots for m in endpoints.values())
        kv_active = sum(m.kv_active_blocks for m in endpoints.values())
        kv_total = sum(m.kv_total_blocks for m in endpoints.values())
        return {
            "decode.slot_busy_ratio": active / total if total else 0.0,
            "decode.waiting": float(sum(
                m.num_requests_waiting for m in endpoints.values())),
            "kv.usage_ratio": kv_active / kv_total if kv_total else 0.0,
        }

    return snapshot


def slo_source(tracker) -> SignalSource:
    """A telemetry.slo.SloTracker → planner signals: rolling-window
    attainment fractions + goodput rate under the ``slo.*`` names
    policy.py consults (SIG_SLO_*). The edge's user-visible-latency
    view of saturation."""
    return tracker.snapshot


def engine_metrics_source(metrics_fn) -> SignalSource:
    """A single engine's ``metrics()`` dict (scheduler ForwardPassMetrics
    shape + coordinator extras) → planner signals. The in-process path
    for an ``in=http out=torch`` frontend running its own planner."""

    def snapshot() -> Dict[str, float]:
        m = metrics_fn() or {}
        total = m.get("request_total_slots") or 0
        active = m.get("request_active_slots") or 0
        kv_total = m.get("kv_total_blocks") or 0
        kv_active = m.get("kv_active_blocks") or 0
        out = {
            "decode.slot_busy_ratio": active / total if total else 0.0,
            "decode.waiting": float(m.get("num_requests_waiting") or 0),
            "kv.usage_ratio": kv_active / kv_total if kv_total else 0.0,
        }
        if "prefill_queue_depth" in m:
            out["prefill.queue_depth"] = float(m["prefill_queue_depth"])
        return out

    return snapshot
