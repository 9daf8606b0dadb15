"""The simulated fleet: real control plane, virtual time, byte-model
workers (the port's copy of ``dynamo_tpu/sim/fleet.py``).

``SimFleet`` wires the REAL classes together exactly as the serving
edge does — ``AdmissionController`` gates concurrency, ``TenantQuotas``
meter tenants, ``PoolManager``/``PoolPolicy`` run cold start and
scale-to-zero, ``KvScheduler`` routes on prefix overlap, ``SlaPolicy``
inside a real ``Planner`` scales/sheds, and one real
``RecoveryController`` per worker runs the drain→respawn ladder when
the sim watchdog trips a wedge. The only simulated parts are the
workers (sim/worker.py) and the actuator that turns ScaleActions into
spawned/retired sim workers.

The KV scheduler breaks its ties with the module-global ``random``
generator, the one ``run_scenario`` seeds and ``faults.fire`` draws from
at a probabilistic spec: under the same seed the port's fleet makes the
reference's choices in the reference's order.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import logging
import random
from typing import Dict, List, Optional, Tuple

from ..kv_router.indexer import OverlapScores
from ..kv_router.scheduler import AllWorkersBusy, KvScheduler
from ..planner.admission import (
    AdmissionConfig, AdmissionController, AdmissionRejected,
)
from ..planner.actuation import LocalActuator
from ..planner.planner import Planner, PlannerConfig
from ..planner.policy import (
    PolicyConfig, RebalanceAction, ScaleAction, SlaPolicy,
)
from ..recovery.controller import RecoveryConfig, RecoveryController
from ..registry.cards import ModelCard
from ..registry.policy import PoolPolicy, PoolPolicyConfig
from ..registry.pools import ColdStartTimeout, PoolConfig, PoolManager
from ..registry.registry import ModelRegistry
from ..registry.tenants import TenantQuota, TenantQuotas
from ..telemetry.flight import FlightRecorder
from ..telemetry.registry import MetricsRegistry
from ..telemetry.slo import SloTracker
from ..utils import faults
from .metrics import SimMetrics
from .worker import SimRequest, SimWorker, WorkerSchedAdapter, WorkerSpec
from .workload import Request

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ChaosEvent:
    """Wedge one worker at a virtual time via the DYN_FAULT vocabulary."""

    at_s: float
    site: str = "decode_burst_hang"
    worker_index: int = 0


@dataclasses.dataclass
class FleetConfig:
    """One scenario's fleet shape + control-plane tuning."""

    primary_model: str = "sim-model"
    spec: WorkerSpec = dataclasses.field(default_factory=WorkerSpec)
    # model → initial worker count (primary included); every model gets
    # a registry card so PoolManager treats it as a pool citizen
    pools: Dict[str, int] = dataclasses.field(default_factory=dict)
    admission: AdmissionConfig = dataclasses.field(
        default_factory=lambda: AdmissionConfig(
            limit=48, queue_depth=64, queue_timeout_s=15.0))
    policy: PolicyConfig = dataclasses.field(
        default_factory=lambda: PolicyConfig(
            min_replicas=1, max_replicas=6,
            scale_up_cooldown_s=30.0, scale_down_cooldown_s=240.0))
    pool_policy: PoolPolicyConfig = dataclasses.field(
        default_factory=lambda: PoolPolicyConfig(
            idle_to_zero_s=300.0, cooldown_s=60.0))
    recovery: RecoveryConfig = dataclasses.field(
        default_factory=lambda: RecoveryConfig(
            migrate=False, respawn_backoff_s=1.0, seize_timeout_s=2.0))
    quota_default: TenantQuota = dataclasses.field(
        default_factory=lambda: TenantQuota())
    quota_overrides: Dict[str, TenantQuota] = dataclasses.field(
        default_factory=dict)
    slo_ttft_s: float = 4.0
    slo_itl_s: float = 0.25
    slo_window_s: float = 60.0
    planner_interval_s: float = 5.0
    scrape_interval_s: float = 2.0
    pool_step_every: int = 5              # scrape cycles per pools.step()
    watchdog_stall_s: float = 15.0
    max_attempts: int = 8
    chaos: List[ChaosEvent] = dataclasses.field(default_factory=list)


class SimScaleActuator:
    """Applies the planner's ScaleActions to the simulated fleet —
    the in-sim stand-in for KubeActuator, with the same ``apply`` /
    ``replicas`` protocol."""

    def __init__(self, fleet: "SimFleet") -> None:
        self.fleet = fleet

    def replicas(self) -> Dict[str, int]:
        return self.fleet.planner_replicas()

    async def apply(self, action) -> bool:
        if isinstance(action, RebalanceAction):
            # the sim has no disagg router; acknowledge the rebalance so
            # the policy's pacing state stays truthful, and keep it on
            # the timeline for the report
            self.fleet.record_event(
                "rebalance",
                max_local_prefill_length=action.max_local_prefill_length,
                max_prefill_queue_size=action.max_prefill_queue_size,
                reason=action.reason)
            return True
        if not isinstance(action, ScaleAction) or action.role != "decode":
            return False
        fleet = self.fleet
        fleet.metrics.scale_actions.inc(
            role=action.role, direction=action.direction)
        fleet.record_event(
            "scale", role=action.role, direction=action.direction,
            from_replicas=action.current_replicas,
            to_replicas=action.target_replicas, reason=action.reason)
        delta = action.target_replicas - action.current_replicas
        if delta > 0:
            for _ in range(delta):
                fleet.provision(fleet.cfg.primary_model)
        else:
            fleet.retire(fleet.cfg.primary_model, -delta)
        return True


class SimFleet:
    def __init__(self, cfg: FleetConfig, clock) -> None:
        self.cfg = cfg
        self.clock = clock
        self.registry = MetricsRegistry()
        self.flight = FlightRecorder(capacity=8192)
        self.cold_store: set = set()
        self.workers: Dict[str, SimWorker] = {}
        self._by_id: Optional[List[SimWorker]] = None  # workers in id order
        self.controllers: Dict[str, RecoveryController] = {}
        self.events: List[dict] = []
        self.records: List[dict] = []
        self.kv_series: List[Tuple[float, float]] = []
        self.replica_series: List[Tuple[float, int]] = []
        self.resubmits = 0
        self._worker_seq = itertools.count()
        self._provisioning: Dict[str, int] = {}
        self._tasks: set = set()
        self._serve_tasks: List[asyncio.Task] = []
        self._respawned: Dict[str, str] = {}
        self.running = False

        self.metrics = SimMetrics(
            self.registry, clock, self.replica_map)
        self.models = ModelRegistry(registry=self._child())
        self.admission = AdmissionController(
            config=cfg.admission, registry=self._child(),
            flight=self.flight, clock=clock)
        self.slo = SloTracker(
            ttft_s=cfg.slo_ttft_s, itl_s=cfg.slo_itl_s,
            window_s=cfg.slo_window_s, registry=self._child(),
            clock=clock)
        self.quotas = TenantQuotas(
            default=cfg.quota_default, overrides=cfg.quota_overrides,
            clock=clock, registry=self._child())
        self.quotas.bind_admissions(self.admission.registry)
        self.ks = KvScheduler(
            block_size=cfg.spec.block_size,
            staleness_bound_s=10.0 * cfg.scrape_interval_s, clock=clock,
            rng=random)
        self.policy = SlaPolicy(config=cfg.policy, clock=clock)
        self.planner = Planner(
            policy=self.policy,
            sources=[self.admission.snapshot, self.slo.snapshot,
                     self._fleet_signals],
            actuators=[SimScaleActuator(self),
                       LocalActuator(admission=self.admission)],
            config=PlannerConfig(interval_s=cfg.planner_interval_s),
            registry=self._child(), flight=self.flight, clock=clock)
        self.recovery_registry = self._child()
        self.pools = PoolManager(
            self.models, pool_size=self.pool_size,
            spawner=self._pool_spawner, drainer=self._pool_drainer,
            config=PoolConfig(cold_start_deadline_s=90.0, poll_s=0.5,
                              retry_kick_s=2.0),
            policy=PoolPolicy(cfg.pool_policy, clock=clock),
            clock=clock, registry=self._child())
        if not cfg.pools:
            cfg.pools = {cfg.primary_model: 2}
        for model in sorted(cfg.pools):
            self.models.put(ModelCard(name=model, endpoint=f"dyn://sim.{model}"))

    def _child(self) -> MetricsRegistry:
        child = MetricsRegistry()
        self.registry.attach(child)
        return child

    # ------------------------------------------------------------------
    # fleet state views
    # ------------------------------------------------------------------

    def workers_by_id(self) -> List[SimWorker]:
        """Every worker in id order (kept until the fleet changes)."""
        if self._by_id is None:
            self._by_id = [w for _, w in sorted(self.workers.items())]
        return self._by_id

    def _drop_worker(self, wid: str) -> None:
        self.workers.pop(wid, None)
        self._by_id = None

    def live_workers(self, model: Optional[str] = None) -> List[SimWorker]:
        return [
            w for w in self.workers_by_id()
            if not w.halted and (model is None or w.model == model)
        ]

    def replica_map(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for w in self.live_workers():
            out[w.model] = out.get(w.model, 0) + 1
        return out

    def planner_replicas(self) -> Dict[str, int]:
        n = len(self.live_workers(self.cfg.primary_model))
        return {"decode": n + self._provisioning.get(
            self.cfg.primary_model, 0)}

    def pool_size(self, model: str) -> int:
        return len(self.live_workers(model))

    def record_event(self, kind: str, **data) -> None:
        self.events.append({"t": self.clock(), "kind": kind, **data})

    def _fleet_signals(self) -> Dict[str, float]:
        live = [w for w in self.live_workers() if not w.wedged]
        total = sum(w.spec.slots for w in live)
        active = sum(len(w.active) + len(w.prefilling) for w in live)
        waiting = sum(len(w.pending) for w in live)
        kv_total = sum(w.spec.kv_blocks for w in live)
        kv_active = sum(w.used_blocks for w in live)
        waits = [w.mean_queue_wait_s() for w in live]
        trips = sum(1 for w in self.workers.values() if w.tripped)
        return {
            "decode.slot_busy_ratio": active / total if total else 0.0,
            "decode.waiting": float(waiting),
            "kv.usage_ratio": kv_active / kv_total if kv_total else 0.0,
            "prefill.queue_depth": float(waiting),
            "prefill.queue_wait_s": (sum(waits) / len(waits)
                                     if waits else 0.0),
            "watchdog.trips": float(trips),
        }

    # ------------------------------------------------------------------
    # worker lifecycle
    # ------------------------------------------------------------------

    def _spawn_worker(self, model: str,
                      with_recovery: bool = True) -> SimWorker:
        wid = f"{model}-w{next(self._worker_seq)}"
        w = SimWorker(wid, model, self.cfg.spec, self.clock,
                      self.cold_store)
        self.workers[wid] = w
        self._by_id = None
        w.start()
        self.ks.update_metrics(wid, w.metrics())
        if with_recovery:
            self.controllers[wid] = self._make_controller(w)
        return w

    def _make_controller(self, w: SimWorker) -> RecoveryController:
        wid = w.worker_id

        async def deregister() -> None:
            self.ks.remove_worker(wid)
            self._drop_worker(wid)

        async def respawner():
            await asyncio.sleep(self.cfg.spec.provision_delay_s)
            fresh = self._spawn_worker(w.model)
            self._respawned[wid] = fresh.worker_id
            return WorkerSchedAdapter(fresh)

        async def register() -> None:
            self.record_event(
                "respawn", worker=wid,
                replacement=self._respawned.get(wid, ""))

        return RecoveryController(
            engine_id=wid,
            scheduler=WorkerSchedAdapter(w),
            respawner=respawner,
            deregister=deregister,
            register=register,
            config=self.cfg.recovery,
            registry=self.recovery_registry,
            flight=self.flight,
        )

    def provision(self, model: str) -> None:
        self._provisioning[model] = self._provisioning.get(model, 0) + 1

        async def _provision() -> None:
            try:
                await asyncio.sleep(self.cfg.spec.provision_delay_s)
                self._spawn_worker(model)
            finally:
                self._provisioning[model] -= 1

        self._hold(asyncio.get_running_loop().create_task(
            _provision(), name=f"sim-provision-{model}"))

    def retire(self, model: str, count: int = 1) -> None:
        victims = [w for w in reversed(self.live_workers(model))
                   if not w.draining][:count]
        for w in victims:
            w.draining = True

            async def _retire(worker: SimWorker = w) -> None:
                while True:
                    # a draining worker never admits its queue; bounce
                    # queued requests back to the client for resubmit
                    while worker.pending:
                        worker.pending.popleft().fail("drained")
                    if not (worker.active or worker.prefilling):
                        break
                    await asyncio.sleep(0.5)
                self.ks.remove_worker(worker.worker_id)
                self._drop_worker(worker.worker_id)
                await worker.halt()

            self._hold(asyncio.get_running_loop().create_task(
                _retire(), name=f"sim-retire-{w.worker_id}"))

    def _hold(self, task: asyncio.Task) -> None:
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _pool_spawner(self, card: ModelCard) -> None:
        self.record_event("cold_start", model=card.name)
        await asyncio.sleep(self.cfg.spec.provision_delay_s)
        self._spawn_worker(card.name)

    async def _pool_drainer(self, model: str) -> None:
        self.record_event("scale_to_zero", model=model)
        self.retire(model, count=len(self.live_workers(model)))

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def _overlap(self, req: Request) -> OverlapScores:
        scores: Dict[str, int] = {}
        cold: Dict[str, int] = {}
        live = self.live_workers(req.model)
        hashes = (live[0].prefix_hashes(req) if live else [])
        if not hashes:
            return OverlapScores()
        n = len(hashes)
        cold_run_at: Dict[int, int] = {}
        for w in live:
            run = w.cached_run(hashes)
            if run:
                scores[w.worker_id] = run
            # the cold-tier run past a given hot-run length is the same
            # for every worker; scan each start index once
            extra = cold_run_at.get(run)
            if extra is None:
                extra = 0
                i = run
                while i < n and hashes[i] in self.cold_store:
                    extra += 1
                    i += 1
                cold_run_at[run] = extra
            if extra:
                cold[w.worker_id] = extra
        return OverlapScores(scores=scores, cold_scores=cold)

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------

    def _dispatch(self, req: Request) -> None:
        self._serve_tasks.append(asyncio.get_running_loop().create_task(
            self._serve(req), name=f"sim-req-{req.request_id}"))

    async def _serve(self, req: Request) -> None:
        rec = {
            "id": req.request_id, "arrival_s": req.arrival_s,
            "model": req.model, "tenant": req.tenant,
            "priority": req.priority, "isl": req.isl, "osl": req.osl,
            "outcome": "failed", "attempts": 0, "resubmits": 0,
        }
        self.pools.note_request(req.model)
        try:
            self.quotas.admit(req.tenant, req.request_id)
            await self.admission.acquire(req.priority, req.request_id)
        except AdmissionRejected as e:
            rec["outcome"] = e.outcome
            self._finish(rec)
            return
        try:
            if self.pool_size(req.model) <= 0:
                await self.pools.await_capacity(req.model)
            await self._serve_admitted(req, rec)
        except ColdStartTimeout:
            rec["outcome"] = "cold_start_timeout"
        finally:
            self.admission.release()
            self._finish(rec)

    async def _serve_admitted(self, req: Request, rec: dict) -> None:
        for attempt in range(self.cfg.max_attempts):
            rec["attempts"] = attempt + 1
            try:
                decision = self.ks.schedule(
                    req.isl, self._overlap(req),
                    pool={w.worker_id
                          for w in self.live_workers(req.model)})
            except AllWorkersBusy:
                if self.pool_size(req.model) <= 0:
                    # recovery or scale-down emptied the pool; lean on
                    # the pool manager's demand-driven cold start
                    # (ColdStartTimeout propagates to _serve)
                    self.pools.note_request(req.model)
                    await self.pools.await_capacity(req.model)
                else:
                    await asyncio.sleep(0.5 * (attempt + 1))
                continue
            worker = self.workers.get(decision.worker_id)
            if worker is None or worker.halted or worker.draining:
                await asyncio.sleep(0.1)
                continue
            sr = SimRequest(req, arrival_t=self.clock())
            worker.enqueue(sr, decision)
            await sr.finished()
            if sr.outcome == "completed":
                rec.update(
                    outcome="completed",
                    worker=worker.worker_id,
                    end_s=self.clock(),
                    ttft_s=sr.ttft_s,
                    itl_max_s=sr.itl_max_s,
                    tokens=req.osl,
                    prefix_hit_tokens=sr.prefix_hit_tokens,
                    pulled_blocks=sr.pulled_blocks,
                    pull_transfer_s=sr.pull_transfer_s,
                    cold_blocks=sr.cold_blocks,
                    slo_met=self.slo.observe(
                        sr.ttft_s, sr.itl_max_s, req.osl),
                )
                self.quotas.charge_tokens(req.tenant, req.osl)
                self.metrics.tokens.inc(req.osl, phase="decode")
                return
            # drained out from under us (wedge / scale-down): resubmit,
            # the way a client retries a 502
            rec["resubmits"] += 1
            self.resubmits += 1
            self.metrics.retries.inc()
            await asyncio.sleep(0.2)

    def _finish(self, rec: dict) -> None:
        if rec.get("_recorded"):
            return
        rec["_recorded"] = True
        self.metrics.requests.inc(
            outcome=rec["outcome"], priority=str(rec["priority"]))
        self.records.append(rec)

    # ------------------------------------------------------------------
    # background loops
    # ------------------------------------------------------------------

    async def _scrape_loop(self) -> None:
        cycle = 0
        while self.running:
            await asyncio.sleep(self.cfg.scrape_interval_s)
            cycle += 1
            now = self.clock()
            for w in self.workers_by_id():
                if w.halted or w.wedged:
                    continue  # a wedged endpoint stops answering scrapes
                self.ks.update_metrics(w.worker_id, w.metrics())
            # the sim watchdog: heartbeat-staleness trip into the REAL
            # recovery controller
            for w in self.workers_by_id():
                wid = w.worker_id
                if w.halted or w.tripped or w.draining:
                    continue
                busy = bool(w.active or w.prefilling or w.pending)
                if (busy and now - w.last_progress_t
                        > self.cfg.watchdog_stall_s):
                    w.tripped = True
                    self.metrics.trips.inc()
                    self.record_event("watchdog_trip", worker=wid)
                    ctrl = self.controllers.get(wid)
                    if ctrl is not None:
                        ctrl.on_trip({"reason": "decode_stall"})
            live = self.live_workers()
            kv_total = sum(w.spec.kv_blocks for w in live)
            kv_active = sum(w.used_blocks for w in live)
            usage = kv_active / kv_total if kv_total else 0.0
            if cycle % 5 == 0:
                self.kv_series.append((now, usage))
                self.replica_series.append((now, len(live)))
            self.metrics.kv_usage.set(usage)
            if cycle % self.cfg.pool_step_every == 0:
                await self.pools.step()

    async def _chaos_loop(self) -> None:
        for ev in sorted(self.cfg.chaos, key=lambda e: e.at_s):
            delay = ev.at_s - self.clock()
            if delay > 0:
                await asyncio.sleep(delay)
            targets = [w for w in self.live_workers(self.cfg.primary_model)
                       if not w.wedged and not w.draining]
            if not targets:
                continue
            target = targets[ev.worker_index % len(targets)]
            faults.arm(ev.site, "once")
            target.fault_site = ev.site
            target._work.set()
            self.metrics.chaos.inc(site=ev.site)
            self.record_event("chaos", site=ev.site,
                              worker=target.worker_id)

    # ------------------------------------------------------------------
    # run
    # ------------------------------------------------------------------

    async def run(self, requests: List[Request]) -> None:
        self.running = True
        for model in sorted(self.cfg.pools):
            for _ in range(self.cfg.pools[model]):
                self._spawn_worker(model)
        scrape = asyncio.get_running_loop().create_task(
            self._scrape_loop(), name="sim-scrape")
        self._hold(scrape)
        chaos_task = None
        if self.cfg.chaos:
            chaos_task = asyncio.get_running_loop().create_task(
                self._chaos_loop(), name="sim-chaos")
            self._hold(chaos_task)
        self.planner.start()
        try:
            # one call_at timer per arrival (instead of a dispatcher
            # coroutine sleeping per request) — same dispatch instants,
            # a third of the event-loop handles
            loop = asyncio.get_running_loop()
            start_t = self.clock()
            last_at = start_t
            for req in sorted(requests,
                              key=lambda r: (r.arrival_s, r.request_id)):
                at = max(req.arrival_s, start_t)
                last_at = max(last_at, at)
                loop.call_at(at, self._dispatch, req)
            if requests:
                # the epsilon orders this barrier after every dispatch
                # timer at last_at regardless of heap tie-breaks
                await asyncio.sleep(last_at - self.clock() + 1e-6)
            if self._serve_tasks:
                await asyncio.gather(*self._serve_tasks,
                                     return_exceptions=False)
            # let in-flight recoveries finish their respawn ladders
            for ctrl in list(self.controllers.values()):
                t = ctrl._recover_task
                if t is not None and not t.done():
                    await t
        finally:
            self.running = False
            self.planner.stop()
            scrape.cancel()
            if chaos_task is not None:
                chaos_task.cancel()
            for t in list(self._tasks):
                t.cancel()
            await asyncio.gather(*self._tasks, return_exceptions=True)
            for w in list(self.workers.values()):
                await w.halt()
            await self.pools.stop()
            n = len([r for r in self.records
                     if r["outcome"] == "completed" and r.get("slo_met")])
            d = len([r for r in self.records
                     if r["outcome"] == "completed"])
            self.metrics.attainment.set(n / d if d else 0.0)
            for summary in self.recovery_summaries():
                self.metrics.recoveries.inc(reason=summary["reason"])

    def recovery_summaries(self) -> List[dict]:
        """Recovery-ladder outcomes with the wall-clock duration field
        stripped — everything that enters a report must be virtual."""
        out = []
        for wid in sorted(self.controllers):
            for s in self.controllers[wid].recoveries:
                out.append({
                    "worker": wid,
                    "reason": s.get("reason"),
                    "hard": s.get("hard"),
                    "finished": s.get("finished"),
                    "migrated": s.get("migrated"),
                    "failed": s.get("failed"),
                    "respawned": s.get("respawned"),
                })
        return out

    def flight_kinds(self) -> List[str]:
        """Chronological flight-event kind sequence from the private
        ring (timestamps are wall-clock and stay out of reports)."""
        return [e.get("kind", "") for e in self.flight.snapshot()]
