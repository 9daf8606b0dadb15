"""RecoveryController: the trip → drain → migrate → respawn ladder.

The port's copy of ``dynamo_tpu/recovery/controller.py``. The stall
watchdog makes a wedge visible; this controller makes it a non-event. It
subscribes to watchdog trips (and supervised-child deaths) and runs, in
order:

1. **gate**: stop admission (``Scheduler.set_draining``: the engine's
   new requests get ``EngineDrainingError``, the HTTP edge's 503) and
   deregister from discovery, so routers stop picking this worker (the
   ``draining`` flag in the worker's load snapshot excludes it from
   KV-router decisions at once).
2. **soft drain**: committed bursts get a grace window to finish on their
   own (a healthy engine's drain often empties here).
3. **seize**: stop the scheduler loop, gracefully (its exit barriers
   reconcile and stream every dispatched burst) for an admin drain, hard
   (cancel; abandon the un-reconciled device work: a wedged barrier would
   never finish) for a watchdog trip.
4. **migrate**: ship each live request to a healthy peer over the
   migration plane (``recovery/migration.py``): hot (the KV rides along)
   when the device is trusted, cold (the peer re-prefills) when it is not.
   A request no peer accepts fails with a terminal error frame.
5. **respawn**: rebuild the engine through the ``respawner`` with
   exponential backoff and a consecutive-failure budget: a supervised
   child's ``SubprocessEngine.respawn`` (``--isolate-engine``: the CLI
   gives such an engine the respawn-only ladder, run from its
   ``add_down_listener`` on a child's death) or a factory; success
   re-registers in discovery (a factory's new scheduler takes traffic).

The same ladder without the hard seize is ``POST /admin/drain``: the
zero-downtime rolling update (``respawn=1`` restarts a live child).
Migrations ride tcp and record the ``dynamo_transfer_*`` family
(``plane="migration"``) in this controller's registry beside ``shipped``,
the KV bytes and frames a drain shipped; the reference's ici backend is
refused by name. An ``admission`` controller (the HTTP edge's,
``planner/admission.py``) is gated beside the scheduler: closed at a
drain's first step, reopened when a respawn succeeds.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Awaitable, Callable, List, Optional

from ..protocols.common import EngineOutput, FinishReason
from ..telemetry.flight import FlightRecorder, flight_recorder
from ..telemetry.registry import MetricsRegistry
from ..transfer.plane import TransferMetrics, negotiate_backend
from .migration import (
    ICI_REFUSED,
    migrate_request,
    migration_class,
    package_request,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RecoveryConfig:
    # soft-drain grace: how long committed work may finish on its own
    drain_grace_s: float = 5.0
    # graceful-seize deadline before escalating to a hard cancel
    seize_timeout_s: float = 5.0
    # respawn ladder: the base backoff (doubles per consecutive failure) and
    # the consecutive-failure budget before the controller gives up
    respawn_backoff_s: float = 1.0
    max_respawns: int = 3
    # master switch for live migration (False: drains fail requests)
    migrate: bool = True


class RecoveryController:
    """One per engine. Every hook is optional: a controller with only a
    respawner runs just the respawn ladder; one with only a scheduler (an
    in-process engine, no supervision) runs drain + migrate."""

    def __init__(
        self,
        engine_id: str = "engine",
        scheduler=None,
        runner=None,
        watchdog=None,
        peers: Optional[Callable[[], List[dict]]] = None,
        respawner: Optional[Callable[[], Awaitable]] = None,
        deregister: Optional[Callable[[], Awaitable]] = None,
        register: Optional[Callable[[], Awaitable]] = None,
        config: Optional[RecoveryConfig] = None,
        registry: Optional[MetricsRegistry] = None,
        flight: Optional[FlightRecorder] = None,
        # router-quality peer selection: (peers, token_ids) → peers ordered
        # best first. Wired to KvFabric.rank_peers when the worker runs a KV
        # fabric, so the peer that already holds the request's prefix is
        # tried first
        peer_ranker: Optional[Callable[[List[dict], List[int]],
                                       List[dict]]] = None,
        ici=None,
        admission=None,  # planner.admission.AdmissionController
    ):
        if ici is not None:
            raise NotImplementedError(ICI_REFUSED)
        self.engine_id = engine_id
        self.scheduler = scheduler
        self.admission = admission
        self.runner = runner
        self.watchdog = watchdog
        self.peers = peers
        self.respawner = respawner
        self.deregister = deregister
        self.register = register
        self.peer_ranker = peer_ranker
        self.config = config or RecoveryConfig()
        self.flight = flight if flight is not None else flight_recorder()
        self.registry = registry or MetricsRegistry()
        self._actions = self.registry.counter(
            "dynamo_recovery_actions_total",
            "Recovery-ladder steps executed, labelled action="
            "drain|migrate|respawn|deregister|register and outcome")
        self._migrations = self.registry.counter(
            "dynamo_recovery_migrations_total",
            "Live request migrations, labelled mode=hot|cold and "
            "outcome=committed|failed")
        self._drain_hist = self.registry.histogram(
            "dynamo_recovery_drain_duration_seconds",
            "One drain ladder end to end: admission gate through migrations "
            "(respawn excluded: it has its own backoff)")
        # the KV payload the migrations shipped (tcp block frames), on the
        # unified transfer family and as plain counts
        self._xfer = TransferMetrics(self.registry, plane="migration")
        self.shipped = {"bytes": 0, "frames": 0}
        self._recover_task: Optional[asyncio.Task] = None
        self._relays: set = set()
        # drain subscribers: called with the drain's info dict when the
        # ladder engages, BEFORE any state is torn down
        self._drain_listeners: List[Callable[[dict], None]] = []
        # drains executing now (the admin path runs OUTSIDE _recover_task):
        # a respawn's own kill must not read as a fresh child death
        self._drains_inflight = 0
        self.consecutive_respawn_failures = 0
        self.recoveries: List[dict] = []  # public record for tests
        # a respawn with another card (respawn_with_card), for its duration
        self._pending_card = None

    # ---------- subscriptions ----------

    def attach(self) -> "RecoveryController":
        if self.watchdog is not None:
            self.watchdog.add_trip_listener(self.on_trip)
        return self

    def add_drain_listener(self, fn: Callable[[dict], None]) -> None:
        """Subscribe to drain-ladder engagements (a sync callback with
        ``{engine, reason, hard}``, for automated recoveries and admin
        drains alike)."""
        self._drain_listeners.append(fn)

    def on_trip(self, info: dict) -> None:
        """Watchdog trip listener (sync, called from the watchdog's task).
        Engine-wedge reasons start the ladder; event_loop_lag is OUR loop
        lagging, which recovering the engine would not help."""
        if info.get("reason") not in ("decode_stall", "no_throughput"):
            return
        self._start_recovery(info.get("reason", "trip"))

    def on_child_down(self, reason: str) -> None:
        """Supervised-child death listener: run the respawn ladder
        proactively so the next request does not pay the spawn."""
        if self._drains_inflight:
            return  # our own respawn's kill, not a fresh death
        self._start_recovery(f"child_down:{reason}")

    def _start_recovery(self, reason: str) -> None:
        if self._recover_task is not None and not self._recover_task.done():
            return  # a recovery is already running
        self._recover_task = asyncio.get_running_loop().create_task(
            self._recover(reason), name=f"recovery-{self.engine_id}")

    async def _recover(self, reason: str) -> None:
        try:
            await self.drain(hard=True, respawn=True, reason=reason)
        except Exception:
            logger.exception("recovery ladder failed for %s", reason)
            self._actions.inc(action="drain", outcome="error")

    # ---------- the ladder ----------

    async def admin_drain(self, mode: str = "migrate",
                          respawn: bool = False) -> dict:
        """``POST /admin/drain``: a healthy engine drains for a rolling
        update: graceful seize, hot migration."""
        return await self.drain(hard=False, migrate=(mode != "fail"),
                                respawn=respawn, reason="admin")

    async def drain(self, hard: bool = False, migrate: Optional[bool] = None,
                    respawn: bool = False, reason: str = "admin") -> dict:
        self._drains_inflight += 1
        try:
            return await self._drain(hard, migrate, respawn, reason)
        finally:
            self._drains_inflight -= 1

    async def _drain(self, hard: bool, migrate: Optional[bool],
                     respawn: bool, reason: str) -> dict:
        t0 = time.monotonic()
        migrate = self.config.migrate if migrate is None else migrate
        summary = {"reason": reason, "hard": hard, "finished": 0,
                   "migrated": 0, "failed": 0, "respawned": False}
        self.flight.record("recovery.drain", engine=self.engine_id,
                           reason=reason, hard=hard)
        info = {"engine": self.engine_id, "reason": reason, "hard": hard}
        for fn in list(self._drain_listeners):
            try:
                fn(info)
            except Exception:
                # evidence capture must never take recovery down with it
                logger.exception("recovery drain listener failed")
        sched = self.scheduler
        # 1. gate: no new work here, no new routing decisions toward here
        if sched is not None:
            sched.set_draining(True)
        if self.admission is not None:
            self.admission.set_draining(True)
        await self._hook("deregister", self.deregister)
        if sched is not None:
            # 2. soft grace: committed work may finish on its own (a wedged
            # loop will not: the deadline bounds the wait)
            if not hard and self.config.drain_grace_s > 0:
                deadline = time.monotonic() + self.config.drain_grace_s
                while (time.monotonic() < deadline
                       and any(s is not None for s in sched.slots)):
                    await asyncio.sleep(0.05)
            # 3. seize the loop; 4. migrate or fail what remains
            await sched.seize(hard=hard, timeout_s=self.config.seize_timeout_s)
            for er in sched.extract_requests():
                if er.finish is not None or er.ctx.is_stopped:
                    sched.allocator.free_blocks(er.block_ids)
                    er.block_ids = []
                    if er.finish is None:
                        er.out_queue.put_nowait(None)  # the consumer is gone
                    summary["finished"] += 1
                    continue
                outcome = "failed"
                if migrate:
                    try:
                        outcome = await self._migrate_or_fail(
                            er, allow_hot=not hard)
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        # one request's packaging failing must not leave its
                        # siblings un-drained and hanging
                        logger.exception("migrating %s failed unexpectedly",
                                         er.request_id)
                        self._fail(er, "migration failed unexpectedly")
                else:
                    self._fail(er, "engine drained without migration")
                summary["migrated" if outcome == "migrated" else "failed"] += 1
        self._actions.inc(action="drain", outcome="ok")
        self._drain_hist.observe(time.monotonic() - t0)
        # 5. respawn
        if respawn and self.respawner is not None:
            summary["respawned"] = await self._respawn(reason)
        summary["duration_s"] = round(time.monotonic() - t0, 3)
        self.recoveries.append(summary)
        logger.warning("recovery drain [%s] done: %s", reason, summary)
        return summary

    async def _migrate_or_fail(self, er, allow_hot: bool = True) -> str:
        sched = self.scheduler
        if migration_class(er) == "fail":
            self._fail(er, "request class cannot migrate (in-process guided "
                           "state); resubmit to a healthy worker")
            return "failed"
        state = package_request(er, sched.allocator, sched.config.kv_block_size,
                                allow_hot=allow_hot and self.runner is not None)
        mode = "hot" if state.hot else "cold"
        for peer in self._candidate_peers(er):
            try:
                negotiate_backend(peer)  # tcp, or a peer offering none
                relay = await migrate_request(
                    peer["host"], peer["port"], er, state,
                    gather=self.runner.gather_blocks_device if state.hot else None,
                    to_host=self.runner.blocks_to_host if state.hot else None,
                    counts=self.shipped, metrics=self._xfer)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a nack, an unreachable peer or a failure of its own (a sick
                # device's gather raising): this attempt is dead, and the
                # request must still end migrated elsewhere or failed LOUDLY
                logger.warning("migration of %s to %s:%s failed: %s; trying "
                               "the next peer", er.request_id, peer.get("host"),
                               peer.get("port"), e)
                continue
            self._hold(relay)
            # the peer owns the KV now: release the source's copy
            sched.allocator.free_blocks(er.block_ids)
            er.block_ids = []
            self._migrations.inc(mode=mode, outcome="committed")
            self._actions.inc(action="migrate", outcome="ok")
            return "migrated"
        self._migrations.inc(mode=mode, outcome="failed")
        self._fail(er, "no healthy peer accepted the migration")
        return "failed"

    def _candidate_peers(self, er=None) -> List[dict]:
        if self.peers is None:
            return []
        try:
            peers = self.peers() or []
        except Exception:
            logger.exception("peer discovery failed")
            return []
        peers = [p for p in peers if p.get("engine_id") != self.engine_id]
        if self.peer_ranker is not None and er is not None and peers:
            # order by prefix overlap with this request so the peer that
            # already holds its KV is tried first (ties keep discovery order)
            try:
                peers = list(self.peer_ranker(peers, list(er.prompt)))
            except Exception:
                logger.exception("peer ranking failed; keeping discovery order")
        return peers

    def _fail(self, er, msg: str) -> None:
        logger.error("failing in-flight request %s: %s", er.request_id, msg)
        self.flight.record("recovery.request_failed", request_id=er.request_id,
                           trace_id=er.ctx.trace_id, reason=msg)
        if self.scheduler is not None:
            self.scheduler.allocator.free_blocks(er.block_ids)
            er.block_ids = []
        er.finish = FinishReason.ERROR
        er.ctx.add_stage("completion")
        er.out_queue.put_nowait(
            EngineOutput(token_ids=[], finish_reason=FinishReason.ERROR))
        er.out_queue.put_nowait(None)
        self._actions.inc(action="migrate", outcome="failed")

    async def respawn_with_card(self, card) -> bool:
        """Drain whatever this engine serves (migrating its requests away)
        and rebuild it with ANOTHER model card: the respawner must accept a
        ``card`` keyword (a factory that cannot swap cards fails loudly).
        For single-engine serving shapes only: a worker registered in
        discovery under one model must not be card-swapped in place."""
        self._drains_inflight += 1
        try:
            self._pending_card = card
            summary = await self._drain(
                hard=False, migrate=True, respawn=True,
                reason=f"model_swap:{getattr(card, 'name', card)}")
            return bool(summary.get("respawned"))
        finally:
            self._pending_card = None
            self._drains_inflight -= 1

    async def _respawn(self, reason: str) -> bool:
        delay = self.config.respawn_backoff_s
        while True:
            if self.consecutive_respawn_failures >= self.config.max_respawns:
                logger.error(
                    "respawn budget exhausted (%d consecutive failures); %s "
                    "stays down until operator action",
                    self.consecutive_respawn_failures, self.engine_id)
                self._actions.inc(action="respawn", outcome="gave_up")
                return False
            try:
                if self._pending_card is not None:
                    result = await self.respawner(card=self._pending_card)
                else:
                    result = await self.respawner()
            except Exception as e:
                self.consecutive_respawn_failures += 1
                self._actions.inc(action="respawn", outcome="failed")
                logger.warning(
                    "respawn attempt failed (%d/%d): %s; backing off %.1fs",
                    self.consecutive_respawn_failures,
                    self.config.max_respawns, e, delay)
                await asyncio.sleep(delay)
                delay *= 2
                continue
            self.consecutive_respawn_failures = 0
            self._actions.inc(action="respawn", outcome="ok")
            self.flight.record("recovery.respawn", engine=self.engine_id,
                               reason=reason)
            if result is not None:
                # the factory rebuilt the serving stack: a later drain
                # operates on the live scheduler
                self.scheduler = result
            await self._hook("register", self.register)
            if self.admission is not None:
                self.admission.set_draining(False)
            return True

    async def _hook(self, name: str, fn) -> None:
        if fn is None:
            return
        try:
            result = fn()
            if asyncio.iscoroutine(result) or isinstance(result, asyncio.Future):
                await result
            self._actions.inc(action=name, outcome="ok")
        except Exception:
            logger.exception("recovery %s hook failed", name)
            self._actions.inc(action=name, outcome="error")

    def _hold(self, task: asyncio.Task) -> None:
        """Keep relay tasks referenced until done; surface their failures."""
        self._relays.add(task)

        def _done(t: asyncio.Task) -> None:
            self._relays.discard(t)
            if not t.cancelled() and t.exception() is not None:
                logger.warning("migration relay failed: %s", t.exception())

        task.add_done_callback(_done)

    async def close(self) -> None:
        tasks = list(self._relays)
        if self._recover_task is not None:
            tasks.append(self._recover_task)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
