"""PoolManager: per-model worker pools — scale-to-zero + cold starts.

One serving plane, many models: the frontend routes ``model=`` to a
per-model pool (http/service.py ModelWatcher → per-model clients over
the lease-scoped endpoint registry). This manager adds the elasticity:

- **scale-to-zero** — a :class:`~.policy.PoolPolicy` loop watches each
  model's demand (requests through this frontend, optionally the fleet
  hub's per-worker activity) and drains an idle model's workers to zero
  through the configured backend (the recovery drain ladder on each worker,
  or a replica patch on the pool's deployment).
- **cold start** — the first request for a model whose pool is empty
  triggers a spawn *with that model's card* (respawn-with-different-
  card, the one new recovery capability) and waits, bounded by
  ``cold_start_deadline_s``, for a worker to join the pool; past the
  deadline the request is shed with 503 + Retry-After
  (:class:`ColdStartTimeout` at the HTTP edge).

Backends are two callables (``spawner(card)``, ``drainer(model)``) so
the same manager drives an InMemoryKube deployment in tests, the
api-store record a standalone operator reconciles, or a subprocess
respawn — :class:`KubePoolBackend` / :class:`StorePoolBackend` package
the replica-patch pair.

The port's copy of ``dynamo_tpu/registry/pools.py``. The CLI wires
``StorePoolBackend`` over ``deploy/store_source.ApiStoreClient`` when a
front has ``--api-store-url`` and ``--planner-deployment``; without them a
cold pool's requests wait out the deadline for a worker started
elsewhere.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Awaitable, Callable, Dict, Optional

from ..llm.model_card import slugify
from ..telemetry.registry import MetricsRegistry
from .cards import ModelCard
from .policy import PoolDemand, PoolPolicy, PoolPolicyConfig
from .registry import ModelRegistry

logger = logging.getLogger(__name__)


class ColdStartTimeout(Exception):
    """No worker joined the cold model's pool within the deadline; the
    edge maps this to 503 + Retry-After."""

    def __init__(self, model: str, waited_s: float,
                 retry_after_s: float = 5.0):
        super().__init__(
            f"model {model!r} is cold and no worker came up within "
            f"{waited_s:.1f}s — retry later"
        )
        self.model = model
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class PoolConfig:
    # bounded wait for a cold pool's first worker (0 = fail immediately)
    cold_start_deadline_s: float = 30.0
    # Retry-After hint on a cold-start timeout
    retry_after_s: float = 5.0
    # policy loop cadence (scale-to-zero decisions)
    interval_s: float = 1.0
    # how often the cold-start wait re-checks the pool
    poll_s: float = 0.05
    # pacing for re-kicking a spawn attempt that FAILED while waiters
    # still hold the deadline (a crashing spawner must not hot-loop)
    retry_kick_s: float = 1.0


class _PoolState:
    __slots__ = ("last_request_t", "requests_total", "cold_task",
                 "cold_waiters", "last_kick_t")

    def __init__(self, now: float):
        self.last_request_t = now
        self.requests_total = 0
        self.cold_task: Optional[asyncio.Task] = None
        self.cold_waiters = 0        # requests holding a cold-start wait
        self.last_kick_t = -1e9      # spawn-attempt pacing


class PoolManager:
    def __init__(
        self,
        registry_view: ModelRegistry,
        pool_size: Callable[[str], int],
        spawner: Optional[Callable[[ModelCard], Awaitable]] = None,
        drainer: Optional[Callable[[str], Awaitable]] = None,
        config: Optional[PoolConfig] = None,
        policy: Optional[PoolPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.view = registry_view
        self.pool_size = pool_size
        self.spawner = spawner
        self.drainer = drainer
        self.config = config or PoolConfig()
        self.policy = policy or PoolPolicy(
            PoolPolicyConfig(idle_to_zero_s=0.0), clock=clock)
        self.clock = clock
        self._pools: Dict[str, _PoolState] = {}
        self._task: Optional[asyncio.Task] = None
        self.view.add_listener(self._on_card)
        # cards registered before this manager existed still get pools
        now = self.clock()
        for name in self.view.cards:
            self._pools.setdefault(name, _PoolState(now))

        self.registry = registry or MetricsRegistry()
        self.registry.callback_gauge(
            "dynamo_registry_pool_workers_replicas",
            "Live workers per model pool, labelled model=",
            lambda: [
                ({"model": name}, self.pool_size(name))
                for name in sorted(self._pools)
            ],
        )
        self._cold_starts = self.registry.counter(
            "dynamo_registry_cold_starts_total",
            "Cold-start attempts per model=, outcome="
            "started|completed|timeout|no_spawner",
        )
        self._zero_scales = self.registry.counter(
            "dynamo_registry_scale_to_zero_total",
            "Idle pools drained to zero replicas, labelled model=",
        )
        self._cold_wait = self.registry.histogram(
            "dynamo_registry_cold_start_wait_seconds",
            "Cold-start wait of requests that found their pool empty "
            "(admitted AND shed waits)",
        )

    # ---------- registry feed ----------

    def _on_card(self, name: str, card) -> None:
        if card is None:
            state = self._pools.pop(name, None)
            if state is not None and state.cold_task is not None:
                state.cold_task.cancel()
            return
        if name not in self._pools:
            # idle accounting starts at first sight, so a never-
            # requested pool still ages out
            self._pools[name] = _PoolState(self.clock())

    # ---------- demand signals ----------

    def note_request(self, model: str) -> None:
        state = self._pools.get(model)
        if state is None:
            if self.view.card(model) is None:
                # card-less engines (local single-model serving) are not
                # pool citizens: tracking them would let scale-to-zero
                # inject junk pool services into deployment records
                return
            state = self._pools[model] = _PoolState(self.clock())
        state.last_request_t = self.clock()
        state.requests_total += 1

    def demand(self) -> Dict[str, PoolDemand]:
        now = self.clock()
        return {
            name: PoolDemand(
                workers=self.pool_size(name),
                idle_s=now - state.last_request_t,
                # waiters count too: a FAILED spawn attempt with
                # requests still holding the deadline keeps the cold
                # pressure visible, so the policy loop re-kicks it
                cold_pending=(state.cold_waiters > 0
                              or (state.cold_task is not None
                                  and not state.cold_task.done())),
            )
            for name, state in self._pools.items()
        }

    def snapshot(self) -> list:
        """``GET /admin/pools`` rows."""
        now = self.clock()
        return [
            {
                "model": name,
                "workers": self.pool_size(name),
                "idle_s": round(now - state.last_request_t, 3),
                "requests_total": state.requests_total,
                "cold_starting": (state.cold_task is not None
                                  and not state.cold_task.done()),
            }
            for name, state in sorted(self._pools.items())
        ]

    # ---------- cold start ----------

    async def await_capacity(self, model: str) -> None:
        """Gate one request on the model's pool having a worker.

        A warm pool returns immediately. A cold pool triggers ONE spawn
        with the model's card (concurrent requests share it) and polls
        until a worker joins or the deadline passes — then raises
        :class:`ColdStartTimeout` (the 503 + Retry-After path).
        """
        if self.pool_size(model) > 0:
            return
        t0 = self.clock()
        state = self._pools.get(model)
        if state is None:
            state = self._pools[model] = _PoolState(t0)
        state.cold_waiters += 1
        try:
            self._kick_cold_start(model, state)
            deadline = t0 + self.config.cold_start_deadline_s
            while self.clock() < deadline:
                if self.pool_size(model) > 0:
                    self._cold_wait.observe(self.clock() - t0)
                    self._cold_starts.inc(model=model,
                                          outcome="completed")
                    return
                # a FAILED spawn attempt retries (paced) while the
                # deadline still holds — one crash must not burn every
                # waiter's whole budget
                self._kick_cold_start(model, state)
                await asyncio.sleep(self.config.poll_s)
            self._cold_wait.observe(self.clock() - t0)
            self._cold_starts.inc(model=model, outcome="timeout")
            raise ColdStartTimeout(
                model, self.clock() - t0,
                retry_after_s=self.config.retry_after_s)
        finally:
            state.cold_waiters -= 1

    def _kick_cold_start(self, model: str, state: _PoolState) -> None:
        """Start (or paced-retry) one spawn attempt. The spawner should
        be idempotent toward "one worker up" — replica patches are; the
        manager re-invokes it until the pool has a worker or every
        waiter's deadline expires."""
        if state.cold_task is not None and not state.cold_task.done():
            return  # a spawn is already in flight — requests share it
        now = self.clock()
        if now - state.last_kick_t < self.config.retry_kick_s:
            return  # pace attempts (and the no-spawner accounting)
        state.last_kick_t = now
        card = self.view.card(model)
        if card is None or self.spawner is None:
            self._cold_starts.inc(model=model, outcome="no_spawner")
            return
        self._cold_starts.inc(model=model, outcome="started")
        logger.info("cold start: spawning a worker for model %s", model)

        async def spawn() -> None:
            try:
                await self.spawner(card)
            except asyncio.CancelledError:
                raise
            except Exception:
                # the waiters' deadline is the real failure path; the
                # spawn error itself must be diagnosable, not silent
                logger.exception("cold-start spawn for %s failed", model)

        state.cold_task = asyncio.get_running_loop().create_task(
            spawn(), name=f"cold-start-{model}")

    # ---------- scale-to-zero loop ----------

    def start(self, spawn=None) -> "PoolManager":
        if self._task is None:
            spawn = spawn or asyncio.get_running_loop().create_task
            self._task = spawn(self._loop())
        return self

    async def _loop(self) -> None:
        while True:
            try:
                await self.step()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("pool policy step failed")
            await asyncio.sleep(self.config.interval_s)

    async def step(self) -> list:
        """One observe→decide→actuate pass; returns applied actions."""
        applied = []
        for action in self.policy.decide(self.demand()):
            if action.kind == "scale_to_zero":
                if self.drainer is None:
                    continue
                logger.info("scale-to-zero: draining idle pool %s",
                            action.model)
                try:
                    await self.drainer(action.model)
                except Exception:
                    logger.exception("draining pool %s failed",
                                     action.model)
                    continue
                self._zero_scales.inc(model=action.model)
                applied.append(action)
            elif action.kind == "cold_start":
                state = self._pools.get(action.model)
                if state is not None:
                    self._kick_cold_start(action.model, state)
                    applied.append(action)
        return applied

    async def stop(self) -> None:
        tasks = [t for t in [self._task] if t is not None]
        self._task = None
        for state in self._pools.values():
            if state.cold_task is not None and not state.cold_task.done():
                tasks.append(state.cold_task)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)


# ---------------------------------------------------------------------------
# replica-patch backends (spawner/drainer pairs)
# ---------------------------------------------------------------------------


def pool_service_name(model: str) -> str:
    """CR/deployment service name of one model's pool."""
    return f"pool-{slugify(model)}"


def pool_service_spec(services: dict, model: str,
                      card: Optional[ModelCard] = None) -> dict:
    """Get-or-create one model pool's service spec in a CR/record
    ``services`` map: a decode-role worker deployment whose model flags
    come from the card (the cold-start material)."""
    service = pool_service_name(model)
    spec = services.setdefault(service, {"role": "decode"})
    if card is not None:
        if card.model_path:
            spec.setdefault("modelPath", card.model_path)
        spec.setdefault("modelName", card.name)
    return spec


class KubePoolBackend:
    """spawner/drainer over the deploy Reconciler: per-model pool
    services (decode-role worker deployments) in one CR, replicas
    patched 0↔N. ``InMemoryKube`` tests the loop end-to-end;
    Kubectl/KubeApi run it for real (the same split as
    planner/actuation.py KubeActuator)."""

    def __init__(self, reconciler, cr: dict, replicas: int = 1):
        self.reconciler = reconciler
        self.cr = cr
        self.replicas = replicas

    def _scale(self, model: str, replicas: int,
               card: Optional[ModelCard] = None) -> None:
        services = self.cr["spec"].setdefault("services", {})
        pool_service_spec(services, model, card)["replicas"] = int(replicas)

    async def _reconcile(self) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self.reconciler.reconcile, self.cr)

    async def spawn(self, card: ModelCard) -> None:
        self._scale(card.name, self.replicas, card)
        await self._reconcile()

    async def drain(self, model: str) -> None:
        self._scale(model, 0)
        await self._reconcile()


class StorePoolBackend:
    """Credless frontends: patch the pool's replica count into the
    api-store deployment record; the operator sourcing CRs from the
    store applies it on its next pass (planner StoreScaleActuator's
    pattern, per-model)."""

    def __init__(self, store_client, deployment: str, replicas: int = 1):
        self.store = store_client  # get(name) / update(name, spec), synchronous
        self.deployment = deployment
        self.replicas = replicas

    def _patch(self, model: str, replicas: int,
               card: Optional[ModelCard] = None) -> None:
        rec = self.store.get(self.deployment)
        if rec is None:
            logger.warning("deployment %r not in api-store — pool scale "
                           "skipped", self.deployment)
            return
        spec = rec["spec"]
        services = spec.setdefault("services", {})
        pool_service_spec(services, model, card)["replicas"] = int(replicas)
        self.store.update(self.deployment, spec)

    async def spawn(self, card: ModelCard) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(
            None, self._patch, card.name, self.replicas, card)

    async def drain(self, model: str) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._patch, model, 0)
