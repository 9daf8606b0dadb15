"""Fleet telemetry hub: cluster-wide /metrics scrape + rollups.

The port's copy of ``dynamo_tpu/telemetry/hub.py``: the scrape goes through
the port's own HTTP GET client (``http/server.http_get``, with the
reference's timeout) instead of an aiohttp session, discovery records are
packed with the runtime's wire codec (``runtime/wire.py``), and the /fleet
handlers answer through the port's ``RouteServer``.

The repo's observability so far is *per-process*: every role renders a
Prometheus exposition (frontend on the service port, dyn:// workers on
``--metrics-port`` sidecars), and a fleet view required an external
Prometheus. The :class:`FleetHub` is the in-cluster pane: a
discovery-driven scraper that pulls every process's exposition into
bounded per-worker :class:`~dynamo_tpu_torch.telemetry.history.MetricHistory`
rings and serves

- ``GET /fleet/metrics`` — per-family rollups (sum/max/avg by role,
  counter rates over the window), and
- ``GET /fleet/workers`` — the per-worker operational row: KV
  utilization, busy ratio, roofline fraction, SLO attainment, drain
  state, watchdog trips, scrape liveness.

Targets come from three places, composable: a static list (``--hub-
target role=url``), in-process registries (the ``in=http`` frontend
scrapes itself and its engine with zero HTTP), and the discovery plane —
workers that start a metrics sidecar register its URL under
``{ns}/telemetry/metrics/...`` (lease-scoped, so a dead worker's target
vanishes with its lease), the same pattern the migration receivers use.

The hub is also the reference's planner signal source
(``signal_source()``): fleet-level saturation (mean busy ratio, mean KV
usage, summed waiting, summed watchdog trips, windowed SLO attainment)
under the ``decode.*``/``kv.*``/``slo.*`` names; the port has no planner
yet to read it.

Discipline: the scrape task is held and cancelled on ``stop()``,
exposition parsing rides the executor, and one unreachable target is
counted and skipped — never fatal.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable, Dict, List, Optional

from ..http.server import http_get, json_response
from ..runtime.wire import packb, unpackb
from .exposition import parse_exposition
from .history import MetricHistory
from .registry import MetricsRegistry

logger = logging.getLogger(__name__)

# discovery keys for metrics sidecars: {ns}/telemetry/metrics/{role}/{instance}
METRICS_ENDPOINT_PREFIX = "telemetry/metrics"

# how long a vanished target's last-known rows stay visible (marked
# down) before the hub forgets the worker entirely
DEFAULT_RETAIN_S = 120.0


def metrics_endpoint_key(namespace: str, role: str, instance: str) -> str:
    return f"{namespace}/{METRICS_ENDPOINT_PREFIX}/{role}/{instance}"


async def register_metrics_endpoint(drt, namespace: str, role: str,
                                    instance: str, url: str) -> None:
    """Advertise this process's /metrics sidecar in the discovery plane
    (lease-scoped: the target disappears with the worker's lease)."""
    lease = await drt.discovery.primary_lease()
    await drt.discovery.kv_put(
        metrics_endpoint_key(namespace, role, instance),
        packb({"url": url, "role": role, "name": instance}),
        lease_id=lease.id,
    )


def discovery_targets(drt, namespace: str) -> Callable[[], Awaitable[List[dict]]]:
    """A hub ``discover`` callable over the discovery plane's registered
    sidecars (see :func:`register_metrics_endpoint`)."""
    prefix = f"{namespace}/{METRICS_ENDPOINT_PREFIX}/"

    async def discover() -> List[dict]:
        kvs = await drt.discovery.kv_get_prefix(prefix)
        out = []
        for v in kvs.values():
            try:
                out.append(unpackb(v))
            except Exception:
                logger.warning("malformed metrics-endpoint record skipped",
                               exc_info=True)
        return out

    return discover


def parse_target_flag(spec: str) -> dict:
    """``role=url`` (or a bare url, role "worker") → target dict; the
    instance name defaults to the url's host:port."""
    role, sep, url = spec.partition("=")
    if not sep:
        role, url = "worker", spec
    role = role.strip() or "worker"
    url = url.strip()
    if "://" not in url:
        url = f"http://{url}"
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    name = url.split("://", 1)[1].split("/", 1)[0]
    return {"url": url, "role": role, "name": name}


class _Worker:
    """One scraped process: its history rings + scrape liveness."""

    __slots__ = ("name", "role", "url", "history", "last_ok_t",
                 "last_attempt_t", "last_error", "seen_t")

    def __init__(self, name: str, role: str, url: Optional[str],
                 history: MetricHistory):
        self.name = name
        self.role = role
        self.url = url  # None for in-process registries
        self.history = history
        self.last_ok_t: Optional[float] = None
        self.last_attempt_t: Optional[float] = None
        self.last_error: Optional[str] = None
        self.seen_t: float = 0.0  # last time the target list contained it


class FleetHub:
    """Scrapes the fleet into history rings; serves rollups."""

    def __init__(
        self,
        targets: Optional[List[dict]] = None,
        discover: Optional[Callable[[], Awaitable[List[dict]]]] = None,
        interval_s: float = 2.0,
        timeout_s: float = 1.5,
        history_window_s: float = 600.0,
        history_max_samples: int = 512,
        retain_s: float = DEFAULT_RETAIN_S,
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.static_targets = list(targets or [])
        self.discover = discover
        self.interval_s = max(0.05, interval_s)
        self.timeout_s = timeout_s
        self.history_window_s = history_window_s
        self.history_max_samples = history_max_samples
        self.retain_s = retain_s
        self.clock = clock
        self._workers: Dict[str, _Worker] = {}
        self._locals: Dict[str, tuple] = {}  # name → (role, registry)
        self._task: Optional[asyncio.Task] = None

        self.registry = registry or MetricsRegistry()
        self._scrapes_c = self.registry.counter(
            "dynamo_hub_scrapes_total",
            "Hub scrape attempts, labelled role= and outcome=ok|error",
        )
        self._scrape_hist = self.registry.histogram(
            "dynamo_hub_scrape_duration_seconds",
            "One target's fetch+parse+ingest wall time",
        )
        self.registry.callback_gauge(
            "dynamo_hub_fleet_workers_replicas",
            "Workers the hub currently tracks, labelled role= and "
            "up=true|false (scrape liveness)",
            self._worker_counts,
        )
        self.registry.callback_gauge(
            "dynamo_hub_fleet_busy_ratio",
            "Fleet mean decode slot occupancy, by role= (the hub-side "
            "rollup a Prometheus avg() should agree with)",
            # dynrace: domain(executor)
            lambda: self._rollup_gauge("dynamo_scheduler_slot_occupancy_ratio"),
        )
        self.registry.callback_gauge(
            "dynamo_hub_fleet_kv_usage_ratio",
            "Fleet mean KV block usage, by role=",
            # dynrace: domain(executor)
            lambda: self._rollup_gauge("dynamo_kv_block_usage_ratio"),
        )
        self.registry.callback_gauge(
            "dynamo_hub_history_series_depth",
            "History-ring series held across all tracked workers",
            # dynrace: domain(executor)
            lambda: sum(w.history.series_count()
                        for w in list(self._workers.values())),
        )

    # ---------- wiring ----------

    def add_local(self, name: str, role: str, registry) -> None:
        """Scrape an in-process registry on the same cadence (the
        frontend's own exposition, an in-process engine) — no HTTP."""
        self._locals[name] = (role, registry)

    # ---------- lifecycle ----------

    def start(self, spawn=None) -> "FleetHub":
        if self._task is None:
            spawn = spawn or asyncio.get_running_loop().create_task
            self._task = spawn(self._loop())
        return self

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        while True:
            try:
                await self.scrape_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("hub scrape cycle failed; continuing")
            await asyncio.sleep(self.interval_s)

    # ---------- scraping ----------

    async def _target_list(self) -> List[dict]:
        targets = list(self.static_targets)
        if self.discover is not None:
            try:
                targets.extend(await self.discover() or [])
            except Exception:
                logger.warning("hub target discovery failed; scraping "
                               "last known pool", exc_info=True)
                # keep every previously-seen remote target alive
                targets.extend(
                    {"url": w.url, "role": w.role, "name": w.name}
                    for w in self._workers.values()
                    if w.url is not None
                    and not any(t.get("name") == w.name
                                for t in targets)
                )
        return targets

    def _worker_for(self, name: str, role: str,
                    url: Optional[str]) -> _Worker:
        w = self._workers.get(name)
        if w is None:
            w = self._workers[name] = _Worker(
                name, role, url,
                MetricHistory(window_s=self.history_window_s,
                              max_samples=self.history_max_samples,
                              clock=self.clock),
            )
        w.role = role
        w.url = url if url is not None else w.url
        w.seen_t = self.clock()
        return w

    async def scrape_once(self) -> None:
        targets = await self._target_list()
        jobs = []
        for t in targets:
            name = t.get("name") or t.get("url")
            if not name or not t.get("url"):
                continue
            w = self._worker_for(name, t.get("role") or "worker", t["url"])
            jobs.append(self._scrape_http(w))
        for name, (role, registry) in self._locals.items():
            w = self._worker_for(name, role, None)
            jobs.append(self._scrape_local(w, registry))
        if jobs:
            await asyncio.gather(*jobs)
        # forget workers that left the target set long enough ago that
        # their last-known rows stopped being useful
        cutoff = self.clock() - self.retain_s
        for name in [n for n, w in self._workers.items()
                     if w.seen_t < cutoff]:
            del self._workers[name]

    async def _scrape(self, w: _Worker, fetch) -> None:
        """Shared attempt/error/success bookkeeping around one target's
        exposition fetch (HTTP or in-process render)."""
        t0 = self.clock()
        w.last_attempt_t = t0
        try:
            text = await fetch()
            await self._ingest(w, text)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # one sick target must not take the fleet pane down — count
            # it, keep its history (the curve UP TO the failure is the
            # interesting part), and let /fleet/workers show it down
            w.last_error = repr(e)
            self._scrapes_c.inc(role=w.role, outcome="error")
            logger.debug("hub scrape of %s (%s) failed: %s",
                         w.name, w.url or "local", e)
        else:
            w.last_ok_t = self.clock()
            w.last_error = None
            self._scrapes_c.inc(role=w.role, outcome="ok")
            self._scrape_hist.observe(self.clock() - t0)

    async def _scrape_http(self, w: _Worker) -> None:
        async def fetch() -> str:
            body = await http_get(w.url, self.timeout_s)
            return body.decode("utf-8")

        await self._scrape(w, fetch)

    async def _scrape_local(self, w: _Worker, registry) -> None:
        async def fetch() -> str:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(None, registry.render)

        await self._scrape(w, fetch)

    async def _ingest(self, w: _Worker, text: str) -> None:
        loop = asyncio.get_running_loop()
        # parsing a large exposition is the scrape's CPU cost — executor
        families = await loop.run_in_executor(None, parse_exposition, text)
        w.history.ingest(families)

    # ---------- rollups ----------
    #
    # Read-side methods run OFF the event loop too: the /fleet handlers
    # ride the executor, and the callback gauges above fire inside any
    # executor-side registry.render (the sidecar server, the hub's own
    # local scrape). The scrape loop is the only writer; readers iterate
    # GIL-atomic list() snapshots of _workers and never mutate history
    # (see telemetry/history.py's threading note), so a concurrent
    # scrape-side insert/expire can't raise mid-iteration.

    def _up(self, w: _Worker) -> bool:
        if w.last_ok_t is None:
            return False
        return (self.clock() - w.last_ok_t) <= max(
            3 * self.interval_s, self.timeout_s)

    # registry render callback: runs wherever /metrics renders (loop
    # handler, hub executor offload, flight-dump thread) — reads must be
    # snapshot-safe
    # dynrace: domain(executor)
    def _worker_counts(self):
        counts: Dict[tuple, int] = {}
        for w in list(self._workers.values()):
            key = (w.role, "true" if self._up(w) else "false")
            counts[key] = counts.get(key, 0) + 1
        return [({"role": role, "up": up}, n)
                for (role, up), n in sorted(counts.items())]

    # dynrace: domain(executor)
    def _rollup_gauge(self, name: str):
        by_role: Dict[str, List[float]] = {}
        for w in list(self._workers.values()):
            if not self._up(w):
                # a wedged worker's last scrape stays readable in its
                # /fleet/workers row (marked down) but must not silently
                # steer a fleet AVERAGE for up to history_window_s
                continue
            v = w.history.latest(name)
            if v is not None:
                by_role.setdefault(w.role, []).append(v)
        return [({"role": role}, sum(vals) / len(vals))
                for role, vals in sorted(by_role.items())]

    def fleet_metrics(self, window_s: Optional[float] = None,
                      prefix: str = "dynamo_") -> dict:
        """Every family's sum/max/avg by role over UP workers
        (per-worker values are the worker's label-set sum), plus
        windowed per-second rates for cumulative series only — a
        gauge's slope reported under the same key would read as an
        event rate. The ``GET /fleet/metrics`` body."""
        families: Dict[str, dict] = {}
        for w in list(self._workers.values()):
            if not self._up(w):
                continue  # same staleness rule as _rollup_gauge
            # single pass per worker: this endpoint walks every name of
            # every worker on each poll, so per-name
            # series scans would go quadratic in series count
            summaries = w.history.name_summaries(window_s=window_s,
                                                 prefix=prefix)
            for name, summ in summaries.items():
                v = summ["latest"]
                fam = families.setdefault(name, {"roles": {}})
                roles = fam["roles"]
                entry = roles.setdefault(
                    w.role, {"sum": 0.0, "max": None, "workers": 0})
                entry["sum"] += v
                entry["max"] = v if entry["max"] is None else max(
                    entry["max"], v)
                entry["workers"] += 1
                if summ["kind"] == "counter":
                    entry["rate_per_s"] = entry.get(
                        "rate_per_s", 0.0) + summ["rate"]
        for fam in families.values():
            for entry in fam["roles"].values():
                entry["avg"] = entry["sum"] / entry["workers"]
        return {
            "time": time.time(),
            "window_s": window_s if window_s is not None
            else self.history_window_s,
            "families": families,
        }

    def fleet_workers(self, slo_window_s: float = 60.0) -> dict:
        """Per-worker operational rows — the ``GET /fleet/workers`` body."""
        rows = []
        now = self.clock()
        for w in sorted(list(self._workers.values()), key=lambda x: x.name):
            hist = w.history
            # slo="request" is the per-request conjunction (met EVERY
            # configured SLO) — blending the ttft/itl dimension series
            # would overstate attainment vs the SlaPolicy floor
            attained = hist.rate("dynamo_slo_attainment_total",
                                 {"slo": "request", "met": "true"},
                                 window_s=slo_window_s)
            judged = hist.rate("dynamo_slo_attainment_total",
                               {"slo": "request"}, window_s=slo_window_s)
            draining = hist.latest("dynamo_scheduler_draining_info")
            # the model this worker serves (multi-model fleet): workers
            # stamp dynamo_registry_model_info{model=} on their registry
            model = None
            for labels, _v in hist.samples("dynamo_registry_model_info"):
                if labels.get("model"):
                    model = labels["model"]
                    break
            row = {
                "name": w.name,
                "role": w.role,
                "model": model,
                "url": w.url,
                "up": self._up(w),
                "scrape_age_s": (
                    round(now - w.last_ok_t, 3)
                    if w.last_ok_t is not None else None
                ),
                "error": w.last_error,
                "kv_usage_ratio": hist.latest("dynamo_kv_block_usage_ratio"),
                "kv_active_blocks": hist.latest("dynamo_kv_active_blocks"),
                "busy_ratio": hist.latest(
                    "dynamo_scheduler_slot_occupancy_ratio"),
                "active_slots": hist.latest("dynamo_scheduler_active_slots"),
                "waiting": hist.latest("dynamo_scheduler_waiting_requests"),
                "roofline_fraction": hist.latest(
                    "dynamo_engine_roofline_fraction"),
                # prefix-hit view, fabric-aware: the local two-tier hit
                # ratio PLUS the datacenter-cache activity — committed
                # remote pulls and cold-tier rehydrates count tokens the
                # fleet never recomputed even though no local tier held
                # them (None = the worker runs no fabric)
                "prefix_hit_ratio": hist.latest(
                    "dynamo_kv_prefix_hit_ratio"),
                "prefix_pulls_per_s": (
                    round(hist.rate(
                        "dynamo_kv_fabric_prefix_pull_total",
                        {"outcome": "committed"},
                        window_s=slo_window_s), 3)
                    if hist.latest(
                        "dynamo_kv_fabric_prefix_pull_total") is not None
                    else None
                ),
                "cold_hits_per_s": (
                    round(hist.rate(
                        "dynamo_kv_fabric_cold_tier_hits_total",
                        window_s=slo_window_s), 3)
                    if hist.latest(
                        "dynamo_kv_fabric_cold_tier_hits_total")
                    is not None else None
                ),
                "slo_attainment": (
                    attained / judged if judged else None
                ),
                "draining": bool(draining) if draining is not None else None,
                "watchdog_trips": hist.latest("dynamo_watchdog_trips_total"),
                "restarts": hist.latest("dynamo_engine_restarts_total"),
                "incidents": hist.latest("dynamo_incidents_total"),
                # None = no HTTP metrics at all; 0.0 = a real flatline
                # (exactly the incident-time signal the pane exists for)
                "requests_per_s": (
                    round(hist.rate("dynamo_http_service_requests_total",
                                    window_s=slo_window_s), 3)
                    if hist.latest(
                        "dynamo_http_service_requests_total") is not None
                    else None
                ),
            }
            rows.append(row)
        return {"time": time.time(), "workers": rows}

    # ---------- planner signal source ----------

    def signal_source(self) -> Callable[[], Dict[str, float]]:
        """Fleet-level saturation under the existing policy vocabulary
        (planner/policy.py SIG_*): the planner consults the POOL, not
        whichever single scrape it happens to sit next to."""

        # the planner polls this from its own loop/executor context
        # dynrace: domain(executor)
        def snapshot() -> Dict[str, float]:
            busy: List[float] = []
            kv: List[float] = []
            waiting = 0.0
            have_waiting = False
            trips = 0.0
            have_trips = False
            attained = judged = 0.0
            for w in list(self._workers.values()):
                if not self._up(w):
                    continue
                hist = w.history
                b = hist.latest("dynamo_scheduler_slot_occupancy_ratio")
                if b is not None:
                    busy.append(b)
                k = hist.latest("dynamo_kv_block_usage_ratio")
                if k is not None:
                    kv.append(k)
                q = hist.latest("dynamo_scheduler_waiting_requests")
                if q is not None:
                    waiting += q
                    have_waiting = True
                t = hist.latest("dynamo_watchdog_trips_total")
                if t is not None:
                    trips += t
                    have_trips = True
                attained += hist.rate(
                    "dynamo_slo_attainment_total",
                    {"slo": "request", "met": "true"}, window_s=60.0)
                judged += hist.rate("dynamo_slo_attainment_total",
                                    {"slo": "request"}, window_s=60.0)
            out: Dict[str, float] = {}
            if busy:
                out["decode.slot_busy_ratio"] = sum(busy) / len(busy)
            if kv:
                out["kv.usage_ratio"] = sum(kv) / len(kv)
            if have_waiting:
                out["decode.waiting"] = waiting
            if have_trips:
                # cumulative (reset-adjusted) fleet trip total: the
                # policy's delta() over this series is trips-in-window
                out["watchdog.trips"] = trips
            if judged > 0:
                out["slo.attainment"] = attained / judged
            return out

        return snapshot

    # ---------- route handlers (mounted by HttpService / MetricsServer) ----------

    async def handle_fleet_metrics(self, request, conn=None):
        window = None
        raw = request.query.get("window")
        if raw:
            try:
                window = max(1.0, float(raw))
            except ValueError:
                return json_response({"error": "bad window"}, status=400)
        prefix = request.query.get("prefix", "dynamo_")
        loop = asyncio.get_running_loop()
        body = await loop.run_in_executor(
            None, lambda: self.fleet_metrics(window, prefix))
        return json_response(body)

    async def handle_fleet_workers(self, request, conn=None):
        loop = asyncio.get_running_loop()
        body = await loop.run_in_executor(None, self.fleet_workers)
        return json_response(body)
