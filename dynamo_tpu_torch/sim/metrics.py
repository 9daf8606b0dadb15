"""``dynamo_sim_*`` instrument family (the port's copy of
``dynamo_tpu/sim/metrics.py``): a long replay is itself observable through
the standard ``/metrics`` plumbing.

The fleet attaches every real component's registry (admission, planner,
registry/pools, tenants, SLO) plus this family to one root
MetricsRegistry, so ``render()`` of a sim run is a legal exposition a
live scrape job could ingest.
"""

from __future__ import annotations

from typing import Callable

from ..telemetry.registry import MetricsRegistry


class SimMetrics:
    """Counters/gauges for one simulator run."""

    def __init__(self, registry: MetricsRegistry,
                 clock: Callable[[], float],
                 replica_fn: Callable[[], dict]) -> None:
        self.registry = registry
        self.requests = registry.counter(
            "dynamo_sim_requests_total",
            "Offered requests by terminal outcome= (completed|shed|"
            "queue_full|timeout|draining|quota|cold_start_timeout|"
            "failed) and priority= class",
        )
        self.tokens = registry.counter(
            "dynamo_sim_tokens_total",
            "Simulated tokens processed, labelled phase=prefill|decode",
        )
        self.scale_actions = registry.counter(
            "dynamo_sim_scale_actions_total",
            "Planner scale actions the sim actuated, labelled role= "
            "and direction=up|down",
        )
        self.chaos = registry.counter(
            "dynamo_sim_chaos_injections_total",
            "Chaos events injected into simulated workers, labelled "
            "site= (DYN_FAULT vocabulary)",
        )
        self.recoveries = registry.counter(
            "dynamo_sim_recoveries_total",
            "Recovery ladders the real controller completed inside the "
            "sim, labelled reason=",
        )
        self.trips = registry.counter(
            "dynamo_sim_watchdog_trips_total",
            "Simulated watchdog trips (stalled-worker detections) that "
            "started a recovery ladder",
        )
        self.retries = registry.counter(
            "dynamo_sim_resubmits_total",
            "Requests the simulated client resubmitted after a drain "
            "failed their first attempt",
        )
        self.attainment = registry.gauge(
            "dynamo_sim_slo_attainment_ratio",
            "SLO-met fraction of completed requests for the finished "
            "run (the report's headline number)",
        )
        self.kv_usage = registry.gauge(
            "dynamo_sim_kv_usage_ratio",
            "Fleet KV block usage at the last sample of the run",
        )
        registry.callback_gauge(
            "dynamo_sim_virtual_time_seconds",
            "Virtual seconds the scenario has advanced",
            clock,
        )
        registry.callback_gauge(
            "dynamo_sim_workers_replicas",
            "Live simulated workers per model= pool",
            lambda: [({"model": m}, float(n))
                     for m, n in sorted(replica_fn().items())],
        )
