"""Scenario vocabulary: named (workload, fleet shape, SLO floor)
triples, plus the seeded entrypoint that runs one against the real
control plane and returns the report dict (the port's copy of
``dynamo_tpu/sim/scenarios.py``).

Determinism contract: ``run_scenario(name, seed)`` seeds the global
``random`` module (the KvScheduler tie-break uses it), resets the fault
registry, builds a fresh ``VirtualClock``, and never reads wall time —
so the same (name, seed, overrides) always produces a byte-identical
report JSON.

The reference's ``rag_pod`` scenario (the rag fleet inside one pod whose
peer pulls ride a plane between cards) is refused by name:
``POD_REFUSED``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional

from ..planner.admission import AdmissionConfig
from ..planner.policy import PolicyConfig
from ..registry.policy import PoolPolicyConfig
from ..registry.tenants import TenantQuota
from ..utils import faults
from .clock import VirtualClock, run_virtual
from .fleet import ChaosEvent, FleetConfig, SimFleet
from .report import build_report
from .worker import POD_REFUSED, WorkerSpec
from .workload import GENERATORS, Request


@dataclasses.dataclass
class Scenario:
    """A named scenario: how traffic arrives + what fleet serves it."""

    name: str
    description: str
    slo_floor: float                       # capacity-curve attainment bar
    duration_s: float
    fleet: Callable[[], FleetConfig]       # fresh config per run
    workload: Optional[Callable[[random.Random, float], List[Request]]] = None


def _base_policy(**kw) -> PolicyConfig:
    base = dict(
        min_replicas=1, max_replicas=6, scale_step=1,
        scale_up_cooldown_s=60.0, scale_down_cooldown_s=300.0,
        decode_busy_up=0.85, decode_busy_down=0.25,
        shed_step_cooldown_s=10.0, relax_after_clear_s=60.0,
    )
    base.update(kw)
    return PolicyConfig(**base)


def _diurnal_fleet() -> FleetConfig:
    # two-model fleet: the primary rides the diurnal wave while a small
    # aux pool goes idle after its early traffic and scales to zero
    return FleetConfig(
        pools={"sim-model": 2, "sim-aux": 1},
        spec=WorkerSpec(),
        policy=_base_policy(),
        pool_policy=PoolPolicyConfig(idle_to_zero_s=300.0, cooldown_s=60.0),
        admission=AdmissionConfig(limit=40, queue_depth=64,
                                  queue_timeout_s=20.0),
    )


def _diurnal_workload(rng: random.Random,
                      duration_s: float) -> List[Request]:
    reqs = GENERATORS["diurnal"](rng, duration_s=duration_s)
    # a thin trickle to the aux model that stops a third of the way in,
    # leaving the pool idle long enough for scale-to-zero to fire
    aux = GENERATORS["diurnal"](
        rng, duration_s=duration_s / 3.0, base_qps=0.2, peak_qps=0.5,
        burst_factor=1.0, model="sim-aux")
    for i, r in enumerate(aux):
        r.request_id = f"aux-{i}"
    out = reqs + aux
    out.sort(key=lambda r: (r.arrival_s, r.request_id))
    return out


def _rag_fleet() -> FleetConfig:
    # small cache → evictions → cold-tier rehydration
    spec = WorkerSpec(kv_blocks=1024)
    return FleetConfig(
        pools={"sim-model": 3},
        spec=spec,
        policy=_base_policy(max_replicas=5),
        admission=AdmissionConfig(limit=48, queue_depth=96,
                                  queue_timeout_s=20.0),
    )


def _long_context_fleet() -> FleetConfig:
    # 128k prompts need headroom: 131072/16 = 8192 blocks just for one
    # prompt's KV, so provision deep pools and SP-friendly thresholds
    spec = WorkerSpec(kv_blocks=16384, slots=6)
    return FleetConfig(
        pools={"sim-model": 2},
        spec=spec,
        policy=_base_policy(max_replicas=5),
        admission=AdmissionConfig(limit=24, queue_depth=48,
                                  queue_timeout_s=30.0),
        slo_ttft_s=20.0,                  # SP prefill of 128k is slow
        slo_itl_s=1.0,                    # SP interleave gaps are legit
        watchdog_stall_s=30.0,
    )


def _tenant_spike_fleet() -> FleetConfig:
    return FleetConfig(
        pools={"sim-model": 2, "sim-burst": 0},
        spec=WorkerSpec(),
        policy=_base_policy(max_replicas=5),
        admission=AdmissionConfig(limit=32, queue_depth=48,
                                  queue_timeout_s=15.0),
        quota_default=TenantQuota(),      # unlimited baseline
        quota_overrides={
            "burst-tenant": TenantQuota(requests_per_s=2.0, burst_s=4.0),
        },
        pool_policy=PoolPolicyConfig(idle_to_zero_s=600.0,
                                     cooldown_s=60.0),
    )


def _tenant_spike_workload(rng: random.Random,
                           duration_s: float) -> List[Request]:
    reqs = GENERATORS["tenant_spike"](rng, duration_s=duration_s)
    # a late burst at the zero-replica aux pool exercises cold start
    # through PoolManager.await_capacity
    cold = GENERATORS["diurnal"](
        rng, duration_s=duration_s / 4.0, base_qps=0.3, peak_qps=0.6,
        burst_factor=1.0, model="sim-burst")
    for i, r in enumerate(cold):
        r.request_id = f"cold-{i}"
        r.arrival_s += duration_s / 2.0
        r.tenant = "acme"
    out = reqs + cold
    out.sort(key=lambda r: (r.arrival_s, r.request_id))
    return out


def _chaos_fleet() -> FleetConfig:
    # two workers so the wedge halves capacity: the outage genuinely
    # overloads the admission edge (shed ladder engages, low classes
    # first) until the watchdog→drain→respawn ladder restores it
    return FleetConfig(
        pools={"sim-model": 2},
        spec=WorkerSpec(),
        policy=_base_policy(max_replicas=4),
        admission=AdmissionConfig(limit=40, queue_depth=64,
                                  queue_timeout_s=20.0),
        watchdog_stall_s=12.0,
        chaos=[ChaosEvent(at_s=400.0, site="decode_burst_hang",
                          worker_index=0)],
    )


SCENARIOS: Dict[str, Scenario] = {
    "diurnal": Scenario(
        name="diurnal",
        description="bursty diurnal wave + aux pool scaling to zero",
        slo_floor=0.7,
        duration_s=1800.0,
        fleet=_diurnal_fleet,
        workload=_diurnal_workload,
    ),
    "rag": Scenario(
        name="rag",
        description="shared-prefix RAG: overlap routing, peer pull, "
                    "cold-tier rehydration",
        slo_floor=0.7,
        duration_s=900.0,
        fleet=_rag_fleet,
    ),
    "long_context": Scenario(
        name="long_context",
        description="long-tail 128k SP prefills over a short-prompt "
                    "baseline",
        slo_floor=0.5,
        duration_s=900.0,
        fleet=_long_context_fleet,
    ),
    "tenant_spike": Scenario(
        name="tenant_spike",
        description="tenant floods past its token-bucket quota; cold "
                    "start of a scale-to-zero pool",
        slo_floor=0.6,
        duration_s=900.0,
        fleet=_tenant_spike_fleet,
        workload=_tenant_spike_workload,
    ),
    "chaos": Scenario(
        name="chaos",
        description="worker wedge mid-run: watchdog trip, drain, "
                    "respawn via the real recovery ladder",
        slo_floor=0.5,
        duration_s=900.0,
        fleet=_chaos_fleet,
    ),
    "replay": Scenario(
        name="replay",
        description="recorded traffic (DYN_TRACE_JSONL sink or "
                    "incident bundle) against a standard fleet",
        slo_floor=0.5,
        duration_s=900.0,
        fleet=_diurnal_fleet,
    ),
}

# the reference's scenarios the port refuses by name, with the reason
REFUSED_SCENARIOS: Dict[str, str] = {"rag_pod": POD_REFUSED}


def run_scenario(
    name: str,
    seed: int = 0,
    duration_s: Optional[float] = None,
    requests: Optional[List[Request]] = None,
    fleet_cfg: Optional[FleetConfig] = None,
    slo_floor: Optional[float] = None,
    on_fleet=None,
) -> dict:
    """Run one scenario to completion in virtual time; return the
    report dict (see sim/report.py for its anatomy).

    ``requests`` overrides the scenario's generator (trace replay);
    ``duration_s`` shortens/stretches a synthetic run (tests use this).
    """
    if name in REFUSED_SCENARIOS:
        raise NotImplementedError(REFUSED_SCENARIOS[name])
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    scn = SCENARIOS[name]
    dur = float(duration_s if duration_s is not None else scn.duration_s)
    random.seed(seed)                     # scheduler tie-breaks
    faults.reset()
    rng = random.Random(seed)
    if requests is None:
        if scn.workload is not None:
            requests = scn.workload(rng, dur)
        elif name in GENERATORS:
            requests = GENERATORS[name](rng, duration_s=dur)
        else:
            raise ValueError(
                f"scenario {name!r} has no synthetic generator — "
                "pass requests= (trace replay)")
    elif duration_s is None and requests:
        # replayed traces define their own horizon
        dur = max(dur, max(r.arrival_s for r in requests) + 60.0)
    cfg = fleet_cfg if fleet_cfg is not None else scn.fleet()
    if duration_s is not None and cfg.chaos:
        # keep chaos inside a shortened run
        for ev in cfg.chaos:
            if ev.at_s >= dur:
                ev.at_s = dur * 0.4
    clock = VirtualClock()
    fleet = SimFleet(cfg, clock)

    async def _main() -> None:
        await fleet.run(requests)

    run_virtual(_main, clock=clock)
    if on_fleet is not None:
        # post-run hook: callers render /metrics, inspect workers, etc.
        on_fleet(fleet)
    floor = float(slo_floor if slo_floor is not None else scn.slo_floor)
    return build_report(name, seed, fleet, floor, dur)
