"""Workload side of the fleet simulator: synthetic generators + replay
(the port's copy of ``dynamo_tpu/sim/workload.py``).

Every generator is a pure function of a seeded ``random.Random`` — the
same seed always yields the same arrival list, which is half of the
byte-identical-report determinism contract (the other half is the
virtual clock in sim/clock.py).

Replay loaders accept the repo's own telemetry artifacts: a
DYN_TRACE_JSONL sink (telemetry/tracing.py record shape) or an incident
bundle directory (telemetry/incidents.py — ``traces.json``). Traces
capture *arrival shape* exactly; token sizes ride along when the record
carries ``isl``/``osl`` keys and otherwise derive deterministically from
the request id (crc32, not the salted builtin ``hash``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import zlib
from typing import Callable, Dict, List, Optional

DEFAULT_MODEL = "sim-model"


@dataclasses.dataclass
class Request:
    """One offered request, in virtual seconds from scenario start."""

    arrival_s: float
    request_id: str
    model: str = DEFAULT_MODEL
    tenant: str = "default"
    priority: int = 1              # index into planner PRIORITY_CLASSES
    isl: int = 512                 # prompt tokens
    osl: int = 128                 # output tokens
    # shared-prefix family: requests with the same group share
    # ``prefix_tokens`` leading tokens (RAG system prompt / few-shot
    # header), which is what the KV fabric's peer-pull and cold-tier
    # modeling keys on
    prefix_group: Optional[str] = None
    prefix_tokens: int = 0


def _stable_u32(s: str) -> int:
    return zlib.crc32(s.encode("utf-8")) & 0xFFFFFFFF


def _poisson_arrivals(
    rng: random.Random,
    duration_s: float,
    rate_fn: Callable[[float], float],
    peak_rate: float,
) -> List[float]:
    """Nonhomogeneous Poisson arrivals by thinning."""
    out: List[float] = []
    t = 0.0
    peak_rate = max(peak_rate, 1e-9)
    while True:
        t += rng.expovariate(peak_rate)
        if t >= duration_s:
            return out
        if rng.random() < rate_fn(t) / peak_rate:
            out.append(t)


def _pick_priority(rng: random.Random) -> int:
    # 20% low / 60% normal / 20% high — enough low-class volume that a
    # shed episode visibly spares the top class
    r = rng.random()
    if r < 0.2:
        return 0
    if r < 0.8:
        return 1
    return 2


# ---------------------------------------------------------------------------
# synthetic generators
# ---------------------------------------------------------------------------


def diurnal(
    rng: random.Random,
    duration_s: float = 1800.0,
    base_qps: float = 1.0,
    peak_qps: float = 6.0,
    period_s: float = 1200.0,
    burst_factor: float = 2.0,
    burst_window: tuple = (0.5, 0.6),
    isl: int = 512,
    osl: int = 128,
    model: str = DEFAULT_MODEL,
) -> List[Request]:
    """Bursty diurnal traffic: a sinusoidal day with a flash burst."""

    def rate(t: float) -> float:
        r = base_qps + (peak_qps - base_qps) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * t / period_s)
        )
        if burst_window[0] * duration_s <= t < burst_window[1] * duration_s:
            r *= burst_factor
        return r

    arrivals = _poisson_arrivals(rng, duration_s, rate, peak_qps * burst_factor)
    out = []
    for i, t in enumerate(arrivals):
        out.append(Request(
            arrival_s=t,
            request_id=f"diurnal-{i}",
            model=model,
            priority=_pick_priority(rng),
            isl=max(16, int(rng.lognormvariate(math.log(isl), 0.5))),
            osl=max(8, int(rng.lognormvariate(math.log(osl), 0.4))),
        ))
    return out


def rag(
    rng: random.Random,
    duration_s: float = 900.0,
    qps: float = 4.0,
    n_groups: int = 6,
    prefix_tokens: int = 2048,
    suffix_tokens: int = 256,
    osl: int = 96,
    model: str = DEFAULT_MODEL,
) -> List[Request]:
    """Shared-prefix RAG traffic: a few hot few-shot headers dominate,
    exercising prefix-overlap routing, fabric peer-pull, and cold-tier
    rehydration once eviction kicks in."""
    arrivals = _poisson_arrivals(rng, duration_s, lambda t: qps, qps)
    # zipf-ish popularity over the prefix families
    weights = [1.0 / (g + 1) for g in range(n_groups)]
    total_w = sum(weights)
    out = []
    for i, t in enumerate(arrivals):
        r = rng.random() * total_w
        group = 0
        acc = 0.0
        for g, w in enumerate(weights):
            acc += w
            if r <= acc:
                group = g
                break
        out.append(Request(
            arrival_s=t,
            request_id=f"rag-{i}",
            model=model,
            priority=_pick_priority(rng),
            isl=prefix_tokens + max(16, int(rng.expovariate(1.0 / suffix_tokens))),
            osl=max(8, int(rng.lognormvariate(math.log(osl), 0.3))),
            prefix_group=f"ctx{group}",
            prefix_tokens=prefix_tokens,
        ))
    return out


def long_context(
    rng: random.Random,
    duration_s: float = 900.0,
    qps: float = 2.0,
    long_fraction: float = 0.08,
    long_isl: int = 131072,
    short_isl: int = 512,
    osl: int = 64,
    model: str = DEFAULT_MODEL,
) -> List[Request]:
    """Mostly short prompts with a long tail of 128k sequence-parallel
    prefills — the SP byte model dominates the long requests."""
    arrivals = _poisson_arrivals(rng, duration_s, lambda t: qps, qps)
    out = []
    for i, t in enumerate(arrivals):
        is_long = rng.random() < long_fraction
        out.append(Request(
            arrival_s=t,
            request_id=f"lctx-{i}",
            model=model,
            priority=_pick_priority(rng),
            isl=(max(long_isl // 4, int(rng.uniform(0.25, 1.0) * long_isl))
                 if is_long
                 else max(16, int(rng.lognormvariate(math.log(short_isl), 0.5)))),
            osl=max(8, int(rng.lognormvariate(math.log(osl), 0.3))),
        ))
    return out


def tenant_spike(
    rng: random.Random,
    duration_s: float = 900.0,
    base_qps: float = 2.0,
    spike_qps: float = 15.0,
    spike_window: tuple = (0.35, 0.55),
    spike_tenant: str = "burst-tenant",
    isl: int = 384,
    osl: int = 96,
    model: str = DEFAULT_MODEL,
) -> List[Request]:
    """Steady multi-tenant baseline plus one tenant flooding far past
    its quota — the token-bucket 429 path, per-tenant shed attribution."""
    lo, hi = spike_window[0] * duration_s, spike_window[1] * duration_s
    base = _poisson_arrivals(rng, duration_s, lambda t: base_qps, base_qps)
    out = []
    for i, t in enumerate(base):
        out.append(Request(
            arrival_s=t,
            request_id=f"ten-b{i}",
            model=model,
            tenant=rng.choice(("acme", "globex")),
            priority=_pick_priority(rng),
            isl=max(16, int(rng.lognormvariate(math.log(isl), 0.4))),
            osl=max(8, int(rng.lognormvariate(math.log(osl), 0.3))),
        ))
    spike = _poisson_arrivals(
        rng, hi - lo, lambda t: spike_qps, spike_qps)
    for i, t in enumerate(spike):
        out.append(Request(
            arrival_s=lo + t,
            request_id=f"ten-s{i}",
            model=model,
            tenant=spike_tenant,
            priority=0,
            isl=max(16, int(rng.lognormvariate(math.log(isl), 0.4))),
            osl=max(8, int(rng.lognormvariate(math.log(osl), 0.3))),
        ))
    out.sort(key=lambda r: (r.arrival_s, r.request_id))
    return out


def chaos(
    rng: random.Random,
    duration_s: float = 900.0,
    qps: float = 3.0,
    isl: int = 384,
    osl: int = 96,
    model: str = DEFAULT_MODEL,
) -> List[Request]:
    """Steady load for the fault-injection scenario; the wedge schedule
    itself lives in the scenario config (DYN_FAULT vocabulary), not in
    the arrival process."""
    arrivals = _poisson_arrivals(rng, duration_s, lambda t: qps, qps)
    return [
        Request(
            arrival_s=t,
            request_id=f"chaos-{i}",
            model=model,
            priority=_pick_priority(rng),
            isl=max(16, int(rng.lognormvariate(math.log(isl), 0.4))),
            osl=max(8, int(rng.lognormvariate(math.log(osl), 0.3))),
        )
        for i, t in enumerate(arrivals)
    ]


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------


def _request_from_trace(
    record: dict,
    t0: float,
    index: int,
    model: Optional[str],
    default_isl: int,
    default_osl: int,
) -> Request:
    rid = str(record.get("request_id") or f"replay-{index}")
    u = _stable_u32(rid)
    return Request(
        arrival_s=max(0.0, float(record.get("time", t0)) - t0),
        request_id=rid,
        model=model or str(record.get("model") or DEFAULT_MODEL),
        tenant=str(record.get("tenant") or "default"),
        priority=int(record.get("priority", 1)),
        # honor explicit sizes; otherwise derive a stable spread from
        # the request id so replay is seed-independent reproducible
        isl=int(record.get("isl") or (default_isl // 2 + u % default_isl)),
        osl=int(record.get("osl") or (default_osl // 2 + (u >> 8) % default_osl)),
    )


def load_trace_jsonl(
    path: str,
    model: Optional[str] = None,
    default_isl: int = 512,
    default_osl: int = 128,
) -> List[Request]:
    """A DYN_TRACE_JSONL sink (one telemetry/tracing.py record per line)
    → offered requests, arrival-normalized to t=0."""
    records: List[dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return _requests_from_records(records, model, default_isl, default_osl)


def load_incident_bundle(
    bundle_dir: str,
    model: Optional[str] = None,
    default_isl: int = 512,
    default_osl: int = 128,
) -> List[Request]:
    """An incident bundle (telemetry/incidents.py) → the traffic that
    led into the failure, replayed from ``traces.json``."""
    path = os.path.join(bundle_dir, "traces.json")
    with open(path, "r", encoding="utf-8") as f:
        traces = json.load(f)
    records = [t for t in traces if isinstance(t, dict)]
    return _requests_from_records(records, model, default_isl, default_osl)


def _requests_from_records(
    records: List[dict],
    model: Optional[str],
    default_isl: int,
    default_osl: int,
) -> List[Request]:
    timed = [r for r in records if isinstance(r.get("time"), (int, float))]
    t0 = min((float(r["time"]) for r in timed), default=0.0)
    out = [
        _request_from_trace(rec, t0, i, model, default_isl, default_osl)
        for i, rec in enumerate(records)
    ]
    out.sort(key=lambda r: (r.arrival_s, r.request_id))
    return out


GENERATORS: Dict[str, Callable] = {
    "diurnal": diurnal,
    "rag": rag,
    "long_context": long_context,
    "tenant_spike": tenant_spike,
    "chaos": chaos,
}
