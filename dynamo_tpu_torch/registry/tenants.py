"""TenantQuotas: per-tenant token-bucket admission at the HTTP edge.

Multi-tenant isolation layered ON TOP of the existing priority-class
admission (planner/admission.py): the ``X-Tenant`` header maps each
request to an admission class with its own token buckets — one in
requests (refilled at ``requests_per_s``) and one in generated/streamed
tokens (refilled at ``tokens_per_s``). A tenant that exceeds its quota
is shed with 429 + Retry-After (``dynamo_planner_admissions_total``
``outcome="quota"``) while every other tenant's requests proceed
untouched — a spike sheds the spiker, not the fleet.

Parsing mirrors the X-Priority contract: an absent, unknown, or garbage
header degrades to the ``default`` tenant (counted on
``dynamo_registry_tenant_fallbacks_total``), never a 500 — quota
enforcement is a service-protection mechanism, not input validation.

The token bucket is charged by ACTUAL streamed tokens (the edge calls
``charge_tokens`` per payload chunk), so the balance may overdraft
below zero; an overdrafted tenant is shed until refill catches up —
bursts are allowed up to ``burst_s`` seconds of rate, then paid back.

The port's copy of ``dynamo_tpu/registry/tenants.py`` (clock injectable
as there).
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import time
from typing import Callable, Dict, Optional

from ..planner.admission import AdmissionRejected
from ..telemetry.registry import MetricsRegistry

TENANT_HEADER = "X-Tenant"
DEFAULT_TENANT = "default"
# a usable tenant id; anything else is garbage and degrades to default
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def parse_tenant(header_value: Optional[str]) -> str:
    """Header → tenant id, quota-free: tenant IDENTITY (who is asking,
    for card visibility) is independent of whether quota enforcement is
    configured. Absent or garbage degrades to the default tenant —
    the X-Priority parsing contract."""
    if not header_value:
        return DEFAULT_TENANT
    v = header_value.strip()
    return v if _TENANT_RE.match(v) else DEFAULT_TENANT


@dataclasses.dataclass
class TenantQuota:
    requests_per_s: float = 0.0   # 0 = unlimited
    tokens_per_s: float = 0.0     # 0 = unlimited
    burst_s: float = 2.0          # bucket capacity = rate × burst_s

    @classmethod
    def from_wire(cls, d: dict) -> "TenantQuota":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: float(v) for k, v in d.items() if k in known})


class _Bucket:
    __slots__ = ("rate", "cap", "level", "refill_t")

    def __init__(self, rate: float, burst_s: float, now: float):
        self.rate = rate
        # capacity never below one unit, or a 0.5 rps tenant could
        # never admit anything at all
        self.cap = max(1.0, rate * burst_s)
        self.level = self.cap
        self.refill_t = now

    def refill(self, now: float) -> None:
        if self.rate <= 0 or now <= self.refill_t:
            # a caller's clock sample may predate the bucket's creation
            # by a tick — never refill backwards
            return
        self.level = min(self.cap,
                         self.level + (now - self.refill_t) * self.rate)
        self.refill_t = now

    def until(self, target: float) -> float:
        """Seconds until the level reaches ``target``."""
        if self.rate <= 0:
            return 1.0
        return max(0.0, (target - self.level) / self.rate)


class _TenantState:
    __slots__ = ("requests", "tokens", "seen_t")

    def __init__(self, quota: TenantQuota, now: float):
        self.requests = _Bucket(quota.requests_per_s, quota.burst_s, now)
        self.tokens = _Bucket(quota.tokens_per_s, quota.burst_s, now)
        self.seen_t = now


class TenantQuotas:
    """Single-loop discipline like the admission controller: all state
    mutation happens on the event loop; no locks."""

    def __init__(
        self,
        default: Optional[TenantQuota] = None,
        overrides: Optional[Dict[str, TenantQuota]] = None,
        clock: Callable[[], float] = time.monotonic,
        max_tracked: int = 1024,
        registry: Optional[MetricsRegistry] = None,
        admissions_registry: Optional[MetricsRegistry] = None,
    ):
        self.default = default or TenantQuota()
        self.overrides = dict(overrides or {})
        self.clock = clock
        self.max_tracked = max(1, max_tracked)
        self._tenants: Dict[str, _TenantState] = {}

        self.registry = registry or MetricsRegistry()
        # the quota outcome rides the SAME family the priority classes
        # shed on — when the edge also runs an AdmissionController,
        # bind ITS registry (get-or-create returns the one counter; two
        # registries each owning the family would double-render it).
        # Created lazily so a bind-before-traffic never leaves an empty
        # duplicate family on this object's own registry.
        self._admissions = None
        if admissions_registry is not None:
            self.bind_admissions(admissions_registry)
        self._sheds = self.registry.counter(
            "dynamo_registry_tenant_sheds_total",
            "Quota rejections, labelled tenant= and bucket="
            "requests|tokens",
        )
        self._fallbacks = self.registry.counter(
            "dynamo_registry_tenant_fallbacks_total",
            "Requests whose X-Tenant header was present but unusable "
            "(garbage or over-length) and degraded to the default tenant",
        )
        self._tokens_c = self.registry.counter(
            "dynamo_registry_tenant_tokens_total",
            "Streamed tokens charged against tenant= budgets",
        )

    def bind_admissions(self, registry: MetricsRegistry) -> None:
        """Count quota outcomes on another registry's
        ``dynamo_planner_admissions_total`` (the admission controller's)
        instead of this object's own — one family, one exposition."""
        self._admissions = registry.counter(
            "dynamo_planner_admissions_total",
            "Admission decisions by priority= class and outcome="
            "admitted|shed|queue_full|timeout|draining|quota",
        )

    def _admissions_counter(self):
        if self._admissions is None:
            self.bind_admissions(self.registry)
        return self._admissions

    # ---------- construction from flags ----------

    @classmethod
    def from_flags(cls, default_rps: float, default_tps: float,
                   overrides_path: Optional[str] = None,
                   burst_s: float = 2.0) -> "TenantQuotas":
        """CLI wiring: ``--tenant-rps/--tenant-tps`` defaults plus an
        optional JSON file ``{"tenant": {"requests_per_s": ..,
        "tokens_per_s": .., "burst_s": ..}, ...}`` of overrides.
        Read synchronously — this runs at process startup, not on the
        serving loop."""
        overrides = {}
        if overrides_path:
            with open(overrides_path) as f:
                raw = json.load(f)
            for name, spec in raw.items():
                if not _TENANT_RE.match(name):
                    raise ValueError(f"bad tenant name {name!r} in "
                                     f"{overrides_path}")
                overrides[name] = TenantQuota.from_wire(spec)
        return cls(
            default=TenantQuota(requests_per_s=default_rps,
                                tokens_per_s=default_tps,
                                burst_s=burst_s),
            overrides=overrides,
        )

    # ---------- the X-Priority-mirroring parse contract ----------

    def resolve(self, header_value: Optional[str]) -> str:
        """Header → tenant id. Absent → default; present-but-garbage →
        default WITH a counter (an operator should know clients send
        broken headers); any well-formed id is a first-class tenant
        with its own buckets — isolation must not require pre-
        registration."""
        if header_value:
            v = header_value.strip()
            if not _TENANT_RE.match(v):
                self._fallbacks.inc()
        return parse_tenant(header_value)

    # ---------- the buckets ----------

    def _quota_for(self, tenant: str) -> TenantQuota:
        return self.overrides.get(tenant, self.default)

    def _state(self, tenant: str) -> _TenantState:
        now = self.clock()
        state = self._tenants.get(tenant)
        if state is None:
            if len(self._tenants) >= self.max_tracked:
                self._evict_idle(now)
            state = self._tenants[tenant] = _TenantState(
                self._quota_for(tenant), now)
        state.seen_t = now
        return state

    def _evict_idle(self, now: float) -> None:
        """Drop the longest-idle tracked tenant — a bounded table, not
        an unbounded per-client-id map (an eviction forgives at most
        one burst window of debt)."""
        oldest = min(self._tenants, key=lambda t: self._tenants[t].seen_t)
        del self._tenants[oldest]

    def admit(self, tenant: str, request_id: str = "") -> None:
        """Charge one request; raises :class:`AdmissionRejected`
        (outcome ``quota``) when either bucket is exhausted."""
        now = self.clock()
        state = self._state(tenant)
        state.requests.refill(now)
        state.tokens.refill(now)
        if state.requests.rate > 0 and state.requests.level < 1.0:
            self._reject(tenant, "requests", state.requests.until(1.0))
        if state.tokens.rate > 0 and state.tokens.level <= 0.0:
            # overdrafted by a previous stream's actual usage: shed
            # until the refill pays the debt back past zero
            self._reject(tenant, "tokens", state.tokens.until(1.0))
        if state.requests.rate > 0:
            state.requests.level -= 1.0
        # deliberately NOT counted as outcome="admitted" here: on the
        # shared family the admission controller owns the admitted row
        # (counting both would double every accepted request); quotas
        # contribute only their own rejection outcome

    def _reject(self, tenant: str, bucket: str, wait_s: float) -> None:
        self._sheds.inc(tenant=tenant, bucket=bucket)
        self._admissions_counter().inc(tenant=tenant, outcome="quota")
        raise AdmissionRejected(
            f"tenant {tenant!r} exceeded its {bucket} quota — retry "
            f"after the bucket refills",
            retry_after_s=max(1.0, math.ceil(wait_s)),
            outcome="quota",
        )

    def charge_tokens(self, tenant: str, n: int = 1) -> None:
        """Post-admission accounting: actual streamed tokens drain the
        token bucket (possibly below zero — the overdraft delays the
        tenant's NEXT admission, never breaks the current stream)."""
        if n <= 0:
            return
        state = self._tenants.get(tenant)
        if state is None or state.tokens.rate <= 0:
            return
        state.tokens.refill(self.clock())
        state.tokens.level -= n
        self._tokens_c.inc(n, tenant=tenant)

    # ---------- introspection ----------

    def snapshot(self) -> Dict[str, dict]:
        now = self.clock()
        out = {}
        for name, state in sorted(self._tenants.items()):
            state.requests.refill(now)
            state.tokens.refill(now)
            out[name] = {
                "requests_level": round(state.requests.level, 2),
                "tokens_level": round(state.tokens.level, 2),
            }
        return out
