"""PoolPolicy: deterministic per-model pool decisions.

The planner's multi-model half: given each model's
demand signals — pool size, seconds since the last request, whether a
cold start is pending — decide which idle pools to drain to zero and
which cold pools to start. Deliberately the same shape as
``planner/policy.py``'s SlaPolicy: pure ``decide()`` over a snapshot,
injectable clock, per-model cooldowns so a flapping demand signal can't
thrash a pool, and the caller (PoolManager or a standalone planner)
owns actuation.

The port's copy of ``dynamo_tpu/registry/policy.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional


@dataclasses.dataclass
class PoolPolicyConfig:
    # a pool with no request for this long drains to zero (0 = never)
    idle_to_zero_s: float = 300.0
    # a nonzero floor DISABLES scale-to-zero for every pool: the only
    # drain this policy emits is to-zero (that's what the backends
    # implement), so a floor above zero means "never drain" rather than
    # silently draining past the floor
    min_workers: int = 0
    # per-model action pacing: a drained pool isn't re-drained, a
    # started pool isn't re-started, within the cooldown
    cooldown_s: float = 30.0


@dataclasses.dataclass
class PoolDemand:
    """One model's demand snapshot, as the caller observed it.

    ``idle_s`` counts from the last request OR from when the pool was
    first observed — a pool that never saw traffic still ages out."""

    workers: int                   # live pool size
    idle_s: float                  # seconds since the last request
    cold_pending: bool = False     # a request is waiting on a cold start


@dataclasses.dataclass
class PoolAction:
    model: str
    kind: str  # "scale_to_zero" | "cold_start"


class PoolPolicy:
    def __init__(self, config: Optional[PoolPolicyConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or PoolPolicyConfig()
        self.clock = clock
        self._last_action: Dict[str, float] = {}  # model → last action t

    def _cooled(self, model: str, now: float) -> bool:
        last = self._last_action.get(model)
        return last is None or (now - last) >= self.config.cooldown_s

    def decide(self, demand: Mapping[str, PoolDemand]) -> List[PoolAction]:
        cfg = self.config
        now = self.clock()
        actions: List[PoolAction] = []
        for model in sorted(demand):
            d = demand[model]
            if d.cold_pending and d.workers <= 0:
                # demand for a cold pool beats any idle accounting —
                # and beats the cooldown too: the request is WAITING
                actions.append(PoolAction(model, "cold_start"))
                self._last_action[model] = now
                continue
            if (cfg.idle_to_zero_s > 0
                    and cfg.min_workers == 0
                    and d.workers > 0
                    and d.idle_s >= cfg.idle_to_zero_s
                    and self._cooled(model, now)):
                actions.append(PoolAction(model, "scale_to_zero"))
                self._last_action[model] = now
        return actions
