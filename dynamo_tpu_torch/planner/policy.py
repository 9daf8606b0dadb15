"""SLA policy engine: rolling-window signals → typed control actions.

The port's copy of ``dynamo_tpu/planner/policy.py``: pure logic, the
same thresholds, pacing and reason strings.

This is the decision half of the closed loop (PAPER.md §1 layer 9 — the
planner the reference's K8s controllers feed): pure functions of a
:class:`~dynamo_tpu_torch.planner.signals.SignalStore` plus the policy's own
hysteresis state. It never touches the cluster, the router, or the HTTP
edge — it only *emits* :data:`Action` values; planner/actuation.py turns
them into replica patches, router-config pushes, and admission-limit
changes. That split is what makes the loop testable: scripted metric
feeds in, pinned action sequences out (tests/test_torch_planner.py holds
them against the reference's).

Flap resistance is structural, not incidental:

- **hysteresis** — every scale trigger has separate up and down
  thresholds; the band between them is a dead zone where nothing moves.
- **cooldown** — after any action on a role, that role is frozen for
  ``scale_up_cooldown_s`` / ``scale_down_cooldown_s`` (down is slower:
  shedding capacity is the riskier direction under a spike).
- **bounds** — replica targets clamp to [min_replicas, max_replicas];
  the admission shed level never reaches the highest priority class.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Mapping, Optional, Union

from .signals import SignalStore

# canonical signal names (one vocabulary shared by sources, policy, and
# docs/planner.md — drift here means the policy silently sees nothing)
SIG_PREFILL_QUEUE_WAIT = "prefill.queue_wait_s"
SIG_PREFILL_QUEUE_DEPTH = "prefill.queue_depth"
SIG_DECODE_SLOT_BUSY = "decode.slot_busy_ratio"
SIG_DECODE_WAITING = "decode.waiting"
SIG_KV_USAGE = "kv.usage_ratio"
SIG_WATCHDOG_TRIPS = "watchdog.trips"
SIG_ADMISSION_QUEUE_DEPTH = "admission.queue_depth"
SIG_ADMISSION_INFLIGHT_RATIO = "admission.inflight_ratio"
# user-visible latency (telemetry/slo.py SloTracker.snapshot — the HTTP
# edge's per-request TTFT/ITL verdicts as rolling attainment fractions)
SIG_SLO_ATTAINMENT = "slo.attainment"
SIG_SLO_TTFT_ATTAINMENT = "slo.ttft_attainment"
SIG_SLO_ITL_ATTAINMENT = "slo.itl_attainment"
SIG_SLO_GOODPUT = "slo.goodput_tokens_per_s"


@dataclasses.dataclass(frozen=True)
class ScaleAction:
    """Patch one role's worker-pool replica count."""

    role: str              # "prefill" | "decode"
    target_replicas: int
    current_replicas: int
    reason: str

    @property
    def direction(self) -> str:
        return "up" if self.target_replicas > self.current_replicas else "down"


@dataclasses.dataclass(frozen=True)
class RebalanceAction:
    """Retune the disagg router's local/remote prefill split."""

    max_local_prefill_length: int
    max_prefill_queue_size: int
    reason: str


@dataclasses.dataclass(frozen=True)
class AdmissionAction:
    """Tighten/relax the HTTP edge: shed level + concurrency limit.

    ``shed_level`` counts priority classes shed from the bottom: 0 sheds
    nothing, 1 sheds the lowest class, and so on. The policy never
    emits a level that would shed the highest class. ``limit`` is None
    when the admission concurrency limit should stay as configured.
    """

    shed_level: int
    limit: Optional[int]   # max concurrently admitted; None = leave as-is
    reason: str


Action = Union[ScaleAction, RebalanceAction, AdmissionAction]


@dataclasses.dataclass
class PolicyConfig:
    """Thresholds and pacing for :class:`SlaPolicy`.

    Defaults are deliberately conservative; the CLI exposes the
    operationally interesting ones as ``--planner-*`` flags.
    """

    window_s: float = 10.0               # aggregate window for triggers

    # ----- prefill pool (queue-wait is the SLA-facing signal) -----
    prefill_queue_wait_up_s: float = 1.0
    prefill_queue_wait_down_s: float = 0.1
    prefill_queue_depth_up: float = 4.0

    # ----- decode pool (slot occupancy + admission backlog) -----
    decode_busy_up: float = 0.9
    decode_busy_down: float = 0.3
    decode_waiting_up: float = 4.0

    # ----- scaling pacing/bounds -----
    min_replicas: int = 1
    max_replicas: int = 8
    scale_step: int = 1
    scale_up_cooldown_s: float = 30.0
    scale_down_cooldown_s: float = 120.0

    # ----- disagg rebalance (remote-prefill threshold) -----
    rebalance_cooldown_s: float = 30.0
    min_local_prefill_length: int = 250
    max_local_prefill_length: int = 16000
    rebalance_factor: float = 2.0        # threshold moves multiplicatively

    # ----- admission control -----
    # SLO-driven saturation: attainment (SLO-met fraction of completed
    # requests over the window) below this floor counts as saturation —
    # the control loop acts on USER-VISIBLE latency, not queue proxies.
    # Only consulted when the slo.* signals are registered (an edge
    # serving without --slo-* flags feeds nothing and nothing changes).
    slo_attainment_floor: float = 0.9
    saturation_kv_usage: float = 0.95
    saturation_busy: float = 0.95
    saturation_waiting: float = 8.0
    saturation_admission_queue: float = 4.0  # at full edge concurrency
    shed_step_cooldown_s: float = 5.0    # between shed-level increases
    relax_after_clear_s: float = 30.0    # healthy this long → relax a level
    max_shed_level: int = 2              # never sheds the highest class
    admitted_limit: Optional[int] = None  # None = leave the edge's limit alone


class SlaPolicy:
    """Deterministic policy: ``decide(signals, replicas)`` → actions.

    Holds only pacing state (last action times, current shed level /
    rebalance threshold) — all load state lives in the SignalStore, so a
    restarted planner re-derives its view from the next few scrapes.
    """

    def __init__(
        self,
        config: Optional[PolicyConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        initial_local_prefill_length: int = 1000,
        initial_prefill_queue_size: int = 2,
    ):
        self.config = config or PolicyConfig()
        self.clock = clock
        self._last_scale_t: dict = {}        # role → monotonic t of last action
        self._last_scale_dir: dict = {}      # role → "up" | "down"
        self._last_rebalance_t: Optional[float] = None
        self._last_shed_change_t: Optional[float] = None
        self._clear_since: Optional[float] = None
        self._prev = None  # decide()'s pacing snapshot, for rollback()
        self.shed_level = 0
        self.local_prefill_length = initial_local_prefill_length
        self.prefill_queue_size = initial_prefill_queue_size

    # ---------- helpers ----------

    def _cooled(self, role: str, direction: str) -> bool:
        last = self._last_scale_t.get(role)
        if last is None:
            return True
        cd = (self.config.scale_up_cooldown_s if direction == "up"
              else self.config.scale_down_cooldown_s)
        return self.clock() - last >= cd

    def _mark_scaled(self, role: str, direction: str) -> None:
        self._last_scale_t[role] = self.clock()
        self._last_scale_dir[role] = direction

    def _scale(self, role: str, replicas: Mapping[str, int], direction: str,
               reason: str) -> Optional[ScaleAction]:
        current = replicas.get(role)
        if current is None:
            return None  # role not deployed — nothing to scale
        if not self._cooled(role, direction):
            return None
        step = self.config.scale_step
        target = current + step if direction == "up" else current - step
        target = max(self.config.min_replicas,
                     min(self.config.max_replicas, target))
        if target == current:
            return None
        self._mark_scaled(role, direction)
        return ScaleAction(role=role, target_replicas=target,
                           current_replicas=current, reason=reason)

    # ---------- the decision ----------

    def decide(self, signals: SignalStore,
               replicas: Mapping[str, int]) -> List[Action]:
        """One policy pass. Deterministic given the store, the replica
        map, and the injected clock."""
        cfg = self.config
        w = cfg.window_s
        actions: List[Action] = []
        # snapshot the pacing state so an action NO actuator applies can
        # be rolled back (rollback()) — otherwise the policy's view
        # (shed level, router threshold, cooldowns) silently diverges
        # from reality for the rest of the process lifetime
        self._prev = (
            dict(self._last_scale_t), self._last_rebalance_t,
            self._last_shed_change_t, self.shed_level,
            self.local_prefill_length, self._clear_since,
        )

        # --- prefill pool: queue wait is the SLA signal; queue depth is
        # an independent trigger (the standalone planner often has only
        # the depth poll — the wait histogram lives on the workers) ---
        queue_wait = signals.mean(SIG_PREFILL_QUEUE_WAIT, w)
        queue_depth = signals.latest(SIG_PREFILL_QUEUE_DEPTH, 0.0)
        depth_mean = signals.mean(SIG_PREFILL_QUEUE_DEPTH, w)
        wait_s = "—" if queue_wait is None else f"{queue_wait:.2f}s"
        if ((queue_wait is not None
                and queue_wait > cfg.prefill_queue_wait_up_s)
                or queue_depth > cfg.prefill_queue_depth_up):
            a = self._scale(
                "prefill", replicas, "up",
                f"prefill queue wait {wait_s} depth {queue_depth:.0f}")
            if a:
                actions.append(a)
        elif ((queue_wait is None or
                queue_wait < cfg.prefill_queue_wait_down_s)
                and depth_mean == 0 and queue_depth == 0):
            # idle needs a full idle window, not one empty-depth sample
            a = self._scale(
                "prefill", replicas, "down",
                f"prefill idle (wait {wait_s}, empty queue)")
            if a:
                actions.append(a)

        # --- decode pool: slot occupancy + admission backlog ---
        busy = signals.mean(SIG_DECODE_SLOT_BUSY, w)
        waiting = signals.latest(SIG_DECODE_WAITING, 0.0)
        if busy is not None and (
                busy > cfg.decode_busy_up or waiting > cfg.decode_waiting_up):
            a = self._scale(
                "decode", replicas, "up",
                f"decode busy {busy:.2f} waiting {waiting:.0f}")
            if a:
                actions.append(a)
        elif busy is not None and busy < cfg.decode_busy_down and waiting == 0:
            a = self._scale(
                "decode", replicas, "down",
                f"decode idle (busy {busy:.2f})")
            if a:
                actions.append(a)

        # --- disagg rebalance: shift the local/remote split toward the
        # side with headroom ---
        rebalance = self._decide_rebalance(signals)
        if rebalance:
            actions.append(rebalance)

        # --- admission: shed under saturation, relax when clear ---
        admission = self._decide_admission(signals)
        if admission:
            actions.append(admission)

        return actions

    def rollback(self, action: Action) -> None:
        """Undo the pacing state an emitted-but-unapplied action
        committed, so the decision retries next cycle instead of the
        policy believing a change that never landed."""
        prev = getattr(self, "_prev", None)
        if prev is None:
            return
        scale_t, rebalance_t, shed_t, shed_level, local_len, clear = prev
        if isinstance(action, ScaleAction):
            if action.role in scale_t:
                self._last_scale_t[action.role] = scale_t[action.role]
            else:
                self._last_scale_t.pop(action.role, None)
        elif isinstance(action, RebalanceAction):
            self.local_prefill_length = local_len
            self._last_rebalance_t = rebalance_t
        elif isinstance(action, AdmissionAction):
            self.shed_level = shed_level
            self._last_shed_change_t = shed_t
            self._clear_since = clear

    def _decide_rebalance(self, signals: SignalStore) -> Optional[RebalanceAction]:
        cfg = self.config
        now = self.clock()
        if (self._last_rebalance_t is not None
                and now - self._last_rebalance_t < cfg.rebalance_cooldown_s):
            return None
        queue_depth = signals.latest(SIG_PREFILL_QUEUE_DEPTH)
        busy = signals.mean(SIG_DECODE_SLOT_BUSY, cfg.window_s)
        if queue_depth is None or busy is None:
            return None
        new_len = self.local_prefill_length
        reason = ""
        if (queue_depth > self.prefill_queue_size
                and busy < cfg.decode_busy_up):
            # prefill pool backed up while decode has headroom: raise the
            # threshold so more prefills stay local
            new_len = min(cfg.max_local_prefill_length,
                          int(self.local_prefill_length
                              * cfg.rebalance_factor))
            reason = (f"prefill queue {queue_depth:.0f} deep, decode busy "
                      f"{busy:.2f} — keep more prefill local")
        elif queue_depth == 0 and busy > cfg.decode_busy_up:
            # decode saturated while the prefill queue is drained: lower
            # the threshold so long prefills go remote again
            new_len = max(cfg.min_local_prefill_length,
                          int(self.local_prefill_length
                              / cfg.rebalance_factor))
            reason = (f"decode busy {busy:.2f}, prefill queue empty — "
                      f"send more prefill remote")
        if new_len == self.local_prefill_length:
            return None
        self.local_prefill_length = new_len
        self._last_rebalance_t = now
        return RebalanceAction(
            max_local_prefill_length=new_len,
            max_prefill_queue_size=self.prefill_queue_size,
            reason=reason,
        )

    def _saturated(self, signals: SignalStore) -> Optional[str]:
        """Non-empty reason string when the serving plane is saturated."""
        cfg = self.config
        w = cfg.window_s
        kv = signals.latest(SIG_KV_USAGE)
        if kv is not None and kv >= cfg.saturation_kv_usage:
            return f"kv usage {kv:.2f}"
        busy = signals.mean(SIG_DECODE_SLOT_BUSY, w)
        waiting = signals.latest(SIG_DECODE_WAITING, 0.0)
        if (busy is not None and busy >= cfg.saturation_busy
                and waiting >= cfg.saturation_waiting):
            return f"decode busy {busy:.2f} with {waiting:.0f} waiting"
        if signals.delta(SIG_WATCHDOG_TRIPS, w) > 0:
            return "watchdog tripped"
        # user-visible latency: the share of completed requests meeting
        # their TTFT/ITL targets fell through the floor — saturation by
        # the only definition the user can feel
        slo = signals.mean(SIG_SLO_ATTAINMENT, w)
        if (cfg.slo_attainment_floor > 0 and slo is not None
                and slo < cfg.slo_attainment_floor):
            return (f"slo attainment {slo:.2f} below floor "
                    f"{cfg.slo_attainment_floor:.2f}")
        # the edge's own state: a deep admission queue at full
        # concurrency IS saturation even when no engine signal reaches
        # this planner (the pure-frontend configuration)
        edge_q = signals.latest(SIG_ADMISSION_QUEUE_DEPTH)
        edge_busy = signals.mean(SIG_ADMISSION_INFLIGHT_RATIO, w)
        if (edge_q is not None and edge_busy is not None
                and edge_busy >= 1.0
                and edge_q >= cfg.saturation_admission_queue):
            return (f"admission queue {edge_q:.0f} deep at full "
                    f"concurrency")
        return None

    def _decide_admission(self, signals: SignalStore) -> Optional[AdmissionAction]:
        cfg = self.config
        now = self.clock()
        reason = self._saturated(signals)
        if reason:
            self._clear_since = None
            if self.shed_level >= cfg.max_shed_level:
                return None
            if (self._last_shed_change_t is not None
                    and now - self._last_shed_change_t
                    < cfg.shed_step_cooldown_s):
                return None
            self.shed_level += 1
            self._last_shed_change_t = now
            return AdmissionAction(
                shed_level=self.shed_level, limit=cfg.admitted_limit,
                reason=f"saturated: {reason}",
            )
        # healthy — relax one level after a sustained clear period
        if self.shed_level == 0:
            self._clear_since = None
            return None
        if self._clear_since is None:
            self._clear_since = now
            return None
        if now - self._clear_since < cfg.relax_after_clear_s:
            return None
        self.shed_level -= 1
        self._clear_since = now
        self._last_shed_change_t = now
        return AdmissionAction(
            shed_level=self.shed_level, limit=cfg.admitted_limit,
            reason="load cleared",
        )
