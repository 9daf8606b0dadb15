"""KV-aware worker selection.

Cost function and predicted-state updates mirror the reference's default
selector (reference: lib/llm/src/kv_router/scheduler.rs:238-340):

    logit = 2 * overlap_ratio - gpu_cache_usage - normalized_active_slots

Highest logit wins; ties break randomly. After each decision the chosen
worker's predicted load is bumped (active slots +1, kv blocks += newly
needed) so a burst of requests doesn't pile onto one worker between
metrics refreshes.

The port's copy of ``dynamo_tpu/kv_router/scheduler.py``. Ties break with
an explicit ``random.Random`` (``rng``) instead of the module's global
choice: seeded, it makes the reference's choice under ``random.seed`` of
the same seed. The pull hint scans the overlap's workers in the overlap's
own order, where the reference scans a set of worker ids
(``dynamo_tpu/kv_router/scheduler.py:200``): a set of strings iterates in
an order that changes with the process's hash seed, so the reference
gives tied owners' hint to a different worker from one process to the
next, and the fleet simulator's reports with it.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import random
import time
from typing import Callable, Dict, List, Optional

from .indexer import OverlapScores
from .protocols import ForwardPassMetrics

logger = logging.getLogger(__name__)


class AllWorkersBusy(Exception):
    pass


@dataclasses.dataclass
class WorkerState:
    worker_id: str
    metrics: ForwardPassMetrics
    # predicted deltas since the last metrics refresh
    predicted_active: int = 0
    predicted_blocks: int = 0
    # monotonic time of the last metrics refresh; the cost function
    # skips workers whose snapshot exceeds the staleness bound
    updated_at: float = 0.0

    def cache_usage(self, block_size: int) -> float:
        total = self.metrics.kv_total_blocks or 1
        return min(
            1.0,
            (self.metrics.kv_active_blocks + self.predicted_blocks) / total,
        )

    def normalized_active(self) -> float:
        total = self.metrics.request_total_slots or 1
        return (self.metrics.request_active_slots + self.predicted_active) / total


class KvScheduler:
    def __init__(self, block_size: int = 16, require_free_slot: bool = False,
                 staleness_bound_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 cold_discount: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.block_size = block_size
        self.rng = rng or random.Random()
        self.require_free_slot = require_free_slot
        # cold-tier blocks (rehydratable spill files, kv/cold_tier.py)
        # count toward a worker's overlap at this fraction of a warm
        # block: a rehydrate pays disk + H2D instead of recompute, so it
        # is worth routing toward — but never as much as hot KV
        self.cold_discount = max(0.0, min(1.0, cold_discount))
        # snapshots older than this are not trusted by the cost function
        # (None/0 = off). A worker whose scrape stopped (wedged engine,
        # partitioned host) keeps its LAST load forever — typically a
        # low-looking one, so without the bound it becomes a black hole
        # every new request routes into.
        self.staleness_bound_s = staleness_bound_s or None
        self.clock = clock
        self.workers: Dict[str, WorkerState] = {}
        self.stale_skips = 0  # lifetime stale-worker exclusions
        self.draining_skips = 0  # lifetime draining-worker exclusions

    def update_metrics(self, worker_id: str, metrics: ForwardPassMetrics) -> None:
        now = self.clock()
        state = self.workers.get(worker_id)
        if state is None:
            self.workers[worker_id] = WorkerState(
                worker_id, metrics, updated_at=now)
        else:
            state.metrics = metrics
            state.predicted_active = 0
            state.predicted_blocks = 0
            state.updated_at = now

    def remove_worker(self, worker_id: str) -> None:
        self.workers.pop(worker_id, None)

    def schedule(
        self, isl_tokens: int, overlap: OverlapScores,
        pool: Optional[set] = None,
    ) -> "SchedulingDecision":
        """Pick a worker for a request with ``isl_tokens`` prompt tokens.

        ``pool`` restricts the decision to one model's workers (the
        per-model partition, registry/): ``model=`` selects the pool
        BEFORE prefix scoring, and overlap credit outside the pool is
        ignored — block hashes are token-based, so a same-prompt hit on
        a different model's worker is a different model's KV."""
        if not self.workers:
            raise AllWorkersBusy("no workers with metrics")
        total_blocks_needed = math.ceil(isl_tokens / self.block_size)

        # pool partition FIRST: workers outside the model's pool are a
        # structural exclusion, not a drain/staleness event — they must
        # not inflate those counters on every multi-pool decision
        in_pool = self.workers
        if pool is not None:
            in_pool = {wid: s for wid, s in self.workers.items()
                       if wid in pool}
            if not in_pool:
                raise AllWorkersBusy("no workers in the model's pool")
        # draining workers (recovery drain / rolling update) are out of
        # the pool outright — unlike staleness there is no fallback: a
        # drain is an explicit "send me nothing", and routing there
        # would hand the request straight to a migration
        candidates = {
            wid: s for wid, s in in_pool.items()
            if not getattr(s.metrics, "draining", False)
        }
        if len(candidates) < len(in_pool):
            self.draining_skips += len(in_pool) - len(candidates)
            logger.debug(
                "kv schedule: skipping %d draining worker(s): %s",
                len(in_pool) - len(candidates),
                sorted(set(in_pool) - set(candidates)),
            )
        if not candidates:
            raise AllWorkersBusy("all workers are draining")
        if self.staleness_bound_s:
            cutoff = self.clock() - self.staleness_bound_s
            fresh = {wid: s for wid, s in candidates.items()
                     if s.updated_at >= cutoff}
            if fresh and len(fresh) < len(candidates):
                self.stale_skips += len(candidates) - len(fresh)
                logger.debug(
                    "kv schedule: skipping %d stale worker(s): %s",
                    len(candidates) - len(fresh),
                    sorted(set(candidates) - set(fresh)),
                )
                candidates = fresh
            elif not fresh:
                # EVERY snapshot is stale (scrape loop hiccup) — routing
                # on old data beats refusing to route at all
                logger.warning(
                    "kv schedule: all %d worker snapshots exceed the "
                    "%.1fs staleness bound; routing on stale data",
                    len(self.workers), self.staleness_bound_s,
                )

        best: List[str] = []
        best_logit = -float("inf")
        for wid, state in candidates.items():
            if self.require_free_slot and (
                state.metrics.request_active_slots + state.predicted_active
                >= (state.metrics.request_total_slots or 1)
            ):
                continue
            matched = overlap.scores.get(wid, 0)
            cold = overlap.cold_scores.get(wid, 0)
            # cold blocks count discounted: rehydration beats recompute
            # but loses to hot KV at equal coverage
            effective = matched + self.cold_discount * cold
            overlap_ratio = (
                effective * self.block_size / isl_tokens
                if isl_tokens else 0.0
            )
            logit = (
                2.0 * overlap_ratio
                - state.cache_usage(self.block_size)
                - state.normalized_active()
            )
            if logit > best_logit + 1e-9:
                best, best_logit = [wid], logit
            elif abs(logit - best_logit) <= 1e-9:
                best.append(wid)
        if not best:
            raise AllWorkersBusy("all workers at slot capacity")
        chosen = self.rng.choice(best)
        matched = overlap.scores.get(chosen, 0)
        # predicted-state update (process_worker_selection analog): cold
        # blocks still allocate fresh HBM on rehydrate, so only the warm
        # match reduces the predicted block demand
        state = self.workers[chosen]
        state.predicted_active += 1
        state.predicted_blocks += max(0, total_blocks_needed - matched)
        logger.debug("kv schedule: %s logit=%.3f matched=%d", chosen, best_logit, matched)
        # the pull hint: the worker holding the LONGEST warm+cold prefix
        # overall, even when load steered the request elsewhere — the
        # chosen worker's fabric can pull the difference from it
        # (kv/fabric.py) instead of recomputing
        best_owner, best_owned, best_key = None, 0, (0.0, 0)
        for wid in dict.fromkeys([*overlap.scores, *overlap.cold_scores]):
            if pool is not None and wid not in pool:
                # another model's worker: its "overlap" is a token-hash
                # coincidence, not pullable KV for this model
                continue
            warm_b = overlap.scores.get(wid, 0)
            cold_b = overlap.cold_scores.get(wid, 0)
            # rank with the same discount the cost function uses (a
            # rehydrate is cheaper than recompute but dearer than hot
            # KV); warm coverage breaks effective-score ties
            key = (warm_b + self.cold_discount * cold_b, warm_b)
            if key > best_key:
                best_owner, best_owned = wid, warm_b + cold_b
                best_key = key
        return SchedulingDecision(
            worker_id=chosen,
            matched_blocks=matched,
            prefix_hit_tokens=matched * self.block_size,
            isl_tokens=isl_tokens,
            cold_blocks=overlap.cold_scores.get(chosen, 0),
            best_prefix_worker=best_owner,
            best_prefix_blocks=best_owned,
        )


@dataclasses.dataclass
class SchedulingDecision:
    worker_id: str
    matched_blocks: int
    prefix_hit_tokens: int
    isl_tokens: int
    # cold-tier blocks the chosen worker can rehydrate (discount-scored)
    cold_blocks: int = 0
    # the pull hint: the worker holding the longest warm+cold prefix of
    # this prompt, even if load routed the request elsewhere — the
    # chosen worker's KV fabric pulls the difference from it
    best_prefix_worker: Optional[str] = None
    best_prefix_blocks: int = 0

    @property
    def overlap_ratio(self) -> float:
        return self.prefix_hit_tokens / self.isl_tokens if self.isl_tokens else 0.0
