"""Simulated decode workers for the fleet simulator (the port's copy of
``dynamo_tpu/sim/worker.py``).

A :class:`SimWorker` is the only simulated component in the harness —
everything above it (admission, planner, pools, recovery, KV routing)
is the real control plane. Its service times come from the device-time
byte model: each decode burst costs
``DeviceTimeTracker.decode_read_bytes / peak_bytes_per_s`` virtual
seconds, a long prompt costs the sequence-parallel ladder's
``sp_prefill_read_bytes``, and every burst is fed back through the real
tracker's ``observe()`` so the sim's roofline numbers are computed by
the same code as a live engine's. The byte model is a floor: it charges
the bytes a step must move at the card's peak rate and nothing of the
host's dispatch, so a measured decode step on the card can take many
times its charge. ``hbm_gbps`` is the knob that says which rate to
charge at; leave it at None for the tracker's (``DYN_HBM_GBPS``, or an
H100 SXM's 3,350 GB/s).

Chaos uses the DYN_FAULT vocabulary: a worker armed with a fault site
consults ``faults.fire(site)`` at its burst seam (the real scheduler's
``decode_burst_hang`` placement) and wedges — no more progress, no more
heartbeats — until the real RecoveryController seizes it.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import math
from typing import Deque, List, Optional

from ..kv_router.protocols import ForwardPassMetrics
from ..telemetry.device_time import DeviceTimeTracker
from ..utils import faults
from .workload import Request

# (model, prefix_group, n_blocks) → block-hash list; the strings are
# pure functions of the key, so sharing across workers/runs is safe
_HASH_CACHE: dict = {}

POD_REFUSED = (
    "pods (WorkerSpec.pod_size > 0, the rag_pod scenario) model peer pulls "
    "over a plane between cards, which the port does not have until it "
    "runs on several cards (ROADMAP queue 1, several cards); the port's "
    "simulator pulls over tcp between hosts only")


@dataclasses.dataclass
class WorkerSpec:
    """Fleet-shape knobs: one worker's capacity + the byte model."""

    slots: int = 8
    kv_blocks: int = 2048
    block_size: int = 16
    # llama-8B-bf16-ish defaults; scenarios override for other shapes
    param_bytes: float = 16e9
    kv_bytes_per_token: float = 131072.0
    hbm_gbps: Optional[float] = None      # None → DYN_HBM_GBPS / the card's
    burst_steps: int = 64                 # decode tokens per dispatch burst
    # sequence-parallel prefill: prompts past the threshold run the
    # chunked ladder and are costed by sp_prefill_read_bytes
    sp_chunk_tokens: int = 8192
    sp_threshold_tokens: int = 16384
    # KV fabric modeling: pulling a peer's committed prefix vs cold-tier
    # rehydration, in GB/s of transfer bandwidth. peer_pull_gbps is the
    # tcp rate over the network between hosts, the one backend the port's
    # transfer plane serves. pod_size > 0 (workers grouped into a domain
    # whose pulls ride a plane between cards) is refused: POD_REFUSED.
    peer_pull_gbps: float = 40.0
    pod_size: int = 0
    cold_pull_gbps: float = 10.0
    provision_delay_s: float = 20.0       # scale-up / respawn lead time

    def __post_init__(self) -> None:
        if self.pod_size > 0:
            raise NotImplementedError(POD_REFUSED)


class _Ctx:
    """Just enough request context for the recovery ladder's _fail path."""

    __slots__ = ("trace_id", "is_stopped", "stages")

    def __init__(self, trace_id: str) -> None:
        self.trace_id = trace_id
        self.is_stopped = False
        self.stages: List[str] = []

    def add_stage(self, name: str) -> None:
        self.stages.append(name)


class _FailureSink:
    """Stands in for an engine request's out_queue: the recovery
    controller's ``_fail`` pushes a terminal ERROR frame here, which the
    fleet observes as "resubmit me"."""

    __slots__ = ("sim_request",)

    def __init__(self, sim_request: "SimRequest") -> None:
        self.sim_request = sim_request

    def put_nowait(self, item) -> None:
        if item is None:
            return
        self.sim_request.fail("drained")


class SimRequest:
    """Runtime state for one offered request's attempt on a worker.

    Shaped so RecoveryController.extract_requests can treat it as an
    engine request: ``request_id`` / ``ctx`` / ``block_ids`` /
    ``finish`` / ``out_queue`` are the fields the real ladder touches.
    """

    def __init__(self, req: Request, arrival_t: float) -> None:
        self.req = req
        self.request_id = req.request_id
        self.arrival_t = arrival_t
        self.ctx = _Ctx(trace_id=req.request_id)
        self.block_ids: List[int] = []
        self.finish = None
        self.out_queue = _FailureSink(self)
        # set by complete() or fail(); the fleet awaits finished()
        self.is_done = False
        self._done: Optional[asyncio.Future] = None
        self.outcome: Optional[str] = None   # completed | drained
        self.ttft_s: Optional[float] = None
        self.itl_max_s: Optional[float] = None
        self.decoded = 0
        self.last_token_t: Optional[float] = None
        # routing telemetry carried over from the SchedulingDecision
        self.prefix_hit_tokens = 0
        self.pulled_blocks = 0
        self.cold_blocks = 0
        # the transfer seconds the plan charged the peer pull (tcp)
        self.pull_transfer_s = 0.0
        self.enqueue_t: Optional[float] = None

    def fail(self, reason: str) -> None:
        if self.outcome is None:
            self.outcome = reason
        self._set_done()

    def complete(self) -> None:
        if self.outcome is None:
            self.outcome = "completed"
        self._set_done()

    def _set_done(self) -> None:
        self.is_done = True
        if self._done is not None and not self._done.done():
            self._done.set_result(None)

    def finished(self) -> asyncio.Future:
        """A future resolved once the attempt completes or fails (an
        ``asyncio.Event`` for one waiter, without its coroutine)."""
        if self._done is None:
            self._done = asyncio.get_running_loop().create_future()
            if self.is_done:
                self._done.set_result(None)
        return self._done


class SimWorker:
    """One simulated engine: slot + paged-KV bookkeeping, an LRU prefix
    cache spilling to the fleet's shared cold tier, and a decode-burst
    loop timed by the byte model."""

    def __init__(
        self,
        worker_id: str,
        model: str,
        spec: WorkerSpec,
        clock,
        cold_store: Optional[set] = None,
    ) -> None:
        self.worker_id = worker_id
        self.model = model
        self.spec = spec
        self.clock = clock
        self.cold_store = cold_store if cold_store is not None else set()
        self.tracker = DeviceTimeTracker(
            param_bytes=spec.param_bytes,
            kv_bytes_per_token=spec.kv_bytes_per_token,
            hbm_gbps=spec.hbm_gbps,
            clock=clock,
        )
        self.active: List[SimRequest] = []
        self.prefilling: List[SimRequest] = []
        self.pending: Deque[SimRequest] = collections.deque()
        self.used_blocks = 0
        # prefix cache: (model, group) → hot block count, LRU order;
        # evictions spill to the shared cold tier (the kv/cold_tier.py
        # content-addressed store, modeled as a block-hash set)
        self.cached: "collections.OrderedDict[tuple, int]" = (
            collections.OrderedDict()
        )
        self.cached_blocks_total = 0
        self.draining = False
        self.wedged = False
        self.halted = False
        self.tripped = False
        self.fault_site: Optional[str] = None
        self.last_progress_t = clock()
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.queue_wait_samples: Deque[float] = collections.deque(maxlen=64)
        self._work = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._aux_tasks: set = set()

    # ------------------------------------------------------------------
    # fleet-facing API
    # ------------------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._run(), name=f"sim-worker-{self.worker_id}")

    def enqueue(self, sr: SimRequest, decision=None) -> None:
        sr.enqueue_t = self.clock()
        if decision is not None:
            sr.prefix_hit_tokens = decision.prefix_hit_tokens
            sr.cold_blocks = decision.cold_blocks
            if (decision.best_prefix_worker
                    and decision.best_prefix_worker != self.worker_id):
                sr.pulled_blocks = max(
                    0, decision.best_prefix_blocks - decision.matched_blocks)
        self.pending.append(sr)
        self._work.set()

    def metrics(self) -> ForwardPassMetrics:
        total = self.spec.kv_blocks or 1
        return ForwardPassMetrics(
            request_active_slots=len(self.active) + len(self.prefilling),
            request_total_slots=self.spec.slots,
            kv_active_blocks=self.used_blocks,
            kv_total_blocks=self.spec.kv_blocks,
            num_requests_waiting=len(self.pending),
            gpu_cache_usage_perc=min(1.0, self.used_blocks / total),
            gpu_prefix_cache_hit_rate=0.0,
            draining=self.draining,
        )

    def mean_queue_wait_s(self) -> float:
        if not self.queue_wait_samples:
            return 0.0
        return sum(self.queue_wait_samples) / len(self.queue_wait_samples)

    async def halt(self) -> None:
        """Stop the loop for good (seize / scale-down teardown)."""
        self.halted = True
        tasks = [t for t in [self._task, *self._aux_tasks] if t is not None]
        self._task = None
        self._aux_tasks.clear()
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    # ------------------------------------------------------------------
    # the engine loop
    # ------------------------------------------------------------------

    def _blocks_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.spec.block_size))

    def prefix_hashes(self, req: Request) -> List[str]:
        if not req.prefix_group or req.prefix_tokens <= 0:
            return []
        n = req.prefix_tokens // self.spec.block_size
        key = (req.model, req.prefix_group, n)
        cached = _HASH_CACHE.get(key)
        if cached is None:
            cached = [f"{req.model}/{req.prefix_group}:{i}"
                      for i in range(n)]
            _HASH_CACHE[key] = cached
        return cached

    def _cache_prefix(self, req: Request) -> None:
        if not req.prefix_group or req.prefix_tokens <= 0:
            return
        n = req.prefix_tokens // self.spec.block_size
        key = (req.model, req.prefix_group)
        prev = self.cached.get(key, 0)
        self.cached[key] = max(prev, n)
        self.cached.move_to_end(key)
        self.cached_blocks_total += max(0, n - prev)
        # the cache lives in the block budget left over after pinned
        # request KV; evictions spill to the shared cold tier whole
        # prefix families at a time (they were committed together)
        budget = max(0, self.spec.kv_blocks - self.used_blocks)
        while self.cached_blocks_total > budget and self.cached:
            (model, group), blocks = self.cached.popitem(last=False)
            self.cached_blocks_total -= blocks
            for i in range(blocks):
                self.cold_store.add(f"{model}/{group}:{i}")

    def cached_run(self, hashes: List[str]) -> int:
        """Consecutive leading blocks of ``hashes`` held hot — the
        overlap-score contract the KvScheduler ranks on."""
        if not hashes:
            return 0
        # hashes are "<model>/<group>:<i>" for one family; group-level
        # bookkeeping answers the run length in O(1)
        key_s, _, _ = hashes[0].rpartition(":")
        model, _, group = key_s.partition("/")
        return min(self.cached.get((model, group), 0), len(hashes))

    async def _run(self) -> None:
        spec = self.spec
        while not self.halted:
            if self.wedged:
                # a wedged engine makes no progress and sends no
                # heartbeats; the watchdog trip → recovery seize is the
                # only way out
                self._work.clear()
                await self._work.wait()
                continue
            self._admit()
            if not self.active and not self.prefilling:
                # the loop is alive — only a wedge freezes this stamp,
                # so the fleet watchdog trips wedges, not idle waits
                self.last_progress_t = self.clock()
                if self.pending:
                    # slot- or KV-starved: re-check after a beat
                    await asyncio.sleep(0.2)
                    continue
                self.tracker.idle()
                self._work.clear()
                await self._work.wait()
                continue
            if self.fault_site and faults.fire(self.fault_site):
                self.wedged = True
                continue
            if self.prefilling:
                # prefill-prioritized interleave: the card runs the
                # queued prefill programs back-to-back before the next
                # burst, so one combined sleep with per-program
                # timestamps is timing-identical to sleeping per
                # program — then the loop re-checks the batch
                await self._prefill_batch(list(self.prefilling))
                continue
            # ---- one decode burst over the whole batch ----
            k = spec.burst_steps
            ctx_sum = sum(sr.req.isl + sr.decoded for sr in self.active)
            read_bytes = self.tracker.decode_read_bytes(k, ctx_sum)
            busy = read_bytes / self.tracker.peak_bytes_per_s
            t0 = self.clock()
            await asyncio.sleep(busy)
            now = self.clock()
            self.tracker.observe(
                "decode_burst", "decode", t0, now,
                read_bytes=read_bytes, tokens=k * len(self.active))
            self.last_progress_t = now
            per_step = busy / k
            finished: List[SimRequest] = []
            for sr in self.active:
                steps = min(k, sr.req.osl - sr.decoded)
                sr.decoded += steps
                self.decode_tokens += steps
                if sr.last_token_t is not None and steps > 0:
                    # tokens emit at per-step cadence inside the burst;
                    # the first one also carries any inter-burst wait
                    # (prefill interleave, queueing) since the row's
                    # previous token
                    gap = max(t0 + per_step - sr.last_token_t, per_step)
                    if sr.itl_max_s is None or gap > sr.itl_max_s:
                        sr.itl_max_s = gap
                if steps > 0:
                    sr.last_token_t = t0 + steps * per_step
                if sr.decoded >= sr.req.osl:
                    finished.append(sr)
            for sr in finished:
                self.active.remove(sr)
                self.used_blocks = max(
                    0, self.used_blocks - len(sr.block_ids))
                sr.block_ids = []
                sr.complete()

    def _admit(self) -> None:
        """Move pending requests into the prefill stage while slot and
        KV budgets allow."""
        while (self.pending and not self.draining
               and len(self.active) + len(self.prefilling)
               < self.spec.slots):
            sr = self.pending[0]
            need = self._blocks_for(sr.req.isl + sr.req.osl)
            if self.used_blocks + need > self.spec.kv_blocks:
                break  # KV-starved; wait for a completion
            self.pending.popleft()
            sr.block_ids = list(range(need))
            self.used_blocks += need
            if sr.enqueue_t is not None:
                self.queue_wait_samples.append(self.clock() - sr.enqueue_t)
            self.prefilling.append(sr)

    def _prefill_plan(self, sr: SimRequest) -> tuple:
        """Cost one request's prefill: (transfer_s, busy_s, read_bytes,
        program, new_tokens) under the byte model."""
        spec = self.spec
        req = sr.req
        transfer_s = 0.0
        block_bytes = spec.block_size * spec.kv_bytes_per_token
        if sr.pulled_blocks:
            sr.pull_transfer_s = (sr.pulled_blocks * block_bytes
                                  / (spec.peer_pull_gbps * 1e9))
            transfer_s += sr.pull_transfer_s
        if sr.cold_blocks:
            transfer_s += (sr.cold_blocks * block_bytes
                           / (spec.cold_pull_gbps * 1e9))
        reused = (sr.prefix_hit_tokens
                  + (sr.pulled_blocks + sr.cold_blocks) * spec.block_size)
        new_tokens = max(spec.block_size, req.isl - reused)
        if new_tokens > spec.sp_threshold_tokens:
            chunks = math.ceil(new_tokens / spec.sp_chunk_tokens)
            read_bytes = self.tracker.sp_prefill_read_bytes(
                chunks, new_tokens)
            program = "prefill_sp"
        else:
            read_bytes = (spec.param_bytes
                          + new_tokens * spec.kv_bytes_per_token)
            program = "prefill"
        busy = read_bytes / self.tracker.peak_bytes_per_s
        return transfer_s, busy, read_bytes, program, new_tokens

    async def _prefill_batch(self, batch: List[SimRequest]) -> None:
        t0 = self.clock()
        plans = [(sr, *self._prefill_plan(sr)) for sr in batch]
        total = sum(transfer_s + busy
                    for _, transfer_s, busy, _, _, _ in plans)
        # virtual sleeps wake exactly at their deadline, so the
        # arithmetic per-program spans below land on the same instants
        # the per-program sleeps would have
        await asyncio.sleep(total)
        if self.halted:
            return  # seized while prefilling
        t = t0
        for sr, transfer_s, busy, read_bytes, program, new_tokens in plans:
            start = t
            t += transfer_s + busy
            if sr.outcome is not None:
                continue  # drained while prefilling
            if sr in self.prefilling:
                self.prefilling.remove(sr)
            else:
                continue  # extracted out from under the program
            self.tracker.observe(program, "prefill", start + transfer_s,
                                 t, read_bytes=read_bytes,
                                 tokens=new_tokens)
            self.prefill_tokens += new_tokens
            sr.ttft_s = t - sr.arrival_t
            sr.last_token_t = t
            sr.decoded = 1  # the prefill emits the first token
            self.decode_tokens += 1
            self._cache_prefix(sr.req)
            self.active.append(sr)
        self.last_progress_t = self.clock()
        self._work.set()


# ---------------------------------------------------------------------------
# recovery-ladder adapters
# ---------------------------------------------------------------------------


class _Allocator:
    __slots__ = ("worker",)

    def __init__(self, worker: SimWorker) -> None:
        self.worker = worker

    def free_blocks(self, block_ids: List[int]) -> None:
        self.worker.used_blocks = max(
            0, self.worker.used_blocks - len(block_ids))


class _SchedCfg:
    __slots__ = ("kv_block_size",)

    def __init__(self, kv_block_size: int) -> None:
        self.kv_block_size = kv_block_size


class WorkerSchedAdapter:
    """Presents one SimWorker as the scheduler surface the real
    RecoveryController drains: set_draining / slots / seize /
    extract_requests / allocator / config."""

    def __init__(self, worker: SimWorker) -> None:
        self.worker = worker
        self.allocator = _Allocator(worker)
        self.config = _SchedCfg(worker.spec.block_size)

    def set_draining(self, draining: bool = True) -> None:
        self.worker.draining = draining

    @property
    def slots(self) -> List[Optional[SimRequest]]:
        live = (list(self.worker.active) + list(self.worker.prefilling))
        return live or [None]

    async def seize(self, hard: bool = False,
                    timeout_s: float = 5.0) -> None:
        await self.worker.halt()

    def extract_requests(self) -> List[SimRequest]:
        w = self.worker
        out = list(w.active) + list(w.prefilling) + list(w.pending)
        w.active.clear()
        w.prefilling.clear()
        w.pending.clear()
        return out
