"""Continuous-batching scheduler: the synchronous path and the persistent
decode loop.

The port of ``dynamo_tpu/engine/scheduler.py``: an asyncio loop
interleaving batched, chunked, bucketed prefills with batched decode over
a fixed set of slots. A decode pass is one token per step, a fused K-step
burst (``multi_step_decode``) while no prefill work waits, an ngram
speculative verify step (``spec_ngram_tokens``) while every active row is
greedy and penalty-free, or, with ``decode_pipeline_depth=2``:

- a dispatch-ahead burst (``_decode_pipelined``): burst k+1 goes to the
  device before burst k's tokens are read on the host, finishes are
  detected one burst late and the over-decoded tail is rolled back;
- a chained burst (``_decode_chained``, ``device_finish``): bursts are
  dispatched back to back off a device-resident carry, finished rows
  freeze on the device (eos, hidden stop ids, ``max_tokens``, the
  model-len horizon, stop sequences by suffix hash, guided choices by a
  device transition table) and a queue of in-flight bursts drains
  asynchronously. Every pass that could not chain is counted under a
  named reason (``metrics()["sync_fallback"]``).

A burst's outputs travel to the host through pinned buffers and an event
recorded right behind the burst (``ModelRunner.stage_to_host``), so
reconciling burst k never waits for burst k+1.

With ``sp_size > 1`` a prompt whose uncached suffix reaches
``long_prefill_threshold_tokens`` takes the sequence-parallel ladder
instead: one prompt at a time advances one SP chunk per pass, dispatch-only,
while the other streams keep decoding; its final chunk's sampled token
feeds a decode burst on the device (the early handoff) before the one host
sync that drains both.

Per-request state tracks paged blocks, chained block hashes (the prefix
cache), the guided-choice cursor and cooperative cancellation; KV OOM
preempts a request back to the waiting queue and its re-prefill continues
the emitted stream.

Not in this slice (later work, refused by ``EngineConfig`` or by the
serving layer): the chained propose-verify round, draft-model speculation,
guided JSON, remote prefill (so the SP ladder in a disagg prefill worker),
fabric pulls, migration, fault injection, the flight recorder and the stall
watchdog.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..protocols.common import (
    EngineOutput,
    FinishReason,
    PreprocessedRequest,
    TokenLogprob,
)
from ..runtime.engine import AsyncEngineContext
from ..tokens import TokenSequence
from .block_allocator import BlockAllocator
from .config import EngineConfig
from .guided import TrieConstraint, compile_device_table
from .model_runner import HostCopy, ModelRunner, build_prefill_arrays
from .sampling import (
    STOP_ID_WIDTH,
    STOP_SEQ_WIDTH,
    SUFFIX_RING_W,
    host_row,
    ring_init,
    seed_to_key,
    stop_id_row,
    stop_seq_rows,
)

logger = logging.getLogger(__name__)


def ngram_propose(history: List[int], match: int, k: int) -> List[int]:
    """Prompt-lookup proposal: find the most recent earlier occurrence of
    the trailing ``match``-gram in the sequence's own history and return
    up to ``k`` tokens that followed it."""
    n = len(history)
    if n < match + 1 or k <= 0:
        return []
    tail = np.asarray(history[-match:], np.int64)
    h = np.asarray(history, np.int64)
    # windows over h[:-1]: every start i has at least one continuation
    # token, and the trailing gram itself (start n-match) is excluded
    win = np.lib.stride_tricks.sliding_window_view(h[:-1], match)
    hits = np.nonzero((win == tail).all(axis=1))[0]
    if hits.size == 0:
        return []
    # latest match whose continuation is full-length; else the earliest
    # (longest) one — a repetitive tail would otherwise propose almost
    # nothing because the most recent occurrence abuts the history end
    full = hits[hits + match + k <= n]
    i = int(full[-1]) if full.size else int(hits[0])
    return [int(t) for t in history[i + match: i + match + k]]


def prefill_bucket_cap(cfg: EngineConfig, rows: int = 1) -> Optional[int]:
    """Largest prefill bucket such that ``rows * bucket`` fits the
    per-step token budget (the ITL bound counts padded positions). None
    when even the smallest bucket overruns; no budget = no cap."""
    budget = cfg.max_prefill_tokens_per_step
    if not budget:
        return cfg.prefill_buckets[-1]
    allowed = [b for b in cfg.prefill_buckets if rows * b <= budget]
    return allowed[-1] if allowed else None


@dataclasses.dataclass
class EngineRequest:
    request_id: str
    prompt: List[int]
    req: PreprocessedRequest
    ctx: AsyncEngineContext
    out_queue: asyncio.Queue
    # sampling scalars (one slot row each; see engine/sampling.py)
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    base_key: Optional[np.ndarray] = None  # uint32[2] per-request key
    want_logprobs: bool = False
    logprobs_n: int = 0  # alternatives per token (OpenAI top_logprobs)
    # OutputOptions.prompt_logprobs: logprob of every prompt token given its
    # prefix, collected per prefill chunk, sent once with the first output
    want_prompt_lps: bool = False
    prompt_lp_parts: List = dataclasses.field(default_factory=list)
    prompt_lps_emitted: bool = False
    # runtime state
    slot: int = -1
    block_ids: List[int] = dataclasses.field(default_factory=list)
    num_cached: int = 0
    context_len: int = 0          # tokens whose KV is (being) written
    pending_token: int = -1       # sampled but KV not yet written
    generated: int = 0
    seq: Optional[TokenSequence] = None
    registered_blocks: int = 0
    finish: Optional[FinishReason] = None
    # chunked-prefill progress (tokens of prefill_tokens with KV written)
    prefill_tokens: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0
    # preemption-resume: generated tokens already emitted before preemption;
    # re-prefilled (prompt + resume_tokens) so the stream CONTINUES
    resume_tokens: List[int] = dataclasses.field(default_factory=list)
    # guided decoding: the constraint cursor (a TrieConstraint built at
    # admission from guided_choice_token_ids) and the token ids its mask
    # currently allows (for sparse bias edits)
    guided: Optional[object] = None
    guided_allowed: List[int] = dataclasses.field(default_factory=list)
    # telemetry: monotonic time of the last token emission (0 = none yet)
    last_emit_t: float = 0.0
    # device-resident finish detection: the admission-time classification
    # (see classify_finish) plus the packed device stop-id row of the
    # chained burst. ``device_checkable`` means every finish condition is
    # expressible on the device: eos / hidden stop ids within
    # STOP_ID_WIDTH, and stop STRINGS only through their canonical token
    # sequences within the suffix-ring bounds. ``chain_fallback`` names WHY
    # a request is not checkable, so every sync pass is attributed. Guided
    # decoding is checked live at dispatch (its device table compiles in an
    # executor).
    device_checkable: bool = False
    chain_fallback: Optional[str] = None
    device_frozen: bool = False  # finish came from the device mask
    fin_eos: frozenset = dataclasses.field(default_factory=frozenset)
    fin_stop: frozenset = dataclasses.field(default_factory=frozenset)
    fin_min_new: int = 0
    fin_max_new: int = 16384
    fin_stop_row: Optional[np.ndarray] = None
    # canonical stop-string token sequences (host-exact check in
    # _check_finish on EVERY path) and their packed device hash rows
    fin_stop_seqs: tuple = ()
    fin_stop_hash: Optional[np.ndarray] = None
    fin_stop_hlen: Optional[np.ndarray] = None
    # trailing emitted tokens (prompt + generated, ending with the pending
    # token): the host mirror of the burst carry's suffix ring; feeds the
    # exact stop-sequence check and the chain-fill ring
    ring_tail: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=SUFFIX_RING_W)
    )
    # chain-transient flags: the guided bias row was reset to logit_bias
    # only for a device-table chain (reinstalled at the barrier), and the
    # row froze on a suffix-hash FALSE positive (resumes at the barrier)
    chain_bias_reset: bool = False
    chain_fp: bool = False
    # memoized guided-table cache key
    guided_key: Optional[tuple] = None

    def __post_init__(self):
        self.classify_finish()

    def classify_finish(self) -> None:
        """Precompute the finish-check state once per request."""
        sc = self.req.stop_conditions
        self.fin_min_new = self.min_new
        self.fin_max_new = self.max_new
        self.fin_eos = (
            frozenset() if sc.ignore_eos
            else frozenset(int(t) for t in (self.req.eos_token_ids or []))
        )
        self.fin_stop = frozenset(
            int(t) for t in (sc.stop_token_ids_hidden or [])
        )
        row = stop_id_row(
            self.req.eos_token_ids, sc.stop_token_ids_hidden, sc.ignore_eos
        )
        n = self.req.sampling_options.n
        self.fin_stop_row = row
        self.fin_stop_seqs = ()
        self.fin_stop_hash = None
        self.fin_stop_hlen = None
        reason = None
        if row is None:
            reason = "stop_ids_overflow"
        elif n is not None and n > 1:
            reason = "n_gt_1"
        if sc.stop:
            seqs = [tuple(int(t) for t in s)
                    for s in (sc.stop_token_seqs or []) if s]
            if seqs and len(seqs) == len(sc.stop):
                # the host-exact stop-sequence finish applies on EVERY path
                # (sync and chained streams stay identical); the packed
                # hash rows are the device approximation's inputs
                self.fin_stop_seqs = tuple(seqs)
                packed = stop_seq_rows(seqs)
                if packed is not None:
                    self.fin_stop_hash, self.fin_stop_hlen = packed
                elif reason is None:
                    reason = "stop_seqs_overflow"
            elif reason is None:
                # no canonical tokenizations shipped: text-level stops stay
                # the detokenizer's concern
                reason = "stop_seqs_unavailable"
        self.chain_fallback = reason
        self.device_checkable = reason is None

    @property
    def max_new(self) -> int:
        # `is None`, not falsy: an explicit 0 means an empty completion
        mt = self.req.stop_conditions.max_tokens
        return 16384 if mt is None else mt

    @property
    def min_new(self) -> int:
        return self.req.stop_conditions.min_tokens or 0


class _HostBatchState:
    """Persistent ``(B, ·)`` host-side decode arrays, mutated only when a
    slot's occupant changes (``install``) or a live row grows blocks
    (``sync_blocks``). Rows of departed requests keep stale values: they
    ride with ``commit=False``, so nothing reads their outputs."""

    def __init__(self, cfg: EngineConfig):
        b = cfg.max_batch_size
        self.temp = np.zeros(b, np.float32)
        self.top_k = np.zeros(b, np.int32)
        self.top_p = np.ones(b, np.float32)
        self.min_p = np.zeros(b, np.float32)
        self.pres = np.zeros(b, np.float32)
        self.freq = np.zeros(b, np.float32)
        self.rep = np.ones(b, np.float32)
        self.keys = np.zeros((b, 2), np.uint32)
        self.btab = np.zeros((b, cfg.blocks_per_seq), np.int32)
        # blocks of each row already mirrored into ``btab``
        self.synced_blocks = np.zeros(b, np.int32)
        # device-finish state (membership-static, read by the chained
        # burst): packed stop-token ids, the min/max token bounds and the
        # stop-sequence suffix-hash targets
        self.stop_ids = np.full((b, STOP_ID_WIDTH), -1, np.int32)
        self.min_new = np.zeros(b, np.int32)
        self.max_new = np.full(b, np.iinfo(np.int32).max, np.int32)
        self.stop_hash = np.zeros((b, STOP_SEQ_WIDTH), np.uint32)
        self.stop_hlen = np.zeros((b, STOP_SEQ_WIDTH), np.int32)

    def install(self, er: "EngineRequest") -> None:
        """(Re)write one slot's rows at admission / membership change."""
        i = er.slot
        (self.temp[i], self.top_k[i], self.top_p[i], self.min_p[i],
         self.pres[i], self.freq[i], self.rep[i]) = (
            er.temperature, er.top_k, er.top_p, er.min_p,
            er.presence_penalty, er.frequency_penalty,
            er.repetition_penalty,
        )
        self.keys[i] = er.base_key
        self.min_new[i] = er.fin_min_new
        self.max_new[i] = min(er.fin_max_new, np.iinfo(np.int32).max)
        self.stop_ids[i] = (
            er.fin_stop_row if er.fin_stop_row is not None else -1)
        self.stop_hash[i] = (
            er.fin_stop_hash if er.fin_stop_hash is not None else 0)
        self.stop_hlen[i] = (
            er.fin_stop_hlen if er.fin_stop_hlen is not None else 0)
        n = len(er.block_ids)
        self.btab[i, :n] = er.block_ids
        self.btab[i, n:] = 0
        self.synced_blocks[i] = n

    def sync_blocks(self, er: "EngineRequest") -> None:
        """Mirror a live row's grown (or rolled-back) block list."""
        i = er.slot
        n = len(er.block_ids)
        s = int(self.synced_blocks[i])
        if n == s:
            return
        if n < s:
            self.btab[i, n:s] = 0
        else:
            self.btab[i, s:n] = er.block_ids[s:]
        self.synced_blocks[i] = n


@dataclasses.dataclass
class _InflightBurst:
    """One dispatched-but-unreconciled decode burst.

    Everything the host needs to reconcile the burst AFTER the next one is
    dispatched: its outputs on their way to the host (``out``, read in one
    executor hop, the loop's only host sync) and, for the dispatch-ahead
    pipeline, the device-resident carry (``last_tokens``) the next burst
    consumes without a host round trip."""

    active: List["EngineRequest"]  # rows committed at dispatch
    out: HostCopy                  # [K, B] tokens, logprobs, top vals / ids
    k_steps: int
    last_tokens: object            # device [B]: the next burst's tokens0
    # chained (device-finish) bursts: _apply_burst takes frozen-row
    # semantics (-1 pads skipped, device finishes counted)
    device_finish: bool = False


class Scheduler:
    # bursts allowed in flight ahead of the asynchronous drain: beyond this
    # the dispatcher waits out the oldest sync (the device has this many
    # bursts queued, so it cannot run dry while the host catches up), and
    # the per-burst output buffers stay bounded
    CHAIN_MAX_INFLIGHT = 4
    # compiled guided tables kept for at most this many distinct choice
    # lists: each is a dense [states, vocab] int32. LRU; eviction is safe
    # mid-chain because every chained pass re-checks presence before the
    # dispatch reads the cache (a missing table just recompiles)
    GUIDED_TABLE_CACHE = 16

    def __init__(self, runner: ModelRunner, config: EngineConfig):
        self.runner = runner
        self.config = config
        self.allocator = BlockAllocator(
            config.num_kv_blocks, config.kv_block_size,
            config.enable_prefix_caching,
        )
        self.waiting: deque = deque()
        self._host = _HostBatchState(config)
        self.slots: List[Optional[EngineRequest]] = [None] * config.max_batch_size
        # the prefill BATCH: up to max_prefill_batch requests whose chunked
        # prefills run as rows of one step
        self.prefilling: List[EngineRequest] = []
        # sequence-parallel long-context prefill (config.sp_size > 1):
        # admissions past long_prefill_threshold_tokens queue here and
        # advance one SP chunk per loop pass; one prompt (``sp_active``)
        # owns the ranks at a time (the chunk is batch-of-1 by
        # construction). The reference's ladder record (``_SpPrefill``) adds
        # only timings for its telemetry, which is not ported
        self.sp_queue: List[EngineRequest] = []
        self.sp_active: Optional[EngineRequest] = None
        self.wake = asyncio.Event()
        self._rng = np.random.default_rng(config.seed)
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        # telemetry (ForwardPassMetrics analog)
        self.prefix_hit_tokens = 0
        self.prefix_total_tokens = 0
        self.steps = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self.preemptions = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.sp_chunks = 0
        self.sp_tokens = 0
        self.sp_handoffs = 0
        # dispatch-ahead decode: the one burst in flight
        self._inflight: Optional[_InflightBurst] = None
        self.pipeline_bursts = 0
        # the chained loop: bursts awaiting their drain (FIFO), the chain's
        # members (fixed between barriers), its device carry, how many
        # bursts it has dispatched, and each member's position and
        # generated count when it opened (block headroom and the noise
        # counters follow the chain's own dispatch count: the host's
        # committed state lags by the whole drain queue)
        self._chain: deque = deque()
        self._chain_members: List[EngineRequest] = []
        self._chain_carry = None
        self._chain_dispatched = 0
        self._chain_pos0: Dict[int, int] = {}
        self._chain_gen0: Dict[int, int] = {}
        self._chain_fp = False
        self._last_chain_len = 0
        self.chain_len_max = 0
        self.device_finished_rows = 0
        self.sync_fallback: Dict[str, int] = {}
        # compiled guided device tables by choice list (None = past the
        # state bound) and the executor compiles in flight
        self._guided_tables: Dict[tuple, object] = {}
        self._guided_table_futs: Dict[tuple, object] = {}

    # ---------- public API ----------

    def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        self._stopping = True
        self.wake.set()
        if self._task:
            await self._task

    def add_request(self, er: EngineRequest) -> None:
        so = er.req.sampling_options
        (er.temperature, er.top_k, er.top_p, er.min_p, er.presence_penalty,
         er.frequency_penalty, er.repetition_penalty) = host_row(so)
        # logprobs is a COUNT: 0 = chosen token's logprob with no
        # alternatives (None = off)
        er.want_logprobs = er.req.output_options.logprobs is not None
        er.logprobs_n = int(er.req.output_options.logprobs or 0)
        er.want_prompt_lps = er.req.output_options.prompt_logprobs is not None
        if so.seed is not None:
            # per-request key: seeded sampling is reproducible AND isolated
            # from batchmates (each row draws from its own generator)
            er.base_key = seed_to_key(int(so.seed))
        else:
            er.base_key = self._rng.integers(0, 2**32, size=2, dtype=np.uint32)
        er.ctx.add_stage("queued")
        self.waiting.append(er)
        self.wake.set()

    def metrics(self) -> dict:
        active = sum(1 for s in self.slots if s is not None)
        return {
            "request_active_slots": active,
            "request_total_slots": self.config.max_batch_size,
            "kv_active_blocks": self.allocator.used,
            "kv_total_blocks": self.allocator.num_blocks,
            "num_requests_waiting": len(self.waiting),
            "gpu_cache_usage_perc": self.allocator.usage(),
            "gpu_prefix_cache_hit_rate": (
                self.prefix_hit_tokens / self.prefix_total_tokens
                if self.prefix_total_tokens else 0.0
            ),
            "steps": self.steps,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "preemptions": self.preemptions,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "sp_chunks": self.sp_chunks,
            "sp_tokens": self.sp_tokens,
            "sp_handoffs": self.sp_handoffs,
            "pipeline_bursts": self.pipeline_bursts,
            "chain_len_last": self._chain_dispatched or self._last_chain_len,
            "chain_len_max": max(self.chain_len_max, self._chain_dispatched),
            "device_finished_rows": self.device_finished_rows,
            "sync_fallback": dict(self.sync_fallback),
        }

    # ---------- helpers ----------

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _emit(self, er: EngineRequest, token: int, logprob: Optional[float],
              top: Optional[dict] = None,
              prompt_lps: Optional[list] = None) -> None:
        if not er.last_emit_t:
            er.ctx.add_stage("first_token")
        er.last_emit_t = time.monotonic()
        er.out_queue.put_nowait(EngineOutput(
            token_ids=[token],
            finish_reason=er.finish,
            logprobs=(
                [TokenLogprob(token, logprob, top)]
                if logprob is not None else None
            ),
            prompt_logprobs=prompt_lps,
        ))

    def _top_row(self, er: EngineRequest, top_vals, top_ids, row: int):
        """The request's top-N alternatives dict from a step's [B, K]
        top-logprob arrays (None unless the request asked for them)."""
        if not er.want_logprobs or er.logprobs_n <= 0:
            return None
        n = min(er.logprobs_n, top_vals.shape[1])
        return {
            int(t): float(v)
            for t, v in zip(top_ids[row, :n], top_vals[row, :n])
        }

    def _finish(self, er: EngineRequest, reason: FinishReason,
                emit: bool = True) -> None:
        er.finish = reason
        er.ctx.add_stage("completion")
        if emit:
            er.out_queue.put_nowait(EngineOutput(token_ids=[], finish_reason=reason))
        er.out_queue.put_nowait(None)  # stream end sentinel
        if er.slot >= 0:
            self.slots[er.slot] = None
        self.allocator.free_blocks(er.block_ids)
        er.block_ids = []

    def _advance_row(self, er: EngineRequest, token: int) -> None:
        """Commit ONE sampled token to host state: the previous pending
        token's KV is now written (push + register), the new token becomes
        pending, and finish checks run."""
        er.seq.push(er.pending_token)
        er.context_len += 1
        self._register_completed_blocks(er)
        er.pending_token = token
        er.generated += 1
        er.ring_tail.append(token)
        er.finish = self._check_finish(er, token)

    def _ensure_block_for(self, er: EngineRequest, position: int) -> bool:
        """Make sure a block exists covering ``position``."""
        needed = position // self.config.kv_block_size + 1
        while len(er.block_ids) < needed:
            try:
                er.block_ids.append(self.allocator.allocate_block())
            except MemoryError:
                return False
        return True

    def _register_completed_blocks(self, er: EngineRequest) -> None:
        """Hash-register blocks whose KV is complete (matchable + KV
        events). ``er.seq`` mirrors exactly the tokens whose KV sits in the
        cache, so its frozen blocks line up 1:1 with ``er.block_ids``."""
        n_complete = min(er.context_len // self.config.kv_block_size,
                         len(er.seq.blocks))
        for i in range(er.registered_blocks, n_complete):
            blk = er.seq.blocks[i]
            self.allocator.register_complete(er.block_ids[i], blk.sequence_hash)
        er.registered_blocks = max(er.registered_blocks, n_complete)

    # ---------- the loop ----------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopping:
            progressed = False

            # drop cancelled requests (client disconnects / kills)
            for er in list(self.waiting):
                if er.ctx.is_stopped:
                    self.waiting.remove(er)
                    self._finish(er, FinishReason.CANCELLED)
            for er in [s for s in self.slots if s is not None]:
                if er.ctx.is_stopped:
                    if er in self.prefilling:
                        self.prefilling.remove(er)
                    self._sp_drop(er)
                    self._finish(er, FinishReason.CANCELLED)

            # local admission: claim a slot + blocks, join the prefill batch.
            # Both ladders honour the prefill-batch cap: SP admissions hold
            # their WHOLE prompt's blocks while the single-owner ladder serves
            # one prompt at a time, so an unbounded sp_queue would pin the
            # block pool idle; oversize backlogs wait block-free in `waiting`
            cap = self.config.max_prefill_batch
            while (self.waiting
                   and len(self.prefilling) < cap
                   and (len(self.sp_queue)
                        + (1 if self.sp_active is not None else 0) < cap)
                   and self._free_slot() is not None):
                er = self.waiting[0]
                try:
                    self._start_prefill(er)
                except MemoryError:
                    break  # no memory — wait for a sequence to finish
                self.waiting.popleft()
                progressed = True

            # one prefill step (≤ max_prefill_tokens_per_step tokens, split
            # across the batch) per pass, interleaved with the decode step
            # below so active streams keep a bounded ITL
            if self.prefilling:
                await self._prefill_chunk(loop, list(self.prefilling))
                progressed = True

            # the sequence-parallel ladder: one chunk per pass (dispatch-only
            # until the final chunk), so decode gaps stay bounded while a
            # long prompt prefills
            if self.sp_active is not None or self.sp_queue:
                if await self._sp_advance(loop):
                    progressed = True

            # decode every active slot: one token, an ngram speculative
            # verify, a fused K-step burst, or — with the dispatch-ahead
            # pipeline — a chained or pipelined burst. Prefill work pins K
            # to 1 so chunked-prefill interleaving (bounded TTFT) is never
            # traded for throughput
            active = [s for s in self.slots
                      if s is not None and s not in self.prefilling
                      and not self._is_sp(s)]
            if active:
                # an SP ladder at work sends the chained and dispatch-ahead
                # modes to the synchronous path ("not_idle"), as in the
                # reference
                runner_idle = not (self.prefilling or self.waiting
                                   or self.sp_active is not None
                                   or self.sp_queue)
                spec_now = (self.config.spec_ngram_tokens > 0 and runner_idle
                            and all(self._spec_eligible(er) for er in active))
                chain_on = (self.config.device_finish_enabled
                            and self.config.decode_pipeline_depth >= 2)
                if not spec_now and self._chain_ok(active, runner_idle):
                    # persistent loop: chain the next burst off the device-
                    # resident carry; finished rows freeze on the device
                    # and drain asynchronously
                    await self._decode_chained(loop, active)
                else:
                    if chain_on:
                        # every pass that did not chain is named
                        reason = self._chain_block_reason(active, runner_idle)
                        if reason:
                            self._note_sync_fallback(reason)
                    await self._chain_barrier(loop)
                    active = [er for er in active if er.finish is None]
                    if (active and not spec_now
                            and self._pipeline_ok(active, runner_idle)):
                        # dispatch-ahead: burst k+1 goes to the device
                        # before burst k's tokens are read on the host
                        await self._decode_pipelined(loop, active)
                    else:
                        # sync barrier: reconcile the in-flight burst before
                        # any non-pipelined dispatch (membership, masks or
                        # the program's shape is changing)
                        await self._drain_pipeline(loop)
                        active = [er for er in active if er.finish is None]
                        if not active:
                            pass
                        elif spec_now:
                            await self._decode_spec(loop, active)
                        else:
                            k_steps = self.config.multi_step_decode
                            if k_steps > 1 and not runner_idle:
                                k_steps = 1
                            await self._decode(loop, active, k_steps)
                progressed = True
            elif self._chain or self._chain_members:
                # every chained row finished or was cancelled while the
                # chain was still dispatching: reconcile the queue and
                # close the chain (frozen rows' pads apply as no-ops)
                await self._chain_barrier(loop)
                progressed = True
            elif self._inflight is not None:
                # every pipelined row finished or was cancelled while its
                # successor burst was in flight: reconcile the orphan (all
                # rows skip at apply: pure over-decode, nothing emits)
                await self._drain_pipeline(loop)
                progressed = True

            if not progressed:
                self.wake.clear()
                if not self.waiting and not any(self.slots):
                    await self.wake.wait()
                else:
                    await asyncio.sleep(0.001)
            else:
                await asyncio.sleep(0)  # let I/O run between steps

        # stopping: reconcile any chained or dispatch-ahead burst so no
        # sampled token is silently dropped and no device work abandoned
        await self._chain_barrier(loop)
        await self._drain_pipeline(loop)

    def _start_prefill(self, er: EngineRequest) -> None:
        """Claim a slot + KV blocks and enter the chunked-prefill state.

        A preempted request resumes here: ``prompt + resume_tokens`` is
        re-prefilled so the emitted stream continues where it left off."""
        slot = self._free_slot()
        assert slot is not None
        er.ctx.add_stage("admission")
        tokens_all = er.prompt + er.resume_tokens
        er.ring_tail.clear()
        er.ring_tail.extend(tokens_all[-SUFFIX_RING_W:])
        if er.want_prompt_lps and not er.prompt_lps_emitted:
            # every prompt position must run through the model — blank the
            # probe's hits so allocation proceeds with zero cached tokens
            probe = self.allocator.probe_prefix(tokens_all)
            er.block_ids, er.num_cached = self.allocator.allocate_prompt(
                tokens_all, probe=(probe[0], []))
        else:
            er.block_ids, er.num_cached = self.allocator.allocate_prompt(tokens_all)
        self.prefix_hit_tokens += er.num_cached
        self.prefix_total_tokens += len(tokens_all)
        er.prefill_tokens = tokens_all
        er.prefill_pos = er.num_cached
        er.context_len = er.num_cached
        er.slot = slot
        self.slots[slot] = er
        self._host.install(er)
        er.seq = TokenSequence(tokens_all, block_size=self.config.kv_block_size)
        er.registered_blocks = 0
        # guided decoding: (re)build the constraint and walk it past any
        # already-emitted tokens (a resumed request continues mid-stream)
        gids = er.req.sampling_options.guided_choice_token_ids
        if gids:
            er.guided = TrieConstraint(gids)
            for t in er.resume_tokens:
                if er.guided.advance(int(t)) != "ok":
                    # derailed resume (tokens that never followed the mask:
                    # unreachable in normal operation): an all-banned mask
                    # would still emit one unconstrained token, so finish
                    # the stream here instead
                    self._finish(er, FinishReason.STOP)
                    return
            if not self._guided_allowed_ids(er):
                # dead state: the vocabulary cannot express any legal
                # continuation
                self._finish(er, FinishReason.STOP)
                return
        # penalty state for the slot: prompt presence + (on resume) counts
        # of the already-generated tokens (+ the guided mask for the FIRST
        # sampled token: the prefill's final chunk samples it)
        self.runner.set_sample_row(
            slot, er.prompt, er.resume_tokens,
            logit_bias=er.req.sampling_options.logit_bias,
            guided_mask=(
                self._guided_mask(er) if er.guided is not None else None),
        )
        if self._sp_eligible(er):
            # the long-context admission class: the SP ranks prefill this
            # one prompt, a chunk per pass
            self.sp_queue.append(er)
        else:
            self.prefilling.append(er)

    # ---------- sequence-parallel long-context prefill ----------

    def _sp_eligible(self, er: EngineRequest) -> bool:
        """Route this admission to the SP ladder? The SP chunk is served
        (``sp_size > 1``, a supported trunk), the uncached suffix reaches
        the threshold, and the request needs no prompt logprobs (the SP
        chunk runs no full-S head)."""
        cfg = self.config
        if not (getattr(self.runner, "sp_ready", False)
                and cfg.long_prefill_threshold_tokens > 0):
            return False
        suffix = len(er.prefill_tokens) - er.num_cached
        if suffix < cfg.long_prefill_threshold_tokens:
            return False
        return not (er.want_prompt_lps and not er.prompt_lps_emitted)

    def _is_sp(self, er: EngineRequest) -> bool:
        return self.sp_active is er or er in self.sp_queue

    def _sp_drop(self, er: EngineRequest) -> None:
        """Remove a cancelled request from the SP ladder. A chunk already
        dispatched only writes the request's own blocks, which are freed
        with it: nothing leaks."""
        if self.sp_active is er:
            self.sp_active = None
        if er in self.sp_queue:
            self.sp_queue.remove(er)

    async def _sp_advance(self, loop) -> bool:
        """One pass of the SP ladder: dispatch the active request's next
        chunk (dispatch-only: the device runs ahead while the loop serves
        decode), register the blocks it completes in the prefix cache, and
        on the final chunk run the early decode handoff and the drain."""
        er = self.sp_active
        while er is None and self.sp_queue:
            er = self.sp_queue.pop(0)
            if er.finish is not None or er.ctx.is_stopped:
                er = None
        self.sp_active = er
        if er is None:
            return False
        if er.finish is not None or er.ctx.is_stopped:
            self.sp_active = None
            if er.finish is None:
                self._finish(er, FinishReason.CANCELLED)
            return True
        total = len(er.prefill_tokens)
        start = er.prefill_pos
        end = min(start + self.runner.sp_chunk_tokens, total)
        final = end >= total
        outs = self.runner.sp_prefill_chunk(
            er.prefill_tokens[:end], start, er.block_ids,
            temperature=er.temperature, top_k=er.top_k, top_p=er.top_p,
            min_p=er.min_p, presence_penalty=er.presence_penalty,
            frequency_penalty=er.frequency_penalty,
            repetition_penalty=er.repetition_penalty,
            seed_keys=er.base_key, counters=er.generated,
            sample_slot=er.slot, commit=final,
            want_top=final and er.logprobs_n > 0,
        )
        self.steps += 1
        self.sp_chunks += 1
        self.sp_tokens += end - start
        er.prefill_pos = end
        er.context_len = end
        # the chunk's blocks become matchable as soon as its write is
        # dispatched: stream order puts it before any later read
        self._register_completed_blocks(er)
        if not final:
            return True
        try:
            await self._sp_finish(loop, er, outs)
        finally:
            self.sp_active = None
        return True

    async def _sp_finish(self, loop, er: EngineRequest, outs) -> None:
        """Early decode handoff and drain of a finished SP ladder.

        The final chunk's sampled token is still on the device. When the
        request can take a plain decode burst, one is dispatched at once
        with that token composed into its row ON THE DEVICE, so the first
        burst is queued before any host read of the prefill outputs. One
        executor sync drains both; emission follows the dense path's rules
        (tokens past a finish are discarded with the request's blocks)."""
        cfg = self.config
        next_tokens, lps, top_vals, top_ids = outs
        pf = self.runner.stage_to_host(next_tokens, lps, top_vals, top_ids)
        hs = self._host
        b = cfg.max_batch_size
        ctx0 = er.context_len  # the first sampled token's position
        k_steps = cfg.multi_step_decode
        burst = None
        can_burst = (
            er.guided is None
            and er.max_new > 1
            and ctx0 + k_steps + 1 <= cfg.max_model_len
            and all(self._ensure_block_for(er, ctx0 + j)
                    for j in range(k_steps))
        )
        if can_burst:
            hs.sync_blocks(er)
            w = cfg.kv_width_bucket(len(er.block_ids))
            btab = hs.btab[:, :w].copy()
            pos0 = np.zeros(b, np.int32)
            pos0[er.slot] = ctx0
            ctrs = np.zeros(b, np.int32)
            ctrs[er.slot] = er.generated + 1  # after the prefill's token
            commit = np.zeros(b, bool)
            commit[er.slot] = True
            temp = np.where(commit, hs.temp, 0.0).astype(np.float32)
            toks, lpb, tvb, tib = self.runner.decode_burst(
                self.runner.handoff_tokens(next_tokens, er.slot), pos0, btab,
                temp, hs.top_k, hs.top_p,
                min_p=hs.min_p, presence_penalty=hs.pres,
                frequency_penalty=hs.freq, repetition_penalty=hs.rep,
                seed_keys=hs.keys, counters=ctrs, commit=commit,
                want_top=er.logprobs_n > 0,
            )
            burst = self.runner.stage_to_host(toks, lpb, tvb, tib)
            self.steps += 1
            self.decode_steps += 1
            self.sp_handoffs += 1

        def _sync():
            out = pf.numpy()
            if burst is not None:
                out = out + burst.numpy()
            return out

        synced = await loop.run_in_executor(None, _sync)
        toks_pf, lps_pf, tv_pf, ti_pf = synced[:4]
        er.ctx.add_stage("prefill")
        token = int(toks_pf[0])
        er.pending_token = token
        er.generated += 1
        er.ring_tail.append(token)
        er.finish = self._check_finish(er, token)
        self._guided_after_token(er)
        self._emit(er, token, float(lps_pf[0]) if er.want_logprobs else None,
                   self._top_row(er, tv_pf, ti_pf, 0))
        if er.finish is not None:
            # trailing burst tokens (if any) are over-decode into the
            # request's own blocks, freed with it
            self._finish(er, er.finish, emit=False)
            return
        if burst is None:
            return
        toks_b, lps_b, tv_b, ti_b = synced[4:]
        for j in range(k_steps):
            if er.finish is not None or er.ctx.is_stopped:
                break
            tok_j = int(toks_b[j, er.slot])
            self._advance_row(er, tok_j)
            self._guided_after_token(er)
            self._emit(er, tok_j,
                       float(lps_b[j, er.slot]) if er.want_logprobs else None,
                       self._top_row(er, tv_b[j], ti_b[j], er.slot))
            if er.finish is not None:
                self._finish(er, er.finish, emit=False)

    async def _prefill_chunk(self, loop, ers: List[EngineRequest]) -> None:
        """ONE batched prefill step: every prefilling request advances a
        chunk as a row of the same step (rows padded to the power-of-two
        ladder, lengths to the common bucket); rows that finish their
        prompt sample and emit. The token budget splits across rows."""
        cfg = self.config
        rows = cfg.prefill_row_bucket(len(ers))
        cap = prefill_bucket_cap(cfg, rows)
        # a full batch can exceed the budget even at the smallest bucket —
        # admit fewer rows this step instead of overrunning
        while cap is None and rows > cfg.PREFILL_ROW_BUCKETS[0]:
            rows = max(r for r in cfg.PREFILL_ROW_BUCKETS if r < rows)
            ers = ers[:rows]
            cap = prefill_bucket_cap(cfg, rows)
        # budget < one row at the smallest bucket: best-effort floor
        bucket_cap = cap if cap is not None else cfg.prefill_buckets[0]
        plan = []  # (er, start, end, take, final)
        for er in ers:
            total = len(er.prefill_tokens)
            take = min(total - er.prefill_pos, bucket_cap)
            end = er.prefill_pos + take
            plan.append((er, er.prefill_pos, end, take, end >= total))
        bucket = cfg.bucket_for(max(p[3] for p in plan))

        tokens = np.zeros((rows, bucket), np.int32)
        positions = np.zeros((rows, bucket), np.int32)
        btab = np.zeros((rows, cfg.blocks_per_seq), np.int32)
        slot_map = np.full((rows, bucket), -1, np.int32)
        ctx_lens = np.ones(rows, np.int32)
        last_idx = np.zeros(rows, np.int32)
        temp = np.zeros(rows, np.float32)
        top_k = np.zeros(rows, np.int32)
        top_p = np.ones(rows, np.float32)
        min_p = np.zeros(rows, np.float32)
        pres = np.zeros(rows, np.float32)
        freq = np.zeros(rows, np.float32)
        rep = np.ones(rows, np.float32)
        keys = np.zeros((rows, 2), np.uint32)
        ctrs = np.zeros(rows, np.int32)
        # pad rows share sample slot 0 with commit=False: the count commit
        # is a scatter-add, so they add 0 to the live row's counts
        sample_slots = np.zeros(rows, np.int32)
        commit = np.zeros(rows, bool)
        targets = np.zeros((rows, bucket), np.int32)
        n_tgts = [0] * len(plan)
        want_prompt = False

        for i, (er, start, end, take, final) in enumerate(plan):
            t, p, bt, sm, cl, li = build_prefill_arrays(
                cfg, er.prefill_tokens[:end], start, er.block_ids,
                bucket=bucket,
            )
            tokens[i], positions[i] = t[0], p[0]
            btab[i], slot_map[i] = bt[0], sm[0]
            ctx_lens[i], last_idx[i] = cl[0], li[0]
            (temp[i], top_k[i], top_p[i], min_p[i], pres[i], freq[i],
             rep[i]) = (er.temperature, er.top_k, er.top_p, er.min_p,
                        er.presence_penalty, er.frequency_penalty,
                        er.repetition_penalty)
            keys[i] = er.base_key
            ctrs[i] = er.generated
            sample_slots[i] = er.slot
            commit[i] = final
            if er.want_prompt_lps and not er.prompt_lps_emitted:
                # target at bucket index j (position start+j) is the NEXT
                # prompt token; only prompt positions count
                want_prompt = True
                nxt = er.prefill_tokens[start + 1: end + 1]
                targets[i, : len(nxt)] = nxt
                n_tgts[i] = max(0, min(take, len(er.prompt) - 1 - start))

        next_tokens, lps, top_vals, top_ids, plps, _ = self.runner.step(
            tokens, positions, btab, slot_map, ctx_lens, last_idx,
            temp, top_k, top_p,
            min_p=min_p, presence_penalty=pres, frequency_penalty=freq,
            repetition_penalty=rep, seed_keys=keys, counters=ctrs,
            sample_slots=sample_slots, commit=commit,
            want_top=any(er.logprobs_n > 0 for er, *_ in plan),
            targets=targets, want_prompt=want_prompt,
        )
        self.steps += 1
        self.prefill_steps += 1

        finals = []
        for i, (er, start, end, take, final) in enumerate(plan):
            if n_tgts[i] > 0:
                er.prompt_lp_parts.append((plps[i: i + 1], n_tgts[i]))
            er.prefill_pos = end
            er.context_len = end
            # prefix blocks become matchable as soon as each chunk's KV is
            # scheduled — stream order puts the write before any later read
            self._register_completed_blocks(er)
            if final:
                finals.append(i)
        if not finals:
            return

        def _to_host():
            # device→host transfers off the event loop
            plists = {
                i: [
                    float(x)
                    for row, cnt in plan[i][0].prompt_lp_parts
                    for x in row.cpu().numpy()[0, :cnt]
                ]
                for i in finals
                if plan[i][0].prompt_lp_parts
            }
            return (next_tokens.cpu().numpy(), lps.cpu().numpy(),
                    top_vals.cpu().numpy(), top_ids.cpu().numpy(), plists)

        toks, lpn, tv, ti, plists = await loop.run_in_executor(None, _to_host)
        for i in finals:
            er = plan[i][0]
            self.prefilling.remove(er)
            er.ctx.add_stage("prefill")
            prompt_lps = None
            if er.want_prompt_lps and not er.prompt_lps_emitted:
                # the first prompt token has no conditioning prefix
                prompt_lps = [None] + plists.get(i, [])
                er.prompt_lps_emitted = True
            er.prompt_lp_parts = []
            if er.max_new == 0:
                # prompt-scoring request (echo + logprobs + max_tokens=0)
                er.finish = FinishReason.LENGTH
                er.out_queue.put_nowait(EngineOutput(
                    token_ids=[], finish_reason=er.finish,
                    prompt_logprobs=prompt_lps,
                ))
                self._finish(er, er.finish, emit=False)
                continue
            token = int(toks[i])
            er.pending_token = token
            er.generated += 1  # += not =: resumed requests keep their count
            er.ring_tail.append(token)
            er.finish = self._check_finish(er, token)
            self._guided_after_token(er)
            self._emit(er, token, float(lpn[i]) if er.want_logprobs else None,
                       self._top_row(er, tv, ti, i), prompt_lps=prompt_lps)
            if er.finish is not None:
                self._finish(er, er.finish, emit=False)

    def _spec_eligible(self, er: EngineRequest) -> bool:
        """Speculative verify preserves the exact stream only for greedy,
        penalty-free, bias-free requests that want no logprobs: the verify
        step's raw argmax must equal what sequential sampling would pick,
        and per-position logprobs are not computed. Guided rows are
        excluded too: their mask changes every step."""
        return (er.guided is None and er.temperature == 0.0
                and er.presence_penalty == 0.0
                and er.frequency_penalty == 0.0
                and er.repetition_penalty == 1.0
                and not er.want_logprobs and er.logprobs_n == 0
                and not er.req.sampling_options.logit_bias)

    async def _decode_spec(self, loop, active: List[EngineRequest]) -> None:
        """One speculative decode pass: propose up to K tokens per row from
        the row's own history (ngram), verify all K + 1 positions in ONE
        forward, and emit the accepted prefix plus the correction token.

        Every proposed position's KV is written during the verify; the
        slots of rejected positions are rewritten when decoding reaches
        them again, and block registration only covers positions below the
        host ``context_len``, which advances by accepted tokens only."""
        cfg = self.config
        b = cfg.max_batch_size
        bs = cfg.kv_block_size
        K = cfg.spec_ngram_tokens
        S = K + 1
        if any(er.context_len + S + 1 > cfg.max_model_len for er in active):
            # a row is within K of the horizon; it finishes momentarily
            return await self._decode(loop, active, 1)

        # when nothing matches anywhere (non-repetitive output) the K+1-wide
        # verify would be pure overhead: run the normal decode instead
        props = {}
        for er in active:
            history = list(er.seq.token_ids) + [er.pending_token]
            props[er.slot] = ngram_propose(history, cfg.spec_ngram_match, K)
        if not any(props.values()):
            return await self._decode(loop, active, cfg.multi_step_decode)

        for er in list(active):
            if not all(self._ensure_block_for(er, er.context_len + j)
                       for j in range(S)):
                logger.warning("KV OOM: preempting %s", er.request_id)
                self._preempt(er)
                active.remove(er)
        if not active:
            return

        w = cfg.kv_width_bucket(max(len(er.block_ids) for er in active))
        tokens = np.zeros((b, S), np.int32)
        positions = np.zeros((b, S), np.int32)
        slot_map = np.full((b, S), -1, np.int32)
        btab = np.zeros((b, w), np.int32)
        ctx_lens = np.ones(b, np.int32)
        last_idx = np.zeros(b, np.int32)
        for er in active:
            i = er.slot
            pos0 = er.context_len
            row = [er.pending_token] + props[i]
            tokens[i, : len(row)] = row
            positions[i] = pos0 + np.arange(S)
            for j in range(S):
                pj = pos0 + j
                slot_map[i, j] = er.block_ids[pj // bs] * bs + pj % bs
            btab[i, : len(er.block_ids)] = er.block_ids
            # causal masking is by absolute position, so a short row's junk
            # keys past its proposal are invisible to its valid queries
            ctx_lens[i] = pos0 + S
            last_idx[i] = len(row) - 1

        zf, zi = np.zeros(b, np.float32), np.zeros(b, np.int32)
        *_, greedy_all = self.runner.step(
            tokens, positions, btab, slot_map, ctx_lens, last_idx,
            zf, zi, np.ones(b, np.float32),
            min_p=zf, presence_penalty=zf, frequency_penalty=zf,
            repetition_penalty=np.ones(b, np.float32),
            seed_keys=np.zeros((b, 2), np.uint32), counters=zi,
            sample_slots=np.arange(b, dtype=np.int32),
            commit=np.zeros(b, bool),  # greedy rows: counts never consulted
            want_top=False, want_greedy=True,
        )
        ga = await loop.run_in_executor(None, lambda: greedy_all.cpu().numpy())
        self.steps += 1
        self.decode_steps += 1

        for er in active:
            if er.finish is not None:
                continue
            prop = props[er.slot]
            a = 0
            while a < len(prop) and int(ga[er.slot, a]) == prop[a]:
                a += 1
            self.spec_proposed += len(prop)
            self.spec_accepted += a
            # emit the accepted prefix + the correction token, with the
            # same pending-token discipline as every other decode path
            for j in range(a + 1):
                if er.finish is not None:
                    break
                token = int(ga[er.slot, j])
                self._advance_row(er, token)
                self._emit(er, token, None, None)
                if er.finish is not None:
                    self._finish(er, er.finish, emit=False)

    async def _decode(self, loop, active: List[EngineRequest],
                      k_steps: int = 1) -> None:
        """One batched decode pass over every active slot: a single step,
        or a K-step burst (``k_steps > 1``) whose K tokens per row reach
        the host together."""
        cfg = self.config
        b = cfg.max_batch_size
        bs = cfg.kv_block_size

        # a burst writes K tokens of KV per row before the host sees any of
        # them, so every row needs blocks for all K positions up front, and
        # no row may run past the model-len horizon mid-burst (such rows
        # finish within one burst anyway — step per token this pass)
        if k_steps > 1 and any(
                er.context_len + k_steps + 1 > cfg.max_model_len for er in active):
            k_steps = 1
        # a row that finishes inside a burst (eos, a hidden stop id, a stop
        # sequence, max_tokens) freezes on the device for the rest of it:
        # no KV write, no expert slot, as the pad single steps carry. On a
        # MoE trunk whose experts hold one token each, a finished row that
        # rode on live would take experts from the rows after it, so a row
        # whose finish the device cannot see in full steps per token
        if k_steps > 1 and any(er.chain_fallback in ("stop_ids_overflow",
                                                     "stop_seqs_overflow")
                               for er in active):
            k_steps = 1
        if any(er.guided is not None for er in active):
            # guided rows rewrite their mask between tokens on the host; a
            # fused burst would sample K tokens against one stale mask.
            # This pins the WHOLE batch: all rows share one dispatch
            k_steps = 1
        for er in list(active):
            if not all(self._ensure_block_for(er, er.context_len + j)
                       for j in range(k_steps)):
                # out of memory: evict this request back to waiting
                # (recompute later; its stream continues on re-prefill)
                logger.warning("KV OOM: preempting %s", er.request_id)
                self._preempt(er)
                active.remove(er)
        if not active:
            return

        # KV-width bucketing: the block table is sized to the live context,
        # rounded up a power-of-two ladder
        w = cfg.kv_width_bucket(max(len(er.block_ids) for er in active))
        hs = self._host
        tokens = np.zeros((b, 1), np.int32)
        positions = np.zeros((b, 1), np.int32)
        slot_map = np.full((b, 1), -1, np.int32)
        ctx_lens = np.ones(b, np.int32)
        last_idx = np.zeros(b, np.int32)
        ctrs = np.zeros(b, np.int32)
        commit = np.zeros(b, bool)
        for er in active:
            i = er.slot
            pos = er.context_len
            hs.sync_blocks(er)
            tokens[i, 0] = er.pending_token
            positions[i, 0] = pos
            slot_map[i, 0] = er.block_ids[pos // bs] * bs + pos % bs
            ctx_lens[i] = pos + 1
            ctrs[i] = er.generated
            commit[i] = True
        btab = hs.btab[:, :w].copy()
        # inactive rows sample with greedy settings: no noise is drawn for them
        temp = np.where(commit, hs.temp, 0.0).astype(np.float32)
        want_top = any(er.logprobs_n > 0 for er in active)

        if k_steps > 1:
            # the chained burst's device finish, from committed host state:
            # frozen rows emit -1 pads
            ring0 = np.full((b, SUFFIX_RING_W), -1, np.int32)
            for er in active:
                ring0[er.slot] = ring_init(er.ring_tail)
            next_tokens, lps, top_vals, top_ids, _ = (
                self.runner.decode_burst_chained(
                    tokens[:, 0], positions[:, 0], ctrs, np.zeros(b, bool),
                    btab, temp, hs.top_k, hs.top_p,
                    min_p=hs.min_p, presence_penalty=hs.pres,
                    frequency_penalty=hs.freq, repetition_penalty=hs.rep,
                    seed_keys=hs.keys, counters=ctrs, commit=commit,
                    stop_ids=hs.stop_ids, min_new=hs.min_new,
                    max_new=hs.max_new, ring0=ring0, stop_hash=hs.stop_hash,
                    stop_hlen=hs.stop_hlen, want_top=want_top))
        else:
            next_tokens, lps, top_vals, top_ids, *_ = self.runner.step(
                tokens, positions, btab, slot_map, ctx_lens, last_idx,
                temp, hs.top_k, hs.top_p,
                min_p=hs.min_p, presence_penalty=hs.pres,
                frequency_penalty=hs.freq, repetition_penalty=hs.rep,
                seed_keys=hs.keys, counters=ctrs,
                sample_slots=np.arange(b, dtype=np.int32), commit=commit,
                want_top=want_top,
            )

        out = self.runner.stage_to_host(next_tokens, lps, top_vals, top_ids)
        toks, lpn, tv, ti = await loop.run_in_executor(None, out.numpy)
        self.steps += 1
        self.decode_steps += 1
        if k_steps == 1:
            # [B] → [1, B] so the emit loop below is one shape
            toks, lpn, tv, ti = toks[None], lpn[None], tv[None], ti[None]

        # emit in step order; a request that finishes at step j froze there
        # (its later lanes are -1 pads). A pad with no host finish is a
        # suffix-hash false positive: the row resumes at the next pass from
        # its committed state
        for j in range(k_steps):
            for er in active:
                if er.finish is not None:
                    continue
                token = int(toks[j, er.slot])
                if token < 0:
                    continue
                self._advance_row(er, token)
                self._guided_after_token(er)
                self._emit(
                    er, token,
                    float(lpn[j, er.slot]) if er.want_logprobs else None,
                    self._top_row(er, tv[j], ti[j], er.slot),
                )
                if er.finish is not None:
                    self._finish(er, er.finish, emit=False)

    # ---------- dispatch-ahead decode (pipeline depth 2) ----------

    def _pipeline_ok(self, active: List[EngineRequest],
                     runner_idle: bool) -> bool:
        """May this pass decode dispatch-ahead?

        Guided decoding (per-token host mask edits), speculative decoding,
        ``n > 1``, prefill / admission work and rows within two bursts of
        the model-len horizon all force the synchronous path, selected per
        pass, never mid-burst. A batch-membership surprise (a row active
        now that was not in the dispatched burst) drains defensively."""
        cfg = self.config
        if cfg.decode_pipeline_depth < 2 or not runner_idle:
            return False
        if cfg.spec_ngram_tokens > 0:
            return False
        K = cfg.multi_step_decode
        for er in active:
            if er.guided is not None:
                return False
            n = er.req.sampling_options.n
            if n is not None and n > 1:
                return False
            if er.context_len + 2 * K + 1 > cfg.max_model_len:
                return False
        infl = self._inflight
        if infl is not None:
            live = {id(er) for er in infl.active if er.finish is None}
            if live != {id(er) for er in active}:
                return False
        return True

    async def _decode_pipelined(self, loop,
                                active: List[EngineRequest]) -> None:
        """One pipelined pass: dispatch burst k+1, then reconcile burst k
        on the host while k+1 runs on the device.

        The carry (burst k's last sampled tokens) is a device tensor among
        the burst's outputs, so burst k+1 consumes it without a host round
        trip; the host then reads, streams and finish-checks burst k's
        tokens during burst k+1's device time. Block headroom for ``2*K``
        positions is reserved before every dispatch, so the in-flight
        burst can never write to an unallocated slot; if the reservation
        fails, the pipeline drains (sync barrier) and the synchronous
        path, which owns preemption, takes the pass."""
        cfg = self.config
        b = cfg.max_batch_size
        k_steps = cfg.multi_step_decode
        infl = self._inflight
        # the device is ``ahead`` tokens past the host's committed state
        ahead = infl.k_steps if infl is not None else 0

        for er in active:
            # 2*K from the host context: covers the burst dispatched now
            # (positions ahead..ahead+K-1 past the committed state) and
            # keeps the invariant once reconciliation advances the host
            if not all(self._ensure_block_for(er, er.context_len + j)
                       for j in range(2 * k_steps)):
                # KV OOM: preemption needs fully committed host state.
                # Drain, then let the sync path preempt / decode this pass
                await self._drain_pipeline(loop)
                live = [e for e in active if e.finish is None]
                if live:
                    await self._decode(loop, live, k_steps)
                return

        hs = self._host
        positions0 = np.zeros(b, np.int32)
        ctrs = np.zeros(b, np.int32)
        commit = np.zeros(b, bool)
        for er in active:
            i = er.slot
            hs.sync_blocks(er)
            positions0[i] = er.context_len + ahead
            ctrs[i] = er.generated + ahead
            commit[i] = True
        w = cfg.kv_width_bucket(max(len(er.block_ids) for er in active))
        btab = hs.btab[:, :w].copy()
        if infl is None:
            # pipeline fill (first burst after a drain): tokens from host
            tokens0 = np.zeros(b, np.int32)
            for er in active:
                tokens0[er.slot] = er.pending_token
        else:
            tokens0 = infl.last_tokens  # device-resident carry
        want_top = any(er.logprobs_n > 0 for er in active)

        toks, lps, tv, ti = self.runner.decode_burst(
            tokens0, positions0, btab, hs.temp, hs.top_k, hs.top_p,
            min_p=hs.min_p, presence_penalty=hs.pres,
            frequency_penalty=hs.freq, repetition_penalty=hs.rep,
            seed_keys=hs.keys, counters=ctrs, commit=commit,
            want_top=want_top,
        )
        self.steps += 1
        self.decode_steps += 1
        self.pipeline_bursts += 1
        self._inflight = _InflightBurst(
            active=list(active),
            out=self.runner.stage_to_host(toks, lps, tv, ti),
            k_steps=k_steps, last_tokens=toks[k_steps - 1],
        )
        if infl is not None:
            # burst k+1 is on the device: reconcile burst k while it runs
            await self._apply_burst(loop, infl)
            if all(er.finish is not None for er in self._inflight.active):
                # burst k finished every row: k+1 is pure over-decode.
                # Reconcile it now instead of leaving an orphan in flight
                await self._drain_pipeline(loop)

    async def _apply_burst(self, loop, infl: _InflightBurst) -> None:
        """Host half of the pipeline: wait for the burst's sampled tokens
        (the decode loop's ONLY host sync, on the burst's own event), emit
        them, run finish checks, and retro-invalidate rows that finished
        one burst late."""
        toks, lpn, tv, ti = await loop.run_in_executor(None, infl.out.numpy)
        for j in range(infl.k_steps):
            for er in infl.active:
                if er.finish is not None:
                    continue  # finished / cancelled: over-decode discarded
                token = int(toks[j, er.slot])
                if infl.device_finish and token < 0:
                    if er.chain_fp:
                        continue  # already flagged: resumes at the barrier
                    if er.fin_stop_hash is not None:
                        # the device's suffix-hash stop candidate froze this
                        # row, but the host's EXACT token-suffix check
                        # (_check_finish, run on every emitted token above)
                        # never fired: a hash collision. Flag it: the chain
                        # closes at the next pass and the row resumes from
                        # its committed state (no token was lost: frozen
                        # rows never over-decode)
                        er.chain_fp = True
                        self._chain_fp = True
                        self._note_sync_fallback("stop_false_positive")
                        continue
                    # -1 pad: the device froze this row at an earlier step,
                    # whose application above set er.finish. A pad with NO
                    # host verdict means the device mask and the host
                    # mirror diverged: finishing the row loudly beats
                    # decoding a frozen zombie forever
                    logger.error(
                        "device froze %s without a host finish verdict "
                        "(device_finish_mask / _check_finish mirror "
                        "divergence?); forcing STOP", er.request_id)
                    er.finish = FinishReason.STOP
                    # emit=True: no preceding _emit carried the finish
                    # reason, and the client must see one
                    self._finish_pipelined(er, emit=True)
                    continue
                self._advance_row(er, token)
                if infl.device_finish and er.guided is not None:
                    # chained guided rows: advance the host cursor (verdicts
                    # only: the device computed the mask; the barrier
                    # reinstalls the host mask if needed)
                    self._guided_after_token(er, edit=False)
                self._emit(
                    er, token,
                    float(lpn[j, er.slot]) if er.want_logprobs else None,
                    self._top_row(er, tv[j], ti[j], er.slot),
                )
                if er.finish is not None:
                    if infl.device_finish:
                        # the device's mask froze this row at exactly this
                        # step: the host check is the mirror that names the
                        # reason and finalizes the bookkeeping
                        er.device_frozen = True
                        self.device_finished_rows += 1
                    self._finish_pipelined(er)

    def _finish_pipelined(self, er: EngineRequest, emit: bool = False) -> None:
        """A pipelined row finished (possibly one burst late): truncate the
        over-decoded tokens (never emitted), roll the headroom blocks
        holding only over-decoded KV back into the allocator and free the
        slot.

        The in-flight burst's writes to the rolled-back blocks are
        harmless: the blocks are anonymous (never registered), and one
        stream orders those writes before any later program's writes to a
        reallocated slot."""
        bs = self.config.kv_block_size
        keep = -(-er.context_len // bs)  # blocks covering committed KV
        er.block_ids = self.allocator.rollback_tail(er.block_ids, keep)
        self._host.sync_blocks(er)
        # emit=False on the normal path: the finishing token's _emit already
        # carried the finish reason
        self._finish(er, er.finish, emit=emit)

    async def _drain_pipeline(self, loop) -> None:
        """Sync barrier: reconcile the in-flight burst (if any) so every
        synchronous consumer (preemption, prefill interleave, spec or
        guided decode, shutdown) sees fully committed host state."""
        infl, self._inflight = self._inflight, None
        if infl is not None:
            await self._apply_burst(loop, infl)

    # ---------- persistent decode loop (config.device_finish) ----------

    def _note_sync_fallback(self, reason: str) -> None:
        self.sync_fallback[reason] = self.sync_fallback.get(reason, 0) + 1

    def _chain_ok(self, active: List[EngineRequest],
                  runner_idle: bool) -> bool:
        return self._chain_block_reason(active, runner_idle) is None

    def _chain_block_reason(self, active: List[EngineRequest],
                            runner_idle: bool) -> Optional[str]:
        """Why can this pass NOT chain a burst off the device carry? None
        = it can. Stop-sequence rows chain through the suffix-hash
        approximation and guided rows through a compiled device table;
        what remains is named here and counted per sync pass
        (``metrics()["sync_fallback"]``)."""
        cfg = self.config
        if not (cfg.device_finish_enabled
                and cfg.decode_pipeline_depth >= 2):
            return "disabled"
        if not runner_idle:
            return "not_idle"
        if not active:
            return "no_rows"
        if self._chain_fp:
            # a suffix-hash false positive froze a row the host must
            # resume: close the chain first (the barrier clears this)
            return "stop_false_positive"
        if cfg.spec_ngram_tokens > 0:
            return "speculation"  # the chained propose-verify round
        tables = set()
        for er in active:
            if not er.device_checkable:
                return er.chain_fallback or "not_checkable"
            if er.fin_stop_seqs and not cfg.device_stop_strings:
                return "stop_strings_disabled"
            if er.guided is not None:
                r = self._guided_chain_reason(er)
                if r:
                    return r
                tables.add(id(self._guided_tables[
                    self._guided_table_key(er)]))
        if len(tables) > 1:
            # the burst takes ONE transition table; requests sharing a
            # choice list share a table, mixed lists wait for membership to
            # separate them
            return "guided_multi_grammar"
        if self._chain_members:
            member_ids = {id(m) for m in self._chain_members}
            if any(id(er) not in member_ids for er in active):
                return "membership"
        return None

    # ---------- guided device tables (engine/guided.py) ----------

    def _guided_table_key(self, er: EngineRequest) -> tuple:
        if er.guided_key is None:
            eos = tuple(sorted(int(t) for t in (er.req.eos_token_ids or [])))
            er.guided_key = (
                "trie",
                tuple(tuple(int(t) for t in c) for c in er.guided._choice_ids),
                eos)
        return er.guided_key

    def _compile_guided_table(self, er: EngineRequest):
        """Executor-side table compile (also called directly by tests).
        Returns the DeviceGuidedTable or None (bound exceeded)."""
        return compile_device_table(
            er.guided, self.config.model.vocab_size,
            er.req.eos_token_ids or [],
            max_states=self.config.guided_table_max_states,
        )

    def _guided_chain_reason(self, er: EngineRequest) -> Optional[str]:
        """Is this guided row chainable right now? Kicks the (executor)
        table compile on first sight; the row is served on the sync path
        until the table lands."""
        if not self.config.guided_device_table:
            return "guided_disabled"
        key = self._guided_table_key(er)
        if key in self._guided_tables:
            # LRU touch + cap (re-checked every pass, so an evicted-then-
            # needed table simply recompiles)
            table = self._guided_tables.pop(key)
            self._guided_tables[key] = table
            while len(self._guided_tables) > self.GUIDED_TABLE_CACHE:
                self._guided_tables.pop(next(iter(self._guided_tables)))
            if table is None:
                return "guided_table_bound"
            if table.state_id(er.guided) is None:
                # the cursor is in a state the BFS never reached: only a
                # bug can produce this; stay on the sync path loudly
                logger.warning(
                    "guided cursor state unmapped in the device table for "
                    "%s; keeping the sync path", er.request_id)
                return "guided_state_unmapped"
            return None
        if key not in self._guided_table_futs:
            # the per-state sweep must never run on the event loop
            fut = asyncio.get_running_loop().run_in_executor(
                None, self._compile_guided_table, er)

            def _done(f, key=key):
                try:
                    self._guided_tables[key] = f.result()
                except Exception:
                    logger.exception("guided device-table compile failed")
                    self._guided_tables[key] = None
                self._guided_table_futs.pop(key, None)
                self.wake.set()

            fut.add_done_callback(_done)
            self._guided_table_futs[key] = fut
        return "guided_table_pending"

    # ---------- the chain ----------

    async def _apply_chain_head(self, loop) -> None:
        """Reconcile the oldest queued chained burst (FIFO: token order
        per row)."""
        await self._apply_burst(loop, self._chain.popleft())

    async def _chain_prologue(self, loop, active):
        """The open / validate ladder of a chained pass: reconcile a
        predating dispatch-ahead burst, open the chain if none is, and
        resolve the live member list. Returns ``(active, live, members)``
        or None: None means every fallback already ran and the caller just
        returns."""
        if self._inflight is not None:
            # a plain dispatch-ahead burst predates this chain: reconcile
            # it first so the chain starts from fully committed state
            await self._drain_pipeline(loop)
            active = [er for er in active if er.finish is None]
            if not active:
                return None
        if not self._chain_members:
            self._chain_members = list(active)
            self._chain_carry = None
            self._chain_dispatched = 0
            self._chain_pos0 = {er.slot: er.context_len for er in active}
            self._chain_gen0 = {er.slot: er.generated for er in active}
        members = self._chain_members
        live = [er for er in members if er.finish is None]
        if not live:
            await self._chain_barrier(loop)
            return None
        return active, live, members

    async def _chain_reserve(self, loop, active, live, advance: int) -> bool:
        """Block headroom for the chain's next dispatch: a never-frozen row
        runs through position ``chain_pos0 + (n+1)*advance - 1``; reserve
        one past that (the carry slot), capped at the model-len horizon
        (the device freezes rows there; blocks past it are never touched).
        False = KV OOM: preemption needs fully committed host state, so
        the chain closed at a barrier and the pass already fell back to
        one sync decode."""
        cfg = self.config
        n = self._chain_dispatched
        for er in live:
            limit = min(self._chain_pos0[er.slot] + (n + 1) * advance,
                        cfg.max_model_len - 1)
            if not self._ensure_block_for(er, limit):
                self._note_sync_fallback("kv_oom")
                await self._chain_barrier(loop)
                rest = [er for er in active if er.finish is None]
                if rest:
                    await self._decode(loop, rest, advance)
                return False
            self._host.sync_blocks(er)
        return True

    def _chain_fill(self, live):
        """The chain-fill carry from committed host state (the first
        dispatch of a chain)."""
        b = self.config.max_batch_size
        tokens0 = np.zeros(b, np.int32)
        positions0 = np.zeros(b, np.int32)
        gen0 = np.zeros(b, np.int32)
        done0 = np.zeros(b, bool)
        ring0 = np.full((b, SUFFIX_RING_W), -1, np.int32)
        gstate0 = np.full(b, -1, np.int32)
        for er in live:
            tokens0[er.slot] = er.pending_token
            positions0[er.slot] = er.context_len
            gen0[er.slot] = er.generated
            ring0[er.slot] = ring_init(er.ring_tail)
            if er.guided is not None:
                gstate0[er.slot] = self._guided_tables[
                    self._guided_table_key(er)].state_id(er.guided)
        return tokens0, positions0, gen0, done0, ring0, gstate0

    async def _chain_drain(self, loop, members) -> None:
        """Asynchronous row drain after a chained dispatch: reconcile every
        burst whose outputs already reached the host (never gating the
        dispatch), enforce the in-flight bound, and close the chain when
        every member finished (anything still queued is frozen
        over-decode)."""
        while self._chain and self._chain[0].out.ready():
            await self._apply_chain_head(loop)
        while len(self._chain) >= self.CHAIN_MAX_INFLIGHT:
            await self._apply_chain_head(loop)
        if all(er.finish is not None for er in members):
            await self._chain_barrier(loop)

    async def _decode_chained(self, loop,
                              active: List[EngineRequest]) -> None:
        """One persistent-loop pass: dispatch the next burst straight off
        the device-resident carry, WITHOUT waiting for any previous
        burst's host reconciliation, then drain whatever bursts have
        already reached the host.

        Finished rows freeze inside the burst (no sampling, no KV writes,
        -1 pads out), so membership never changes mid-chain: the commit
        mask marks members, the device ``done`` mask marks frozen rows,
        and rows cancelled on the host simply drop out of the commit mask
        at the next dispatch. Block headroom and the noise counters follow
        the chain's own dispatch count (the host's committed state lags by
        the whole drain queue); headroom is capped at the model-len
        horizon, where the device's LENGTH check freezes rows, so
        near-horizon rows stay chained instead of forcing sync."""
        cfg = self.config
        b = cfg.max_batch_size
        k_steps = max(1, cfg.multi_step_decode)
        opened = await self._chain_prologue(loop, active)
        if opened is None:
            return
        active, live, members = opened
        n = self._chain_dispatched
        if not await self._chain_reserve(loop, active, live, k_steps):
            return

        hs = self._host
        commit = np.zeros(b, bool)
        ctrs = np.zeros(b, np.int32)
        for er in members:
            commit[er.slot] = er.finish is None
            # a row that has not frozen has generated gen0 + n*K tokens
            # when this burst starts; a frozen row's draw is never read
            ctrs[er.slot] = self._chain_gen0[er.slot] + n * k_steps
        w = cfg.kv_width_bucket(max(len(er.block_ids) for er in live))
        btab = hs.btab[:, :w].copy()
        want_top = any(er.logprobs_n > 0 for er in members)
        # guided members ride the device transition table: ONE table per
        # chain (_chain_block_reason enforced it), their bias rows reset to
        # logit_bias only so the in-burst mask is not applied twice (the
        # barrier reinstalls the host mask)
        gtable_dev = None
        guided_live = [er for er in live if er.guided is not None]
        if guided_live:
            table = self._guided_tables[
                self._guided_table_key(guided_live[0])]
            gtable_dev = table.device(
                self.runner.guided_state_bucket(table.n_states),
                self.runner.device)
            for er in guided_live:
                if not er.chain_bias_reset:
                    self._set_plain_bias(er)
                    er.chain_bias_reset = True
        if self._chain_carry is None:
            carry = self._chain_fill(live)
        else:
            carry = self._chain_carry
        tokens0, positions0, gen0, done0, ring0, gstate0 = carry

        toks, lps, tv, ti, self._chain_carry = self.runner.decode_burst_chained(
            tokens0, positions0, gen0, done0, btab,
            hs.temp, hs.top_k, hs.top_p,
            min_p=hs.min_p, presence_penalty=hs.pres,
            frequency_penalty=hs.freq, repetition_penalty=hs.rep,
            seed_keys=hs.keys, counters=ctrs, commit=commit,
            stop_ids=hs.stop_ids, min_new=hs.min_new, max_new=hs.max_new,
            ring0=ring0, gstate0=gstate0,
            stop_hash=hs.stop_hash, stop_hlen=hs.stop_hlen,
            gtable=gtable_dev, want_top=want_top,
        )
        self._chain_dispatched += 1
        self.steps += 1
        self.decode_steps += 1
        self.pipeline_bursts += 1
        self._chain.append(_InflightBurst(
            active=list(live),
            out=self.runner.stage_to_host(toks, lps, tv, ti),
            k_steps=k_steps, last_tokens=None, device_finish=True,
        ))
        await self._chain_drain(loop, members)

    def _logit_bias_onto(self, er: EngineRequest, row: np.ndarray) -> np.ndarray:
        """``row`` plus the request's logit_bias entries."""
        for tid, bv in (er.req.sampling_options.logit_bias or {}).items():
            tid = int(tid)
            if 0 <= tid < len(row):
                row[tid] += float(bv)
        return row

    def _set_plain_bias(self, er: EngineRequest) -> None:
        """Reset one slot's bias row to the request's logit_bias alone: a
        device-table chain computes the guided mask in the burst, so the
        host-installed mask must not apply a second time."""
        self.runner.set_bias_row(er.slot, self._logit_bias_onto(
            er, np.zeros(self.config.model.vocab_size, np.float32)))

    def _reinstall_guided_mask(self, er: EngineRequest) -> None:
        """Back to host-masked guided decoding (chain closed): rebuild the
        dense mask from the CURRENT cursor state. The drain advanced the
        host cursor token by token, so it is exact."""
        self.runner.set_bias_row(
            er.slot, self._logit_bias_onto(er, self._guided_mask(er)))

    async def _chain_barrier(self, loop) -> None:
        """Host barrier: reconcile every queued chained burst and close
        the chain, the ONLY place chain membership compacts. Runs before
        admission-driven sync passes, preemption and shutdown."""
        if not self._chain and not self._chain_members:
            return
        bursts = self._chain_dispatched
        while self._chain:
            await self._apply_chain_head(loop)
        for er in self._chain_members:
            er.chain_fp = False
            if er.chain_bias_reset:
                er.chain_bias_reset = False
                if er.finish is None and er.guided is not None:
                    self._reinstall_guided_mask(er)
        if bursts:
            self._last_chain_len = bursts
            self.chain_len_max = max(self.chain_len_max, bursts)
        self._chain_members = []
        self._chain_carry = None
        self._chain_dispatched = 0
        self._chain_pos0 = {}
        self._chain_gen0 = {}
        self._chain_fp = False

    # ---------- guided decoding on the synchronous path ----------

    def _guided_allowed_ids(self, er: EngineRequest) -> List[int]:
        """Token ids the constraint permits next, plus the eos ids wherever
        the constrained output may legally end (a terminal trie node)."""
        v = self.config.model.vocab_size
        ids, at_end = er.guided.allowed()
        allowed = [t for t in ids if 0 <= t < v]
        if at_end:
            allowed.extend(int(e) for e in er.req.eos_token_ids or []
                           if 0 <= int(e) < v)
        return allowed

    def _guided_mask(self, er: EngineRequest) -> np.ndarray:
        """Dense [V] additive mask for the NEXT sampled token: 0 for the
        allowed ids, a large negative everywhere else. Used at admission
        (set_sample_row); per-step updates edit sparsely instead."""
        mask = np.full(self.config.model.vocab_size, -1e9, np.float32)
        er.guided_allowed = self._guided_allowed_ids(er)
        mask[er.guided_allowed] = 0.0
        return mask

    def _guided_after_token(self, er: EngineRequest,
                            edit: bool = True) -> None:
        """Advance the constraint past the just-sampled token; install the
        next mask, or finish when the constraint completes. Runs between
        _check_finish and _emit so the completing token still streams.

        ``edit=False`` (the chained drain): advance the cursor and judge
        verdicts only. The device computed this token's mask from the
        transition table, and the barrier reinstalls the host mask if the
        row ever returns to the sync path."""
        if er.guided is None or er.finish is not None:
            return
        key_before = er.guided.state_key()
        if er.guided.advance(er.pending_token) != "ok":
            # "done": the final choice token. "derail": eos at a legal end
            # point (eos is never in the constraint's own alphabet)
            er.finish = FinishReason.STOP
            return
        if not edit or er.guided.state_key() == key_before:
            return
        # sparse edit: only the old node's and the new node's neighborhoods
        # change: O(branching), not O(vocab), per token
        user_bias = er.req.sampling_options.logit_bias or {}
        new_allowed = self._guided_allowed_ids(er)
        if not new_allowed:
            # dead state mid-stream: stop at the valid prefix instead of
            # emitting an unconstrained token through an all-banned mask
            er.finish = FinishReason.STOP
            return
        new_set = set(new_allowed)
        changed = list(new_set | set(er.guided_allowed))
        vals = [(0.0 if t in new_set else -1e9)
                + float(user_bias.get(t, 0.0))
                for t in changed]
        self.runner.edit_bias_entries(er.slot, changed, vals)
        er.guided_allowed = new_allowed

    def _preempt(self, er: EngineRequest) -> None:
        """Return a request to the waiting queue, releasing its blocks.
        Tokens already emitted are preserved: re-admission re-prefills
        ``prompt + resume_tokens`` and the stream continues."""
        self.preemptions += 1
        er.ctx.add_stage("preempted")
        if er.slot >= 0:
            self.slots[er.slot] = None
            er.slot = -1
        self.allocator.free_blocks(er.block_ids)
        er.block_ids = []
        # seq mirrors tokens whose KV was written; everything past the
        # prompt is generated output, plus the not-yet-written pending one
        gen = er.seq.token_ids[len(er.prompt):] if er.seq is not None else []
        if er.pending_token >= 0:
            gen = gen + [er.pending_token]
        er.resume_tokens = list(gen)
        er.context_len = 0
        er.num_cached = 0
        er.pending_token = -1
        er.seq = None
        er.registered_blocks = 0
        er.prefill_tokens = []
        er.prefill_pos = 0
        er.prompt_lp_parts = []
        # er.generated keeps its value: max_tokens accounting and the
        # sampling step counters continue, not restart
        self.waiting.appendleft(er)

    def _check_finish(self, er: EngineRequest, token: int
                      ) -> Optional[FinishReason]:
        """Per-token finish verdict off the admission-time classification."""
        if er.generated >= er.fin_min_new:
            # eos/stops suppressed below min_tokens; ignore_eos already
            # emptied fin_eos at classification
            if token in er.fin_eos:
                return FinishReason.EOS
            if token in er.fin_stop:
                return FinishReason.STOP
            if er.fin_stop_seqs:
                tail = tuple(er.ring_tail)
                for seq in er.fin_stop_seqs:
                    length = len(seq)
                    if (er.generated >= length
                            and len(tail) >= length
                            and tail[-length:] == seq):
                        return FinishReason.STOP
        if er.generated >= er.fin_max_new:
            return FinishReason.LENGTH
        if er.context_len + 1 >= self.config.max_model_len:
            return FinishReason.LENGTH
        return None
