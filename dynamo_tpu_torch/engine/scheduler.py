"""Continuous-batching scheduler: the synchronous serving path.

The port of ``dynamo_tpu/engine/scheduler.py`` at the reference's
synchronous config (``decode_pipeline_depth`` <= 1): an asyncio loop
interleaving batched, chunked, bucketed prefills with batched decode over
a fixed set of slots — one token per step, a fused K-step burst
(``multi_step_decode``) while no prefill work waits, or an ngram
speculative verify step (``spec_ngram_tokens``) while every active row is
greedy and penalty-free. Per-request state tracks paged blocks, chained
block hashes (the prefix cache) and cooperative cancellation; KV OOM
preempts a request back to the waiting queue and its re-prefill continues
the emitted stream.

Not in this slice (later work, refused by ``EngineConfig``): pipelined and
chained decode, draft-model speculation, guided decoding,
sequence-parallel prefill, remote prefill, fabric pulls, migration, fault
injection, the flight recorder and the stall watchdog.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from collections import deque
from typing import List, Optional

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
from .model_runner import ModelRunner
from .sampling import host_row, seed_to_key

logger = logging.getLogger(__name__)

# trailing emitted tokens kept per request for the exact stop-sequence check
SUFFIX_RING_W = 32


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


def build_prefill_arrays(cfg: EngineConfig, prompt: List[int], num_cached: int,
                         block_ids: List[int], bucket: Optional[int] = None):
    """Batch-of-1 arrays for one bucketed prefill step: (tokens, positions,
    block_tables, slot_mapping, context_lens, last_idx) — the leading
    arguments of ``ModelRunner.step``. Pass ``bucket`` to pad to a
    caller-chosen bucket."""
    suffix = prompt[num_cached:]
    bucket = bucket or cfg.bucket_for(len(suffix))
    w = cfg.blocks_per_seq
    bs = cfg.kv_block_size

    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, : len(suffix)] = suffix
    positions = np.full((1, bucket), num_cached + len(suffix) - 1, np.int32)
    positions[0, : len(suffix)] = np.arange(num_cached, len(prompt))
    slot_map = np.full((1, bucket), -1, np.int32)
    for i, pos in enumerate(range(num_cached, len(prompt))):
        slot_map[0, i] = block_ids[pos // bs] * bs + pos % bs
    btab = np.zeros((1, w), np.int32)
    btab[0, : len(block_ids)] = block_ids
    ctx_lens = np.asarray([len(prompt)], np.int32)
    last_idx = np.asarray([len(suffix) - 1], np.int32)
    return tokens, positions, btab, slot_map, ctx_lens, last_idx


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
    # telemetry: monotonic time of the last token emission (0 = none yet)
    last_emit_t: float = 0.0
    # the admission-time finish classification (see classify_finish)
    fin_eos: frozenset = dataclasses.field(default_factory=frozenset)
    fin_stop: frozenset = dataclasses.field(default_factory=frozenset)
    fin_min_new: int = 0
    fin_max_new: int = 16384
    fin_stop_seqs: tuple = ()
    # trailing emitted tokens (prompt + generated, ending with the pending
    # token): feeds the exact stop-sequence check
    ring_tail: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=SUFFIX_RING_W)
    )

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
        seqs = [tuple(int(t) for t in s)
                for s in (sc.stop_token_seqs or []) if s]
        # canonical-tokenization stop strings are checked exactly on the
        # host; text-level matching stays the detokenizer's job
        self.fin_stop_seqs = tuple(seqs) if sc.stop and seqs else ()

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
        n = len(er.block_ids)
        self.btab[i, :n] = er.block_ids
        self.btab[i, n:] = 0
        self.synced_blocks[i] = n

    def sync_blocks(self, er: "EngineRequest") -> None:
        """Mirror a live row's grown block list."""
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


class Scheduler:
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
                    self._finish(er, FinishReason.CANCELLED)

            # local admission: claim a slot + blocks, join the prefill batch
            while (self.waiting
                   and len(self.prefilling) < self.config.max_prefill_batch
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

            # decode every active slot: one token, an ngram speculative
            # verify, or a fused K-step burst — prefill work pins K to 1 so
            # chunked-prefill interleaving (bounded TTFT) is never traded
            # for throughput
            active = [s for s in self.slots
                      if s is not None and s not in self.prefilling]
            if active:
                runner_idle = not (self.prefilling or self.waiting)
                if (self.config.spec_ngram_tokens > 0 and runner_idle
                        and all(self._spec_eligible(er) for er in active)):
                    await self._decode_spec(loop, active)
                else:
                    k_steps = self.config.multi_step_decode
                    if k_steps > 1 and not runner_idle:
                        k_steps = 1
                    await self._decode(loop, active, k_steps)
                progressed = True

            if not progressed:
                self.wake.clear()
                if not self.waiting and not any(self.slots):
                    await self.wake.wait()
                else:
                    await asyncio.sleep(0.001)
            else:
                await asyncio.sleep(0)  # let I/O run between steps

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
        # penalty state for the slot: prompt presence + (on resume) counts
        # of the already-generated tokens
        self.runner.set_sample_row(
            slot, er.prompt, er.resume_tokens,
            logit_bias=er.req.sampling_options.logit_bias,
        )
        self.prefilling.append(er)

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
            self._emit(er, token, float(lpn[i]) if er.want_logprobs else None,
                       self._top_row(er, tv, ti, i), prompt_lps=prompt_lps)
            if er.finish is not None:
                self._finish(er, er.finish, emit=False)

    def _spec_eligible(self, er: EngineRequest) -> bool:
        """Speculative verify preserves the exact stream only for greedy,
        penalty-free, bias-free requests that want no logprobs: the verify
        step's raw argmax must equal what sequential sampling would pick,
        and per-position logprobs are not computed."""
        return (er.temperature == 0.0
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
            next_tokens, lps, top_vals, top_ids = self.runner.decode_burst(
                tokens[:, 0], positions[:, 0], btab, temp, hs.top_k, hs.top_p,
                min_p=hs.min_p, presence_penalty=hs.pres,
                frequency_penalty=hs.freq, repetition_penalty=hs.rep,
                seed_keys=hs.keys, counters=ctrs, commit=commit,
                want_top=want_top,
            )
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

        def _sync_step():
            return (next_tokens.cpu().numpy(), lps.cpu().numpy(),
                    top_vals.cpu().numpy(), top_ids.cpu().numpy())

        toks, lpn, tv, ti = await loop.run_in_executor(None, _sync_step)
        self.steps += 1
        self.decode_steps += 1
        if k_steps == 1:
            # [B] → [1, B] so the emit loop below is one shape
            toks, lpn, tv, ti = toks[None], lpn[None], tv[None], ti[None]

        # emit in step order; a request that finishes at step j has its
        # trailing burst tokens discarded — their KV went into its own
        # unregistered blocks, which are freed with the request
        for j in range(k_steps):
            for er in active:
                if er.finish is not None:
                    continue
                token = int(toks[j, er.slot])
                self._advance_row(er, token)
                self._emit(
                    er, token,
                    float(lpn[j, er.slot]) if er.want_logprobs else None,
                    self._top_row(er, tv[j], ti[j], er.slot),
                )
                if er.finish is not None:
                    self._finish(er, er.finish, emit=False)

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
