"""Continuous-batching scheduler: the synchronous path and the persistent
decode loop.

The port of ``dynamo_tpu/engine/scheduler.py``: an asyncio loop
interleaving batched, chunked, bucketed prefills with batched decode over
a fixed set of slots. A decode pass is one token per step, a fused K-step
burst (``multi_step_decode``) while no prefill work waits, a speculative
verify step while every active row is greedy and penalty-free (proposals
from the row's own history, ``spec_ngram_tokens``, or from a draft model's
K + 1-step burst, ``spec_draft_model``, whose paged cache mirrors the
target's block ids: every prefill chunk and per-token step replays on the
draft), or, with ``decode_pipeline_depth=2``:

- a dispatch-ahead burst (``_decode_pipelined``): burst k+1 goes to the
  device before burst k's tokens are read on the host, finishes are
  detected one burst late and the over-decoded tail is rolled back;
- a chained burst (``_decode_chained``, ``device_finish``): bursts are
  dispatched back to back off a device-resident carry, finished rows
  freeze on the device (eos, hidden stop ids, ``max_tokens``, the
  model-len horizon, stop sequences by suffix hash, guided choices and
  bounded JSON grammars by a device transition table) and a queue of
  in-flight bursts drains asynchronously. Every pass that could not chain is counted under a
  named reason (``metrics()["sync_fallback"]``);
- a chained propose-verify round (``_decode_chained_spec``): speculation
  inside the chained loop, the ngram proposals drawn on the device from the
  carry's suffix ring or the draft's burst run on the same carry, verified
  by one S = K + 1-position forward whose accepted prefix folds into the
  carry, with no host barrier between rounds.

A burst's outputs travel to the host through pinned buffers and an event
recorded right behind the burst (``ModelRunner.stage_to_host``), so
reconciling burst k never waits for burst k+1.

With ``sp_size > 1`` a prompt whose uncached suffix reaches
``long_prefill_threshold_tokens`` takes the sequence-parallel ladder
instead: one prompt at a time advances one SP chunk per pass, dispatch-only,
while the other streams keep decoding; its final chunk's sampled token
feeds a decode burst on the device (the early handoff) before the one host
sync that drains both.

With a ``RemotePrefillCoordinator`` (``disagg``), a prompt the router
sends to the prefill pool holds its blocks in ``pending_remote`` until the
prefill worker has streamed its KV into them and committed the first
token; the row then enters the decode loop as a local prefill's would
(``_install_remote``). Past the coordinator's timeout the request falls
back to a local prefill.

With ``host_kv_blocks`` the allocator offloads evicted HBM blocks to the
host tier (``kv/host_tier.py``) and restores them on a prefix hit; the
staged copies are drained once the pass's device work is dispatched. With
``cold_tier_blocks`` the host tier's evictions spill to the cold tier
(``kv/cold_tier.py``), and with it or ``prefix_pull`` the cluster KV
fabric (``kv/fabric.py``) plans prefix pulls, admitted before anything
else: a request whose prefix a peer (or the cold tier) holds past every
local tier reserves its blocks and waits in ``pending_pull`` while the
blocks stream in; a commit registers them and the tail prefills locally,
any failure falls back to a local prefill with the same stream.

Per-request state tracks paged blocks, chained block hashes (the prefix
cache), the guided cursor (a choice trie built at admission, or the JSON
cursor the serving facade attaches, reset and re-walked at admission and
at a preemption's resume) and cooperative cancellation; KV OOM
preempts a request back to the waiting queue and its re-prefill continues
the emitted stream.

The drain and watchdog surface (``recovery/``, ``telemetry/watchdog.py``):
``draining`` gates every admission (local, remote prefill, prefix pull)
and rides ``metrics()``, so KV routers skip the worker; ``seize`` stops the
loop, gracefully (its exit barriers reconcile every dispatched burst) or
hard (the in-flight and chained bursts are abandoned; their tokens were
never emitted); ``extract_requests`` detaches every live request for the
recovery controller to migrate or fail; ``admit_migrated`` installs one
that a draining peer shipped, hot over its scattered KV or cold into the
waiting queue for a re-prefill of ``prompt + resume_tokens``.
``last_loop_t`` is stamped at the top of every pass for
``watchdog_probe``; ``request_table`` is a flight artifact's request
table. The executor-side host sync of a decode step and of a burst is the
``decode_burst_hang`` chaos site (``utils/faults.py``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
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
from ..telemetry.flight import flight_recorder
from ..telemetry.registry import MetricsRegistry
from ..utils import faults
from .block_allocator import BlockAllocator, KvEventSink
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


def _host_sync(out: HostCopy):
    """The executor side of a decode step's or a burst's host sync: wait
    for its staged outputs. The chaos site ``decode_burst_hang`` wedges THIS
    thread, the shape of a dead device mid-sync (``utils/faults.py``)."""
    faults.maybe_hang("decode_burst_hang")
    return out.numpy()


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
    # admission from guided_choice_token_ids, or the JsonConstraint the
    # serving facade attaches) and the token ids its mask currently allows
    # (for sparse bias edits)
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
    # disaggregated prefill: the commit's future, its deadline (past it the
    # request falls back to a local prefill), one remote attempt per
    # request, and the backoff after a rejection on the prefix-hit term
    remote_future: Optional[asyncio.Future] = None
    remote_deadline: float = 0.0
    remote_attempted: bool = False
    remote_backoff_until: float = 0.0
    # cluster-KV-fabric prefix pull: the in-flight pull (a _PendingPull
    # while queued in pending_pull), one attempt per request (a fallback
    # must not loop), and whether a committed pull pre-allocated this
    # request's blocks (``_start_prefill`` then skips the allocation)
    pull: Optional[object] = None
    pull_attempted: bool = False
    pull_ready: bool = False
    # no re-plan before this monotonic time (a no-plan outcome holds on
    # the loop's ~1 ms cadence: the ownership view changes on event cadence)
    pull_backoff_until: float = 0.0
    # held out of LOCAL admission while another request's in-flight pull
    # fetches (part of) this prompt's prefix; cleared early by that pull's
    # commit or fallback, bounded by its deadline
    pull_hold_until: float = 0.0

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
class _PendingPull:
    """One in-flight prefix pull (a ``pending_pull`` entry).

    The request holds its full prompt allocation; ``targets`` (the pull's
    destination blocks) are PINNED for the duration so nothing reclaims a
    slot with a scatter in flight. The scheduler pins at submit and unpins
    at reap: commit, fallback, cancel and stop all go through
    ``_release_pull``."""

    plan: object                    # kv.fabric.PullPlan
    task: asyncio.Task              # the fabric.pull coroutine
    targets: List[int]              # destination block ids (pinned)
    hashes: List[int]               # the prompt's full hash chain
    deadline: float                 # monotonic fallback deadline


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
    # a chained propose-verify round: [S, B] tokens with -1 pads past each
    # row's acceptance, and ``out`` carries the per-row proposed and
    # accepted counts after them (no logprobs: spec rows want none)
    spec: bool = False
    # device-time accounting (telemetry/device_time.py): the dispatch time,
    # and the HBM bytes this burst must stream and the tokens it samples,
    # fixed at dispatch
    dispatch_t: float = 0.0
    read_bytes: float = 0.0
    tokens: int = 0


class Scheduler:
    # bursts allowed in flight ahead of the asynchronous drain: beyond this
    # the dispatcher waits out the oldest sync (the device has this many
    # bursts queued, so it cannot run dry while the host catches up), and
    # the per-burst output buffers stay bounded
    CHAIN_MAX_INFLIGHT = 4
    # compiled guided tables kept for at most this many distinct choice
    # lists or JSON specs: each is a dense [states, vocab] int32. LRU;
    # eviction is safe mid-chain because every chained pass re-checks
    # presence before the dispatch reads the cache (a missing table just
    # recompiles)
    GUIDED_TABLE_CACHE = 16

    def __init__(self, runner: ModelRunner, config: EngineConfig,
                 events: Optional[KvEventSink] = None, disagg=None,
                 draft_runner: Optional[ModelRunner] = None):
        self.runner = runner
        self.config = config
        # the flight ring the drain surface records into (the process-wide
        # one unless a test injects its own)
        self.flight = flight_recorder()
        # draft-model speculation: the draft's paged cache mirrors the
        # target's block ids (every prefill chunk and per-token step replays
        # on the draft) and the decode loop proposes with its K + 1-step
        # burst
        self.draft = draft_runner
        # Optional[RemotePrefillCoordinator]: conditional remote prefill
        self.disagg = disagg
        # requests whose prefill runs on a prefill worker (blocks held,
        # waiting for the commit)
        self.pending_remote: List[EngineRequest] = []
        # the KV tiers' and the fabric's instruments
        self.registry = MetricsRegistry()
        # KV events (a worker's publisher): stored on registration, removed
        # on eviction or release, as the reference's allocator emits them;
        # the cold pair on the cold tier's spills and evictions
        sink = events or KvEventSink()
        tier2 = None
        if config.host_kv_blocks > 0:
            from ..kv import KvHostTier

            tier2 = KvHostTier(runner, config.host_kv_blocks)
        cold = None
        if config.cold_tier_blocks > 0:
            from ..kv import KvColdTier
            from ..ops.host_xxh64 import checksum_for

            # the host tier's evictions survive to disk; residency is
            # advertised through the cold event hooks
            cold = KvColdTier(
                config.cold_tier_dir, config.cold_tier_blocks,
                registry=self.registry,
                on_stored=lambda hashes, parent: sink.on_stored_cold(
                    hashes, parent),
                on_removed=lambda hashes: sink.on_removed_cold(hashes),
                checksum=checksum_for(runner.device))
            tier2.on_evict = cold.offer
        self.allocator = BlockAllocator(
            config.num_kv_blocks, config.kv_block_size,
            config.enable_prefix_caching, sink, tier2=tier2,
        )
        # the cluster KV fabric: peer prefix pulls and cold rehydration,
        # built whenever either is configured; the CLI wiring attaches the
        # peer view (event feed, pull-server descriptors)
        self.fabric = None
        if (config.prefix_pull or cold is not None) \
                and config.enable_prefix_caching:
            from ..kv import KvFabric

            self.fabric = KvFabric(
                runner, self.allocator, engine_id=f"eng-{id(self):x}",
                block_size=config.kv_block_size, cold=cold,
                peer_pull=config.prefix_pull,
                min_pull_blocks=config.prefix_pull_min_blocks,
                pull_timeout_s=config.prefix_pull_timeout_s,
                registry=self.registry)
        self.pending_pull: List[EngineRequest] = []
        # pull outcomes on this engine: commits, and fallbacks by reason
        self.pull_commits = 0
        self.pull_fallbacks: Dict[str, int] = {}
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
        # drain gate (recovery/): True stops ALL admission (local slot
        # claims, remote-prefill submits, prefix pulls) while committed work
        # proceeds; exported in metrics() so the KV router skips this worker
        self.draining = False
        # watchdog heartbeat: stamped at the top of EVERY loop pass, so a
        # loop wedged INSIDE a pass (a dead device's host sync) goes stale
        # while a healthy but waiting loop stays fresh
        self.last_loop_t = time.monotonic()
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
        # the chain's program family: "plain" bursts or "spec" rounds (a
        # switch closes the chain at a barrier)
        self._chain_kind: Optional[str] = None
        self._last_chain_len = 0
        self.chain_len_max = 0
        self.device_finished_rows = 0
        self.sync_fallback: Dict[str, int] = {}
        # compiled guided device tables by choice list or JSON spec (None =
        # past the state bound) and the executor compiles in flight
        self._guided_tables: Dict[tuple, object] = {}
        self._guided_table_futs: Dict[tuple, object] = {}
        # the runner's first-dispatch series and live device time render in
        # this scrape; observations feed at the loop's EXISTING host
        # reconciliation seams (executor host syncs, HostCopy readiness
        # probes), never an added sync (test doubles carry no trackers)
        for tracker in (getattr(runner, "compiles", None),
                        getattr(runner, "device_time", None)):
            if tracker is not None:
                self.registry.attach(tracker.registry)
        self.device_time = getattr(runner, "device_time", None)
        self._register_gauges()

    def _register_gauges(self) -> None:
        """The reference's load gauges, by its names (a worker's
        ``--metrics-port`` sidecar renders them; the fleet hub's per-worker
        rows read them). Render callbacks run off the loop: they count over
        ``list()`` snapshots."""
        reg = self.registry
        active = lambda: sum(1 for s in list(self.slots) if s is not None)  # noqa: E731
        for name, help_, fn in (
            ("dynamo_kv_active_blocks", "KV blocks in use",
             lambda: self.allocator.used),
            ("dynamo_kv_block_usage_ratio", "used / total KV blocks",
             self.allocator.usage),
            ("dynamo_scheduler_active_slots",
             "Batch slots currently decoding or prefilling", active),
            ("dynamo_scheduler_slot_occupancy_ratio",
             "active_slots / total_slots",
             lambda: active() / max(1, self.config.max_batch_size)),
            ("dynamo_scheduler_waiting_requests",
             "Admission queue depth (local waiting + pending remote prefill "
             "+ pending prefix pulls)",
             lambda: (len(self.waiting) + len(self.pending_remote)
                      + len(self.pending_pull))),
            ("dynamo_scheduler_draining_info",
             "1 while this engine is gated for drain/recovery (admission "
             "refused, routers skip it)", lambda: float(self.draining)),
            ("dynamo_kv_prefix_hit_ratio",
             "Prompt tokens served from the prefix cache / all prompt tokens",
             lambda: (self.prefix_hit_tokens / self.prefix_total_tokens
                      if self.prefix_total_tokens else 0.0)),
        ):
            reg.callback_gauge(name, help_, fn)

    # ---------- public API ----------

    def start(self) -> None:
        # any first dispatch past this point interrupts live serving: the
        # tracker tags it "late" (the recompile-storm signal)
        for r in (self.runner, self.draft):
            compiles = getattr(r, "compiles", None)
            if compiles is not None:
                compiles.mark_serving_started()
        if self.fabric is not None and self.fabric.cold is not None:
            # restart-warm on every embedding: prime the cold index off the
            # loop so spilled prefixes survive a restart (refresh() is
            # idempotent; the CLI's distributed wiring primes it too)
            self.fabric.hold_task(asyncio.get_running_loop().run_in_executor(
                None, self.fabric.cold.refresh))
        self._task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        self._stopping = True
        self.wake.set()
        if self._task:
            await self._task
        for er in self.pending_remote:
            self.disagg.cancel(er.request_id)
            self._finish(er, FinishReason.CANCELLED)
        self.pending_remote.clear()
        for er in self.pending_pull:
            self._release_pull(er)
            self._finish(er, FinishReason.CANCELLED)
        self.pending_pull.clear()
        if self.fabric is not None:
            await self.fabric.close()
        if self.disagg is not None:
            await self.disagg.close()

    def _prepare_request(self, er: EngineRequest) -> None:
        """Per-request host fields shared by local admission and a migrated
        admission (everything but the PRNG key, which a migrated request
        brings along)."""
        so = er.req.sampling_options
        (er.temperature, er.top_k, er.top_p, er.min_p, er.presence_penalty,
         er.frequency_penalty, er.repetition_penalty) = host_row(so)
        # logprobs is a COUNT: 0 = chosen token's logprob with no
        # alternatives (None = off)
        er.want_logprobs = er.req.output_options.logprobs is not None
        er.logprobs_n = int(er.req.output_options.logprobs or 0)
        er.want_prompt_lps = er.req.output_options.prompt_logprobs is not None

    def add_request(self, er: EngineRequest) -> None:
        self._prepare_request(er)
        so = er.req.sampling_options
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
        """The reference's keys under the reference's conditions (each
        feature's counters only while the feature is on; ``draining``
        always: KV routers exclude a draining worker from every decision;
        the coordinator's ``remote_prefill_*`` keys with a disagg
        coordinator), beside the port's own counters that no reference key
        carries."""
        active = sum(1 for s in self.slots if s is not None)
        out = {
            "request_active_slots": active,
            "request_total_slots": self.config.max_batch_size,
            "kv_active_blocks": self.allocator.used,
            "kv_total_blocks": self.allocator.num_blocks,
            "num_requests_waiting": (len(self.waiting) + len(self.pending_remote)
                                     + len(self.pending_pull)),
            "gpu_cache_usage_perc": self.allocator.usage(),
            "gpu_prefix_cache_hit_rate": (
                self.prefix_hit_tokens / self.prefix_total_tokens
                if self.prefix_total_tokens else 0.0
            ),
            "draining": self.draining,
            # the counts behind the rate: a router's scrape reads which
            # worker served a prefix from its cache
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_total_tokens": self.prefix_total_tokens,
            "steps": self.steps,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "preemptions": self.preemptions,
            "sp_chunks": self.sp_chunks,
            "sp_tokens": self.sp_tokens,
            "sp_handoffs": self.sp_handoffs,
            "chain_len_max": max(self.chain_len_max, self._chain_dispatched),
            "device_finished_rows": self.device_finished_rows,
            "sync_fallback": dict(self.sync_fallback),
        }
        if self.config.spec_ngram_tokens or self.draft is not None:
            out["spec_proposed_tokens"] = self.spec_proposed
            out["spec_accepted_tokens"] = self.spec_accepted
        if self.config.decode_pipeline_depth >= 2:
            out["decode_pipeline_bursts"] = self.pipeline_bursts
        if self.config.device_finish_enabled:
            out["decode_burst_chain_length"] = (
                self._chain_dispatched or self._last_chain_len)
        if self.allocator.tier2 is not None:
            out.update(self.allocator.tier2.metrics())
        if self.fabric is not None and self.fabric.cold is not None:
            out.update(self.fabric.cold.metrics())
        if self.disagg is not None:
            out.update(self.disagg.metrics())
        return out

    def fabric_stats(self) -> dict:
        """The fabric's counters and this engine's pull outcomes (a
        worker's stats scrape carries them beside ``metrics()``)."""
        out = dict(self.fabric.stats()) if self.fabric is not None else {}
        out.update(pull_commits=self.pull_commits,
                   pull_fallbacks=dict(self.pull_fallbacks),
                   pending_pull=len(self.pending_pull))
        if self.fabric is not None and self.fabric.cold is not None:
            out["cold"] = self.fabric.cold.counts()
        return out

    # ---------- drain / migration surface (recovery/) ----------

    def set_draining(self, draining: bool = True) -> None:
        """Gate admission: committed work proceeds, nothing new starts. The
        flag rides the metrics() snapshot so KV routers skip this worker,
        and the watchdog treats a draining engine as stopping (gated queued
        work must not read as starvation)."""
        self.draining = draining
        self.wake.set()

    async def seize(self, hard: bool = False, timeout_s: float = 5.0) -> None:
        """Stop the loop for a drain.

        Graceful (``hard=False``) lets the loop run its exit barriers: every
        dispatched burst (the dispatch-ahead one, every chained one)
        reconciles and streams its tokens; past ``timeout_s`` it escalates
        to a cancel (a half-wedged loop must not hang the drain). Hard
        cancels at once: a loop wedged inside a pass (the watchdog-trip
        case) would never finish a barrier. Un-reconciled device work is
        abandoned: its tokens were never emitted, so the committed host
        state a migration packages stays exact."""
        self._stopping = True
        self.draining = True
        self.wake.set()
        task, self._task = self._task, None
        if task is not None:
            if not hard:
                try:
                    await asyncio.wait_for(asyncio.shield(task), timeout_s)
                except asyncio.TimeoutError:
                    logger.warning("graceful seize timed out after %.1fs; "
                                   "cancelling the scheduler loop", timeout_s)
                    hard = True
            if hard and not task.done():
                task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.exception("scheduler loop raised during seize")
        if self._inflight is not None or self._chain:
            self.flight.record("scheduler.burst_abandon",
                               inflight=self._inflight is not None,
                               chained=len(self._chain))
        self._inflight = None
        self._chain.clear()
        self._chain_members = []
        self._chain_carry = None
        self._chain_dispatched = 0
        self._chain_pos0 = {}
        self._chain_gen0 = {}
        self._chain_kind = None
        self._chain_fp = False

    def extract_requests(self) -> List[EngineRequest]:
        """Detach every live request (slots, the prefill batch, the SP
        ladder, the waiting queue, pending remote prefills and prefix pulls)
        WITHOUT finishing its stream: the recovery controller migrates or
        fails each one. Requests keep their block lists; the caller releases
        them (after a hot migration shipped the KV). Call after ``seize``."""
        out: List[EngineRequest] = []
        for i, er in enumerate(self.slots):
            if er is None:
                continue
            self.slots[i] = None
            er.slot = -1
            out.append(er)
        self.prefilling.clear()
        # SP mid-prefill requests migrate cold (partial KV never ships); a
        # dispatched chunk only writes their own blocks
        self.sp_queue.clear()
        self.sp_active = None
        while self.waiting:
            out.append(self.waiting.popleft())
        for er in self.pending_remote:
            if self.disagg is not None:
                self.disagg.cancel(er.request_id, reason="drain")
            er.remote_future = None
            out.append(er)
        self.pending_remote.clear()
        for er in self.pending_pull:
            # the in-flight pull aborts; the request migrates cold (its
            # blocks hold no registered KV: packaging frees them)
            self._release_pull(er)
            out.append(er)
        self.pending_pull.clear()
        for er in out:
            self.flight.record("scheduler.extract", request_id=er.request_id,
                               trace_id=er.ctx.trace_id, generated=er.generated,
                               blocks=len(er.block_ids))
        return out

    def admit_migrated(self, er: EngineRequest, committed_tokens: List[int],
                       block_ids: List[int]) -> bool:
        """Admit a request a draining peer migrated here.

        Hot (``block_ids`` non-empty, their KV already scattered): the row
        enters the decode loop directly, as a committed remote prefill's
        does, except that nothing is emitted here: every token up to and
        including the pending one already streamed from the source. Cold:
        it joins the waiting queue and the preemption-resume path
        re-prefills ``prompt + resume_tokens``, continuing the stream.
        Returns False (the caller frees the blocks and nacks) when no slot
        is free at install time."""
        self._prepare_request(er)
        if er.base_key is None:
            # a source state without the per-request key: a fresh one
            # (sampled continuations part from the undisturbed stream,
            # greedy ones do not)
            er.base_key = self._rng.integers(0, 2**32, size=2, dtype=np.uint32)
        er.ctx.add_stage("migration.resume")
        self.flight.record("scheduler.migrate_in", request_id=er.request_id,
                           trace_id=er.ctx.trace_id, hot=bool(block_ids),
                           generated=er.generated)
        if not block_ids:
            # cold: never a remote prefill for a resumed stream (the remote
            # path would restart from the prompt alone)
            er.remote_attempted = bool(er.resume_tokens)
            self.waiting.append(er)
            self.wake.set()
            return True
        slot = self._free_slot()
        if slot is None:
            return False
        er.slot = slot
        er.block_ids = list(block_ids)
        er.context_len = len(committed_tokens)
        er.num_cached = 0
        er.resume_tokens = []
        er.seq = TokenSequence(committed_tokens, block_size=self.config.kv_block_size)
        er.registered_blocks = 0
        # every fallible step runs BEFORE the slot publishes: a failed
        # install leaves this scheduler as it was (the host row written
        # here is inert while the slot stays empty)
        self._host.install(er)
        # penalty and noise state: presence of the prompt plus counts of
        # every generated token, the pending one included (sampled and
        # emitted; only its KV write is still owed). ``er.generated`` came
        # with the state: the noise counters continue, not restart
        tail = list(committed_tokens)
        if er.pending_token >= 0:
            tail.append(er.pending_token)
        er.ring_tail.clear()
        er.ring_tail.extend(tail[-SUFFIX_RING_W:])
        self.runner.set_sample_row(
            slot, er.prompt, tail[len(er.prompt):],
            logit_bias=er.req.sampling_options.logit_bias)
        # completed prefix blocks become matchable here too: a migrated
        # prefix seeds this worker's prefix cache
        self._register_completed_blocks(er)
        self.slots[slot] = er
        self.wake.set()
        return True

    # ---------- watchdog surface (telemetry/watchdog.py) ----------

    def watchdog_probe(self) -> dict:
        """The liveness snapshot the stall watchdog samples: the heartbeat
        of the last loop pass, the dispatch counter and the pending work by
        kind (local waiting, remote-prefill and prefix-pull waits, active
        slots)."""
        return {
            "heartbeat_t": self.last_loop_t,
            "steps": self.steps,
            "queue_depth": len(self.waiting),
            "pending_remote": len(self.pending_remote),
            # pull waits own their deadline (fallback to local), so the
            # watchdog must not read them as starvation
            "pending_pull": len(self.pending_pull),
            "active": sum(1 for s in self.slots if s is not None),
            # a draining engine's gated queue is recovery's, not a stall
            "stopping": self._stopping or self.draining,
        }

    def request_table(self) -> List[dict]:
        """The active requests for a flight artifact: every slot's occupant
        plus the waiting, pending-remote and pending-pull queues."""
        out = []
        for i, er in enumerate(self.slots):
            if er is None:
                continue
            out.append({
                "state": ("prefilling" if er in self.prefilling
                          else "sp_prefilling" if self._is_sp(er)
                          else "decoding"),
                "slot": i,
                "request_id": er.request_id,
                "trace_id": er.ctx.trace_id,
                "prompt_tokens": len(er.prompt),
                "generated": er.generated,
                "context_len": er.context_len,
                "blocks": len(er.block_ids),
                "guided": er.guided is not None,
            })
        for state, ers in (("waiting", list(self.waiting)),
                           ("pending_remote", self.pending_remote),
                           ("pending_pull", self.pending_pull)):
            out.extend({
                "state": state,
                "request_id": er.request_id,
                "trace_id": er.ctx.trace_id,
                "prompt_tokens": len(er.prompt),
                "generated": er.generated,
            } for er in ers)
        return out

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
            self.allocator.register_complete(
                er.block_ids[i], blk.sequence_hash, blk.parent_sequence_hash)
        er.registered_blocks = max(er.registered_blocks, n_complete)

    # ---------- the loop ----------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopping:
            progressed = False
            # watchdog heartbeat (telemetry/watchdog.py): a wedge INSIDE this
            # pass (a host sync on a dead device) leaves it stale
            self.last_loop_t = time.monotonic()

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

            # remote prefill completions, cancellations and timeouts
            if self.pending_remote:
                progressed |= self._reap_remote()

            # prefix-pull completions, fallbacks and timeouts
            if self.pending_pull:
                progressed |= self._reap_pulls()

            # admission, pulls first: a prefix pull is only a block
            # reservation and a transfer (no local compute), and a pulled
            # prefix shrinks the suffix every later decision sees
            if (self.fabric is not None and not self.draining
                    and self.fabric.may_hold_any()):
                for er in list(self.waiting):
                    if len(self.pending_pull) >= self.config.max_batch_size:
                        break
                    if self._try_submit_pull(er):
                        self.waiting.remove(er)
                        progressed = True

            # remote admission next: a prompt the router sends to the
            # prefill pool only holds blocks here until its commit
            unrouted = set()
            if self.disagg is not None and not self.draining:
                seen = list(self.waiting)
                for er in seen:
                    if len(self.pending_remote) >= self.config.max_batch_size:
                        break
                    if await self._try_submit_remote(er):
                        self.waiting.remove(er)
                        progressed = True
                # a request that arrived while a submit awaited its push has
                # not met the router yet: it waits for the next pass rather
                # than being prefilled here by default
                unrouted = {id(er) for er in self.waiting} - {id(er) for er in seen}

            # local admission: claim a slot + blocks, join the prefill batch.
            # A request held for an overlapping in-flight prefix pull is
            # skipped (not admitted to recompute what the pull is about to
            # install); everyone else keeps FIFO order.
            # Both ladders honour the prefill-batch cap: SP admissions hold
            # their WHOLE prompt's blocks while the single-owner ladder serves
            # one prompt at a time, so an unbounded sp_queue would pin the
            # block pool idle; oversize backlogs wait block-free in `waiting`
            cap = self.config.max_prefill_batch
            while (self.waiting
                   and not self.draining
                   and len(self.prefilling) < cap
                   and (len(self.sp_queue)
                        + (1 if self.sp_active is not None else 0) < cap)
                   and self._free_slot() is not None):
                now_h = time.monotonic()
                er = next((e for e in self.waiting
                           if e.pull_hold_until <= now_h), None)
                if er is None or id(er) in unrouted:
                    break  # everyone is held on a pull, or not yet routed
                try:
                    self._start_prefill(er)
                except MemoryError:
                    break  # no memory — wait for a sequence to finish
                self.waiting.remove(er)
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

            # decode every active slot: one token, a speculative verify
            # (ngram or draft proposals), a fused K-step burst, or — with
            # the dispatch-ahead pipeline — a chained propose-verify round,
            # a chained or a pipelined burst. Prefill work pins K to 1 so
            # chunked-prefill interleaving (bounded TTFT) is never traded
            # for throughput
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
                speculating = (self.config.spec_ngram_tokens > 0
                               or self.draft is not None)
                spec_now = (speculating and runner_idle
                            and all(self._spec_eligible(er) for er in active))
                chain_on = (self.config.device_finish_enabled
                            and self.config.decode_pipeline_depth >= 2)
                spec_reason = (self._spec_chain_reason(active, runner_idle)
                               if spec_now and chain_on else None)
                if spec_now and chain_on and spec_reason is None:
                    # persistent loop, speculative: propose-verify rounds
                    # off the device-resident carry, no host barrier
                    # between the draft's burst and the target's verify
                    await self._decode_chained_spec(loop, active)
                elif not spec_now and self._chain_ok(active, runner_idle):
                    # persistent loop: chain the next burst off the device-
                    # resident carry; finished rows freeze on the device
                    # and drain asynchronously
                    await self._decode_chained(loop, active)
                else:
                    if chain_on:
                        # every pass that did not chain is named
                        reason = (spec_reason if spec_now else
                                  self._chain_block_reason(active, runner_idle))
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
                            # the speculative verify (ngram or draft
                            # proposals) on the synchronous path
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

            # file the staged host-tier offloads now that this pass's device
            # work is dispatched: the copies overlapped it, so the drain
            # waits only on a straggler
            if self.allocator.tier2 is not None:
                self.allocator.tier2.drain()

            if not progressed:
                self.wake.clear()
                # about to sleep: request-starved idle is not a pipeline
                # bubble of the device-time estimator
                if self.device_time is not None:
                    self.device_time.idle()
                if not self.waiting and not any(self.slots):
                    if self.pending_remote or self.pending_pull:
                        # wake on a commit; the bounded wait keeps the
                        # remote and pull deadlines checked even if a
                        # stalled pull never completes its task
                        try:
                            await asyncio.wait_for(self.wake.wait(), 0.5)
                        except asyncio.TimeoutError:
                            pass
                    else:
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
        if er.pull_ready and er.block_ids:
            # a committed prefix pull already allocated the blocks,
            # scattered the pulled run and registered it (num_cached covers
            # local + pulled): only the tail prefills below
            er.pull_ready = False
        elif er.want_prompt_lps and not er.prompt_lps_emitted:
            # every prompt position must run through the model — blank the
            # probe's hits so allocation proceeds with zero cached tokens
            probe = self.allocator.probe_prefix(tokens_all)
            er.block_ids, er.num_cached = self.allocator.allocate_prompt(
                tokens_all, probe=(probe[0], [], []))
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
        elif er.guided is not None:
            er.guided.reset()  # a JSON cursor, attached by the serving facade
        if er.guided is not None:
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

    # ---------- cluster KV fabric: prefix pull (kv/fabric.py) ----------

    def _try_submit_pull(self, er: EngineRequest) -> bool:
        """Start a prefix pull for this waiting request?

        Engages when the fabric's ownership view (peer KV events, the cold
        tier's index) holds a longer prefix run than every local tier. The
        request reserves its FULL prompt allocation now (as a remote
        prefill's submit does), pins the pull's targets and waits in
        ``pending_pull`` while the blocks stream; the loop serves everyone
        else meanwhile. One attempt per request: any failure falls back to
        a plain local prefill with the same stream."""
        if (er.pull_attempted or er.resume_tokens
                or (er.want_prompt_lps and not er.prompt_lps_emitted)):
            # a resumed stream re-prefills prompt + resume (no pullable
            # chain for the generated tail); prompt logprobs need every
            # position through the model anyway
            return False
        if time.monotonic() < er.pull_backoff_until:
            return False
        probe = self.allocator.probe_prefix(er.prompt)
        hashes, local_blocks, host_hashes = probe
        n_local = len(local_blocks) + len(host_hashes)
        plan = self.fabric.plan(hashes, n_local, len(er.prompt))
        if plan is None:
            # nothing worth pulling now: do not re-hash the prompt on every
            # pass while the request queues
            er.pull_backoff_until = time.monotonic() + 0.25
            return False
        planned = set(plan.hashes)
        for other in self.pending_pull:
            if (other.pull is not None
                    and not planned.isdisjoint(other.pull.plan.hashes)):
                # a pull in flight fetches (part of) this run: its commit
                # registers the prefix for everyone, so HOLD this request
                # out of local admission until it resolves (commit and
                # fallback clear the hold early; its deadline bounds it)
                er.pull_backoff_until = time.monotonic() + 0.05
                er.pull_hold_until = other.pull.deadline
                return False
        try:
            er.block_ids, er.num_cached = self.allocator.allocate_prompt(
                er.prompt, probe=probe)
        except MemoryError:
            # transient: the pull stays worth trying once memory frees
            er.pull_backoff_until = time.monotonic() + 0.25
            return False
        bs = self.config.kv_block_size
        if er.num_cached // bs != plan.start_block:
            # the local hit shrank inside allocate_prompt (a host-tier
            # capacity eviction raced the probe): the planned run no longer
            # abuts the cached prefix, so abandon this plan
            self.allocator.free_blocks(er.block_ids)
            er.block_ids = []
            er.num_cached = 0
            er.pull_backoff_until = time.monotonic() + 0.25
            return False
        er.pull_attempted = True
        targets = er.block_ids[plan.start_block:plan.start_block + plan.blocks]
        self.allocator.pin_blocks(targets)
        task = asyncio.get_running_loop().create_task(
            self.fabric.pull(plan, targets, request_id=er.request_id,
                             trace_id=er.ctx.trace_id),
            name=f"kv-pull-{er.request_id[:8]}")
        task.add_done_callback(lambda _f: self.wake.set())
        er.pull = _PendingPull(
            plan=plan, task=task, targets=targets, hashes=hashes,
            deadline=time.monotonic() + self.fabric.pull_timeout_s)
        self.pending_pull.append(er)
        return True

    def _reap_pulls(self) -> bool:
        """Commit finished pulls; fall back on failures and deadlines."""
        progressed = False
        now = time.monotonic()
        for er in list(self.pending_pull):
            pp: _PendingPull = er.pull
            if er.ctx.is_stopped:
                self.pending_pull.remove(er)
                self._release_pull(er)
                self._finish(er, FinishReason.CANCELLED)
                # requests held on THIS pull must not wait out its deadline
                self._clear_pull_holds()
                progressed = True
            elif pp.task.done():
                self.pending_pull.remove(er)
                served, reason = 0, "empty"
                if not pp.task.cancelled():
                    try:
                        served = pp.task.result()
                    except Exception as e:
                        reason = "error"
                        logger.warning("prefix pull failed for %s (%s); local "
                                       "recompute fallback", er.request_id, e)
                if served > 0:
                    self._commit_pull(er, served)
                else:
                    self._fallback_pull(er, reason)
                progressed = True
            elif now > pp.deadline:
                # a dead or stalled source never holds the request: cancel
                # the transfer and recompute locally
                pp.task.cancel()
                self.pending_pull.remove(er)
                self._fallback_pull(er, "timeout")
                progressed = True
        return progressed

    def _release_pull(self, er: EngineRequest) -> None:
        """Unwind a pull's reservation state (task and pins). The blocks
        stay with the request: a commit registers them, a fallback or a
        finish frees them."""
        pp: _PendingPull = er.pull
        er.pull = None
        if not pp.task.done():
            pp.task.cancel()
        self.allocator.unpin_blocks(pp.targets)

    def _commit_pull(self, er: EngineRequest, served: int) -> None:
        """A pull landed ``served`` blocks: register the content-addressed
        prefix (matchable, with its KV events, as if this engine had
        computed it) and re-queue the request for its tail prefill."""
        pp: _PendingPull = er.pull
        self._release_pull(er)
        bs = self.config.kv_block_size
        for i in range(served):
            idx = pp.plan.start_block + i
            parent = pp.hashes[idx - 1] if idx > 0 else None
            self.allocator.register_complete(pp.targets[i], pp.hashes[idx], parent)
        er.num_cached += served * bs
        er.pull_ready = True
        er.ctx.add_stage("kv_fabric")
        self.pull_commits += 1
        self.waiting.appendleft(er)
        self._clear_pull_holds()
        self.wake.set()

    def _clear_pull_holds(self) -> None:
        """A pull resolved (commit or fallback): release every waiting
        request held for it; their next pass re-probes the new local state
        (after a commit the prefix is a local hit)."""
        for w in self.waiting:
            w.pull_hold_until = 0.0
            w.pull_backoff_until = 0.0

    def _fallback_pull(self, er: EngineRequest, reason: str) -> None:
        """The pull failed, expired or served nothing: release everything
        and recompute locally. The stream equals the no-fabric run's:
        nothing was registered, so the allocator's state is that of a fresh
        admission."""
        self._release_pull(er)
        self.allocator.free_blocks(er.block_ids)
        er.block_ids = []
        er.num_cached = 0
        er.ctx.add_stage("pull_fallback")
        self.pull_fallbacks[reason] = self.pull_fallbacks.get(reason, 0) + 1
        self.waiting.appendleft(er)
        self._clear_pull_holds()
        self.wake.set()

    # ---------- disaggregated prefill (decode side) ----------

    async def _try_submit_remote(self, er: EngineRequest) -> bool:
        """Conditional disagg: enqueue this prompt for a remote prefill?
        The reference's decision point: the router's verdict from the
        prompt length, the prefix-hit length and the queue depth, after the
        requests only the local path serves are kept local."""
        if er.remote_attempted:
            return False  # one remote attempt; a fallback prefills locally
        if er.pull_ready:
            # a committed prefix pull pre-allocated this request's blocks;
            # the (now small) tail prefills locally
            return False
        if time.monotonic() < er.remote_backoff_until:
            return False
        if er.resume_tokens:
            # a preempted stream: only the local path re-prefills prompt +
            # resume_tokens
            return False
        if er.want_prompt_lps:
            # prompt logprobs need every position's logits on this engine
            return False
        so = er.req.sampling_options
        if so.guided_choice_token_ids or so.guided_json or er.guided is not None:
            # the remote prefill samples the first token without the mask
            return False
        # the long-prefill admission class: past the threshold, prompts
        # prefer the prefill pool whatever the router says, unless this
        # engine runs the SP ladder itself
        threshold = self.config.long_prefill_threshold_tokens
        force_long = (threshold > 0
                      and not self.runner.sp_ready
                      and len(er.prompt) >= threshold)
        # a larger prefix hit only shrinks the suffix: a prompt that does
        # not qualify with hit 0 never does (saves hashing it every pass)
        if not force_long and not self.disagg.decide(len(er.prompt), 0):
            return False
        probe = self.allocator.probe_prefix(er.prompt)
        # host-tier blocks count as hit: restoring them locally is far
        # cheaper than a remote prefill round trip
        prefix_hit = self.allocator.cached_tokens(probe)
        if force_long and len(er.prompt) - prefix_hit < threshold:
            force_long = False
        if not force_long and not self.disagg.decide(len(er.prompt), prefix_hit):
            # not permanent: cached prefixes are evicted and the threshold
            # is live-tunable; back off instead of probing every pass
            er.remote_backoff_until = time.monotonic() + 0.25
            return False
        er.remote_attempted = True
        try:
            er.block_ids, er.num_cached = self.allocator.allocate_prompt(
                er.prompt, probe=probe)
        except MemoryError:
            return False
        try:
            er.remote_future = await self.disagg.submit(
                er.request_id, er.prompt, er.block_ids, er.num_cached,
                temperature=er.temperature, top_k=er.top_k, top_p=er.top_p,
                min_p=er.min_p, presence_penalty=er.presence_penalty,
                frequency_penalty=er.frequency_penalty,
                repetition_penalty=er.repetition_penalty, seed=so.seed,
                want_logprobs=er.want_logprobs, logprobs_n=er.logprobs_n,
                logit_bias=so.logit_bias, trace_id=er.ctx.trace_id or "",
                ctx=er.ctx)  # the kv_transfer mark is stamped at the commit
        except Exception:
            # queue unreachable: release and let the local path take it
            logger.exception("remote prefill submit failed for %s; going "
                             "local", er.request_id)
            self.allocator.free_blocks(er.block_ids)
            er.block_ids = []
            er.num_cached = 0
            return False
        self.prefix_hit_tokens += er.num_cached
        self.prefix_total_tokens += len(er.prompt)
        er.ctx.add_stage("admission")
        er.remote_deadline = time.monotonic() + self.disagg.prefill_timeout_s
        er.remote_future.add_done_callback(lambda _f: self.wake.set())
        self.pending_remote.append(er)
        return True

    def _reap_remote(self) -> bool:
        """Install committed remote prefills; handle cancels and timeouts."""
        progressed = False
        now = time.monotonic()
        for er in list(self.pending_remote):
            if er.ctx.is_stopped:
                self.pending_remote.remove(er)
                self.disagg.cancel(er.request_id)
                self._finish(er, FinishReason.CANCELLED)
                progressed = True
                continue
            fut = er.remote_future
            if fut.done() and not fut.cancelled():
                slot = self._free_slot()
                if slot is None:
                    break  # keep the completion order; wait for a slot
                self.pending_remote.remove(er)
                self._install_remote(er, slot)
                progressed = True
            elif now > er.remote_deadline:
                # the prefill worker is lost or the queue starved: the
                # blocks go back and the request prefills locally, first in
                # line
                logger.warning("remote prefill timeout for %s; local "
                               "fallback", er.request_id)
                self.pending_remote.remove(er)
                self.disagg.cancel(er.request_id, reason="timeout")
                # the local admission counts the prompt's prefix hit anew
                self.prefix_hit_tokens -= er.num_cached
                self.prefix_total_tokens -= len(er.prompt)
                self.allocator.free_blocks(er.block_ids)
                er.block_ids = []
                er.num_cached = 0
                er.remote_future = None
                er.ctx.add_stage("remote_fallback")
                self.waiting.appendleft(er)
                progressed = True
        return progressed

    def _install_remote(self, er: EngineRequest, slot: int) -> None:
        """A remote prefill committed: its KV blocks are in this cache and
        its first token was sampled there. Enter the decode loop as a local
        prefill's final chunk leaves a row (host batch state, sample row,
        the prefix cache and its KV events, the suffix ring)."""
        token, lp, top = er.remote_future.result()
        er.ctx.add_stage("remote_prefill")
        er.remote_future = None
        er.slot = slot
        self.slots[slot] = er
        self._host.install(er)
        er.prefill_tokens = er.prompt
        er.prefill_pos = len(er.prompt)
        er.context_len = len(er.prompt)
        er.pending_token = token
        er.generated = 1
        # penalty state for the decode steps this slot is entering
        self.runner.set_sample_row(
            slot, er.prompt, [token],
            logit_bias=er.req.sampling_options.logit_bias)
        er.seq = TokenSequence(er.prompt, block_size=self.config.kv_block_size)
        er.registered_blocks = 0
        # the remotely filled blocks become matchable and publish their
        # stored events (a KV router learns of them here)
        self._register_completed_blocks(er)
        er.ring_tail.clear()
        er.ring_tail.extend(er.prompt[-SUFFIX_RING_W:])
        er.ring_tail.append(token)
        er.finish = self._check_finish(er, token)
        if top and er.want_logprobs and er.logprobs_n > 0:
            top = dict(list(top.items())[: er.logprobs_n])
        else:
            top = None
        self._emit(er, token, lp if er.want_logprobs else None, top)
        if er.finish is not None:
            self._finish(er, er.finish, emit=False)

    # ---------- sequence-parallel long-context prefill ----------

    def _sp_eligible(self, er: EngineRequest) -> bool:
        """Route this admission to the SP ladder? The SP chunk is served
        (``sp_size > 1``, a supported trunk), the uncached suffix reaches
        the threshold, the request needs no prompt logprobs (the SP chunk
        runs no full-S head), and no draft mirrors the cache (the draft has
        no SP chunk: its mirror would go stale)."""
        cfg = self.config
        if not (getattr(self.runner, "sp_ready", False)
                and cfg.long_prefill_threshold_tokens > 0):
            return False
        suffix = len(er.prefill_tokens) - er.num_cached
        if suffix < cfg.long_prefill_threshold_tokens:
            return False
        if er.want_prompt_lps and not er.prompt_lps_emitted:
            return False
        return self.draft is None

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

    def _sp_kernel_route(self) -> bool:
        """Does the SP chunk's prefix attention take kernel 6 (a card) or
        the plain gather route (the CPU)? The device-time byte model
        counts one pass over the prefix for the kernel, three for the
        gather."""
        return self.runner.device.type == "cuda"

    async def _sp_finish(self, loop, er: EngineRequest, outs) -> None:
        """Early decode handoff and drain of a finished SP ladder.

        The final chunk's sampled token is still on the device. When the
        request can take a plain decode burst, one is dispatched at once
        with that token composed into its row ON THE DEVICE, so the first
        burst is queued before any host read of the prefill outputs. One
        executor sync drains both; emission follows the dense path's rules
        (tokens past a finish are discarded with the request's blocks)."""
        cfg = self.config
        # the final chunk was dispatched just now: the ladder's device-time
        # window closes at this drain
        t_final = time.monotonic()
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
            t_burst = time.monotonic()
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
        t_done = time.monotonic()
        dt = self.device_time
        if dt is not None:
            chunks = -(-(er.context_len - er.num_cached)
                       // max(1, self.runner.sp_chunk_tokens))
            dt.observe("prefill_sp", "prefill", t_final, t_done,
                       read_bytes=dt.sp_prefill_read_bytes(
                           chunks, er.context_len,
                           kernel=self._sp_kernel_route()))
            if burst is not None:
                dt.observe("decode_burst", "decode", t_burst, t_done,
                           read_bytes=dt.decode_read_bytes(
                               k_steps, er.context_len),
                           tokens=k_steps)
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

        t0 = time.monotonic()
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
        if self.draft is not None:
            # mirror the chunk on the draft: the same tokens, slots and
            # (shared) block ids, so the draft's cache holds the whole
            # context every speculative round assumes. Inert sampling:
            # nothing commits and nothing reads the outputs
            dtemp, dtop_k, dtop_p, dkw = self._inert_sampling(rows)
            self.draft.step(
                tokens, positions, btab, slot_map, ctx_lens, last_idx,
                dtemp, dtop_k, dtop_p, sample_slots=sample_slots,
                commit=np.zeros(rows, bool), want_top=False, **dkw)

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

        # the outputs start to the host behind the step (pinned copies and
        # an event each), and an executor waits on those events: no
        # device-wide sync, which a concurrent dispatch guarded against
        # host syncs (an install landing, another engine's burst) would see
        staged = self.runner.stage_to_host(next_tokens, lps, top_vals, top_ids)
        parts = {i: [(self.runner.stage_to_host(row), cnt)
                     for row, cnt in plan[i][0].prompt_lp_parts]
                 for i in finals if plan[i][0].prompt_lp_parts}

        def _to_host():
            plists = {i: [float(x) for part, cnt in rows
                          for x in part.numpy()[0][0, :cnt]]
                      for i, rows in parts.items()}
            return (*staged.numpy(), plists)

        toks, lpn, tv, ti, plists = await loop.run_in_executor(None, _to_host)
        if self.device_time is not None:
            # non-final chunks never sync; their device time folds into this
            # observation through the serialized-interval estimator
            self.device_time.observe("prefill", "prefill", t0,
                                     time.monotonic())
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

    @staticmethod
    def _inert_sampling(n: int):
        """Greedy, penalty-free sampling arrays for the draft's mirror runs
        and bursts (nothing reads a sampled output but the proposals):
        positional (temperature, top_k, top_p) and the keyword tail as one
        dict."""
        zf = np.zeros(n, np.float32)
        zi = np.zeros(n, np.int32)
        return zf, zi, np.ones(n, np.float32), dict(
            min_p=zf, presence_penalty=zf, frequency_penalty=zf,
            repetition_penalty=np.ones(n, np.float32),
            seed_keys=np.zeros((n, 2), np.uint32), counters=zi)

    async def _draft_propose(self, loop, active: List[EngineRequest],
                             K: int) -> dict:
        """K greedy proposals per row from the draft model's burst.

        ONE extra dispatch per round: the draft's ``multi_step_decode`` is
        K + 1, so the burst also writes the K-th proposal's KV into the
        mirror cache (the last sampled token only drives that write and is
        dropped). Inactive rows run inert."""
        cfg = self.config
        b = cfg.max_batch_size
        w = cfg.kv_width_bucket(max(len(er.block_ids) for er in active))
        tokens0 = np.zeros(b, np.int32)
        positions0 = np.zeros(b, np.int32)
        btab = np.zeros((b, w), np.int32)
        commit = np.zeros(b, bool)
        for er in active:
            i = er.slot
            tokens0[i] = er.pending_token
            positions0[i] = er.context_len
            btab[i, : len(er.block_ids)] = er.block_ids
            commit[i] = True
        temp, top_k, top_p, kw = self._inert_sampling(b)
        toks, *_ = self.draft.decode_burst(
            tokens0, positions0, btab, temp, top_k, top_p,
            commit=commit, want_top=False, **kw)
        staged = self.draft.stage_to_host(toks)
        tk, = await loop.run_in_executor(None, staged.numpy)
        self.steps += 1
        return {er.slot: [int(t) for t in tk[:K, er.slot]] for er in active}

    async def _decode_spec(self, loop, active: List[EngineRequest]) -> None:
        """One speculative decode pass: propose up to K tokens per row, from
        the row's own history (ngram) or from the draft model's K + 1-step
        burst, verify all K + 1 positions in ONE forward, and emit the
        accepted prefix plus the correction token.

        Every proposed position's KV is written during the verify (and, for
        draft proposals, into the draft's mirror cache during its burst);
        the slots of rejected positions are rewritten when decoding reaches
        them again, and block registration only covers positions below the
        host ``context_len``, which advances by accepted tokens only."""
        cfg = self.config
        b = cfg.max_batch_size
        bs = cfg.kv_block_size
        K = (cfg.spec_draft_tokens if self.draft is not None
             else cfg.spec_ngram_tokens)
        S = K + 1
        if any(er.context_len + S + 1 > cfg.max_model_len for er in active):
            # a row is within K of the horizon; it finishes momentarily
            return await self._decode(loop, active, 1)

        props = {}
        if self.draft is None:
            # when nothing matches anywhere (non-repetitive output) the
            # K+1-wide verify would be pure overhead: run the normal decode
            # instead
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
        if self.draft is not None:
            # draft proposals: ONE burst of the small model (the blocks are
            # allocated above, so its mirror writes land in valid slots)
            props = await self._draft_propose(loop, active, K)

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
        t_dispatch = time.monotonic()
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
        dt = self.device_time
        if dt is not None:
            # the verify forward is one decode-shaped step over S positions:
            # the weights once and each row's (ctx + S) KV
            dt.observe("spec_verify", "decode", t_dispatch, time.monotonic(),
                       read_bytes=dt.decode_read_bytes(
                           1, sum(er.context_len + S for er in active)),
                       tokens=len(active))
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
        if self.draft is not None:
            # plain decode keeps the draft's mirror cache current (the next
            # speculative round assumes draft KV at every position below
            # the context), and the mirror steps per token: with a draft,
            # speculation plays the fused burst's part
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

        t_dispatch = time.monotonic()
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
            if self.draft is not None:
                # mirror the step on the draft (inert sampling): the
                # speculative rounds assume the draft's cache covers every
                # position the target has decoded
                dtemp, dtop_k, dtop_p, dkw = self._inert_sampling(b)
                self.draft.step(
                    tokens, positions, btab, slot_map, ctx_lens, last_idx,
                    dtemp, dtop_k, dtop_p,
                    sample_slots=np.arange(b, dtype=np.int32),
                    commit=np.zeros(b, bool), want_top=False, **dkw)

        out = self.runner.stage_to_host(next_tokens, lps, top_vals, top_ids)
        toks, lpn, tv, ti = await loop.run_in_executor(None, _host_sync, out)
        dt = self.device_time
        if dt is not None:
            dt.observe("decode_burst" if k_steps > 1 else "decode", "decode",
                       t_dispatch, time.monotonic(),
                       read_bytes=dt.decode_read_bytes(
                           k_steps, sum(er.context_len for er in active)),
                       tokens=k_steps * len(active))
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

        Guided decoding (per-token host mask edits), speculative decoding
        (either proposal source), ``n > 1``, prefill / admission work and
        rows within two bursts of the model-len horizon all force the
        synchronous path, selected per pass, never mid-burst. A
        batch-membership surprise (a row active now that was not in the
        dispatched burst) drains defensively."""
        cfg = self.config
        if cfg.decode_pipeline_depth < 2 or not runner_idle:
            return False
        if self.draft is not None or cfg.spec_ngram_tokens > 0:
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

        t_dispatch = time.monotonic()
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
        dt = self.device_time
        self._inflight = _InflightBurst(
            active=list(active),
            out=self.runner.stage_to_host(toks, lps, tv, ti),
            k_steps=k_steps, last_tokens=toks[k_steps - 1],
            dispatch_t=t_dispatch,
            read_bytes=dt.decode_read_bytes(
                k_steps, sum(er.context_len + ahead for er in active),
            ) if dt is not None else 0.0,
            tokens=k_steps * len(active),
        )
        if infl is not None:
            # burst k+1 is on the device: reconcile burst k while it runs
            await self._apply_burst(loop, infl)
            if all(er.finish is not None for er in self._inflight.active):
                # burst k finished every row: k+1 is pure over-decode.
                # Reconcile it now instead of leaving an orphan in flight
                await self._drain_pipeline(loop)

    async def _apply_burst(self, loop, infl: _InflightBurst,
                           ready_hint: Optional[float] = None) -> None:
        """Host half of the pipeline: wait for the burst's sampled tokens
        (the decode loop's ONLY host sync, on the burst's own event), emit
        them, run finish checks, and retro-invalidate rows that finished
        one burst late. A propose-verify round also adds its rows'
        proposed and accepted counts to the speculation metrics.

        ``ready_hint`` is the moment a ``HostCopy.ready()`` probe saw the
        outputs land (the chain's row drain): the device-time observation
        prefers it to the post-sync stamp, so drain lag is not charged as
        device time."""
        outs = await loop.run_in_executor(None, _host_sync, infl.out)
        if self.device_time is not None and infl.dispatch_t:
            self.device_time.observe(
                "decode_burst_df" if infl.device_finish else "decode_burst",
                "decode", infl.dispatch_t,
                ready_hint if ready_hint is not None else time.monotonic(),
                read_bytes=infl.read_bytes, tokens=infl.tokens)
        if infl.spec:
            # spec rounds carry no logprobs (spec rows want none), but the
            # acceptance accounting
            toks, nprop, nacc = outs
            lpn = tv = ti = None
        else:
            toks, lpn, tv, ti = outs
        for j in range(infl.k_steps):
            for er in infl.active:
                if er.finish is not None:
                    continue  # finished / cancelled: over-decode discarded
                token = int(toks[j, er.slot])
                if infl.device_finish and token < 0:
                    if er.chain_fp:
                        continue  # already flagged: resumes at the barrier
                    if infl.spec and j > 0:
                        # a round pads past its acceptance: every live row
                        # still emits its correction at j = 0, so only a
                        # pad there means a frozen row
                        continue
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
                    (float(lpn[j, er.slot])
                     if lpn is not None and er.want_logprobs else None),
                    (self._top_row(er, tv[j], ti[j], er.slot)
                     if tv is not None else None),
                )
                if er.finish is not None:
                    if infl.device_finish:
                        # the device's mask froze this row at exactly this
                        # step: the host check is the mirror that names the
                        # reason and finalizes the bookkeeping
                        er.device_frozen = True
                        self.device_finished_rows += 1
                    self._finish_pipelined(er)
        if infl.spec:
            for er in infl.active:
                p = int(nprop[er.slot])
                if p <= 0:
                    continue  # a frozen row proposed nothing this round
                self.spec_proposed += p
                self.spec_accepted += min(int(nacc[er.slot]), p)

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
        """Why can this pass NOT chain a plain burst off the device carry?
        None = it can. Stop-sequence rows chain through the suffix-hash
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
        if self.draft is not None:
            # plain chaining would starve the draft's mirror cache for these
            # rows: a draft engine chains through the propose-verify rounds
            return "draft_mirror"
        if self._chain_members and self._chain_kind not in (None, "plain"):
            return "chain_kind"
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

    def _spec_chain_reason(self, active: List[EngineRequest],
                           runner_idle: bool) -> Optional[str]:
        """Why can this pass NOT chain propose-verify rounds? None = it can.
        (The caller established that speculation is configured, the runner
        is idle and every row is spec-eligible: greedy, penalty-free,
        unguided.)"""
        cfg = self.config
        if not (cfg.device_finish_enabled
                and cfg.decode_pipeline_depth >= 2):
            return "disabled"
        if not runner_idle:
            return "not_idle"
        if self._chain_fp:
            return "stop_false_positive"
        if not getattr(self.runner, "spec_burst_ready", False):
            return "spec_program"
        P = (cfg.spec_draft_tokens if self.draft is not None
             else cfg.spec_ngram_tokens)
        n = self._chain_dispatched
        for er in active:
            if not er.device_checkable:
                return er.chain_fallback or "not_checkable"
            if er.fin_stop_seqs and not cfg.device_stop_strings:
                return "stop_strings_disabled"
            # the horizon, bounded by the chain's own dispatch count (the
            # host's committed context lags the drain queue): the round's
            # S-position forward stays inside the model length, as the
            # synchronous verify checks per pass
            pos0 = self._chain_pos0.get(er.slot, er.context_len)
            if pos0 + (n + 1) * (P + 1) + 1 > cfg.max_model_len:
                return "spec_near_horizon"
        if self._chain_members:
            if self._chain_kind not in (None, "spec"):
                return "chain_kind"
            member_ids = {id(m) for m in self._chain_members}
            if any(id(er) not in member_ids for er in active):
                return "membership"
        return None

    # ---------- guided device tables (engine/guided.py) ----------

    def _guided_table_key(self, er: EngineRequest) -> tuple:
        if er.guided_key is None:
            eos = tuple(sorted(int(t) for t in (er.req.eos_token_ids or [])))
            g = er.guided
            if isinstance(g, TrieConstraint):
                er.guided_key = (
                    "trie", tuple(tuple(int(t) for t in c) for c in g._choice_ids),
                    eos)
            else:
                # a JsonConstraint: keyed by its spec's canonical text (the
                # serving cache's own key), or by the grammar itself, which
                # the key then holds alive. Never by id(grammar): the
                # serving LRU drops grammars, and a new one can take a
                # dropped one's id and be served its table
                spec = er.req.sampling_options.guided_json
                er.guided_key = (
                    "json", json.dumps(spec, sort_keys=True) if spec
                    else g.grammar, eos)
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

    async def _apply_chain_head(self, loop,
                                ready_hint: Optional[float] = None) -> None:
        """Reconcile the oldest queued chained burst (FIFO: token order
        per row)."""
        await self._apply_burst(loop, self._chain.popleft(), ready_hint)

    async def _chain_prologue(self, loop, active, kind):
        """The open / validate ladder of a chained pass: reconcile a
        predating dispatch-ahead burst, close the chain at a barrier on a
        switch of its KIND ("plain" bursts or "spec" rounds), open the
        chain if none is, and resolve the live member list. Returns
        ``(active, live, members)`` or None: None means every fallback
        already ran and the caller just returns."""
        if self._inflight is not None:
            # a plain dispatch-ahead burst predates this chain: reconcile
            # it first so the chain starts from fully committed state
            await self._drain_pipeline(loop)
            active = [er for er in active if er.finish is None]
            if not active:
                return None
        if self._chain_members and self._chain_kind not in (None, kind):
            await self._chain_barrier(loop)
            active = [er for er in active if er.finish is None]
            if not active:
                return None
        if not self._chain_members:
            self._chain_members = list(active)
            self._chain_kind = kind
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

    async def _chain_reserve(self, loop, active, live, advance: int,
                             sync_steps: int) -> bool:
        """Block headroom for the chain's next dispatch: a never-frozen row
        runs through position ``chain_pos0 + (n+1)*advance - 1``; reserve
        one past that (the carry slot), capped at the model-len horizon
        (the device freezes rows there; blocks past it are never touched).
        False = KV OOM: preemption needs fully committed host state, so
        the chain closed at a barrier and the pass already fell back to
        one sync decode of ``sync_steps``."""
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
                    await self._decode(loop, rest, sync_steps)
                return False
            self._host.sync_blocks(er)
        return True

    def _chain_masks(self, members, live):
        """(commit mask, block-table slice) of one chained dispatch."""
        cfg = self.config
        commit = np.zeros(cfg.max_batch_size, bool)
        for er in members:
            commit[er.slot] = er.finish is None
        w = cfg.kv_width_bucket(max(len(er.block_ids) for er in live))
        return commit, self._host.btab[:, :w].copy()

    def _chain_fill(self, live, with_guided: bool):
        """The chain-fill carry from committed host state (the first
        dispatch of a chain). Spec chains carry no guided state (spec rows
        are unguided)."""
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
            if with_guided and er.guided is not None:
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
            # ready() is an event query, never a sync: its time is the
            # device-time observation's ready stamp
            await self._apply_chain_head(loop, ready_hint=time.monotonic())
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
        opened = await self._chain_prologue(loop, active, "plain")
        if opened is None:
            return
        active, live, members = opened
        n = self._chain_dispatched
        if not await self._chain_reserve(loop, active, live, k_steps, k_steps):
            return

        hs = self._host
        commit, btab = self._chain_masks(members, live)
        ctrs = np.zeros(b, np.int32)
        for er in members:
            # a row that has not frozen has generated gen0 + n*K tokens
            # when this burst starts; a frozen row's draw is never read
            ctrs[er.slot] = self._chain_gen0[er.slot] + n * k_steps
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
            carry = self._chain_fill(live, with_guided=True)
        else:
            carry = self._chain_carry
        tokens0, positions0, gen0, done0, ring0, gstate0 = carry

        t_dispatch = time.monotonic()
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
        dt = self.device_time
        self._chain.append(_InflightBurst(
            active=list(live),
            out=self.runner.stage_to_host(toks, lps, tv, ti),
            k_steps=k_steps, last_tokens=None, device_finish=True,
            dispatch_t=t_dispatch,
            read_bytes=dt.decode_read_bytes(k_steps, sum(
                min(self._chain_pos0[er.slot] + n * k_steps,
                    cfg.max_model_len) for er in live),
            ) if dt is not None else 0.0,
            tokens=k_steps * len(live),
        ))
        await self._chain_drain(loop, members)

    async def _decode_chained_spec(self, loop,
                                   active: List[EngineRequest]) -> None:
        """One chained propose-verify pass: ONE round dispatched straight
        off the device-resident carry. The proposals come from the carry's
        trailing-token ring (ngram, inside the round) or from the draft
        model's burst on the SAME carry (its tokens and positions, its
        commit mask gated by the carry's done mask on the device), and one
        S = K + 1-position forward verifies them; the accepted prefix and
        the correction commit with the plain chain's freeze semantics. No
        host barrier between rounds, or between a draft's burst and its
        verify: the drain reconciles rounds as their outputs reach the
        host, with each row's proposed and accepted counts."""
        cfg = self.config
        b = cfg.max_batch_size
        P = (cfg.spec_draft_tokens if self.draft is not None
             else cfg.spec_ngram_tokens)
        S = P + 1
        opened = await self._chain_prologue(loop, active, "spec")
        if opened is None:
            return
        active, live, members = opened
        # headroom: a round advances a never-frozen row by at most S
        # positions (the accepted prefix and the correction); near-horizon
        # rounds never dispatch (_spec_chain_reason closes the chain first)
        if not await self._chain_reserve(loop, active, live, S, 1):
            return

        hs = self._host
        commit, btab = self._chain_masks(members, live)
        if self._chain_carry is None:
            carry = self._chain_fill(live, with_guided=False)
        else:
            carry = self._chain_carry
        tokens0, positions0, gen0, done0, ring0, gstate0 = carry

        n = self._chain_dispatched
        t_dispatch = time.monotonic()
        props = None
        if self.draft is not None:
            # the draft's round on the SAME carry: its burst takes the
            # target's device-resident tokens and positions, its live rows
            # are the members the carry has not frozen
            dtemp, dtop_k, dtop_p, dkw = self._inert_sampling(b)
            dtoks, *_ = self.draft.decode_burst(
                tokens0, positions0, btab, dtemp, dtop_k, dtop_p,
                commit=self.draft.live_rows(commit, done0),
                want_top=False, **dkw)
            props = dtoks[:P].T                  # [B, P] device proposals
            self.steps += 1

        toks, nprop, nacc, self._chain_carry = self.runner.decode_burst_spec(
            tokens0, positions0, gen0, done0, ring0, gstate0, btab,
            commit=commit, stop_ids=hs.stop_ids, min_new=hs.min_new,
            max_new=hs.max_new, stop_hash=hs.stop_hash,
            stop_hlen=hs.stop_hlen, proposals=props)
        self._chain_dispatched += 1
        self.steps += 1
        self.decode_steps += 1
        self.pipeline_bursts += 1
        dt = self.device_time
        self._chain.append(_InflightBurst(
            active=list(live),
            out=self.runner.stage_to_host(toks, nprop, nacc),
            k_steps=S, last_tokens=None, device_finish=True, spec=True,
            dispatch_t=t_dispatch,
            # one S-position forward: the weights once, each row's KV
            read_bytes=dt.decode_read_bytes(1, sum(
                min(self._chain_pos0[er.slot] + n * S + S, cfg.max_model_len)
                for er in live),
            ) if dt is not None else 0.0,
            tokens=len(live)))
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
        self._chain_kind = None
        self._chain_fp = False

    # ---------- guided decoding on the synchronous path ----------

    def _guided_allowed_ids(self, er: EngineRequest) -> List[int]:
        """Token ids the constraint permits next, plus the eos ids wherever
        the constrained output may legally end (a terminal trie node; a
        complete top-level JSON value)."""
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
