"""Prefill worker: pops the queue, computes KV, streams it to decode workers.

The port's copy of ``dynamo_tpu/disagg/prefill_worker.py``: pop the
namespace's prefill queue, resolve the decode engine's transfer
descriptor from discovery (refusing one whose cache differs from this
worker's in dtype or block shape), run the prefill as a chunked ladder on
the local runner and stream each chunk's completed KV blocks to the
decode engine while the next chunk computes. The dense ladder takes the
decode scheduler's chunk (``build_prefill_arrays`` at
``prefill_bucket_cap``) through ``runner.step``; past
``long_prefill_threshold_tokens``, on a runner that serves the
sequence-parallel chunk, the SP ladder (``runner.sp_prefill_chunk``) runs
instead. The queue item is acked only after the commit is acknowledged,
so a crash anywhere earlier redelivers it.

Pipeline (one card, one stream)::

  chunk i ──▶ chunk i+1 ──▶ ...                   (dispatched on the loop)
     └▶ frame gather + its copy to pinned host memory, enqueued behind it
            └▶ wait on that copy's event, pack, write   (pump: executor + socket)

The gather and its host copy are dispatched on the event loop between
chunk steps, so stream order pins each gather to the blocks its chunk
completed; the pump waits only on its frame's own event. The first token
is read the same way (``stage_to_host``), never by a device-wide sync.

Sampling noise: a seeded request's first token is drawn with
``(seed_to_key(seed), counter 0)``, the decode scheduler's local draw, so
a seeded stream is the same remote or local; an unseeded one draws from
this worker's own generator.

Telemetry: each prefill stamps ``prefill.dequeue`` → ``prefill.compute``
→ ``prefill.transfer`` on its own context and exports them on the commit
frame (the decode side folds them into the request's stitched trace);
``registry`` renders ``metrics()``'s counters as
``dynamo_prefill_worker_*`` gauges beside the runner's compile and
device-time series (the ``--metrics-port`` sidecar's exposition).

Not ported: the ici payload pump.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import Dict, List, Optional

import numpy as np

from ..engine.block_allocator import BlockAllocator
from ..engine.model_runner import build_prefill_arrays
from ..engine.sampling import seed_to_key
from ..engine.scheduler import prefill_bucket_cap
from ..runtime.engine import AsyncEngineContext
from ..runtime.wire import unpackb
from ..telemetry.registry import MetricsRegistry
from ..tokens import compute_block_hashes
from ..transfer.plane import FramePipe, negotiate_backend
from .protocols import PrefillQueue, RemotePrefillRequest
from .transfer import KvTransferClient, cache_layout, layout_mismatch, transfer_key

logger = logging.getLogger(__name__)

# per-request transfer records kept for the stats scrape
TRANSFER_HISTORY = 32


class PrefillWorker:
    def __init__(self, drt, runner, config, namespace: str = "public",
                 component: str = "backend", transfer_chunk_blocks: int = 16):
        self.drt = drt
        self.runner = runner
        self.config = config
        self.namespace = namespace
        self.component = component
        self.transfer_chunk_blocks = transfer_chunk_blocks
        self.queue = PrefillQueue(drt.messaging, namespace)
        self.allocator = BlockAllocator(
            config.num_kv_blocks, config.kv_block_size,
            config.enable_prefix_caching)
        self._rng = np.random.default_rng(config.seed)
        self._layout = cache_layout(runner)
        self._clients: Dict[str, KvTransferClient] = {}
        self._stopping = False
        self.prefills = 0
        self.sp_prefills = 0
        self.prefill_tokens = 0
        self.transfer_bytes = 0
        self.transfer_frames = 0
        self.nacks = 0
        self.prefix_hit_tokens = 0
        self.prefix_total_tokens = 0
        self.max_live_host_frames = 0
        self.transfers = collections.deque(maxlen=TRANSFER_HISTORY)
        # the sidecar's exposition: the counters of metrics() as gauges,
        # and the runner's first-dispatch and device-time series
        self.registry = MetricsRegistry()
        self.registry.register_callback_gauges("dynamo_prefill_worker",
                                               self.metrics)
        for tracker in (getattr(runner, "compiles", None),
                        getattr(runner, "device_time", None)):
            if tracker is not None:
                self.registry.attach(tracker.registry)

    # ---------- main loop ----------

    async def run(self) -> None:
        while not self._stopping:
            await self.serve_one(timeout=1.0)

    def stop(self) -> None:
        self._stopping = True

    async def serve_one(self, timeout: Optional[float] = None) -> bool:
        """Pop and fully process one queue item. False on timeout."""
        try:
            popped = await self.queue.pop(timeout=timeout)
        except Exception:
            # a broker hiccup: back off, never end run()
            logger.exception("prefill queue pop failed")
            await asyncio.sleep(1.0)
            return False
        if popped is None:
            return False
        rpr, ack = popped
        try:
            await self._handle(rpr)
        except Exception:
            # no ack: the visibility window redelivers the item
            logger.exception("prefill of %s failed; leaving it for "
                             "redelivery", rpr.request_id)
            stale = self._clients.pop(rpr.engine_id, None)
            if stale is not None:
                await stale.close()
            return True
        ack()
        return True

    # ---------- the work ----------

    def _chunk_cap(self) -> int:
        """The decode scheduler's single-row chunk (``prefill_bucket_cap``),
        floored at the smallest bucket so a chunk always advances."""
        cap = prefill_bucket_cap(self.config)
        return cap if cap is not None else self.config.prefill_buckets[0]

    async def _handle(self, rpr: RemotePrefillRequest) -> None:
        cfg = self.config
        bs = cfg.kv_block_size
        prompt = rpr.token_ids
        loop = asyncio.get_running_loop()
        # this hop's trace: the marks ride the commit frame back to the
        # decode side, which stitches them into the request's timeline
        ctx = AsyncEngineContext(trace_id=rpr.trace_id or rpr.request_id)
        ctx.add_stage("prefill.dequeue")
        block_ids, num_cached = self.allocator.allocate_prompt(prompt)
        pipe: Optional[FramePipe] = None
        t_start = time.monotonic()
        try:
            client = await self._client(rpr.engine_id)
            if rpr.seed is not None:
                seed_keys = seed_to_key(int(rpr.seed))[None, :]
            else:
                seed_keys = self._rng.integers(0, 2**32, size=(1, 2),
                                               dtype=np.uint32)
            # slot 0 of this runner: prompt presence and the logit_bias
            self.runner.set_sample_row(0, prompt, [], logit_bias=rpr.logit_bias)
            samp_args = (np.asarray([rpr.temperature], np.float32),
                         np.asarray([rpr.top_k], np.int32),
                         np.asarray([rpr.top_p], np.float32))
            samp_kw = dict(
                min_p=np.asarray([rpr.min_p], np.float32),
                presence_penalty=np.asarray([rpr.presence_penalty], np.float32),
                frequency_penalty=np.asarray([rpr.frequency_penalty], np.float32),
                repetition_penalty=np.asarray([rpr.repetition_penalty], np.float32),
                seed_keys=seed_keys, counters=np.zeros(1, np.int32),
                sample_slots=np.zeros(1, np.int32), commit=np.zeros(1, bool))
            # the long-context admission class: the same chunk ladder
            # through the SP chunk, which writes the same paged cache the
            # frame gathers read
            use_sp = (self.runner.sp_ready
                      and cfg.long_prefill_threshold_tokens > 0
                      and len(prompt) - num_cached
                      >= cfg.long_prefill_threshold_tokens)
            # the decode side already holds the blocks below first_block;
            # everything from there ships in bounded frames, each as soon
            # as its last position's KV is scheduled
            first_block = rpr.num_cached // bs
            limit = len(block_ids)
            cap = self.runner.sp_chunk_tokens if use_sp else self._chunk_cap()
            pipe = self._start_pump(client, rpr, max(1, cap // bs))
            shipped = first_block
            # this worker's own prefix hits are complete KV from the start
            cached_ready = min(num_cached // bs, limit)
            if cached_ready > shipped:
                await self._ship(pipe, rpr, block_ids, shipped, cached_ready)
                shipped = cached_ready
            pos, total = num_cached, len(prompt)
            want_top = rpr.logprobs_n > 0
            chunks = 0
            while True:
                end = min(pos + cap, total)
                final = end >= total
                # dispatch-only either way; one host read, of the final
                # chunk's sampled token
                if use_sp:
                    outs = self.runner.sp_prefill_chunk(
                        prompt[:end], pos, block_ids,
                        temperature=rpr.temperature, top_k=rpr.top_k,
                        top_p=rpr.top_p, min_p=rpr.min_p,
                        presence_penalty=rpr.presence_penalty,
                        frequency_penalty=rpr.frequency_penalty,
                        repetition_penalty=rpr.repetition_penalty,
                        seed_keys=seed_keys[0], counters=0, sample_slot=0,
                        commit=final, want_top=final and want_top)
                else:
                    arrays = build_prefill_arrays(cfg, prompt[:end], pos,
                                                  block_ids)
                    outs = self.runner.step(*arrays, *samp_args, **samp_kw,
                                            want_top=final and want_top)
                chunks += 1
                ready = limit if final else min(end // bs, limit)
                if ready > shipped:
                    await self._ship(pipe, rpr, block_ids, shipped, ready)
                    shipped = ready
                pos = end
                if final:
                    break
            staged = self.runner.stage_to_host(*outs[:4])
            toks, lps, top_vals, top_ids = await loop.run_in_executor(
                None, staged.numpy)
            token, lp = int(toks[0]), float(lps[0])
            top = ({int(t): float(v) for t, v in zip(top_ids[0], top_vals[0])}
                   if want_top else None)
            t_compute_done = time.monotonic()
            # closing-mark semantics: dequeue → here is the chunked compute
            # (the final chunk's token read included)
            ctx.add_stage("prefill.compute")
            # feed the local prefix cache so later prompts skip this work
            parent = None
            for i, h in enumerate(compute_block_hashes(prompt, bs)):
                self.allocator.register_complete(block_ids[i], h, parent)
                parent = h
            nbytes = await pipe.drain()
            # every frame is on the wire: the transfer tail that compute
            # did not hide closes here
            ctx.add_stage("prefill.transfer")
            committed = await client.send_commit(
                rpr.request_id, token, lp if rpr.want_logprobs else None,
                top=top,
                spans={
                    "source": "prefill_worker",
                    "spans": ctx.export_spans(),
                    # the offset pair: the decode side's submit stamp is
                    # the send; these two are this worker's
                    "recv_at": ctx.wall(ctx.stages[0][1]),
                    "resp_sent_at": time.time(),
                })
            t_done = time.monotonic()
            if not committed:
                # the receiver dropped a frame and nacked: the decode side
                # prefills locally after its timeout; the work is done here
                self.nacks += 1
                logger.warning("decode engine nacked the commit of %s "
                               "(dropped payload); it falls back to a local "
                               "prefill", rpr.request_id)
            self.prefills += 1
            self.sp_prefills += int(use_sp)
            self.prefill_tokens += len(prompt) - num_cached
            self.transfer_bytes += nbytes
            self.transfer_frames += pipe.frames
            self.prefix_hit_tokens += num_cached
            self.prefix_total_tokens += len(prompt)
            self.max_live_host_frames = max(self.max_live_host_frames,
                                            pipe.max_live_host_frames)
            first = pipe.first_frame_t
            self.transfers.append({
                "request_id": rpr.request_id,
                "prompt_tokens": len(prompt),
                "computed_tokens": len(prompt) - num_cached,
                "shipped_blocks": limit - first_block,
                "sp": use_sp, "chunks": chunks,
                "bytes": nbytes, "frames": pipe.frames,
                "compute_s": t_compute_done - t_start,
                # first frame enqueued → commit acked; the part of it after
                # the final chunk's compute is what compute did not hide
                "duration_s": t_done - first if first is not None else 0.0,
                "exposed_s": t_done - t_compute_done,
                "committed": committed,
            })
        finally:
            if pipe is not None:
                await pipe.shutdown()
            self.allocator.free_blocks(block_ids)

    # ---------- the frame stream ----------

    def _start_pump(self, client, rpr, frame_blocks: int) -> FramePipe:
        pipe = FramePipe(depth=self.config.disagg_stream_depth,
                         frame_blocks=frame_blocks)
        pipe.task = asyncio.ensure_future(self._run_pump(pipe, client, rpr))
        return pipe

    async def _run_pump(self, pipe: FramePipe, client, rpr) -> None:
        try:
            await self._tcp_pump(pipe, client, rpr)
        except asyncio.CancelledError:
            # shutdown() cancels this task: the producer is the one tearing
            # down, so nothing would feed a consume loop here
            raise
        except Exception as e:
            pipe.error = e
            # keep consuming so a producer blocked on the bounded queue
            # wakes (it re-checks pipe.error after every put); stop at the
            # sentinel, or at once if the pump already saw it
            while not pipe.closed:
                if await pipe.q.get() is None:
                    pipe.closed = True

    async def _ship(self, pipe: FramePipe, rpr, block_ids: List[int],
                    lo: int, hi: int) -> None:
        """Dispatch the gather of blocks [lo, hi) and their copies to the
        host, frame by frame, and enqueue the frames. On the event loop by
        design: dispatch order pins each read between the chunk that
        completed its blocks and the next."""
        step = pipe.frame_blocks
        for i in range(lo, hi, step):
            src = block_ids[i: min(i + step, hi)]
            dst = rpr.block_ids[i: min(i + step, hi)]
            k_dev, v_dev = self.runner.gather_blocks_device(src)
            staged = self.runner.stage_blocks_to_host(k_dev, v_dev)
            await pipe.put((staged, k_dev.dtype, v_dev.dtype, dst))

    async def _tcp_pump(self, pipe: FramePipe, client, rpr) -> None:
        """Per frame: wait on its host copy in an executor, then write it;
        at depth 2 the next frame's wait overlaps the previous write."""
        loop = asyncio.get_running_loop()
        prev_send: Optional[asyncio.Task] = None

        async def send(k, v, dst: List[int]) -> None:
            try:
                pipe.nbytes += await client.send_blocks(
                    rpr.request_id, dst, k, v,
                    chunk_blocks=self.transfer_chunk_blocks,
                    trace_id=rpr.trace_id or None)
            finally:
                pipe.live_host_frames -= 1

        try:
            while True:
                frame = await pipe.q.get()
                if frame is None:
                    pipe.closed = True
                    break
                staged, k_dtype, v_dtype, dst = frame
                k, v = await loop.run_in_executor(None, staged.tensors)
                k, v = k.view(k_dtype), v.view(v_dtype)
                pipe.frames += 1
                pipe.live_host_frames += 1
                pipe.max_live_host_frames = max(pipe.max_live_host_frames,
                                                pipe.live_host_frames)
                if prev_send is not None:
                    await prev_send
                    prev_send = None
                if pipe.depth >= 2:
                    prev_send = asyncio.ensure_future(send(k, v, dst))
                else:
                    await send(k, v, dst)
            if prev_send is not None:
                await prev_send
                prev_send = None
        finally:
            if prev_send is not None:
                prev_send.cancel()
                try:
                    await prev_send
                except (asyncio.CancelledError, ConnectionError):
                    pass  # the primary error is already propagating

    async def _client(self, engine_id: str) -> KvTransferClient:
        client = self._clients.get(engine_id)
        if client is not None:
            return client
        raw = await self.drt.discovery.kv_get(
            transfer_key(self.namespace, self.component, engine_id))
        if raw is None:
            raise ConnectionError(f"no kv transfer descriptor for {engine_id}")
        desc = unpackb(raw)
        negotiate_backend(desc)
        bad = layout_mismatch(desc, self._layout)
        if bad is not None:
            raise ValueError(
                f"refusing to send to {engine_id}: its KV cache layout differs "
                f"from this worker's: {bad}")
        client = await KvTransferClient(desc["host"], desc["port"]).connect()
        self._clients[engine_id] = client
        return client

    def metrics(self) -> dict:
        return {
            "prefills_total": self.prefills,
            "prefill_tokens_total": self.prefill_tokens,
            "transfer_bytes_total": self.transfer_bytes,
            "kv_active_blocks": self.allocator.used,
            "kv_total_blocks": self.allocator.num_blocks,
            # the port's own
            "sp_prefills_total": self.sp_prefills,
            "transfer_frames_total": self.transfer_frames,
            "nacks_total": self.nacks,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_total_tokens": self.prefix_total_tokens,
            "max_live_host_frames": self.max_live_host_frames,
            "transfers": list(self.transfers),
        }

    async def close(self) -> None:
        self.stop()
        for client in self._clients.values():
            await client.close()
        self._clients.clear()
