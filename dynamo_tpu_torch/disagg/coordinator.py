"""Decode-side remote-prefill coordination.

The port's copy of ``dynamo_tpu/disagg/coordinator.py``, living in the
decode worker: decide local or remote per request (the router's verdict
with the queue depth), enqueue a ``RemotePrefillRequest`` for blocks the
scheduler allocated, receive the blocks on the transfer server, and hand
the scheduler a future that resolves when the prefill worker commits the
first token. At the commit the request's trace gets its ``kv_transfer``
mark and the prefill worker's span set (it rides the commit frame), folded
with a clock offset from the commit's return leg (``telemetry/stitch.py``);
the counters are in ``metrics()``.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import Dict, Optional, Sequence

from ..runtime.wire import packb
from .protocols import PrefillQueue, RemotePrefillRequest
from .router import DisaggRouter
from .transfer import KvTransferServer, cache_layout, transfer_key

logger = logging.getLogger(__name__)


class RemotePrefillCoordinator:
    """Lives inside a decode worker; one per engine."""

    def __init__(self, drt, runner, namespace: str = "public",
                 component: str = "backend",
                 router: Optional[DisaggRouter] = None,
                 engine_id: Optional[str] = None,
                 advertise_host: str = "127.0.0.1",
                 depth_refresh_s: float = 0.25,
                 prefill_timeout_s: float = 120.0):
        self.drt = drt
        self.runner = runner
        self.namespace = namespace
        self.component = component
        self.router = router or DisaggRouter(namespace=namespace)
        self.engine_id = engine_id or f"eng-{uuid.uuid4().hex[:12]}"
        self.queue = PrefillQueue(drt.messaging, namespace)
        self.prefill_timeout_s = prefill_timeout_s
        self._server = KvTransferServer(
            scatter=self._scatter, on_commit=self._commit,
            authorize=self._authorize, host=advertise_host,
            layout=cache_layout(runner))
        self._pending: Dict[str, asyncio.Future] = {}
        # the request contexts (stage marks, remote spans) and the submit
        # wall stamps the commit's span fold needs
        self._ctx: Dict[str, object] = {}
        self._submit_wall: Dict[str, float] = {}
        self._queue_depth = 0
        self._depth_refresh_s = depth_refresh_s
        self._depth_task: Optional[asyncio.Task] = None
        self.remote_submitted = 0
        self.remote_completed = 0
        self.failures: Dict[str, int] = {}   # by reason: submit|timeout|cancelled
        self.blocks_installed = 0

    # ---------- lifecycle ----------

    async def start(self) -> "RemotePrefillCoordinator":
        await self._server.start()
        await self.router.start(self.drt.discovery, self.drt.runtime)
        lease = await self.drt.discovery.primary_lease()
        await self.drt.discovery.kv_put(
            transfer_key(self.namespace, self.component, self.engine_id),
            packb(self._server.descriptor), lease_id=lease.id)
        self._depth_task = self.drt.runtime.spawn(self._depth_loop())
        return self

    async def close(self) -> None:
        if self._depth_task is not None:
            self._depth_task.cancel()
        await self.router.stop()
        await self._server.close()

    async def _depth_loop(self) -> None:
        while True:
            try:
                self._queue_depth = await self.queue.depth()
            except Exception:  # the loop outlives a broker hiccup
                logger.debug("queue depth refresh failed", exc_info=True)
            await asyncio.sleep(self._depth_refresh_s)

    # ---------- scheduler-facing API ----------

    def decide(self, prompt_len: int, prefix_hit_len: int) -> bool:
        """Should this prompt's prefill go remote? (sync; cached depth)"""
        return self.router.prefill_remote(prompt_len, prefix_hit_len,
                                          self._queue_depth)

    async def submit(self, request_id: str, token_ids: Sequence[int],
                     block_ids: Sequence[int], num_cached: int,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, min_p: float = 0.0,
                     presence_penalty: float = 0.0,
                     frequency_penalty: float = 0.0,
                     repetition_penalty: float = 1.0,
                     seed: Optional[int] = None, want_logprobs: bool = False,
                     logprobs_n: int = 0, logit_bias: Optional[dict] = None,
                     trace_id: str = "", ctx=None) -> asyncio.Future:
        """Enqueue the prompt; returns a future of (first_token, logprob,
        top). ``ctx`` (the request's AsyncEngineContext) gets the
        ``kv_transfer`` mark and the prefill worker's spans at the commit."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[request_id] = fut
        if ctx is not None:
            self._ctx[request_id] = ctx
        try:
            await self.queue.push(RemotePrefillRequest(
                request_id=request_id, engine_id=self.engine_id,
                token_ids=list(map(int, token_ids)),
                block_ids=list(map(int, block_ids)), num_cached=num_cached,
                temperature=temperature, top_k=top_k, top_p=top_p,
                min_p=min_p, presence_penalty=presence_penalty,
                frequency_penalty=frequency_penalty,
                repetition_penalty=repetition_penalty, seed=seed,
                want_logprobs=want_logprobs, logprobs_n=logprobs_n,
                logit_bias=logit_bias, trace_id=trace_id,
                enqueued_at=time.time()))
        except BaseException:
            # nothing is coming: do not keep authorizing frames for it
            self._pending.pop(request_id, None)
            self._ctx.pop(request_id, None)
            self._count_failure("submit")
            raise
        self._submit_wall[request_id] = time.time()
        self.remote_submitted += 1
        self._queue_depth += 1  # optimistic until the next refresh
        return fut

    def cancel(self, request_id: str, reason: str = "cancelled") -> None:
        """Stop accepting frames for a request (cancel, timeout fallback)."""
        fut = self._pending.pop(request_id, None)
        self._ctx.pop(request_id, None)
        self._submit_wall.pop(request_id, None)
        if fut is not None:
            self._count_failure(reason)
            fut.cancel()

    def _count_failure(self, reason: str) -> None:
        self.failures[reason] = self.failures.get(reason, 0) + 1

    # ---------- transfer-server callbacks ----------

    def _authorize(self, request_id: str, block_ids) -> bool:
        return request_id in self._pending

    async def _scatter(self, request_id: str, block_ids, k, v) -> None:
        # pin the frame in a worker thread (touches no shared state); the
        # cache write stays on the event loop, so it is ordered on the
        # runner's stream with the scheduler's dispatches
        loop = asyncio.get_running_loop()
        k, v = await loop.run_in_executor(
            None, lambda: self.runner.stage_blocks(k, v))
        # the request may have been cancelled or timed out DURING the
        # await: its blocks may already belong to another sequence
        if request_id not in self._pending:
            logger.info("dropping late KV frame for %s", request_id)
            return
        self.runner.scatter_blocks(block_ids, k, v)
        self.blocks_installed += len(block_ids)

    def _commit(self, request_id: str, first_token: int,
                logprob: Optional[float], top: Optional[dict] = None,
                spans: Optional[dict] = None) -> None:
        fut = self._pending.pop(request_id, None)
        ctx = self._ctx.pop(request_id, None)
        submit_wall = self._submit_wall.pop(request_id, None)
        if fut is None or fut.done():
            logger.warning("commit for unknown request %s", request_id)
            return
        if ctx is not None:
            # closing-mark semantics (telemetry/tracing.py): the span from
            # the submit-side "admission" mark to here is the remote compute
            # and the streamed KV transfer
            ctx.add_stage("kv_transfer")
            if spans and submit_wall is not None:
                # the forward "leg" is a QUEUE submit (the worker dequeues
                # whenever it gets there), so the offset comes from the
                # commit's return leg alone (queued_forward)
                from ..telemetry.stitch import remote_span_set

                ctx.add_remote_spans(remote_span_set(
                    spans.get("source", "prefill_worker"),
                    spans.get("spans") or [],
                    spans.get("recv_at", 0.0),
                    spans.get("resp_sent_at", 0.0),
                    submit_wall, time.time(),
                    children=spans.get("children") or [],
                    queued_forward=True,
                ))
        self.remote_completed += 1
        fut.set_result((first_token, logprob, top))

    def metrics(self) -> dict:
        return {
            "remote_prefill_submitted": self.remote_submitted,
            "remote_prefill_completed": self.remote_completed,
            "remote_prefill_pending": len(self._pending),
            "prefill_queue_depth": self._queue_depth,
            # the port's own: fallbacks by reason and the received stream
            "remote_prefill_failures": dict(self.failures),
            "kv_transfer_bytes_received": self._server.bytes_received,
            "kv_transfer_frames_received": self._server.frames_received,
            "kv_transfer_blocks_installed": self.blocks_installed,
            "kv_transfer_nacks": self._server.nacks,
        }
