"""The remote-prefill request and the prefill work queue.

The port's copy of ``dynamo_tpu/disagg/protocols.py``, on the runtime's
work queue (push, pop with a visibility window, ack, depth): a prefill
worker that dies mid-item leaves it unacked, and the broker hands it to
another worker. ``to_wire`` encodes with ``runtime/wire.py``, byte for
byte the reference's msgpack.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

from ..runtime.wire import packb, unpackb

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RemotePrefillRequest:
    """A prompt whose KV is computed remotely and pushed back.

    ``block_ids`` are the decode worker's cache blocks covering the
    prompt; the prefill worker writes the suffix after ``num_cached``
    tokens (the decode side's prefix-cache hit) into them."""

    request_id: str
    engine_id: str            # decode engine that owns the blocks
    token_ids: List[int]
    block_ids: List[int]
    num_cached: int = 0       # decode-side prefix-hit tokens (block multiple)
    # sampling of the one token the prefill samples
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    seed: Optional[int] = None
    want_logprobs: bool = False
    logprobs_n: int = 0       # top_logprobs alternatives (0 = chosen only)
    logit_bias: Optional[dict] = None  # token id → additive logit offset
    trace_id: str = ""        # ingress correlation id (logs only)
    enqueued_at: float = 0.0  # wall clock at enqueue (telemetry only)

    def to_wire(self) -> bytes:
        d = dataclasses.asdict(self)
        if d.get("logit_bias"):
            # string keys on the wire: a strict map-key decode rejects ints
            d["logit_bias"] = {str(k): v for k, v in d["logit_bias"].items()}
        return packb(d)

    @classmethod
    def from_wire(cls, data: bytes) -> "RemotePrefillRequest":
        d = unpackb(data)
        if d.get("logit_bias"):
            d["logit_bias"] = {
                int(k): float(v) for k, v in d["logit_bias"].items()}
        # unknown keys are dropped: a newer sender's field must not crash
        # an older worker's pop
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class PrefillQueue:
    """The shared prefill work queue, one per namespace. Decode workers
    push; prefill workers pop with a visibility window and ack only after
    the commit, so a worker's death mid-prefill redelivers the item."""

    # kept at or above the decode side's prefill timeout (120 s), so a
    # slow but live prefill is not duplicated onto a second worker
    DEFAULT_VISIBILITY = 120.0

    def __init__(self, messaging, namespace: str = "public",
                 visibility: float = DEFAULT_VISIBILITY):
        self.messaging = messaging
        self.name = f"{namespace}.prefill_queue"
        self.visibility = visibility

    async def push(self, req: RemotePrefillRequest) -> None:
        await self.messaging.queue_push(self.name, req.to_wire())

    async def pop(self, timeout: Optional[float] = None):
        """(RemotePrefillRequest, ack) or None on timeout. A malformed
        item never parses for any worker: it is acked away."""
        item = await self.messaging.queue_pop(
            self.name, timeout=timeout, visibility=self.visibility)
        if item is None:
            return None
        try:
            req = RemotePrefillRequest.from_wire(item.payload)
        except (ValueError, TypeError, KeyError):
            logger.exception("dropping malformed prefill queue item")
            item.ack()
            return None
        return req, item.ack

    async def depth(self) -> int:
        return await self.messaging.queue_depth(self.name)
