"""Message plane: subject-based pub/sub, queue-group services, work queues.

The role NATS (+JetStream) plays in the reference (reference:
lib/runtime/src/transports/nats.rs:45-130; prefill work queue
examples/llm/utils/nats_queue.py:27-155). Subjects are dot-separated
strings; subscriptions may use a trailing ``*`` wildcard segment.

Three delivery modes:
- ``subscribe``   — fan-out: every subscriber gets every message (KV events,
                    hit-rate events, metrics).
- ``service``     — queue group: each message goes to exactly one member
                    (request push to a worker endpoint).
- ``work_queue``  — durable-ish FIFO with explicit ack and visibility
                    timeout (disaggregated prefill queue). Un-acked items
                    are redelivered — a prefill worker dying mid-job must
                    not lose the job.

The port's copy of ``dynamo_tpu/runtime/messaging.py`` (standard library only).
"""

from __future__ import annotations

import abc
import asyncio
import dataclasses
from typing import AsyncIterator, Callable, Optional


@dataclasses.dataclass
class Message:
    subject: str
    payload: bytes
    reply: Optional[str] = None


class Subscription:
    """Async stream of Messages; cancel() to stop.

    ``on_cancel`` lets the owning transport release server-side state
    (unsub RPC, registry pruning) when the consumer goes away.
    """

    def __init__(self, on_cancel: Optional[Callable[[], None]] = None) -> None:
        self._queue: asyncio.Queue = asyncio.Queue()
        self._cancelled = False
        self._on_cancel = on_cancel

    def _emit(self, msg: Message) -> None:
        if not self._cancelled:
            self._queue.put_nowait(msg)

    def cancel(self) -> None:
        if self._cancelled:
            return
        self._cancelled = True
        self._queue.put_nowait(None)
        if self._on_cancel is not None:
            self._on_cancel()

    def __aiter__(self) -> AsyncIterator[Message]:
        return self

    async def __anext__(self) -> Message:
        msg = await self._queue.get()
        if msg is None:
            raise StopAsyncIteration
        return msg


@dataclasses.dataclass
class WorkItem:
    payload: bytes
    ack: Callable[[], None]  # call to mark done; otherwise redelivered


class MessagingClient(abc.ABC):
    @abc.abstractmethod
    async def publish(self, subject: str, payload: bytes) -> None:
        pass

    @abc.abstractmethod
    async def subscribe(self, subject: str) -> Subscription:
        """Fan-out subscription. Trailing ``*`` matches one segment."""

    @abc.abstractmethod
    async def service_subscribe(self, subject: str, queue_group: str) -> Subscription:
        """Queue-group subscription: one member of the group per message."""

    @abc.abstractmethod
    async def request(self, subject: str, payload: bytes, timeout: float = 30.0) -> bytes:
        """RPC convenience: publish with reply subject, await one response."""

    # --- work queue (JetStream analog) ---

    @abc.abstractmethod
    async def queue_push(self, queue: str, payload: bytes) -> None:
        pass

    @abc.abstractmethod
    async def queue_pop(
        self, queue: str, timeout: Optional[float] = None, visibility: float = 60.0
    ) -> Optional[WorkItem]:
        """Blocking pop; item is redelivered if not acked within ``visibility``."""

    @abc.abstractmethod
    async def queue_depth(self, queue: str) -> int:
        pass

    async def close(self) -> None:
        pass


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style match: ``a.b.*`` matches one segment, ``a.>`` matches rest."""
    if pattern == subject:
        return True
    p_parts = pattern.split(".")
    s_parts = subject.split(".")
    for i, p in enumerate(p_parts):
        if p == ">":
            # NATS semantics: '>' requires at least one more subject token
            return i < len(s_parts)
        if i >= len(s_parts):
            return False
        if p == "*":
            continue
        if p != s_parts[i]:
            return False
    return len(p_parts) == len(s_parts)
