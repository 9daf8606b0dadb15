"""Discovery plane: lease-scoped KV store with prefix watch.

This is the control plane of the framework — the role etcd plays in the
reference (reference: lib/runtime/src/transports/etcd.rs:40-520 — kv_create
txn semantics, prefix watch with Put/Delete events, auto-renewed primary
lease whose loss is the liveness signal). Two implementations exist:
in-memory (tests, single-process serving) and the dynstore TCP server
(multi-process / multi-host).

Liveness contract: every serving endpoint registers its key under the
worker's *primary lease*. If the worker dies, keep-alives stop, the lease
expires, the server deletes the key, and every watcher sees a Delete event —
routers stop routing there with zero extra coordination.

The port's copy of ``dynamo_tpu/runtime/discovery.py`` (standard library only).
"""

from __future__ import annotations

import abc
import asyncio
import dataclasses
import enum
from typing import AsyncIterator, Dict, List, Optional, Tuple


class WatchEventType(enum.Enum):
    PUT = "put"
    DELETE = "delete"


@dataclasses.dataclass
class WatchEvent:
    type: WatchEventType
    key: str
    value: bytes


@dataclasses.dataclass
class Lease:
    id: int
    ttl: float


class DiscoveryClient(abc.ABC):
    """Lease + KV + watch surface shared by all discovery transports."""

    @abc.abstractmethod
    async def grant_lease(self, ttl: float = 10.0) -> Lease:
        """Create a lease; the client auto-keeps-it-alive until revoked."""

    @abc.abstractmethod
    async def revoke_lease(self, lease_id: int) -> None:
        """Revoke: all keys attached to the lease are deleted server-side."""

    @abc.abstractmethod
    async def kv_create(self, key: str, value: bytes, lease_id: Optional[int] = None) -> bool:
        """Transactional create — returns False if the key already exists."""

    @abc.abstractmethod
    async def kv_put(self, key: str, value: bytes, lease_id: Optional[int] = None) -> None:
        """Unconditional upsert."""

    @abc.abstractmethod
    async def kv_get(self, key: str) -> Optional[bytes]:
        pass

    @abc.abstractmethod
    async def kv_get_prefix(self, prefix: str) -> Dict[str, bytes]:
        pass

    @abc.abstractmethod
    async def kv_delete(self, key: str) -> None:
        pass

    @abc.abstractmethod
    async def watch_prefix(
        self, prefix: str
    ) -> Tuple[Dict[str, bytes], "PrefixWatcher"]:
        """Current snapshot + a watcher yielding subsequent events."""

    async def primary_lease(self) -> Lease:
        """The client's default lease, created lazily, shared by all endpoints."""
        if getattr(self, "_primary_lease", None) is None:
            self._primary_lease = await self.grant_lease()
        return self._primary_lease

    async def close(self) -> None:
        pass


class PrefixWatcher:
    """Async stream of WatchEvents for one prefix; cancel() to stop.

    ``on_cancel`` lets the owning transport release server-side watch state.
    """

    def __init__(self, on_cancel=None) -> None:
        self._queue: asyncio.Queue = asyncio.Queue()
        self._cancelled = False
        self._on_cancel = on_cancel

    def _emit(self, event: WatchEvent) -> None:
        if not self._cancelled:
            self._queue.put_nowait(event)

    def cancel(self) -> None:
        if self._cancelled:
            return
        self._cancelled = True
        self._queue.put_nowait(None)
        if self._on_cancel is not None:
            self._on_cancel()

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self

    async def __anext__(self) -> WatchEvent:
        ev = await self._queue.get()
        if ev is None:
            raise StopAsyncIteration
        return ev


async def kv_create_or_validate(
    client: DiscoveryClient, key: str, value: bytes, lease_id: Optional[int] = None
) -> bool:
    """Create, or succeed iff the existing value matches (config agreement)."""
    if await client.kv_create(key, value, lease_id):
        return True
    existing = await client.kv_get(key)
    return existing == value
