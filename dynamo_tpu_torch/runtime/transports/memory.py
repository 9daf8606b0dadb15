"""In-process discovery + messaging transport.

The default for single-process serving and the test harness — the analog of
the reference's mock network (reference: lib/runtime/tests/common/mock.rs:
30-120, in-memory control/data plane with optional latency injection).
A ``MemoryHub`` is the shared broker; every client in the process points at
the same hub instance.

The port's copy of ``dynamo_tpu/runtime/transports/memory.py`` (standard library only).
"""

from __future__ import annotations

import asyncio
import itertools
import random
import time
from typing import Dict, List, Optional, Set, Tuple

from ..discovery import (
    DiscoveryClient,
    Lease,
    PrefixWatcher,
    WatchEvent,
    WatchEventType,
)
from ..messaging import (
    Message,
    MessagingClient,
    Subscription,
    WorkItem,
    subject_matches,
)


class LatencyModel:
    """Optional injected delay, mirroring the reference mock's NoDelay /
    Constant / NormalDistribution latency models."""

    def __init__(self, constant: float = 0.0, jitter: float = 0.0):
        self.constant = constant
        self.jitter = jitter

    async def delay(self) -> None:
        d = self.constant + (random.random() * self.jitter if self.jitter else 0.0)
        if d > 0:
            await asyncio.sleep(d)


class MemoryHub:
    """Shared in-process broker state for both planes."""

    def __init__(self, latency: Optional[LatencyModel] = None):
        self.latency = latency or LatencyModel()
        # discovery
        self.kv: Dict[str, Tuple[bytes, Optional[int]]] = {}  # key -> (value, lease)
        self.leases: Dict[int, Set[str]] = {}  # lease id -> keys
        self.watchers: List[Tuple[str, PrefixWatcher]] = []
        self._lease_ids = itertools.count(1)
        # messaging
        self.subscriptions: List[Tuple[str, Subscription]] = []
        self.groups: Dict[Tuple[str, str], List[Subscription]] = {}
        self._group_rr: Dict[Tuple[str, str], int] = {}
        # work queues
        self.queues: Dict[str, asyncio.Queue] = {}
        self.inflight: Dict[str, Dict[int, bytes]] = {}
        self._item_ids = itertools.count(1)

    # --- discovery internals ---

    def _emit_watch(self, ev: WatchEvent) -> None:
        self.watchers = [(p, w) for p, w in self.watchers if not w._cancelled]
        for prefix, watcher in list(self.watchers):
            if ev.key.startswith(prefix):
                watcher._emit(ev)

    def deliver(self, subject: str, payload: bytes, reply: Optional[str] = None) -> int:
        """Fan-out + queue-group delivery; prunes cancelled subscriptions.
        Returns the number of subscribers the message reached."""
        msg = Message(subject=subject, payload=payload, reply=reply)
        delivered = 0
        self.subscriptions = [
            (p, s) for p, s in self.subscriptions if not s._cancelled
        ]
        for pattern, sub in list(self.subscriptions):
            if subject_matches(pattern, subject):
                sub._emit(msg)
                delivered += 1
        for key, members in list(self.groups.items()):
            pattern, _group = key
            live = [m for m in members if not m._cancelled]
            if len(live) != len(members):
                if live:
                    self.groups[key] = live
                else:
                    del self.groups[key]
                    continue
            if not live or not subject_matches(pattern, subject):
                continue
            idx = self._group_rr.get(key, 0) % len(live)
            self._group_rr[key] = idx + 1
            live[idx]._emit(msg)
            delivered += 1
        return delivered

    def expire_lease(self, lease_id: int) -> None:
        """Simulate worker death: drop all keys attached to the lease."""
        for key in sorted(self.leases.pop(lease_id, set())):
            val = self.kv.pop(key, (b"", None))[0]
            self._emit_watch(WatchEvent(WatchEventType.DELETE, key, val))

    def queue(self, name: str) -> asyncio.Queue:
        if name not in self.queues:
            self.queues[name] = asyncio.Queue()
            self.inflight[name] = {}
        return self.queues[name]


_default_hub: Optional[MemoryHub] = None


def default_hub() -> MemoryHub:
    global _default_hub
    if _default_hub is None:
        _default_hub = MemoryHub()
    return _default_hub


def reset_default_hub() -> None:
    global _default_hub
    _default_hub = None


class MemoryDiscoveryClient(DiscoveryClient):
    def __init__(self, hub: Optional[MemoryHub] = None):
        self.hub = hub or default_hub()
        self._primary_lease: Optional[Lease] = None

    async def grant_lease(self, ttl: float = 10.0) -> Lease:
        lease_id = next(self.hub._lease_ids)
        self.hub.leases[lease_id] = set()
        return Lease(id=lease_id, ttl=ttl)

    async def revoke_lease(self, lease_id: int) -> None:
        self.hub.expire_lease(lease_id)

    async def kv_create(self, key: str, value: bytes, lease_id: Optional[int] = None) -> bool:
        await self.hub.latency.delay()
        if key in self.hub.kv:
            return False
        await self.kv_put(key, value, lease_id)
        return True

    async def kv_put(self, key: str, value: bytes, lease_id: Optional[int] = None) -> None:
        self.hub.kv[key] = (value, lease_id)
        if lease_id is not None:
            self.hub.leases.setdefault(lease_id, set()).add(key)
        self.hub._emit_watch(WatchEvent(WatchEventType.PUT, key, value))

    async def kv_get(self, key: str) -> Optional[bytes]:
        entry = self.hub.kv.get(key)
        return entry[0] if entry else None

    async def kv_get_prefix(self, prefix: str) -> Dict[str, bytes]:
        return {k: v for k, (v, _) in self.hub.kv.items() if k.startswith(prefix)}

    async def kv_delete(self, key: str) -> None:
        entry = self.hub.kv.pop(key, None)
        if entry is not None:
            value, lease_id = entry
            if lease_id is not None and lease_id in self.hub.leases:
                self.hub.leases[lease_id].discard(key)
            self.hub._emit_watch(WatchEvent(WatchEventType.DELETE, key, value))

    async def watch_prefix(self, prefix: str):
        snapshot = await self.kv_get_prefix(prefix)
        watcher = PrefixWatcher()
        self.hub.watchers.append((prefix, watcher))
        return snapshot, watcher


class MemoryMessagingClient(MessagingClient):
    def __init__(self, hub: Optional[MemoryHub] = None):
        self.hub = hub or default_hub()
        self._reply_ids = itertools.count(1)

    async def publish(self, subject: str, payload: bytes) -> None:
        await self.hub.latency.delay()
        self.hub.deliver(subject, payload)

    async def subscribe(self, subject: str) -> Subscription:
        sub = Subscription()
        self.hub.subscriptions.append((subject, sub))
        return sub

    async def service_subscribe(self, subject: str, queue_group: str) -> Subscription:
        sub = Subscription()
        self.hub.groups.setdefault((subject, queue_group), []).append(sub)
        return sub

    async def request(self, subject: str, payload: bytes, timeout: float = 30.0) -> bytes:
        reply_subject = f"_inbox.{id(self)}.{next(self._reply_ids)}"
        reply_sub = await self.subscribe(reply_subject)
        try:
            if self.hub.deliver(subject, payload, reply=reply_subject) == 0:
                raise ConnectionError(f"no responders on subject {subject!r}")
            resp = await asyncio.wait_for(reply_sub.__anext__(), timeout)
            return resp.payload
        finally:
            reply_sub.cancel()

    async def queue_push(self, queue: str, payload: bytes) -> None:
        self.hub.queue(queue).put_nowait(payload)

    async def queue_pop(
        self, queue: str, timeout: Optional[float] = None, visibility: float = 60.0
    ) -> Optional[WorkItem]:
        q = self.hub.queue(queue)
        try:
            if timeout is None:
                payload = await q.get()
            else:
                payload = await asyncio.wait_for(q.get(), timeout)
        except asyncio.TimeoutError:
            return None
        item_id = next(self.hub._item_ids)
        self.hub.inflight[queue][item_id] = payload
        loop = asyncio.get_running_loop()

        def _redeliver():
            pending = self.hub.inflight[queue].pop(item_id, None)
            if pending is not None:
                q.put_nowait(pending)

        handle = loop.call_later(visibility, _redeliver)

        def ack():
            handle.cancel()
            self.hub.inflight[queue].pop(item_id, None)

        return WorkItem(payload=payload, ack=ack)

    async def queue_depth(self, queue: str) -> int:
        return self.hub.queue(queue).qsize()
