"""dynstore: the framework's control+message plane server and client.

One asyncio TCP server provides both planes the reference gets from two
external services (reference: etcd for lease-KV-watch discovery,
lib/runtime/src/transports/etcd.rs; NATS for subject pub/sub, queue-group
request push and the JetStream prefill work queue,
lib/runtime/src/transports/nats.rs, examples/llm/utils/nats_queue.py).
The environment ships no etcd or NATS, so the framework carries its own:
semantics match (transactional create, prefix watch with Put/Delete, lease
TTL liveness, queue groups, ack/visibility work queues), implementation is
ours.

Wire protocol: 4-byte big-endian length, then a msgpack map. Requests carry
``id`` for RPC correlation; server pushes carry ``push`` with a watcher /
subscription id. One TCP connection per client, multiplexed.

Run standalone:  python -m dynamo_tpu_torch.runtime.transports.dynstore --port 4871

The port's copy of ``dynamo_tpu/runtime/transports/dynstore.py``: the same
server, client and wire (``runtime/wire.py`` encodes the frames msgpack
would), so a broker or client of either package talks to the other's.
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import logging
import time
from typing import Dict, Optional, Set, Tuple

from ..discovery import (
    DiscoveryClient,
    Lease,
    PrefixWatcher,
    WatchEvent,
    WatchEventType,
)
from ..messaging import Message, MessagingClient, Subscription, WorkItem, subject_matches
from ..wire import read_frame, write_frame

logger = logging.getLogger(__name__)

DEFAULT_PORT = 4871


class _ServerConn:
    """Per-connection server state."""

    def __init__(self, server: "DynStoreServer", writer: asyncio.StreamWriter):
        self.server = server
        self.writer = writer
        self.leases: Set[int] = set()
        self.watch_ids: Set[int] = set()
        self.sub_ids: Set[int] = set()
        self.send_lock = asyncio.Lock()
        self.closed = False

    async def send(self, obj: dict) -> None:
        if self.closed:
            return
        try:
            async with self.send_lock:
                write_frame(self.writer, obj)
                await self.writer.drain()
        except (ConnectionResetError, BrokenPipeError, RuntimeError):
            self.closed = True


class DynStoreServer:
    """The broker process: lease-KV-watch + pub/sub + work queues."""

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT):
        self.host = host
        self.port = port
        # kv: key -> (value, lease_id)
        self.kv: Dict[str, Tuple[bytes, Optional[int]]] = {}
        # leases: id -> (expiry_time, ttl, keys)
        self.leases: Dict[int, Tuple[float, float, Set[str]]] = {}
        # watches: wid -> (prefix, conn)
        self.watches: Dict[int, Tuple[str, _ServerConn]] = {}
        # subs: sid -> (pattern, group | None, conn)
        self.subs: Dict[int, Tuple[str, Optional[str], _ServerConn]] = {}
        self._group_rr: Dict[Tuple[str, str], int] = {}
        self.queues: Dict[str, asyncio.Queue] = {}
        self.inflight: Dict[str, Dict[int, bytes]] = {}
        self._ids = itertools.count(1)
        self._server: Optional[asyncio.AbstractServer] = None
        self._reaper_task: Optional[asyncio.Task] = None
        self._conns: set = set()
        self._op_tasks: set = set()

    # --- lifecycle ---

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self._reaper_task = asyncio.create_task(self._reap_leases())
        logger.info("dynstore listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._reaper_task:
            self._reaper_task.cancel()
        # drop live client connections first: Server.wait_closed() (py3.12)
        # otherwise blocks until every connected client hangs up on its own
        for conn in list(self._conns):
            conn.closed = True
            conn.writer.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # --- lease liveness ---

    async def _reap_leases(self) -> None:
        while True:
            await asyncio.sleep(0.5)
            now = time.monotonic()
            expired = [lid for lid, (exp, _, _) in self.leases.items() if exp < now]
            for lid in expired:
                await self._expire_lease(lid)

    async def _expire_lease(self, lease_id: int) -> None:
        entry = self.leases.pop(lease_id, None)
        if entry is None:
            return
        _, _, keys = entry
        for key in sorted(keys):
            await self._delete_key(key)

    async def _delete_key(self, key: str) -> None:
        entry = self.kv.pop(key, None)
        if entry is None:
            return
        value, lease_id = entry
        if lease_id is not None and lease_id in self.leases:
            self.leases[lease_id][2].discard(key)
        await self._emit_watch(WatchEventType.DELETE, key, value)

    async def _emit_watch(self, ev_type: WatchEventType, key: str, value: bytes) -> None:
        for wid, (prefix, conn) in list(self.watches.items()):
            if key.startswith(prefix):
                await conn.send(
                    {"push": "watch", "wid": wid, "type": ev_type.value, "key": key, "value": value}
                )

    # --- connection handling ---

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = _ServerConn(self, writer)
        self._conns.add(conn)
        try:
            while True:
                req = await read_frame(reader)
                if req is None:
                    break
                # each op handled concurrently so a blocking queue_pop doesn't
                # stall keepalives on the same connection; keep a strong ref
                # (bare create_task results are GC-able mid-flight)
                task = asyncio.create_task(self._dispatch(conn, req))
                self._op_tasks.add(task)
                task.add_done_callback(self._op_tasks.discard)
        finally:
            conn.closed = True
            self._conns.discard(conn)
            await self._cleanup_conn(conn)
            writer.close()

    async def _cleanup_conn(self, conn: _ServerConn) -> None:
        """Connection death == worker death: expire its leases immediately."""
        for wid in list(conn.watch_ids):
            self.watches.pop(wid, None)
        for sid in list(conn.sub_ids):
            self.subs.pop(sid, None)
        for lid in list(conn.leases):
            await self._expire_lease(lid)

    async def _dispatch(self, conn: _ServerConn, req: dict) -> None:
        op = req.get("op")
        rid = req.get("id")
        try:
            result = await self._execute(conn, op, req)
            if rid is not None:
                await conn.send({"id": rid, "ok": True, **(result or {})})
        except Exception as e:  # report, don't kill the connection
            logger.exception("dynstore op %s failed", op)
            if rid is not None:
                await conn.send({"id": rid, "ok": False, "error": str(e)})

    async def _execute(self, conn: _ServerConn, op: str, req: dict) -> Optional[dict]:
        if op == "lease_grant":
            lid = next(self._ids)
            ttl = float(req.get("ttl", 10.0))
            self.leases[lid] = (time.monotonic() + ttl, ttl, set())
            conn.leases.add(lid)
            return {"lease": lid, "ttl": ttl}
        if op == "lease_keepalive":
            lid = req["lease"]
            if lid in self.leases:
                _, ttl, keys = self.leases[lid]
                self.leases[lid] = (time.monotonic() + ttl, ttl, keys)
                return {"alive": True}
            return {"alive": False}
        if op == "lease_revoke":
            await self._expire_lease(req["lease"])
            conn.leases.discard(req["lease"])
            return {}
        if op == "kv_create":
            if req["key"] in self.kv:
                return {"created": False}
            await self._kv_put(req["key"], req["value"], req.get("lease"))
            return {"created": True}
        if op == "kv_put":
            await self._kv_put(req["key"], req["value"], req.get("lease"))
            return {}
        if op == "kv_get":
            entry = self.kv.get(req["key"])
            return {"value": entry[0] if entry else None}
        if op == "kv_get_prefix":
            pfx = req["prefix"]
            return {"kvs": {k: v for k, (v, _) in self.kv.items() if k.startswith(pfx)}}
        if op == "kv_delete":
            await self._delete_key(req["key"])
            return {}
        if op == "watch":
            wid = next(self._ids)
            self.watches[wid] = (req["prefix"], conn)
            conn.watch_ids.add(wid)
            pfx = req["prefix"]
            return {"wid": wid, "kvs": {k: v for k, (v, _) in self.kv.items() if k.startswith(pfx)}}
        if op == "unwatch":
            self.watches.pop(req["wid"], None)
            conn.watch_ids.discard(req["wid"])
            return {}
        if op == "sub":
            sid = next(self._ids)
            self.subs[sid] = (req["subject"], req.get("group"), conn)
            conn.sub_ids.add(sid)
            return {"sid": sid}
        if op == "unsub":
            self.subs.pop(req["sid"], None)
            conn.sub_ids.discard(req["sid"])
            return {}
        if op == "pub":
            delivered = await self._publish(req["subject"], req["payload"], req.get("reply"))
            return {"delivered": delivered}
        if op == "queue_push":
            self._queue(req["queue"]).put_nowait(req["payload"])
            return {}
        if op == "queue_pop":
            return await self._queue_pop(conn, req)
        if op == "queue_ack":
            self.inflight.get(req["queue"], {}).pop(req["item"], None)
            return {}
        if op == "queue_depth":
            return {"depth": self._queue(req["queue"]).qsize()}
        if op == "ping":
            return {"pong": True}
        raise ValueError(f"unknown op {op!r}")

    async def _kv_put(self, key: str, value: bytes, lease_id: Optional[int]) -> None:
        if lease_id is not None and lease_id not in self.leases:
            raise ValueError(f"lease {lease_id} does not exist")
        self.kv[key] = (value, lease_id)
        if lease_id is not None:
            self.leases[lease_id][2].add(key)
        await self._emit_watch(WatchEventType.PUT, key, value)

    async def _publish(self, subject: str, payload: bytes, reply: Optional[str]) -> int:
        delivered = 0
        groups_seen: Dict[Tuple[str, str], list] = {}
        for sid, (pattern, group, conn) in list(self.subs.items()):
            if conn.closed or not subject_matches(pattern, subject):
                continue
            if group is None:
                await conn.send(
                    {"push": "msg", "sid": sid, "subject": subject, "payload": payload, "reply": reply}
                )
                delivered += 1
            else:
                groups_seen.setdefault((pattern, group), []).append((sid, conn))
        for key, members in groups_seen.items():
            idx = self._group_rr.get(key, 0) % len(members)
            self._group_rr[key] = idx + 1
            sid, conn = members[idx]
            await conn.send(
                {"push": "msg", "sid": sid, "subject": subject, "payload": payload, "reply": reply}
            )
            delivered += 1
        return delivered

    def _queue(self, name: str) -> asyncio.Queue:
        if name not in self.queues:
            self.queues[name] = asyncio.Queue()
            self.inflight[name] = {}
        return self.queues[name]

    async def _queue_pop(self, conn: _ServerConn, req: dict) -> dict:
        q = self._queue(req["queue"])
        timeout = req.get("timeout")
        try:
            if timeout is None:
                payload = await q.get()
            else:
                payload = await asyncio.wait_for(q.get(), timeout)
        except asyncio.TimeoutError:
            return {"payload": None}
        if conn.closed:
            # popper died while blocked — hand the job straight back instead
            # of parking it invisible for the full visibility window
            q.put_nowait(payload)
            return {"payload": None}
        item_id = next(self._ids)
        qname = req["queue"]
        self.inflight[qname][item_id] = payload
        visibility = float(req.get("visibility", 60.0))
        loop = asyncio.get_running_loop()

        def _redeliver():
            pending = self.inflight[qname].pop(item_id, None)
            if pending is not None:
                q.put_nowait(pending)

        loop.call_later(visibility, _redeliver)
        return {"payload": payload, "item": item_id}


class DynStoreClient(DiscoveryClient, MessagingClient):
    """One client implementing both planes over a single multiplexed TCP conn.

    Survives broker restarts (reference analog: etcd lease
    re-establishment, lib/runtime/src/transports/etcd/lease.rs:19-117):
    on connection loss it reconnects with backoff and restores the whole
    session — leases are re-granted (their *client-side* ids are stable,
    so lease-derived endpoint keys/subjects don't change), lease-attached
    keys are re-put, prefix watches re-arm (emitting synthetic PUT/DELETE
    events for whatever changed while detached), and subscriptions
    re-subscribe. In-flight RPCs at the moment of loss still fail; new
    RPCs block until the session is back (up to ``max_reconnect_wait``).

    Scope note: only *lease-attached* keys are restored — they are this
    client's ephemeral registrations. Durable unleased KV lives in the
    broker, which is a single unreplicated process; restart loses it.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT):
        self.host = host
        self.port = port
        self.reconnect = True          # False restores fail-fast semantics
        self.max_reconnect_wait = 30.0  # how long new RPCs wait for a session
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._watchers: Dict[int, PrefixWatcher] = {}
        self._subs: Dict[int, Subscription] = {}
        # pushes that arrive between the watch/sub RPC response frame and the
        # awaiting coroutine registering its watcher/subscription object
        self._early_pushes: Dict[int, list] = {}
        self._dead_ids: set = set()  # cancelled wids/sids — never buffer these
        self._ids = itertools.count(1)
        self._reader_task: Optional[asyncio.Task] = None
        self._keepalive_tasks: Dict[int, asyncio.Task] = {}
        self._send_lock = asyncio.Lock()
        self._primary_lease: Optional[Lease] = None
        self._closed = False
        self._bg_tasks: set = set()
        # client-lease-handle -> {"server": server lease id, "ttl": float,
        # "keys": {key: value}} — everything needed to rebuild the session
        self._client_leases: Dict[int, Dict] = {}
        self._connected = asyncio.Event()
        self._reconnect_task: Optional[asyncio.Task] = None

    def _spawn_bg(self, coro) -> None:
        """Fire-and-forget RPC with a strong task reference (GC-safe)."""
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)

        def _done(t):
            self._bg_tasks.discard(t)
            if not t.cancelled() and t.exception() is not None:
                logger.debug("background rpc failed: %s", t.exception())

        task.add_done_callback(_done)

    async def connect(self) -> "DynStoreClient":
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        self._reader_task = asyncio.create_task(self._read_loop())
        self._connected.set()
        return self

    async def close(self) -> None:
        self._closed = True
        for t in self._keepalive_tasks.values():
            t.cancel()
        if self._reconnect_task:
            self._reconnect_task.cancel()
        if self._reader_task:
            self._reader_task.cancel()
        if self._writer:
            self._writer.close()

    async def _read_loop(self) -> None:
        assert self._reader is not None
        while True:
            frame = await read_frame(self._reader)
            if frame is None:
                break
            if "push" in frame:
                self._handle_push(frame)
            else:
                fut = self._pending.pop(frame.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(frame)
        # connection lost: fail all in-flight RPCs (their responses are gone)
        self._connected.clear()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("dynstore connection lost"))
        self._pending.clear()
        if self._closed or not self.reconnect:
            for w in self._watchers.values():
                w.cancel()
            for s in self._subs.values():
                s.cancel()
            return
        if self._reconnect_task is None or self._reconnect_task.done():
            self._reconnect_task = asyncio.create_task(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        """Re-dial with exponential backoff, then rebuild the session."""
        delay = 0.05
        while not self._closed:
            try:
                self._reader, self._writer = await asyncio.open_connection(
                    self.host, self.port
                )
            except OSError:
                await asyncio.sleep(delay)
                delay = min(delay * 2, 2.0)
                continue
            self._reader_task = asyncio.create_task(self._read_loop())
            try:
                await self._restore_session()
            except (ConnectionError, OSError, RuntimeError, asyncio.TimeoutError) as e:
                logger.warning("dynstore session restore failed, retrying: %s", e)
                self._writer.close()
                await asyncio.sleep(delay)
                delay = min(delay * 2, 2.0)
                continue
            self._connected.set()
            logger.info("dynstore reconnected to %s:%d", self.host, self.port)
            return

    async def _restore_session(self) -> None:
        """Re-grant leases, re-put their keys, re-arm watches and subs.

        Watch re-arm reconciles the broker's current state against what the
        watcher had already seen, emitting synthetic DELETE/PUT events so
        consumers converge without missing transitions.

        Order matters and mirrors initial bring-up (component.py serve):
        subscriptions re-arm BEFORE lease keys re-put — the moment another
        client's watch sees our re-registered endpoint key it may push a
        request at our subject, which must already have its subscriber."""
        # the new broker allocates ids from scratch: stale wid/sid state
        # from the old id space must go first, or a fresh id that collides
        # with an old one gets evicted/dropped by the stale bookkeeping
        live_subs = list(self._subs.values())
        live_watchers = list(self._watchers.values())
        self._subs.clear()
        self._watchers.clear()
        self._early_pushes.clear()
        self._dead_ids.clear()

        for sub in live_subs:
            kwargs = {"group": sub._dyn_group} if sub._dyn_group else {}
            resp = await self._rpc_now("sub", subject=sub._dyn_subject, **kwargs)
            sub._dyn_sid = resp["sid"]
            self._subs[resp["sid"]] = sub
            self._drain_early(resp["sid"])
        for state in self._client_leases.values():
            resp = await self._rpc_now("lease_grant", ttl=state["ttl"])
            state["server"] = resp["lease"]
            for key, value in state["keys"].items():
                await self._rpc_now(
                    "kv_put", key=key, value=value, lease=state["server"]
                )
        for watcher in live_watchers:
            resp = await self._rpc_now("watch", prefix=watcher._dyn_prefix)
            watcher._dyn_wid = resp["wid"]
            self._watchers[resp["wid"]] = watcher
            seen: Dict[str, bytes] = watcher._dyn_seen
            now_kvs: Dict[str, bytes] = resp["kvs"]
            for key in [k for k in seen if k not in now_kvs]:
                watcher._emit(WatchEvent(WatchEventType.DELETE, key, seen.pop(key)))
            for key, value in now_kvs.items():
                if seen.get(key) != value:
                    seen[key] = value
                    watcher._emit(WatchEvent(WatchEventType.PUT, key, value))
            self._drain_early(resp["wid"])

    def _handle_push(self, frame: dict) -> None:
        kind = frame["push"]
        if kind == "watch":
            watcher = self._watchers.get(frame["wid"])
            if watcher is not None:
                ev = WatchEvent(
                    WatchEventType(frame["type"]), frame["key"], frame["value"]
                )
                # track what the consumer has seen so a reconnect can
                # reconcile (synthetic events for the detached window)
                if ev.type is WatchEventType.PUT:
                    watcher._dyn_seen[ev.key] = ev.value
                else:
                    watcher._dyn_seen.pop(ev.key, None)
                watcher._emit(ev)
            else:
                self._buffer_early(frame["wid"], frame)
        elif kind == "msg":
            sub = self._subs.get(frame["sid"])
            if sub is not None:
                sub._emit(
                    Message(
                        subject=frame["subject"],
                        payload=frame["payload"],
                        reply=frame.get("reply"),
                    )
                )
            else:
                self._buffer_early(frame["sid"], frame)

    def _buffer_early(self, rid: int, frame: dict) -> None:
        if rid in self._dead_ids:
            return  # push racing a cancellation — drop, don't accumulate
        if len(self._early_pushes) >= 256 and rid not in self._early_pushes:
            return  # cap distinct ids; genuinely-early windows are tiny
        buf = self._early_pushes.setdefault(rid, [])
        if len(buf) < 4096:
            buf.append(frame)

    def _drain_early(self, rid: int) -> None:
        for frame in self._early_pushes.pop(rid, []):
            self._handle_push(frame)

    async def _rpc_now(self, op: str, rpc_timeout: Optional[float] = 30.0, **kwargs) -> dict:
        """Issue an RPC on the current connection (no reconnect gate) —
        used by session restore, which runs while disconnected-for-users."""
        if self._writer is None:
            raise ConnectionError("client not connected")
        rid = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        async with self._send_lock:
            write_frame(self._writer, {"op": op, "id": rid, **kwargs})
            await self._writer.drain()
        resp = await asyncio.wait_for(fut, rpc_timeout)
        if not resp.get("ok"):
            raise RuntimeError(f"dynstore {op} failed: {resp.get('error')}")
        return resp

    async def _rpc(self, op: str, rpc_timeout: Optional[float] = 30.0, **kwargs) -> dict:
        if not self._connected.is_set() and self.reconnect and not self._closed:
            try:
                await asyncio.wait_for(
                    self._connected.wait(), self.max_reconnect_wait
                )
            except asyncio.TimeoutError:
                raise ConnectionError(
                    f"dynstore unreachable for {self.max_reconnect_wait}s"
                ) from None
        return await self._rpc_now(op, rpc_timeout, **kwargs)

    # --- DiscoveryClient ---

    def _server_lease(self, lease_id: Optional[int]) -> Optional[int]:
        """Client lease handle → current server lease id. Handles are
        stable across reconnects (endpoint keys embed them); the server id
        changes every re-grant."""
        if lease_id is None:
            return None
        state = self._client_leases.get(lease_id)
        return state["server"] if state else lease_id

    async def grant_lease(self, ttl: float = 10.0) -> Lease:
        resp = await self._rpc("lease_grant", ttl=ttl)
        handle = next(self._ids)
        self._client_leases[handle] = {
            "server": resp["lease"], "ttl": resp["ttl"], "keys": {},
        }
        lease = Lease(id=handle, ttl=resp["ttl"])
        self._keepalive_tasks[handle] = asyncio.create_task(self._keepalive(lease))
        return lease

    async def _keepalive(self, lease: Lease) -> None:
        while not self._closed and lease.id in self._client_leases:
            await asyncio.sleep(lease.ttl / 3.0)
            if not self._connected.is_set():
                # reconnect in progress; restore re-grants the lease
                await self._connected.wait()
                continue
            try:
                resp = await self._rpc_now(
                    "lease_keepalive", lease=self._server_lease(lease.id)
                )
                if not resp.get("alive"):
                    # the broker reaped the lease while the connection
                    # stayed up (e.g. a >ttl event-loop stall): re-grant it
                    # and re-put its keys right here — the reconnect path
                    # only covers connection loss
                    logger.warning(
                        "lease %d reaped while connected — re-granting", lease.id
                    )
                    state = self._client_leases.get(lease.id)
                    if state is not None:
                        g = await self._rpc_now("lease_grant", ttl=state["ttl"])
                        state["server"] = g["lease"]
                        for key, value in state["keys"].items():
                            await self._rpc_now(
                                "kv_put", key=key, value=value,
                                lease=state["server"],
                            )
            except (ConnectionError, RuntimeError, asyncio.TimeoutError):
                continue  # the read loop handles the disconnect

    async def revoke_lease(self, lease_id: int) -> None:
        task = self._keepalive_tasks.pop(lease_id, None)
        if task:
            task.cancel()
        state = self._client_leases.pop(lease_id, None)
        await self._rpc(
            "lease_revoke", lease=state["server"] if state else lease_id
        )

    def _track_lease_key(self, key: str, value: bytes, lease_id: Optional[int]) -> None:
        if lease_id is not None and lease_id in self._client_leases:
            self._client_leases[lease_id]["keys"][key] = value

    async def kv_create(self, key: str, value: bytes, lease_id: Optional[int] = None) -> bool:
        resp = await self._rpc(
            "kv_create", key=key, value=value, lease=self._server_lease(lease_id)
        )
        if resp["created"]:
            self._track_lease_key(key, value, lease_id)
        return resp["created"]

    async def kv_put(self, key: str, value: bytes, lease_id: Optional[int] = None) -> None:
        await self._rpc(
            "kv_put", key=key, value=value, lease=self._server_lease(lease_id)
        )
        self._track_lease_key(key, value, lease_id)

    async def kv_get(self, key: str) -> Optional[bytes]:
        return (await self._rpc("kv_get", key=key))["value"]

    async def kv_get_prefix(self, prefix: str) -> Dict[str, bytes]:
        return (await self._rpc("kv_get_prefix", prefix=prefix))["kvs"]

    async def kv_delete(self, key: str) -> None:
        await self._rpc("kv_delete", key=key)
        for state in self._client_leases.values():
            state["keys"].pop(key, None)

    async def watch_prefix(self, prefix: str):
        resp = await self._rpc("watch", prefix=prefix)
        wid = resp["wid"]

        def on_cancel():
            live_wid = watcher._dyn_wid  # may have been re-armed since
            self._watchers.pop(live_wid, None)
            self._early_pushes.pop(live_wid, None)
            self._dead_ids.add(live_wid)
            if not self._closed:
                self._spawn_bg(self._rpc("unwatch", wid=live_wid))

        watcher = PrefixWatcher(on_cancel=on_cancel)
        watcher._dyn_prefix = prefix
        watcher._dyn_wid = wid
        watcher._dyn_seen = dict(resp["kvs"])
        self._watchers[wid] = watcher
        self._drain_early(wid)
        return resp["kvs"], watcher

    # --- MessagingClient ---

    async def publish(self, subject: str, payload: bytes) -> None:
        await self._rpc("pub", subject=subject, payload=payload)

    def _make_sub(self, sid: int, subject: str, group: Optional[str]) -> Subscription:
        def on_cancel():
            live_sid = sub._dyn_sid  # may have been re-armed since
            self._subs.pop(live_sid, None)
            self._early_pushes.pop(live_sid, None)
            self._dead_ids.add(live_sid)
            if not self._closed:
                self._spawn_bg(self._rpc("unsub", sid=live_sid))

        sub = Subscription(on_cancel=on_cancel)
        sub._dyn_subject = subject
        sub._dyn_group = group
        sub._dyn_sid = sid
        self._subs[sid] = sub
        self._drain_early(sid)
        return sub

    async def subscribe(self, subject: str) -> Subscription:
        resp = await self._rpc("sub", subject=subject)
        return self._make_sub(resp["sid"], subject, None)

    async def service_subscribe(self, subject: str, queue_group: str) -> Subscription:
        resp = await self._rpc("sub", subject=subject, group=queue_group)
        return self._make_sub(resp["sid"], subject, queue_group)

    async def request(self, subject: str, payload: bytes, timeout: float = 30.0) -> bytes:
        reply_subject = f"_inbox.{id(self)}.{next(self._ids)}"
        reply_sub = await self.subscribe(reply_subject)
        try:
            resp = await self._rpc("pub", subject=subject, payload=payload, reply=reply_subject)
            if resp.get("delivered", 0) == 0:
                raise ConnectionError(f"no responders on subject {subject!r}")
            msg = await asyncio.wait_for(reply_sub.__anext__(), timeout)
            return msg.payload
        finally:
            reply_sub.cancel()

    async def queue_push(self, queue: str, payload: bytes) -> None:
        await self._rpc("queue_push", queue=queue, payload=payload)

    async def queue_pop(
        self, queue: str, timeout: Optional[float] = None, visibility: float = 60.0
    ) -> Optional[WorkItem]:
        while True:
            try:
                resp = await self._rpc(
                    "queue_pop",
                    rpc_timeout=None if timeout is None else timeout + 5.0,
                    queue=queue,
                    **({"timeout": timeout} if timeout is not None else {}),
                    visibility=visibility,
                )
                break
            except ConnectionError:
                # an indefinitely-blocking pop rides out broker restarts;
                # timed pops surface the error (callers own the retry)
                if timeout is not None or self._closed or not self.reconnect:
                    raise
        if resp["payload"] is None:
            return None
        item_id = resp["item"]

        def ack():
            self._spawn_bg(self._rpc("queue_ack", queue=queue, item=item_id))

        return WorkItem(payload=resp["payload"], ack=ack)

    async def queue_depth(self, queue: str) -> int:
        return (await self._rpc("queue_depth", queue=queue))["depth"]


def main() -> None:
    parser = argparse.ArgumentParser(description="dynamo-tpu control/message plane server (PyTorch port)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args()
    from ...utils.logging import setup_logging
    setup_logging(logging.DEBUG if args.verbose else logging.INFO)
    server = DynStoreServer(args.host, args.port)
    try:
        asyncio.run(server.serve_forever())
    except KeyboardInterrupt:  # SIGINT is the broker's way to stop
        pass


if __name__ == "__main__":
    main()
