"""RouterEvent recorder and replay: offline router-policy evaluation.

Capture a component's KV events to JSONL, replay them later into a fresh
indexer to evaluate routing policies without a cluster. Reference analog:
lib/llm/src/recorder.rs + kv_router/recorder.rs.

The port's copy of ``dynamo_tpu/kv_router/recorder.py``: the events are
decoded with the port's wire codec (``runtime/wire.py``) instead of
msgpack, and each line is the reference's (``{"ts": <wall time>, "event":
<the event's wire dict>}``), so either package replays the other's file.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import os
import time
from typing import Iterator, Optional, Union

from ..runtime.component import Component
from ..runtime.wire import unpackb
from .indexer import KvIndexer, ShardedKvIndexer
from .protocols import KV_EVENT_SUBJECT, RouterEvent

logger = logging.getLogger(__name__)


class KvRecorder:
    """Subscribes to a component's kv_events and appends them to JSONL;
    with ``max_bytes`` the file rotates to ``<path>.<unix seconds>`` (then
    ``.1``, ``.2``, ... within one second) once it passes the bound."""

    def __init__(
        self,
        component: Component,
        path: str,
        max_bytes: Optional[int] = None,
    ):
        self.component = component
        self.path = path
        self.max_bytes = max_bytes
        self.count = 0
        self._task = None
        self._sub = None
        self._fh = None
        # one writer thread: every file op (open, write, rotate, close) runs
        # on it in submission order, so stop() can never close the handle
        # under a write in flight
        self._io: Optional[concurrent.futures.ThreadPoolExecutor] = None

    async def start(self) -> "KvRecorder":
        # file IO off the loop: the recorder shares it with the router's hot
        # path, and an open() or flush() on a slow filesystem must not stall it
        self._io = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="kv-recorder")
        loop = asyncio.get_running_loop()
        self._fh = await loop.run_in_executor(self._io, open, self.path, "a")
        self._sub = await self.component.subscribe_event(KV_EVENT_SUBJECT)
        self._task = self.component.drt.runtime.spawn(self._consume())
        return self

    async def _consume(self) -> None:
        loop = asyncio.get_running_loop()
        async for msg in self._sub:
            try:
                event = unpackb(msg.payload)
                line = json.dumps({"ts": time.time(), "event": event}) + "\n"
                await loop.run_in_executor(self._io, self._write_line, line)
                self.count += 1
                # the write just awaited is done: no op of _io is in flight
                if self.max_bytes and self._fh.tell() > self.max_bytes:
                    await loop.run_in_executor(self._io, self._rotate)
            except Exception:
                logger.exception("record failed")

    # the methods below run only on the one-worker _io executor
    def _write_line(self, line: str) -> None:
        self._fh.write(line)
        self._fh.flush()

    def _rotate(self) -> None:
        self._fh.close()
        # <path>.<unix seconds>, as the reference names it; a second rotation
        # within the same second takes <path>.<seconds>.<n> instead of
        # renaming over the first (the reference's loses that file)
        target = base = f"{self.path}.{int(time.time())}"
        n = 0
        while os.path.exists(target):
            n += 1
            target = f"{base}.{n}"
        os.rename(self.path, target)
        self._fh = open(self.path, "a")

    async def stop(self) -> None:
        if self._sub:
            self._sub.cancel()
        if self._task:
            self._task.cancel()
        if self._fh:
            # close on the writer thread, reading self._fh when it runs: FIFO
            # order puts it after any queued write or rotate (which may have
            # swapped the handle)
            await asyncio.get_running_loop().run_in_executor(
                self._io, self._close_fh)
        if self._io:
            self._io.shutdown(wait=False)
            self._io = None

    def _close_fh(self) -> None:
        fh, self._fh = self._fh, None
        if fh is not None:
            fh.close()


def iter_recorded_events(path: str) -> Iterator[RouterEvent]:
    with open(path) as f:
        for line in f:
            if line.strip():
                yield RouterEvent.from_wire(json.loads(line)["event"])


def replay_events(
    path: str,
    indexer: Union[KvIndexer, ShardedKvIndexer],
    timed: bool = False,
) -> int:
    """Feed recorded events into an indexer; returns the event count. With
    ``timed`` the gaps between the events' wall times are slept (each at
    most 1 s)."""
    n = 0
    last_ts = None
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if timed and last_ts is not None:
                time.sleep(max(0.0, min(1.0, rec["ts"] - last_ts)))
            last_ts = rec["ts"]
            indexer.apply_event(RouterEvent.from_wire(rec["event"]))
            n += 1
    return n
