"""Transfer-plane core: the poison set, the bounded frame pipe, the
unified ``dynamo_transfer_*`` family and the backend negotiation.

The port's copy of ``dynamo_tpu/transfer/plane.py``; the per-plane
handlers (``disagg/prefill_worker.py``, ``kv/fabric.py``,
``recovery/migration.py``) compose these pieces:

- ``PoisonSet``: request ids whose payload stream can no longer be
  trusted (a frame lost, unauthorized, of another cache layout, or a
  connection that died mid-stream); their commit is nacked, because
  resuming over blocks that were never scattered corrupts the stream.
  TTL and a logged cap bound it.
- ``FramePipe``: the conveyor between a chunk loop and one wire pump;
  ``maxsize=1`` plus the pump's one-frame lookahead bound live host
  frames at two regardless of sequence length.
- ``TransferMetrics``: the ``dynamo_transfer_*`` instruments (bytes,
  duration, exposed seconds, open channels), labelled ``{plane,
  backend}``, the reference's names and help text. The owners' stats
  dicts (the prefill worker's ``transfers``, the fabric's ``pull_bytes``,
  the controller's ``shipped``) count the same bytes beside them.
- ``record_open``: the ``transfer.open`` flight event (one channel dialled,
  with its backend).
- ``negotiate_backend``: the payload path for one peer pair. The port
  serves ``tcp`` only; the ``ici`` collective plane is refused by name.
- ``maybe_drop_connection``: the ``transfer_conn_drop`` fault seam
  (``utils/faults.py``), consulted between the chunk frames of a pull
  serve.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)

# dropped-payload bookkeeping: ids leave when their commit is nacked; a
# request that never commits would otherwise stay forever. The TTL is far
# past any commit delay (the decode side's prefill timeout is 120 s), so
# expiry never un-poisons a commit that could still arrive; the count cap
# is a last resort and LOGS what it evicts
MAX_DROPPED = 4096
DROPPED_TTL_S = 600.0

# the fault site a plane's chunk loop consults between frames
CONN_DROP_FAULT = "transfer_conn_drop"


def record_open(plane: str, backend: str, peer: str = "",
                trace_id: Optional[str] = None) -> None:
    """``transfer.open`` flight event: one channel dialled (or adopted)
    with its payload backend."""
    from ..telemetry.flight import flight_recorder

    flight_recorder().record("transfer.open", plane=plane, backend=backend,
                             peer=peer or None, trace_id=trace_id)


def maybe_drop_connection() -> bool:
    """The ``transfer_conn_drop`` fault seam: True when the armed fault
    fires; the caller closes its writer, exercising the far side's
    fallback. One call per chunk keeps the drop mid-stream-able."""
    from ..utils import faults

    return faults.fire(CONN_DROP_FAULT)


class PoisonSet:
    """Request ids whose payload stream can no longer be trusted
    (insertion-ordered, so TTL expiry is a prefix scan)."""

    def __init__(self, plane: str):
        self.plane = plane
        self._dropped: Dict[str, float] = {}

    def __len__(self) -> int:
        return len(self._dropped)

    def __contains__(self, request_id: str) -> bool:
        return request_id in self._dropped

    def mark(self, request_id: str, reason: str = "") -> None:
        now = time.monotonic()
        logger.warning("%s transfer: poisoning %s (%s)", self.plane,
                       request_id, reason or "dropped frame")
        self._dropped.pop(request_id, None)
        self._dropped[request_id] = now
        for rid, t in list(self._dropped.items()):
            if now - t <= DROPPED_TTL_S:
                break
            del self._dropped[rid]
        while len(self._dropped) > MAX_DROPPED:
            rid, _ = next(iter(self._dropped.items()))
            del self._dropped[rid]
            logger.error(
                "dropped-payload set over cap (%d); evicting %s: a late "
                "commit for it would now be accepted", MAX_DROPPED, rid)

    def pop(self, request_id: str) -> bool:
        """Consume a poison mark at commit time: True → nack."""
        return self._dropped.pop(request_id, None) is not None


class FramePipe:
    """Bounded conveyor between the chunk loop and one transfer pump.

    The producer dispatches device gathers (their host copies started
    behind them) and enqueues ``(staged, dst_ids)`` frames; the pump
    drains them to the wire. ``maxsize=1`` plus the pump's one-frame
    lookahead bound live host frames at two."""

    def __init__(self, depth: int, frame_blocks: int):
        self.depth = depth  # 1 = strictly serial frames, 2 = double-buffered
        self.frame_blocks = frame_blocks  # max KV blocks per frame
        self.q: asyncio.Queue = asyncio.Queue(maxsize=1)
        self.closed = False  # the pump consumed the end-of-stream sentinel
        self.error: Optional[BaseException] = None
        self.nbytes = 0
        self.frames = 0
        self.first_frame_t: Optional[float] = None
        self.live_host_frames = 0
        self.max_live_host_frames = 0
        self.task: Optional[asyncio.Task] = None

    async def put(self, frame) -> None:
        if self.error is not None:
            raise self.error
        if self.first_frame_t is None:
            self.first_frame_t = time.monotonic()
        await self.q.put(frame)
        # the pump may have failed while we were blocked on the queue
        if self.error is not None:
            raise self.error

    async def drain(self) -> int:
        """Flush: every enqueued frame is on the wire (or the pump's
        failure is re-raised). Awaited before the commit frame."""
        await self.q.put(None)
        await self.task
        if self.error is not None:
            raise self.error
        return self.nbytes

    async def shutdown(self) -> None:
        """Abnormal-exit cleanup: the happy path joined the pump through
        ``drain``; anything else is an error or cancel path where the
        connection goes down anyway, so cancel outright."""
        if self.task is not None and not self.task.done():
            self.task.cancel()
            try:
                await self.task
            except asyncio.CancelledError:
                pass


class TransferMetrics:
    """The unified ``dynamo_transfer_*`` instrument family.

    One instance per component registry; every sample carries ``plane``
    (disagg|fabric|migration) and ``backend`` (tcp, or ``local`` for the
    fabric's cold-tier rehydrates, which move bytes without a wire)."""

    def __init__(self, registry, plane: Optional[str] = None):
        self.plane = plane
        self._bytes = registry.counter(
            "dynamo_transfer_bytes_total",
            "KV payload bytes moved across the unified transfer plane, "
            "labelled plane=disagg|fabric|migration and backend=tcp|ici|"
            "local")
        self._duration = registry.histogram(
            "dynamo_transfer_duration_seconds",
            "One transfer end to end (first frame enqueued/dialled → "
            "commit acked or last block installed), labelled "
            "{plane, backend}")
        self._exposed = registry.histogram(
            "dynamo_transfer_exposed_seconds",
            "Non-overlapped transfer tail: wire time AFTER the covering "
            "compute finished (commit RTT included; 0 = fully hidden "
            "behind compute), labelled {plane, backend}")
        self._channels = registry.gauge(
            "dynamo_transfer_channels",
            "Open transfer channels (control connections), labelled "
            "{plane, backend}")

    def _labels(self, backend: str, plane: Optional[str]) -> dict:
        return {"plane": plane or self.plane or "?", "backend": backend}

    def add_bytes(self, n: int, backend: str,
                  plane: Optional[str] = None) -> None:
        self._bytes.inc(n, **self._labels(backend, plane))

    def observe_duration(self, seconds: float, backend: str,
                         plane: Optional[str] = None) -> None:
        self._duration.observe(seconds, **self._labels(backend, plane))

    def observe_exposed(self, seconds: float, backend: str,
                        plane: Optional[str] = None) -> None:
        self._exposed.observe(seconds, **self._labels(backend, plane))

    def channel_opened(self, backend: str,
                       plane: Optional[str] = None) -> None:
        self._channels.inc(1, **self._labels(backend, plane))

    def channel_closed(self, backend: str,
                       plane: Optional[str] = None) -> None:
        self._channels.dec(1, **self._labels(backend, plane))


def negotiate_backend(descriptor: Optional[dict], ici=None,
                      peer_role: str = "receiver") -> str:
    """The payload backend for one peer pair: ``tcp``, the one the port
    serves. A collective plane (``ici``) is refused by name; so is a peer
    whose descriptor offers no tcp."""
    if ici is not None:
        raise NotImplementedError(
            "the ici transfer backend (a device-to-device collective plane) "
            "is not ported to the PyTorch engine; use --kv-transfer tcp")
    modes = (descriptor or {}).get("modes") or ("tcp",)
    if "tcp" not in modes:
        raise ValueError(f"the {peer_role} offers no tcp transfer "
                         f"(modes {list(modes)})")
    return "tcp"
