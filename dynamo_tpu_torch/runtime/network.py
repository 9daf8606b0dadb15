"""Network data plane: dial-back response streaming.

Request/response flow across processes (mirrors the reference's two-part
message + TCP dial-back design, reference:
lib/runtime/src/pipeline/network/egress/push.rs:88-180 and
network/tcp/{server,client}.rs):

1. The *requester* registers a stream with its process-wide ``StreamServer``
   and gets a ``conn_info`` descriptor (scheme/host/port/stream_id).
2. The request — a two-part message ``{header: {req_id, conn}, payload}`` —
   is pushed over the message plane to the chosen worker instance subject.
3. The *worker* dials back (TCP, or a process-local queue when both ends
   share a process), sends a prologue (``ok`` or an engine-creation error),
   then streams data frames; ``stop``/``kill`` control frames flow
   requester→worker on the same connection.

The port's copy of ``dynamo_tpu/runtime/network.py``; its frames are the
reference's, encoded by ``runtime/wire.py``, so a requester of either
package reads a worker of the other.

Frames are 4-byte length-prefixed msgpack maps:
  worker→requester: {t: "prologue", ok, error?} | {t: "data", payload} | {t: "end"}
  requester→worker: {t: "stop"} | {t: "kill"}
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Any, AsyncIterator, Callable, Dict, Optional, Tuple

from .engine import AsyncEngineContext, Context, EngineError
from .wire import read_frame, write_frame

logger = logging.getLogger(__name__)


class ResponseStreamError(Exception):
    """The worker reported an error in the stream prologue or mid-stream."""


class _LocalStream:
    """In-process dial-back: a pair of queues instead of a socket."""

    def __init__(self) -> None:
        self.to_requester: asyncio.Queue = asyncio.Queue()
        self.to_worker: asyncio.Queue = asyncio.Queue()


_local_streams: Dict[str, _LocalStream] = {}


class StreamServer:
    """Per-process receiver for dial-back response streams.

    Lazily started TCP listener (reference: DistributedRuntime::tcp_server,
    lib/runtime/src/distributed.rs:135). Also owns the process-local stream
    registry used when requester and worker share a process.
    """

    def __init__(self, host: str = "127.0.0.1", advertise_host: Optional[str] = None):
        self.host = host
        self.advertise_host = advertise_host or host
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._ids = itertools.count(1)
        self._waiting: Dict[str, asyncio.Future] = {}
        self._start_lock: Optional[asyncio.Lock] = None

    async def ensure_started(self) -> None:
        if self._server is not None:
            return
        if self._start_lock is None:
            self._start_lock = asyncio.Lock()
        async with self._start_lock:
            if self._server is not None:
                return
            server = await asyncio.start_server(self._accept, self.host, 0)
            self.port = server.sockets[0].getsockname()[1]
            self._server = server

    async def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        handshake = await read_frame(reader)
        if handshake is None:
            writer.close()
            return
        stream_id = handshake.get("stream")
        fut = self._waiting.pop(stream_id, None)
        if fut is None or fut.done():
            logger.warning("dial-back for unknown stream %s", stream_id)
            writer.close()
            return
        fut.set_result((reader, writer))

    async def register_tcp(self) -> Tuple[dict, asyncio.Future]:
        """Returns (conn_info, future resolving to (reader, writer))."""
        await self.ensure_started()
        stream_id = f"s{next(self._ids)}"
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiting[stream_id] = fut
        conn = {"scheme": "tcp", "host": self.advertise_host, "port": self.port, "stream": stream_id}
        return conn, fut

    def register_local(self) -> Tuple[dict, _LocalStream]:
        stream_id = f"l{next(self._ids)}"
        stream = _LocalStream()
        _local_streams[stream_id] = stream
        conn = {"scheme": "local", "stream": stream_id}
        return conn, stream

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


async def respond_to(
    conn_info: dict,
    stream_fn: Callable[[AsyncEngineContext], AsyncIterator[Any]],
    request_id: str,
    trace_id: Optional[str] = None,
    span_source: str = "worker",
) -> None:
    """Worker side: dial back and pump ``stream_fn``'s output to the requester.

    Control frames from the requester (stop/kill) are applied to the
    engine context while streaming. ``trace_id`` is the ingress-assigned
    correlation id riding the message header; ``request_id`` (the per-hop
    wire id) keys worker-side engine state. ``span_source`` names this
    process in the cluster-stitched trace: the ``end`` frame piggybacks
    the context's span marks (plus any remote sets it collected from
    planes further downstream) back to the requester, stamped with the
    request-receipt and response-send wall times the requester needs for
    clock-offset estimation (telemetry/stitch.py).
    """
    import time as _time

    recv_at = _time.time()  # request receipt on THIS process's clock
    ctx = AsyncEngineContext(request_id, trace_id=trace_id)
    scheme = conn_info.get("scheme")
    if scheme == "local":
        stream = _local_streams.pop(conn_info["stream"], None)
        if stream is None:
            logger.warning("local stream %s vanished", conn_info.get("stream"))
            return

        async def send(frame: dict) -> None:
            stream.to_requester.put_nowait(frame)

        async def control_loop():
            while True:
                frame = await stream.to_worker.get()
                if frame is None:
                    return
                _apply_control(frame, ctx)

        ctrl_task = asyncio.create_task(control_loop())
        try:
            await _pump(stream_fn, ctx, send, span_source, recv_at)
        finally:
            ctrl_task.cancel()
        return

    if scheme == "tcp":
        try:
            reader, writer = await asyncio.open_connection(conn_info["host"], conn_info["port"])
        except OSError as e:
            logger.warning("dial-back to %s failed: %s", conn_info, e)
            return
        write_frame(writer, {"stream": conn_info["stream"]})
        await writer.drain()

        async def control_loop():
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    # requester went away entirely → kill
                    ctx.kill()
                    return
                _apply_control(frame, ctx)

        ctrl_task = asyncio.create_task(control_loop())

        async def send(frame: dict) -> None:
            # drain per frame: backpressure from a slow requester propagates
            # into the generator instead of ballooning the send buffer
            write_frame(writer, frame)
            await writer.drain()

        try:
            await _pump(stream_fn, ctx, send, span_source, recv_at)
        except (ConnectionResetError, BrokenPipeError):
            ctx.kill()
        finally:
            ctrl_task.cancel()
            writer.close()
        return

    raise ValueError(f"unknown conn scheme {scheme!r}")


def _apply_control(frame: dict, ctx: AsyncEngineContext) -> None:
    t = frame.get("t")
    if t == "stop":
        ctx.stop_generating()
    elif t == "kill":
        ctx.kill()


async def _pump(
    stream_fn: Callable[[AsyncEngineContext], AsyncIterator[Any]],
    ctx: AsyncEngineContext,
    send,
    span_source: str = "worker",
    recv_at: float = 0.0,
) -> None:
    # Prime the first item BEFORE the prologue: async generators don't run
    # their body until first iteration, so engine-creation errors (EngineError)
    # only surface here — this is what makes the error-prologue contract real.
    try:
        stream = stream_fn(ctx).__aiter__()
        first: Any = await stream.__anext__()
        have_first = True
    except EngineError as e:
        await send({"t": "prologue", "ok": False, "error": str(e)})
        return
    except StopAsyncIteration:
        have_first = False
    except Exception as e:
        logger.exception("engine failed before first response %s", ctx.id)
        await send({"t": "prologue", "ok": False, "error": f"{type(e).__name__}: {e}"})
        return
    await send({"t": "prologue", "ok": True})
    try:
        if have_first and not ctx.is_killed:
            await send({"t": "data", "payload": first})
            async for item in stream:
                if ctx.is_killed:
                    break
                await send({"t": "data", "payload": item})
        # span export piggybacks on the end frame (no extra round trip):
        # this process's marks plus every remote set IT collected from
        # planes further downstream (remote prefill commit, a nested
        # worker hop) — the requester folds them with an offset estimate
        # from (its send time, recv_at, resp_sent_at, its receive time)
        end: dict = {"t": "end"}
        if ctx.stages or ctx.remote_spans:
            import time as _time

            end.update({
                "source": span_source,
                "spans": ctx.export_spans(),
                "children": list(ctx.remote_spans),
                "recv_at": recv_at,
                "resp_sent_at": _time.time(),
            })
        await send(end)
    except Exception as e:  # stream died mid-flight: tell the requester
        logger.exception("response stream %s failed", ctx.id)
        await send({"t": "err", "error": f"{type(e).__name__}: {e}"})


class ResponseReceiver:
    """Requester side: consumes the dialed-back stream as an async iterator."""

    def __init__(self, context: AsyncEngineContext):
        self.context = context
        self._queue: asyncio.Queue = asyncio.Queue()
        self._send_control: Optional[Callable[[dict], None]] = None
        # span export off the end frame: the worker's marks + the wall
        # times the offset estimate needs; resp_recv_at is stamped HERE
        # (this process's clock) when the end frame lands
        self.remote_spans: Optional[dict] = None
        self.resp_recv_at: float = 0.0
        self._prologue: asyncio.Future = asyncio.get_event_loop().create_future()
        # strong ref to the frame-pump task; bare create_task results can be
        # garbage-collected mid-stream, silently freezing the receiver
        self._pump_task: Optional[asyncio.Task] = None

    def stop_generating(self) -> None:
        self.context.stop_generating()
        if self._send_control:
            self._send_control({"t": "stop"})

    def kill(self) -> None:
        self.context.kill()
        if self._send_control:
            self._send_control({"t": "kill"})

    async def wait_prologue(self, timeout: float = 600.0) -> None:
        # generous default: the prologue follows the FIRST response item, so
        # it legitimately waits through a cold start (the first kernel
        # builds)
        """Raises ResponseStreamError if the worker rejected the request."""
        await asyncio.wait_for(asyncio.shield(self._prologue), timeout)
        err = self._prologue.result()
        if err is not None:
            raise ResponseStreamError(err)

    def _feed(self, frame: Optional[dict]) -> bool:
        """Returns False when the stream is finished."""
        if frame is None:
            if not self._prologue.done():
                self._prologue.set_result("connection lost before prologue")
            self._queue.put_nowait(("err", "connection lost"))
            return False
        t = frame.get("t")
        if t == "prologue":
            if not self._prologue.done():
                self._prologue.set_result(None if frame.get("ok") else frame.get("error", "engine error"))
            return True
        if t == "data":
            self._queue.put_nowait(("data", frame["payload"]))
            return True
        if t == "end":
            if frame.get("spans") or frame.get("children"):
                import time as _time

                self.remote_spans = frame
                self.resp_recv_at = _time.time()
            self._queue.put_nowait(("end", None))
            return False
        if t == "err":
            self._queue.put_nowait(("err", frame.get("error", "stream error")))
            return False
        return True

    def __aiter__(self):
        return self

    async def __anext__(self):
        kind, value = await self._queue.get()
        if kind == "data":
            return value
        if kind == "end":
            raise StopAsyncIteration
        raise ResponseStreamError(value)


async def open_response_stream(
    stream_server: StreamServer, local: bool
) -> Tuple[dict, ResponseReceiver]:
    """Requester side setup. Returns (conn_info to embed in the request,
    receiver to iterate)."""
    ctx = AsyncEngineContext()
    receiver = ResponseReceiver(ctx)

    if local:
        conn, stream = stream_server.register_local()

        def send_control(frame: dict) -> None:
            stream.to_worker.put_nowait(frame)

        receiver._send_control = send_control

        async def pump_local():
            while True:
                frame = await stream.to_requester.get()
                if not receiver._feed(frame):
                    break

        receiver._pump_task = asyncio.create_task(pump_local())
        return conn, receiver

    conn, fut = await stream_server.register_tcp()

    async def pump_tcp():
        try:
            reader, writer = await asyncio.wait_for(fut, 60.0)
        except asyncio.TimeoutError:
            stream_server._waiting.pop(conn["stream"], None)
            receiver._feed(None)
            return

        def send_control(frame: dict) -> None:
            try:
                write_frame(writer, frame)
            except (ConnectionResetError, RuntimeError):
                pass

        receiver._send_control = send_control
        try:
            while True:
                frame = await read_frame(reader)
                if not receiver._feed(frame):
                    break
        finally:
            writer.close()

    receiver._pump_task = asyncio.create_task(pump_tcp())
    return conn, receiver
