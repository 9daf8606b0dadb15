"""Out-of-process engine hosting: a supervised child process behind framed IPC.

The port's copy of ``dynamo_tpu/llm/engines/subprocess_host.py``. The
engine runs in a child process that can hang or die; the hosting worker
stays alive, fails the in-flight requests cleanly (an error prologue
before the first output, an error mid-stream after it) and respawns. On a
card the hazard is a child that dies (an out-of-memory, a device fault, a
kill) or wedges its event loop; the worker, its HTTP front and its
discovery lease outlive it.

Plane layout (one unix socket per engine; frames are the runtime's 4-byte
length-prefixed maps of ``runtime/wire.py``, the codec every other plane
of the port speaks)::

    parent → child:  {t: "init", engine_args}          once, first
                     {t: "req",  id, payload}          start a stream
                     {t: "stop", id} | {t: "kill", id} cancel a stream
                     {t: "ping", n}                    heartbeat
                     {t: "shutdown"}                   graceful exit
    child → parent:  {t: "ready", info} | {t: "init_error", error}
                     {t: "data", id, payload}
                     {t: "end",  id} | {t: "error", id, error}
                     {t: "pong", n, m}                 m: engine metrics
                     {t: "kv", ev, hashes, parent}     allocator events

Streams multiplex over the one socket by request id. Heartbeats ride the
same socket on purpose: a child whose event loop is wedged stops ponging
though the process is alive, the failure an exit code cannot show.

Supervision policy: a child that exits, breaks the socket, or misses
``heartbeat_misses`` consecutive pongs is SIGKILLed and reaped; every
in-flight request fails with ``EngineError`` (before its first output) or
``EngineStreamDied`` (mid-stream); the block hashes the child advertised
as stored replay as removed into the worker's sink; the down listeners
hear the reason. The next ``generate`` respawns lazily, up to
``max_restarts`` consecutive failed spawns with exponential backoff; a
successful init resets the budget. An ``init_error`` (the engine's own
constructor raised: a missing file, a kernel library that does not build
or load on the card) is deterministic and is not retried.

The built-in engine ``@torch`` is ``TorchServingEngine`` built from the
parent CLI's flag dict (``engine_args["flags"]``); its allocator's stored
and removed events come back as ``kv`` frames. Cold-tier residency
events stay in the child, as in the reference. The ``ready`` frame's
``info`` carries the child's pid and, on a card, its free device memory
read before the engine loaded (``torch.cuda.mem_get_info``).

Engine-author contract: the heartbeat measures the child's EVENT LOOP, so
a ``generate`` that runs long synchronous work inline stops ponging and is
killed as wedged. Run such work in an executor, or raise the budget: the
defaults (5 s × 6 misses, ``init_timeout_s`` 120) are the CLI's
``--engine-heartbeat-s`` / ``--engine-heartbeat-misses`` /
``--engine-init-timeout-s``. A first ``@torch`` start on a fresh tree
builds the kernel libraries inside the init deadline.

    python -m dynamo_tpu_torch.llm.engines.subprocess_host <engine.py|@torch>

is the child's entry point (the host starts it; it dials the socket named
by ``DYN_ENGINE_SOCKET``).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import sys
import tempfile
import time
import uuid
from typing import Any, AsyncIterator, Dict, List, Optional

from ...runtime.engine import AsyncEngine, Context, EngineError
from ...runtime.wire import read_frame, write_frame
from .python_file import to_wire

logger = logging.getLogger(__name__)

SOCKET_ENV = "DYN_ENGINE_SOCKET"
CHILD_MODULE = "dynamo_tpu_torch.llm.engines.subprocess_host"
TORCH_ENGINE = "@torch"
# how long close() waits for a child to close its engine and exit
CHILD_EXIT_TIMEOUT_S = 5.0


class EngineStreamDied(EngineError):
    """The engine process died after the stream had started (an
    ``EngineError``, so the HTTP edge ends the stream with an error chunk)."""


class SubprocessEngine(AsyncEngine):
    """Hosts a Python-file engine (``python_file.py`` contract) or the
    ``@torch`` engine in a supervised child process."""

    def __init__(
        self,
        path: str,
        engine_args: Optional[dict] = None,
        *,
        init_timeout_s: float = 120.0,
        heartbeat_interval_s: float = 5.0,
        heartbeat_misses: int = 6,
        max_restarts: int = 3,
        restart_backoff_s: float = 0.5,
        child_env: Optional[Dict[str, str]] = None,
        events=None,  # KvEventSink: the child's "kv" frames replay into it
    ):
        self.path = path
        self.engine_args = engine_args or {}
        self.events = events
        # refreshed by each pong (the child sends engine.metrics() with it);
        # read synchronously by stats handlers and /metrics
        self._last_metrics: dict = {}
        # block hashes the live child advertised as stored: a child that
        # dies takes its allocator with it, so the sink must see them
        # removed or the KV router would route to hits that cannot occur
        self._kv_live_hashes: set = set()
        self.init_timeout_s = init_timeout_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.heartbeat_misses = heartbeat_misses
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.child_env = child_env

        self._proc: Optional[asyncio.subprocess.Process] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._hb_task: Optional[asyncio.Task] = None
        self._streams: Dict[str, asyncio.Queue] = {}
        self._pong = 0
        self._pong_t: Optional[float] = None
        self._spawn_lock: Optional[asyncio.Lock] = None
        self._consecutive_failures = 0
        self._closed = False
        # successful spawns, and one record each: pid, seconds from the
        # spawn to ready, the child's ready info (its free card memory)
        self.spawn_count = 0
        self.spawns: List[dict] = []
        # the largest gap between two pongs of the live child (its loop's
        # worst stall plus one interval)
        self.pong_gap_max_s = 0.0
        from ...telemetry.registry import MetricsRegistry

        self.host_registry = MetricsRegistry()
        self._restarts = self.host_registry.counter(
            "dynamo_engine_restarts_total",
            "Supervised engine-child respawns, labelled reason="
            "exit|heartbeat|disconnect|manual (what took the previous "
            "child down)")
        self._gap_gauge = self.host_registry.gauge(
            "dynamo_engine_heartbeat_gap_max_seconds",
            "Largest gap between two heartbeat pongs of the live engine "
            "child (its event loop's worst stall plus one interval)")
        self._last_down_kind: Optional[str] = None
        # child-death subscribers (recovery/controller.py): called with the
        # down kind AFTER the streams are failed; never during close()
        self._down_listeners: list = []

    @classmethod
    async def load(cls, path: str, engine_args: Optional[dict] = None,
                   **kw) -> "SubprocessEngine":
        # "@"-prefixed specs are built-in engines ("@torch"), not files
        if not path.startswith("@") and not os.path.exists(path):
            raise FileNotFoundError(f"python engine file not found: {path}")
        eng = cls(path, engine_args, **kw)
        await eng._ensure_running()
        return eng

    def metrics(self) -> dict:
        """Engine metrics as of the last heartbeat pong (the hosted
        engine's ``metrics()``; {} until the first pong arrives)."""
        return self._last_metrics

    @property
    def pid(self) -> Optional[int]:
        """The live child's pid (None while none runs)."""
        return self._proc.pid if self._proc is not None else None

    # ---------- lifecycle ----------

    async def _ensure_running(self) -> None:
        if self._closed:
            raise EngineError("engine host is closed")
        if self._spawn_lock is None:
            self._spawn_lock = asyncio.Lock()
        async with self._spawn_lock:
            if (self._proc is not None and self._proc.returncode is None
                    and self._writer is not None):
                return
            delay = self.restart_backoff_s
            while True:
                if self._consecutive_failures > self.max_restarts:
                    raise EngineError(
                        f"engine {self.path} failed to start "
                        f"{self._consecutive_failures} consecutive times; "
                        "giving up")
                try:
                    await self._spawn_once()
                    self._consecutive_failures = 0
                    return
                except EngineError:
                    raise
                except Exception as e:
                    self._consecutive_failures += 1
                    logger.warning("engine spawn attempt failed (%d/%d): %s",
                                   self._consecutive_failures,
                                   self.max_restarts, e)
                    if self._consecutive_failures > self.max_restarts:
                        raise EngineError(
                            f"engine {self.path} failed to start: {e}") from e
                    await asyncio.sleep(delay)
                    delay *= 2

    def _child_environ(self, sock_path: str) -> Dict[str, str]:
        env = dict(os.environ if self.child_env is None else self.child_env)
        env[SOCKET_ENV] = sock_path
        # the child runs `-m dynamo_tpu_torch...`: the package must import
        # whatever the parent's working directory
        pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        pp = env.get("PYTHONPATH")
        env["PYTHONPATH"] = pkg_parent + (os.pathsep + pp if pp else "")
        return env

    async def _spawn_once(self) -> None:
        sock_dir = tempfile.mkdtemp(prefix="dyn-engine-")
        sock_path = os.path.join(sock_dir, "ipc.sock")
        connected: asyncio.Future = asyncio.get_running_loop().create_future()

        async def on_connect(reader, writer):
            if not connected.done():
                connected.set_result((reader, writer))
            else:  # only the hosted child may dial in
                writer.close()

        t0 = time.monotonic()
        server = await asyncio.start_unix_server(on_connect, sock_path)
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", CHILD_MODULE, self.path,
            env=self._child_environ(sock_path))
        try:
            reader, writer = await asyncio.wait_for(
                connected, timeout=self.init_timeout_s)
            write_frame(writer, {"t": "init", "engine_args": self.engine_args})
            await writer.drain()
            frame = await asyncio.wait_for(read_frame(reader),
                                           timeout=self.init_timeout_s)
            if frame is None:
                raise RuntimeError("engine exited during init")
            if frame.get("t") == "init_error":
                # a deterministic failure of the engine's own: no retry
                raise EngineError(f"engine init failed: {frame.get('error')}")
            if frame.get("t") != "ready":
                raise RuntimeError(f"unexpected init reply {frame.get('t')!r}")
        except BaseException:
            with contextlib.suppress(ProcessLookupError):
                proc.kill()
            with contextlib.suppress(Exception):
                await proc.wait()
            raise
        finally:
            server.close()
            # the socket exists for the dial-in only; a crash-looping engine
            # must not pile up temporary directories
            with contextlib.suppress(OSError):
                os.unlink(sock_path)
            with contextlib.suppress(OSError):
                os.rmdir(sock_dir)
        ready_s = time.monotonic() - t0
        self._proc = proc
        self._writer = writer
        self._pong = 0
        self._pong_t = None
        self.pong_gap_max_s = 0.0
        self._gap_gauge.set(0.0)
        self.spawn_count += 1
        self.spawns.append(dict(frame.get("info") or {}, pid=proc.pid,
                                ready_s=ready_s))
        if self.spawn_count > 1:
            # a RE-spawn: the previous child went down for _last_down_kind
            reason = self._last_down_kind or "unknown"
            self._restarts.inc(reason=reason)
            from ...telemetry.flight import flight_recorder

            flight_recorder().record(
                "engine.respawn", path=self.path, pid=proc.pid,
                spawn=self.spawn_count, reason=reason)
        self._reader_task = asyncio.create_task(self._read_loop(reader))
        self._hb_task = asyncio.create_task(self._heartbeat_loop(writer))
        # one line a spawn, its record as JSON (an operator's log, and what
        # a harness reads the spawn's seconds and card memory from)
        logger.info("engine subprocess for %s up (pid %d): %s", self.path,
                    proc.pid, json.dumps(self.spawns[-1]))

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                t = frame.get("t")
                if t == "pong":
                    self._on_pong(frame)
                    continue
                if t == "kv":
                    self._on_kv_frame(frame)
                    continue
                q = self._streams.get(frame.get("id"))
                if q is not None:
                    q.put_nowait(frame)
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
        finally:
            # during close() the child's own exit closes the socket: that
            # EOF is the shutdown, not a death to kill it for
            if not self._closed:
                await self._on_child_down("engine process disconnected")

    def _on_pong(self, frame: dict) -> None:
        now = time.monotonic()
        if self._pong_t is not None:
            gap = now - self._pong_t
            if gap > self.pong_gap_max_s:
                self.pong_gap_max_s = gap
                self._gap_gauge.set(gap)
        self._pong_t = now
        self._pong = frame.get("n", 0)
        if "m" in frame:
            self._last_metrics = frame["m"]

    def _on_kv_frame(self, frame: dict) -> None:
        """Replay a child KV event into the worker-side sink: the KV
        router's index stays current though the allocator lives in the
        child."""
        if self.events is None:
            return
        try:
            hashes = frame.get("hashes") or []
            if frame.get("ev") == "stored":
                self._kv_live_hashes.update(hashes)
                self.events.on_stored(hashes, frame.get("parent"))
            elif frame.get("ev") == "removed":
                self._kv_live_hashes.difference_update(hashes)
                self.events.on_removed(hashes)
        except Exception:
            logger.exception("KV event replay failed")

    async def _heartbeat_loop(self, writer: asyncio.StreamWriter) -> None:
        n = 0
        try:
            while True:
                await asyncio.sleep(self.heartbeat_interval_s)
                n += 1
                write_frame(writer, {"t": "ping", "n": n})
                await writer.drain()
                if n - self._pong > self.heartbeat_misses and not self._closed:
                    logger.error(
                        "engine %s missed %d heartbeats; killing it (a wedged "
                        "child never exits on its own)", self.path,
                        n - self._pong)
                    await self._on_child_down(
                        f"engine unresponsive: missed {n - self._pong} "
                        "heartbeats", kind="heartbeat")
                    return
        except (ConnectionResetError, BrokenPipeError, OSError):
            # during close() the child closes its socket as it exits: a
            # ping that meets it is no death to kill the child for (it may
            # still be closing its engine)
            if not self._closed:
                await self._on_child_down("engine process disconnected")

    async def _on_child_down(self, reason: str,
                             kind: str = "disconnect") -> None:
        """Fail every in-flight stream and reap the child. Idempotent, and
        the hand-off is claimed SYNCHRONOUSLY before the first await: the
        heartbeat path and the read loop's EOF race to call this, and the
        loser must find nothing left to fail (else the requester would see
        the generic 'disconnected' instead of the real reason)."""
        proc, self._proc = self._proc, None
        writer, self._writer = self._writer, None
        streams, self._streams = self._streams, {}
        hb, self._hb_task = self._hb_task, None
        winner = proc is not None or writer is not None or bool(streams)
        # the dead child's cached blocks died with its allocator: purge them
        # from the worker-side index first (synchronously, as below)
        dead_hashes, self._kv_live_hashes = self._kv_live_hashes, set()
        if dead_hashes and self.events is not None:
            try:
                self.events.on_removed(sorted(dead_hashes))
            except Exception:
                logger.exception("KV purge after child death failed")
        if proc is not None and proc.returncode is not None:
            reason = f"{reason} (exit code {proc.returncode})"
            kind = "exit"
        if winner and not self._closed:
            self._last_down_kind = kind
            for fn in list(self._down_listeners):
                try:
                    fn(kind)
                except Exception:
                    logger.exception("engine down listener failed")
        # fail the streams before any await: past the first suspension this
        # task can be cancelled by the competing path (the read loop cancels
        # the heartbeat task and vice versa), and a cancelled loser must not
        # take the error frames with it
        for q in streams.values():
            q.put_nowait({"t": "error", "error": reason, "died": True})
        if hb is not None and hb is not asyncio.current_task():
            hb.cancel()
        if writer is not None:
            with contextlib.suppress(Exception):
                writer.close()
        if proc is not None:
            with contextlib.suppress(ProcessLookupError):
                proc.kill()
            with contextlib.suppress(Exception):
                await proc.wait()

    def add_down_listener(self, fn) -> None:
        """Subscribe to child deaths (a sync callback with the down kind;
        not called for ``close()``). The recovery controller runs its
        respawn ladder from it instead of waiting for the next request to
        pay the spawn."""
        self._down_listeners.append(fn)

    async def respawn(self, reason: str = "manual", card=None) -> None:
        """Kill the current child (failing its streams) and bring a fresh
        one up NOW: the supervised-child half of a recovery respawn or a
        rolling restart. ``card`` (a model card or its wire dict) swaps
        the model a flag-driven ``@torch`` child serves: it re-reads
        ``model_path`` / ``model_name`` on spawn."""
        if card is not None:
            flags = self.engine_args.get("flags")
            if not isinstance(flags, dict):
                raise EngineError(
                    "this engine host cannot swap model cards (no flag-driven "
                    "child; serve out=torch --isolate-engine)")
            wire = card.to_wire() if hasattr(card, "to_wire") else dict(card)
            if not wire.get("model_path"):
                raise EngineError(f"model card {wire.get('name')!r} carries no "
                                  "model_path: cannot cold-start from it")
            flags["model_path"] = wire["model_path"]
            flags["model_name"] = wire.get("name") or flags.get("model_name")
            if wire.get("kv_block_size"):
                flags["kv_block_size"] = int(wire["kv_block_size"])
            reason = f"{reason} (card={wire.get('name')})"
        await self._on_child_down(f"manual respawn: {reason}", kind="manual")
        await self._ensure_running()

    async def close(self) -> None:
        """Ask the child to shut down (it closes its engine and exits), give
        it ``CHILD_EXIT_TIMEOUT_S``, then fail what is left and kill it."""
        self._closed = True
        writer = self._writer
        if writer is not None:
            with contextlib.suppress(Exception):
                write_frame(writer, {"t": "shutdown"})
                await writer.drain()
            proc = self._proc
            if proc is not None:
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(proc.wait(),
                                           timeout=CHILD_EXIT_TIMEOUT_S)
        await self._on_child_down("engine host closed")
        if self._reader_task is not None:
            self._reader_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._reader_task

    # ---------- serving ----------

    async def generate(self, request: Context[Any]) -> AsyncIterator[Any]:
        await self._ensure_running()
        rid = f"{request.id}-{uuid.uuid4().hex[:8]}"
        q: asyncio.Queue = asyncio.Queue()
        self._streams[rid] = q
        writer = self._writer
        started = False
        ctx = request.context

        async def watch_cancel():
            await ctx.wait_stopped()
            w = self._writer
            if w is not None:
                with contextlib.suppress(Exception):
                    write_frame(w, {"t": "kill" if ctx.is_killed else "stop",
                                    "id": rid})
                    await w.drain()

        cancel_task = asyncio.create_task(watch_cancel())
        try:
            write_frame(writer, {"t": "req", "id": rid,
                                 "payload": to_wire(request.payload)})
            await writer.drain()
            while True:
                frame = await q.get()
                t = frame.get("t")
                if t == "data":
                    started = True
                    yield frame.get("payload")
                elif t == "end":
                    return
                elif t == "error":
                    msg = frame.get("error", "engine error")
                    if frame.get("died") and started:
                        # the stream was flowing: a mid-stream error
                        raise EngineStreamDied(msg)
                    raise EngineError(msg)
                else:
                    logger.warning("unexpected engine frame %r", t)
        finally:
            cancel_task.cancel()
            self._streams.pop(rid, None)


# ---------------------------------------------------------------------------
# the child
# ---------------------------------------------------------------------------


def _card_info(device: str) -> dict:
    """The card's free and total memory as the child starts (before its
    engine loads): a respawn after a kill must find the old context's
    memory returned."""
    if not str(device).startswith("cuda"):
        return {}
    import torch

    free, total = torch.cuda.mem_get_info()
    return {"card_free_bytes": int(free), "card_total_bytes": int(total)}


async def _build_child_engine(engine_path: str, engine_args: dict,
                              event_post):
    """The hosted engine and its ready info, inside the child.

    ``engine_path`` is a Python file (the pystr:/pytok: contract) or the
    ``@torch`` sentinel: ``TorchServingEngine`` on the device the parent's
    flags name (``engine_args['flags']``, the CLI's flag namespace as a
    dict); its stored and removed KV events go back to the parent as
    ``{"t": "kv"}`` frames through ``event_post``. On a card the engine's
    warmup loads the kernel libraries ``ops/_build.py`` built (or builds
    them): a library that does not build or load raises here, and the
    parent reports the ``init_error`` without retrying."""
    if engine_path == TORCH_ENGINE:
        from types import SimpleNamespace

        t0 = time.monotonic()
        from ...cli.run import load_mdc
        from ...engine.block_allocator import KvEventSink
        from ...engine.serving import TorchServingEngine

        flags = SimpleNamespace(**(engine_args.get("flags") or {}))
        t1 = time.monotonic()
        info = _card_info(flags.device)
        # where a spawn's seconds go: the imports (torch), the card's
        # context, then the engine (the weights' load and the warmup)
        info.update(import_s=t1 - t0, card_s=time.monotonic() - t1)
        t2 = time.monotonic()
        mdc = load_mdc(flags)
        sink = KvEventSink(
            on_stored=lambda hashes, parent: event_post(
                {"t": "kv", "ev": "stored", "hashes": [int(h) for h in hashes],
                 "parent": None if parent is None else int(parent)}),
            on_removed=lambda hashes: event_post(
                {"t": "kv", "ev": "removed",
                 "hashes": [int(h) for h in hashes]}),
        )
        engine = await TorchServingEngine.create(
            mdc=mdc, flags=flags, device=flags.device, events=sink)
        info["engine_s"] = time.monotonic() - t2
        return engine, info
    from .python_file import PythonFileEngine

    return await PythonFileEngine.load(engine_path, engine_args), {}


def _engine_metrics(engine_path: str, engine) -> Optional[dict]:
    """A pong's metrics: the engine's ``metrics()`` (None for an engine
    without one) and, for ``@torch``, this process's kernel launch counts
    as ``launches_<kernel>``."""
    if not hasattr(engine, "metrics"):
        return None
    m = dict(engine.metrics())
    if engine_path == TORCH_ENGINE:
        from ...cli.run import _kernel_launches

        m.update({f"launches_{k}": v for k, v in _kernel_launches().items()})
    return m


async def _child_main(engine_path: str) -> int:
    reader, writer = await asyncio.open_unix_connection(os.environ[SOCKET_ENV])
    init = await read_frame(reader)
    if init is None or init.get("t") != "init":
        return 2

    tasks: Dict[str, asyncio.Task] = {}
    send_lock = asyncio.Lock()

    async def send(frame: dict) -> None:
        async with send_lock:  # frames of concurrent streams interleave
            write_frame(writer, frame)
            await writer.drain()

    # KV events are posted synchronously from the scheduler's hooks; a FIFO
    # and one pump keep stored/removed in order (a block's stored after its
    # removed would corrupt the router's index)
    event_q: asyncio.Queue = asyncio.Queue()

    async def _event_pump() -> None:
        while True:
            await send(await event_q.get())

    try:
        engine, info = await _build_child_engine(
            engine_path, init.get("engine_args") or {}, event_q.put_nowait)
    # dynlint: allow(silent-except) - the error IS surfaced: the init_error frame below
    except BaseException as e:
        # report, do not just die: an init error is deterministic, not
        # something a restart repairs
        write_frame(writer, {"t": "init_error",
                             "error": f"{type(e).__name__}: {e}"})
        await writer.drain()
        return 3
    pump_task = asyncio.create_task(_event_pump())
    write_frame(writer, {"t": "ready", "info": dict(info, pid=os.getpid())})
    await writer.drain()

    async def run_stream(rid: str, payload: Any) -> None:
        try:
            async for chunk in engine.generate(Context(payload)):
                await send({"t": "data", "id": rid, "payload": chunk})
            await send({"t": "end", "id": rid})
        except asyncio.CancelledError:
            await send({"t": "end", "id": rid})
            raise
        # dynlint: allow(silent-except) - the error IS surfaced: relayed as a frame
        except BaseException as e:
            await send({"t": "error", "id": rid,
                        "error": f"{type(e).__name__}: {e}"})
        finally:
            tasks.pop(rid, None)

    while True:
        frame = await read_frame(reader)
        if frame is None:
            break
        t = frame.get("t")
        if t == "ping":
            # pongs carry the metrics: the parent's stats handler is
            # synchronous and reads what the latest pong brought
            pong = {"t": "pong", "n": frame.get("n", 0)}
            try:
                m = _engine_metrics(engine_path, engine)
                if m is not None:
                    pong["m"] = m
            except Exception:
                logger.exception("engine metrics failed; pong sent without")
            await send(pong)
        elif t == "req":
            from ...utils import faults

            if faults.fire("child_exit"):
                # fault site: the child dies hard as it takes a request;
                # the parent must fail the stream and respawn
                os._exit(17)
            rid = frame["id"]
            tasks[rid] = asyncio.create_task(run_stream(rid, frame.get("payload")))
        elif t in ("stop", "kill"):
            task = tasks.get(frame.get("id"))
            if task is not None:
                task.cancel()
        elif t == "shutdown":
            break
    for task in list(tasks.values()):
        task.cancel()
    pump_task.cancel()
    if hasattr(engine, "close"):
        with contextlib.suppress(Exception):
            await engine.close()
    return 0


def main() -> None:
    if len(sys.argv) != 2:
        print("usage: python -m dynamo_tpu_torch.llm.engines.subprocess_host "
              "<engine_file.py|@torch>", file=sys.stderr)
        raise SystemExit(2)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s[child]: %(message)s")
    raise SystemExit(asyncio.run(_child_main(sys.argv[1])))


if __name__ == "__main__":
    main()
