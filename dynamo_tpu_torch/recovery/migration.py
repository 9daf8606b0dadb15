"""Live request migration: move an in-flight request to a healthy peer.

The port's copy of ``dynamo_tpu/recovery/migration.py`` over the ``tcp``
backend. A draining engine packages each live request's *committed*
state (the token ids whose KV sits in its paged cache, the pending
sampled token, the generation counter, the per-request noise key and the
request body) and ships it to a peer engine, which admits the request
into its own cache and resumes decode mid-stream. Two modes:

- **hot** (a healthy device, e.g. ``POST /admin/drain`` rolling updates):
  the committed KV blocks ride along, gathered frame by frame
  (``MIGRATE_CHUNK_BLOCKS`` blocks each: the sender gathers on the device
  with ``gather_blocks_device`` behind every dispatched step, and copies
  the frame to the host in an executor), so the peer resumes without
  recomputing anything;
- **cold** (a wedged device: a hung gather would wedge the drain too):
  only tokens ship; the peer re-prefills ``prompt + resume`` through the
  scheduler's preemption-resume path, so the continued stream is the one
  the source would have produced.

The client's stream never breaks: the source keeps the client connection
and *relays*: after the peer commits, its outputs stream back over the
migration connection into the original request's output queue. Commit and
poison follow ``disagg/transfer.py``: a connection that dies before the
commit aborts the reservation on the receiver (blocks freed, nothing
installed); a death after it cancels the resumed request.

**Stream re-bind.** The commit ack carries a ``resume_id``; the source
puts a ``migrated`` control frame (an ``EngineOutput`` with no payload)
into the client stream, and a re-bind-aware consumer (``llm/backend.py``
through :func:`follow_migrated_stream`) attaches directly to the peer
(``mig_attach``). The peer's pump switches to the new connection, sending
``mig_handoff`` on the old one in order (no frame lost or duplicated), the
source's relay ends, and the source worker may exit. A consumer that
never attaches gets the whole relayed stream.

Wire (4-byte length-prefixed headers in the runtime's wire codec, byte for
byte msgpack's, and raw payloads: the transfer plane's framing), one
migration per connection::

    → {type:"mig_begin", state:{...}, nblocks, sent_at, backend}
    ← {type:"mig_ack", ok, reason?, recv_at, sent_at}
    → {type:"mig_blocks", offset, shape, dtype, k_bytes, v_bytes[, v_shape]} <k> <v>
    → {type:"mig_commit"}
    ← {type:"mig_ack", ok, reason?, resume_id}
    ← {type:"mig_data", payload: EngineOutput wire} ...
    ← {type:"mig_handoff"}                     (re-bind: relay duty ends)
    ← {type:"mig_end", spans?, children?} | {type:"mig_error", error}

and on a re-bind connection::

    → {type:"mig_attach", resume_id, sent_at}
    ← {type:"mig_ack", ok, reason?, recv_at, sent_at}
    ← {type:"mig_data", ...} ... {type:"mig_end", ...}

A block frame carries V's shape where it differs from K's (MLA's
``(c_kv, k_rope)`` pair), so a DeepSeek request migrates hot. Both ends
widen their connection (``transfer.framing.widen_stream``): a peer decodes
on the loop that reads the frames, and asyncio's 256 KiB reads would
interleave a decode pass with every one of them. ``mig_end``
carries the peer's span export (``migration.resume`` onward), kept as it
arrived, as ``runtime/client.py`` keeps a worker's. Refused by name: the
``ici`` collective backend and its ``mig_ici_blocks`` frame.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..protocols.common import EngineOutput, FinishReason, PreprocessedRequest
from ..runtime.engine import AsyncEngineContext
from ..telemetry.flight import flight_recorder
from ..transfer.framing import WIDE_IO_BYTES, pack_frame, read_header, widen_stream
from ..transfer.plane import maybe_drop_connection, record_open
from ..transfer.tcp import TcpBackend

logger = logging.getLogger(__name__)

# blocks per KV frame: bounds the sender's and the receiver's host buffers,
# as the streamed prefill transfer's frames do
MIGRATE_CHUNK_BLOCKS = 16
# a peer that does not accept within this is another peer's turn
CONNECT_TIMEOUT_S = 5.0

ICI_REFUSED = ("the ici migration backend (a device-to-device collective "
               "plane) is not ported to the PyTorch engine; migrations ride "
               "tcp")


def migration_key(namespace: str, component: str, engine_id: str) -> str:
    """Discovery key a worker's migration receiver registers under
    (lease-scoped, like the KV transfer descriptor)."""
    return f"{namespace}/components/{component}/migration/{engine_id}"


class MigrationRejected(Exception):
    """The peer cannot take this request (no slot, no memory, another
    geometry). The caller tries the next peer or fails the request."""


@dataclasses.dataclass
class MigrationState:
    """Everything a peer needs to resume the request as it would have
    continued."""

    request_id: str
    trace_id: str
    req: dict                       # PreprocessedRequest.to_wire()
    # hot: tokens whose KV ships (prompt + generated, == context_len);
    # empty for a cold migration
    committed_tokens: List[int]
    # cold: generated tokens already emitted to the client (the pending one
    # included): the peer re-prefills prompt + resume and continues
    resume_tokens: List[int]
    pending_token: int              # sampled, emitted, KV not yet written
    generated: int                  # max_tokens accounting + noise counter
    base_key: List[int]             # per-request noise key (uint32 x 2)
    prompt_lps_emitted: bool
    kv_block_size: int              # the geometry must match across engines

    @property
    def hot(self) -> bool:
        return bool(self.committed_tokens)

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "MigrationState":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def migration_class(er) -> str:
    """Migrate-or-fail decision per request class: ``hot``, ``cold`` or
    ``fail``.

    - guided_json → **fail**: the grammar cursor lives in the serving
      layer's in-process cache; it cannot serialize, and a cold resume on
      the peer would decode unconstrained.
    - guided_choice → **cold**: ``_start_prefill`` rebuilds the trie from
      the request body and walks it past the resume tokens.
    - prompt logprobs not yet emitted → **cold**: the peer's re-prefill
      recomputes them.
    - mid-prefill or still waiting → **cold** (no complete KV to ship).
    - plain decode-state requests → **hot**.
    """
    so = er.req.sampling_options
    if so.guided_json:
        return "fail"
    if er.guided is not None or so.guided_choice_token_ids:
        return "cold"
    if er.want_prompt_lps and not er.prompt_lps_emitted:
        return "cold"
    if (er.seq is None or er.pending_token < 0
            or er.context_len != len(er.seq.token_ids)):
        return "cold"
    return "hot"


def package_request(er, allocator, kv_block_size: int,
                    allow_hot: bool = True) -> MigrationState:
    """The wire state of an extracted request, releasing the over-reserved
    block tail (hot) or every block (cold) to the source allocator. After
    this the request holds exactly the blocks that ship (hot) or none
    (cold). Reads only host state: ``pending_token`` and ``base_key`` are
    the host copies the scheduler already holds (no device read)."""
    hot = allow_hot and migration_class(er) == "hot"
    if hot:
        keep = -(-er.context_len // kv_block_size)
        er.block_ids = allocator.rollback_tail(er.block_ids, keep)
        committed = [int(t) for t in er.seq.token_ids]
        resume: List[int] = []
    else:
        # cold: the resume computation of Scheduler._preempt (tokens already
        # emitted continue, never restart)
        if er.seq is not None:
            gen = [int(t) for t in er.seq.token_ids[len(er.prompt):]]
            if er.pending_token >= 0:
                gen = gen + [int(er.pending_token)]
        else:
            gen = [int(t) for t in er.resume_tokens]
        committed = []
        resume = gen
        allocator.free_blocks(er.block_ids)
        er.block_ids = []
    return MigrationState(
        request_id=er.request_id,
        trace_id=er.ctx.trace_id,
        req=er.req.to_wire(),
        committed_tokens=committed,
        resume_tokens=resume,
        pending_token=int(er.pending_token) if hot else -1,
        generated=int(er.generated),
        base_key=([int(x) for x in np.asarray(er.base_key).tolist()]
                  if er.base_key is not None else []),
        prompt_lps_emitted=bool(er.prompt_lps_emitted),
        kv_block_size=kv_block_size,
    )


# ---------------------------------------------------------------------------
# receiver
# ---------------------------------------------------------------------------


class MigrationSink:
    """Receiver-side binding to one engine: reserve blocks, scatter the
    shipped KV and install the resumed request into the scheduler."""

    def __init__(self, scheduler, runner):
        self.scheduler = scheduler
        self.runner = runner
        # attempt key → (state, block_ids) reserved, not yet committed. Keys
        # are per ATTEMPT: a sender failing over to the same receiver has
        # two live connections for one request id, and the stale attempt's
        # abort must free ITS reservation, never the retry's
        self._pending: Dict[str, Tuple[MigrationState, List[int]]] = {}

    def reserve(self, state: MigrationState, nblocks: int) -> str:
        sched = self.scheduler
        cfg = sched.config
        if sched.draining:
            raise MigrationRejected("peer is itself draining")
        # the geometry and capacity gate BEFORE any state mutates: a
        # sequence this engine cannot hold nacks here instead of failing
        # inside an admission (+1: the pending token needs a position below
        # the horizon)
        prompt_len = len((state.req or {}).get("token_ids") or [])
        total = (len(state.committed_tokens)
                 or prompt_len + len(state.resume_tokens))
        if total + 1 >= cfg.max_model_len:
            raise MigrationRejected(
                f"sequence of {total} tokens exceeds this engine's "
                f"max_model_len {cfg.max_model_len}")
        if nblocks > 0:
            if state.kv_block_size != cfg.kv_block_size:
                raise MigrationRejected(
                    f"kv_block_size mismatch: sender {state.kv_block_size} "
                    f"vs {cfg.kv_block_size}")
            if nblocks > cfg.blocks_per_seq:
                raise MigrationRejected(
                    f"{nblocks} blocks exceed this engine's block-table "
                    f"width {cfg.blocks_per_seq}")
            if sched._free_slot() is None:
                raise MigrationRejected("no free slot")
            try:
                block_ids = sched.allocator.allocate_n(nblocks)
            except MemoryError as e:
                raise MigrationRejected(f"no KV memory: {e}") from None
        else:
            block_ids = []
        mig_id = f"{state.request_id}#{uuid.uuid4().hex[:8]}"
        self._pending[mig_id] = (state, block_ids)
        return mig_id

    async def scatter(self, mig_id: str, offset: int, k, v) -> None:
        entry = self._pending.get(mig_id)
        if entry is None:
            raise MigrationRejected(f"unknown migration {mig_id}")
        _state, block_ids = entry
        n = k.shape[1]
        if offset < 0 or offset + n > len(block_ids):
            raise MigrationRejected(
                f"block frame [{offset}:{offset + n}) outside the reservation "
                f"of {len(block_ids)}")
        # the pinned staging runs off the loop (the coordinator's scatter
        # discipline); the cache-mutating scatter stays on the loop, so it
        # is ordered with the scheduler's own dispatches on one stream
        k, v = await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.runner.stage_blocks(k, v))
        # the migration may have been aborted during the await
        if mig_id not in self._pending:
            logger.info("dropping a late migration KV frame for %s", mig_id)
            return
        self.runner.scatter_blocks(block_ids[offset:offset + n], k, v)

    def commit(self, mig_id: str):
        """Install the migrated request; returns the live EngineRequest
        whose out_queue the caller pumps back to the sender."""
        entry = self._pending.pop(mig_id, None)
        if entry is None:
            raise MigrationRejected(f"unknown migration {mig_id}")
        state, block_ids = entry
        # engine-side ids stay this engine's own: a replayed migration must
        # not collide in scheduler state; the trace id carries the
        # cross-worker correlation
        from ..engine.scheduler import EngineRequest

        req = PreprocessedRequest.from_wire(state.req)
        er = EngineRequest(
            request_id=uuid.uuid4().hex,
            prompt=list(req.token_ids),
            req=req,
            ctx=AsyncEngineContext(trace_id=state.trace_id or None),
            out_queue=asyncio.Queue(),
        )
        er.generated = int(state.generated)
        er.pending_token = int(state.pending_token)
        er.prompt_lps_emitted = bool(state.prompt_lps_emitted)
        er.resume_tokens = [int(t) for t in state.resume_tokens]
        if state.base_key:
            er.base_key = np.asarray(state.base_key, np.uint32)
        try:
            ok = self.scheduler.admit_migrated(
                er, [int(t) for t in state.committed_tokens], block_ids)
        except Exception as e:
            # an install failure stays MigrationRejected (blocks freed, the
            # sender nacked): never corrupt the healthy peer's scheduler
            self.scheduler.allocator.free_blocks(block_ids)
            raise MigrationRejected(f"install failed: {e}") from e
        if not ok:
            self.scheduler.allocator.free_blocks(block_ids)
            raise MigrationRejected("no free slot at commit")
        return er

    def abort(self, mig_id: str, backend: str = "tcp",
              reason: str = "") -> None:
        entry = self._pending.pop(mig_id, None)
        if entry is not None:
            state, block_ids = entry
            self.scheduler.allocator.free_blocks(block_ids)
            flight_recorder().record(
                "transfer.poison", plane="migration", backend=backend,
                request_id=state.request_id, trace_id=state.trace_id,
                reason=reason or "connection died before commit")


_STREAM_END = object()  # sentinel: the out_queue's terminal None, popped


class _Resume:
    """One installed migrated request and its pump-handoff state."""

    __slots__ = ("er", "attach_writer", "attach_evt", "released",
                 "pending_get", "pending_out", "done")

    def __init__(self, er):
        self.er = er
        self.attach_writer = None      # set by a mig_attach connection
        self.attach_evt = asyncio.Event()
        self.released = asyncio.Event()  # the original pump gave it up
        # an out_queue.get in flight across the handoff: the popped, unwritten
        # output must reach the NEW connection, not vanish
        self.pending_get: Optional[asyncio.Task] = None
        # a popped output whose write never completed (handoff, or the relay
        # connection dying mid-frame): the successor pump re-sends it
        self.pending_out = None        # EngineOutput | _STREAM_END | None
        self.done = False              # the stream ended (mig_end DELIVERED)


class MigrationServer:
    """TCP receiver of inbound migrations, one migration per connection.

    After the commit the connection streams: the resumed request's outputs
    ride back as ``mig_data`` frames until the stream ends. A connection
    death before the commit aborts the reservation (the transfer plane's
    poison discipline); after it, it cancels the resumed request. A
    ``mig_attach`` connection re-binds the stream to a direct consumer: the
    pump switches writers (``mig_handoff`` closes the old connection's duty
    in order), so the source worker can exit."""

    def __init__(self, sink: MigrationSink, host: str = "127.0.0.1",
                 port: int = 0, ici=None, ici_rank: Optional[int] = None):
        if ici is not None or ici_rank is not None:
            raise NotImplementedError(ICI_REFUSED)
        self.sink = sink
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._resumes: Dict[str, _Resume] = {}
        self._conns: set = set()

    async def start(self) -> "MigrationServer":
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port, limit=WIDE_IO_BYTES)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def descriptor(self) -> dict:
        return {"host": self.host, "port": self.port, "modes": ["tcp"]}

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        # KV frames arrive while this engine decodes on the same loop: move
        # a frame in a few turns, not in 256 KiB ones
        widen_stream(writer)
        mig_id: Optional[str] = None
        er = None
        backend = "tcp"
        try:
            while True:
                header = await read_header(reader, "migration")
                if header is None:
                    return
                mtype = header.get("type")
                if mtype == "mig_begin":
                    recv_at = time.time()
                    backend = header.get("backend") or "tcp"
                    if backend != "tcp":
                        raise MigrationRejected(ICI_REFUSED)
                    state = MigrationState.from_wire(header["state"])
                    try:
                        mig_id = self.sink.reserve(state,
                                                   int(header.get("nblocks", 0)))
                    except MigrationRejected as e:
                        pack_frame(writer, {"type": "mig_ack", "ok": False,
                                            "reason": str(e)})
                        await writer.drain()
                        return
                    # the begin / ack pair is the hop's clock-offset pair: the
                    # sender holds its own walls, this side supplies its own
                    pack_frame(writer, {"type": "mig_ack", "ok": True,
                                        "recv_at": recv_at,
                                        "sent_at": time.time()})
                    await writer.drain()
                elif mtype == "mig_blocks":
                    k, v = await TcpBackend.recv_blocks(reader, header)
                    await self.sink.scatter(mig_id, int(header["offset"]), k, v)
                elif mtype == "mig_ici_blocks":
                    raise MigrationRejected(ICI_REFUSED)
                elif mtype == "mig_commit":
                    try:
                        er = self.sink.commit(mig_id)
                    except MigrationRejected as e:
                        pack_frame(writer, {"type": "mig_ack", "ok": False,
                                            "reason": str(e)})
                        await writer.drain()
                        return
                    mig_id = None  # installed: no reservation to abort
                    resume_id = uuid.uuid4().hex
                    resume = _Resume(er)
                    self._resumes[resume_id] = resume
                    pack_frame(writer, {"type": "mig_ack", "ok": True,
                                        "resume_id": resume_id})
                    await writer.drain()
                    handed_off = False
                    try:
                        handed_off = await self._pump(resume, writer,
                                                      accept_attach=True)
                    finally:
                        if (not handed_off and resume.attach_writer is not None
                                and not resume.done):
                            # the relay connection died RACING an attach (the
                            # draining source exiting is exactly when
                            # consumers attach): the attached consumer owns
                            # the live stream; its pump proceeds off
                            # resume.released
                            handed_off = True
                        if not handed_off:
                            self._resumes.pop(resume_id, None)
                        else:
                            # this connection's death must NOT cancel the
                            # request: a direct consumer has it
                            er = None
                    return
                elif mtype == "mig_attach":
                    await self._handle_attach(header, writer)
                    return
                else:
                    logger.error("unknown migration frame %r", mtype)
                    return
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, OSError):
            pass
        except MigrationRejected as e:
            logger.warning("migration aborted: %s", e)
        except Exception:
            logger.exception("migration connection failed")
        finally:
            self._conns.discard(writer)
            if mig_id is not None:
                # died before the commit: nothing installed, the reservation
                # is freed (poison: a partial KV stream never becomes a live
                # request)
                self.sink.abort(mig_id, backend=backend)
            if er is not None and er.finish is None:
                # died after the commit: the relay (and so the client) is
                # gone; stop the resumed request
                er.ctx.stop_generating()
            writer.close()

    async def _handle_attach(self, header: dict,
                             writer: asyncio.StreamWriter) -> None:
        """A consumer re-binding a migrated stream to itself."""
        resume_id = header.get("resume_id") or ""
        resume = self._resumes.get(resume_id)
        if resume is None or resume.attach_writer is not None:
            pack_frame(writer, {"type": "mig_ack", "ok": False,
                                "reason": f"unknown or already-attached "
                                          f"resume id {resume_id!r}"})
            await writer.drain()
            return
        recv_at = time.time()
        pack_frame(writer, {"type": "mig_ack", "ok": True, "recv_at": recv_at,
                            "sent_at": time.time()})
        await writer.drain()
        resume.attach_writer = writer
        resume.attach_evt.set()
        # wait for the original pump to hand the stream off (it sends
        # mig_handoff on its own connection first, preserving order)
        await resume.released.wait()
        er = resume.er
        try:
            if not resume.done:
                await self._pump(resume, writer, accept_attach=False)
        finally:
            self._resumes.pop(resume_id, None)
            if er.finish is None and not resume.done:
                # the attached consumer died mid-stream: nobody listens
                er.ctx.stop_generating()

    async def _pump(self, resume: _Resume, writer: asyncio.StreamWriter,
                    accept_attach: bool) -> bool:
        """Stream the resumed request's outputs to ``writer``; True when the
        stream was handed off to an attach connection."""
        er = resume.er
        try:
            while True:
                if (accept_attach and resume.attach_writer is not None
                        and writer is not resume.attach_writer):
                    # a direct consumer attached: frames written so far
                    # precede the handoff marker on this connection, every
                    # later one goes to the new connection (exactly once)
                    pack_frame(writer, {"type": "mig_handoff"})
                    await writer.drain()
                    return True
                out = resume.pending_out
                if out is None:
                    get_task = resume.pending_get
                    if get_task is None:
                        get_task = asyncio.ensure_future(er.out_queue.get())
                        resume.pending_get = get_task
                    if accept_attach:
                        attach_task = asyncio.ensure_future(
                            resume.attach_evt.wait())
                        try:
                            await asyncio.wait(
                                {get_task, attach_task},
                                return_when=asyncio.FIRST_COMPLETED)
                        finally:
                            attach_task.cancel()
                        if not get_task.done():
                            continue  # woken by the attach: see above
                    fetched = await get_task
                    resume.pending_get = None
                    out = _STREAM_END if fetched is None else fetched
                    resume.pending_out = out
                if out is _STREAM_END:
                    # the span export rides the stream-end frame: the peer's
                    # migration.resume → decode → completion marks land in
                    # the consumer's trace, not a silent gap
                    pack_frame(writer, {
                        "type": "mig_end",
                        "spans": er.ctx.export_spans(),
                        "children": list(er.ctx.remote_spans),
                    })
                    await writer.drain()
                    # done only once DELIVERED: a relay death mid-end leaves
                    # it pending for the attach pump to re-send
                    resume.done = True
                    resume.pending_out = None
                    return False
                pack_frame(writer, {"type": "mig_data", "payload": out.to_wire()})
                await writer.drain()
                resume.pending_out = None
        finally:
            # whatever ended this pump (handoff, stream end, connection
            # death), a waiting attach handler must not hang on released
            resume.released.set()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # 3.12's wait_closed waits for every open connection: close them
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            self._server = None


# ---------------------------------------------------------------------------
# sender
# ---------------------------------------------------------------------------


def _hop_offset(sent_at: float, ack: dict):
    """The hop's clock offset and network round trip from a begin (or
    attach) and its ack (``telemetry/stitch.estimate_offset``); (0, 0) when
    the ack carries no stamps."""
    if not ack.get("recv_at"):
        return 0.0, 0.0
    from ..telemetry.stitch import estimate_offset

    return estimate_offset(sent_at, ack["recv_at"],
                           ack.get("sent_at", ack["recv_at"]), time.time())


def _peer_spans(header: dict, offset: float, rtt: float) -> dict:
    """The peer's span set off a ``mig_end`` frame, with the hop's offset
    estimate from the begin / ack pair."""
    return {"source": "migration_peer", "spans": header.get("spans") or [],
            "offset_s": round(offset, 6), "rtt_s": round(rtt, 6),
            "children": header.get("children") or []}


async def migrate_request(
    host: str,
    port: int,
    er,
    state: MigrationState,
    gather: Optional[Callable] = None,   # (block_ids) -> (k, v) on the device
    to_host: Optional[Callable] = None,  # (k, v) -> host (k, v), executor
    ici=None,
    counts: Optional[dict] = None,
    metrics=None,                        # TransferMetrics(plane="migration")
) -> asyncio.Task:
    """Ship one request to a peer and return the spawned relay task.

    Hot frames gather on the loop (``gather``: dispatch-only, ordered
    behind every step dispatched before it on the runner's stream) and copy
    to the host in an executor (``to_host``), one frame at a time, so host
    buffers stay bounded at one frame. ``counts`` (a dict) gains the KV
    ``bytes`` and ``frames`` shipped.

    Raises ``MigrationRejected`` (the peer nacked) or ``OSError`` /
    ``ConnectionError`` (the peer is unreachable, the stream died): in both
    cases nothing was installed remotely and the caller may try another
    peer. On success the request's blocks are the caller's to free; the
    returned task relays the peer's outputs into ``er.out_queue`` until the
    stream ends (the caller holds it and cancels it on shutdown).
    ``metrics`` records the channel, the bytes ``counts`` gains and the
    transfer's seconds on the ``dynamo_transfer_*`` family."""
    if ici is not None:
        raise NotImplementedError(ICI_REFUSED)
    block_ids = list(er.block_ids) if state.hot else []
    backend = "tcp"
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), CONNECT_TIMEOUT_S)
    widen_stream(writer)
    loop = asyncio.get_running_loop()
    t0 = time.monotonic()
    record_open("migration", backend, peer=f"{host}:{port}",
                trace_id=state.trace_id)
    if metrics is not None:
        metrics.channel_opened(backend)
    try:
        begin_sent = time.time()
        pack_frame(writer, {
            "type": "mig_begin", "state": state.to_wire(),
            "nblocks": len(block_ids), "sent_at": begin_sent,
            "backend": backend,
        })
        await writer.drain()
        ack = await read_header(reader, "migration")
        if ack is None or not ack.get("ok"):
            raise MigrationRejected((ack or {}).get(
                "reason", "peer closed during begin"))
        # the per-hop clock offset, applied to the peer's span export when
        # mig_end delivers it
        offset, rtt = _hop_offset(begin_sent, ack)
        for i in range(0, len(block_ids), MIGRATE_CHUNK_BLOCKS):
            if maybe_drop_connection():
                writer.close()
                raise ConnectionResetError("fault injected: transfer_conn_drop")
            ids = block_ids[i:i + MIGRATE_CHUNK_BLOCKS]
            k_dev, v_dev = gather(ids)
            k, v = await loop.run_in_executor(None, to_host, k_dev, v_dev)
            nbytes = await TcpBackend.send_blocks(
                writer, {"type": "mig_blocks", "offset": i}, k, v)
            if counts is not None:
                counts["bytes"] = counts.get("bytes", 0) + nbytes
                counts["frames"] = counts.get("frames", 0) + 1
            if metrics is not None:
                metrics.add_bytes(nbytes, backend)
        pack_frame(writer, {"type": "mig_commit"})
        await writer.drain()
        ack = await read_header(reader, "migration")
        if ack is None or not ack.get("ok"):
            raise MigrationRejected((ack or {}).get(
                "reason", "peer closed during commit"))
        if metrics is not None:
            metrics.observe_duration(time.monotonic() - t0, backend)
    except BaseException:
        if metrics is not None:
            metrics.channel_closed(backend)
        writer.close()
        raise
    # committed: the peer owns the request now. Stamp the hop, offer the
    # re-bind, then relay (the peer's half of the trace arrives with mig_end)
    resume_id = ack.get("resume_id")
    if resume_id:
        # a follow_migrated_stream consumer attaches directly to the peer and
        # this worker's relay ends at the handoff; consumers that ignore it
        # get the whole relay
        er.out_queue.put_nowait(EngineOutput(migrated={
            "host": host, "port": port, "resume_id": resume_id}))
    er.ctx.add_stage("migration.relay")
    flight_recorder().record(
        "recovery.migrate", request_id=er.request_id,
        trace_id=er.ctx.trace_id, peer=f"{host}:{port}", hot=state.hot,
        blocks=len(block_ids), generated=int(state.generated))
    return loop.create_task(_relay(reader, writer, er, offset, rtt,
                                   metrics=metrics, backend=backend),
                            name=f"mig-relay-{er.request_id[:8]}")


async def _relay(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 er, offset: float = 0.0, rtt: float = 0.0,
                 metrics=None, backend: str = "tcp") -> None:
    """Forward the peer's resumed outputs into the original out_queue: the
    client's stream continues without a break. A client disconnect reaches
    the peer as this connection closing."""
    ended = False

    async def watch_cancel():
        await er.ctx.wait_stopped()
        writer.close()  # the peer sees the death and stops the request

    cancel_task = asyncio.get_running_loop().create_task(watch_cancel())
    try:
        while True:
            header = await read_header(reader, "migration")
            if header is None:
                break  # the peer died mid-stream
            mtype = header.get("type")
            if mtype == "mig_data":
                er.out_queue.put_nowait(
                    EngineOutput.from_wire(header.get("payload") or {}))
            elif mtype == "mig_end":
                if header.get("spans"):
                    er.ctx.add_remote_spans(_peer_spans(header, offset, rtt))
                er.out_queue.put_nowait(None)
                ended = True
                return
            elif mtype == "mig_handoff":
                # a downstream consumer attached directly to the peer: the
                # relay ends, the source stream closes without a finish (the
                # consumer continues on its own connection), and this worker
                # is free to exit
                flight_recorder().record(
                    "recovery.migrate_handoff", request_id=er.request_id,
                    trace_id=er.ctx.trace_id)
                er.out_queue.put_nowait(None)
                ended = True
                return
            elif mtype == "mig_error":
                logger.error("migrated request %s failed remotely: %s",
                             er.request_id, header.get("error"))
                break
            else:
                logger.error("unknown relay frame %r", mtype)
                break
    finally:
        cancel_task.cancel()
        writer.close()
        if metrics is not None:
            metrics.channel_closed(backend)
        if not ended and not er.ctx.is_stopped:
            # the peer (or its connection) died mid-stream: the client must
            # see a terminal frame, not silence
            er.out_queue.put_nowait(
                EngineOutput(token_ids=[], finish_reason=FinishReason.ERROR))
            er.out_queue.put_nowait(None)


# ---------------------------------------------------------------------------
# stream re-bind (consumer side)
# ---------------------------------------------------------------------------


async def _fold_end_spans(reader, ctx, offset: float, rtt: float,
                          timeout_s: float = 0.25) -> None:
    """Bounded read-ahead for the ``mig_end`` behind a finish frame; folds
    the peer's span export into ``ctx``. Best effort: a peer that never
    sends it costs ``timeout_s``, nothing else."""
    try:
        end = await asyncio.wait_for(read_header(reader, "migration"), timeout_s)
    except (asyncio.TimeoutError, asyncio.IncompleteReadError,
            ConnectionResetError, OSError):
        return
    if end and end.get("type") == "mig_end" and end.get("spans") and ctx is not None:
        ctx.add_remote_spans(_peer_spans(end, offset, rtt))


async def _open_attach(info: dict):
    """Dial the peer and bind to a migrated request's resumed stream.
    Returns ``(reader, writer, offset, rtt)`` after the attach ack: the wall
    pair is the hop's clock-offset estimate for the span fold."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(info["host"], info["port"]), CONNECT_TIMEOUT_S)
    try:
        sent_at = time.time()
        pack_frame(writer, {"type": "mig_attach",
                            "resume_id": info["resume_id"],
                            "sent_at": sent_at})
        await writer.drain()
        ack = await read_header(reader, "migration")
        if ack is None or not ack.get("ok"):
            raise MigrationRejected((ack or {}).get(
                "reason", "peer closed during attach"))
        offset, rtt = _hop_offset(sent_at, ack)
        return reader, writer, offset, rtt
    except BaseException:
        writer.close()
        raise


async def follow_migrated_stream(stream, ctx=None):
    """Wrap an engine's output stream, re-binding across migrations.

    Yields :class:`EngineOutput` objects (wire dicts are decoded). On a
    ``migrated`` control frame the attach handshake starts at once,
    concurrently with the source's relay: the peer switches its pump on
    receipt, the source stream ends at the handoff, and this generator
    continues from the direct connection with nothing lost or repeated. The
    source worker is then free to exit. If the attach fails, the relay
    carries the stream to its end.

    ``ctx`` (an AsyncEngineContext) receives the peer's span export from
    ``mig_end``."""
    from contextlib import aclosing

    rebind: Optional[dict] = None
    attach_task: Optional[asyncio.Task] = None
    try:
        async with aclosing(stream) as s:
            async for out in s:
                if isinstance(out, dict):
                    out = EngineOutput.from_wire(out)
                if out.migrated:
                    rebind = dict(out.migrated)
                    attach_task = asyncio.get_running_loop().create_task(
                        _open_attach(rebind),
                        name=f"mig-attach-{rebind.get('resume_id', '?')[:8]}")
                    continue  # a control frame: never client payload
                yield out
                if out.finish_reason is not None:
                    return
        # the source stream ended without a finish: a handoff (we attached;
        # continue on the direct connection) or a cancellation (nothing to
        # attach to)
        while attach_task is not None:
            try:
                reader, writer, offset, rtt = await attach_task
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.warning("stream re-bind to %s:%s failed (%s); the "
                               "stream ends with the source's relay",
                               rebind.get("host"), rebind.get("port"), e)
                return
            attach_task = None
            try:
                while True:
                    header = await read_header(reader, "migration")
                    if header is None:
                        yield EngineOutput(token_ids=[],
                                           finish_reason=FinishReason.ERROR)
                        return
                    mtype = header.get("type")
                    if mtype == "mig_data":
                        out = EngineOutput.from_wire(header.get("payload") or {})
                        if out.migrated:
                            # a chained migration: the peer itself drained
                            rebind = dict(out.migrated)
                            attach_task = asyncio.get_running_loop().create_task(
                                _open_attach(rebind))
                            continue
                        if out.finish_reason is not None:
                            # the mig_end (the span export) is right behind the
                            # finish frame: read it BEFORE yielding, because a
                            # detokenizing consumer breaks (and acloses this)
                            # at the finish chunk
                            await _fold_end_spans(reader, ctx, offset, rtt)
                            yield out
                            return
                        yield out
                    elif mtype == "mig_end":
                        if header.get("spans") and ctx is not None:
                            ctx.add_remote_spans(
                                _peer_spans(header, offset, rtt))
                        break  # a chained migration's attach_task continues
                    elif mtype == "mig_error":
                        yield EngineOutput(token_ids=[],
                                           finish_reason=FinishReason.ERROR)
                        return
                    else:
                        logger.error("unknown attach frame %r", mtype)
                        return
            finally:
                writer.close()
    finally:
        if attach_task is not None:
            if (attach_task.done() and not attach_task.cancelled()
                    and attach_task.exception() is None):
                # the handshake completed but the stream ended through the
                # relay first: close the connection it opened
                attach_task.result()[1].close()
            else:
                attach_task.cancel()
