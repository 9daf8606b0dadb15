"""KV transfer endpoints: push paged KV blocks into a remote engine's cache.

The port's copy of ``dynamo_tpu/disagg/transfer.py`` over the tcp
backend. Each decode engine runs a ``KvTransferServer``; its descriptor
(host, port, modes, and the cache's dtype and block shapes) is published
in the discovery plane under ``transfer_key``, and prefill workers dial it
and stream block frames::

  {type: "blocks", request_id, block_ids, shape, dtype, k_bytes, v_bytes
   [, v_shape]} <k raw bytes> <v raw bytes>
  {type: "commit", request_id, first_token, logprob, top, spans}

The commit is acked with one framed byte: \\x01 committed, \\x00 nacked (a
payload frame of the request was dropped: the decode side must not resume
over blocks that were never scattered; its request falls back to a local
prefill at the coordinator's timeout).

A frame whose dtype or block shape differs from this cache's is refused
by name and poisons its request, never reinterpreted. Refused by name too:
the ``ici_blocks`` frame (the collective backend), which is not ported.

Read-only block serve (the cluster KV fabric, ``kv/fabric.py``) rides the
same framing the other way: a peer asks for a sequence-hash chain and this
engine streams whatever prefix run of it it still holds::

  → {type: "pull", hashes, chunk_blocks, backend?, trace_id?}
  ← {type: "pull_blocks", shape, dtype, k_bytes, v_bytes [, v_shape]} <k> <v>
  ← {type: "pull_end", served}

A server without a ``pull_source`` answers ``pull_end`` with 0 served.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import struct
from typing import Callable, List, Optional, Sequence

import torch

from ..transfer.framing import dtype_name, pack_frame, read_exact, read_header
from ..transfer.plane import PoisonSet, maybe_drop_connection
from ..transfer.tcp import TcpBackend

logger = logging.getLogger(__name__)


def transfer_key(namespace: str, component: str, engine_id: str) -> str:
    return f"{namespace}/components/{component}/kv_transfer/{engine_id}"


def cache_layout(runner) -> dict:
    """A runner cache's wire layout: its dtype's name and one block's K
    and V shapes (``[L, bs, heads, dim]``, the cache pair without its
    block dimension). Sender and receiver must agree on all three."""
    k, v = runner.kv_cache
    return {"dtype": dtype_name(k.dtype),
            "k_block_shape": [k.shape[0], *k.shape[2:]],
            "v_block_shape": [v.shape[0], *v.shape[2:]]}


def layout_mismatch(want: dict, got: dict) -> Optional[str]:
    """What differs between two cache layouts, by name; None if nothing."""
    for key in ("dtype", "k_block_shape", "v_block_shape"):
        a, b = want.get(key), got.get(key)
        if key != "dtype":
            a, b = list(a or []), list(b or [])
        if a != b:
            return f"{key} {got.get(key)} (this cache: {want.get(key)})"
    return None


def frame_layout(header: dict) -> dict:
    """The layout a block frame's header announces."""
    shape = list(header["shape"])
    v_shape = list(header.get("v_shape") or shape)
    return {"dtype": header["dtype"],
            "k_block_shape": [shape[0], *shape[2:]],
            "v_block_shape": [v_shape[0], *v_shape[2:]]}


class KvTransferServer:
    """Receives block frames and scatters them into the local paged cache."""

    def __init__(
        self,
        scatter: Callable[..., object],
        on_commit: Callable[..., None],
        authorize: Optional[Callable[[str, Sequence[int]], bool]] = None,
        host: str = "127.0.0.1",
        layout: Optional[dict] = None,
        pull_source=None,  # Optional[Callable[[List[int]], PullGrant]]
    ):
        # scatter(request_id, block_ids, k, v) may return an awaitable; an
        # async scatter MUST re-validate the request after any await (the
        # request can be cancelled meanwhile and its blocks reallocated)
        self.scatter = scatter
        # on_commit(request_id, first_token, logprob, top, spans)
        self.on_commit = on_commit
        # guards against late frames of cancelled or unknown requests
        # writing into reallocated blocks
        self.authorize = authorize or (lambda request_id, ids: True)
        self.host = host
        # this cache's layout (``cache_layout``): published, and held
        # against every block frame; None accepts any (tests)
        self.layout = layout
        # read-only block serve (the cluster KV fabric): pull_source(hashes)
        # resolves and PINS the longest locally held run of a hash chain
        # and returns a grant whose gather_frame packs wire frames off the
        # loop; its release() unpins and runs exactly once, in the serve's
        # finally, so a connection dying mid-serve never leaves blocks fenced
        self.pull_source = pull_source
        self.pulls_served = 0
        self._poison = PoisonSet("disagg")
        self.frames_received = 0
        self.bytes_received = 0
        self.nacks = 0
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()  # open connections, closed by close()

    async def start(self) -> "KvTransferServer":
        self._server = await asyncio.start_server(self._handle, self.host, 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def descriptor(self) -> dict:
        modes = ["tcp"] + (["pull"] if self.pull_source is not None else [])
        return {"host": self.host, "port": self.port, "modes": modes,
                **(self.layout or {})}

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        # requests with payload frames on THIS connection whose commit has
        # not arrived: a connection that dies mid-stream leaves their
        # caches partly scattered, so their commits must be nacked
        streaming: set = set()
        self._writers.add(writer)
        try:
            while True:
                try:
                    header = await read_header(reader, "transfer")
                except ValueError as e:
                    logger.error("%s", e)
                    return
                if header is None:
                    return
                mtype = header.get("type")
                if mtype == "blocks":
                    rid = header["request_id"]
                    # marked BEFORE the payload read: dying mid-payload is
                    # the same partial-stream hazard as dying between frames
                    streaming.add(rid)
                    k, v = await TcpBackend.recv_blocks(reader, header)
                    self.frames_received += 1
                    self.bytes_received += (int(header["k_bytes"])
                                            + int(header["v_bytes"]))
                    bad = (layout_mismatch(self.layout, frame_layout(header))
                           if self.layout is not None else None)
                    if bad is not None:
                        logger.error(
                            "refusing the KV frame of %s: its cache layout "
                            "differs: %s", rid, bad)
                        self._poison.mark(rid, reason=f"layout: {bad}")
                        continue
                    if not self.authorize(rid, header["block_ids"]):
                        # request gone: a later commit for it is nacked
                        self._poison.mark(rid, reason="unauthorized")
                        continue
                    result = self.scatter(rid, header["block_ids"], k, v)
                    if inspect.isawaitable(result):
                        await result
                elif mtype == "commit":
                    rid = header["request_id"]
                    streaming.discard(rid)
                    if self._poison.pop(rid):
                        logger.warning("nacking commit for %s: an earlier "
                                       "payload frame was dropped", rid)
                        self.nacks += 1
                        writer.write(struct.pack(">I", 1) + b"\x00")
                        await writer.drain()
                        continue
                    top = header.get("top")
                    self.on_commit(
                        rid, header["first_token"], header.get("logprob"),
                        {int(t): float(x) for t, x in top.items()} if top else None,
                        header.get("spans"))
                    writer.write(struct.pack(">I", 1) + b"\x01")
                    await writer.drain()
                elif mtype == "pull":
                    # read-only block serve: stream the longest locally
                    # resident run of the requested chain on THIS connection
                    await self._serve_pull(header, writer)
                elif mtype == "ici_blocks":
                    logger.error("refusing an 'ici_blocks' frame: the ici "
                                 "collective backend is not ported to the "
                                 "PyTorch engine")
                    streaming.add(header["request_id"])
                    return
                else:
                    logger.error("unknown transfer frame type %r", mtype)
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            logger.warning("kv transfer connection lost", exc_info=True)
        except Exception:
            logger.exception("kv transfer connection failed")
        finally:
            for rid in streaming:
                logger.warning("transfer connection closed mid-stream for %s; "
                               "poisoning its commit (decode falls back to a "
                               "local prefill)", rid)
                self._poison.mark(rid, reason="conn_death")
            self._writers.discard(writer)
            writer.close()

    async def _serve_pull(self, header: dict,
                          writer: asyncio.StreamWriter) -> None:
        """Serve one ``pull`` frame: the longest locally held run of the
        requested chain as chunk frames, then a ``pull_end`` trailer.

        Strictly read-only: the grant pins its HBM blocks and is released
        in the ``finally``, so a puller that vanishes mid-stream costs this
        engine nothing but the frames already sent. The gathers dispatch
        here; the host waits and the byte packing ride the executor."""
        hashes = [int(h) for h in header.get("hashes") or []]
        chunk = max(1, int(header.get("chunk_blocks", 16)))
        grant = self.pull_source(hashes) if self.pull_source else None
        if grant is None:
            pack_frame(writer, {"type": "pull_end", "served": 0})
            await writer.drain()
            return
        try:
            n = len(grant)
            for lo in range(0, n, chunk):
                if maybe_drop_connection():
                    # fault site: the serving side dies mid-stream; the
                    # puller falls back to a local recompute with its
                    # reservation freed and nothing registered
                    writer.close()
                    return
                hi = min(lo + chunk, n)
                kb, vb, shape, dtype, v_shape = await grant.gather_frame(lo, hi)
                frame = {"type": "pull_blocks", "shape": shape, "dtype": dtype,
                         "k_bytes": len(kb), "v_bytes": len(vb)}
                if v_shape != shape:
                    frame["v_shape"] = v_shape
                pack_frame(writer, frame, kb, vb)
                await writer.drain()
            pack_frame(writer, {"type": "pull_end", "served": n})
            await writer.drain()
            self.pulls_served += 1
        finally:
            grant.release()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # a sender's cached connection stays open between requests;
            # wait_closed waits for every connection to end
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()


class KvTransferClient:
    """Prefill-side connection pushing block frames to one decode engine."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> "KvTransferClient":
        self.reader, self.writer = await asyncio.open_connection(
            self.host, self.port)
        return self

    async def send_blocks(self, request_id: str, block_ids: List[int],
                          k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                          chunk_blocks: int = 16,
                          trace_id: Optional[str] = None) -> int:
        """Stream host blocks ``[L, n, bs, ...]`` in frames of at most
        ``chunk_blocks``, so the receiver overlaps scatter with reads.
        Returns the payload bytes sent."""
        n = len(block_ids)
        if k_blocks.shape[1] != n or v_blocks.shape[1] != n:
            raise ValueError(f"{n} block ids for blocks of shapes "
                             f"{tuple(k_blocks.shape)} {tuple(v_blocks.shape)}")
        sent = 0
        for i in range(0, n, chunk_blocks):
            ids = block_ids[i: i + chunk_blocks]
            header = {"type": "blocks", "request_id": request_id,
                      "block_ids": list(map(int, ids))}
            if trace_id:
                header["trace_id"] = trace_id
            sent += await TcpBackend.send_blocks(
                self.writer, header, k_blocks[:, i: i + len(ids)],
                v_blocks[:, i: i + len(ids)])
        return sent

    async def send_ici_blocks(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "send_ici_blocks: the ici collective backend is not ported to "
            "the PyTorch engine")

    async def send_commit(self, request_id: str, first_token: int,
                          logprob: Optional[float] = None,
                          top: Optional[dict] = None,
                          spans: Optional[dict] = None) -> bool:
        """True if the receiver committed, False if it nacked (a payload
        frame was dropped: the decode side prefills locally; the sender
        releases its side either way)."""
        pack_frame(self.writer, {
            "type": "commit",
            "request_id": request_id,
            "first_token": int(first_token),
            "logprob": None if logprob is None else float(logprob),
            "top": {str(t): float(x) for t, x in top.items()} if top else None,
            "spans": spans,
        })
        await self.writer.drain()
        # after the ack the decode side owns the KV
        ack = await read_exact(self.reader, 5)
        return ack[-1:] == b"\x01"

    async def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except (ConnectionError, OSError):
                pass  # a peer that is already gone
