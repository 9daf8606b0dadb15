"""Cluster KV fabric: cross-worker prefix pulls and cold-tier rehydration.

The port's copy of ``dynamo_tpu/kv/fabric.py``. Per-process prefix caching
becomes a cluster-wide cache: when the ownership view says another worker
already computed a longer prefix of this prompt than any local tier holds,
the scheduler PULLS those committed KV blocks over the transfer plane
instead of recomputing them; when the cold tier (``kv/cold_tier.py``)
holds the extension, the pull reads checksummed spill files instead of
the wire. Either way the unmatched tail still prefills locally, and any
failure (peer dead, timeout, checksum miss, an injected fault) falls back
to a local recompute with a byte-identical stream: the fallback registered
nothing, so the allocator's state is exactly the no-fabric state.

- ``KvFabric``, one per engine: the *ownership view* (a ``KvIndexer`` fed
  with other workers' KV events, the stream the KV router indexes), the
  peer descriptors, the cold tier and both halves of the pull.
- The serve half plugs into ``KvTransferServer(pull_source=...)``
  (``disagg/transfer.py``): a peer's ``pull`` frame resolves the longest
  locally resident run of the requested hash chain (HBM blocks pinned for
  the stream, host-tier blocks copied out of the slab) and streams it back
  chunk by chunk. The gathers dispatch on the loop (they must order with
  the engine's own steps); the host waits and the byte packing ride the
  executor.
- The pull half (``KvFabric.pull``) scatters the arriving frames into
  blocks the scheduler reserved: each frame is pinned on the executor
  while the loop reads the next one, then scattered on the loop.

Only the tcp payload path exists: the ici collective plane (``set_ici``,
a device-to-device frame, its negotiation) is refused by name, as the
port's ``--kv-transfer ici`` is. Each pull records the ``dynamo_transfer_*``
family (``plane="fabric"``; backend ``tcp`` for a peer, ``local`` for a
cold rehydrate) and a peer pull's ``transfer.open`` flight event; the
fabric also keeps plain counters (``stats()``: the same bytes) and its
pull counter in the registry.

Fault sites: ``transfer_conn_drop`` (the serving side dies mid-stream)
and ``prefix_pull_stall`` (the pulling side stalls until the scheduler's
deadline cancels it); both end in the byte-identical local fallback with
zero leaked blocks.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.attention import _bytes
from ..transfer.framing import dtype_name, pack_frame, read_header
from ..transfer.plane import TransferMetrics, negotiate_backend, record_open
from ..transfer.tcp import TcpBackend
from ..utils import faults

logger = logging.getLogger(__name__)

# blocks per pull frame: bounds both sides' host buffers the way the
# streamed-prefill plane bounds its own
PULL_CHUNK_BLOCKS = 16
# pulls kept in ``KvFabric.recent`` for the stats scrape
RECENT_PULLS = 64


def fabric_key(namespace: str, component: str, engine_id: str) -> str:
    """Discovery key a worker's pull server registers under (lease-scoped,
    like the KV transfer descriptors)."""
    return f"{namespace}/components/{component}/kv_fabric/{engine_id}"


@dataclass
class PullPlan:
    """One planned prefix pull: the hash run to fetch and its source."""

    source: str                      # "peer" | "cold"
    hashes: List[int]                # sequence hashes, a run of the chain
    start_block: int                 # chain index of hashes[0]
    worker_id: Optional[str] = None  # peer pulls: the owning worker
    host: Optional[str] = None
    port: Optional[int] = None
    backend: str = "tcp"             # the one payload path the port serves

    @property
    def blocks(self) -> int:
        return len(self.hashes)


@dataclass
class _GrantEntry:
    sequence_hash: int
    kind: str                        # "hbm" | "host"
    block_id: Optional[int] = None   # hbm
    arrays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # host copies


class PullGrant:
    """Server-side lease over the blocks one pull serves.

    HBM blocks are pinned at resolution (the allocator will neither evict
    nor reuse them mid-gather); ``release`` unpins and MUST run exactly
    once, connection death included (the transfer server's ``finally``
    owns that)."""

    def __init__(self, fabric: "KvFabric", entries: List[_GrantEntry]):
        self._fabric = fabric
        self.entries = entries
        self._released = False

    @property
    def hashes(self) -> List[int]:
        return [e.sequence_hash for e in self.entries]

    def __len__(self) -> int:
        return len(self.entries)

    async def gather_frame(self, lo: int, hi: int):
        """Entries [lo, hi) as one wire frame: ``(k_bytes, v_bytes,
        k_shape, dtype_name, v_shape)`` over ``[L, n, bs, ...]``.

        The device gather and its copy into pinned memory dispatch on the
        loop (they order with the engine's own steps over the shared
        cache); the wait on that copy's event, the assembly with host-tier
        entries and the byte packing ride the executor."""
        chunk = self.entries[lo:hi]
        hbm_ids = [e.block_id for e in chunk if e.kind == "hbm"]
        runner = self._fabric.runner
        copy = None
        if hbm_ids:
            copy = runner.stage_blocks_to_host(
                *runner.gather_blocks_device(hbm_ids))
        dtypes = [c.dtype for c in runner.kv_cache]

        def _assemble():
            hbm = None
            if copy is not None:
                hbm = [t.view(d) for t, d in zip(copy.tensors(), dtypes)]
            parts: List[List[torch.Tensor]] = [[], []]
            j = 0
            for e in chunk:
                for c in range(2):
                    parts[c].append(hbm[c][:, j:j + 1] if e.kind == "hbm"
                                    else e.arrays[c])
                j += e.kind == "hbm"
            k, v = (_cat_blocks(p) for p in parts)
            raw = [t.view(-1).view(torch.uint8).numpy().tobytes() for t in (k, v)]
            return raw[0], raw[1], list(k.shape), dtype_name(k.dtype), list(v.shape)

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, _assemble)

    async def gather_frame_device(self, lo: int, hi: int):
        raise NotImplementedError(
            "gather_frame_device: the ici collective plane is not ported to "
            "the PyTorch engine (pulls ride tcp)")

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        hbm = [e.block_id for e in self.entries if e.kind == "hbm"]
        if hbm:
            self._fabric.allocator.unpin_blocks(hbm)


class KvFabric:
    """One per engine: ownership view + cold tier + pull client/server."""

    def __init__(
        self,
        runner,
        allocator,
        engine_id: str,
        block_size: int = 16,
        cold=None,                   # Optional[KvColdTier]
        peers: Optional[Callable[[], Dict[str, dict]]] = None,
        peer_pull: bool = True,
        min_pull_blocks: int = 1,
        pull_timeout_s: float = 30.0,
        chunk_blocks: int = PULL_CHUNK_BLOCKS,
        registry=None,
        ici=None,
    ):
        from ..kv_router.indexer import KvIndexer

        self.runner = runner
        self.allocator = allocator
        self.engine_id = engine_id
        self.block_size = block_size
        self.cold = cold
        # worker_id → {"host", "port"} descriptors of peer pull servers
        self.peers = peers or (lambda: {})
        # the cross-worker half is opt-in (prefix_pull): a cold-tier-only
        # configuration plans cold rehydrates but never reaches over the
        # network (and the CLI wiring starts no pull server)
        self.peer_pull = peer_pull
        self.min_pull_blocks = max(1, min_pull_blocks)
        self.pull_timeout_s = pull_timeout_s
        self.chunk_blocks = max(1, chunk_blocks)
        # the ownership view: remote workers' KV events (this engine's own
        # are skipped: the local tiers answer faster than any pull)
        self.indexer = KvIndexer(block_size)
        self.server = None           # KvTransferServer started by serve()
        # wiring-owned background tasks (event feed, peer refresh), held
        # so close() cancels them
        self._tasks: List[asyncio.Task] = []
        if registry is None:
            from ..telemetry.registry import MetricsRegistry

            registry = MetricsRegistry()
        self.registry = registry
        if cold is not None and cold.registry is not registry:
            registry.attach(cold.registry)
        self._pulls = registry.counter(
            "dynamo_kv_fabric_prefix_pull_total",
            "Prefix pulls, labelled source=peer|cold and outcome="
            "committed|failed|empty (failed/empty fall back to local "
            "recompute, byte-identically)")
        self._xfer = TransferMetrics(registry, plane="fabric")
        # plain counters beside the transfer family (the stats scrape's)
        self.pull_bytes = {"tcp": 0, "local": 0}
        self.pull_seconds = 0.0
        self.serves = 0
        self.served_blocks = 0
        self.recent: deque = deque(maxlen=RECENT_PULLS)
        if ici is not None:
            self.set_ici(ici)

    def set_ici(self, plane) -> None:
        raise NotImplementedError(
            "the ici transfer backend (a device-to-device collective plane) "
            "is not ported to the PyTorch engine; prefix pulls ride tcp")

    # ---------- ownership view ----------

    def apply_event(self, event) -> None:
        """Feed one RouterEvent (``kv_router/protocols.py``) into the
        ownership view. Events from this engine are ignored."""
        if event.worker_id == self.engine_id:
            return
        self.indexer.apply_event(event)

    def remove_worker(self, worker_id: str) -> None:
        self.indexer.remove_worker(worker_id)

    # ---------- planning (sync; the scheduler's admission path) ----------

    def may_hold_any(self) -> bool:
        """Cheap admission gate: is there ANY ownership to plan against?
        With an empty peer view and an empty cold index (one worker) the
        per-request probe must cost nothing."""
        return ((self.peer_pull and len(self.indexer.tree) > 0)
                or (self.cold is not None and len(self.cold) > 0))

    def plan(self, hashes: List[int], local_blocks: int,
             prompt_len: int) -> Optional[PullPlan]:
        """Best pull extending a ``local_blocks``-block local hit.

        At least one prompt token stays uncached (the engine needs logits
        to sample from), so the pulled run is capped at
        ``(prompt_len - 1) // block_size`` cached blocks in all. None when
        no source beats the local tiers by ``min_pull_blocks``."""
        max_cached = max(0, (prompt_len - 1) // self.block_size)
        budget = max_cached - local_blocks
        if budget < self.min_pull_blocks:
            return None
        cold_run: List[int] = []
        if self.cold is not None:
            cold_run = self.cold.match_extension(hashes, local_blocks)[:budget]
        peer_plan = (self._best_peer_run(hashes, local_blocks, budget)
                     if self.peer_pull else None)
        # the longer run wins; a tie goes to the cold tier (a local disk
        # beats a network round trip at equal coverage)
        if (len(cold_run) >= self.min_pull_blocks
                and (peer_plan is None or len(cold_run) >= peer_plan.blocks)):
            return PullPlan(source="cold", hashes=list(cold_run),
                            start_block=local_blocks)
        return peer_plan

    def _best_peer_run(self, hashes: List[int], local_blocks: int,
                       budget: int) -> Optional[PullPlan]:
        if len(self.indexer.tree) == 0:
            return None
        overlap = self.indexer.find_matches(hashes)
        peers = self.peers() or {}
        best: Optional[Tuple[int, str]] = None
        for wid, score in overlap.scores.items():
            if wid == self.engine_id or wid not in peers:
                continue
            run = min(score, local_blocks + budget) - local_blocks
            if run < self.min_pull_blocks:
                continue
            if best is None or run > best[0]:
                best = (run, wid)
        if best is None:
            return None
        run, wid = best
        desc = peers[wid]
        return PullPlan(
            source="peer",
            hashes=list(hashes[local_blocks:local_blocks + run]),
            start_block=local_blocks, worker_id=wid,
            host=desc.get("host"), port=desc.get("port"),
            # the peer plays the sender when we pull
            backend=negotiate_backend(desc, peer_role="sender"))

    def rank_peers(self, peers: List[dict],
                   token_ids: List[int]) -> List[dict]:
        """Order peer descriptors by prefix overlap with ``token_ids``
        (descending; ties keep the input order): the selection recovery
        uses for migration targets. The descriptor's ``worker_id`` (the
        KV-event id) is the join key; one without it scores 0."""
        from ..tokens import compute_block_hashes

        if not peers or len(self.indexer.tree) == 0:
            return list(peers)
        overlap = self.indexer.find_matches(
            compute_block_hashes(token_ids, self.block_size))
        return sorted(
            peers,
            key=lambda p: -overlap.scores.get(
                p.get("worker_id") or p.get("engine_id", ""), 0))

    # ---------- serve half (KvTransferServer pull_source) ----------

    def grant(self, hashes: List[int]) -> Optional[PullGrant]:
        """Resolve and pin the longest locally resident run of ``hashes``.

        HBM blocks (``allocator.by_hash``) are pinned; host-tier blocks
        are copied out of the slab now (a later drain may reuse their
        slots). Staged, not yet drained, offloads are skipped. None when
        not even the first hash is resident."""
        entries: List[_GrantEntry] = []
        pinned: List[int] = []
        tier2 = self.allocator.tier2
        for h in hashes:
            bid = self.allocator.by_hash.get(h)
            if bid is not None:
                entries.append(_GrantEntry(h, "hbm", block_id=bid))
                pinned.append(bid)
                continue
            arrays = tier2.read(h) if tier2 is not None else None
            if arrays is not None:
                entries.append(_GrantEntry(h, "host", arrays=arrays))
                continue
            break
        if not entries:
            return None
        if pinned:
            self.allocator.pin_blocks(pinned)
        self.serves += 1
        self.served_blocks += len(entries)
        return PullGrant(self, entries)

    async def serve(self, host: str = "127.0.0.1"):
        """Start this fabric's pull server (a read-only KvTransferServer)
        and return it; its descriptor registers under ``fabric_key``."""
        from ..disagg.transfer import KvTransferServer

        self.server = await KvTransferServer(
            scatter=lambda *a: None, on_commit=lambda *a: None,
            pull_source=self.grant, host=host).start()
        return self.server

    def hold_task(self, task) -> None:
        """Adopt a wiring-layer task (event consumer, peer refresh, the
        cold index's priming) into this fabric's lifecycle."""
        self._tasks.append(task)

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        if self.server is not None:
            await self.server.close()
        if self.cold is not None:
            await self.cold.close()

    def stats(self) -> dict:
        """Plain counters for a worker's stats scrape."""
        pulls: Dict[str, int] = {}
        for key, n in self._pulls.values.items():
            d = dict(key)
            pulls[f"{d.get('source')}_{d.get('outcome')}"] = int(n)
        return {"pulls": pulls, "pull_bytes": dict(self.pull_bytes),
                "pull_seconds": self.pull_seconds, "serves": self.serves,
                "served_blocks": self.served_blocks,
                "pinned_blocks": len(self.allocator.pinned),
                "recent": list(self.recent)}

    # ---------- pull half (a scheduler-owned task) ----------

    async def pull(self, plan: PullPlan, block_ids: List[int],
                   request_id: str = "", trace_id: Optional[str] = None) -> int:
        """Execute one pull into the reserved ``block_ids``.

        Returns the number of blocks installed: always a PREFIX of
        ``plan.hashes`` (the caller registers exactly that run and
        recomputes the rest). Raises on a transport failure; the caller
        falls back to a local recompute and frees the reservation. Nothing
        here registers blocks: a partly scattered reservation is anonymous
        and dies with the fallback's free."""
        assert len(block_ids) >= len(plan.hashes)
        t0 = time.monotonic()
        outcome = "failed"
        served = 0
        backend = "local" if plan.source == "cold" else plan.backend
        try:
            if plan.source == "cold":
                served = await self._pull_cold(plan, block_ids)
            else:
                served = await self._pull_peer(plan, block_ids)
            outcome = "committed" if served else "empty"
            return served
        finally:
            seconds = time.monotonic() - t0
            self._pulls.inc(source=plan.source, outcome=outcome)
            self._xfer.observe_duration(seconds, backend)
            self.pull_seconds += seconds
            self.recent.append(dict(
                request_id=request_id, source=plan.source,
                worker=plan.worker_id, asked=plan.blocks, served=served,
                outcome=outcome, seconds=seconds))

    async def _maybe_stall(self) -> None:
        # fault site: the pull stalls mid-flight; the scheduler's deadline
        # must cancel it and fall back byte-identically
        if faults.fire("prefix_pull_stall"):
            await asyncio.sleep(3600.0)

    async def _pull_cold(self, plan: PullPlan, block_ids: List[int]) -> int:
        loop = asyncio.get_running_loop()
        served = 0
        for lo in range(0, len(plan.hashes), self.chunk_blocks):
            await self._maybe_stall()
            chunk = plan.hashes[lo:lo + self.chunk_blocks]

            def _read(chunk=chunk):
                ks, vs = [], []
                for h in chunk:
                    got = self.cold.get(h)
                    if got is None:
                        break  # absent or corrupt: the run ends here
                    ks.append(got[0])
                    vs.append(got[1])
                if not ks:
                    return None
                k, v = self.runner.stage_blocks(_cat_blocks(ks),
                                                _cat_blocks(vs))
                return k, v, len(ks)

            staged = await loop.run_in_executor(None, _read)
            if staged is None:
                break
            k, v, n = staged
            # the cache-mutating scatter on the loop: it orders with the
            # scheduler's own dispatches over the shared cache
            self.runner.scatter_blocks(block_ids[served:served + n], k, v)
            nbytes = _nbytes(k) + _nbytes(v)
            self.pull_bytes["local"] += nbytes
            self._xfer.add_bytes(nbytes, "local")
            served += n
            if n < len(chunk):
                break
        return served

    async def _pull_peer(self, plan: PullPlan, block_ids: List[int]) -> int:
        loop = asyncio.get_running_loop()
        reader, writer = await asyncio.open_connection(plan.host, plan.port)
        record_open("fabric", "tcp", peer=plan.worker_id or "")
        self._xfer.channel_opened("tcp")
        try:
            pack_frame(writer, {
                "type": "pull",
                "hashes": [int(h) for h in plan.hashes],
                "chunk_blocks": self.chunk_blocks,
                "trace_id": None,
                "backend": "tcp",
            })
            await writer.drain()
            served = 0
            while True:
                await self._maybe_stall()
                frame = await read_header(reader, "pull")
                if frame is None:
                    # the serving side died mid-stream: the pull fails and
                    # the caller recomputes locally; nothing registered
                    raise ConnectionResetError("pull connection closed mid-stream")
                ftype = frame.get("type")
                if ftype == "pull_blocks":
                    k, v = await TcpBackend.recv_blocks(reader, frame)
                    n = k.shape[1]
                    if served + n > len(plan.hashes):
                        raise ValueError("peer served past the asked run")
                    # pin off the loop, scatter on it: the next frame's
                    # read overlaps this one's copy to the card
                    k, v = await loop.run_in_executor(
                        None, self.runner.stage_blocks, k, v)
                    self.runner.scatter_blocks(block_ids[served:served + n], k, v)
                    nbytes = _nbytes(k) + _nbytes(v)
                    self.pull_bytes["tcp"] += nbytes
                    self._xfer.add_bytes(nbytes, "tcp")
                    served += n
                elif ftype == "pull_end":
                    return min(served, int(frame.get("served", served)))
                else:
                    raise ValueError(f"unknown pull frame {ftype!r}")
        finally:
            self._xfer.channel_closed("tcp")
            writer.close()


def _cat_blocks(parts: List[torch.Tensor]) -> torch.Tensor:
    """Block tensors ``[L, n_i, ...]`` concatenated on dim 1, through their
    bytes (torch has no fp8 ``cat`` on the CPU)."""
    return torch.cat([_bytes(p) for p in parts], dim=1).view(parts[0].dtype)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()
