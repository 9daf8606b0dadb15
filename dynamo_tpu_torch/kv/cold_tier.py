"""Content-addressed cold KV tier: a disk spill that survives process death.

The port's copy of ``dynamo_tpu/kv/cold_tier.py``, the third tier of the
KV hierarchy (HBM → host RAM → here). Blocks are keyed by their *chained
sequence hash* (``tokens.py``) and stored one file per block, so identical
token prefixes written by ANY worker rehydrate on any other worker sharing
the directory, a freshly respawned one included, whose HBM and host tiers
start empty. Every read is checksum-verified and every write is atomic
(tmp + rename), so a shared mount serves as well as a local disk.

File layout (``<dir>/<sequence_hash:016x>.kvb``), the reference's::

    [4-byte big-endian header len][header][k raw bytes][v raw bytes]

The header is the runtime's wire codec (``runtime/wire.py``, byte for byte
msgpack's) of ``{magic: "dynkv1", sequence_hash, parent_hash, shape,
dtype, k_bytes, v_bytes, checksum}``: the sequence hash again (a renamed
file must not serve under the wrong prefix), K's shape ``[L, 1, bs, ...]``
and the dtype by name (``bfloat16``, ``float8_e4m3fn``, ...: the bytes are
viewed back as that dtype), and xxh64 over the payload (K's bytes then
V's). A file of either package reads in the other. Where V's shape differs
from K's (MLA's ``k_rope`` beside ``c_kv``) the port adds ``v_shape``;
the reference reads V with K's shape and so quarantines such files.

A failed verification (wrong magic, hash mismatch, short payload, checksum
mismatch) is a MISS, never an install: the file is quarantined (deleted)
and counted.

The checksum routine is the caller's (``checksum``): the scheduler gives
a CUDA engine's cold tier the native host xxh64 (``ops/host_xxh64.py``),
the plain pure-Python one otherwise.

Threading discipline: ``offer`` (the host tier's eviction hook) schedules
the file write on the event loop's executor and HOLDS the future;
``get`` / ``put`` / ``refresh`` are sync and belong on an executor thread
(the fabric's pull task is the production caller). ``has`` /
``match_extension`` consult only the in-memory index, so the scheduler's
planning path stays cheap; the index can be stale against other writers of
a shared directory, which is safe because a read re-verifies and treats
absence as a miss. The ownership hooks (``on_stored`` / ``on_removed``,
the KV event publisher's cold pair) always run on the serving loop.
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import threading
import time
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..ops.host_xxh64 import xxh64_pair_ref
from ..runtime.wire import packb, unpackb
from ..transfer.framing import dtype_name, torch_dtype

logger = logging.getLogger(__name__)

_MAGIC = "dynkv1"
_SUFFIX = ".kvb"
_MAX_HEADER = 1 << 20


def _fname(sequence_hash: int) -> str:
    return f"{sequence_hash & (2**64 - 1):016x}{_SUFFIX}"


def _raw(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def _view(raw: bytes, shape, dtype: torch.dtype) -> torch.Tensor:
    # a bytearray is writable: torch.frombuffer wants a writable buffer
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return flat.view(dtype).reshape(tuple(shape))


class KvColdTier:
    """Disk store of KV blocks keyed by sequence hash.

    ``capacity_blocks`` bounds the block files this process keeps, least
    recently accessed first (in-memory order; ``refresh`` seeds it from
    mtimes, which ``get`` also touches so other workers sharing the
    directory see accesses too). ``on_stored`` / ``on_removed`` mirror the
    allocator's KV event hooks so a router learns cold ownership."""

    def __init__(
        self,
        directory: str,
        capacity_blocks: int,
        registry=None,
        on_stored=None,   # (hashes: List[int], parent: Optional[int]) -> None
        on_removed=None,  # (hashes: List[int]) -> None
        checksum: Optional[Callable[[bytes, bytes], int]] = None,
    ):
        self.dir = directory
        self.capacity_blocks = capacity_blocks
        self.on_stored = on_stored or (lambda hashes, parent: None)
        self.on_removed = on_removed or (lambda hashes: None)
        self.checksum = checksum or xxh64_pair_ref
        os.makedirs(self.dir, exist_ok=True)
        # hash → payload bytes, in access (LRU) order: the capacity bound
        # pops the front without re-statting the directory
        self._index: "OrderedDict[int, int]" = OrderedDict()
        # resident payload bytes as a plain int (a gauge reads it from the
        # loop while executor-side puts mutate the index)
        self._bytes = 0
        # serializes executor-side mutation (puts, gets and refreshes run
        # on whatever executor thread their future landed on)
        self._mutate = threading.Lock()
        # the serving loop, captured at construction or at the first
        # loop-side offer: executor-side hook calls are marshalled onto it
        try:
            self._loop: Optional[asyncio.AbstractEventLoop] = (
                asyncio.get_running_loop())
        except RuntimeError:
            self._loop = None
        # spill writes in flight (offer), held so close() drains them
        self._writes: set = set()
        # seconds spent in the checksum and in whole puts / gets (the
        # phase's write and read rates and the checksum's share of them)
        self.checksum_s = self.put_s = self.get_s = 0.0
        self.put_bytes = self.get_bytes = 0
        if registry is None:
            from ..telemetry.registry import MetricsRegistry

            registry = MetricsRegistry()
        self.registry = registry
        self._hits = registry.counter(
            "dynamo_kv_fabric_cold_tier_hits_total",
            "Cold-tier block reads that verified and rehydrated")
        self._misses = registry.counter(
            "dynamo_kv_fabric_cold_tier_misses_total",
            "Cold-tier block reads that failed, labelled reason="
            "absent|corrupt (corrupt files are quarantined, never installed)")
        self._evictions = registry.counter(
            "dynamo_kv_fabric_cold_tier_evictions_total",
            "Cold-tier block files evicted by the capacity bound (oldest "
            "access first)")
        registry.callback_gauge(
            "dynamo_kv_fabric_cold_tier_bytes",
            "Payload bytes resident in this process's cold-tier index",
            lambda: float(self._bytes))

    # ---------- sync index surface (the scheduler's planning path) ----------

    def __len__(self) -> int:
        return len(self._index)

    def has(self, sequence_hash: int) -> bool:
        return sequence_hash in self._index

    def match_extension(self, hashes: Sequence[int], start: int) -> List[int]:
        """Longest index-resident run of ``hashes`` starting at ``start``
        (the contract of ``KvHostTier.match_extension``)."""
        out: List[int] = []
        for h in hashes[start:]:
            if h not in self._index:
                break
            out.append(h)
        return out

    def counts(self) -> dict:
        """Hits, misses by reason and evictions so far."""
        misses = {dict(k).get("reason", ""): int(v)
                  for k, v in self._misses.values.items()}
        return {"hits": int(sum(self._hits.values.values())),
                "misses": misses,
                "evictions": int(sum(self._evictions.values.values()))}

    # ---------- executor-side I/O ----------

    def refresh(self) -> int:
        """Rescan the directory into the index (sync; executor-bound).

        The respawn-warm path: a fresh worker over a populated directory
        learns every resident prefix here and ADVERTISES the delta through
        the ownership hooks, so routers and peer fabrics can score it.
        Returns the number of indexed blocks."""
        found = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            logger.exception("cold tier dir unreadable: %s", self.dir)
            names = []
        for name in names:
            if not name.endswith(_SUFFIX):
                continue
            try:
                h = int(name[: -len(_SUFFIX)], 16)
                path = os.path.join(self.dir, name)
                found.append((os.path.getmtime(path), h, os.path.getsize(path)))
            except (ValueError, OSError):
                continue  # a foreign file; the read path would reject it too
        found.sort()  # oldest access first = the front of the LRU order
        index = OrderedDict((h, size) for _m, h, size in found)
        with self._mutate:
            prev = set(self._index)
            # keep entries this process wrote while the scan ran (a put
            # landing between listdir and here must not be dropped)
            for h, size in self._index.items():
                if h not in index:
                    index[h] = size
            self._index = index
            self._bytes = sum(index.values())
        added = [int(h) for h in index if h not in prev]
        if added:
            self._emit(self.on_stored, added, None)
        return len(index)

    def put(self, sequence_hash: int, k: torch.Tensor, v: torch.Tensor,
            parent_hash: Optional[int] = None) -> None:
        """Write one block ``[L, 1, bs, ...]`` atomically (sync;
        executor-bound)."""
        t0 = time.perf_counter()
        k_raw, v_raw = _raw(k), _raw(v)
        t1 = time.perf_counter()
        checksum = self.checksum(k_raw, v_raw)
        self.checksum_s += time.perf_counter() - t1
        header = {
            "magic": _MAGIC,
            "sequence_hash": int(sequence_hash),
            "parent_hash": None if parent_hash is None else int(parent_hash),
            "shape": list(k.shape),
            "dtype": dtype_name(k.dtype),
            "k_bytes": len(k_raw),
            "v_bytes": len(v_raw),
            "checksum": checksum,
        }
        if list(v.shape) != list(k.shape):
            header["v_shape"] = list(v.shape)
        header = packb(header)
        path = os.path.join(self.dir, _fname(sequence_hash))
        # file I/O outside the lock; the tmp name is unique per thread (a
        # same-hash race is benign: content addressing makes both equal)
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(struct.pack(">I", len(header)))
            f.write(header)
            f.write(k_raw)
            f.write(v_raw)
        os.replace(tmp, path)  # atomic: readers see whole files or none
        with self._mutate:
            size = len(k_raw) + len(v_raw)
            self._bytes += size - (self._index.get(sequence_hash) or 0)
            self._index[sequence_hash] = size
            self._index.move_to_end(sequence_hash)  # newest = the LRU back
            self._emit(self.on_stored, [int(sequence_hash)], parent_hash)
            self._enforce_capacity()
            self.put_s += time.perf_counter() - t0
            self.put_bytes += size

    def get(self, sequence_hash: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Read and verify one block (sync; executor-bound). Any failed
        verification is a miss: corrupt or truncated files are quarantined
        (deleted) and counted, NEVER installed."""
        t0 = time.perf_counter()
        path = os.path.join(self.dir, _fname(sequence_hash))
        try:
            with open(path, "rb") as f:
                raw_len = f.read(4)
                if len(raw_len) < 4:
                    raise ValueError("truncated header length")
                (hlen,) = struct.unpack(">I", raw_len)
                if hlen > _MAX_HEADER:
                    raise ValueError(f"header too large: {hlen}")
                header = unpackb(f.read(hlen))
                if (header.get("magic") != _MAGIC
                        or int(header.get("sequence_hash", -1))
                        != int(sequence_hash)):
                    raise ValueError("magic/hash mismatch")
                k_raw = f.read(header["k_bytes"])
                v_raw = f.read(header["v_bytes"])
                if (len(k_raw) != header["k_bytes"]
                        or len(v_raw) != header["v_bytes"]):
                    raise ValueError("truncated payload")
                t1 = time.perf_counter()
                checksum = self.checksum(k_raw, v_raw)
                self.checksum_s += time.perf_counter() - t1
                if checksum != header["checksum"]:
                    raise ValueError("checksum mismatch")
                dtype = torch_dtype(header["dtype"])
                k = _view(k_raw, header["shape"], dtype)
                v = _view(v_raw, header.get("v_shape") or header["shape"], dtype)
        except FileNotFoundError:
            # another worker sharing the directory evicted it: retract the
            # ownership advertisement too
            with self._mutate:
                self._forget(sequence_hash)
            self._emit(self.on_removed, [int(sequence_hash)])
            self._misses.inc(reason="absent")
            return None
        except (ValueError, KeyError, TypeError, OSError, RuntimeError,
                IndexError, struct.error) as e:
            logger.warning("cold tier: quarantining corrupt block %s: %s",
                           _fname(sequence_hash), e)
            with self._mutate:
                self._drop(sequence_hash)
            self._misses.inc(reason="corrupt")
            return None
        with self._mutate:
            if sequence_hash in self._index:
                self._index.move_to_end(sequence_hash)  # LRU touch
            self.get_s += time.perf_counter() - t0
            self.get_bytes += len(k_raw) + len(v_raw)
        try:
            # mtime touch too: other workers sharing the directory (and
            # this process's next refresh) see the access order
            os.utime(path)
        except OSError:
            pass  # best effort; the eviction order degrades gracefully
        self._hits.inc()
        return k, v

    # ---------- the host tier's eviction hook (loop-side) ----------

    def offer(self, sequence_hash: int, k: torch.Tensor, v: torch.Tensor,
              parent_hash: Optional[int] = None) -> None:
        """Spill one block the host tier evicted. On the event loop the
        write rides the executor and the future is held (logged on
        failure, drained by ``close``); without a running loop (sync
        tests, offline tools) it happens inline. ``k`` and ``v`` must not
        change afterwards (the host tier hands over copies)."""
        if sequence_hash in self._index:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self.put(sequence_hash, k, v, parent_hash)
            return
        self._loop = loop
        fut = loop.run_in_executor(None, self.put, sequence_hash, k, v,
                                   parent_hash)
        self._writes.add(fut)

        def _done(f) -> None:
            self._writes.discard(f)
            if not f.cancelled() and f.exception() is not None:
                logger.warning("cold tier spill failed: %s", f.exception())

        fut.add_done_callback(_done)

    async def close(self) -> None:
        """Drain in-flight spill writes."""
        writes = list(self._writes)
        if writes:
            await asyncio.gather(*writes, return_exceptions=True)

    # ---------- internals ----------

    def _emit(self, fn, *args) -> None:
        """Run an ownership hook on the serving loop: put / get / _drop run
        on executor threads, but the hooks feed loop-bound machinery (the
        KV event publisher's queue). Loop-side and loopless callers invoke
        directly."""
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            loop = self._loop
            if loop is not None and loop.is_running():
                loop.call_soon_threadsafe(fn, *args)
                return
        fn(*args)

    def _forget(self, sequence_hash: int) -> None:
        # caller holds _mutate
        size = self._index.pop(sequence_hash, None)
        if size:
            self._bytes -= size

    def _drop(self, sequence_hash: int) -> None:
        # caller holds _mutate (threading.Lock is not reentrant)
        self._forget(sequence_hash)
        try:
            os.unlink(os.path.join(self.dir, _fname(sequence_hash)))
        except OSError:
            pass  # another worker may have evicted the same file first
        self._emit(self.on_removed, [int(sequence_hash)])

    def _enforce_capacity(self) -> None:
        # caller holds _mutate; O(evicted): the victim is the index's front
        while len(self._index) > self.capacity_blocks:
            self._drop(next(iter(self._index)))
            self._evictions.inc()

    def metrics(self) -> dict:
        return {
            "cold_kv_blocks": len(self._index),
            "cold_kv_capacity": self.capacity_blocks,
            "cold_kv_bytes": self._bytes,
        }
