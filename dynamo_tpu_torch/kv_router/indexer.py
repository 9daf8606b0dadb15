"""Global prefix index: which worker holds which KV blocks.

A radix/trie over *chained block hashes*: each node is one cached block
(identified by its sequence hash — i.e. the whole prefix ending there),
holding the set of workers that advertise it. ``find_matches`` walks a
request's block-hash chain from the root and scores workers by how many
consecutive blocks they already hold.

Reference analog: lib/llm/src/kv_router/indexer.rs — RadixTree with a
lookup map keyed by block hash, early-exit scoring, apply_event
Stored/Removed, remove_worker, and a sharded variant. The single-threaded
actor there becomes a plain asyncio-confined object here (one event loop ==
one thread); ``ShardedKvIndexer`` partitions workers for scale.

The port's copy of ``dynamo_tpu/kv_router/indexer.py``. ``KvIndexer`` and
``ShardedKvIndexer`` index over the native core's C++ tree
(``dynamo_tpu_torch/native``, ``_NativeTreeAdapter``) as the reference's
do; ``RadixTree`` below is its plain version, chosen by
``use_native=False``. A native build that fails raises: the plain tree is
never a quiet fallback.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set

from .protocols import RouterEvent


@dataclasses.dataclass
class OverlapScores:
    """worker → number of consecutive prefix blocks already cached."""

    scores: Dict[str, int] = dataclasses.field(default_factory=dict)
    # block hash → how many workers hold it (frequency info for policies)
    frequencies: List[int] = dataclasses.field(default_factory=list)
    # worker → ADDITIONAL consecutive blocks past its warm run that the
    # worker can rehydrate from its cold tier (kv/cold_tier.py spill
    # advertisements, RouterEvent tier="cold"); scored discounted vs a
    # warm hit by KvScheduler.cold_discount
    cold_scores: Dict[str, int] = dataclasses.field(default_factory=dict)

    def merge(self, other: "OverlapScores") -> None:
        for w, s in other.scores.items():
            self.scores[w] = max(self.scores.get(w, 0), s)
        for w, s in other.cold_scores.items():
            self.cold_scores[w] = max(self.cold_scores.get(w, 0), s)
        # frequencies are per-depth holder counts — sum element-wise
        if len(other.frequencies) > len(self.frequencies):
            self.frequencies.extend([0] * (len(other.frequencies) - len(self.frequencies)))
        for i, f in enumerate(other.frequencies):
            self.frequencies[i] += f


class _Node:
    __slots__ = ("hash", "parent", "children", "workers", "last_update")

    def __init__(self, h: Optional[int], parent: Optional["_Node"]):
        self.hash = h
        self.parent = parent
        self.children: Dict[int, _Node] = {}
        self.workers: Set[str] = set()
        self.last_update = time.monotonic()


class RadixTree:
    def __init__(self, expiration_s: Optional[float] = None):
        self.root = _Node(None, None)
        self.lookup: Dict[int, _Node] = {}
        self.expiration_s = expiration_s

    def find_matches(
        self, block_hashes: List[int], early_exit: bool = False
    ) -> OverlapScores:
        """Walk the chain from the root; score consecutive holders."""
        out = OverlapScores()
        node = self.root
        now = time.monotonic()
        active: Optional[Set[str]] = None  # workers still matching consecutively
        for h in block_hashes:
            child = node.children.get(h)
            if child is None:
                break
            if self.expiration_s is not None and now - child.last_update > self.expiration_s:
                break
            holders = child.workers
            active = holders if active is None else (active & holders)
            if not active:
                break
            for w in active:
                out.scores[w] = out.scores.get(w, 0) + 1
            out.frequencies.append(len(holders))
            if early_exit and len(active) == 1:
                # single candidate — extend its score cheaply down the chain
                (only,) = active
                n = child
                for h2 in block_hashes[len(out.frequencies):]:
                    n = n.children.get(h2)
                    if n is None or only not in n.workers:
                        break
                    out.scores[only] += 1
                    out.frequencies.append(len(n.workers))
                break
            node = child
        return out

    def apply_event(self, event: RouterEvent) -> None:
        if event.stored is not None:
            parent = (
                self.lookup.get(event.stored.parent_hash)
                if event.stored.parent_hash is not None
                else self.root
            )
            if parent is None:
                # parent unknown (dropped/expired) — root the chain here so the
                # blocks are still discoverable standalone
                parent = self.root
            for h in event.stored.block_hashes:
                node = self.lookup.get(h)
                if node is None:
                    node = _Node(h, parent)
                    parent.children[h] = node
                    self.lookup[h] = node
                elif node.parent is self.root and parent is not self.root:
                    # node was orphan-rooted (its parent event arrived late or
                    # was dropped) — re-link under its real parent so prefix
                    # walks see the full chain
                    self.root.children.pop(h, None)
                    node.parent = parent
                    parent.children[h] = node
                node.workers.add(event.worker_id)
                node.last_update = time.monotonic()
                parent = node
        if event.removed is not None:
            for h in event.removed.block_hashes:
                node = self.lookup.get(h)
                if node is None:
                    continue
                node.workers.discard(event.worker_id)
                if not node.workers and not node.children:
                    self._prune(node)

    def _prune(self, node: "_Node") -> None:
        while node is not None and node is not self.root:
            if node.workers or node.children:
                break
            parent = node.parent
            if parent is not None:
                parent.children.pop(node.hash, None)
            self.lookup.pop(node.hash, None)
            node = parent

    def remove_worker(self, worker_id: str) -> None:
        dead = []
        for h, node in self.lookup.items():
            node.workers.discard(worker_id)
            if not node.workers and not node.children:
                dead.append(node)
        for node in dead:
            self._prune(node)

    def clear_expired(self) -> int:
        if self.expiration_s is None:
            return 0
        cutoff = time.monotonic() - self.expiration_s
        dead = [n for n in self.lookup.values() if n.last_update < cutoff and not n.children]
        for n in dead:
            self._prune(n)
        return len(dead)

    def __len__(self) -> int:
        return len(self.lookup)


class _NativeTreeAdapter:
    """``RadixTree``'s surface over the native core's C++ tree: the
    production path (prefix matching runs on every scheduling decision;
    the reference runs it on a dedicated Rust actor thread,
    indexer.rs:499-663)."""

    native = True

    def __init__(self, expiration_s: Optional[float]):
        from ..native import NativeRadixTree

        self._tree = NativeRadixTree(expiration_s)

    def apply_event(self, event: RouterEvent) -> None:
        if event.stored is not None:
            self._tree.apply_stored(event.worker_id, event.stored.parent_hash,
                                    event.stored.block_hashes)
        if event.removed is not None:
            self._tree.apply_removed(event.worker_id, event.removed.block_hashes)

    def find_matches(self, block_hashes: List[int],
                     early_exit: bool = False) -> OverlapScores:
        scores, freqs = self._tree.find_matches(block_hashes, early_exit)
        return OverlapScores(scores=scores, frequencies=freqs)

    def remove_worker(self, worker_id: str) -> None:
        self._tree.remove_worker(worker_id)

    def clear_expired(self) -> int:
        return self._tree.clear_expired()

    def __len__(self) -> int:
        return len(self._tree)


class KvIndexer:
    """Event-consuming index (the actor surface of the reference).

    ``use_native``: True (default) takes the C++ tree, False the plain
    ``RadixTree``."""

    def __init__(
        self,
        block_size: int = 16,
        expiration_s: Optional[float] = None,
        use_native: bool = True,
    ):
        self.block_size = block_size
        self.tree = (_NativeTreeAdapter(expiration_s) if use_native
                     else RadixTree(expiration_s))
        self.events_applied = 0
        self.worker_ids: set = set()  # every worker ever seen in events
        # cold-tier ownership (RouterEvent tier="cold"), kept BESIDE the
        # warm tree (both tree implementations stay tier-blind): hash →
        # workers that can rehydrate the block from their cold tier
        self._cold: Dict[int, Set[str]] = {}

    def apply_event(self, event: RouterEvent) -> None:
        if getattr(event, "tier", "hbm") == "cold":
            self._apply_cold(event)
        else:
            self.tree.apply_event(event)
        self.worker_ids.add(event.worker_id)
        self.events_applied += 1

    def _apply_cold(self, event: RouterEvent) -> None:
        wid = event.worker_id
        if event.stored is not None:
            for h in event.stored.block_hashes:
                self._cold.setdefault(h, set()).add(wid)
        if event.removed is not None:
            for h in event.removed.block_hashes:
                holders = self._cold.get(h)
                if holders is not None:
                    holders.discard(wid)
                    if not holders:
                        del self._cold[h]

    def find_matches(self, block_hashes: List[int]) -> OverlapScores:
        out = self.tree.find_matches(block_hashes)
        if self._cold:
            self._extend_cold(out, block_hashes)
        return out

    def _extend_cold(self, out: OverlapScores,
                     block_hashes: List[int]) -> None:
        """Per-worker cold extension: how many consecutive blocks PAST a
        worker's warm run it can still rehydrate from cold spill files.
        Cold blocks also bridge from position 0 for workers with no warm
        hit at all (the respawned-worker case)."""
        candidates: Set[str] = set(out.scores)
        for h in block_hashes:
            holders = self._cold.get(h)
            if holders:
                candidates.update(holders)
        for w in candidates:
            warm = out.scores.get(w, 0)
            i = warm
            while i < len(block_hashes) and w in self._cold.get(
                    block_hashes[i], ()):
                i += 1
            if i > warm:
                out.cold_scores[w] = i - warm

    def find_matches_for_request(self, token_ids: List[int]) -> OverlapScores:
        from ..tokens import compute_block_hashes

        return self.find_matches(compute_block_hashes(token_ids, self.block_size))

    def remove_worker(self, worker_id: str) -> None:
        self.tree.remove_worker(worker_id)
        self.worker_ids.discard(worker_id)
        for h in list(self._cold):
            holders = self._cold[h]
            holders.discard(worker_id)
            if not holders:
                del self._cold[h]


class ShardedKvIndexer:
    """Workers partitioned across N independent trees (reference:
    indexer.rs KvIndexerSharded). Queries fan out and merge."""

    def __init__(self, num_shards: int, block_size: int = 16):
        self.block_size = block_size
        self.shards = [KvIndexer(block_size) for _ in range(num_shards)]
        self._assignment: Dict[str, int] = {}

    def _shard_for(self, worker_id: str) -> KvIndexer:
        idx = self._assignment.get(worker_id)
        if idx is None:
            # least-loaded assignment
            loads = [len(s.tree) for s in self.shards]
            idx = loads.index(min(loads))
            self._assignment[worker_id] = idx
        return self.shards[idx]

    def apply_event(self, event: RouterEvent) -> None:
        self._shard_for(event.worker_id).apply_event(event)

    def find_matches(self, block_hashes: List[int]) -> OverlapScores:
        out = OverlapScores()
        for shard in self.shards:
            out.merge(shard.find_matches(block_hashes))
        return out

    def remove_worker(self, worker_id: str) -> None:
        idx = self._assignment.pop(worker_id, None)
        if idx is not None:
            self.shards[idx].remove_worker(worker_id)

    @property
    def worker_ids(self) -> set:
        return set(self._assignment)
