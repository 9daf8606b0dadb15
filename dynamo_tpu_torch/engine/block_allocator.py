"""Paged KV block allocator with prefix-cache reuse, retention priorities,
pins and the host-RAM offload tier.

The port's copy of ``dynamo_tpu/engine/block_allocator.py``, without its
flight-recorder events and registry instruments (the port has no flight
recorder yet; the eviction count is the plain ``evictions`` attribute).
Semantics follow the reference's block manager (SURVEY.md §2.2,
reference: lib/llm/src/kv/{manager,reuse,reserved}.rs) over the engine's
flat block-id space:

- ``allocate_prompt`` matches INFLIGHT blocks first (refcount > 0: a live
  sequence holds the same prefix), then REUSABLE pooled blocks (refcount
  0, state preserved), then takes fresh or evicted blocks and restores
  any host-tier extension into them.
- The reuse pool is priority-ordered FIFO: eviction pops the lowest
  priority class first and the oldest returned within a class, so
  important prefixes (system prompts) stay longest. Priorities attach per
  sequence hash through ``set_priority``.
- ``pin_blocks`` / ``unpin_blocks`` (counted) fence a block against
  reclaim while an out-of-band consumer (a restore or a pull scattering
  into it, a pull serve reading it) depends on its contents; freeing a
  pinned block defers the release until the last unpin.
- A block evicted from HBM with a registered hash is queued for the host
  tier (``tier2``) and offloaded in one batched gather by
  ``flush_offload`` before its slot is written.
- Completed blocks are registered by sequence hash and announced through
  the ``events`` sink: stored on registration, removed on eviction or
  release, the reference's sites. The sink's cold pair announces the cold
  tier's residency (``kv/cold_tier.py``: its spills and evictions).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..tokens import compute_block_hashes


@dataclasses.dataclass
class KvEventSink:
    """Engine-side KV event hooks (no-op by default).

    The ``_cold`` pair announces cold-tier residency (``kv/cold_tier.py``
    spills and evictions, wired by the scheduler) so a router can score a
    rehydratable prefix, discounted against a warm hit
    (``kv_router/scheduler.py`` cold_discount)."""

    on_stored: Callable[[List[int], Optional[int]], None] = lambda hashes, parent: None
    on_removed: Callable[[List[int]], None] = lambda hashes: None
    on_stored_cold: Callable[[List[int], Optional[int]], None] = (
        lambda hashes, parent: None
    )
    on_removed_cold: Callable[[List[int]], None] = lambda hashes: None


class _ReusePool:
    """Priority-ordered FIFO of refcount-0 cached blocks.

    Eviction order is (priority asc, return-tick asc): the lowest priority
    class drains first, oldest first within a class (the reference's
    PriorityKey ordering, kv/reuse.rs:246-270). A lazy-deletion heap;
    membership is the dict."""

    def __init__(self) -> None:
        self._entry: Dict[int, Tuple[int, int]] = {}  # bid → (prio, tick)
        self._heap: List[Tuple[int, int, int]] = []   # (prio, tick, bid)
        self._tick = itertools.count()

    def add(self, bid: int, priority: int = 0) -> None:
        tick = next(self._tick)
        self._entry[bid] = (priority, tick)
        heapq.heappush(self._heap, (priority, tick, bid))

    def discard(self, bid: int) -> None:
        self._entry.pop(bid, None)  # heap entry invalidated lazily

    def reprioritize(self, bid: int, priority: int) -> None:
        if bid in self._entry:
            # takes its FIFO place within the NEW class (a new tick)
            self.add(bid, priority)

    def pop(self, skip: Optional[Set[int]] = None) -> Optional[int]:
        """Evict the (priority, FIFO)-first block, skipping ``skip``."""
        deferred: List[Tuple[int, int, int]] = []
        out: Optional[int] = None
        while self._heap:
            prio, tick, bid = heapq.heappop(self._heap)
            if self._entry.get(bid) != (prio, tick):
                continue  # stale entry (discarded or reprioritized)
            if skip and bid in skip:
                deferred.append((prio, tick, bid))
                continue
            del self._entry[bid]
            out = bid
            break
        for item in deferred:  # pinned blocks keep their order
            heapq.heappush(self._heap, item)
        return out

    def __contains__(self, bid: int) -> bool:
        return bid in self._entry

    def __len__(self) -> int:
        return len(self._entry)


class BlockAllocator:
    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = True,
                 events: Optional[KvEventSink] = None,
                 tier2=None):  # Optional[kv.KvHostTier]
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self.events = events or KvEventSink()
        self.tier2 = tier2
        # evictions collected during one allocation, offloaded in one
        # batched gather by flush_offload
        self._pending_offload: List[Tuple[int, int]] = []
        self.free: List[int] = list(range(num_blocks - 1, -1, -1))  # pop() → block 0 first
        # sequence_hash → block id (cached, complete blocks)
        self.by_hash: Dict[int, int] = {}
        self.block_hash: Dict[int, int] = {}   # block id → sequence hash
        self.refcount: Dict[int, int] = {}
        # refcount-0 cached blocks in priority-FIFO order: evictable
        self.reusable = _ReusePool()
        # sequence_hash → retention priority (0 by default; higher = kept
        # longer)
        self.hash_priority: Dict[int, int] = {}
        # fenced blocks, COUNTED: two consumers can fence one block (two
        # pulls serving it); the fence holds until the last unpin
        self.pinned: Dict[int, int] = {}
        self._deferred_free: List[int] = []
        self.evictions = 0
        # match staging counters (the reference's two match stages)
        self.matched_inflight_total = 0
        self.matched_reusable_total = 0

    # ---------- accounting ----------

    @property
    def available(self) -> int:
        pinned_reusable = sum(1 for b in self.pinned if b in self.reusable)
        return len(self.free) + len(self.reusable) - pinned_reusable

    @property
    def used(self) -> int:
        return self.num_blocks - self.available

    def usage(self) -> float:
        return self.used / self.num_blocks if self.num_blocks else 0.0

    # ---------- priorities / fences ----------

    def set_priority(self, sequence_hashes: List[int], priority: int) -> None:
        """Retention priority for blocks by content hash (reference:
        kv/reuse.rs UpdateBlock): applies to blocks already pooled and to
        any later pooling of these hashes; priority 0 evicts first."""
        for h in sequence_hashes:
            if priority == 0:
                self.hash_priority.pop(h, None)
            else:
                self.hash_priority[h] = priority
            bid = self.by_hash.get(h)
            if bid is not None and bid in self.reusable:
                self.reusable.reprioritize(bid, priority)

    def pin_blocks(self, block_ids: List[int]) -> None:
        """Fence blocks against reclaim: a pinned block is never evicted
        from the reuse pool, and a free of it defers until the LAST
        unpin."""
        for bid in block_ids:
            self.pinned[bid] = self.pinned.get(bid, 0) + 1

    def unpin_blocks(self, block_ids: List[int]) -> None:
        for bid in block_ids:
            n = self.pinned.get(bid, 0) - 1
            if n > 0:
                self.pinned[bid] = n
            else:
                self.pinned.pop(bid, None)
        if self._deferred_free:
            # a block re-acquired while pinned (a prefix match ref'd it)
            # cancels its pending free: releasing it now would make a LIVE
            # block evictable
            self._deferred_free = [
                b for b in self._deferred_free if self.refcount.get(b, 0) == 0
            ]
            ready = [b for b in self._deferred_free if b not in self.pinned]
            self._deferred_free = [
                b for b in self._deferred_free if b in self.pinned
            ]
            if ready:
                self._release(ready)

    def fence(self) -> None:
        """Synchronization point (reference kv/reuse.rs fence): every
        offload queued or staged so far is committed to the host tier."""
        self.flush_offload()
        if self.tier2 is not None:
            self.tier2.drain()

    # ---------- core ops ----------

    def _take_block(self) -> int:
        if self.free:
            return self.free.pop()
        bid = self.reusable.pop(skip=self.pinned)
        if bid is not None:
            self.evictions += 1
            h = self.block_hash.pop(bid, None)
            if h is not None:
                self.by_hash.pop(h, None)
                if self.tier2 is not None:
                    # the KV is still intact in the slot: queue it for the
                    # host tier, flushed (batched) before the slot is written
                    self._pending_offload.append((h, bid))
                self.events.on_removed([h])
            return bid
        raise MemoryError("KV cache exhausted")

    def flush_offload(self) -> None:
        """Offload every queued eviction in one batched device gather.
        Runs before the evicted slots are written; a caller that allocates
        with ``flush=False`` owns that ordering."""
        if self._pending_offload:
            pending, self._pending_offload = self._pending_offload, []
            self.tier2.offload_batch(pending)

    def match_prefix(self, token_ids: List[int]) -> Tuple[List[int], List[int]]:
        """Longest HBM-cached prefix of complete blocks: (block ids, their
        sequence hashes)."""
        hashes, blocks, _host = self.probe_prefix(token_ids)
        return blocks, hashes[: len(blocks)]

    def probe_prefix(self, token_ids: List[int]):
        """One hashing pass over both tiers: (hashes of every complete
        block, the HBM-resident prefix's block ids, the host-tier run
        extending it). Feed it into ``allocate_prompt(probe=...)`` so
        callers hash the prompt once; ``cached_tokens(probe)`` is the
        restorable token count."""
        if not self.enable_prefix_caching:
            return [], [], []
        hashes = compute_block_hashes(token_ids, self.block_size)
        blocks: List[int] = []
        for h in hashes:
            bid = self.by_hash.get(h)
            if bid is None:
                break
            blocks.append(bid)
        host_hashes: List[int] = []
        if self.tier2 is not None:
            host_hashes = self.tier2.match_extension(hashes, len(blocks))
        return hashes, blocks, host_hashes

    def cached_tokens(self, probe) -> int:
        _hashes, blocks, host_hashes = probe
        return (len(blocks) + len(host_hashes)) * self.block_size

    def allocate_prompt(
        self, token_ids: List[int], probe=None
    ) -> Tuple[List[int], int]:
        """Allocate blocks for a prompt; reuse cached prefix blocks from HBM
        and restore host-tier blocks into fresh slots.

        ``probe`` may carry a just-computed ``probe_prefix`` result (valid
        only if no allocator mutation happened in between).
        Returns (block_ids covering ceil(len/bs) blocks, num_cached_tokens).
        Raises MemoryError if the demand cannot be met (caller queues).
        """
        n_needed = max(1, -(-len(token_ids) // self.block_size))
        hashes, cached_blocks, host_hashes = (
            probe if probe is not None else self.probe_prefix(token_ids)
        )
        cached_blocks = list(cached_blocks)
        host_hashes = list(host_hashes)
        # always recompute at least one token so the engine has logits to
        # sample from: a full-prompt hit drops its last cached block
        if (len(cached_blocks) + len(host_hashes)) * self.block_size >= len(token_ids):
            if host_hashes:
                host_hashes.pop()
            else:
                cached_blocks = cached_blocks[:-1]
        n_new = n_needed - len(cached_blocks)
        # matching a pooled block takes it out of the evictable pool, so
        # it does not count as available for the new blocks
        pooled = sum(
            1 for bid in cached_blocks
            if bid in self.reusable and bid not in self.pinned
        )
        if n_new > self.available - pooled:
            raise MemoryError(
                f"need {n_new} blocks, {self.available - pooled} available"
            )
        self.matched_inflight_total += sum(
            1 for bid in cached_blocks if self.refcount.get(bid, 0) > 0
        )
        self.matched_reusable_total += sum(
            1 for bid in cached_blocks if self.refcount.get(bid, 0) == 0
        )
        for bid in cached_blocks:
            self._ref(bid)
        new_blocks = [self._take_block() for _ in range(n_new)]
        for bid in new_blocks:
            self.refcount[bid] = self.refcount.get(bid, 0) + 1
        # offload the evicted blocks (one batched gather) BEFORE a restore
        # writes into any of those same slots
        self.flush_offload()

        if host_hashes:
            # commit the staged offloads first: drain applies the capacity
            # eviction, and the keep-check below must see the drained store
            self.tier2.drain()
            # taking blocks above may have evicted host-tier entries
            # (capacity pressure): keep only the still-resident prefix run
            keep = 0
            while keep < len(host_hashes) and self.tier2.has(host_hashes[keep]):
                keep += 1
            host_hashes = host_hashes[:keep]
        if host_hashes:
            restore_bids = new_blocks[: len(host_hashes)]
            # fence the restore targets while the restore dispatches:
            # nothing may reclaim a slot with a copy in flight
            self.pin_blocks(restore_bids)
            try:
                self.tier2.restore(host_hashes, restore_bids)
            finally:
                self.unpin_blocks(restore_bids)
            for i, h in enumerate(host_hashes):
                idx = len(cached_blocks) + i
                parent = hashes[idx - 1] if idx > 0 else None
                self.register_complete(restore_bids[i], h, parent)

        num_cached = (len(cached_blocks) + len(host_hashes)) * self.block_size
        return cached_blocks + new_blocks, num_cached

    def allocate_n(self, n: int) -> List[int]:
        """``n`` anonymous blocks, all or nothing (a migration's admit: a
        partial reservation would strand a half-scattered transfer). On
        MemoryError everything taken so far is released first."""
        got: List[int] = []
        try:
            for _ in range(n):
                got.append(self.allocate_block(flush=False))
        except MemoryError:
            self.free_blocks(got)
            raise
        self.flush_offload()
        return got

    def allocate_block(self, flush: bool = True) -> int:
        """One more block for a growing (decoding) sequence.

        ``flush=False`` defers the host-offload gather so a caller growing
        many sequences at once pays one batched gather; it must call
        ``flush_offload()`` before the evicted slots are written."""
        bid = self._take_block()
        if flush:
            self.flush_offload()
        self.refcount[bid] = self.refcount.get(bid, 0) + 1
        return bid

    def _ref(self, bid: int) -> None:
        self.refcount[bid] = self.refcount.get(bid, 0) + 1
        self.reusable.discard(bid)  # no longer evictable

    def register_complete(self, bid: int, sequence_hash: int,
                          parent_hash: Optional[int]) -> None:
        """A block is now full with known content — make it matchable."""
        if not self.enable_prefix_caching:
            return
        existing = self.by_hash.get(sequence_hash)
        if existing is not None and existing != bid:
            return  # identical content already cached under another block
        self.by_hash[sequence_hash] = bid
        self.block_hash[bid] = sequence_hash
        self.events.on_stored([sequence_hash], parent_hash)

    def rollback_tail(self, block_ids: List[int], keep: int) -> List[int]:
        """Release the over-allocated tail of a sequence's block list.

        The dispatch-ahead decode loop reserves block headroom before
        every dispatch; a finish detected one burst late leaves the row
        holding blocks whose only contents are over-decoded positions the
        host never committed. Those tail blocks are anonymous
        (registration only ever covers positions below the host
        ``context_len``), so releasing them returns them straight to the
        free list. Returns the retained prefix."""
        keep = max(0, keep)
        tail = block_ids[keep:]
        if tail:
            self.free_blocks(tail)
        return block_ids[:keep]

    def free_blocks(self, block_ids: List[int]) -> None:
        """Release a sequence's references. Hashed blocks become reusable
        (still matchable until evicted); anonymous blocks go to the free
        list. Pinned blocks defer until ``unpin_blocks``."""
        ready: List[int] = []
        for bid in block_ids:
            rc = self.refcount.get(bid, 0) - 1
            if rc > 0:
                self.refcount[bid] = rc
                continue
            self.refcount.pop(bid, None)
            if bid in self.pinned:
                if bid not in self._deferred_free:  # re-freed after a re-ref
                    self._deferred_free.append(bid)
                continue
            ready.append(bid)
        self._release(ready)

    def _release(self, block_ids: List[int]) -> None:
        removed_hashes: List[int] = []
        for bid in block_ids:
            h = self.block_hash.get(bid)
            if h is not None and self.enable_prefix_caching:
                self.reusable.add(bid, self.hash_priority.get(h, 0))
            else:
                h = self.block_hash.pop(bid, None)
                if h is not None:
                    self.by_hash.pop(h, None)
                    removed_hashes.append(h)
                self.free.append(bid)
        if removed_hashes:
            self.events.on_removed(removed_hashes)
