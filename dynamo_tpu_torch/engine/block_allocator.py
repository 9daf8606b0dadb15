"""Paged KV block allocator with prefix-cache reuse and LRU eviction.

The port's copy of ``dynamo_tpu/engine/block_allocator.py``, reduced to
what the serving path uses: no host-RAM offload tier, no
pins/fences, no retention priorities and no KV event hooks (later slices).
Semantics follow the reference's block manager (SURVEY.md §2.2,
reference: lib/llm/src/kv/{manager,reuse,reserved}.rs) over the engine's
flat block-id space:

- ``allocate_prompt`` matches the longest cached prefix of complete
  blocks — held by a live sequence (refcount > 0) or pooled (refcount 0,
  state preserved) — then takes fresh blocks, evicting pooled ones.
- Freed blocks with a registered hash stay matchable in the reuse pool
  until evicted, least recently freed first (the reference's
  priority-FIFO pool with every priority at its default).
- Completed blocks (prompt or generated) are registered by sequence hash.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

from ..tokens import compute_block_hashes


class BlockAllocator:
    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = True):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self.free: List[int] = list(range(num_blocks - 1, -1, -1))  # pop() → block 0 first
        # sequence_hash → block id (cached, complete blocks)
        self.by_hash: Dict[int, int] = {}
        self.block_hash: Dict[int, int] = {}   # block id → sequence hash
        self.refcount: Dict[int, int] = {}
        # refcount-0 cached blocks in eviction order (oldest freed first)
        self.reusable: "OrderedDict[int, None]" = OrderedDict()
        self.evictions = 0

    @property
    def available(self) -> int:
        return len(self.free) + len(self.reusable)

    @property
    def used(self) -> int:
        return self.num_blocks - self.available

    def usage(self) -> float:
        return self.used / self.num_blocks if self.num_blocks else 0.0

    def _take_block(self) -> int:
        if self.free:
            return self.free.pop()
        if self.reusable:
            bid, _ = self.reusable.popitem(last=False)
            self.evictions += 1
            h = self.block_hash.pop(bid, None)
            if h is not None:
                self.by_hash.pop(h, None)
            return bid
        raise MemoryError("KV cache exhausted")

    def probe_prefix(self, token_ids: List[int]):
        """One hashing pass: (hashes of every complete block, the cached
        prefix's block ids). Feed it into ``allocate_prompt(probe=...)``
        so callers hash the prompt once."""
        if not self.enable_prefix_caching:
            return [], []
        hashes = compute_block_hashes(token_ids, self.block_size)
        blocks: List[int] = []
        for h in hashes:
            bid = self.by_hash.get(h)
            if bid is None:
                break
            blocks.append(bid)
        return hashes, blocks

    def allocate_prompt(
        self, token_ids: List[int], probe=None
    ) -> Tuple[List[int], int]:
        """Allocate blocks for a prompt, reusing cached prefix blocks.

        ``probe`` may carry a just-computed ``probe_prefix`` result (valid
        only if no allocator mutation happened in between).
        Returns (block_ids covering ceil(len/bs) blocks, num_cached_tokens).
        Raises MemoryError if the demand cannot be met (caller queues).
        """
        n_needed = max(1, -(-len(token_ids) // self.block_size))
        _hashes, cached_blocks = (
            probe if probe is not None else self.probe_prefix(token_ids)
        )
        cached_blocks = list(cached_blocks)
        # always recompute at least one token so the engine has logits to
        # sample from: a full-prompt hit drops its last cached block
        if len(cached_blocks) * self.block_size >= len(token_ids):
            cached_blocks = cached_blocks[:-1]
        n_new = n_needed - len(cached_blocks)
        # matching a pooled block takes it out of the evictable pool, so
        # it does not count as available for the new blocks
        pooled = sum(1 for bid in cached_blocks if bid in self.reusable)
        if n_new > self.available - pooled:
            raise MemoryError(
                f"need {n_new} blocks, {self.available - pooled} available"
            )
        for bid in cached_blocks:
            self.refcount[bid] = self.refcount.get(bid, 0) + 1
            self.reusable.pop(bid, None)  # no longer evictable
        new_blocks = [self.allocate_block() for _ in range(n_new)]
        return cached_blocks + new_blocks, len(cached_blocks) * self.block_size

    def allocate_block(self) -> int:
        """One more block for a growing (decoding) sequence."""
        bid = self._take_block()
        self.refcount[bid] = self.refcount.get(bid, 0) + 1
        return bid

    def register_complete(self, bid: int, sequence_hash: int) -> None:
        """A block is now full with known content — make it matchable."""
        if not self.enable_prefix_caching:
            return
        existing = self.by_hash.get(sequence_hash)
        if existing is not None and existing != bid:
            return  # identical content already cached under another block
        self.by_hash[sequence_hash] = bid
        self.block_hash[bid] = sequence_hash

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
        list."""
        for bid in block_ids:
            rc = self.refcount.get(bid, 0) - 1
            if rc > 0:
                self.refcount[bid] = rc
                continue
            self.refcount.pop(bid, None)
            if bid in self.block_hash and self.enable_prefix_caching:
                self.reusable[bid] = None
            else:
                h = self.block_hash.pop(bid, None)
                if h is not None:
                    self.by_hash.pop(h, None)
                self.free.append(bid)
