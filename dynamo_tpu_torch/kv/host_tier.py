"""Host-memory KV tier: offload evicted HBM blocks, restore on a prefix hit.

The port's copy of ``dynamo_tpu/kv/host_tier.py``, the analog of the
reference Dynamo's multi-tier block manager (lib/llm/src/kv/storage.rs
Device / Pinned slabs, kv/reuse.rs, the block_copy.cu gather and scatter).

A block is offloaded *at HBM eviction time*: when the allocator pops a
reusable block to hand its slot to new data, the block's KV is still
intact, so it is read out to host RAM first, keyed by its chained sequence
hash. A later prompt whose prefix extends past the HBM-cached blocks gets
its host-resident blocks restored into fresh slots instead of recomputed.

Offload is staged, never synchronous: ``offload_batch`` only *dispatches*
the runner's device gather (``ModelRunner.gather_blocks_device``: it runs
on the runner's stream before any later write to those slots), its
transpose to block-major order on the device (each block's bytes then
land contiguous on the host), and the copy of the frame into pinned
memory (``ModelRunner.stage_blocks_to_host``: a ``HostCopy`` with its own
event).
``drain`` (run by the scheduler once the next step is dispatched, and
forced by ``restore`` and the allocator's ``fence``) waits on those copies'
events, never on the device, then files the blocks into the host store and
applies the LRU capacity, calling ``on_evict`` (the cold tier's spill) for
each block that leaves. A staged block is matchable the whole time.

The store is one slab per cache of the pair (Llama's K and V, MLA's
``c_kv`` and ``k_rope``, whose last dims differ), ``capacity_blocks``
slots each, allocated once at construction, pinned on a card (so a
restore's host-to-device copy is asynchronous and no block pays a
page-locked allocation of its own), with an LRU over the slots. An e4m3
cache travels as its bytes, so a restored block is byte-equal to the one
offloaded.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..ops.attention import _bytes
from ..ops.transfer import to_device

logger = logging.getLogger(__name__)


class KvHostTier:
    """Store of KV blocks in host RAM, keyed by sequence hash, with
    asynchronous device-to-host staging."""

    def __init__(
        self,
        runner,
        capacity_blocks: int,
        on_evict: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None,
    ):
        # the runner's block ops: gather_blocks_device, stage_blocks_to_host,
        # scatter_blocks, and its cache pair (the slabs' layout)
        self.runner = runner
        self.capacity_blocks = capacity_blocks
        # capacity-eviction hook (the cold tier's spill entry,
        # ``KvColdTier.offer``): called with (sequence_hash, k, v), each
        # ``[L, 1, bs, ...]`` in the cache's dtype, the moment a block
        # leaves host RAM (the last chance to keep it rehydratable)
        self.on_evict = on_evict
        self._pinned = runner.device.type == "cuda"
        self.slabs = tuple(
            torch.empty((capacity_blocks, c.shape[0], *c.shape[2:]),
                        dtype=c.dtype, pin_memory=self._pinned)
            for c in runner.kv_cache)
        self._free_slots: List[int] = list(range(capacity_blocks - 1, -1, -1))
        # sequence_hash → slot, in LRU order (front = least recent)
        self.store: "OrderedDict[int, int]" = OrderedDict()
        # dispatched, not yet filed: (hashes, HostCopy of the gathered frame)
        self._staged: List[Tuple[List[int], object]] = []
        self._staged_hashes: set = set()
        self.offloaded_total = 0
        self.restored_total = 0
        self.evicted_total = 0

    def __len__(self) -> int:
        return len(self.store) + len(self._staged_hashes)

    def has(self, sequence_hash: int) -> bool:
        return sequence_hash in self.store or sequence_hash in self._staged_hashes

    def offload_batch(self, pairs: Sequence[Tuple[int, int]]) -> None:
        """Offload many evicted blocks with ONE device gather. Only
        dispatches: the gather and the copy into pinned memory are queued
        on the runner's stream behind an event; ``drain`` files them."""
        fresh = []
        for h, bid in pairs:
            if h in self.store:
                self.store.move_to_end(h)
            elif h not in self._staged_hashes:
                fresh.append((h, bid))
        if not fresh:
            return
        k, v = self.runner.gather_blocks_device([bid for _h, bid in fresh])
        # [L, n, ...] → [n, L, ...] on the device: a block is one
        # contiguous run of the host frame, copied into its slot in one go
        copy = self.runner.stage_blocks_to_host(
            _bytes(k).transpose(0, 1).contiguous(),
            _bytes(v).transpose(0, 1).contiguous())
        hashes = [h for h, _bid in fresh]
        self._staged.append((hashes, copy))
        self._staged_hashes.update(hashes)
        self.offloaded_total += len(fresh)

    def _slot_for_new(self, frames, pending) -> int:
        """A slot for one more stored block: a free one, else the LRU
        block's, which leaves through ``on_evict`` first (with copies of
        its bytes: from the frame, if it was filed in this batch and not
        copied yet). Filing and evicting one block at a time evicts exactly
        the blocks (and in the order) the reference's file-all-then-trim
        drain does."""
        if self._free_slots:
            return self._free_slots.pop()
        h, slot = self.store.popitem(last=False)
        self.evicted_total += 1
        i = pending.pop(slot, None)
        if self.on_evict is not None:
            if i is None:
                k, v = self.read_slot(slot)
            else:
                k, v = (f[i].unsqueeze(1).clone().view(s.dtype)
                        for f, s in zip(frames, self.slabs))
            self.on_evict(h, k, v)
        return slot

    def drain(self) -> None:
        """File every staged offload into the host store (waits only on
        the copies' own events) and apply the capacity. The bytes move in
        runs of consecutive slots (a batch's blocks mostly take
        consecutive ones): a few large copies, not one per block."""
        if not self._staged:
            return
        staged, self._staged = self._staged, []
        self._staged_hashes.clear()
        for hashes, copy in staged:
            frames = copy.tensors()  # [n, L, ...] each, the caches' bytes
            pending = {}  # slot → frame row, filed but not yet copied
            for i, h in enumerate(hashes):
                if h in self.store:
                    self.store.move_to_end(h)
                    continue
                slot = self._slot_for_new(frames, pending)
                pending[slot] = i
                self.store[h] = slot
            for slab, frame in zip(self.slabs, frames):
                dst = _bytes(slab)
                for d, s, n in _runs(sorted(pending.items())):
                    dst[d:d + n].copy_(frame[s:s + n])

    def read_slot(self, slot: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copies of one slot's blocks, ``[L, 1, bs, ...]`` each."""
        return tuple(_bytes(s)[slot].unsqueeze(1).clone().view(s.dtype)
                     for s in self.slabs)

    def read(self, sequence_hash: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Copies of a stored (drained) block, or None."""
        slot = self.store.get(sequence_hash)
        return None if slot is None else self.read_slot(slot)

    def restore(self, hashes: Sequence[int], block_ids: Sequence[int]) -> None:
        """Write host-resident blocks back into freshly allocated HBM
        slots: the slots are gathered into one pinned frame per cache,
        copied to the card without blocking, and scattered there."""
        assert len(hashes) == len(block_ids)
        if not hashes:
            return
        if any(h in self._staged_hashes for h in hashes):
            self.drain()
        runs = _runs(enumerate(self.store[h] for h in hashes))
        frames = []
        for slab in self.slabs:
            src = _bytes(slab)
            buf = torch.empty((len(hashes), *src.shape[1:]), dtype=src.dtype,
                              pin_memory=self._pinned)
            for d, s, n in runs:
                buf[d:d + n].copy_(src[s:s + n])
            dev = to_device(buf, self.runner.device)
            frames.append(dev.transpose(0, 1).view(slab.dtype))  # [L, n, ...]
        self.runner.scatter_blocks(list(block_ids), *frames)
        for h in hashes:
            self.store.move_to_end(h)
        self.restored_total += len(hashes)

    def match_extension(self, hashes: Sequence[int], start: int) -> List[int]:
        """Longest host-resident (stored or staged) run of ``hashes``
        starting at index ``start``."""
        out: List[int] = []
        for h in hashes[start:]:
            if not self.has(h):
                break
            out.append(h)
        return out

    def metrics(self) -> dict:
        return {
            "host_kv_blocks": len(self),
            "host_kv_staged": len(self._staged_hashes),
            "host_kv_capacity": self.capacity_blocks,
            "host_kv_offloaded_total": self.offloaded_total,
            "host_kv_restored_total": self.restored_total,
            "host_kv_evicted_total": self.evicted_total,
        }


def _runs(pairs):
    """(dst, src) index pairs as runs ``(dst0, src0, n)`` along which both
    advance by one, in the pairs' order."""
    runs: List[List[int]] = []
    for d, s in pairs:
        if runs and runs[-1][0] + runs[-1][2] == d and runs[-1][1] + runs[-1][2] == s:
            runs[-1][2] += 1
        else:
            runs.append([d, s, 1])
    return runs
