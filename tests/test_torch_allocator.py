"""The port's block allocator makes the reference's decisions: the same
operations give the same block ids, cached-token counts and free counts
(prefix reuse, pooled-block matches, LRU eviction under pressure), and
emit the same KV events (stored with their parent, removed on eviction
and release) to a ``KvEventSink``."""

import numpy as np
import pytest

from dynamo_tpu.engine.block_allocator import BlockAllocator as JaxAllocator
from dynamo_tpu.engine.block_allocator import KvEventSink as JaxSink
from dynamo_tpu.tokens import TokenSequence as JaxSequence
from dynamo_tpu_torch.engine.block_allocator import BlockAllocator, KvEventSink
from dynamo_tpu_torch.tokens import TokenSequence


def _both(fn_ref, fn_port):
    """(ref result, port result); a MemoryError must happen on both sides."""
    out = []
    for fn in (fn_ref, fn_port):
        try:
            out.append(fn())
        except MemoryError:
            out.append(MemoryError)
    return out


def _register(alloc, seq_cls, tokens, blocks, bs):
    seq = seq_cls(tokens, block_size=bs)
    for bid, blk in zip(blocks, seq.blocks):
        alloc.register_complete(bid, blk.sequence_hash,
                                blk.parent_sequence_hash)


def _recording_sink(cls, events):
    return cls(on_stored=lambda h, p: events.append(("stored", list(h), p)),
               on_removed=lambda h: events.append(("removed", list(h))))


@pytest.mark.parametrize("prefix_caching", [True, False])
def test_allocator_decisions_match_reference(prefix_caching):
    bs, n_blocks = 4, 12
    rng = np.random.default_rng(0)
    base = [int(t) for t in rng.integers(0, 100, 16)]
    prompts = [base[:10], base[:13] + [7], base, [1, 2, 3], base[:8] + [9] * 9,
               [int(t) for t in rng.integers(0, 100, 20)], base[:12]]
    ref_events, port_events = [], []
    ref = JaxAllocator(n_blocks, bs, prefix_caching,
                       _recording_sink(JaxSink, ref_events))
    port = BlockAllocator(n_blocks, bs, prefix_caching,
                          _recording_sink(KvEventSink, port_events))
    live, cached = [], []
    for i, p in enumerate(prompts):
        want, got = _both(lambda: ref.allocate_prompt(p),
                          lambda: port.allocate_prompt(p))
        assert got == want, i
        if want is not MemoryError:
            cached.append(want[1])
            _register(ref, JaxSequence, p, want[0], bs)
            _register(port, TokenSequence, p, got[0], bs)
            live.append(want[0])
        # free every other allocation: refcount-0 hashed blocks pool up
        if i % 2 == 1 and live:
            blocks = live.pop(0)
            ref.free_blocks(blocks)
            port.free_blocks(blocks)
        assert port.available == ref.available, i
        want, got = _both(ref.allocate_block, port.allocate_block)
        assert got == want, i
    # the sequence exercised prefix hits and eviction (or neither, off)
    assert (max(cached) > 0) == prefix_caching
    assert (port.evictions > 0) == prefix_caching
    # the same KV events in the same order: stored with parents, removed
    # by eviction (a prefix-cached allocator emits none otherwise)
    assert port_events == ref_events
    assert any(e[0] == "removed" for e in port_events) == prefix_caching
    assert any(e[0] == "stored" for e in port_events) == prefix_caching
