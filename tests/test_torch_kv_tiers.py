"""The port's KV tiers against the reference's: the block manager (retention
priorities, counted pins and the deferred free, fences, staged-block hits,
thrash), the host tier (a pinned slab on a card) and the cold tier's file
format, and whole engines that restore from the host tier and rehydrate
from the cold tier after a respawn.

Each allocator case drives the reference's ``BlockAllocator`` (its host
tier over an in-memory store) and the port's (its host tier over a runner
stand-in) with one op sequence and compares what each returns and emits:
block ids, cached-token counts, KV events, pins, refcounts, the free list
and the restored block contents. The engine cases hold restored and
rehydrated blocks to the bytes first written, the port's blocks to the
JAX engine's recompute (f32, atol 1e-5, as ``test_torch_disagg.py``'s
block differential) and the streams to the JAX engine's."""

import asyncio
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.block_allocator import BlockAllocator as RefAllocator
from dynamo_tpu.engine.block_allocator import KvEventSink as RefSink
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.kv import KvColdTier as RefCold
from dynamo_tpu.kv import KvHostTier as RefHost
from dynamo_tpu.models import deepseek as jax_deepseek
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.tokens import compute_block_hashes
from dynamo_tpu_torch.engine.block_allocator import BlockAllocator, KvEventSink
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import HostCopy, ModelRunner
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.kv import KvColdTier, KvHostTier
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import host_xxh64
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tokens import xxh64_intdigest

BS = 4  # the allocator cases' block size
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=512, rms_norm_eps=1e-5)
# V2-Lite's shape at 3 layers and narrow widths (test_torch_mla.py's):
# yarn rope, a dense first layer, routed MoE with a shared expert
DEEPSEEK = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
                num_layers=3, num_heads=4, num_kv_heads=4, head_dim=16,
                kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=12,
                v_head_dim=12, num_experts=4, num_experts_per_tok=2,
                moe_intermediate_size=32, n_shared_experts=1,
                first_k_dense_replace=1, norm_topk_prob=False,
                routed_scaling_factor=1.5, max_position_embeddings=256,
                rope_scaling={"type": "yarn", "factor": 4.0,
                              "original_max_position_embeddings": 64,
                              "beta_fast": 32, "beta_slow": 1, "mscale": 1.0,
                              "mscale_all_dim": 0.707})
TIMEOUT_S = 180


def _run(coro, timeout=TIMEOUT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# ------------------------------------------------------------ the allocator


class _RefStore:
    """The reference tests' in-memory stand-in for its runner's gather and
    scatter (one [4] f32 row a block, under a fake layer dim)."""

    def __init__(self, n):
        self.data = {i: np.zeros(4, np.float32) for i in range(n)}

    def write(self, bid, value):
        self.data[bid] = value

    def read(self, bid):
        return np.asarray(self.data[bid])

    def gather(self, ids):
        k = np.stack([self.data[i] for i in ids])[None]
        return k, k.copy()

    def scatter(self, ids, k, v):
        for j, bid in enumerate(ids):
            self.data[bid] = np.asarray(k[0, j])


class _PortRunner:
    """The port's runner surface the host tier uses (its block ops and
    its cache pair), over a [1, n, 4] f32 cache pair on the CPU."""

    device = torch.device("cpu")

    def __init__(self, n):
        self.kv_cache = (torch.zeros(1, n, 4), torch.zeros(1, n, 4))

    def write(self, bid, value):
        for c in self.kv_cache:
            c[0, bid] = torch.from_numpy(np.asarray(value, np.float32))

    def read(self, bid):
        return self.kv_cache[0][0, bid].numpy().copy()

    def gather_blocks_device(self, ids):
        idx = torch.tensor(list(ids))
        return tuple(c.index_select(1, idx) for c in self.kv_cache)

    def stage_blocks_to_host(self, k, v):
        return HostCopy((k, v))

    def scatter_blocks(self, ids, k, v):
        idx = torch.tensor(list(ids))
        for c, b in zip(self.kv_cache, (k, v)):
            c.index_copy_(1, idx, b)


def _side(pkg, n_blocks, host_cap=0):
    """One package's allocator (and host tier over its store), with its
    KV events recorded."""
    events = []
    stored = lambda h, p: events.append(("stored", list(h), p))  # noqa: E731
    removed = lambda h: events.append(("removed", list(h)))  # noqa: E731
    if pkg == "ref":
        store = _RefStore(n_blocks)
        tier = (RefHost(store.gather, store.scatter, host_cap)
                if host_cap else None)
        alloc = RefAllocator(n_blocks, BS, True,
                             RefSink(on_stored=stored, on_removed=removed),
                             tier2=tier)
    else:
        store = _PortRunner(n_blocks)
        tier = KvHostTier(store, host_cap) if host_cap else None
        alloc = BlockAllocator(n_blocks, BS, True,
                               KvEventSink(on_stored=stored, on_removed=removed),
                               tier2=tier)
    return types.SimpleNamespace(alloc=alloc, store=store, tier=tier,
                                 events=events)


def _state(s):
    a = s.alloc
    out = dict(available=a.available, free=list(a.free),
               refcount={b: n for b, n in a.refcount.items() if n},
               pinned=dict(a.pinned), by_hash=dict(a.by_hash),
               events=list(s.events),
               inflight=a.matched_inflight_total,
               reusable=a.matched_reusable_total)
    if s.tier is not None:
        out["tier"] = s.tier.metrics()
    return out


def _fill_and_free(s, prompt, write=True):
    """Allocate a prompt, write and register its complete blocks, free it."""
    blocks, cached = s.alloc.allocate_prompt(prompt)
    hashes = compute_block_hashes(prompt, BS)
    parent = None
    for bid, h in zip(blocks[: len(prompt) // BS], hashes):
        if write:
            s.store.write(bid, np.full(4, h % 251, np.float32))
        s.alloc.register_complete(bid, h, parent)
        parent = h
    s.alloc.free_blocks(blocks)
    return blocks, cached, hashes


def _try(fn):
    try:
        return fn()
    except MemoryError:
        return "MemoryError"


def _case_priority(s, log):
    prompts = [list(range(a, a + 8)) for a in (10, 100, 200)]
    hashes = [_fill_and_free(s, p)[2] for p in prompts]
    s.alloc.set_priority(hashes[1], 5)
    for _ in range(6):
        log.append(s.alloc.allocate_block())
    log.append(_state(s))


def _case_rekey(s, log):
    h_a = _fill_and_free(s, list(range(8)))[2]
    _fill_and_free(s, list(range(50, 58)))
    s.alloc.set_priority(h_a, 3)
    s.alloc.set_priority(h_a[:1], 0)  # back to the default class
    for _ in range(4):
        log.append(s.alloc.allocate_block())
    log.append(_state(s))


def _case_storm(s, log):
    prefix = list(range(1, 17))
    seqs = []
    blocks0, cached0 = s.alloc.allocate_prompt(prefix + [77])
    hashes = compute_block_hashes(prefix, BS)
    parent = None
    for bid, h in zip(blocks0[:4], hashes):
        s.alloc.register_complete(bid, h, parent)
        parent = h
    seqs.append(blocks0)
    for i in range(8):
        seqs.append(s.alloc.allocate_prompt(prefix + [100 + i]))
        log.append(seqs[-1])
        seqs[-1] = seqs[-1][0]
    log.append(_state(s))
    for blocks in seqs:
        s.alloc.free_blocks(blocks)
    log.append(s.alloc.allocate_prompt(prefix + [500]))
    log.append(_state(s))


def _case_churn(s, log):
    rng = np.random.default_rng(7)
    live = {}
    for step in range(150):
        if live and (len(live) > 5 or rng.random() < 0.45):
            name = list(live)[int(rng.integers(len(live)))]
            s.alloc.free_blocks(live.pop(name))
        else:
            start = int(rng.integers(0, 8)) * BS
            prompt = list(range(start, start + int(rng.integers(5, 20))))
            got = _try(lambda: s.alloc.allocate_prompt(prompt))
            log.append(got)
            if got == "MemoryError":
                continue
            parent = None
            for bid, h in zip(got[0][: len(prompt) // BS],
                              compute_block_hashes(prompt, BS)):
                s.alloc.register_complete(bid, h, parent)
                parent = h
            live[f"s{step}"] = got[0]
        log.append((s.alloc.available, len(s.events)))
    log.append(_state(s))


def _case_pins(s, log):
    h = _fill_and_free(s, list(range(8)))[2]
    bid = s.alloc.by_hash[h[0]]
    s.alloc.pin_blocks([bid])
    log.append([s.alloc.allocate_block() for _ in range(3)])
    log.append(_try(s.alloc.allocate_block))
    s.alloc.unpin_blocks([bid])
    log.append(s.alloc.allocate_block())
    log.append(_state(s))


def _case_deferred_free(s, log):
    blocks, _ = s.alloc.allocate_prompt(list(range(6)))
    s.alloc.pin_blocks(blocks[:1])
    s.alloc.free_blocks(blocks)
    log.append(_state(s))
    s.alloc.unpin_blocks(blocks[:1])
    log.append(_state(s))


def _case_counted_pins(s, log):
    h = _fill_and_free(s, list(range(8)))[2]
    bid = s.alloc.by_hash[h[0]]
    s.alloc.pin_blocks([bid])
    s.alloc.pin_blocks([bid])
    s.alloc.unpin_blocks([bid])
    log.append([s.alloc.allocate_block() for _ in range(3)])
    log.append(_state(s))
    s.alloc.unpin_blocks([bid])
    log.append(s.alloc.allocate_block())
    log.append(_state(s))


def _case_reacquire(s, log):
    prompt = list(range(1, 9))
    _fill_and_free(s, prompt)
    blocks2, _ = s.alloc.allocate_prompt(prompt + [99])
    s.alloc.pin_blocks(blocks2[:1])
    s.alloc.free_blocks(blocks2)
    blocks3, _ = s.alloc.allocate_prompt(prompt + [77])
    log.append(blocks3)
    s.alloc.unpin_blocks(blocks2[:1])
    log.append(_state(s))
    s.alloc.free_blocks(blocks3)
    log.append(_state(s))


def _case_allocate_n(s, log):
    _fill_and_free(s, list(range(12)))
    log.append(s.alloc.allocate_n(3))
    log.append(_try(lambda: s.alloc.allocate_n(9)))
    log.append(_state(s))


def _restored(s, blocks, cached):
    return [s.store.read(b).tolist() for b in blocks[: cached // BS]]


def _case_offload_restore(s, log):
    # 13 tokens over 4 blocks: 3 complete blocks offload on eviction and
    # restore into the new slots of the repeat
    a = list(range(1, 14))
    _fill_and_free(s, a)
    blocks_b, _ = s.alloc.allocate_prompt(list(range(100, 113)))
    log.append((blocks_b, _state(s)))
    s.alloc.free_blocks(blocks_b)
    probe = s.alloc.probe_prefix(a)
    log.append(s.alloc.cached_tokens(probe))
    blocks, cached = s.alloc.allocate_prompt(a, probe=probe)
    log.append((blocks, cached, _restored(s, blocks, cached), _state(s)))


def _case_fenced_restore(s, log):
    seen = []
    orig = s.tier.restore

    def spying_restore(hashes, bids):
        seen.append(all(b in s.alloc.pinned for b in bids))
        orig(hashes, bids)

    s.tier.restore = spying_restore
    _fill_and_free(s, list(range(1, 13)))
    blocks_b, _ = s.alloc.allocate_prompt(list(range(100, 100 + 8 * BS)))
    s.alloc.free_blocks(blocks_b)
    blocks, cached = s.alloc.allocate_prompt(list(range(1, 13)))
    log.append((blocks, cached, seen, _restored(s, blocks, cached), _state(s)))


def _case_staged_hit(s, log):
    prompt = list(range(1, 13))
    _fill_and_free(s, prompt)
    blocks_b, _ = s.alloc.allocate_prompt(list(range(100, 100 + 8 * BS)))
    s.alloc.free_blocks(blocks_b)
    log.append(s.tier.metrics())  # staged, not yet drained
    blocks, cached = s.alloc.allocate_prompt(prompt)
    log.append((blocks, cached, _restored(s, blocks, cached), _state(s)))


def _case_fence(s, log):
    _fill_and_free(s, list(range(1, 13)))
    blocks_b, _ = s.alloc.allocate_prompt(list(range(100, 100 + 8 * BS)))
    s.alloc.free_blocks(blocks_b)
    log.append(s.tier.metrics())
    s.alloc.fence()
    log.append(_state(s))


def _case_thrash(s, log):
    prompts = {n: list(range(1 + 40 * n, 13 + 40 * n)) for n in range(4)}
    rng = np.random.default_rng(3)
    for step in range(120):
        n = int(rng.integers(0, 4))
        prompt = prompts[n]
        blocks, cached = s.alloc.allocate_prompt(prompt)
        log.append((blocks, cached, _restored(s, blocks, cached)))
        hashes = compute_block_hashes(prompt, BS)
        parent = None
        for bid, h in zip(blocks[:3], hashes):
            s.store.write(bid, np.full(4, h % 251, np.float32))
            s.alloc.register_complete(bid, h, parent)
            parent = h
        s.alloc.free_blocks(blocks)
        if step % 7 == 0:
            s.alloc.fence()
    log.append(_state(s))


ALLOCATOR_CASES = {
    # name: (case, blocks, host tier capacity)
    "priority_order": (_case_priority, 6, 0),
    "priority_rekey": (_case_rekey, 4, 0),
    "inflight_storm": (_case_storm, 32, 0),
    "churn": (_case_churn, 16, 0),
    "pinned_survives": (_case_pins, 4, 0),
    "deferred_free": (_case_deferred_free, 4, 0),
    "counted_pins": (_case_counted_pins, 4, 0),
    "reacquired_while_pinned": (_case_reacquire, 8, 0),
    "allocate_n": (_case_allocate_n, 6, 0),
    "offload_restore": (_case_offload_restore, 4, 8),
    "fenced_restore": (_case_fenced_restore, 8, 16),
    "staged_hit": (_case_staged_hit, 8, 16),
    "fence": (_case_fence, 8, 16),
    "thrash": (_case_thrash, 8, 4),
}


@pytest.mark.parametrize("name", list(ALLOCATOR_CASES))
def test_allocator_matches_the_reference(name):
    case, n_blocks, host_cap = ALLOCATOR_CASES[name]
    logs = {}
    for pkg in ("ref", "port"):
        s = _side(pkg, n_blocks, host_cap)
        logs[pkg] = []
        case(s, logs[pkg])
    assert logs["port"] == logs["ref"]
    assert logs["port"]  # the case observed something


# --------------------------------------------------------- the host tier


def _cfg(model=TINY, **kw):
    base = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
                num_kv_blocks=64, dtype="float32")
    return EngineConfig(model=ModelConfig(**model), **dict(base, **kw))


def _random_blocks(cache, n, seed):
    shape = (cache.shape[0], n, *cache.shape[2:])
    if cache.dtype == torch.float32:
        return torch.from_numpy(np.random.default_rng(seed).normal(
            size=shape).astype(np.float32))
    raw = np.random.default_rng(seed).integers(
        0, 256, int(np.prod(shape)) * cache.element_size(), dtype=np.uint8)
    return torch.from_numpy(raw).view(cache.dtype).reshape(shape)


def _b(t):
    return t.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("model,kw", [
    (TINY, dict(dtype="float32")),
    (TINY, dict(dtype="bfloat16")),
    (TINY, dict(dtype="bfloat16", kv_cache_dtype="fp8")),
    (DEEPSEEK, dict(dtype="float32")),
], ids=["f32", "bf16", "e4m3", "deepseek_pair"])
def test_host_tier_round_trip_is_byte_exact(model, kw):
    """Blocks offloaded from a runner's cache (staged, then drained into the
    slab) restore byte for byte into other slots; the capacity evicts the
    least recently used block first and hands ``on_evict`` copies of it,
    ``[L, 1, bs, ...]`` in the cache's dtype; the slabs are allocated once,
    ``capacity`` slots of each cache of the pair."""
    runner = ModelRunner(_cfg(model, **kw), device="cpu")
    ids = [3, 7, 11, 12, 40]
    k0, v0 = runner.kv_cache
    k, v = _random_blocks(k0, len(ids), 0), _random_blocks(v0, len(ids), 1)
    runner.scatter_blocks(ids, k, v)
    evicted = []
    tier = KvHostTier(runner, 4, on_evict=lambda h, ek, ev: evicted.append(
        (h, ek, ev)))
    assert [tuple(s.shape) for s in tier.slabs] == [
        (4, c.shape[0], *c.shape[2:]) for c in runner.kv_cache]
    tier.offload_batch([(100 + j, b) for j, b in enumerate(ids[:3])])
    assert tier.has(101) and tier.metrics()["host_kv_staged"] == 3
    tier.offload_batch([(103, ids[3]), (104, ids[4]), (101, ids[1])])
    # the staged blocks' slots are overwritten before the drain
    runner.scatter_blocks(ids, torch.zeros_like(k), torch.zeros_like(v))
    tier.drain()
    assert tier.metrics() == dict(
        host_kv_blocks=4, host_kv_staged=0, host_kv_capacity=4,
        host_kv_offloaded_total=5, host_kv_restored_total=0,
        host_kv_evicted_total=1)
    (h, ek, ev), = evicted  # block 100, the least recent
    assert h == 100 and ek.dtype == k0.dtype and tuple(ek.shape) == (
        k0.shape[0], 1, *k0.shape[2:])
    assert torch.equal(_b(ek), _b(k[:, :1])) and torch.equal(_b(ev), _b(v[:, :1]))
    dst = [50, 20, 33, 1]
    tier.restore([101, 102, 103, 104], dst)
    gk, gv = runner.gather_blocks(dst)
    assert torch.equal(_b(gk), _b(k[:, 1:])) and torch.equal(_b(gv), _b(v[:, 1:]))
    assert tier.restored_total == 4
    assert tier.match_extension([101, 102, 999, 103], 0) == [101, 102]


def test_host_tier_evicts_as_the_reference_does():
    """The same offloads, drains and restores through both host tiers:
    the same residency, counters and eviction hook calls (the slab files
    and evicts one block at a time, the reference trims after filing)."""
    rng = np.random.default_rng(5)
    sides = {}
    for pkg in ("ref", "port"):
        s = _side(pkg, 32)
        hooked = []
        hook = lambda h, k, v, hooked=hooked: hooked.append(  # noqa: E731
            (h, np.asarray(k).reshape(-1)[:1].tolist()))
        s.tier = (RefHost(s.store.gather, s.store.scatter, 5, on_evict=hook)
                  if pkg == "ref" else KvHostTier(s.store, 5, on_evict=hook))
        sides[pkg] = (s, hooked)
    for b in range(32):
        for s, _ in sides.values():
            s.store.write(b, np.full(4, b, np.float32))
    trace = {pkg: [] for pkg in sides}
    for step in range(40):
        op = rng.integers(0, 3)
        bids = [int(x) for x in rng.choice(32, int(rng.integers(1, 8)),
                                           replace=False)]
        for pkg, (s, hooked) in sides.items():
            if op == 0 or op == 1:
                s.tier.offload_batch([(1000 + b, b) for b in bids])
            else:
                s.tier.drain()
            have = [h for h in (1000 + b for b in bids) if s.tier.has(h)]
            trace[pkg].append((have, s.tier.metrics(), list(hooked)))
    assert trace["port"] == trace["ref"]


# ---------------------------------------------------------- the cold tier


def _blk(seed, shape=(2, 1, 4, 2, 3), dtype=torch.float32):
    return _random_blocks(torch.empty((shape[0], 1, *shape[2:]), dtype=dtype),
                          1, seed).reshape(shape)


def _np_of(t):
    """A port tensor as the reference's host array (ml_dtypes for bf16 and
    e4m3, as the reference's framing resolves them)."""
    from dynamo_tpu.transfer.framing import np_dtype

    name = str(t.dtype).removeprefix("torch.")
    raw = _b(t).numpy().copy()
    return raw.view(np_dtype(name)).reshape(tuple(t.shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn],
                         ids=["f32", "bf16", "e4m3"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_cold_files_read_in_both_packages(tmp_path, dtype, writer):
    """A ``.kvb`` file written by either package reads in the other, byte
    for byte, and the two packages write the same file bytes for the same
    block (header in the wire codec, xxh64 checksum)."""
    k, v = _blk(1, dtype=dtype), _blk(2, dtype=dtype)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port = KvColdTier(str(port_dir), 8)
    ref = RefCold(str(ref_dir), 8)
    port.put(0xFEEDFACECAFEBEEF, k, v, parent_hash=7)
    ref.put(0xFEEDFACECAFEBEEF, _np_of(k), _np_of(v), parent_hash=7)
    name = f"{0xFEEDFACECAFEBEEF:016x}.kvb"
    assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes()
    src = port_dir if writer == "port" else ref_dir
    if writer == "port":
        reader = RefCold(str(src), 8)
        assert reader.refresh() == 1
        gk, gv = reader.get(0xFEEDFACECAFEBEEF)
        assert gk.tobytes() == _b(k).numpy().tobytes()
        assert gv.tobytes() == _b(v).numpy().tobytes()
    else:
        reader = KvColdTier(str(src), 8)
        assert reader.refresh() == 1
        gk, gv = reader.get(0xFEEDFACECAFEBEEF)
        assert gk.dtype == dtype and tuple(gk.shape) == tuple(k.shape)
        assert torch.equal(_b(gk), _b(k)) and torch.equal(_b(gv), _b(v))


def test_cold_tier_round_trip_and_respawn_priming(tmp_path):
    """A second instance over the same directory (a respawned worker)
    learns the resident blocks on refresh and advertises them through its
    ownership hook, then rehydrates them by sequence hash; MLA's pair
    carries V's shape (``v_shape``)."""
    a = KvColdTier(str(tmp_path), 8)
    k1, v1 = _blk(0), _blk(1)
    k2, v2 = _blk(2, (2, 1, 4, 32)), _blk(3, (2, 1, 4, 8))  # c_kv, k_rope
    a.put(101, k1, v1)
    a.put(202, k2, v2, parent_hash=101)
    assert a.match_extension([101, 202, 999], 0) == [101, 202]
    primed = []
    b = KvColdTier(str(tmp_path), 8, on_stored=lambda hs, p: primed.extend(hs))
    assert not b.has(101) and b.refresh() == 2
    assert sorted(primed) == [101, 202]
    gk, gv = b.get(101)
    assert torch.equal(gk, k1) and torch.equal(gv, v1)
    gk, gv = b.get(202)
    assert torch.equal(gk, k2) and torch.equal(gv, v2)
    assert b.counts() == {"hits": 2, "misses": {}, "evictions": 0}
    # a writer counts payload bytes, a refresh the files' sizes (as the
    # reference's does)
    assert a.metrics()["cold_kv_bytes"] == sum(
        t.numel() * t.element_size() for t in (k1, v1, k2, v2))
    assert b.metrics() == {"cold_kv_blocks": 2, "cold_kv_capacity": 8,
                           "cold_kv_bytes": sum(
                               f.stat().st_size for f in tmp_path.iterdir())}


def test_mla_pair_round_trips_where_the_reference_quarantines_it(tmp_path):
    """MLA's cache pair (``c_kv`` [L, 1, bs, 1, R], ``k_rope`` [.., RD])
    has two last dims. The reference's file header carries K's shape only
    and reads V with it, so its own MLA files fail as corrupt (quarantined,
    a recompute); the port adds ``v_shape`` and rehydrates them. A Llama
    pair's header has no ``v_shape``: the same bytes as the reference's."""
    k, v = _blk(0, (3, 1, 8, 1, 16)), _blk(1, (3, 1, 8, 1, 8))
    ref = RefCold(str(tmp_path / "ref"), 8)
    ref.put(5, _np_of(k), _np_of(v))
    assert ref.get(5) is None and not ref.has(5)  # the reference's fault
    port = KvColdTier(str(tmp_path / "port"), 8)
    port.put(5, k, v)
    gk, gv = port.get(5)
    assert torch.equal(gk, k) and torch.equal(gv, v)


@pytest.mark.parametrize("damage", ["flipped_byte", "truncated", "renamed",
                                    "absent"])
def test_cold_tier_damaged_files_are_misses(tmp_path, damage):
    """A failed verification is a miss, never an install: the file is
    quarantined and counted, as in the reference (the same damage is held
    against both packages)."""
    outcomes = {}
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        tier = (RefCold if pkg == "ref" else KvColdTier)(str(d), 8)
        blk = (lambda s: _np_of(_blk(s))) if pkg == "ref" else _blk
        tier.put(111, blk(0), blk(1))
        path = d / f"{111:016x}.kvb"
        raw = path.read_bytes()
        want = 111
        if damage == "flipped_byte":
            path.write_bytes(raw[:-3] + bytes([raw[-3] ^ 0xFF]) + raw[-2:])
        elif damage == "truncated":
            path.write_bytes(raw[: len(raw) // 2])
        elif damage == "renamed":
            os.rename(path, d / f"{444:016x}.kvb")
            tier = (RefCold if pkg == "ref" else KvColdTier)(str(d), 8)
            tier.refresh()
            want = 444
        else:
            path.unlink()
        removed = []
        tier.on_removed = lambda hs: removed.extend(hs)
        got = tier.get(want)
        outcomes[pkg] = (got is None, os.listdir(d), tier.has(want), removed)
    assert outcomes["port"] == outcomes["ref"]
    assert outcomes["port"][0] and not outcomes["port"][2]


def test_cold_tier_capacity_evicts_oldest(tmp_path):
    tier = KvColdTier(str(tmp_path), capacity_blocks=2)
    for i, h in enumerate([11, 22, 33]):
        tier.put(h, _blk(i), _blk(i + 10))
    assert not tier.has(11) and tier.has(22) and tier.has(33)
    assert not (tmp_path / f"{11:016x}.kvb").exists()
    assert tier.counts()["evictions"] == 1
    # a refresh orders by access (mtime): a read touches it
    for i, h in enumerate([22, 33]):
        os.utime(tmp_path / f"{h:016x}.kvb", (1000 + i, 1000 + i))
    fresh = KvColdTier(str(tmp_path), capacity_blocks=2)
    fresh.refresh()
    assert list(fresh._index) == [22, 33]


def test_host_tier_spills_to_cold_on_eviction(tmp_path):
    """The host tier's capacity eviction is the cold tier's spill source,
    and the spill announces cold ownership through the hook."""
    runner = ModelRunner(_cfg(), device="cpu")
    k, v = _random_blocks(runner.kv_cache[0], 2, 0), _random_blocks(
        runner.kv_cache[1], 2, 1)
    runner.scatter_blocks([0, 1], k, v)
    stored = []
    cold = KvColdTier(str(tmp_path), 8, on_stored=lambda hs, p: stored.extend(hs))
    tier = KvHostTier(runner, 1, on_evict=cold.offer)
    tier.offload_batch([(100, 0), (101, 1)])
    tier.drain()
    assert not tier.has(100) and tier.has(101) and cold.has(100)
    assert stored == [100]
    gk, gv = cold.get(100)
    assert torch.equal(gk, k[:, :1]) and torch.equal(gv, v[:, :1])


def test_cold_hooks_run_on_the_loop(tmp_path):
    """Spill writes run on the executor; the ownership hook comes back on
    the event loop's thread."""
    async def main():
        loop_thread = threading.current_thread()
        seen = []
        cold = KvColdTier(str(tmp_path), 8, on_stored=lambda hs, p: seen.append(
            (threading.current_thread() is loop_thread, list(hs))))
        cold.offer(7, _blk(0), _blk(1))
        await cold.close()
        for _ in range(50):
            if seen:
                break
            await asyncio.sleep(0.01)
        return seen, cold.has(7)

    assert _run(main()) == ([(True, [7])], True)


def test_native_checksum_plain_version_is_the_reference_xxh64():
    """The cold tier's checksum: the plain version (what a CPU engine
    uses, and what the card's native routine is held against) equals
    ``xxhash.xxh64`` over K's bytes then V's, the reference's."""
    import xxhash

    rng = np.random.default_rng(0)
    for n in (0, 1, 31, 32, 33, 100, 4096):
        a = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, n // 3, dtype=np.uint8).tobytes()
        h = xxhash.xxh64()
        h.update(a)
        h.update(b)
        assert host_xxh64.xxh64_pair_ref(a, b) == h.intdigest()
        assert xxh64_intdigest(a + b) == h.intdigest()
    assert host_xxh64.checksum_for("cpu") is host_xxh64.xxh64_pair_ref
    assert host_xxh64.checksum_for("cuda") is host_xxh64.xxh64_pair


# --------------------------------------------------- engines with the tiers


PROMPT_A = [1, 17, 43, 99, 7, 3, 250, 12, 5, 77, 8, 21, 33, 44, 55, 66, 9, 2,
            120, 14, 71, 88, 19, 4, 30, 31, 32, 33, 34, 35]
PROMPT_B = [2, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46]
EVICTOR = [2] + list(range(90, 123))
MODELS = {"llama": (TINY, jax_llama), "deepseek": (DEEPSEEK, jax_deepseek)}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    mcfg, arch = MODELS[request.param]
    params = arch.init_params(JaxModelConfig(**mcfg), jax.random.PRNGKey(3),
                              jnp.float32)
    host = jax.device_get(params)
    return request.param, mcfg, params, from_jax_params(
        host, ModelConfig(**mcfg), "cpu", "float32")


def _req(prompt, n=6):
    return PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0))


async def _tokens(engine, prompt, n=6):
    out = []
    async for o in engine.generate(Context(_req(prompt, n))):
        out.extend(o["token_ids"])
    return out


async def _jax_tokens(engine, prompt, n=6):
    req = JaxRequest(token_ids=list(prompt),
                     stop_conditions=JaxStop(max_tokens=n, ignore_eos=True),
                     sampling_options=JaxSampling(temperature=0.0))
    out = []
    async for o in engine.generate(JaxContext(req)):
        out.extend(o["token_ids"])
    return out


def _blocks_by_hash(engine, hashes):
    """The engine's HBM blocks of ``hashes`` (gathered now), K and V."""
    alloc = engine.scheduler.allocator
    ids = [alloc.by_hash[h] for h in hashes]
    return engine.runner.gather_blocks(ids)


def _jax_blocks_by_hash(engine, hashes):
    alloc = engine.scheduler.allocator
    k, v = engine.runner.gather_blocks([alloc.by_hash[h] for h in hashes])
    return np.asarray(k), np.asarray(v)


TIERS = dict(max_batch_size=2, max_model_len=64, kv_block_size=8,
             num_kv_blocks=6, dtype="float32")


def test_host_restore_equals_the_reference_recompute(model):
    """Prompt A, an evictor that pushes A's blocks to the host tier, then A
    again: the repeat restores A's blocks instead of recomputing them. The
    restored blocks are byte-equal to the ones first computed and within
    1e-5 of the JAX engine's recompute of A; every stream equals the JAX
    engine's over the same sequence."""
    name, mcfg, jparams, tparams = model
    kw = dict(TIERS, host_kv_blocks=32)
    hashes = compute_block_hashes(PROMPT_A, 8)[:3]

    async def port():
        e = await TorchServingEngine.create(
            EngineConfig(model=ModelConfig(**mcfg), **kw), params=tparams,
            device="cpu", warmup=False)
        try:
            a1 = await _tokens(e, PROMPT_A)
            first = _blocks_by_hash(e, hashes)
            ev = await _tokens(e, EVICTOR)
            assert not any(h in e.scheduler.allocator.by_hash for h in hashes)
            a2 = await _tokens(e, PROMPT_A)
            again = _blocks_by_hash(e, hashes)
            return [a1, ev, a2], first, again, e.metrics()
        finally:
            await e.close()

    async def ref():
        e = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None),
            engine_config=JaxEngineConfig(model=JaxModelConfig(**mcfg), **kw),
            params=jparams, warmup=False)
        try:
            a1 = await _jax_tokens(e, PROMPT_A)
            blocks = _jax_blocks_by_hash(e, hashes)
            out = [a1, await _jax_tokens(e, EVICTOR), await _jax_tokens(e, PROMPT_A)]
            return out, blocks, e.metrics()
        finally:
            await e.close()

    streams, first, again, m = _run(port())
    want, ref_blocks, ref_m = _run(ref())
    assert streams == want
    assert streams[0] == streams[2]
    assert m["host_kv_restored_total"] == ref_m["host_kv_restored_total"] >= 3
    for a, b, r in zip(first, again, ref_blocks):
        assert torch.equal(_b(a), _b(b))  # restored = first written
        np.testing.assert_allclose(b.numpy(), r, atol=1e-5, rtol=0)
    for key in ("host_kv_offloaded_total", "host_kv_evicted_total",
                "host_kv_blocks", "kv_active_blocks"):
        assert m[key] == ref_m[key], key


def test_cold_rehydrate_after_respawn_equals_the_reference(model, tmp_path):
    """A prefix spilled through host-tier eviction survives its engine: a
    fresh engine over the same cold directory (empty HBM and host tiers)
    rehydrates it instead of recomputing, byte-equal to the blocks first
    written and within 1e-5 of the JAX engine's recompute; the stream
    equals the JAX engine's. Then a corrupted file: the pull commits only
    the verified run, the corrupt block is a miss (quarantined) and is
    recomputed; the stream is still the same."""
    name, mcfg, jparams, tparams = model
    kw = dict(TIERS, host_kv_blocks=1, cold_tier_blocks=32,
              prefix_pull_min_blocks=1)
    chain = compute_block_hashes(PROMPT_A, 8)

    def mk(d):
        return TorchServingEngine.create(
            EngineConfig(model=ModelConfig(**mcfg), cold_tier_dir=str(d), **kw),
            params=tparams, device="cpu", warmup=False)

    async def port():
        d = tmp_path / "cold"
        e1 = await mk(d)
        try:
            base = await _tokens(e1, PROMPT_A)
            first = _blocks_by_hash(e1, chain)
            await _tokens(e1, EVICTOR)
        finally:
            await e1.close()  # drains the spill writes
        spilled = [h for h in chain if (d / f"{h:016x}.kvb").exists()]
        e2 = await mk(d)
        try:
            assert e2.scheduler.fabric.cold.refresh() >= 2
            out = await _tokens(e2, PROMPT_A)
            s2 = e2.scheduler.fabric_stats()
            again = _blocks_by_hash(e2, spilled)
            hit2 = e2.scheduler.prefix_hit_tokens
            leaks2 = (dict(e2.scheduler.allocator.pinned),
                      e2.scheduler.allocator.used)
        finally:
            await e2.close()
        # a corrupt spill file: the LAST spilled block's payload
        victim = d / f"{spilled[-1]:016x}.kvb"
        raw = bytearray(victim.read_bytes())
        raw[-1] ^= 0xFF
        victim.write_bytes(bytes(raw))
        e3 = await mk(d)
        try:
            e3.scheduler.fabric.cold.refresh()
            out3 = await _tokens(e3, PROMPT_A)
            s3 = e3.scheduler.fabric_stats()
            leaks3 = (dict(e3.scheduler.allocator.pinned),
                      e3.scheduler.allocator.used)
        finally:
            await e3.close()
        return (base, out, out3, first, again, spilled, s2, s3, hit2,
                leaks2, leaks3, victim.exists())

    async def ref():
        e = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None),
            engine_config=JaxEngineConfig(
                model=JaxModelConfig(**mcfg),
                **dict(TIERS, host_kv_blocks=32)),
            params=jparams, warmup=False)
        try:
            return (await _jax_tokens(e, PROMPT_A),
                    _jax_blocks_by_hash(e, chain))
        finally:
            await e.close()

    (base, out, out3, first, again, spilled, s2, s3, hit2, leaks2, leaks3,
     victim_left) = _run(port())
    want, ref_blocks = _run(ref())
    assert len(spilled) >= 2
    assert base == out == out3 == want
    assert s2["pull_commits"] == 1 and s2["recent"][-1]["source"] == "cold"
    assert s2["recent"][-1]["served"] == len(spilled)
    assert hit2 == len(spilled) * 8
    idx = [chain.index(h) for h in spilled]
    for c in range(2):
        got = again[c]
        assert torch.equal(_b(got), _b(first[c][:, idx]))
        np.testing.assert_allclose(got.numpy(), ref_blocks[c][:, idx],
                                   atol=1e-5, rtol=0)
    # the corrupt block: a miss, quarantined, never installed
    assert s3["recent"][-1]["served"] == len(spilled) - 1
    assert s3["cold"]["misses"] == {"corrupt": 1}
    assert not victim_left
    assert leaks2 == leaks3 == ({}, 0)
