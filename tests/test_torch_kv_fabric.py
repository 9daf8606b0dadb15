"""The port's cluster KV fabric against the reference's: planning and the
ownership view, the pull frame's serve half (the same bytes on the wire),
pulls between engines (a port engine pulling from a port engine and from
the reference's engine), the fault sites' fallbacks, the scheduler's pull
path and the CLI's wiring helpers.

The differential contract everywhere: a pulled prefix gives the stream a
local recompute gives (and the JAX engine gives), and every failure path
(a serve dropped mid-stream, a pull stalled past its deadline) falls back
to a local recompute with the same stream and zero leaked blocks or pins
on both sides."""

import asyncio
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
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.kv import KvColdTier as RefCold
from dynamo_tpu.kv import KvFabric as RefFabric
from dynamo_tpu.kv_router.protocols import KvCacheStored as RefStored
from dynamo_tpu.kv_router.protocols import RouterEvent as RefEvent
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.tokens import compute_block_hashes
from dynamo_tpu_torch.cli import run
from dynamo_tpu_torch.engine.block_allocator import BlockAllocator, KvEventSink
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.serving import (
    TorchServingEngine,
    engine_config_from_mdc,
)
from dynamo_tpu_torch.kv import KvColdTier, KvFabric, fabric_key
from dynamo_tpu_torch.kv_router.protocols import (
    KvCacheRemoved,
    KvCacheStored,
    RouterEvent,
)
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.transfer.framing import pack_frame, read_exact
from dynamo_tpu_torch.utils import faults

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=512, rms_norm_eps=1e-5)
BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32", prefix_pull=True,
            prefix_pull_min_blocks=2, prefix_pull_timeout_s=10.0)
SHARED_PREFIX = [1, 17, 43, 99, 7, 3, 250, 12, 5, 77, 8, 21,
                 33, 44, 55, 66, 9, 2, 120, 14, 71, 88, 19, 4]  # 3 blocks
PROMPT_A = SHARED_PREFIX + [30, 31, 32, 33, 34, 35]
PROMPT_B = SHARED_PREFIX + [40, 41, 42, 43, 44, 45]
TIMEOUT_S = 180


def _run(coro, timeout=TIMEOUT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(3),
                                   jnp.float32)
    return params, from_jax_params(jax.device_get(params), ModelConfig(**TINY),
                                   "cpu", "float32")


def _cfg(**kw):
    return EngineConfig(model=ModelConfig(**TINY), **dict(BASE, **kw))


def _jax_cfg(**kw):
    return JaxEngineConfig(model=JaxModelConfig(**TINY), **dict(BASE, **kw))


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


def _stored(worker, hashes, parent=None, tier="hbm"):
    return RouterEvent(worker_id=worker, stored=KvCacheStored(hashes, parent),
                       tier=tier)


def _b(t):
    return t.contiguous().view(-1).view(torch.uint8)


def _no_leaks(engine):
    a = engine.scheduler.allocator
    return (dict(a.pinned), {b: n for b, n in a.refcount.items() if n})


# ------------------------------------------------ planning and the view


def test_plan_and_rank_peers_match_the_reference(tmp_path):
    """The same events, cold residency and peers in both fabrics: the same
    gate, the same plans (cold beats a peer at equal coverage, the run is
    capped so one token stays uncached, ``min_pull_blocks`` holds), and
    ``rank_peers`` orders migration targets alike. (Two peers at an equal
    run are a tie both packages break by the index's set order, which the
    hash seed moves: no case here has one.)"""
    prompt = list(range(1, 42))
    chain = compute_block_hashes(prompt, 4)  # 10 blocks
    peers = {"w-a": {"host": "h", "port": 1, "modes": ["tcp", "pull"]},
             "w-b": {"host": "h", "port": 2, "modes": ["tcp", "pull"]}}
    out = {}
    for pkg in ("ref", "port"):
        Cold, Fabric, Ev, St = ((RefCold, RefFabric, RefEvent, RefStored)
                                if pkg == "ref" else
                                (KvColdTier, KvFabric, RouterEvent, KvCacheStored))
        cold = Cold(str(tmp_path / pkg), 16)
        fab = Fabric(runner=None, allocator=None, engine_id="self", block_size=4,
                     cold=cold, peers=lambda: peers, min_pull_blocks=2)
        log = [fab.may_hold_any()]

        def plan(local, n=len(prompt), fab=fab):
            p = fab.plan(chain, local, n)
            return None if p is None else (p.source, p.hashes, p.start_block,
                                           p.worker_id, p.port, p.backend)

        fab.apply_event(Ev(worker_id="w-a", stored=St(chain[:6], None)))
        fab.apply_event(Ev(worker_id="w-b", stored=St(chain[:9], None)))
        fab.apply_event(Ev(worker_id="self", stored=St(chain, None)))
        log += [fab.may_hold_any(), plan(0), plan(5), plan(8), plan(0, 30)]
        for i, h in enumerate(chain[:9]):  # cold holds the same 9 blocks
            cold._index[h] = 1
        log += [plan(0), plan(3)]
        fab.remove_worker("w-b")
        log += [plan(0), plan(7)]
        ranked = fab.rank_peers(
            [{"engine_id": "e1", "worker_id": "w-x"},
             {"engine_id": "e2", "worker_id": "w-a"}, {"engine_id": "e3"}],
            prompt)
        log.append([p["engine_id"] for p in ranked])
        out[pkg] = log
    assert out["port"] == out["ref"]
    assert out["port"][2][0] == "peer" and out["port"][2][3] == "w-b"


def test_pool_scope_peers_matches_the_reference():
    """Two model pools on one component: the same scoped peers and live
    set as the reference's filter (missing metadata is a wildcard, an
    unreadable record too), over records in the wire codec."""
    import msgpack

    from dynamo_tpu.cli.run import _pool_scope_peers as ref_scope

    def rec(wid, model=None):
        info = {"instance_id": wid, "subject": "s", "worker_id": wid}
        if model is not None:
            info["model"] = model
        return msgpack.packb(info, use_bin_type=True)

    eps = {
        "ns/components/backend/endpoints/generate:w-a2": rec("w-a2", "modelA"),
        "ns/components/backend/endpoints/generate:w-b1": rec("w-b1", "modelB"),
        "ns/components/backend/endpoints/generate:w-any": rec("w-any"),
        "ns/components/backend/endpoints/generate:w-junk": b"\x00not-msgpack",
    }
    peers = {w: {"engine_id": w, "host": "h", "port": 1}
             for w in ("w-a2", "w-b1", "w-any", "w-junk", "w-norec")}
    for model in ("modelA", "modelB", ""):
        assert run._pool_scope_peers(peers, eps, model) == ref_scope(
            peers, eps, model)
    scoped, live = run._pool_scope_peers(peers, eps, "modelA")
    assert set(scoped) == {"w-a2", "w-any", "w-junk", "w-norec"}
    assert live == {"w-a2", "w-b1", "w-any", "w-junk"}


def test_fabric_peer_refresh_is_pool_scoped():
    """``_setup_kv_fabric`` against an in-process discovery plane: two
    pools on one component; the peer cache holds this worker's pool only,
    while the dead-id prune spans the component; the pull server's
    descriptor is registered under ``fabric_key``."""
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.memory import MemoryHub
    from dynamo_tpu_torch.runtime.wire import packb, unpackb

    class _StubServer:
        port = 7
        descriptor = {"host": "127.0.0.1", "port": 7, "modes": ["tcp", "pull"]}

    class _StubFabric:
        peer_pull = True
        cold = None

        def __init__(self, engine_id):
            self.engine_id = engine_id
            self.indexer = types.SimpleNamespace(worker_ids={"w-dead", "w-b1"})
            self.removed, self.held = [], []
            self.peers = lambda: {}

        async def serve(self, host=""):
            return _StubServer()

        def remove_worker(self, wid):
            self.removed.append(wid)
            self.indexer.worker_ids.discard(wid)

        def hold_task(self, task):
            self.held.append(task)

        def apply_event(self, ev):
            pass

    async def main():
        drt = DistributedRuntime.in_process(MemoryHub())
        endpoint = drt.namespace("ns").component("backend").endpoint("generate")
        lease = await drt.discovery.primary_lease()
        for wid, model in (("w-a1", "modelA"), ("w-a2", "modelA"),
                           ("w-b1", "modelB")):
            await drt.discovery.kv_create(endpoint.etcd_key(wid), packb(
                {"instance_id": wid, "subject": "s", "worker_id": wid,
                 "model": model}), lease_id=lease.id)
            if wid != "w-a1":
                await drt.discovery.kv_put(
                    fabric_key("ns", "backend", wid),
                    packb({"host": "h", "port": 1, "engine_id": wid}),
                    lease_id=lease.id)
        fab = _StubFabric("w-a1")
        core = types.SimpleNamespace(scheduler=types.SimpleNamespace(fabric=fab))
        flags = types.SimpleNamespace(namespace="ns", advertise_host="127.0.0.1")
        try:
            out = await run._setup_kv_fabric(
                flags, core, drt=drt, component="backend", endpoint=endpoint,
                instance_id="w-a1", model="modelA")
            mine = unpackb(await drt.discovery.kv_get(
                fabric_key("ns", "backend", "w-a1")))
            return out is fab, set(fab.peers()), fab.removed, mine
        finally:
            for task in fab.held:
                task.cancel()
            await asyncio.gather(*fab.held, return_exceptions=True)
            await drt.close()

    same, peers, removed, mine = _run(main())
    assert same and peers == {"w-a2"}
    assert "w-dead" in removed and "w-b1" not in removed
    assert mine == {"host": "127.0.0.1", "port": 7, "modes": ["tcp", "pull"],
                    "engine_id": "w-a1"}


def test_cli_takes_the_tier_flags():
    """The six flags the port refused are taken and reach EngineConfig as
    the reference's parser maps them; ``--kv-transfer ici`` stays
    refused by name."""
    flags = run.parse_flags([
        "--host-kv-blocks", "64", "--prefix-pull", "--prefix-pull-min-blocks",
        "3", "--prefix-pull-timeout-s", "7.5", "--cold-tier-dir", "/x",
        "--cold-tier-blocks", "128"])
    mdc = types.SimpleNamespace(config=None, context_length=512,
                                kv_block_size=16)
    cfg = engine_config_from_mdc(mdc, flags, extra={})
    assert (cfg.host_kv_blocks, cfg.prefix_pull, cfg.prefix_pull_min_blocks,
            cfg.prefix_pull_timeout_s, cfg.cold_tier_dir,
            cfg.cold_tier_blocks) == (64, True, 3, 7.5, "/x", 128)
    for name in ("--host-kv-blocks", "--prefix-pull", "--cold-tier-dir"):
        assert name not in run.REFUSED_FLAGS
    with pytest.raises(SystemExit, match="ici"):
        run.parse_flags(["--kv-transfer", "ici"])
    with pytest.raises(NotImplementedError, match="ici"):
        KvFabric(runner=None, allocator=None, engine_id="x", ici=object())


# ------------------------------------------------------ the serve half


def _seeded_cache(pkg, weights, ids, hashes):
    """A runner whose blocks ``ids`` hold the same random f32 bytes in
    either package, registered under ``hashes``, and a fabric over it."""
    rng = np.random.default_rng(11)
    shape = (TINY["num_layers"], len(ids), 8, TINY["num_kv_heads"],
             TINY["hidden_size"] // TINY["num_heads"])
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    if pkg == "ref":
        runner = JaxRunner(_jax_cfg(), params=weights[0])
        runner.scatter_blocks(ids, k, v)
        alloc = RefAllocator(64, 8)
        fab = RefFabric(runner, alloc, engine_id="srv", block_size=8)
    else:
        runner = ModelRunner(_cfg(), params=weights[1], device="cpu")
        runner.scatter_blocks(ids, torch.from_numpy(k), torch.from_numpy(v))
        alloc = BlockAllocator(64, 8)
        fab = KvFabric(runner, alloc, engine_id="srv", block_size=8)
    parent = None
    for bid, h in zip(ids, hashes):
        alloc.register_complete(bid, h, parent)
        parent = h
    return fab, k, v


def test_pull_serve_sends_the_reference_bytes(weights):
    """One pull frame to the reference's serve half and to the port's over
    the same cache bytes: the same bytes come back (chunk headers in the
    wire codec, raw block payloads, the ``pull_end`` trailer), the run
    stops at the first hash neither holds, and no pin is left behind; a
    server with no pull source answers ``pull_end`` with 0 served."""
    ids = [5, 9, 2, 40, 17, 33, 8]
    hashes = [1000 + i for i in range(len(ids))]
    asked = hashes[:5] + [999] + hashes[5:]

    async def pull_raw(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        pack_frame(writer, {"type": "pull", "hashes": asked, "chunk_blocks": 2})
        await writer.drain()
        raw = b""
        while not raw.endswith(b"\xa4type\xa8pull_end\xa6served\x05"):
            raw += await reader.read(1 << 16)
        writer.close()
        return raw

    async def main():
        out = {}
        for pkg in ("ref", "port"):
            fab, k, v = _seeded_cache(pkg, weights, ids, hashes)
            server = await fab.serve()
            try:
                out[pkg] = (await pull_raw(server.port),
                            dict(fab.allocator.pinned))
            finally:
                await server.close()
        from dynamo_tpu_torch.disagg.transfer import KvTransferServer

        bare = await KvTransferServer(scatter=lambda *a: None,
                                      on_commit=lambda *a: None).start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", bare.port)
            pack_frame(writer, {"type": "pull", "hashes": hashes})
            await writer.drain()
            n = int.from_bytes(await read_exact(reader, 4), "big")
            from dynamo_tpu_torch.runtime.wire import unpackb

            out["bare"] = unpackb(await read_exact(reader, n))
            writer.close()
        finally:
            await bare.close()
        return out, k, v

    out, k, v = _run(main())
    assert out["port"] == out["ref"]
    assert out["port"][1] == {}
    raw = out["port"][0]
    assert k[:, :2].tobytes() in raw and v[:, 4:5].tobytes() in raw
    assert out["bare"] == {"type": "pull_end", "served": 0}


# ---------------------------------------------------- engines that pull


def _feed(fabric, worker_id):
    """A KV event sink that feeds ``fabric``'s ownership view (the event
    stream a router would relay)."""
    return KvEventSink(
        on_stored=lambda hs, p: fabric.apply_event(_stored(worker_id, list(hs), p)),
        on_removed=lambda hs: fabric.apply_event(RouterEvent(
            worker_id=worker_id, removed=KvCacheRemoved(list(hs)))))


async def _pair(weights, **b_kw):
    """Engine B's fabric sees engine A's KV events and pulls from A's
    serve half."""
    b = await TorchServingEngine.create(_cfg(**b_kw), params=weights[1],
                                        device="cpu", warmup=False)
    a = await TorchServingEngine.create(
        _cfg(), params=weights[1], device="cpu", warmup=False,
        events=_feed(b.scheduler.fabric, "worker-a"))
    server = await a.scheduler.fabric.serve()
    b.scheduler.fabric.peers = lambda: {
        "worker-a": {"host": "127.0.0.1", "port": server.port}}
    return a, b


async def _baseline(weights, prompt):
    e = await TorchServingEngine.create(_cfg(), params=weights[1], device="cpu",
                                        warmup=False)
    try:
        return await _tokens(e, prompt)
    finally:
        await e.close()


def test_peer_pull_is_byte_identical(weights):
    """Worker A computed a shared prefix; worker B pulls its 3 blocks
    instead of recomputing them: the pulled blocks are A's bytes, B's
    stream equals a local recompute's and the JAX engine's, B prefilled
    only the 6-token tail, and neither side keeps a pin or a block."""
    hashes = compute_block_hashes(PROMPT_B, 8)[:3]

    async def main():
        base = await _baseline(weights, PROMPT_B)
        a, b = await _pair(weights)
        try:
            await _tokens(a, PROMPT_A)
            ka, va = a.runner.gather_blocks(
                [a.scheduler.allocator.by_hash[h] for h in hashes])
            out = await _tokens(b, PROMPT_B)
            kb, vb = b.runner.gather_blocks(
                [b.scheduler.allocator.by_hash[h] for h in hashes])
            stats = b.scheduler.fabric_stats()
            hit = (b.scheduler.prefix_hit_tokens, b.scheduler.prefix_total_tokens)
            served = a.scheduler.fabric.stats()
        finally:
            await a.close()
            await b.close()
        return base, out, (ka, va, kb, vb), stats, hit, served, _no_leaks(a), \
            _no_leaks(b)

    async def ref():
        e = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None), engine_config=_jax_cfg(),
            params=weights[0], warmup=False)
        try:
            return await _jax_tokens(e, PROMPT_B)
        finally:
            await e.close()

    base, out, (ka, va, kb, vb), stats, hit, served, la, lb = _run(main())
    assert out == base == _run(ref())
    assert torch.equal(_b(ka), _b(kb)) and torch.equal(_b(va), _b(vb))
    assert stats["pull_commits"] == 1 and stats["pulls"] == {"peer_committed": 1}
    assert stats["recent"][-1]["served"] == 3
    assert hit == (24, len(PROMPT_B))
    assert served["serves"] == 1 and served["served_blocks"] == 3
    assert la == lb == ({}, {})


@pytest.mark.parametrize("fault", ["transfer_conn_drop", "prefix_pull_stall"])
def test_pull_faults_fall_back_byte_identically(weights, fault):
    """The serving side dies mid-stream, or the pull stalls past its
    deadline: B falls back to a local recompute with the same stream,
    names the reason, and neither side keeps a pin or a block."""

    async def main():
        base = await _baseline(weights, PROMPT_B)
        kw = dict(prefix_pull_timeout_s=0.5) if fault == "prefix_pull_stall" else {}
        a, b = await _pair(weights, **kw)
        try:
            await _tokens(a, PROMPT_A)
            faults.arm(fault, "once")
            out = await _tokens(b, PROMPT_B)
            stats = b.scheduler.fabric_stats()
        finally:
            faults.reset()
            await a.close()
            await b.close()
        return base, out, stats, _no_leaks(a), _no_leaks(b)

    base, out, stats, la, lb = _run(main())
    assert out == base
    assert stats["pull_commits"] == 0
    assert stats["pull_fallbacks"] == (
        {"error": 1} if fault == "transfer_conn_drop" else {"timeout": 1})
    assert la == lb == ({}, {})


def test_port_pulls_from_the_reference_engine(weights):
    """The reference's engine serves, the port's pulls: the pull frame and
    its chunk frames are one format, the pulled blocks are the reference
    engine's bytes, and the stream equals the port's local recompute."""
    hashes = compute_block_hashes(PROMPT_B, 8)[:3]

    async def main():
        base = await _baseline(weights, PROMPT_B)
        b = await TorchServingEngine.create(_cfg(), params=weights[1],
                                            device="cpu", warmup=False)
        fab = b.scheduler.fabric
        ref_sink = RefSink(on_stored=lambda hs, p: fab.apply_event(
            _stored("worker-ref", list(hs), p)))
        a = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None), engine_config=_jax_cfg(),
            params=weights[0], warmup=False, events=ref_sink)
        server = await a.scheduler.fabric.serve()
        fab.peers = lambda: {"worker-ref": {"host": "127.0.0.1",
                                            "port": server.port}}
        try:
            await _jax_tokens(a, PROMPT_A)
            ka, va = a.runner.gather_blocks(
                [a.scheduler.allocator.by_hash[h] for h in hashes])
            out = await _tokens(b, PROMPT_B)
            kb, vb = b.runner.gather_blocks(
                [b.scheduler.allocator.by_hash[h] for h in hashes])
            stats = b.scheduler.fabric_stats()
        finally:
            await a.close()
            await b.close()
        return base, out, (np.asarray(ka), np.asarray(va), kb, vb), stats, \
            _no_leaks(b)

    base, out, (ka, va, kb, vb), stats, lb = _run(main())
    assert stats["pull_commits"] == 1
    assert kb.numpy().tobytes() == ka.tobytes()
    assert vb.numpy().tobytes() == va.tobytes()
    assert out == base
    assert lb == ({}, {})


def test_held_followers_wait_for_the_pull_then_hit_locally(weights):
    """Two requests over one prefix reach B at once: one pulls, the other
    is held out of local admission until the pull commits and then hits
    the pulled blocks locally (one transfer, not two); both streams equal
    their local recomputes."""
    prompt_c = SHARED_PREFIX + [50, 51, 52, 53, 54, 55]

    async def main():
        want = [await _baseline(weights, p) for p in (PROMPT_B, prompt_c)]
        a, b = await _pair(weights)
        try:
            await _tokens(a, PROMPT_A)
            got = await asyncio.gather(_tokens(b, PROMPT_B), _tokens(b, prompt_c))
            stats = b.scheduler.fabric_stats()
            hit = b.scheduler.prefix_hit_tokens
        finally:
            await a.close()
            await b.close()
        return want, list(got), stats, hit, _no_leaks(b)

    want, got, stats, hit, lb = _run(main())
    assert got == want
    assert stats["pull_commits"] == 1 and stats["pulls"] == {"peer_committed": 1}
    assert hit == 48  # both requests' 3 shared blocks
    assert lb == ({}, {})


def test_cli_worker_wiring_pulls_between_two_workers(weights):
    """Two token-level workers wired as the CLI wires them, in one process
    over an in-process broker: KV event publishers, endpoints, and
    ``_setup_kv_fabric`` (the pull server's descriptor, the peer refresh,
    the ownership feed). A prompt served by one is pulled by the other,
    whose stats scrape carries the fabric's counters."""
    from dynamo_tpu_torch.kv_router.publisher import (
        KvEventPublisher,
        KvMetricsPublisher,
    )
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.memory import MemoryHub

    flags = types.SimpleNamespace(namespace="ns", advertise_host="127.0.0.1")

    async def worker(hub, wid):
        drt = DistributedRuntime.in_process(hub)
        endpoint = drt.namespace("ns").component("backend").endpoint("generate")
        publisher = KvEventPublisher(endpoint.component, wid)
        publisher.start()
        core = await TorchServingEngine.create(
            _cfg(), params=weights[1], device="cpu", warmup=False,
            events=publisher.as_sink())

        async def handler(payload, ctx):
            async for out in core.generate(Context(payload, ctx)):
                yield out

        serving = await endpoint.serve(
            handler, instance_id=wid, metadata={"model": "tiny"},
            stats_handler=KvMetricsPublisher(core.metrics).stats_handler)
        fab = await run._setup_kv_fabric(flags, core, drt=drt,
                                         component="backend",
                                         endpoint=endpoint, instance_id=wid,
                                         model="tiny")
        return types.SimpleNamespace(drt=drt, core=core, serving=serving,
                                     fab=fab, publisher=publisher)

    async def main():
        base = await _baseline(weights, PROMPT_B)
        hub = MemoryHub()
        wa = await worker(hub, "w-a")
        wb = await worker(hub, "w-b")
        try:
            # B's first peer refresh found A's pull-server descriptor
            peers = wb.fab.peers()
            await _tokens(wa.core, PROMPT_A)
            for _ in range(200):  # the event feed reaches B's view
                if len(wb.fab.indexer.tree):
                    break
                await asyncio.sleep(0.01)
            out = await _tokens(wb.core, PROMPT_B)
            stats = wb.core.scheduler.fabric_stats()
        finally:
            for w in (wa, wb):
                await w.serving.stop()
                w.publisher.stop()
                await w.core.close()
                await w.drt.close()
        return base, out, stats, peers

    base, out, stats, peers = _run(main())
    assert set(peers) == {"w-a"} and peers["w-a"]["modes"] == ["tcp", "pull"]
    assert out == base
    assert stats["pull_commits"] == 1 and stats["pinned_blocks"] == 0


def _family(text, name, labels):
    """One sample of a rendered exposition (0.0 when absent)."""
    for line in text.splitlines():
        if line.startswith(f"{name}{{") and all(
                f'{k}="{v}"' in line for k, v in labels.items()):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_peer_pull_records_the_transfer_family(weights):
    """A peer pull's ``dynamo_transfer_*{plane="fabric",backend="tcp"}`` in
    the puller's registry: the bytes equal ``pull_bytes["tcp"]``, one
    duration sample, the channel closed after the pull."""

    async def main():
        a, b = await _pair(weights)
        try:
            await _tokens(a, PROMPT_A)
            await _tokens(b, PROMPT_B)
            return b.scheduler.fabric.registry.render(), dict(
                b.scheduler.fabric.pull_bytes)
        finally:
            await a.close()
            await b.close()

    text, pulled = _run(main())
    labels = {"plane": "fabric", "backend": "tcp"}
    assert _family(text, "dynamo_transfer_bytes_total", labels) == pulled["tcp"] > 0
    assert _family(text, "dynamo_transfer_duration_seconds_count", labels) == 1.0
    assert _family(text, "dynamo_transfer_channels", labels) == 0.0
