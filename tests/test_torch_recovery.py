"""Recovery and live migration in the port, against the reference.

- Policy and state: ``migration_class`` against the reference's over a
  table of request kinds (plain, guided choice, guided JSON, prompt
  logprobs still owed, mid-prefill, waiting); ``package_request``'s
  ``MigrationState`` and the allocator after it equal the reference's, hot
  and cold; the ``mig_begin`` header and a KV frame a port sender writes
  are byte for byte the reference sender's.
- Streams: an admin drain of a port source into a port peer, hot (graceful
  seize) and cold (hard seize), from a synchronous and from a chained
  source: the greedy streams equal the undisturbed port streams and
  ``JaxServingEngine``'s, exactly; a seeded sampled stream equals its
  undisturbed port stream; no block stays in use on either side.
- The failure paths of ``tests/test_recovery.py``: the receiver poisons a
  partial migration; an oversized sequence, a block-table overflow and a
  ``kv_block_size`` mismatch are nacked before anything mutates; a dropped
  connection fails over to the next peer; a wedge trips the watchdog, the
  controller seizes hard, migrates cold and respawns (deregister before
  register); the respawn backoff doubles and gives up at its budget; a
  request no peer accepts ends with an error frame; a draining engine
  raises ``EngineDrainingError``; HTTP answers 503 with Retry-After, and
  ``/admin/drain`` 501 without a controller; the KV router never picks a
  draining port worker.
- The re-bind: a ``follow_migrated_stream`` consumer attaches to the peer
  and the source's relay ends before the stream does (the peer's decode is
  gated on the attach's acknowledgement, not timed); an attach that fails
  falls back to the relay.
- Cache forms: a hot migration over an e4m3 cache installs the shipped
  bytes; a DeepSeek ``(c_kv, k_rope)`` pair migrates hot in the port, while
  the reference's block frame cannot carry it (its receiver views V with
  K's shape).
- The CLI: the eight recovery flags parse as the reference's parser does
  (and give its ``RecoveryConfig``); two ``in=http out=torch --self-heal``
  subprocesses: ``POST /admin/drain`` migrates a streamed chat hot, the
  stream runs to ``[DONE]`` with the undisturbed text, a new request gets
  503, and the source's ``/metrics`` counts the committed hot migration.

Tiny widths (2 layers, hidden 64, block size 8), f32 unless named. Every
test runs under its own timeout; servers bind port 0.
"""

import asyncio
import dataclasses
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
import types
from pathlib import Path

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.block_allocator import BlockAllocator as RefAllocator
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.scheduler import EngineRequest as RefER
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols.common import PreprocessedRequest as RefRequest
from dynamo_tpu.protocols.common import SamplingOptions as RefSampling
from dynamo_tpu.protocols.common import StopConditions as RefStop
from dynamo_tpu.recovery import migration as ref_migration
from dynamo_tpu.runtime.engine import AsyncEngineContext as RefCtx
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.tokens import TokenSequence as RefSeq
from dynamo_tpu.transfer.tcp import TcpBackend as RefTcp
from dynamo_tpu_torch.engine.block_allocator import BlockAllocator
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.kv_router.indexer import OverlapScores
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.kv_router.scheduler import AllWorkersBusy, KvScheduler
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    EngineOutput,
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.recovery import (
    MigrationRejected,
    MigrationServer,
    MigrationSink,
    MigrationState,
    RecoveryConfig,
    RecoveryController,
    migrate_request,
    migration_class,
    package_request,
)
from dynamo_tpu_torch.recovery import migration as port_migration
from dynamo_tpu_torch.runtime.engine import (
    AsyncEngineContext,
    Context,
    EngineDrainingError,
)
from dynamo_tpu_torch.runtime.wire import unpackb
from dynamo_tpu_torch.telemetry.flight import FlightRecorder, flight_recorder
from dynamo_tpu_torch.telemetry.watchdog import StallWatchdog
from dynamo_tpu_torch.tokens import TokenSequence
from dynamo_tpu_torch.transfer.framing import pack_frame, read_header
from dynamo_tpu_torch.utils import faults
from fixtures import make_model_dir

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=512, rms_norm_eps=1e-5)
DEEPSEEK = dict(TINY, kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, num_kv_heads=4)
BASE = dict(max_batch_size=4, max_model_len=256, kv_block_size=8,
            num_kv_blocks=160, dtype="float32")
CHAINED = dict(decode_pipeline_depth=2, multi_step_decode=4)
NEW = 32           # tokens a stream asks for
LIVE = 6           # tokens every stream has when the drain fires
SAMPLED = dict(temperature=0.8, top_p=0.95, seed=1234)
TIMEOUT_S = 120


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 512, n)]


# a 150-token prompt ships two KV frames of 16 blocks
PROMPTS = [_prompt(150, 1), _prompt(20, 2), _prompt(45, 3)]
SAMPLED_PROMPT = PROMPTS[1]


def _run(coro, timeout=TIMEOUT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(7),
                                   jnp.float32)
    host = jax.device_get(params)
    return params, from_jax_params(host, ModelConfig(**TINY), "cpu", "float32")


def _cfg(model=TINY, **kw):
    return EngineConfig(model=ModelConfig(**model), **dict(BASE, **kw))


def _req(prompt, max_tokens=NEW, **sampling):
    sampling.setdefault("temperature", 0.0)
    return PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=SamplingOptions(**sampling))


async def _engine(params, model=TINY, **kw):
    return await TorchServingEngine.create(_cfg(model, **kw), params=params,
                                           device="cpu", warmup=False)


async def _stream(engine, prompt, **sampling):
    toks, finish = [], None
    async for out in engine.generate(Context(_req(prompt, **sampling))):
        toks.extend(out["token_ids"])
        finish = out.get("finish_reason") or finish
    return toks, finish


@pytest.fixture(scope="module")
def baseline(weights):
    """The undisturbed streams: the port's (greedy and the seeded sampled
    one) and ``JaxServingEngine``'s greedy ones, on the same weights."""
    async def port():
        engine = await _engine(weights[1])
        try:
            greedy = [await _stream(engine, p) for p in PROMPTS]
            return greedy, await _stream(engine, SAMPLED_PROMPT, **SAMPLED)
        finally:
            await engine.close()

    async def ref():
        engine = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None),
            engine_config=JaxEngineConfig(model=JaxModelConfig(**TINY), **BASE),
            params=weights[0], warmup=False)
        try:
            out = []
            for p in PROMPTS:
                req = RefRequest(token_ids=list(p),
                                 stop_conditions=RefStop(max_tokens=NEW,
                                                         ignore_eos=True),
                                 sampling_options=RefSampling(temperature=0.0))
                toks = []
                async for o in engine.generate(JaxContext(req)):
                    toks.extend(o["token_ids"])
                out.append(toks)
            return out
        finally:
            await engine.close()

    greedy, sampled = _run(port())
    return {"port": greedy, "sampled": sampled, "jax": _run(ref())}


# ------------------------------------------------------------ policy and state


def _er(pkg, prompt, max_tokens=20, **sampling):
    """A request of either package, as the serving facade builds it."""
    sampling.setdefault("temperature", 0.0)
    if pkg == "port":
        req = _req(prompt, max_tokens, **sampling)
        return EngineRequest(request_id="r1", prompt=list(prompt), req=req,
                             ctx=AsyncEngineContext(trace_id="t1"),
                             out_queue=asyncio.Queue())
    req = RefRequest(token_ids=list(prompt),
                     stop_conditions=RefStop(max_tokens=max_tokens,
                                             ignore_eos=True),
                     sampling_options=RefSampling(**sampling))
    return RefER(request_id="r1", prompt=list(prompt), req=req,
                 ctx=RefCtx(trace_id="t1"), out_queue=asyncio.Queue())


def _decode_state(pkg, er, n_tokens=6):
    """Committed KV over prompt + n generated tokens, one more pending."""
    seq_cls = TokenSequence if pkg == "port" else RefSeq
    toks = list(er.prompt) + list(range(100, 100 + n_tokens))
    er.seq = seq_cls(toks, block_size=8)
    er.context_len = len(toks)
    er.pending_token = 7
    er.generated = n_tokens + 1
    return er


def _kind(pkg, kind):
    prompt = [1, 2, 3]
    if kind == "plain":
        return _decode_state(pkg, _er(pkg, prompt))
    if kind == "waiting":
        return _er(pkg, prompt)
    if kind == "mid_prefill":
        er = _er(pkg, list(range(1, 30)))
        er.seq = (TokenSequence if pkg == "port" else RefSeq)(er.prompt, block_size=8)
        er.context_len = 8
        return er
    if kind == "guided_choice":
        return _decode_state(pkg, _er(pkg, prompt,
                                      guided_choice_token_ids=[[5, 6]]))
    if kind == "guided_json":
        return _decode_state(pkg, _er(pkg, prompt,
                                      guided_json={"type": "json_object"}))
    if kind == "prompt_lps_owed":
        er = _decode_state(pkg, _er(pkg, prompt))
        er.want_prompt_lps = True
        return er
    raise AssertionError(kind)


KINDS = {"plain": "hot", "waiting": "cold", "mid_prefill": "cold",
         "guided_choice": "cold", "guided_json": "fail",
         "prompt_lps_owed": "cold"}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_migration_class_matches_the_reference(kind):
    async def go():
        return (migration_class(_kind("port", kind)),
                ref_migration.migration_class(_kind("reference", kind)))

    port, ref = _run(go())
    assert port == ref == KINDS[kind]


@pytest.mark.parametrize("mode", ["hot", "cold", "waiting"])
def test_package_request_matches_the_reference(mode):
    """The same extracted request, packaged by each package over its own
    allocator: the wire state field for field, the blocks the request keeps
    and the allocator's count after it."""
    async def go():
        out = []
        for pkg, alloc_cls, package in (
                ("port", BlockAllocator, package_request),
                ("reference", RefAllocator, ref_migration.package_request)):
            alloc = alloc_cls(32, 8, enable_prefix_caching=False)
            prompt = list(range(1, 21))
            er = _er(pkg, prompt, seed=42)
            er.base_key = np.asarray([11, 4000000000], np.uint32)
            if mode == "waiting":
                er.resume_tokens = [9, 8, 7]  # a preempted request
                er.generated = 3
            else:
                _decode_state(pkg, er)
                # four blocks hold 26 committed tokens; one more is headroom
                er.block_ids = alloc.allocate_n(5)
            state = package(er, alloc, 8, allow_hot=(mode == "hot"))
            out.append((state.to_wire(), state.hot, list(er.block_ids),
                        alloc.used))
        return out

    port, ref = _run(go())
    assert port == ref
    wire, hot, blocks, used = port
    assert hot is (mode == "hot")
    assert used == len(blocks) == (4 if mode == "hot" else 0)
    assert wire["base_key"] == [11, 4000000000]
    if mode == "cold":
        assert wire["resume_tokens"] == list(range(100, 106)) + [7]
    if mode == "waiting":
        assert wire["resume_tokens"] == [9, 8, 7]


def test_begin_header_and_block_frame_bytes_match_the_reference(monkeypatch):
    """A port sender's ``mig_begin`` frame and KV block frame, and the
    reference sender's for the same state and blocks, are the same bytes
    (the runtime's wire codec against msgpack; the receiver nacks the
    commit, so nothing relays)."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((2, 3, 8, 2, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 3, 8, 2, 16), np.float32))

    async def capture(send):
        frames = []

        async def handle(reader, writer):
            while True:
                raw = await reader.readexactly(4)
                (n,) = struct.unpack(">I", raw)
                head = await reader.readexactly(n)
                header = unpackb(head)
                payload = b""
                if header["type"] == "mig_blocks":
                    payload = await reader.readexactly(
                        header["k_bytes"] + header["v_bytes"])
                frames.append(raw + head + payload)
                if header["type"] == "mig_begin":
                    pack_frame(writer, {"type": "mig_ack", "ok": True})
                elif header["type"] == "mig_commit":
                    pack_frame(writer, {"type": "mig_ack", "ok": False,
                                        "reason": "test"})
                    await writer.drain()
                    writer.close()
                    return

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            with pytest.raises(Exception, match="test"):
                await send(port)
        finally:
            server.close()
            await server.wait_closed()
        return frames

    async def go():
        er = _decode_state("port", _er("port", list(range(1, 21)), seed=3))
        er.block_ids = [4, 5, 6]
        er.base_key = np.asarray([1, 2], np.uint32)
        state = MigrationState(
            request_id="r1", trace_id="t1", req=er.req.to_wire(),
            committed_tokens=[int(t) for t in er.seq.token_ids],
            resume_tokens=[], pending_token=7, generated=7, base_key=[1, 2],
            prompt_lps_emitted=False, kv_block_size=8)
        ref_er = _decode_state("reference", _er("reference", list(range(1, 21)),
                                                seed=3))
        ref_er.block_ids = [4, 5, 6]
        ref_state = ref_migration.MigrationState.from_wire(state.to_wire())
        port_frames = await capture(lambda p: migrate_request(
            "127.0.0.1", p, er, state, gather=lambda ids: (k, v),
            to_host=lambda a, b: (a, b)))
        ref_frames = await capture(lambda p: ref_migration.migrate_request(
            "127.0.0.1", p, ref_er, ref_state,
            gather=lambda ids: (k.numpy(), v.numpy())))
        return port_frames, ref_frames

    port, ref = _run(go())
    assert len(port) == len(ref) == 3  # begin, one block frame, commit
    assert port == ref


# ------------------------------------------------------------------ streams


async def _drain_scenario(params, *, hard=False, src_kw=None, dst_kw=None,
                          model=TINY, prompts=PROMPTS, sampled=True,
                          peers=None, conn_drop=False, capture=None):
    """Serve ``prompts`` (and the seeded sampled one) on a source engine,
    drain it once every stream is live and migrate into a peer; return the
    streams, the drain's summary and what the checks read."""
    src = await _engine(params, model, **(src_kw or {}))
    dst = await _engine(params, model, **(dst_kw or {}))
    sink = MigrationSink(dst.scheduler, dst.runner)
    if capture is not None:
        capture(src, dst, sink)
    server = await MigrationServer(sink).start()
    here = {"host": server.host, "port": server.port, "engine_id": "dst"}
    ctl = RecoveryController(
        engine_id="src", scheduler=src.scheduler, runner=src.runner,
        peers=peers or (lambda: [here, here] if conn_drop else [here]),
        config=RecoveryConfig(drain_grace_s=0.0))
    reqs = [(p, {}) for p in prompts]
    if sampled:
        reqs.append((SAMPLED_PROMPT, SAMPLED))
    got = [[[], None] for _ in reqs]

    async def one(i, prompt, sampling):
        async for out in src.generate(Context(_req(prompt, **sampling))):
            got[i][0].extend(out["token_ids"])
            got[i][1] = out.get("finish_reason") or got[i][1]

    tasks = [asyncio.ensure_future(one(i, p, s)) for i, (p, s) in enumerate(reqs)]
    try:
        while min(len(g[0]) for g in got) < LIVE:
            await asyncio.sleep(0.002)
        if conn_drop:
            faults.arm("transfer_conn_drop", "once")
        summary = await ctl.drain(hard=hard)
        draining = src.metrics()["draining"]
        await asyncio.gather(*tasks)
        return dict(streams=[tuple(g) for g in got], summary=summary,
                    draining=draining, src_used=src.scheduler.allocator.used,
                    dst_used=dst.scheduler.allocator.used,
                    dst_decode_steps=dst.scheduler.decode_steps,
                    registry=ctl.registry.render(), shipped=dict(ctl.shipped))
    finally:
        await ctl.close()
        await server.close()
        await dst.close()
        await src.close()


SCENARIOS = {"hot_sync": (False, {}), "hot_chained": (False, CHAINED),
             "cold_sync": (True, {}), "cold_chained": (True, CHAINED)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_drain_streams_match_the_undisturbed_and_the_reference(
        weights, baseline, scenario):
    """Every stream crosses the hop: greedy ones equal the undisturbed port
    streams and ``JaxServingEngine``'s exactly, the seeded sampled one its
    undisturbed port stream (its key and ``generated`` ship); nothing stays
    in use on either side, and the migrations are counted by mode."""
    hard, src_kw = SCENARIOS[scenario]
    out = _run(_drain_scenario(weights[1], hard=hard, src_kw=src_kw))
    mode = "cold" if hard else "hot"
    assert out["summary"]["migrated"] == len(PROMPTS) + 1
    assert out["summary"]["failed"] == 0 and out["draining"] is True
    streams = out["streams"]
    for (toks, finish), port, ref in zip(streams, baseline["port"],
                                         baseline["jax"]):
        assert (toks, finish) == port and toks == ref
        assert finish == "length"
    assert streams[-1] == baseline["sampled"]
    assert out["src_used"] == 0 and out["dst_used"] == 0
    assert out["dst_decode_steps"] > 0
    assert (f'dynamo_recovery_migrations_total{{mode="{mode}",'
            f'outcome="committed"}} {float(len(PROMPTS) + 1)}') in out["registry"]
    if hard:
        assert out["shipped"] == {"bytes": 0, "frames": 0}
    else:
        # the 150-token prompt's 20 blocks ship as two frames; the others one
        assert out["shipped"]["frames"] == len(PROMPTS) + 2


def test_dropped_connection_fails_over_to_the_next_peer(weights, baseline):
    """``transfer_conn_drop`` kills the first attempt's connection before
    its commit: the receiver poisons that reservation, the controller tries
    the next peer, and the stream still equals the undisturbed one."""
    out = _run(_drain_scenario(weights[1], prompts=PROMPTS[:1], sampled=False,
                               conn_drop=True))
    assert out["summary"]["migrated"] == 1 and out["summary"]["failed"] == 0
    assert out["streams"][0] == baseline["port"][0]
    assert out["src_used"] == 0 and out["dst_used"] == 0
    assert faults.fired_total == {"transfer_conn_drop": 1}
    assert "transfer.poison" in [e["kind"] for e in flight_recorder().snapshot()]


def test_request_no_peer_accepts_fails_with_an_error_frame(weights):
    """A dead peer, then none: the stream ends with ``finish_reason`` error
    and the request's blocks go back."""
    async def dead_port():
        server = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        server.close()
        await server.wait_closed()
        return port

    port = _run(dead_port())
    out = _run(_drain_scenario(
        weights[1], prompts=PROMPTS[1:2], sampled=False,
        peers=lambda: [{"host": "127.0.0.1", "port": port, "engine_id": "x"}]))
    assert out["summary"]["migrated"] == 0 and out["summary"]["failed"] == 1
    toks, finish = out["streams"][0]
    assert finish == "error" and LIVE <= len(toks) < NEW
    assert out["src_used"] == 0
    assert ('dynamo_recovery_migrations_total{mode="hot",outcome="failed"} 1.0'
            in out["registry"])


def test_wedge_trips_seizes_hard_migrates_cold_and_respawns(weights, baseline):
    """``decode_burst_hang`` wedges the source's decode sync: exactly one
    ``decode_stall`` trip, the hard seize, every request migrates cold and
    streams on, the respawner runs and the hooks run deregister before
    register; the draining snapshot keeps the KV router off the sick worker;
    after the release no block stays in use."""
    async def go():
        src = await _engine(weights[1])
        src.scheduler.flight = FlightRecorder()
        dst = await _engine(weights[1])
        server = await MigrationServer(MigrationSink(dst.scheduler,
                                                     dst.runner)).start()
        wd = StallWatchdog(probe=src.scheduler.watchdog_probe,
                           requests=src.scheduler.request_table,
                           flight=src.scheduler.flight, interval_s=0.02,
                           stall_s=0.15).start()
        hooks, respawned = [], []

        async def respawner():
            respawned.append(1)

        async def register():
            hooks.append("register")

        async def deregister():
            hooks.append("deregister")

        ctl = RecoveryController(
            engine_id="src", scheduler=src.scheduler, runner=src.runner,
            watchdog=wd, respawner=respawner, register=register,
            deregister=deregister,
            peers=lambda: [{"host": server.host, "port": server.port,
                            "engine_id": "dst"}],
            config=RecoveryConfig(drain_grace_s=0.05, respawn_backoff_s=0.01),
            flight=src.scheduler.flight).attach()
        got = [[[], None] for _ in PROMPTS]

        async def one(i, prompt):
            async for out in src.generate(Context(_req(prompt))):
                got[i][0].extend(out["token_ids"])
                got[i][1] = out.get("finish_reason") or got[i][1]

        tasks = [asyncio.ensure_future(one(i, p)) for i, p in enumerate(PROMPTS)]
        try:
            while min(len(g[0]) for g in got) < LIVE:
                await asyncio.sleep(0.002)
            faults.arm("decode_burst_hang", "once")
            await asyncio.gather(*tasks)
            while not ctl.recoveries:
                await asyncio.sleep(0.01)
            sick = ForwardPassMetrics.from_wire(src.metrics())
            out = dict(streams=[tuple(g) for g in got],
                       trips=[t["reason"] for t in wd.trips],
                       summary=ctl.recoveries[0], hooks=hooks,
                       respawned=bool(respawned), sick=sick,
                       kinds=[e["kind"] for e in src.scheduler.flight.snapshot()],
                       registry=ctl.registry.render())
        finally:
            faults.release()
            await wd.stop()
            await ctl.close()
            await server.close()
            await dst.close()
            await src.close()
        out["src_used"] = src.scheduler.allocator.used
        out["dst_used"] = dst.scheduler.allocator.used
        return out

    out = _run(go())
    assert out["trips"] == ["decode_stall"]
    s = out["summary"]
    assert (s["reason"], s["hard"], s["migrated"], s["failed"], s["respawned"]) \
        == ("decode_stall", True, len(PROMPTS), 0, True)
    assert out["respawned"] and out["hooks"] == ["deregister", "register"]
    assert [t for t, _ in out["streams"]] == [t for t, _ in baseline["port"]]
    assert ('dynamo_recovery_migrations_total{mode="cold",outcome="committed"} 3.0'
            in out["registry"])
    assert out["kinds"].count("scheduler.extract") == len(PROMPTS)
    assert "scheduler.burst_abandon" not in out["kinds"]  # the sync path
    assert out["sick"].draining is True
    ks = KvScheduler(block_size=8)
    ks.update_metrics("src", out["sick"])
    ks.update_metrics("dst", ForwardPassMetrics(request_total_slots=4,
                                                kv_total_blocks=64))
    for _ in range(10):
        assert ks.schedule(16, OverlapScores()).worker_id == "dst"
    assert out["src_used"] == 0 and out["dst_used"] == 0


def test_hard_seize_abandons_the_chained_bursts(weights, baseline,
                                               monkeypatch):
    """A hard seize of a chained source with bursts queued abandons them
    (``scheduler.burst_abandon``): their tokens never reach a stream, and
    the cold migration continues every stream as the undisturbed run. (On
    the CPU a burst's outputs are ready at once; holding ``ready()`` false
    keeps the chain's queue at its bound, as a busy card does.)"""
    from dynamo_tpu_torch.engine import model_runner

    monkeypatch.setattr(model_runner.HostCopy, "ready", lambda self: False)
    ring = FlightRecorder()

    def private_ring(src, dst, sink):
        src.scheduler.flight = ring

    out = _run(_drain_scenario(weights[1], hard=True, src_kw=CHAINED,
                               sampled=False, capture=private_ring))
    assert out["streams"] == baseline["port"]
    (abandon,) = [e for e in ring.snapshot()
                  if e["kind"] == "scheduler.burst_abandon"]
    assert abandon["data"]["chained"] >= 1
    assert [e["kind"] for e in ring.snapshot()].count(
        "scheduler.extract") == len(PROMPTS)


# ------------------------------------------------------------ failure paths


async def _dst(params, **kw):
    engine = await _engine(params, **kw)
    return engine, MigrationSink(engine.scheduler, engine.runner)


def _state(prompt, committed=(), resume=(), bs=8, generated=2):
    return MigrationState(
        request_id="m1", trace_id="t1", req=_req(prompt).to_wire(),
        committed_tokens=list(committed), resume_tokens=list(resume),
        pending_token=7 if committed else -1, generated=generated,
        base_key=[1, 2], prompt_lps_emitted=False, kv_block_size=bs)


def test_receiver_poisons_a_partial_migration(weights):
    """The sender dies between its begin and its commit: the reservation is
    freed and nothing is installed."""
    async def go():
        engine, sink = await _dst(weights[1])
        server = await MigrationServer(sink).start()
        try:
            reader, writer = await asyncio.open_connection(server.host,
                                                           server.port)
            pack_frame(writer, {"type": "mig_begin", "nblocks": 2,
                                "state": _state([1, 2, 3], [1, 2, 3, 9]).to_wire()})
            await writer.drain()
            ack = await read_header(reader, "migration")
            held = engine.scheduler.allocator.used
            writer.close()
            while engine.scheduler.allocator.used:
                await asyncio.sleep(0.01)
            return ack, held, engine.scheduler.slots
        finally:
            await server.close()
            await engine.close()

    ack, held, slots = _run(go())
    assert ack["ok"] and held == 2
    assert all(s is None for s in slots)


@pytest.mark.parametrize("case", ["hot_past_len", "cold_past_len",
                                  "table_width", "block_size", "draining"])
def test_receiver_nacks_what_it_cannot_hold(weights, case):
    """The geometry and capacity gate nacks before anything mutates: a
    sequence at the peer's horizon (hot and cold), more blocks than its
    table holds, another ``kv_block_size``, a peer that is itself
    draining."""
    async def go():
        engine, sink = await _dst(weights[1], max_model_len=64)
        cfg = engine.config
        state, n = {
            "hot_past_len": (_state(range(1, 10), range(1, 101)), 13),
            "cold_past_len": (_state(range(1, 60), resume=range(1, 10)), 0),
            "table_width": (_state([1, 2, 3], [1, 2, 3, 4]),
                            cfg.blocks_per_seq + 1),
            "block_size": (_state([1, 2, 3], [1, 2, 3, 4], bs=16), 1),
            "draining": (_state([1, 2, 3], [1, 2, 3, 4]), 1),
        }[case]
        if case == "draining":
            engine.scheduler.set_draining(True)
        try:
            with pytest.raises(MigrationRejected):
                sink.reserve(state, n)
            return engine.scheduler.allocator.used, engine.scheduler.slots
        finally:
            await engine.close()

    used, slots = _run(go())
    assert used == 0 and all(s is None for s in slots)


async def test_respawn_backoff_doubles_and_gives_up_at_the_budget(monkeypatch):
    delays = []
    real_sleep = asyncio.sleep

    async def fake_sleep(d):
        delays.append(d)
        await real_sleep(0)

    monkeypatch.setattr(asyncio, "sleep", fake_sleep)
    calls = []

    async def bad_respawner():
        calls.append(1)
        raise RuntimeError("spawn failed")

    c = RecoveryController(respawner=bad_respawner, config=RecoveryConfig(
        respawn_backoff_s=0.01, max_respawns=3))
    assert await c._respawn("test") is False
    assert len(calls) == 3 and delays == [0.01, 0.02, 0.04]
    assert c.consecutive_respawn_failures == 3
    assert ('dynamo_recovery_actions_total{action="respawn",outcome="gave_up"} 1.0'
            in c.registry.render())


async def test_respawn_success_resets_the_budget_and_registers():
    registered = []

    async def register():
        registered.append(1)

    async def good():
        return None

    c = RecoveryController(respawner=good, register=register,
                           config=RecoveryConfig(respawn_backoff_s=0.01))
    c.consecutive_respawn_failures = 2
    assert await c._respawn("test") is True
    assert c.consecutive_respawn_failures == 0 and registered == [1]


async def test_trip_reasons_that_start_the_ladder():
    """Only engine wedges start a recovery; the event loop's own lag does
    not; a recovery already running is not started twice; an ici plane is
    refused by name."""
    c = RecoveryController()
    started = []
    c._start_recovery = started.append
    for reason in ("event_loop_lag", "decode_stall", "no_throughput"):
        c.on_trip({"reason": reason})
    assert started == ["decode_stall", "no_throughput"]
    with pytest.raises(NotImplementedError, match="ici"):
        RecoveryController(ici=object())
    with pytest.raises(NotImplementedError, match="ici"):
        MigrationServer(None, ici=object())


def test_draining_engine_raises_the_retryable_error(weights):
    async def go():
        engine = await _engine(weights[1])
        try:
            engine.scheduler.set_draining(True)
            with pytest.raises(EngineDrainingError):
                async for _ in engine.generate(Context(_req([1, 2, 3]))):
                    pass
            assert engine.metrics()["draining"] is True
            assert engine.scheduler.watchdog_probe()["stopping"] is True
            engine.scheduler.set_draining(False)
            return await _stream(engine, [1, 2, 3])
        finally:
            await engine.close()

    toks, finish = _run(go())
    assert len(toks) == NEW and finish == "length"


def test_http_answers_503_while_draining_and_admin_drain_needs_a_controller():
    """A draining engine's request is a 503 with Retry-After and the
    reference's error type; /admin/drain is 501 without a drainer, runs it
    with the query's mode and respawn, and refuses a bad mode with 400."""
    from dynamo_tpu_torch.http.service import HttpService, ModelManager

    class DrainingEngine:
        def generate(self, ctx):
            async def gen():
                raise EngineDrainingError("engine is draining")
                yield  # pragma: no cover

            return gen()

    calls = {}

    async def drainer(mode, respawn):
        calls.update(mode=mode, respawn=respawn)
        return {"migrated": 2, "failed": 0}

    async def go():
        manager = ModelManager()
        manager.add_chat_model("m", DrainingEngine())
        service = HttpService(manager, host="127.0.0.1", port=0)
        await service.start()
        out = []
        try:
            async with aiohttp.ClientSession() as s:
                base = f"http://127.0.0.1:{service.port}"
                for stream in (False, True):
                    async with s.post(f"{base}/v1/chat/completions", json={
                            "model": "m", "stream": stream,
                            "messages": [{"role": "user", "content": "hi"}]}) as r:
                        out.append((r.status, r.headers.get("Retry-After"),
                                    (await r.json())["error"]["type"]))
                async with s.post(f"{base}/admin/drain") as r:
                    out.append(r.status)
                service.drainer = drainer
                async with s.post(f"{base}/admin/drain?mode=migrate&respawn=1") as r:
                    out.append((r.status, await r.json()))
                async with s.post(f"{base}/admin/drain?mode=bogus") as r:
                    out.append(r.status)
        finally:
            await service.stop()
        return out

    out = _run(go())
    assert out == [(503, "1", "service_unavailable"),
                   (503, "1", "service_unavailable"), 501,
                   (200, {"migrated": 2, "failed": 0}), 400]
    assert calls == {"mode": "migrate", "respawn": True}


def test_kv_router_never_picks_a_draining_port_worker(weights):
    """A port engine's draining snapshot keeps the port's KV router off it;
    with every worker draining there is nobody to pick."""
    async def go():
        engine = await _engine(weights[1])
        try:
            healthy = ForwardPassMetrics.from_wire(engine.metrics())
            engine.scheduler.set_draining(True)
            return healthy, ForwardPassMetrics.from_wire(engine.metrics())
        finally:
            await engine.close()

    healthy, sick = _run(go())
    assert healthy.draining is False and sick.draining is True
    ks = KvScheduler(block_size=8)
    ks.update_metrics("sick", sick)
    ks.update_metrics("ok", healthy)
    for _ in range(20):
        assert ks.schedule(32, OverlapScores()).worker_id == "ok"
    assert ks.draining_skips == 20
    ks.update_metrics("ok", sick)
    with pytest.raises(AllWorkersBusy):
        ks.schedule(32, OverlapScores())


def test_migration_connections_read_a_frame_in_a_few_loop_turns():
    """``widen_stream`` raises a connection's socket buffers and its
    transport's read size (256 KiB a turn by default), so a peer that
    decodes between turns still reads a 32 MiB frame in a few of them."""
    from dynamo_tpu_torch.transfer.framing import WIDE_IO_BYTES, widen_stream

    async def go():
        got = {}

        async def handle(reader, writer):
            widen_stream(writer)
            got["max_size"] = writer.transport.max_size
            got["rcvbuf"] = writer.get_extra_info("socket").getsockopt(
                socket.SOL_SOCKET, socket.SO_RCVBUF)
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        _, writer = await asyncio.open_connection(
            "127.0.0.1", server.sockets[0].getsockname()[1])
        before = writer.get_extra_info("socket").getsockopt(
            socket.SOL_SOCKET, socket.SO_RCVBUF)
        while not got:
            await asyncio.sleep(0.01)
        writer.close()
        server.close()
        await server.wait_closed()
        return got, before

    got, before = _run(go())
    assert got["max_size"] == WIDE_IO_BYTES
    assert got["rcvbuf"] > before


# ----------------------------------------------------------------- re-bind


def test_rebind_ends_the_relay_before_the_stream_ends(weights, baseline,
                                                      monkeypatch):
    """A ``follow_migrated_stream`` consumer sees the ``migrated`` frame and
    attaches to the peer; the peer's decode is held until the attach is
    acknowledged, so the handoff lands mid-stream by construction: the
    source's relay ends (``recovery.migrate_handoff``) while the peer still
    has tokens to send, and the stream equals the undisturbed one, its
    peer spans folded in."""
    real_open = port_migration._open_attach

    async def go():
        gate = asyncio.Event()

        async def open_attach(info, *a, **kw):
            out = await real_open(info, *a, **kw)
            gate.set()  # the peer acknowledged the attach
            return out

        monkeypatch.setattr(port_migration, "_open_attach", open_attach)
        src = await _engine(weights[1])
        dst = await _engine(weights[1])
        real_decode = dst.scheduler._decode

        async def gated_decode(*a, **kw):
            await gate.wait()
            return await real_decode(*a, **kw)

        dst.scheduler._decode = gated_decode
        server = await MigrationServer(MigrationSink(dst.scheduler,
                                                     dst.runner)).start()
        ctl = RecoveryController(
            engine_id="src", scheduler=src.scheduler, runner=src.runner,
            peers=lambda: [{"host": server.host, "port": server.port,
                            "engine_id": "dst"}],
            config=RecoveryConfig(drain_grace_s=0.0))
        ctx = AsyncEngineContext()
        toks, finish = [], None
        relay_ended_at = []

        async def consume():
            nonlocal finish
            stream = port_migration.follow_migrated_stream(
                src.generate(Context(_req(PROMPTS[0]), ctx)), ctx=ctx)
            async for out in stream:
                assert out.migrated is None, "the control frame leaked"
                toks.extend(out.token_ids)
                finish = out.finish_reason or finish

        task = asyncio.ensure_future(consume())
        try:
            while len(toks) < LIVE:
                await asyncio.sleep(0.002)
            summary = await ctl.drain()
            (relay,) = ctl._relays
            await asyncio.wait({relay})
            relay_ended_at.append(len(toks))
            await task
            kinds = [e["kind"] for e in flight_recorder().snapshot()]
            return (summary, toks, finish, relay_ended_at[0], kinds,
                    list(ctx.remote_spans), src.scheduler.allocator.used,
                    dst.scheduler)
        finally:
            await ctl.close()
            await server.close()
            await dst.close()
            await src.close()

    summary, toks, finish, relay_end, kinds, spans, src_used, dst_sched = _run(go())
    assert summary["migrated"] == 1
    assert (toks, finish) == (baseline["port"][0][0], FinishReason.LENGTH)
    assert "recovery.migrate_handoff" in kinds
    assert relay_end < NEW, "the relay only ended with the stream"
    peer = [s for s in spans if s["source"] == "migration_peer"]
    assert peer and "migration.resume" in [n for n, _ in peer[0]["spans"]]
    assert src_used == 0 and dst_sched.allocator.used == 0


async def test_rebind_attach_failure_falls_back_to_the_relay():
    """A consumer that cannot reach the peer keeps the relayed stream, with
    nothing lost and no error."""
    async def fake_stream():
        yield EngineOutput(token_ids=[1])
        yield EngineOutput(migrated={"host": "127.0.0.1", "port": 9,
                                     "resume_id": "x"})
        yield EngineOutput(token_ids=[2]).to_wire()
        yield EngineOutput(token_ids=[3], finish_reason=FinishReason.LENGTH)

    toks, finish = [], None
    async for out in port_migration.follow_migrated_stream(fake_stream()):
        toks.extend(out.token_ids)
        finish = out.finish_reason or finish
    assert toks == [1, 2, 3] and finish == FinishReason.LENGTH


# -------------------------------------------------------------- cache forms


def _capture_installs(record):
    """Wrap the peer sink's scatter: after each frame lands, read the
    installed blocks back from the peer's cache (bytes), beside the frame."""
    def capture(src, dst, sink):
        real = sink.scatter

        async def scatter(mig_id, offset, k, v):
            await real(mig_id, offset, k, v)
            ids = sink._pending[mig_id][1][offset:offset + k.shape[1]]
            got = dst.runner.gather_blocks(ids)
            record.append(((k, v), got))

        sink.scatter = scatter

    return capture


def _byte_view(t):
    return t.contiguous().view(-1).view(torch.uint8)


def test_fp8_cache_migrates_hot_with_its_bytes(weights):
    """Over e4m3 caches, the installed blocks are the shipped bytes, and the
    streams equal an undisturbed fp8 engine's."""
    async def undisturbed():
        engine = await _engine(weights[1], kv_cache_dtype="fp8")
        try:
            return [await _stream(engine, p) for p in PROMPTS[:2]]
        finally:
            await engine.close()

    want = _run(undisturbed())
    record = []
    out = _run(_drain_scenario(
        weights[1], prompts=PROMPTS[:2], sampled=False,
        src_kw=dict(kv_cache_dtype="fp8"), dst_kw=dict(kv_cache_dtype="fp8"),
        capture=_capture_installs(record)))
    assert out["summary"]["migrated"] == 2
    assert out["streams"] == want
    assert record and all(k.dtype == torch.float8_e4m3fn for (k, _), _ in record)
    for (k, v), (gk, gv) in record:
        assert torch.equal(_byte_view(k), _byte_view(gk))
        assert torch.equal(_byte_view(v), _byte_view(gv))


def test_mla_pair_migrates_hot_where_the_reference_frame_cannot(weights):
    """A DeepSeek ``(c_kv, k_rope)`` cache pair: the port's frame carries
    V's shape, so the request migrates hot, byte for byte, and streams as
    undisturbed. The reference's frame carries K's shape only: its receiver
    cannot view the same pair (the fault ROADMAP records)."""
    params = ModelRunner(_cfg(DEEPSEEK), device="cpu").params

    async def undisturbed():
        engine = await _engine(params, DEEPSEEK)
        try:
            return [await _stream(engine, p) for p in PROMPTS[1:]]
        finally:
            await engine.close()

    want = _run(undisturbed())
    record = []
    out = _run(_drain_scenario(params, model=DEEPSEEK, prompts=PROMPTS[1:],
                               sampled=False,
                               capture=_capture_installs(record)))
    assert out["summary"]["migrated"] == 2 and out["summary"]["failed"] == 0
    assert out["streams"] == want
    assert out["src_used"] == 0 and out["dst_used"] == 0
    (k, v), (gk, gv) = record[0]
    assert k.shape[-1] != v.shape[-1]  # c_kv's rank 32, k_rope's 8
    assert torch.equal(k, gk) and torch.equal(v, gv)

    async def reference_frame():
        frames = []

        async def handle(reader, writer):
            header = await read_header(reader)
            try:
                frames.append(await RefTcp.recv_blocks(reader, header))
            except Exception as e:  # the reference's receiver fails here
                frames.append(e)
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        _, writer = await asyncio.open_connection(
            "127.0.0.1", server.sockets[0].getsockname()[1])
        await RefTcp.send_blocks(writer, {"type": "mig_blocks", "offset": 0},
                                 k.numpy(), v.numpy())
        while not frames:
            await asyncio.sleep(0.01)
        writer.close()
        server.close()
        await server.wait_closed()
        return frames[0]

    got = _run(reference_frame())
    assert isinstance(got, ValueError)


# --------------------------------------------------------------------- CLI

RECOVERY_FLAGS = {  # flag → (a value, the RecoveryConfig field or None)
    "--flight-dir": ("/tmp/flights", None),
    "--watchdog-stall-s": ("0", None),
    "--self-heal": (None, None),
    "--drain-grace-s": ("0.2", "drain_grace_s"),
    "--respawn-max": ("5", "max_respawns"),
    "--respawn-backoff-s": ("0.5", "respawn_backoff_s"),
    "--migrate-peers": ("10.0.0.2:8391,10.0.0.3:8392", None),
    "--migrate-port": ("8391", None),
}


def _tiny_model_dir(tmp_path):
    d = make_model_dir(tmp_path, config_overrides=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=512,
        max_position_embeddings=512))
    extra = Path(d) / "f32.json"
    extra.write_text(json.dumps({"dtype": "float32"}))
    return d, str(extra)


@pytest.mark.parametrize("flag", sorted(RECOVERY_FLAGS))
def test_cli_recovery_flags_map_as_the_reference(tmp_path, flag):
    """Each of the eight recovery flags, given and left at its default,
    lands on the reference parser's field with the reference's value; the
    watchdog's deadline (an explicit 0 included) reaches the same
    ``EngineConfig`` field, and ``--self-heal``'s wiring builds the same
    ``RecoveryConfig`` and static peers as the reference's."""
    from dynamo_tpu.cli import run as ref_run
    from dynamo_tpu.engine.serving import engine_config_from_mdc as ref_config
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.engine.serving import engine_config_from_mdc
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    value, field = RECOVERY_FLAGS[flag]
    assert flag not in run.REFUSED_FLAGS
    d, _ = _tiny_model_dir(tmp_path)
    for argv in ([], [flag] + ([value] if value is not None else [])):
        argv = argv + ["--max-model-len", "64"]
        want = ref_run.build_parser().parse_args(argv)
        got = run.parse_flags(argv)
        dest = flag[2:].replace("-", "_")
        assert getattr(got, dest) == getattr(want, dest), (argv, dest)
        assert (engine_config_from_mdc(ModelDeploymentCard.from_local_path(d),
                                       got).watchdog_stall_s
                == ref_config(RefCard.from_local_path(d), want).watchdog_stall_s)

        async def wiring(mod, flags):
            core = types.SimpleNamespace(
                scheduler=types.SimpleNamespace(config=None), runner=None)
            flags.migrate_port = 0  # bind an ephemeral port
            ctl, server = await mod._setup_self_healing(flags, core)
            try:
                return dataclasses.asdict(ctl.config), ctl.peers()
            finally:
                await server.close()

        got_w = _run(wiring(run, got))
        want_w = _run(wiring(ref_run, want))
        assert got_w == want_w
        if field is not None and flag in argv:
            assert got_w[0][field] == type(got_w[0][field])(value)


def _cli(args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    return subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.run", *args],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _listening(proc, deadline):
    line = ""
    while "listening on" not in line:
        assert time.monotonic() < deadline, "the CLI never listened"
        line = proc.stdout.readline()
        if not line and proc.poll() is not None:
            raise AssertionError(proc.stderr.read())
    return int(line.strip().rsplit(":", 1)[1])


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_self_heal_drains_a_streamed_chat_to_a_peer(tmp_path):
    """Two ``in=http out=torch --self-heal`` engines on the CPU: B receives
    migrations, A names B as its peer. A streamed chat on A, then
    ``POST /admin/drain`` on A: one hot migration, the stream runs to
    ``[DONE]`` with no error and B's undisturbed text, A answers 503 with
    Retry-After after, and A's /metrics counts the committed hot migration;
    both exit 0 on SIGINT."""
    d, extra = _tiny_model_dir(tmp_path)
    mig_b = _free_port()
    common = ["in=http", "out=torch", "--model-path", d, "--device", "cpu",
              "--allow-random-weights", "--extra-engine-args", extra,
              "--max-model-len", "256", "--num-kv-blocks", "128",
              "--kv-block-size", "8", "--http-host", "127.0.0.1",
              "--http-port", "0", "--self-heal", "--advertise-host",
              "127.0.0.1"]
    b = _cli(common + ["--migrate-port", str(mig_b)])
    a = _cli(common + ["--migrate-peers", f"127.0.0.1:{mig_b}",
                       "--drain-grace-s", "0"])
    body = {"model": "tiny-llama", "stream": True, "max_tokens": 200,
            "temperature": 0.0, "ignore_eos": True,
            "messages": [{"role": "user", "content": "the quick brown fox"}]}
    try:
        deadline = time.monotonic() + 180
        port_b, port_a = _listening(b, deadline), _listening(a, deadline)

        async def drive():
            async with aiohttp.ClientSession() as s:
                chunks, drained = [], None
                async with s.post(f"http://127.0.0.1:{port_a}/v1/chat/completions",
                                  json=body) as r:
                    assert r.status == 200
                    async for line in r.content:
                        line = line.decode().strip()
                        if not line.startswith("data: "):
                            continue
                        chunks.append(line[6:])
                        if len(chunks) == 3 and drained is None:
                            async with s.post(f"http://127.0.0.1:{port_a}"
                                              "/admin/drain") as dr:
                                drained = (dr.status, await dr.json())
                async with s.post(f"http://127.0.0.1:{port_a}/v1/chat/completions",
                                  json=dict(body, stream=False)) as r:
                    refused = (r.status, r.headers.get("Retry-After"))
                async with s.get(f"http://127.0.0.1:{port_a}/metrics") as r:
                    metrics = await r.text()
                async with s.post(f"http://127.0.0.1:{port_b}/v1/chat/completions",
                                  json=dict(body, stream=False)) as r:
                    direct = await r.json()
            return chunks, drained, refused, metrics, direct

        chunks, drained, refused, metrics, direct = asyncio.run(
            asyncio.wait_for(drive(), TIMEOUT_S))
        assert drained[0] == 200
        assert (drained[1]["migrated"], drained[1]["failed"]) == (1, 0)
        assert chunks[-1] == "[DONE]"
        parsed = [json.loads(c) for c in chunks[:-1]]
        assert not any("error" in c for c in parsed)
        text = "".join(c["choices"][0]["delta"].get("content") or ""
                       for c in parsed if c.get("choices"))
        assert text == direct["choices"][0]["message"]["content"]
        assert direct["usage"]["completion_tokens"] == 200
        assert refused == (503, "1")
        assert ('dynamo_recovery_migrations_total{mode="hot",outcome="committed"} '
                '1.0') in metrics
        for proc in (a, b):
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        for proc in (a, b):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_wedge_autoproduces_one_incident_bundle(weights, tmp_path):
    """``decode_burst_hang`` wedges a CPU engine under an incident recorder
    wired as the CLI wires it (the watchdog's trips, the recovery ladder's
    drains, a local history sampler): the trip and the drain that follows
    fold into EXACTLY ONE bundle (manifest, flight, history and traces),
    which carries the wedged request and lists at /debug/incidents."""
    from dynamo_tpu_torch.telemetry.history import (
        LocalHistorySampler,
        MetricHistory,
    )
    from dynamo_tpu_torch.telemetry.incidents import (
        IncidentConfig,
        IncidentRecorder,
        load_bundle_dir,
    )
    from dynamo_tpu_torch.telemetry.tracing import TraceRecorder

    async def go():
        src = await _engine(weights[1])
        dst = await _engine(weights[1])
        server = await MigrationServer(MigrationSink(dst.scheduler,
                                                     dst.runner)).start()
        wd = StallWatchdog(probe=src.scheduler.watchdog_probe,
                           requests=src.scheduler.request_table,
                           registry=src.scheduler.registry,
                           flight=src.scheduler.flight, interval_s=0.02,
                           stall_s=0.15).start()
        ctl = RecoveryController(
            engine_id="src", scheduler=src.scheduler, runner=src.runner,
            watchdog=wd,
            peers=lambda: [{"host": server.host, "port": server.port,
                            "engine_id": "dst"}],
            config=RecoveryConfig(drain_grace_s=0.05, respawn_backoff_s=0.01),
            flight=src.scheduler.flight).attach()
        recorder = IncidentRecorder(
            IncidentConfig(out_dir=str(tmp_path), settle_s=1.0),
            history=MetricHistory(window_s=600.0))
        recorder.watch_watchdog(wd)
        recorder.watch_recovery(ctl)
        sampler = LocalHistorySampler(src.scheduler.registry,
                                      history=recorder.history,
                                      interval_s=0.03).start()
        tracer = TraceRecorder(capacity=8, jsonl_path="")
        ctx = Context(_req(PROMPTS[1]))
        toks, armed = [], False
        try:
            async for out in src.generate(ctx):
                toks.extend(out["token_ids"])
                if len(toks) >= LIVE and not armed:
                    armed = True
                    faults.arm("decode_burst_hang", "once")
            tracer.record(ctx.context.trace_id, "m", "success",
                          list(ctx.context.stages), ctx=ctx.context)
            for _ in range(200):
                if recorder.captures:
                    break
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.3)  # a second capture would land by now
            return (toks, list(recorder.bundles), recorder.suppressed,
                    recorder.list_bundles(), ctx.context.trace_id,
                    [t["reason"] for t in wd.trips])
        finally:
            faults.release()
            await sampler.stop()
            await recorder.stop()
            tracer.close()
            await wd.stop()
            await ctl.close()
            await server.close()
            await dst.close()
            await src.close()

    toks, bundles, suppressed, listed, trace_id, trips = _run(go())
    assert len(toks) == NEW and trips == ["decode_stall"]
    (manifest,) = bundles
    assert manifest["reason"] == "decode_stall" and suppressed >= 1
    assert sorted(os.listdir(manifest["path"])) == [
        "flight.json", "history.json", "manifest.json", "traces.json"]
    bundle = load_bundle_dir(manifest["path"])
    kinds = {e["kind"] for e in bundle["flight"]["events"]}
    assert "watchdog.trip" in kinds
    assert bundle["history"]["series"]
    assert trace_id in [t["request_id"] for t in bundle["traces"]]
    assert [m["bundle"] for m in listed] == [manifest["bundle"]]
