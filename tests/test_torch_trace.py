"""Cross-process traces: the port's stitching against the reference's, and
the span sets each plane carries.

- ``telemetry/stitch.py``: ``estimate_offset``, ``remote_span_set`` and
  ``stitched_timeline`` / ``timeline_gaps`` over the same seeded nested
  span sets (exact equality: the same float arithmetic);
- the dial-back stream's end frame: a client folds the worker's spans with
  an offset whose error bound (half the round trip) covers the true skew
  of 0 on one host;
- the disaggregated pair: a remote prefill's trace nests the prefill
  worker's ``prefill.dequeue → prefill.compute → prefill.transfer`` inside
  the decode engine's ``kv_transfer`` span, as the reference's pair does;
- the migration plane: a drained request's trace carries the peer's span
  set with the hop's offset from the begin / ack pair.
"""

import asyncio
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.disagg import DisaggRouter as RefRouter
from dynamo_tpu.disagg import PrefillWorker as RefPrefillWorker
from dynamo_tpu.disagg import RemotePrefillCoordinator as RefCoordinator
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime import DistributedRuntime as RefDrt
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.transports.memory import MemoryHub as RefHub
from dynamo_tpu.telemetry import stitch as ref_stitch
from dynamo_tpu.telemetry import tracing as ref_tracing
from dynamo_tpu_torch import runtime as port_rt
from dynamo_tpu_torch.disagg import (
    DisaggRouter,
    PrefillWorker,
    RemotePrefillCoordinator,
)
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.recovery import (
    MigrationServer,
    MigrationSink,
    RecoveryConfig,
    RecoveryController,
)
from dynamo_tpu_torch.recovery import migration as port_migration
from dynamo_tpu_torch.runtime.client import Client as PortClient
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.memory import MemoryHub
from dynamo_tpu_torch.telemetry import stitch as port_stitch
from dynamo_tpu_torch.telemetry import tracing as port_tracing

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=256)
BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32")


def _run(coro, timeout=120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# ---------- the stitching math ----------

def _span_set(mod, rng, source, depth, t0):
    """A seeded remote span set with nested children, folded by ``mod``."""
    skew = float(rng.uniform(-2.0, 2.0))
    sent = t0 + float(rng.uniform(0.0, 0.01))
    recv = sent + skew + float(rng.uniform(0.0005, 0.003))
    marks, t = [], recv
    for name in ("dequeue", "compute", "transfer")[: int(rng.integers(1, 4))]:
        t += float(rng.uniform(0.001, 0.05))
        marks.append([f"{source}.{name}", t])
    resp = t + float(rng.uniform(0.0, 0.001))
    back = resp - skew + float(rng.uniform(0.0005, 0.003))
    children = ([_span_set(mod, rng, f"{source}_child", depth - 1, recv)]
                if depth > 0 else [])
    return mod.remote_span_set(source, marks, recv, resp, sent, back,
                               children=children,
                               queued_forward=bool(rng.random() < 0.5))


def _trace(mod, seed, depth, n_remote):
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    spans = ref_tracing.span_breakdown(
        [("http", 5.0), ("admission", 5.01), ("first_token", 5.2),
         ("completion", 5.5)], 5.6)
    remote = [_span_set(mod, rng, f"hop{i}", depth, t0)
              for i in range(n_remote)]
    return {"request_id": "r", "t0_wall": t0, "spans": spans,
            "remote": remote}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("depth,n_remote", [(0, 1), (2, 1), (1, 3)],
                         ids=["flat", "nested", "fanout"])
def test_stitched_timeline_equal(seed, depth, n_remote):
    port = _trace(port_stitch, seed, depth, n_remote)
    ref = _trace(ref_stitch, seed, depth, n_remote)
    assert port == ref  # remote_span_set folds identically
    ps, rs = port_stitch.stitched_timeline(port), ref_stitch.stitched_timeline(ref)
    assert ps == rs
    assert (port_stitch.timeline_gaps(ps["timeline"], 0.0005)
            == ref_stitch.timeline_gaps(rs["timeline"], 0.0005))


@pytest.mark.parametrize("legs", [(0.0, 0.1, 0.3, 0.45), (5.0, 7.1, 8.0, 3.2),
                                  (1.0, 0.5, 0.9, 1.6)])
def test_offset_estimates_equal(legs):
    assert port_stitch.estimate_offset(*legs) == ref_stitch.estimate_offset(*legs)
    assert (port_stitch.estimate_offset_return_leg(*legs[2:])
            == ref_stitch.estimate_offset_return_leg(*legs[2:]))


def test_stitcher_stops_at_the_hop_bound():
    deep = {"source": "x", "spans": [["m", 1.0]], "children": []}
    node = deep
    for _ in range(port_stitch.MAX_HOP_DEPTH + 3):
        node = {"source": "x", "spans": [["m", 1.0]], "children": [node]}
    trace = {"t0_wall": 0.0, "spans": [], "remote": [node]}
    assert (port_stitch.stitched_timeline(trace)
            == ref_stitch.stitched_timeline(trace))
    assert len(port_stitch.stitched_timeline(trace)["sources"]) == \
        port_stitch.MAX_HOP_DEPTH + 1


# ---------- the dial-back end frame ----------

def test_client_folds_the_end_frame_with_an_offset():
    """The worker's marks ride the end frame; the client folds them with an
    offset estimate whose error bound is half the round trip (one host: the
    true offset is 0)."""
    async def handler(payload, ctx):
        ctx.add_stage("worker.start")
        for tok in payload["text"].split():
            yield {"tok": tok}
        ctx.add_stage("worker.done")

    async def main():
        drt = port_rt.DistributedRuntime.in_process(MemoryHub())
        ep = drt.namespace("t").component("w").endpoint("generate")
        serving = await ep.serve(handler, span_source="decode_engine")
        client = await PortClient(ep).start()
        await client.wait_for_instances(1)
        req = port_rt.Context({"text": "a b c"})
        out = [x["tok"] async for x in client.generate(req)]
        await serving.stop()
        await drt.close()
        return out, req.context.remote_spans

    out, remote = _run(main())
    assert out == ["a", "b", "c"]
    (rs,) = remote
    assert rs["source"] == "decode_engine"
    assert [n for n, _ in rs["spans"]] == ["worker.start", "worker.done"]
    assert rs["rtt_s"] >= 0.0
    assert abs(rs["offset_s"]) <= rs["rtt_s"] / 2 + 1e-3
    assert set(rs) == {"source", "spans", "recv_at", "resp_sent_at",
                       "offset_s", "rtt_s", "children"}


# ---------- the disaggregated pair ----------

@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(5),
                                   jnp.float32)
    return params, from_jax_params(jax.device_get(params), ModelConfig(**TINY),
                                   "cpu", "float32")


PROMPT = [1 + (i * 29) % 300 for i in range(30)]


async def _port_remote_ctx(params):
    hub = MemoryHub()
    drt = port_rt.DistributedRuntime.in_process(hub)
    drt_p = port_rt.DistributedRuntime.in_process(hub)
    cfg = EngineConfig(model=ModelConfig(**TINY), **BASE)

    async def factory(runner):
        return await RemotePrefillCoordinator(
            drt, runner, router=DisaggRouter(max_local_prefill_length=0,
                                             max_prefill_queue_size=100),
            depth_refresh_s=0.05).start()

    engine = await TorchServingEngine.create(
        cfg, params=params, device="cpu", warmup=False, disagg_factory=factory)
    worker = PrefillWorker(drt_p, ModelRunner(cfg, params=params, device="cpu"),
                           cfg)
    task = asyncio.ensure_future(worker.run())
    try:
        ctx = Context(PreprocessedRequest(
            token_ids=PROMPT,
            stop_conditions=StopConditions(max_tokens=4, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0)))
        async for _ in engine.generate(ctx):
            pass
        return ctx.context, worker.registry.render()
    finally:
        worker.stop()
        await task
        await worker.close()
        await engine.close()
        await drt_p.close()
        await drt.close()


async def _ref_remote_ctx(params):
    hub = RefHub()
    drt, drt_p = RefDrt.in_process(hub), RefDrt.in_process(hub)
    cfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **BASE)

    async def factory(runner):
        return await RefCoordinator(
            drt, runner, router=RefRouter(max_local_prefill_length=0,
                                          max_prefill_queue_size=100),
            depth_refresh_s=0.05).start()

    engine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=cfg,
        params=params, warmup=False, disagg_factory=factory)
    worker = RefPrefillWorker(drt_p, JaxRunner(cfg, params=params), cfg)
    task = asyncio.ensure_future(worker.run())
    try:
        ctx = JaxContext(JaxRequest(
            token_ids=PROMPT,
            stop_conditions=JaxStop(max_tokens=4, ignore_eos=True),
            sampling_options=JaxSampling(temperature=0.0)))
        async for _ in engine.generate(ctx):
            pass
        return ctx.context
    finally:
        worker.stop()
        await task
        await worker.close()
        await engine.close()
        await drt_p.close()
        await drt.close()


def _stitched(mod_tracing, mod_stitch, ctx):
    rec = mod_tracing.TraceRecorder(jsonl_path="")
    trace = rec.record("r", "m", "success", list(ctx.stages), ctx=ctx)
    rec.close()
    return mod_stitch.stitched_timeline(trace)


def test_remote_prefill_trace_nests_the_prefill_worker(weights):
    port_ctx, worker_expo = _run(_port_remote_ctx(weights[1]))
    ref_ctx = _run(_ref_remote_ctx(weights[0]))
    # the decode side's marks: the same names in the same order
    assert ([n for n, _ in port_ctx.stages]
            == [n for n, _ in ref_ctx.stages])
    assert "kv_transfer" in [n for n, _ in port_ctx.stages]
    port = _stitched(port_tracing, port_stitch, port_ctx)
    ref = _stitched(ref_tracing, ref_stitch, ref_ctx)
    assert ([s["source"] for s in port["sources"]]
            == [s["source"] for s in ref["sources"]]
            == ["frontend", "prefill_worker"])
    names = [(r["source"], r["name"]) for r in port["timeline"]]
    assert (sorted(names)
            == sorted((r["source"], r["name"]) for r in ref["timeline"]))
    (rs,) = port_ctx.remote_spans
    # a queue-mediated hop: the offset comes from the commit's return leg,
    # its error bound is the reported round trip (one host: offset ~ 0)
    assert abs(rs["offset_s"]) <= rs["rtt_s"] + 1e-3
    rows = {r["name"]: r for r in port["timeline"]}
    kv = rows["kv_transfer"]
    for name in ("prefill.compute", "prefill.transfer"):
        # the worker's spans land inside the decode side's kv_transfer
        # span (closing-mark attribution: kv_transfer ends at the commit)
        r = rows[name]
        assert r["start_s"] + r["duration_s"] <= (
            kv["start_s"] + kv["duration_s"] + rs["rtt_s"] + 1e-3)
    assert "dynamo_prefill_worker_prefills_total 1.0" in worker_expo
    assert "dynamo_engine_xla_compiles_total" in worker_expo


# ---------- the migration plane ----------

def test_hop_offset_from_the_ack_pair():
    assert port_migration._hop_offset(1.0, {}) == (0.0, 0.0)
    off, rtt = port_migration._hop_offset(
        10.0, {"recv_at": 10.5, "sent_at": 10.6})
    assert rtt >= 0.0
    got = port_migration._peer_spans({"spans": [["m", 1.0]]}, off, rtt)
    assert got == {"source": "migration_peer", "spans": [["m", 1.0]],
                   "offset_s": round(off, 6), "rtt_s": round(rtt, 6),
                   "children": []}


def test_hot_migration_trace_carries_the_peer_spans(weights):
    """A drained stream's trace carries the peer's ``migration.resume``
    onward, with the begin / ack hop's offset inside its error bound."""
    async def go():
        src = await TorchServingEngine.create(
            EngineConfig(model=ModelConfig(**TINY), **BASE),
            params=weights[1], device="cpu", warmup=False)
        dst = await TorchServingEngine.create(
            EngineConfig(model=ModelConfig(**TINY), **BASE),
            params=weights[1], device="cpu", warmup=False)
        server = await MigrationServer(MigrationSink(dst.scheduler,
                                                     dst.runner)).start()
        ctl = RecoveryController(
            engine_id="src", scheduler=src.scheduler, runner=src.runner,
            peers=lambda: [{"host": server.host, "port": server.port,
                            "engine_id": "dst"}],
            config=RecoveryConfig(drain_grace_s=0.0)).attach()
        ctx = Context(PreprocessedRequest(
            token_ids=PROMPT,
            stop_conditions=StopConditions(max_tokens=60, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0)))
        toks = []
        try:
            async for out in src.generate(ctx):
                toks.extend(out["token_ids"])
                if len(toks) == 4:
                    await ctl.admin_drain(mode="migrate")
        finally:
            await ctl.close()
            await server.close()
            await dst.close()
            await src.close()
        return toks, ctx.context

    toks, ctx = _run(go())
    assert len(toks) == 60
    peers = [r for r in ctx.remote_spans if r["source"] == "migration_peer"]
    assert peers, ctx.remote_spans
    rs = peers[0]
    assert "migration.resume" in [n for n, _ in rs["spans"]]
    assert abs(rs["offset_s"]) <= rs["rtt_s"] / 2 + 1e-3
    stitched = _stitched(port_tracing, port_stitch, ctx)
    assert "migration_peer" in [s["source"] for s in stitched["sources"]]
