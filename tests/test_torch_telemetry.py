"""Differentials of the port's telemetry against the JAX package's.

Each port module (``dynamo_tpu_torch/telemetry/``, ``utils/profiling.py``,
the metrics sidecar) is held against its counterpart in
``dynamo_tpu/telemetry/`` on the same seeded inputs with injected clocks:
exposition parses, span breakdowns, the trace store's TTL and capacity
evictions, the device-time estimator (busy, bubble, ratios, roofline), the
SLO windows, the compile tracker, the runners' byte models, and the stage
marks of one request through the port's and the JAX engine on a tiny
Llama. Tolerance: exact equality wherever both compute in float64 from the
same numbers; the byte model's KV term differs by the reference's lane
padding, stated as D / lane_pad(D).
"""

import asyncio
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.ops.attention import lane_pad
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.telemetry import device_time as ref_dt
from dynamo_tpu.telemetry import exposition as ref_expo
from dynamo_tpu.telemetry import flight as ref_flight
from dynamo_tpu.telemetry import registry as ref_registry
from dynamo_tpu.telemetry import slo as ref_slo
from dynamo_tpu.telemetry import tracing as ref_tracing
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.http.server import HttpError, http_get
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.telemetry import device_time as port_dt
from dynamo_tpu_torch.telemetry import exposition as port_expo
from dynamo_tpu_torch.telemetry import flight as port_flight
from dynamo_tpu_torch.telemetry import registry as port_registry
from dynamo_tpu_torch.telemetry import slo as port_slo
from dynamo_tpu_torch.telemetry import tracing as port_tracing
from dynamo_tpu_torch.telemetry.server import (
    MetricsServer,
    maybe_start_metrics_server,
)
from dynamo_tpu_torch.utils import profiling


def _run(coro):
    return asyncio.run(coro)


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _families(parsed):
    """Parsed exposition → comparable plain data."""
    return {name: (f.type, f.help, [(s.name, s.labels, s.value)
                                    for s in f.samples])
            for name, f in parsed.items()}


def _series(text):
    """An exposition's families without their help texts (the port words
    some help texts for the card)."""
    return {name: (t, samples) for name, (t, _h, samples)
            in _families(ref_expo.parse_exposition(text)).items()}


# ---------- exposition ----------

EXPOSITIONS = {
    "escaped_labels": (
        '# HELP m_total A "quoted" help\n# TYPE m_total counter\n'
        'm_total{model="a\\"b\\\\c\\nd",status="ok"} 3.0\n'),
    "histogram": (
        "# TYPE h histogram\n"
        'h_bucket{le="0.1",p="x"} 1\nh_bucket{le="+Inf",p="x"} 4\n'
        'h_sum{p="x"} 2.5\nh_count{p="x"} 4\n'),
    "headerless_and_inf": "g 1.5\nneg -Inf\npos +Inf\n",
    "gauge_named_count": "# TYPE q_count gauge\nq_count 7\n",
    "comments_and_blanks": "# just a comment\n\n# TYPE c counter\nc 2\n\n",
}


@pytest.mark.parametrize("name", sorted(EXPOSITIONS))
def test_exposition_parses_equal(name):
    text = EXPOSITIONS[name]
    ref = ref_expo.parse_exposition(text)
    port = port_expo.parse_exposition(text)
    assert _families(port) == _families(ref)
    for fam in ref:
        if ref[fam].type == "histogram":
            assert (port_expo.histogram_series(port[fam])
                    == ref_expo.histogram_series(ref[fam]))


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("dyn_req_total", "requests")
    g = reg.gauge("dyn_inflight", "in flight")
    h = reg.histogram("dyn_lat_seconds", "latency")
    rng = np.random.default_rng(11)
    for i in range(40):
        model = f'm"{i % 3}\\'
        c.inc(model=model, status="ok" if i % 4 else "err")
        g.set(float(i % 5), model=model)
        h.observe(float(rng.exponential(0.3)), model=model)
    reg.callback_gauge("dyn_cb", "callback", lambda: [({"k": "v"}, 2.0)])
    return reg.render()


def test_registry_exposition_parses_equal_to_the_reference():
    """The same instrument operations on both registries render texts that
    parse to the same families."""
    assert (_families(port_expo.parse_exposition(_drive_registry(port_registry)))
            == _families(ref_expo.parse_exposition(_drive_registry(ref_registry))))


# ---------- tracing ----------

SPAN_CASES = {
    "empty": ([], 5.0),
    "one_mark": ([("http", 1.0)], 1.5),
    "engine_marks": ([("http", 1.0), ("queued", 1.001), ("admission", 1.002),
                      ("prefill", 1.05), ("first_token", 1.06),
                      ("completion", 1.3)], 1.31),
    "out_of_order_end": ([("a", 2.0), ("b", 3.0)], 2.5),
}


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_span_breakdown_equal(case):
    stages, end = SPAN_CASES[case]
    assert (port_tracing.span_breakdown(stages, end)
            == ref_tracing.span_breakdown(stages, end))


def _drive_recorder(mod, capacity, ttl_s, seed):
    clock = Clock()
    registry = (port_registry if mod is port_tracing else ref_registry
                ).MetricsRegistry()
    rec = mod.TraceRecorder(capacity=capacity, ttl_s=ttl_s, registry=registry,
                            clock=clock, jsonl_path="")
    rng = np.random.default_rng(seed)
    seen = []
    for i in range(30):
        clock.t += float(rng.uniform(0.0, 4.0))
        rid = f"r{int(rng.integers(0, 12))}"
        rec.record(rid, "m", "success", [("http", 1.0), ("completion", 1.2)],
                   end=1.25)
        if i % 5 == 4:
            seen.append([t["request_id"] for t in rec.recent(50)])
    out = dict(ids=[t["request_id"] for t in rec.recent(100)],
               evicted=rec.evicted, seen=seen, n=len(rec),
               got=[rec.get(f"r{i}") is not None for i in range(12)])
    samples = ref_expo.parse_exposition(registry.render())
    out["evicted_series"] = sorted(
        (tuple(sorted(s.labels.items())), s.value)
        for s in samples["dynamo_trace_evicted_total"].samples)
    rec.close()
    return out


@pytest.mark.parametrize("capacity,ttl_s", [(4, 0.0), (64, 10.0), (3, 6.0)],
                         ids=["capacity", "ttl", "both"])
def test_trace_store_evictions_equal(capacity, ttl_s):
    assert (_drive_recorder(port_tracing, capacity, ttl_s, 5)
            == _drive_recorder(ref_tracing, capacity, ttl_s, 5))


def test_trace_jsonl_writer_and_context_pieces(tmp_path):
    """The JSONL sink writes one object per request on its own thread; a
    context contributes the wall anchor and its remote span sets."""
    from dynamo_tpu_torch.runtime.engine import AsyncEngineContext

    path = tmp_path / "traces.jsonl"
    rec = port_tracing.TraceRecorder(jsonl_path=str(path))
    ctx = AsyncEngineContext(trace_id="t1")
    ctx.add_stage("http")
    ctx.add_remote_spans({"source": "worker", "spans": []})
    rec.record("t1", "m", "success", ctx.stages, ctx=ctx)
    rec.record("t2", "m", "error", [])
    rec.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["request_id"] for x in lines] == ["t1", "t2"]
    assert lines[0]["t0_wall"] == pytest.approx(ctx.wall(ctx.stages[0][1]))
    assert lines[0]["remote"] == [{"source": "worker", "spans": []}]
    assert port_tracing.recorders()  # the flight artifact's trace section


# ---------- device time ----------

def _device_sequence(seed):
    rng = np.random.default_rng(seed)
    t = 10.0
    ops = []
    for i in range(60):
        kind = rng.choice(["decode", "decode_burst", "prefill", "prefill_sp",
                           "idle"], p=[0.35, 0.25, 0.15, 0.1, 0.15])
        t += float(rng.uniform(0.0, 0.02))
        if kind == "idle":
            ops.append(("idle",))
            continue
        dispatch = t
        ready = dispatch + float(rng.uniform(0.0005, 0.05))
        phase = "decode" if kind.startswith("decode") else "prefill"
        ops.append(("observe", kind, phase, dispatch, ready,
                    float(rng.uniform(1e6, 1e9)), int(rng.integers(1, 9)),
                    float(rng.uniform(0.0, 0.5))))
        t = ready - float(rng.uniform(0.0, 0.01))  # overlapping dispatches
    return ops


def _drive_device_time(mod, seed, window_s):
    clock = Clock(0.0)
    tr = mod.DeviceTimeTracker(param_bytes=2.5e9, kv_bytes_per_token=32768.0,
                               hbm_gbps=1000.0, window_s=window_s, clock=clock)
    busy = []
    for op in _device_sequence(seed):
        if op[0] == "idle":
            tr.idle()
            continue
        _, program, phase, dispatch, ready, nbytes, tokens, advance = op
        clock.t += advance
        busy.append(tr.observe(program, phase, dispatch, ready,
                               read_bytes=nbytes, tokens=tokens))
    return dict(busy=busy, busy_s=tr.busy_s, bubble_s=tr.bubble_s,
                decode_bytes=tr.decode_bytes, decode_tokens=tr.decode_tokens,
                prefill_bytes=tr.prefill_bytes, observations=tr.observations,
                ratios=tr._busy_ratios(), roofline=tr._roofline(),
                hist=_series(tr.registry.render()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window_s", [1.0, 60.0], ids=["short", "long"])
def test_device_time_tracker_equal(seed, window_s):
    """One timestamp sequence (overlapping dispatches, idle resets, SP
    observations with bytes) gives the same busy, bubble, ratios and
    roofline through both trackers."""
    assert (_drive_device_time(port_dt, seed, window_s)
            == _drive_device_time(ref_dt, seed, window_s))


@pytest.mark.parametrize("chunks,ctx,kernel", [(1, 100, False), (4, 4096, True),
                                               (7, 12000, False)])
def test_device_time_byte_models_equal(chunks, ctx, kernel):
    port = port_dt.DeviceTimeTracker(param_bytes=3e9, kv_bytes_per_token=4096.0)
    ref = ref_dt.DeviceTimeTracker(param_bytes=3e9, kv_bytes_per_token=4096.0)
    assert (port.sp_prefill_read_bytes(chunks, ctx, kernel)
            == ref.sp_prefill_read_bytes(chunks, ctx, kernel))
    assert port.decode_read_bytes(chunks, ctx) == ref.decode_read_bytes(chunks, ctx)


def test_device_time_default_is_the_h100_and_env_overrides(monkeypatch):
    monkeypatch.delenv(port_dt.HBM_GBPS_ENV, raising=False)
    assert port_dt.DeviceTimeTracker().peak_bytes_per_s == 3350.0e9
    monkeypatch.setenv(port_dt.HBM_GBPS_ENV, "2000")
    assert port_dt.DeviceTimeTracker().peak_bytes_per_s == 2000.0e9
    assert ref_dt.DeviceTimeTracker().peak_bytes_per_s == 2000.0e9


# ---------- SLO ----------

def _drive_slo(mod, ttft_s, itl_s, seed):
    clock = Clock(0.0)
    registry = (port_registry if mod is port_slo else ref_registry
                ).MetricsRegistry()
    tr = mod.SloTracker(ttft_s=ttft_s, itl_s=itl_s, window_s=20.0,
                        registry=registry, clock=clock)
    rng = np.random.default_rng(seed)
    snaps = []
    for i in range(80):
        clock.t += float(rng.uniform(0.0, 1.5))
        itl = None if rng.random() < 0.2 else float(rng.uniform(0.0, 0.2))
        tr.observe(float(rng.uniform(0.0, 1.0)), itl, int(rng.integers(1, 50)))
        if i % 7 == 0:
            snaps.append((tr.snapshot(), tr.window_count()))
    return dict(snaps=snaps, requests=tr.requests, met=tr.met_requests,
                goodput=tr.goodput_tokens,
                expo=_series(registry.render()))


@pytest.mark.parametrize("ttft_s,itl_s", [(0.5, None), (None, 0.1), (0.4, 0.15)],
                         ids=["ttft", "itl", "both"])
def test_slo_windows_equal(ttft_s, itl_s):
    assert (_drive_slo(port_slo, ttft_s, itl_s, 3)
            == _drive_slo(ref_slo, ttft_s, itl_s, 3))


# ---------- the compile tracker ----------

def _drive_compiles(mod):
    flight = mod.FlightRecorder()
    tr = mod.CompileTracker(flight=flight)
    keys = [("prefill", "b1_s16_w8"), ("decode", "b4_s1_w8"),
            ("prefill", "b1_s16_w8"), ("decode_burst", "b4_w8")]
    for program, key in keys:
        with tr.track(program, key):
            pass
    tr.mark_serving_started()
    for program, key in keys + [("prefill", "b1_s32_w8"), ("decode", "b4_s1_w16")]:
        with tr.track(program, key):
            pass
    samples = ref_expo.parse_exposition(tr.registry.render())
    return dict(
        records=[(r["program"], r["key"], r["phase"]) for r in tr.records],
        late=tr.late_compiles,
        counts=sorted((tuple(sorted(s.labels.items())), s.value) for s in
                      samples["dynamo_engine_xla_compiles_total"].samples),
        events=[(e["kind"], e["data"]["program"], e["data"]["phase"])
                for e in flight.snapshot()])


def test_compile_tracker_equal():
    assert _drive_compiles(port_flight) == _drive_compiles(ref_flight)


# ---------- the engines: byte model, first dispatches, stage marks ----------

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=256)
BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32")
PROMPT = [int(t) for t in np.random.default_rng(4).integers(3, 512, 21)]


@pytest.fixture(scope="module")
def engine_runs():
    """One greedy request through each engine (warmup off, so the first
    dispatches are the request's own): the stage marks, the runners' byte
    models and first-dispatch records."""
    params = jax_llama.init_params(JaxModelConfig(**TINY),
                                   jax.random.PRNGKey(3), jnp.float32)

    async def go():
        jcfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **BASE)
        jeng = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None), engine_config=jcfg,
            params=params, warmup=False)
        cfg = EngineConfig(model=ModelConfig(**TINY), **BASE)
        peng = await TorchServingEngine.create(
            cfg, params=from_jax_params(jax.device_get(params), cfg.model,
                                        "cpu", "float32"),
            device="cpu", warmup=False)
        out = {}
        try:
            jctx = JaxContext(JaxRequest(
                token_ids=PROMPT,
                stop_conditions=JaxStop(max_tokens=6, ignore_eos=True),
                sampling_options=JaxSampling(temperature=0.0)))
            async for _ in jeng.generate(jctx):
                pass
            pctx = Context(PreprocessedRequest(
                token_ids=PROMPT,
                stop_conditions=StopConditions(max_tokens=6, ignore_eos=True),
                sampling_options=SamplingOptions(temperature=0.0)))
            async for _ in peng.generate(pctx):
                pass
            out["stages"] = ([n for n, _ in jctx.context.stages],
                             [n for n, _ in pctx.context.stages])
            out["runners"] = (jeng.runner, peng.runner)
            out["expo"] = (jeng.scheduler.registry.render(),
                           peng.scheduler.registry.render())
        finally:
            await jeng.close()
            await peng.close()
        return out

    return _run(go())


def test_stage_marks_equal_through_both_engines(engine_runs):
    ref, port = engine_runs["stages"]
    assert port == ref
    assert port[:2] == ["queued", "admission"]
    assert port.index("prefill") < port.index("first_token") < port.index(
        "completion")


def test_runner_byte_model_against_the_reference(engine_runs):
    """Weights: the same bytes. KV per token: the port counts its real
    cache (unpadded, without the spare row); the reference's cache pads
    each head's lanes to 128, so the ratio is D / lane_pad(D)."""
    jr, pr = engine_runs["runners"]
    d = TINY["hidden_size"] // TINY["num_heads"]
    assert pr.param_bytes == jr.param_bytes
    assert pr.kv_bytes_per_token / jr.kv_bytes_per_token == pytest.approx(
        d / lane_pad(d), rel=1e-12)
    # the port's real bytes: K and V, every layer, every KV head, f32
    assert pr.kv_bytes_per_token == (2 * TINY["num_layers"]
                                     * TINY["num_kv_heads"] * d * 4)
    assert pr.device_time.kv_bytes_per_token == pr.kv_bytes_per_token


def test_first_dispatch_keys_match_the_reference(engine_runs):
    """The step programs' (program, key) first dispatches agree: the same
    names and shape-bucket keys, all late (serving had started)."""
    jr, pr = engine_runs["runners"]

    def keys(tr):
        return sorted((r["program"], r["key"], r["phase"]) for r in tr.records
                      if r["program"] in ("prefill", "decode"))

    assert keys(pr.compiles) == keys(jr.compiles)
    assert keys(pr.compiles) and all(k[2] == "late" for k in keys(pr.compiles))


@pytest.mark.parametrize("family", ["dynamo_engine_xla_compiles_total",
                                    "dynamo_engine_device_time_seconds",
                                    "dynamo_engine_device_busy_ratio",
                                    "dynamo_engine_roofline_fraction"])
def test_engine_scrape_carries_the_telemetry_families(engine_runs, family):
    ref_text, port_text = engine_runs["expo"]
    port = port_expo.parse_exposition(port_text)
    ref = ref_expo.parse_exposition(ref_text)
    assert family in ref and family in port
    assert port[family].type == ref[family].type
    assert {s.name for s in port[family].samples}


def test_engine_device_time_phases(engine_runs):
    _, pr = engine_runs["runners"]
    dt = pr.device_time
    assert dt.observations >= 2
    assert set(dt.busy_s) == {"prefill", "decode"}
    assert dt.decode_tokens == 5  # the first token came from the prefill
    (labels, frac), = dt._roofline()
    assert labels == {} and frac > 0.0


# ---------- profiling (CPU activity) ----------

def test_capture_trace_writes_trace_and_summary(tmp_path):
    trace_dir = profiling.capture_trace(str(tmp_path), 0.05)
    assert os.path.isfile(os.path.join(trace_dir, profiling.TRACE_FILE))
    summary = profiling.read_summary(trace_dir)
    assert summary["cuda"] is False and summary["window_s"] == 0.05
    assert summary["kernel_launches"] == 0 and summary["kernels"] == {}


def test_capture_trace_refuses_while_a_capture_holds_the_lock(tmp_path):
    assert profiling._capture_lock.acquire(blocking=False)
    try:
        with pytest.raises(profiling.CaptureBusyError):
            profiling.capture_trace(str(tmp_path), 0.01)
    finally:
        profiling._capture_lock.release()


def test_summarize_trace_unions_overlapping_kernels():
    events = [{"cat": "kernel", "name": "a", "ts": 0.0, "dur": 100.0},
              {"cat": "kernel", "name": "b", "ts": 50.0, "dur": 100.0},
              {"cat": "kernel", "name": "a", "ts": 300.0, "dur": 50.0},
              {"cat": "cpu_op", "name": "x", "ts": 0.0, "dur": 999.0}]
    s = profiling.summarize_trace(events, 0.001)
    assert s["kernel_launches"] == 3
    assert s["kernel_busy_s"] == pytest.approx(200e-6)
    assert s["kernel_busy_share"] == pytest.approx(0.2)
    assert s["kernels"]["a"] == {"launches": 2, "us": 150.0}


# ---------- the metrics sidecar and the GET client ----------

def test_metrics_sidecar_serves_the_registry():
    async def go():
        reg = port_registry.MetricsRegistry()
        reg.counter("dyn_x_total", "x").inc(3, k="v")
        assert await maybe_start_metrics_server(reg, 0) is None  # port 0 = off
        srv = await MetricsServer(reg, host="127.0.0.1", port=0).start()
        try:
            text = (await http_get(f"http://127.0.0.1:{srv.port}/metrics",
                                   2.0)).decode()
            with pytest.raises(HttpError) as e:
                await http_get(f"http://127.0.0.1:{srv.port}/nope", 2.0)
            return text, e.value.status
        finally:
            await srv.stop()

    text, status = _run(go())
    fam = port_expo.parse_exposition(text)["dyn_x_total"]
    assert [(s.labels, s.value) for s in fam.samples] == [({"k": "v"}, 3.0)]
    assert status == 404
