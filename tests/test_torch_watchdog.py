"""The stall watchdog and the flight ring in the port, against the reference.

- The scripted-probe cases of ``tests/test_watchdog.py`` (idle with a stale
  heartbeat, a healthy remote wait, a stale heartbeat with work pending,
  frozen steps with queued work, an idle gap then arrivals, advancing steps,
  a stopping engine, a flaky probe): the port's ``StallWatchdog`` gives the
  reference's trip sequence on the same probe script, each case run on both
  packages.
- ``FlightRecorder``: the ring bound and its drop count, the snapshot
  filtered by request or trace id, the capacity env, the process-wide ring:
  the same events as the reference's recorder.
- Flight artifacts: a trip writes one to ``DYN_FLIGHT_DIR`` that parses and
  carries the ring, every thread's stack, the registered engine's probe,
  request table and metrics; ``install_signal_dump`` writes one on SIGUSR2.
- ``Scheduler.watchdog_probe`` keys and values (the heartbeat's stamp
  aside) and ``request_table`` against ``JaxServingEngine``'s scheduler on
  the same traffic, idle and with a draining gate holding a request.
- A port engine whose decode host sync wedges (``decode_burst_hang``) trips
  ``decode_stall`` once, and the artifact holds the wedged request.

Tiny widths (2 layers, hidden 64, block size 8), f32. Every test runs
under its own timeout.
"""

import asyncio
import json
import os
import signal
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.scheduler import EngineRequest as JaxER
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import AsyncEngineContext as JaxCtx
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.telemetry import flight as ref_flight
from dynamo_tpu.telemetry import watchdog as ref_watchdog
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.engine.scheduler import EngineRequest as PortER
from dynamo_tpu_torch.runtime.engine import AsyncEngineContext as PortCtx
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.telemetry import flight as port_flight
from dynamo_tpu_torch.telemetry import watchdog as port_watchdog
from dynamo_tpu_torch.utils import faults

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=512, rms_norm_eps=1e-5)
BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32")
TIMEOUT_S = 120
PACKAGES = {"reference": (ref_watchdog, ref_flight),
            "port": (port_watchdog, port_flight)}


def _run(coro, timeout=TIMEOUT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(5),
                                   jnp.float32)
    host = jax.device_get(params)
    return params, from_jax_params(host, ModelConfig(**TINY), "cpu", "float32")


# ------------------------------------------------------- scripted probes


def _probe(heartbeat=None, steps=0, depth=0, remote=0, active=0,
           stopping=False):
    hb = heartbeat if heartbeat is not None else time.monotonic()
    return {"heartbeat_t": hb, "steps": steps, "queue_depth": depth,
            "pending_remote": remote, "active": active, "stopping": stopping}


def _flaky():
    calls = {"n": 0}

    def probe():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("scrape race")
        return _probe(heartbeat=0.0, active=1)

    return probe


def _advancing():
    counter = {"steps": 0}

    def probe():
        counter["steps"] += 1  # every sample sees progress
        return _probe(steps=counter["steps"], depth=2, active=1)

    return probe


# case → (probe factory, sampling cycles, the reference's trip sequence)
CASES = {
    "idle_stale_heartbeat": (lambda: lambda: _probe(heartbeat=0.0), 8, []),
    "remote_wait": (lambda: lambda: _probe(steps=7, remote=3), 8, []),
    "stale_heartbeat_once": (
        lambda: lambda: _probe(heartbeat=0.0, active=1, steps=4), 16,
        ["decode_stall"]),
    "frozen_steps": (lambda: lambda: _probe(steps=42, depth=2), 16,
                     ["no_throughput"]),
    "advancing_steps": (_advancing, 16, []),
    "stopping": (lambda: lambda: _probe(heartbeat=0.0, active=3, stopping=True),
                 8, []),
    "flaky_probe": (_flaky, 16, ["decode_stall"]),
}


async def _scripted(package, probe, cycles, interval=0.03, stall=0.1):
    wd_mod, fl_mod = PACKAGES[package]
    wd = wd_mod.StallWatchdog(probe, interval_s=interval, stall_s=stall,
                              flight=fl_mod.FlightRecorder()).start()
    await asyncio.sleep(interval * cycles + stall)
    await wd.stop()
    return wd


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_scripted_probe_trips_as_the_reference(case, package):
    """The same probe script gives the reference's trip sequence; a trip
    counts under its reason in the registry and lands in the flight ring."""
    factory, cycles, want = CASES[case]
    wd = _run(_scripted(package, factory(), cycles))
    assert [t["reason"] for t in wd.trips] == want
    assert wd.loop_lag_s < 1.0
    text = wd.registry.render()
    assert "dynamo_runtime_event_loop_lag_seconds" in text
    for reason in want:
        assert f'dynamo_watchdog_trips_total{{reason="{reason}"}} 1.0' in text
    assert [e["data"]["reason"] for e in wd.flight.snapshot()
            if e["kind"] == "watchdog.trip"] == want


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_idle_gap_then_arrival_trips_only_after_the_deadline(package):
    """Steps frozen through a long idle period, then work arrives: the
    starvation clock restarts at the arrival; only a queue that stays
    starved past the deadline trips ``no_throughput``."""
    wd_mod, fl_mod = PACKAGES[package]
    state = {"depth": 0}

    async def go():
        wd = wd_mod.StallWatchdog(lambda: _probe(steps=10, depth=state["depth"]),
                                  interval_s=0.03, stall_s=0.15,
                                  flight=fl_mod.FlightRecorder()).start()
        await asyncio.sleep(0.5)   # idle far beyond stall_s, steps frozen
        state["depth"] = 2         # a burst of work arrives
        await asyncio.sleep(0.09)  # well under stall_s since the arrival
        early = list(wd.trips)
        await asyncio.sleep(0.5)   # now starved
        await wd.stop()
        return early, list(wd.trips)

    early, late = _run(go())
    assert early == []
    assert [t["reason"] for t in late] == ["no_throughput"]


def test_trip_listeners_run_after_the_dump_and_survive_a_failure():
    """Listeners get the trip's info (its artifact path included); one that
    raises does not stop the next one, nor the watchdog."""
    seen = []

    def bad(info):
        raise RuntimeError("listener bug")

    async def go():
        wd = port_watchdog.StallWatchdog(
            lambda: _probe(heartbeat=0.0, active=1), interval_s=0.02,
            stall_s=0.05, flight=port_flight.FlightRecorder())
        wd.add_trip_listener(bad)
        wd.add_trip_listener(seen.append)
        wd.start()
        await asyncio.sleep(0.3)
        await wd.stop()
        return wd

    wd = _run(go())
    assert [i["reason"] for i in seen] == ["decode_stall"]
    assert "artifact" in seen[0] and seen[0]["probe"]["active"] == 1
    assert wd.last_trip is seen[0]


# ------------------------------------------------------------ flight ring


def _drive_ring(mod, capacity):
    rec = mod.FlightRecorder(capacity=capacity)
    for i in range(40):
        rid = f"r{i % 3}"
        rec.record("scheduler.extract", request_id=rid,
                   trace_id=("t1" if i % 5 == 0 else rid), blocks=i)
    return rec


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("t", "wall")}
            for e in events]


def test_flight_ring_matches_the_reference():
    """Bound, drop count, filters by request and trace id, the ``n`` cap:
    the same events as the reference's ring (times aside)."""
    ref, port = _drive_ring(ref_flight, 16), _drive_ring(port_flight, 16)
    assert (len(port), port.appended, port.dropped, port.capacity) == (
        len(ref), ref.appended, ref.dropped, ref.capacity) == (16, 40, 24, 16)
    assert _strip(port.snapshot()) == _strip(ref.snapshot())
    for rid in ("r0", "r1", "t1", "nobody"):
        assert (_strip(port.snapshot(request_id=rid))
                == _strip(ref.snapshot(request_id=rid)))
    assert _strip(port.snapshot(n=3)) == _strip(ref.snapshot(n=3))
    assert port.snapshot(n=3)[-1]["data"] == {"blocks": 39}


@pytest.mark.parametrize("raw,want", [("64", 64), ("3", 16), ("junk", 4096),
                                      ("", 4096)])
def test_flight_capacity_env(monkeypatch, raw, want):
    """``DYN_FLIGHT_EVENTS`` sizes a ring built without a capacity, floored
    at 16; garbage falls back to 4,096, as in the reference."""
    monkeypatch.setenv("DYN_FLIGHT_EVENTS", raw)
    assert port_flight.FlightRecorder().capacity == want
    assert ref_flight.FlightRecorder().capacity == want


def test_process_wide_recorder_records_fault_fires():
    """``flight_recorder()`` is one ring per process; an injected fault's
    fire lands in it as ``fault.injected``."""
    ring = port_flight.flight_recorder()
    assert ring is port_flight.flight_recorder()
    faults.arm("transfer_conn_drop", "once")
    assert faults.fire("transfer_conn_drop")
    assert ring.snapshot(n=1)[0]["kind"] == "fault.injected"
    assert ring.snapshot(n=1)[0]["data"] == {"site": "transfer_conn_drop"}


# -------------------------------------------------------- flight artifacts


def test_trip_writes_a_parsable_artifact(tmp_path, monkeypatch):
    """A trip dumps one artifact into DYN_FLIGHT_DIR: the ring (merged with
    the process-wide one), all threads' stacks, the source's probe, request
    table, metrics and last trip; the path rides the trip's info."""
    monkeypatch.setenv("DYN_FLIGHT_DIR", str(tmp_path))
    ring = port_flight.FlightRecorder()
    ring.record("scheduler.extract", request_id="wedged", blocks=3)

    async def go():
        wd = port_watchdog.StallWatchdog(
            lambda: _probe(heartbeat=0.0, active=1, steps=9),
            requests=lambda: [{"state": "decoding", "request_id": "wedged"}],
            interval_s=0.02, stall_s=0.05, flight=ring, name="eng-a").start()
        await asyncio.sleep(0.3)
        await wd.stop()
        return wd

    wd = _run(go())
    assert len(wd.trips) == 1
    path = wd.trips[0]["artifact"]
    assert os.path.dirname(path) == str(tmp_path) and path.endswith(
        "-decode_stall.json")
    art = json.loads(open(path).read())
    assert art["reason"] == "decode_stall" and art["version"] == 1
    assert art["pid"] == os.getpid()
    kinds = [e["kind"] for e in art["events"]]
    assert "scheduler.extract" in kinds and "watchdog.trip" in kinds
    assert any(t["stack"] for t in art["threads"])
    (src,) = [s for s in art["sources"] if s["name"] == "eng-a"]
    assert src["probe"]["steps"] == 9
    assert src["requests"] == [{"state": "decoding", "request_id": "wedged"}]
    assert "dynamo_watchdog_trips_total" in src["metrics"]
    assert "traces" not in art  # the trace section waits for tracing
    assert port_watchdog._SOURCES == []  # stop() unregistered it


def test_no_flight_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("DYN_FLIGHT_DIR", raising=False)
    assert port_watchdog.write_flight_artifact({"reason": "x"}) is None
    monkeypatch.setenv("DYN_FLIGHT_DIR", str(tmp_path / "new"))
    path = port_watchdog.write_flight_artifact({"reason": "x"})
    assert path.startswith(str(tmp_path / "new"))
    assert json.loads(open(path).read()) == {"reason": "x"}


def test_sigusr2_dumps_an_artifact(tmp_path, monkeypatch):
    """``install_signal_dump`` is idempotent, and SIGUSR2 writes a
    ``sigusr2`` artifact from a thread of its own."""
    monkeypatch.setenv("DYN_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setattr(port_watchdog, "_signal_installed", False)
    prev = signal.getsignal(signal.SIGUSR2)
    try:
        assert port_watchdog.install_signal_dump()
        assert port_watchdog.install_signal_dump()
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 30
        while not list(tmp_path.glob("*-sigusr2.json")):
            assert time.monotonic() < deadline, "no SIGUSR2 artifact"
            time.sleep(0.01)
        (path,) = tmp_path.glob("*-sigusr2.json")
        for _ in range(3000):  # the dump thread may still be writing it
            try:
                art = json.loads(path.read_text())
                break
            except ValueError:
                time.sleep(0.01)
        assert art["reason"] == "sigusr2" and art["threads"]
    finally:
        signal.signal(signal.SIGUSR2, prev)


# ---------------------------------------------- the scheduler's probe


def _jax_req(prompt, n):
    return JaxRequest(token_ids=list(prompt),
                      stop_conditions=JaxStop(max_tokens=n, ignore_eos=True),
                      sampling_options=JaxSampling(temperature=0.0))


def _req(prompt, n):
    return PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0))


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 512, n)]


async def _probe_record(weights, port: bool):
    """The probe after serving two requests one by one, then with the drain
    gate closed and one request queued behind it; the request table there."""
    if port:
        engine = await TorchServingEngine.create(
            EngineConfig(model=ModelConfig(**TINY), **BASE), params=weights[1],
            device="cpu", warmup=False)
        req, ctx = _req, Context
    else:
        engine = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None),
            engine_config=JaxEngineConfig(model=JaxModelConfig(**TINY), **BASE),
            params=weights[0], warmup=False)
        req, ctx = _jax_req, JaxContext
    sched = engine.scheduler
    try:
        for p in (_prompt(20, 1), _prompt(13, 2)):
            async for _ in engine.generate(ctx(req(p, 6))):
                pass
        idle = sched.watchdog_probe()
        sched.set_draining(True)
        # past the engine's own gate (it refuses a draining engine): the
        # scheduler's admission gate holds the request in `waiting`
        before = time.monotonic()
        ER, C = (PortER, PortCtx) if port else (JaxER, JaxCtx)
        prompt = _prompt(9, 3)
        er = ER(request_id="held", prompt=prompt, req=req(prompt, 4),
                ctx=C(trace_id="tr-held"),
                out_queue=asyncio.Queue())
        sched.add_request(er)
        await asyncio.sleep(0.1)
        gated = sched.watchdog_probe()
        table = sched.request_table()
        sched.set_draining(False)
        while (await er.out_queue.get()) is not None:
            pass
        assert idle["heartbeat_t"] <= before <= gated["heartbeat_t"]
        return idle, gated, table, sched.watchdog_probe()
    finally:
        await engine.close()


def test_watchdog_probe_matches_the_reference(weights):
    """``watchdog_probe`` keys and values equal ``JaxServingEngine``'s
    scheduler's on the same traffic (the heartbeat's stamp aside); the
    request table holds the gated request as the reference's does."""
    ref = _run(_probe_record(weights, port=False))
    port = _run(_probe_record(weights, port=True))
    for r, p in zip(ref[:2] + ref[3:], port[:2] + port[3:]):
        assert set(r) == set(p)
        assert ({k: v for k, v in r.items() if k != "heartbeat_t"}
                == {k: v for k, v in p.items() if k != "heartbeat_t"})
    assert port[1]["queue_depth"] == 1 and port[1]["stopping"] is True
    assert port[2] == ref[2] == [{
        "state": "waiting", "request_id": "held", "trace_id": "tr-held",
        "prompt_tokens": 9, "generated": 0}]


# ------------------------------------------------------ a wedged engine


def test_wedged_decode_sync_trips_decode_stall_once(weights, tmp_path,
                                                    monkeypatch):
    """``decode_burst_hang`` wedges the executor side of a decode step's host
    sync: the engine's watchdog trips ``decode_stall`` exactly once (the
    wedge persists across samples), and the artifact's request table holds
    the wedged request; after the release the stream completes."""
    monkeypatch.setenv("DYN_FLIGHT_DIR", str(tmp_path))

    async def go():
        engine = await TorchServingEngine.create(
            EngineConfig(model=ModelConfig(**TINY), watchdog_stall_s=0.3,
                         watchdog_interval_s=0.05, **BASE),
            params=weights[1], device="cpu", warmup=False)
        try:
            toks = []

            async def consume():
                async for out in engine.generate(Context(_req(_prompt(20, 4), 24))):
                    toks.extend(out["token_ids"])

            task = asyncio.ensure_future(consume())
            while len(toks) < 4:
                await asyncio.sleep(0.005)
            faults.arm("decode_burst_hang", "once")
            while not engine.watchdog.trips:
                await asyncio.sleep(0.02)
            await asyncio.sleep(0.5)  # more samples of the same wedge
            trips = [t["reason"] for t in engine.watchdog.trips]
            art = json.loads(open(engine.watchdog.trips[0]["artifact"]).read())
            faults.release()
            await task
            return trips, art, toks, engine.metrics()
        finally:
            faults.release()
            await engine.close()

    trips, art, toks, metrics = _run(go())
    assert trips == ["decode_stall"]
    (src,) = art["sources"]
    assert [r["state"] for r in src["requests"]] == ["decoding"]
    assert src["requests"][0]["prompt_tokens"] == 20
    assert "fault.injected" in [e["kind"] for e in art["events"]]
    assert len(toks) == 24 and metrics["kv_active_blocks"] == 0
