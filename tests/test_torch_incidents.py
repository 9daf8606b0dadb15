"""The port's incident recorder against the JAX package's.

- the trigger's rate limits (per-reason cooldown, the global minimum
  interval, (reason, request) dedup) decide alike on one injected clock;
- one captured bundle has the reference's file set and manifest keys, and
  carries the affected request's flight events, history and trace;
- the SLO-floor and late-dispatch probes fire on the same sequences;
- the probe loop is edge-triggered, bundles prune oldest first, a profile
  window lands inside the bundle (a CPU capture here) or is skipped while
  another capture holds the lock, and ``GET /debug/incidents`` lists and
  fetches bundles (501 without a recorder).
"""

import asyncio
import json
import os

import pytest

from dynamo_tpu.telemetry import flight as ref_flight
from dynamo_tpu.telemetry import history as ref_history
from dynamo_tpu.telemetry import incidents as ref_incidents
from dynamo_tpu.telemetry import slo as ref_slo
from dynamo_tpu.telemetry import tracing as ref_tracing
from dynamo_tpu_torch.http.server import HttpError, http_get
from dynamo_tpu_torch.http.service import HttpService, ModelManager
from dynamo_tpu_torch.telemetry import flight as port_flight
from dynamo_tpu_torch.telemetry import history as port_history
from dynamo_tpu_torch.telemetry import incidents as port_incidents
from dynamo_tpu_torch.telemetry import slo as port_slo
from dynamo_tpu_torch.telemetry import tracing as port_tracing
from dynamo_tpu_torch.utils import profiling

PORT = (port_incidents, port_flight, port_history, port_tracing, port_slo)
REF = (ref_incidents, ref_flight, ref_history, ref_tracing, ref_slo)


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _run(coro, timeout=60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _recorder(mods, clk, history=None, **cfg):
    inc, flight = mods[0], mods[1]
    cfg.setdefault("settle_s", 0.0)
    return inc.IncidentRecorder(inc.IncidentConfig(**cfg), history=history,
                                flight=flight.FlightRecorder(capacity=64),
                                clock=clk)


TRIGGERS = [  # (advance the clock, reason, request id)
    (0.0, "decode_stall", None), (0.0, "decode_stall", None),
    (2.0, "recovery_drain", None), (4.0, "recovery_drain", None),
    (3.0, "decode_stall", None), (6.0, "Decode Stall!", None),
    (20.0, "slo_floor", "req-1"), (15.0, "slo_floor", "req-1"),
    (0.0, "slo_floor", "req-2"), (200.0, "slo_floor", "req-1"),
]


async def _drive_triggers(mods):
    clk = Clock()
    rec = _recorder(mods, clk, cooldown_s=10.0, min_interval_s=5.0,
                    dedup_s=100.0)
    got = []
    for dt, reason, rid in TRIGGERS:
        clk.t += dt
        got.append(rec.trigger(reason, request_id=rid))
    await rec.stop()
    kinds = [(e["kind"], e["data"].get("reason"), e["data"].get("by"))
             for e in rec.flight.snapshot()]
    return got, rec.captures, rec.suppressed, sorted(
        (m["reason"], m["request_id"]) for m in rec.bundles), sorted(kinds)


def test_trigger_rate_limits_equal():
    port, ref = _run(_drive_triggers(PORT)), _run(_drive_triggers(REF))
    assert port == ref
    assert port[0][:2] == [True, False]


async def _one_bundle(mods, tmp_path, request_id="req-x"):
    inc, _flight, hist_mod, tracing, _ = mods
    hist = hist_mod.MetricHistory(window_s=600.0)
    for i in range(5):
        hist.observe("dynamo_kv_block_usage_ratio", {}, i / 10)
        hist.observe("dynamo_watchdog_trips_total", {"reason": "x"},
                     float(i), kind="counter")
    rec = _recorder(mods, Clock(), history=hist, out_dir=str(tmp_path))
    rec.flight.record("scheduler.admission", request_id=request_id, slot=0)
    tr = tracing.TraceRecorder(capacity=8, jsonl_path="")
    tr.record(request_id, "m", "completed",
              [("ingress", 100.0), ("first_token", 100.1)], end=100.3)
    assert rec.trigger("manual_test", request_id=request_id,
                       stalled_for_s=1.25) is True
    await rec.stop()
    tr.close()
    (manifest,) = rec.bundles
    return rec, manifest, inc.load_bundle_dir(manifest["path"])


def test_bundle_file_set_and_manifest_keys_equal(tmp_path):
    prec, pm, pb = _run(_one_bundle(PORT, tmp_path / "port"))
    _, rm, _ = _run(_one_bundle(REF, tmp_path / "ref"))
    assert sorted(os.listdir(pm["path"])) == sorted(os.listdir(rm["path"])) \
        == ["flight.json", "history.json", "manifest.json", "traces.json"]
    assert set(pm) == set(rm)
    assert pm["files"] == rm["files"]
    assert (pm["reason"], pm["request_id"], pm["info"]) == (
        rm["reason"], rm["request_id"], rm["info"])
    assert "req-x" in {e.get("request_id") for e in pb["flight"]["events"]}
    series = {s["name"]: s for s in pb["history"]["series"]}
    assert len(series["dynamo_kv_block_usage_ratio"]["points"]) == 5
    assert series["dynamo_watchdog_trips_total"]["kind"] == "counter"
    assert "req-x" in [t["request_id"] for t in pb["traces"]]
    assert [b["bundle"] for b in prec.list_bundles()] == [pm["bundle"]]


def _probe_sequences(mods):
    inc, _f, _h, _t, slo = mods
    clk = Clock()
    tracker = slo.SloTracker(ttft_s=0.5, window_s=30.0, clock=clk)
    probe = inc.slo_probe(tracker, floor=0.8, min_requests=4)
    out = []
    for i, ttft in enumerate([0.1, 0.2, 0.9, 0.9, 0.1, 0.9, 0.1, 0.1, 0.1]):
        clk.t += 1.0
        tracker.observe(ttft, None, 5)
        out.append(probe())

    class Compiles:
        late_compiles = 0

    compiles = Compiles()
    late = inc.late_compile_probe(compiles, burst=3, window_s=10.0, clock=clk)
    for n in (0, 1, 1, 3, 3, 3, 3):
        clk.t += 4.0
        compiles.late_compiles = n
        out.append(late())
    return out


def test_probes_fire_alike():
    port, ref = _probe_sequences(PORT), _probe_sequences(REF)
    assert port == ref
    assert any(p and p["reason"] == "slo_floor" for p in port)
    assert any(p and p["reason"] == "late_compile_burst" for p in port)


def test_probe_loop_is_edge_triggered_and_rearms():
    async def go():
        state = {"bad": False}
        rec = _recorder(PORT, Clock(), cooldown_s=0.0, min_interval_s=0.0)
        rec.add_probe(lambda: {"reason": "custom", "x": 1} if state["bad"]
                      else None)
        rec.start(probe_interval_s=0.02)
        for bad in (True, True, False, True):
            state["bad"] = bad
            await asyncio.sleep(0.1)
        await rec.stop()
        return rec.captures

    assert _run(go()) == 2


def test_bundles_prune_oldest_first(tmp_path):
    async def go():
        clk = Clock()
        rec = _recorder(PORT, clk, out_dir=str(tmp_path), cooldown_s=0.0,
                        min_interval_s=0.0, max_bundles=2)
        for i in range(4):
            clk.t += 1.0
            rec.trigger(f"r{i}")
            await rec.stop()  # each capture completes before the next
            await asyncio.sleep(0.01)
        return rec

    rec = _run(go())
    assert [m["reason"] for m in rec.list_bundles()] == ["r2", "r3"]


@pytest.mark.parametrize("busy", [False, True], ids=["captured", "skipped"])
def test_incident_profile_window(tmp_path, busy):
    async def go():
        rec = _recorder(PORT, Clock(), out_dir=str(tmp_path), profile_s=0.05)
        if busy:
            assert profiling._capture_lock.acquire(blocking=False)
        try:
            rec.trigger("manual")
            await rec.stop()
        finally:
            if busy:
                profiling._capture_lock.release()
        return rec.bundles[0]

    manifest = _run(go())
    if busy:
        assert manifest["profile"] == {
            "skipped": "another profiler capture is in flight"}
        assert "profile/" not in manifest["files"]
    else:
        trace_dir = manifest["profile"]["trace_dir"]
        assert trace_dir.startswith(os.path.join(manifest["path"], "profile"))
        assert profiling.read_summary(trace_dir)["cuda"] is False
        assert "profile/" in manifest["files"]


def test_debug_incidents_route(tmp_path):
    async def go():
        plain = await HttpService(ModelManager(), "127.0.0.1", 0).start()
        rec = _recorder(PORT, Clock(), out_dir=str(tmp_path))
        svc = await HttpService(ModelManager(), "127.0.0.1", 0,
                                incidents=rec).start()
        rec.trigger("manual", request_id="r1")
        await rec.stop()
        base = f"http://127.0.0.1:{svc.port}/debug/incidents"
        try:
            with pytest.raises(HttpError) as off:
                await http_get(f"http://127.0.0.1:{plain.port}/debug/incidents",
                               2.0)
            listed = json.loads(await http_get(base, 2.0))
            bundle = listed["bundles"][0]["bundle"]
            one = json.loads(await http_get(f"{base}?id={bundle}", 2.0))
            with pytest.raises(HttpError) as missing:
                await http_get(f"{base}?id=incident-1-2-nope", 2.0)
            text = (await http_get(f"http://127.0.0.1:{svc.port}/metrics",
                                   2.0)).decode()
            return off.value.status, listed, one, missing.value.status, text
        finally:
            await svc.stop()
            await plain.stop()

    off, listed, one, missing, text = _run(go())
    assert off == 501
    assert listed["dir"] == str(tmp_path) and len(listed["bundles"]) == 1
    assert one["manifest"]["request_id"] == "r1"
    assert set(one) >= {"manifest", "flight", "traces"}
    assert missing == 404
    assert 'dynamo_incidents_total{reason="manual"} 1.0' in text
