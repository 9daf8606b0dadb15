"""The port's metric history and fleet hub against the JAX package's.

- ``telemetry/history.py``: the same seeded observations (gauges, counters
  with a reset, histogram families through ``ingest``) give the same
  latest values, deltas, rates, resets, windows and snapshots;
- ``telemetry/hub.py``: two workers' expositions served by one aiohttp
  test server, scraped on the same injected clock by the reference's hub
  (its aiohttp session) and by the port's (its own asyncio GET client):
  ``fleet_metrics``, ``fleet_workers`` and the signal source agree, a
  counter reset included; a dead target is counted, never fatal;
- ``parse_target_flag``, the discovery records the sidecars register,
  and the /fleet routes of the port's front with and without a hub.
"""

import asyncio
import json

import aiohttp
import numpy as np
import pytest
from aiohttp import web

from dynamo_tpu.telemetry import exposition as ref_expo
from dynamo_tpu.telemetry import history as ref_history
from dynamo_tpu.telemetry import hub as ref_hub
from dynamo_tpu_torch import runtime as port_rt
from dynamo_tpu_torch.http.server import http_get
from dynamo_tpu_torch.http.service import HttpService, ModelManager
from dynamo_tpu_torch.runtime.transports.memory import MemoryHub
from dynamo_tpu_torch.telemetry import exposition as port_expo
from dynamo_tpu_torch.telemetry import history as port_history
from dynamo_tpu_torch.telemetry import hub as port_hub
from dynamo_tpu_torch.telemetry.registry import MetricsRegistry


def _run(coro, timeout=60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------- history ----------

def _drive_history(hmod, emod, seed):
    clock = Clock()
    h = hmod.MetricHistory(window_s=30.0, max_samples=16, max_series=6,
                           clock=clock)
    rng = np.random.default_rng(seed)
    total = 0.0
    reads = []
    for i in range(40):
        clock.t += float(rng.uniform(0.1, 2.0))
        total += float(rng.integers(0, 5))
        if i == 20:
            total = 1.0  # the scraped process restarted
        h.observe("dyn_gauge", {"w": "a"}, float(rng.uniform(0, 1)))
        h.observe("dyn_gauge", {"w": "b"}, float(rng.uniform(0, 1)))
        h.observe("dyn_total", {"w": "a"}, total, kind="counter")
        h.observe(f"dyn_many_{i % 9}", None, 1.0)  # hits max_series
        if i % 6 == 0:
            h.ingest(emod.parse_exposition(
                "# TYPE dyn_h histogram\n"
                f'dyn_h_bucket{{le="1"}} {i}\ndyn_h_sum {i * 0.5}\n'
                f"dyn_h_count {i}\n"))
        if i % 5 == 4:
            reads.append((h.latest("dyn_gauge"), h.latest("dyn_gauge", {"w": "a"}),
                          h.delta("dyn_total"), h.rate("dyn_total", window_s=10.0),
                          h.resets("dyn_total"), h.kind("dyn_total"),
                          h.kind("dyn_h_sum"), h.window("dyn_total", window_s=8.0),
                          h.name_summaries(window_s=10.0),
                          h.series_count(), h.dropped_series))
    snap = h.snapshot(window_s=10.0)
    snap.pop("time")
    for s in snap["series"]:
        s["points"] = [[p[0], p[2]] for p in s["points"]]  # drop the wall
    return reads, snap, h.names()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_history_equal_across_a_counter_reset(seed):
    port = _drive_history(port_history, port_expo, seed)
    ref = _drive_history(ref_history, ref_expo, seed)
    assert port == ref
    assert port[0][-1][4] == 1  # the reset was detected once


def test_local_history_sampler_fills_rings():
    async def go():
        reg = MetricsRegistry()
        c = reg.counter("dyn_c_total", "c")
        sampler = port_history.LocalHistorySampler(reg, interval_s=0.02).start()
        for _ in range(5):
            c.inc()
            await asyncio.sleep(0.03)
        await sampler.stop()
        return sampler.history

    h = _run(go())
    assert h.kind("dyn_c_total") == "counter"
    assert len(h.window("dyn_c_total")) >= 2


# ---------- the hub ----------

def _worker_text(i, step):
    """Worker ``i``'s exposition at scrape ``step``: gauges that move, a
    request counter (worker b restarts at step 3), SLO verdicts."""
    reqs = step * (3 + i) if not (i == 1 and step >= 3) else step - 2
    return (
        "# TYPE dynamo_kv_block_usage_ratio gauge\n"
        f"dynamo_kv_block_usage_ratio {0.1 * (i + 1) + 0.01 * step}\n"
        "# TYPE dynamo_scheduler_slot_occupancy_ratio gauge\n"
        f"dynamo_scheduler_slot_occupancy_ratio {0.5 + 0.1 * i}\n"
        "# TYPE dynamo_scheduler_waiting_requests gauge\n"
        f"dynamo_scheduler_waiting_requests {step % 3}\n"
        "# TYPE dynamo_engine_roofline_fraction gauge\n"
        f"dynamo_engine_roofline_fraction {0.02 * (i + 1)}\n"
        "# TYPE dynamo_http_service_requests_total counter\n"
        f'dynamo_http_service_requests_total{{model="m",status="success"}} {reqs}\n'
        "# TYPE dynamo_slo_attainment_total counter\n"
        f'dynamo_slo_attainment_total{{met="true",slo="request"}} {2 * step}\n'
        f'dynamo_slo_attainment_total{{met="false",slo="request"}} {step}\n'
        "# TYPE dynamo_registry_model_info gauge\n"
        f'dynamo_registry_model_info{{model="m{i}"}} 1\n'
        "# TYPE dynamo_watchdog_trips_total counter\n"
        f'dynamo_watchdog_trips_total{{reason="decode_stall"}} {step // 2}\n')


async def _serve_texts(state):
    app = web.Application()

    async def metrics(request):
        i = int(request.match_info["i"])
        return web.Response(text=_worker_text(i, state["step"]),
                            content_type="text/plain")

    app.router.add_get("/w{i}/metrics", metrics)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, runner.addresses[0][1]


def _strip(body):
    body = dict(body)
    body.pop("time", None)
    return body


async def _drive_hubs():
    state = {"step": 0}
    runner, port = await _serve_texts(state)
    targets = [{"url": f"http://127.0.0.1:{port}/w{i}/metrics",
                "role": "decode_engine", "name": f"w{i}"} for i in range(2)]
    dead = {"url": "http://127.0.0.1:9/metrics", "role": "decode_engine",
            "name": "dead"}
    clocks = (Clock(), Clock())
    hubs = [mod.FleetHub(targets=targets + [dead], interval_s=1.0,
                         timeout_s=0.5, history_window_s=60.0, clock=clock)
            for mod, clock in ((ref_hub, clocks[0]), (port_hub, clocks[1]))]
    out = []
    try:
        for step in range(6):
            state["step"] = step
            for hub, clock in zip(hubs, clocks):
                clock.t += 1.0
                await hub.scrape_once()
            out.append([
                (_strip(h.fleet_metrics(window_s=10.0)),
                 [{k: v for k, v in row.items() if k != "error"}
                  for row in _strip(h.fleet_workers(slo_window_s=10.0))["workers"]],
                 h.signal_source()(),
                 sorted((tuple(sorted(s.labels.items())), s.value) for s in
                        ref_expo.parse_exposition(h.registry.render())
                        ["dynamo_hub_scrapes_total"].samples))
                for h in hubs])
    finally:
        for h in hubs:
            await h.stop()
        await runner.cleanup()
    return out


def test_fleet_hub_rollups_equal_over_the_same_scrapes():
    for ref, port in _run(_drive_hubs()):
        assert port == ref
    workers = {r["name"]: r for r in port[1]}
    assert workers["w0"]["up"] and workers["w1"]["up"]
    assert not workers["dead"]["up"]
    assert workers["w1"]["model"] == "m1"
    assert workers["w0"]["roofline_fraction"] == pytest.approx(0.02)


@pytest.mark.parametrize("spec,want", [
    ("decode=127.0.0.1:9001", {"url": "http://127.0.0.1:9001/metrics",
                               "role": "decode", "name": "127.0.0.1:9001"}),
    ("http://h:1/metrics", {"url": "http://h:1/metrics", "role": "worker",
                            "name": "h:1"}),
    ("prefill=http://h:2/", {"url": "http://h:2/metrics", "role": "prefill",
                             "name": "h:2"}),
])
def test_parse_target_flag_equal(spec, want):
    assert port_hub.parse_target_flag(spec) == ref_hub.parse_target_flag(spec) \
        == want


def test_sidecars_register_and_the_hub_discovers_them():
    async def go():
        drt = port_rt.DistributedRuntime.in_process(MemoryHub())
        await port_hub.register_metrics_endpoint(
            drt, "ns", "decode_engine", "w-1", "http://127.0.0.1:1/metrics")
        await port_hub.register_metrics_endpoint(
            drt, "other", "decode_engine", "w-2", "http://127.0.0.1:2/metrics")
        found = await port_hub.discovery_targets(drt, "ns")()
        await drt.close()
        return found

    assert _run(go()) == [{"url": "http://127.0.0.1:1/metrics",
                           "role": "decode_engine", "name": "w-1"}]


def test_fleet_routes_on_the_front():
    """/fleet/* answer 501 without a hub; with one, the hub's rollups of the
    frontend's own registry (its local scrape) and the hub's instruments
    in the front's /metrics."""
    async def go():
        plain = await HttpService(ModelManager(), "127.0.0.1", 0).start()
        hub = port_hub.FleetHub(interval_s=0.05)
        svc = HttpService(ModelManager(), "127.0.0.1", 0, hub=hub)
        hub.add_local("frontend", "frontend", svc.metrics.registry)
        await svc.start()
        hub.start()
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{plain.port}/fleet/workers") as r:
                    off = (r.status, await r.json())
                for _ in range(100):
                    await asyncio.sleep(0.05)
                    body = json.loads(await http_get(
                        f"http://127.0.0.1:{svc.port}/fleet/workers", 2.0))
                    if body["workers"] and body["workers"][0]["up"]:
                        break
                fm = json.loads(await http_get(
                    f"http://127.0.0.1:{svc.port}/fleet/metrics?window=5", 2.0))
                async with s.get(f"http://127.0.0.1:{svc.port}/fleet/metrics"
                                 "?window=x") as r:
                    bad = r.status
                text = (await http_get(f"http://127.0.0.1:{svc.port}/metrics",
                                       2.0)).decode()
            return off, body, fm, bad, text
        finally:
            await hub.stop()
            await svc.stop()
            await plain.stop()

    off, body, fm, bad, text = _run(go())
    assert off[0] == 501 and "--hub" in off[1]["error"]
    (row,) = body["workers"]
    assert row["name"] == "frontend" and row["up"] and row["url"] is None
    # the front's own families, as its local scrape read them
    fam = fm["families"]["dynamo_trace_store_requests"]
    assert fam["roles"]["frontend"]["workers"] == 1
    assert bad == 400
    assert 'dynamo_hub_fleet_workers_replicas{role="frontend",up="true"} 1.0' in text
