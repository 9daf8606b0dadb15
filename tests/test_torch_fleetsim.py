"""The port's fleet simulator (``dynamo_tpu_torch/sim``) against the
reference's (``dynamo_tpu/sim``), on the CPU.

- **Differential.** Each synthetic scenario under seeds 0 and 7, at the
  shortened horizons ``tests/test_fleetsim.py`` uses and one explicit peak
  (an H100 SXM's 3,350 GB/s) for both packages: the port's report JSON
  equals the reference's once the reference's two ``*_ici`` keys (its
  intra-pod pull backend, which the port refuses) are dropped. Both round
  through ``report._r``, so the comparison is exact. So do the replays of
  a ``DYN_TRACE_JSONL`` file and of an incident bundle that the port's own
  telemetry wrote, the seeded generators and the ``/metrics`` exposition.
  The reference's KV scheduler scans the pull hint's owners as a set of
  worker ids, whose order follows the process's hash seed; the port scans
  them in the overlap's order. The differential runs give the reference's
  scheduler module that order (``_InsertionOrdered``), and a test pins the
  reference's reports varying with the hash seed where the port's do not.
- **Counterparts** of the reference's suite, on the port alone at its
  default peak: virtual time, the scenarios' scale, shed, cold-start and
  recovery behaviour, replay, determinism, the CLI's gates.
- **Refusals.** ``rag_pod`` and ``WorkerSpec(pod_size > 0)`` raise by name.
- **Wall clock.** An AST scan of ``dynamo_tpu_torch/sim/`` finds no
  wall-clock read (the reference's dynlint rule ``wallclock-in-sim`` is
  scoped to ``dynamo_tpu/sim/`` and cannot see the port's tree).
"""

import ast
import asyncio
import dataclasses
import json
import os
import random
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

from dynamo_tpu.sim import scenarios as ref_scenarios
from dynamo_tpu.sim import workload as ref_workload
from dynamo_tpu_torch.cli import fleetsim
from dynamo_tpu_torch.sim import scenarios as port_scenarios
from dynamo_tpu_torch.sim.clock import VirtualClock, run_virtual
from dynamo_tpu_torch.sim.report import render_table
from dynamo_tpu_torch.sim.scenarios import (
    REFUSED_SCENARIOS,
    SCENARIOS,
    run_scenario,
)
from dynamo_tpu_torch.sim.worker import (
    POD_REFUSED,
    SimRequest,
    SimWorker,
    WorkerSpec,
)
from dynamo_tpu_torch.sim.workload import (
    GENERATORS,
    Request,
    load_incident_bundle,
    load_trace_jsonl,
)

REPO = Path(__file__).resolve().parent.parent
SIM_DIR = REPO / "dynamo_tpu_torch" / "sim"

PEAK_GBPS = 3350.0
# the shortened horizons of tests/test_fleetsim.py
SHORT = {"diurnal": 900.0, "rag": 420.0, "long_context": 420.0,
         "tenant_spike": 500.0, "chaos": 500.0}
ICI_KEYS = ("pulled_blocks_ici", "pull_transfer_s_ici")


@pytest.fixture(autouse=True)
def _default_peak(monkeypatch):
    """Every run here charges the peak it names, whatever the shell says."""
    monkeypatch.delenv("DYN_HBM_GBPS", raising=False)


class _InsertionOrdered(dict):
    """``set`` for the reference's scheduler module in the differential
    runs: the same members, iterated in the order they were added, which
    is the order the port's pull-hint scan takes."""

    def __init__(self, items=()):
        super().__init__(dict.fromkeys(items))

    def __or__(self, other):
        return _InsertionOrdered([*self, *other])

    def __sub__(self, other):
        return _InsertionOrdered(k for k in self if k not in other)


@pytest.fixture
def ref_scan_in_order(monkeypatch):
    from dynamo_tpu.kv_router import scheduler as ref_scheduler

    monkeypatch.setattr(ref_scheduler, "set", _InsertionOrdered, raising=False)


def _run_at_peak(mod, name, seed, gbps=PEAK_GBPS, **kw):
    cfg = mod.SCENARIOS[name].fleet()
    cfg.spec = dataclasses.replace(cfg.spec, hbm_gbps=gbps)
    return mod.run_scenario(name, seed=seed, fleet_cfg=cfg, **kw)


def _same_report(ref, port):
    for key in ICI_KEYS:
        assert ref["totals"].pop(key) in (0, 0.0), key
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)


# ---------------------------------------------------------------------------
# differential: the port's reports equal the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(SHORT))
def test_report_equals_reference(name, seed, ref_scan_in_order):
    ref = _run_at_peak(ref_scenarios, name, seed, duration_s=SHORT[name])
    port = _run_at_peak(port_scenarios, name, seed, duration_s=SHORT[name])
    assert port["totals"]["offered"] > 0
    _same_report(ref, port)


def test_metrics_exposition_equals_reference(ref_scan_in_order):
    """``--metrics-out``'s exposition, type for type and sample for sample
    (the port words some families' help its own way, and its recovery
    controller registers the transfer family after its own counters), but
    the recovery drain's duration (the controller times its ladder on the
    wall clock, in both packages)."""
    text = {}
    for tag, mod in (("ref", ref_scenarios), ("port", port_scenarios)):
        _run_at_peak(mod, "chaos", 0, duration_s=500.0,
                     on_fleet=lambda f, tag=tag: text.__setitem__(
                         tag, f.registry.render()))
    wall = re.compile(r"^dynamo_recovery_drain_duration_seconds_sum ")

    def samples(tag):
        lines = [ln for ln in text[tag].splitlines()
                 if not ln.startswith("# HELP")]
        assert sum(bool(wall.match(ln)) for ln in lines) == 1
        return sorted(ln for ln in lines if not wall.match(ln))

    port = samples("port")
    assert any(ln.startswith("dynamo_sim_requests_total{") for ln in port)
    assert port == samples("ref")


def _fields(reqs):
    return [dataclasses.astuple(r) for r in reqs]


def _trace_times(monkeypatch, tracing_mod, start=1_760_000_000.0, step=0.75):
    """The port's trace recorder stamps ``time.time()``: give its module a
    clock that spreads the records ``step`` seconds apart."""
    ticks = iter(start + i * step for i in range(1 << 20))
    fake = types.SimpleNamespace(time=lambda: next(ticks),
                                 monotonic=tracing_mod.time.monotonic)
    monkeypatch.setattr(tracing_mod, "time", fake)


def test_trace_jsonl_replay_equals_reference(tmp_path, monkeypatch,
                                            ref_scan_in_order):
    """A ``DYN_TRACE_JSONL`` file the port's ``TraceRecorder`` wrote loads to
    the same requests in both packages and replays to the same report."""
    from dynamo_tpu_torch.telemetry import tracing

    _trace_times(monkeypatch, tracing)
    path = tmp_path / "traces.jsonl"
    rec = tracing.TraceRecorder(capacity=256, jsonl_path=str(path))
    for i in range(150):
        rec.record(f"req-{i}", "sim-model", "completed",
                   [("ingress", 10.0 + i), ("first_token", 10.1 + i)],
                   end=10.5 + i)
    rec.close()
    assert len(path.read_text().splitlines()) == 150
    port_reqs = load_trace_jsonl(str(path))
    ref_reqs = ref_workload.load_trace_jsonl(str(path))
    assert _fields(port_reqs) == _fields(ref_reqs)
    assert port_reqs[-1].arrival_s == pytest.approx(149 * 0.75)
    ref = _run_at_peak(ref_scenarios, "replay", 0, requests=ref_reqs)
    port = _run_at_peak(port_scenarios, "replay", 0, requests=port_reqs)
    assert port["totals"]["outcomes"] == {"completed": 150}
    _same_report(ref, port)


def test_incident_bundle_replay_equals_reference(tmp_path, monkeypatch,
                                                ref_scan_in_order):
    """An incident bundle the port's ``IncidentRecorder`` captured (its
    ``traces.json``: the traces of the requests its flight ring saw) loads
    and replays alike in both packages."""
    from dynamo_tpu_torch.telemetry import flight, incidents, tracing

    _trace_times(monkeypatch, tracing, step=2.0)

    async def capture():
        ring = flight.FlightRecorder(capacity=128)
        rec = incidents.IncidentRecorder(
            incidents.IncidentConfig(out_dir=str(tmp_path), settle_s=0.0,
                                     max_traces=32),
            flight=ring, clock=lambda: 100.0)
        traces = tracing.TraceRecorder(capacity=64, jsonl_path="")
        for i in range(30):
            ring.record("scheduler.admission", request_id=f"b{i}", slot=0)
            traces.record(f"b{i}", "sim-model", "completed",
                          [("ingress", 50.0 + i), ("first_token", 50.2 + i)],
                          end=51.0 + i)
        assert rec.trigger("manual", request_id="b0") is True
        await rec.stop()
        traces.close()
        (manifest,) = rec.bundles
        return manifest["path"]

    bundle = asyncio.run(capture())
    port_reqs = load_incident_bundle(bundle)
    ref_reqs = ref_workload.load_incident_bundle(bundle)
    assert len(port_reqs) == 30
    assert _fields(port_reqs) == _fields(ref_reqs)
    ref = _run_at_peak(ref_scenarios, "replay", 0, requests=ref_reqs,
                       duration_s=300.0)
    port = _run_at_peak(port_scenarios, "replay", 0, requests=port_reqs,
                        duration_s=300.0)
    assert port["totals"]["outcomes"] == {"completed": 30}
    _same_report(ref, port)


def _rag_report_digests(package):
    """The rag report's digest (seed 0, 420 virtual s) in fresh
    interpreters under hash seeds 1 and 2."""
    script = textwrap.dedent(f"""
        import hashlib, json, logging, sys
        logging.disable(logging.CRITICAL)
        sys.path.insert(0, {str(REPO)!r})
        from {package}.sim.scenarios import SCENARIOS, run_scenario
        cfg = SCENARIOS["rag"].fleet()
        cfg.spec.hbm_gbps = {PEAK_GBPS!r}
        rep = run_scenario("rag", seed=0, duration_s=420.0, fleet_cfg=cfg)
        print(hashlib.sha1(json.dumps(rep, sort_keys=True).encode()).hexdigest())
    """)
    out = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed, JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stderr[-3000:]
        out.append(res.stdout.split()[-1])
    return out


def test_reference_rag_report_follows_the_hash_seed():
    """The reference's fault the port repaired: its pull hint among tied
    owners comes from a set of worker ids, so its rag report changes with
    the interpreter's hash seed; the port's report is the same under
    both."""
    ref_a, ref_b = _rag_report_digests("dynamo_tpu")
    port_a, port_b = _rag_report_digests("dynamo_tpu_torch")
    assert ref_a != ref_b
    assert port_a == port_b


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_equal_reference(name):
    port = GENERATORS[name](random.Random(7), duration_s=300.0)
    ref = ref_workload.GENERATORS[name](random.Random(7), duration_s=300.0)
    assert port and _fields(port) == _fields(ref)


# ---------------------------------------------------------------------------
# virtual clock
# ---------------------------------------------------------------------------


def test_virtual_time_runs_fast_and_ordered():
    clock = VirtualClock()
    order = []

    async def sleeper(tag, delay):
        await asyncio.sleep(delay)
        order.append((tag, clock()))

    async def main():
        await asyncio.gather(
            sleeper("c", 3600.0), sleeper("a", 10.0), sleeper("b", 90.0))

    run_virtual(main, clock=clock)
    # timers fire in virtual order and the clock lands on the horizon
    assert [t for t, _ in order] == ["a", "b", "c"]
    assert clock() >= 3600.0
    assert order[0][1] == pytest.approx(10.0, abs=0.5)


def test_virtual_wait_for_times_out_virtually():
    clock = VirtualClock()

    async def main():
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(asyncio.Event().wait(), timeout=120.0)

    run_virtual(main, clock=clock)
    assert 120.0 <= clock() < 200.0


def _loop_order(clock_mod, seed, debug):
    """A seeded mix of what the simulator asks of its loop: sleeps whose
    deadlines tie, call_soon from callbacks, timers past asyncio's
    100-handle line with two in three cancelled (so it rebuilds its
    heap), an Event, a wait_for deadline, a callback that raises. Returns
    the (virtual time, tag) order in which everything ran; the seeded
    draws are made as things run, so a different order changes every
    later draw."""
    rng = random.Random(seed)
    clock = clock_mod.VirtualClock()
    order = []
    errors = []

    async def main():
        loop = asyncio.get_running_loop()
        loop.set_debug(debug)
        loop.set_exception_handler(
            lambda _, ctx: errors.append(type(ctx["exception"]).__name__))
        event = asyncio.Event()
        delays = (0.0, 0.25, 0.5, 1.0)

        def mark(tag):
            order.append((loop.time(), tag))
            if rng.random() < 0.2:
                loop.call_soon(order.append, (loop.time(), "soon-" + tag))

        async def sleeper(i):
            for j in range(8):
                await asyncio.sleep(rng.choice(delays))
                mark(f"s{i}.{j}")
            if i % 3 == 0:
                await event.wait()
                mark(f"event{i}")

        def boom():
            raise ValueError("a callback that raises")

        timers = [loop.call_later(rng.choice(delays) * 4, mark, f"t{k}")
                  for k in range(300)]
        for k, timer in enumerate(timers):
            if k % 3:
                timer.cancel()
        loop.call_later(0.5, boom)
        tasks = [asyncio.ensure_future(sleeper(i)) for i in range(12)]
        try:
            await asyncio.wait_for(asyncio.sleep(10.0), 2.0)
        except asyncio.TimeoutError:
            mark("deadline")
        event.set()
        await asyncio.gather(*tasks)
        await asyncio.sleep(5.0)
        mark("end")

    clock_mod.run_virtual(main, clock=clock)
    return order, errors


@pytest.mark.parametrize("debug", [False, True], ids=["plain", "debug"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loop_runs_callbacks_in_the_reference_order(seed, debug):
    """The port's virtual-time loop (its own timer heap and iteration)
    runs callbacks in exactly the order of the reference's, which is
    asyncio's own loop under a time-warping selector."""
    from dynamo_tpu.sim import clock as ref_clock
    from dynamo_tpu_torch.sim import clock as port_clock

    port = _loop_order(port_clock, seed, debug)
    assert port == _loop_order(ref_clock, seed, debug)
    order, errors = port
    assert errors == ["ValueError"]
    assert len(order) > 200 and "end" in [tag for _, tag in order[-2:]]
    assert len({t for t, _ in order}) < len(order)  # deadlines tied


# ---------------------------------------------------------------------------
# scenario behaviour (short horizons; the CLI runs the full ones)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chaos_report():
    return run_scenario("chaos", seed=0, duration_s=500.0)


def _report_shape_ok(rep):
    assert rep["totals"]["offered"] > 0
    assert rep["capacity"]["curve"], "capacity curve is empty"
    for point in rep["capacity"]["curve"]:
        assert 0.0 <= point["slo_attainment"] <= 1.0
    assert rep["windows"]
    assert isinstance(rep["capacity"]["capacity_qps"], float)
    assert not set(ICI_KEYS) & set(rep["totals"])
    # renders, and carries the headline number
    assert "capacity=" in render_table(rep)


def test_diurnal_scales_up_and_down():
    rep = run_scenario("diurnal", seed=0, duration_s=900.0)
    _report_shape_ok(rep)
    scale_dirs = [e["direction"] for e in rep["timeline"]
                  if e["kind"] == "scale"]
    assert "up" in scale_dirs and "down" in scale_dirs
    assert rep["totals"]["outcomes"].get("completed", 0) > 0
    assert rep["totals"]["slo_attainment"] >= rep["slo_floor"]


def test_diurnal_full_run_scales_aux_pool_to_zero():
    rep = run_scenario("diurnal", seed=0)   # the full 1,800 s horizon
    assert rep["duration_s"] == 1800.0
    zero = [e for e in rep["timeline"] if e["kind"] == "scale_to_zero"]
    assert zero and zero[0]["model"] == "sim-aux"


def test_rag_exercises_prefix_reuse_and_cold_tier():
    rep = run_scenario("rag", seed=0, duration_s=420.0)
    _report_shape_ok(rep)
    t = rep["totals"]
    assert t["prefix_hit_tokens"] > 0, "no hot prefix reuse"
    assert t["pulled_blocks"] > 0, "no fabric peer pull modeled"
    assert t["pull_transfer_s_tcp"] > 0.0
    assert t["cold_blocks"] > 0, "no cold-tier rehydration modeled"


def test_prefill_plan_costs_a_pull_at_the_tcp_rate():
    """The byte model charges a peer pull its blocks' bytes at
    ``peer_pull_gbps``, the reference's charge for a pull over tcp."""
    from dynamo_tpu.sim import worker as ref_worker

    plans = []
    for mod in (ref_worker, None):
        spec_cls, sr_cls, w_cls, req_cls = (
            (mod.WorkerSpec, mod.SimRequest, mod.SimWorker,
             ref_workload.Request) if mod else
            (WorkerSpec, SimRequest, SimWorker, Request))
        spec = spec_cls(peer_pull_gbps=40.0, hbm_gbps=PEAK_GBPS)
        w = w_cls("w0", "sim-model", spec, clock=lambda: 0.0)
        sr = sr_cls(req_cls(arrival_s=0.0, request_id="r0", isl=4096),
                    arrival_t=0.0)
        sr.pulled_blocks = 64
        plans.append((w._prefill_plan(sr), sr.pull_transfer_s))
    (ref_plan, ref_s), (port_plan, port_s) = plans
    assert port_plan == ref_plan
    assert port_s == ref_s == pytest.approx(64 * 16 * 131072.0 / 40e9)
    assert port_plan[0] == pytest.approx(port_s)


def test_long_context_routes_sp_prefills():
    seen = {}
    rep = run_scenario(
        "long_context", seed=0, duration_s=420.0,
        on_fleet=lambda f: seen.update(
            sp_bytes=sum(w.tracker.prefill_bytes
                         for w in f.workers.values())))
    _report_shape_ok(rep)
    assert rep["totals"]["outcomes"].get("completed", 0) > 0
    # prefill_sp is the only program whose bytes the tracker folds in
    assert seen["sp_bytes"] > 0.0


def test_tenant_spike_quota_sheds_attributed_to_tenant():
    rep = run_scenario("tenant_spike", seed=0, duration_s=500.0)
    _report_shape_ok(rep)
    assert rep["totals"]["outcomes"].get("quota", 0) > 0
    by_tenant = rep["shed_by_tenant"]
    assert by_tenant["burst-tenant"]["shed_rate"] > 0.3
    for tenant in ("acme", "globex"):
        assert by_tenant[tenant]["shed_rate"] < 0.05
    # the zero-replica aux pool cold-started on demand
    assert any(e["kind"] == "cold_start" for e in rep["timeline"])


def test_chaos_shed_episode_spares_highest_priority(chaos_report):
    rep = chaos_report
    shed = sum(v for k, v in rep["totals"]["outcomes"].items()
               if k not in ("completed", "failed"))
    assert shed > 0, "no shed episode during the outage"
    by_prio = rep["shed_by_priority"]
    assert by_prio["0"]["shed_rate"] > by_prio["2"]["shed_rate"]
    assert by_prio["2"]["shed_rate"] < 0.05


def test_chaos_trips_watchdog_drains_and_respawns(chaos_report):
    rep = chaos_report
    kinds = [e["kind"] for e in rep["timeline"]]
    assert kinds.count("watchdog_trip") == 1, "one wedge, one trip"
    assert "chaos" in kinds and "respawn" in kinds
    (summary,) = rep["recoveries"]
    assert summary["reason"] == "decode_stall"
    assert summary["respawned"] is True
    assert summary["migrated"] == 0          # the sim runs migrate=False
    assert summary["failed"] > 0             # in-flight requests failed over
    # drained requests were resubmitted and completed: no request lost
    assert rep["totals"]["resubmits"] >= summary["failed"]
    assert rep["totals"]["outcomes"].get("failed", 0) == 0


def test_chaos_flight_ladder_matches_recovery_pins(chaos_report):
    """The port's recovery controller fires the reference's flight ladder:
    drain, each in-flight request failed, respawn."""
    kinds = chaos_report["flight_kinds"]
    d = kinds.index("recovery.drain")
    r = kinds.index("recovery.respawn")
    fails = [i for i, k in enumerate(kinds)
             if k == "recovery.request_failed"]
    assert fails and d < min(fails) and max(fails) < r


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------


def _write_trace(path, n=120, start=1700000000.0):
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            f.write(json.dumps({
                "request_id": f"r{i}",
                "time": start + i * 1.5,
                "model": "sim-model",
                "tenant": "t1" if i % 3 else "t2",
                "priority": i % 3,
            }) + "\n")


def test_trace_jsonl_replay(tmp_path):
    path = str(tmp_path / "traces.jsonl")
    _write_trace(path)
    reqs = load_trace_jsonl(path)
    assert len(reqs) == 120
    assert reqs[0].arrival_s == 0.0          # normalized to t=0
    assert all(r.isl > 0 and r.osl > 0 for r in reqs)
    # the same file loads to identical sizes (crc32, not a salted hash())
    again = load_trace_jsonl(path)
    assert _fields(reqs) == _fields(again)
    rep = run_scenario("replay", seed=0, requests=reqs)
    assert rep["totals"]["outcomes"].get("completed", 0) == 120


def test_incident_bundle_replay(tmp_path):
    traces = [{"request_id": f"b{i}", "time": 500.0 + i * 2.0,
               "isl": 300 + i, "osl": 40}
              for i in range(40)]
    (tmp_path / "traces.json").write_text(json.dumps(traces))
    reqs = load_incident_bundle(str(tmp_path))
    assert len(reqs) == 40
    assert reqs[0].isl == 300                # explicit sizes honored
    rep = run_scenario("replay", seed=0, requests=reqs, duration_s=300.0)
    assert rep["totals"]["outcomes"].get("completed", 0) == 40


def test_replay_scenario_requires_a_trace():
    with pytest.raises(ValueError):
        run_scenario("replay", seed=0)


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------


def test_report_byte_identical_same_seed(chaos_report):
    again = run_scenario("chaos", seed=0, duration_s=500.0)
    assert json.dumps(chaos_report, sort_keys=True) == \
        json.dumps(again, sort_keys=True)


def test_report_differs_across_seeds():
    a = run_scenario("tenant_spike", seed=1, duration_s=300.0)
    b = run_scenario("tenant_spike", seed=2, duration_s=300.0)
    assert json.dumps(a, sort_keys=True) != json.dumps(b, sort_keys=True)


def test_generators_are_seed_deterministic():
    for name, gen in GENERATORS.items():
        a = gen(random.Random(7), duration_s=120.0)
        b = gen(random.Random(7), duration_s=120.0)
        assert [(r.request_id, r.arrival_s, r.isl, r.osl) for r in a] == \
               [(r.request_id, r.arrival_s, r.isl, r.osl) for r in b], name
        assert all(0.0 <= r.arrival_s < 120.0 for r in a), name


def test_rag_generator_emits_shared_prefix_groups():
    reqs = GENERATORS["rag"](random.Random(0), duration_s=120.0)
    assert len({r.prefix_group for r in reqs}) > 1
    assert all(r.prefix_tokens > 0 for r in reqs)


# ---------------------------------------------------------------------------
# the wall clock: an AST scan of the port's sim/ (import aliases resolved)
# ---------------------------------------------------------------------------

BANNED = {"time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
          "time.perf_counter", "time.perf_counter_ns", "time.sleep",
          "datetime.datetime.now", "datetime.datetime.utcnow",
          "datetime.date.today"}


def _wall_clock_reads(source: str):
    """(line, call) of every wall-clock read in ``source``: the banned
    dotted calls through any import alias, and ``<...loop...>.time()``."""
    tree = ast.parse(source)
    names = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                names[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                names[a.asname or a.name] = f"{node.module}.{a.name}"

    def dotted(func):
        parts = []
        while isinstance(func, ast.Attribute):
            parts.append(func.attr)
            func = func.value
        if not isinstance(func, ast.Name) or func.id not in names:
            return None
        return ".".join([names[func.id], *reversed(parts)])

    found = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name in BANNED:
            found.append((node.lineno, name))
        elif (name is None and isinstance(node.func, ast.Attribute)
              and node.func.attr == "time"
              and isinstance(node.func.value, ast.Name)
              and "loop" in node.func.value.id):
            found.append((node.lineno, f"{node.func.value.id}.time"))
    return found


@pytest.mark.parametrize("source, call", [
    ("import time\ntime.time()", "time.time"),
    ("import time as t\nt.monotonic()", "time.monotonic"),
    ("from time import perf_counter as pc\npc()", "time.perf_counter"),
    ("from datetime import datetime\ndatetime.now()", "datetime.datetime.now"),
    ("import datetime as dt\ndt.datetime.utcnow()", "datetime.datetime.utcnow"),
    ("import asyncio\nloop = asyncio.get_event_loop()\nloop.time()",
     "loop.time"),
])
def test_wall_clock_scan_sees_through_aliases(source, call):
    assert [c for _, c in _wall_clock_reads(source)] == [call]


def test_no_wall_clock_reads_in_sim_package():
    files = sorted(SIM_DIR.glob("*.py"))
    assert len(files) == 8
    assert _wall_clock_reads("def time(self):\n    return self.clock()") == []
    found = {p.name: _wall_clock_reads(p.read_text(encoding="utf-8"))
             for p in files}
    assert not any(found.values()), found


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_rag_pod_is_refused_by_name(capsys):
    assert "rag_pod" in ref_scenarios.SCENARIOS
    assert set(REFUSED_SCENARIOS) == {"rag_pod"}
    assert "rag_pod" not in SCENARIOS
    with pytest.raises(NotImplementedError, match="rag_pod"):
        run_scenario("rag_pod", seed=0, duration_s=60.0)
    with pytest.raises(SystemExit) as e:
        fleetsim.main(["--scenario", "rag_pod"])
    assert e.value.code == 2
    assert "rag_pod" in capsys.readouterr().err


def test_pod_size_is_refused_by_name():
    with pytest.raises(NotImplementedError) as e:
        WorkerSpec(pod_size=8)
    assert str(e.value) == POD_REFUSED and "pod_size" in POD_REFUSED
    with pytest.raises(NotImplementedError):
        dataclasses.replace(WorkerSpec(), pod_size=1)
    assert not hasattr(WorkerSpec(), "ici_pull_gbps")


# ---------------------------------------------------------------------------
# the CLI: ``python3 -m dynamo_tpu_torch.cli.fleetsim``
# ---------------------------------------------------------------------------


def test_cli_exits_2_when_slo_floor_violated(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = fleetsim.main(["--scenario", "chaos", "--duration", "400",
                        "--slo-floor", "1.01", "--json-out", str(out)])
    assert rc == 2
    assert json.loads(out.read_text())["slo_floor"] == 1.01
    assert "SLO floor violated" in capsys.readouterr().err


def test_cli_exits_3_when_speedup_missed(capsys):
    rc = fleetsim.main(["--scenario", "rag", "--duration", "120",
                        "--speedup", "1e12"])
    assert rc == 3
    assert "speedup target missed" in capsys.readouterr().err


def test_cli_lists_scenarios_and_passes_gate(tmp_path, capsys):
    assert fleetsim.main(["--list"]) == 0
    listing = capsys.readouterr().out
    for name in SCENARIOS:
        assert name in listing
    assert "rag_pod" not in listing
    metrics = tmp_path / "metrics.prom"
    rc = fleetsim.main(["--scenario", "long_context", "--duration", "300",
                        "--metrics-out", str(metrics)])
    assert rc == 0
    exposition = metrics.read_text()
    for family in ("dynamo_sim_requests_total",
                   "dynamo_sim_virtual_time_seconds",
                   "dynamo_planner_admissions_total"):
        assert family in exposition
    capsys.readouterr()


def test_cli_json_equals_run_scenario(capsys):
    """``--json`` prints the report ``run_scenario`` returns, and the
    wall-clock facts go to stderr only."""
    assert fleetsim.main(["--scenario", "tenant_spike", "--seed", "3",
                          "--duration", "200", "--json"]) == 0
    out, err = capsys.readouterr()
    rep = run_scenario("tenant_spike", seed=3, duration_s=200.0)
    assert json.loads(out) == json.loads(json.dumps(rep))
    assert "realtime" in err and "realtime" not in out


def test_cli_replay_needs_a_trace(capsys):
    with pytest.raises(SystemExit) as e:
        fleetsim.main(["--scenario", "replay"])
    assert e.value.code == 2
    assert "--trace or --bundle" in capsys.readouterr().err
