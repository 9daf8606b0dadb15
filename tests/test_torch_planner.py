"""The port's closed-loop SLA planner against the JAX package's.

``dynamo_tpu_torch/planner/{signals,policy,planner,actuation}.py`` are the
port's copies of ``dynamo_tpu/planner``: the same scripted signal feeds
(``tests/test_planner.py``'s, and feeds drawn from a seed) go through both
``SignalStore`` / ``SlaPolicy`` pairs on one injected clock, and every
comparison is exact: the window aggregates (to 1e-12), the action lists
with their reasons, the shed level, the rebalance threshold, cooldowns,
bounds and ``rollback``. Both ``Planner`` loops step the same scripted
sources into recording actuators (a failing source and a failing actuator
skipped in both): the same actions, the same ``dynamo_planner_*``
exposition samples and ``planner.action`` flight events. The actuators:
``KubeActuator`` over both ``InMemoryKube``s, ``StoreScaleActuator``
against both packages' api-stores crosswise, ``LocalActuator``'s admission
knobs and its ``DisaggRouter`` key over the port's dynstore.
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest
from test_torch_deploy import ref_to_port

from dynamo_tpu import planner as ref
from dynamo_tpu.deploy import operator as ref_operator
from dynamo_tpu.telemetry.flight import FlightRecorder as RefFlight
from dynamo_tpu_torch import planner as port
from dynamo_tpu_torch.deploy import operator as port_operator
from dynamo_tpu_torch.telemetry.flight import FlightRecorder as PortFlight

PKGS = {"ref": (ref, ref_operator, RefFlight),
        "port": (port, port_operator, PortFlight)}


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# tests/test_planner.py's make_policy defaults
BASE = dict(
    window_s=10.0, prefill_queue_wait_up_s=1.0, prefill_queue_wait_down_s=0.1,
    prefill_queue_depth_up=4.0, decode_busy_up=0.9, decode_busy_down=0.3,
    decode_waiting_up=4.0, min_replicas=1, max_replicas=3,
    scale_up_cooldown_s=30.0, scale_down_cooldown_s=120.0,
    rebalance_cooldown_s=30.0, shed_step_cooldown_s=5.0,
    relax_after_clear_s=30.0)

SIGNALS = ("prefill.queue_wait_s", "prefill.queue_depth",
           "decode.slot_busy_ratio", "decode.waiting", "kv.usage_ratio",
           "watchdog.trips", "admission.queue_depth",
           "admission.inflight_ratio", "slo.attainment")


def _action(a):
    return (type(a).__name__, dataclasses.asdict(a))


# ------------------------------------------------------------------ signals


@pytest.mark.parametrize("seed", range(4))
def test_signal_store_aggregates_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    clock = Clock()
    window, cap = float(rng.choice([5.0, 10.0, 100.0])), int(rng.choice([8, 1024]))
    stores = [ns.SignalStore(window_s=window, max_samples=cap, clock=clock)
              for ns in (ref, port)]
    names = ["a", "b", "c"]
    checked = 0
    for _ in range(300):
        clock.advance(float(rng.exponential(1.5)))
        kind = rng.integers(0, 4)
        if kind == 0:
            name, v = names[rng.integers(0, 3)], float(rng.normal(0, 5))
            for s in stores:
                s.observe(name, v)
        elif kind == 1:
            # a sample stamped in the past, as a source's own clock gives it
            t = clock.t - float(rng.uniform(0, 20))
            for s in stores:
                s.observe("a", 1.25, t=t)
        elif kind == 2:
            vals = {"a": float(rng.normal()), "b": int(rng.integers(0, 9)),
                    "c": True, "d": "text"}
            for s in stores:
                s.observe_many(vals)
        for name in names + ["missing"]:
            w = float(rng.choice([1.0, 3.0, 50.0]))
            got = [(s.latest(name), s.latest(name, 7.0), s.age(name),
                    s.mean(name), s.mean(name, w), s.max(name, w),
                    s.min(name), s.min(name, w, default=-1.0), s.delta(name),
                    s.delta(name, w), s.names()) for s in stores]
            want, have = got
            for x, y in zip(want, have):
                if isinstance(x, float) and isinstance(y, float):
                    assert abs(x - y) <= 1e-12
                else:
                    assert x == y
            checked += 1
    assert checked == 1200


# ------------------------------------------------------------------- policy

# a step: (seconds to advance, observations, actions applied?)
SCRIPTS = {
    # tests/test_planner.py's feeds
    "prefill_up_cooldown_max": ({"prefill": 1, "decode": 1}, {}, [
        (0.0, {"prefill.queue_wait_s": 2.0}, True),
        (5.0, {"prefill.queue_wait_s": 2.0}, True),
        (30.0, {"prefill.queue_wait_s": 2.0}, True),
        (31.0, {"prefill.queue_wait_s": 2.0}, True)]),
    "prefill_dead_zone_then_down": ({"prefill": 2}, {}, [
        (0.0, {"prefill.queue_wait_s": 0.5, "prefill.queue_depth": 0.0}, True),
        (11.0, {"prefill.queue_wait_s": 0.01, "prefill.queue_depth": 0.0}, True),
        (121.0, {"prefill.queue_wait_s": 0.01, "prefill.queue_depth": 0.0}, True)]),
    "down_waits_longer_cooldown": ({"decode": 2}, {}, [
        (0.0, {"decode.slot_busy_ratio": 0.95}, True),
        (40.0, {"decode.slot_busy_ratio": 0.0, "decode.waiting": 0.0}, True),
        (120.0, {"decode.slot_busy_ratio": 0.0}, True)]),
    "unknown_role": ({}, {}, [(0.0, {"prefill.queue_wait_s": 5.0}, True)]),
    "rebalance_both_ways": ({}, {}, [
        (0.0, {"prefill.queue_depth": 5.0, "decode.slot_busy_ratio": 0.5}, True),
        (5.0, {"prefill.queue_depth": 5.0, "decode.slot_busy_ratio": 0.5}, True),
        (31.0, {"prefill.queue_depth": 0.0, "decode.slot_busy_ratio": 0.95}, True)]),
    "rebalance_clamps": ({}, {"max_local_prefill_length": 1500}, [
        (0.0, {"prefill.queue_depth": 5.0, "decode.slot_busy_ratio": 0.5}, True)]),
    "shed_ladder_and_relax": ({}, {}, [
        (0.0, {"watchdog.trips": 0.0}, True),
        (1.0, {"watchdog.trips": 1.0}, True),
        (1.0, {"watchdog.trips": 2.0}, True),
        (6.0, {"watchdog.trips": 3.0}, True),
        (6.0, {"watchdog.trips": 4.0}, True),
        (15.0, {"watchdog.trips": 4.0}, True),
        (31.0, {"watchdog.trips": 4.0}, True),
        (31.0, {"watchdog.trips": 4.0}, True)]),
    "kv_saturation": ({}, {"saturation_kv_usage": 0.95, "saturation_busy": 0.95,
                           "saturation_waiting": 3.0}, [
        (0.0, {"kv.usage_ratio": 0.99}, True)]),
    "busy_saturation": ({}, {"saturation_busy": 0.95, "saturation_waiting": 3.0}, [
        (0.0, {"decode.slot_busy_ratio": 0.99, "decode.waiting": 5.0}, True)]),
    "depth_alone": ({"prefill": 1}, {}, [
        (0.0, {"prefill.queue_depth": 10.0}, True)]),
    "admission_signals_alone": ({}, {"saturation_admission_queue": 4.0}, [
        (0.0, {"admission.queue_depth": 8.0, "admission.inflight_ratio": 1.0},
         True)]),
    "blind_past_window": ({"prefill": 2}, {}, [
        (0.0, {"prefill.queue_depth": 7.0}, True),
        (11.0, {}, True)]),
    "unapplied_rolls_back": ({}, {}, [
        (0.0, {"kv.usage_ratio": 0.99}, False),
        (6.0, {"kv.usage_ratio": 0.99}, False),
        (6.0, {"kv.usage_ratio": 0.99}, True)]),
    # the SLO floor (the edge's planner) and a decode burst that scales up
    # twice and back down past the window and the 4x cooldown
    "slo_floor": ({}, {}, [
        (0.0, {"slo.attainment": 0.5}, True),
        (6.0, {"slo.attainment": 0.4}, True),
        (60.0, {"slo.attainment": 1.0}, True),
        (31.0, {"slo.attainment": 1.0}, True)]),
    "decode_burst_up_and_down": ({"decode": 1}, {
        "scale_up_cooldown_s": 1.0, "scale_down_cooldown_s": 4.0}, [
        (0.5, {"decode.slot_busy_ratio": 1.0, "decode.waiting": 8.0}, True),
        (0.5, {"decode.slot_busy_ratio": 1.0, "decode.waiting": 8.0}, True),
        (0.5, {"decode.slot_busy_ratio": 1.0, "decode.waiting": 6.0}, True),
        (0.5, {"decode.slot_busy_ratio": 1.0, "decode.waiting": 2.0}, True),
        *[(0.5, {"decode.slot_busy_ratio": 0.0, "decode.waiting": 0.0}, True)
          for _ in range(40)]]),
}


def _run_policy(ns, replicas0, overrides, steps):
    clock = Clock()
    signals = ns.SignalStore(clock=clock)
    policy = ns.SlaPolicy(ns.PolicyConfig(**dict(BASE, **overrides)),
                          clock=clock)
    replicas = dict(replicas0)
    trace = []
    for dt, obs, apply in steps:
        clock.advance(dt)
        for name, v in obs.items():
            signals.observe(name, v)
        actions = policy.decide(signals, dict(replicas))
        for a in actions:
            if not apply:
                policy.rollback(a)
            elif type(a).__name__ == "ScaleAction":
                replicas[a.role] = a.target_replicas
        trace.append(([_action(a) for a in actions], policy.shed_level,
                      policy.local_prefill_length, dict(replicas),
                      dict(policy._last_scale_t), policy._clear_since))
    return trace


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_policy_scripted_feeds_match_the_reference(name):
    replicas0, overrides, steps = SCRIPTS[name]
    want = _run_policy(ref, replicas0, overrides, steps)
    got = _run_policy(port, replicas0, overrides, steps)
    assert got == want
    if name != "unknown_role":
        assert any(actions for actions, *_ in want), name


def _random_steps(rng, n=60):
    steps = []
    for _ in range(n):
        obs = {}
        for sig in SIGNALS:
            if rng.random() < 0.4:
                if sig == "watchdog.trips":
                    obs[sig] = float(rng.integers(0, 3))
                elif sig in ("prefill.queue_depth", "decode.waiting",
                             "admission.queue_depth"):
                    obs[sig] = float(rng.integers(0, 12))
                elif sig == "prefill.queue_wait_s":
                    obs[sig] = float(rng.choice([0.0, 0.05, 0.5, 2.0]))
                else:
                    obs[sig] = float(rng.choice([0.0, 0.2, 0.5, 0.92, 0.97, 1.0]))
        steps.append((float(rng.choice([0.0, 0.5, 2.0, 6.0, 15.0, 35.0, 125.0])),
                      obs, bool(rng.random() < 0.8)))
    return steps


@pytest.mark.parametrize("seed", range(8))
def test_policy_seeded_feeds_match_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    replicas0 = {r: int(rng.integers(1, 4)) for r in ("prefill", "decode")
                 if rng.random() < 0.8}
    overrides = dict(scale_up_cooldown_s=float(rng.choice([1.0, 30.0])),
                     scale_down_cooldown_s=float(rng.choice([4.0, 120.0])),
                     max_replicas=int(rng.integers(2, 6)))
    steps = _random_steps(rng)
    want = _run_policy(ref, replicas0, overrides, steps)
    assert _run_policy(port, replicas0, overrides, steps) == want
    kinds = {a[0] for actions, *_ in want for a in actions}
    assert len(kinds) >= 2, kinds


# ------------------------------------------------------------- the planner


def _samples(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith("dynamo_planner_"))


def _events(flight):
    return [(e["kind"], e.get("data")) for e in flight.snapshot()]


async def _run_planner(key, feed):
    ns, _, flight_cls = PKGS[key]
    clock = Clock()
    flight = flight_cls(64)
    applied_log = []

    class Recording:
        """Claims scale and admission actions; fails on every third."""

        def __init__(self):
            self.n = 0
            self.replica_map = {"prefill": 1, "decode": 1}

        def replicas(self):
            return dict(self.replica_map)

        async def apply(self, action):
            name = type(action).__name__
            if name == "RebalanceAction":
                return False
            self.n += 1
            if self.n % 3 == 0:
                raise RuntimeError("actuator down")
            if name == "ScaleAction":
                self.replica_map[action.role] = action.target_replicas
            applied_log.append(_action(action))
            return True

    class Declining:
        async def apply(self, action):
            return False

    it = iter(feed)

    def source():
        return next(it)

    def failing():
        if clock.t % 2 < 1:
            raise ValueError("source down")
        return {"decode.waiting": 0.0}

    planner = ns.Planner(
        policy=ns.SlaPolicy(ns.PolicyConfig(**dict(
            BASE, scale_up_cooldown_s=1.0, scale_down_cooldown_s=4.0)),
            clock=clock),
        sources=[failing, source], actuators=[Declining(), Recording()],
        flight=flight, clock=clock)
    trace = []
    for _ in feed:
        clock.advance(0.75)
        actions = await planner.step()
        trace.append([_action(a) for a in actions])
    return dict(trace=trace, applied=applied_log,
                audit=[_action(a) for a in planner.actions_applied],
                samples=_samples(planner.registry.render()),
                events=_events(flight), shed=planner.policy.shed_level)


@pytest.mark.parametrize("seed", range(3))
def test_planner_loop_matches_the_reference(seed):
    rng = np.random.default_rng(200 + seed)
    feed = [{k: v for k, v in _random_steps(rng, 1)[0][1].items()}
            for _ in range(40)]
    want = asyncio.run(_run_planner("ref", feed))
    got = asyncio.run(_run_planner("port", feed))
    assert got == want
    assert want["applied"] and want["events"]
    assert any('applied="false"' in s for s in want["samples"])


def test_planner_loop_task_starts_and_stops():
    async def main():
        clock = Clock()
        planner = port.Planner(sources=[lambda: {"prefill.queue_wait_s": 0.0}],
                               flight=PortFlight(16), clock=clock)
        planner.config.interval_s = 0.01
        planner.start()
        await asyncio.sleep(0.05)
        planner.stop()
        assert planner._task is None
        return planner.registry.render()

    text = asyncio.run(main())
    n = [line for line in text.splitlines()
         if line.startswith("dynamo_planner_cycles_total")]
    assert n and float(n[0].split()[-1]) >= 2


def test_engine_aggregator_and_slo_sources_match_the_reference():
    m = {"request_total_slots": 8, "request_active_slots": 6,
         "kv_total_blocks": 100, "kv_active_blocks": 40,
         "num_requests_waiting": 5, "prefill_queue_depth": 2}
    assert (port.engine_metrics_source(lambda: m)()
            == ref.engine_metrics_source(lambda: m)())
    assert port.engine_metrics_source(lambda: {})() == ref.engine_metrics_source(
        lambda: {})()

    from dynamo_tpu.kv_router.protocols import ForwardPassMetrics as RefFpm
    from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics as PortFpm

    rows = [dict(request_active_slots=a, request_total_slots=8,
                 kv_active_blocks=k, kv_total_blocks=64, num_requests_waiting=w)
            for a, k, w in ((8, 40, 6), (3, 10, 0))]

    class Agg:
        def __init__(self, cls):
            self.endpoints = {f"w{i}": cls(**r) for i, r in enumerate(rows)}

    assert (port.aggregator_source(Agg(PortFpm))()
            == ref.aggregator_source(Agg(RefFpm))())

    class Tracker:
        def snapshot(self):
            return {"slo.attainment": 0.25}

    t = Tracker()
    assert port.slo_source(t)() == ref.slo_source(t)() == {"slo.attainment": 0.25}


# ---------------------------------------------------------------- actuators


def _cr(prefill=1, decode=1):
    return {
        "apiVersion": "dynamo.tpu/v1alpha1",
        "kind": "DynamoTpuGraphDeployment",
        "metadata": {"name": "g1", "namespace": "serving", "uid": "u-1"},
        "spec": {"image": "dynamo-tpu:test", "namespace": "public",
                 "services": {
                     "prefill": {"role": "prefill", "replicas": prefill,
                                 "modelPath": "/m"},
                     "decode": {"role": "decode", "replicas": decode,
                                "modelPath": "/m"}}},
    }


def test_kube_actuator_lands_the_same_objects():
    async def main(key):
        ns, op, _ = PKGS[key]
        kube = op.InMemoryKube()
        actuator = ns.KubeActuator(op.Reconciler(kube), _cr())
        out = []
        for role, target in (("prefill", 2), ("decode", 3), ("prefill", 1),
                              ("nope", 2)):
            ok = await actuator.apply(ns.ScaleAction(
                role=role, target_replicas=target, current_replicas=1,
                reason="t"))
            out.append((ok, actuator.replicas()))
        declined = await actuator.apply(ns.AdmissionAction(
            shed_level=1, limit=None, reason="t"))
        return out, declined, kube.objects

    want = asyncio.run(main("ref"))
    got = asyncio.run(main("port"))
    assert got[:2] == want[:2]
    assert got[2] == {k: ref_to_port(v) for k, v in want[2].items()}
    assert want[0][1] == (True, {"prefill": 2, "decode": 3})
    assert want[0][3][0] is False and want[1] is False


@pytest.mark.parametrize("store,client", [("ref", "port"), ("port", "ref")])
def test_store_scale_actuator_and_client_crosswise(store, client):
    """The port's actuator and client against the JAX api-store (aiohttp),
    and the JAX ones against the port's: the same records."""
    from dynamo_tpu.deploy import api_store as ref_store
    from dynamo_tpu.deploy import store_source as ref_source
    from dynamo_tpu_torch.deploy import api_store as port_store
    from dynamo_tpu_torch.deploy import store_source as port_source

    stores = {"ref": ref_store, "port": port_store}
    sources = {"ref": ref_source, "port": port_source}
    ns = PKGS[client][0]

    async def main():
        svc = stores[store].ApiStoreService(
            stores[store].DeploymentStore(":memory:"), "127.0.0.1", 0)
        await svc.start()
        loop = asyncio.get_running_loop()
        try:
            c = sources[client].ApiStoreClient(f"http://127.0.0.1:{svc.port}")
            spec = {"services": {"decode": {"role": "decode", "replicas": 1}}}
            await loop.run_in_executor(None, c.create, "g1", spec)
            act = ns.StoreScaleActuator(c, "g1")
            out = [await act.replicas()]
            for role, target in (("decode", 3), ("prefill", 2)):
                out.append(await act.apply(ns.ScaleAction(
                    role=role, target_replicas=target, current_replicas=1,
                    reason="t")))
                out.append(await act.replicas())
            missing = ns.StoreScaleActuator(c, "nope")
            out.append(await missing.apply(ns.ScaleAction(
                role="decode", target_replicas=2, current_replicas=1,
                reason="t")))
            out.append(await missing.replicas())
            rec = await loop.run_in_executor(None, c.get, "g1")
            return out, {k: rec[k] for k in ("name", "spec", "status")}
        finally:
            await svc.stop()

    out, rec = asyncio.run(main())
    assert out == [{"decode": 1}, True, {"decode": 3}, True,
                   {"decode": 3, "prefill": 2}, False, {}]
    assert rec == {"name": "g1", "status": None, "spec": {"services": {
        "decode": {"role": "decode", "replicas": 3},
        "prefill": {"role": "prefill", "replicas": 2}}}}


def test_local_actuator_sets_the_same_knobs_and_router_key():
    """Admission shed level and limit as the reference's; the rebalance
    lands on an in-process DisaggRouter and on the discovery key every
    live router watches, written over the port's dynstore, read back with
    the reference's key function and decoded as the reference's value."""
    from dynamo_tpu.disagg import router as ref_router_mod
    from dynamo_tpu.runtime.transports.memory import MemoryHub
    from dynamo_tpu.runtime.component import DistributedRuntime as RefDrt
    from dynamo_tpu_torch.disagg.router import DisaggRouter as PortRouter
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.dynstore import DynStoreServer
    from dynamo_tpu_torch.runtime.wire import unpackb

    # the key as the reference's router names it
    REF_KEY = ref_router_mod.DisaggRouter(
        namespace="graph", model_name="llama").config_key()
    actions = lambda ns: [  # noqa: E731
        ns.RebalanceAction(max_local_prefill_length=2000,
                           max_prefill_queue_size=3, reason="t"),
        ns.AdmissionAction(shed_level=1, limit=8, reason="t"),
        ns.AdmissionAction(shed_level=0, limit=None, reason="t"),
        ns.ScaleAction(role="decode", target_replicas=2, current_replicas=1,
                       reason="t")]

    async def port_side():
        server = DynStoreServer(port=0)
        await server.start()
        drt = await DistributedRuntime.connect(port=server.port)
        try:
            router = PortRouter(max_local_prefill_length=1000,
                                max_prefill_queue_size=2)
            adm = port.AdmissionController(port.AdmissionConfig(limit=4),
                                           flight=PortFlight(16))
            act = port.LocalActuator(disagg_router=router, admission=adm,
                                     discovery=drt.discovery,
                                     namespace="graph", model_name="llama")
            out = []
            for a in actions(port):
                out.append((await act.apply(a), adm.shed_level, adm.limit))
            kv = await drt.discovery.kv_get(REF_KEY)
            return out, (router.max_local_prefill_length,
                         router.max_prefill_queue_size), unpackb(kv)
        finally:
            await drt.close()
            await server.stop()

    async def ref_side():
        hub = MemoryHub()
        drt = RefDrt.in_process(hub)
        router = ref_router_mod.DisaggRouter(max_local_prefill_length=1000,
                                             max_prefill_queue_size=2)
        adm = ref.AdmissionController(ref.AdmissionConfig(limit=4),
                                      flight=RefFlight(16))
        act = ref.LocalActuator(disagg_router=router, admission=adm,
                                discovery=drt.discovery, namespace="graph",
                                model_name="llama")
        out = []
        for a in actions(ref):
            out.append((await act.apply(a), adm.shed_level, adm.limit))
        import msgpack

        kv = await drt.discovery.kv_get(REF_KEY)
        await drt.close()
        return out, (router.max_local_prefill_length,
                     router.max_prefill_queue_size), msgpack.unpackb(kv)

    got, want = asyncio.run(port_side()), asyncio.run(ref_side())
    assert got == want
    assert want[0] == [(True, 0, 4), (True, 1, 8), (True, 0, 8), (False, 0, 8)]
    assert want[2] == {"max_local_prefill_length": 2000,
                       "max_prefill_queue_size": 3}


def test_planner_package_exports_the_reference_names():
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert json.dumps(sorted(dir(port.PolicyConfig()))) == json.dumps(
        sorted(dir(ref.PolicyConfig())))


# ------------------------------------------- a reference fault, fixed


class _FakeStore:
    """A record with the graph's decode service and a cold pool's service
    of the same role (what a front's StorePoolBackend writes)."""

    def __init__(self):
        self.rec = {"name": "graph", "spec": {"services": {
            "decode": {"role": "decode", "replicas": 3},
            "pool-cold": {"role": "decode", "modelName": "cold",
                          "replicas": 1}}}}

    def get(self, name):
        return json.loads(json.dumps(self.rec)) if name == "graph" else None

    def update(self, name, spec):
        self.rec = {"name": name, "spec": json.loads(json.dumps(spec))}


def test_replicas_report_the_service_the_actuator_scales():
    """The reference's ``replicas()`` keeps the LAST service of a role
    (``dynamo_tpu/planner/actuation.py:68-73``, ``:118-121`` and ``:134-137``), so a cold
    pool's ``pool-<slug>`` service (role decode) hides the graph's decode
    count: its policy sees 1 and never scales the graph's 3 replicas down
    when idle. The port reports the service ``apply`` patches (the first
    of the role, or the one ``role_services`` names), and scales it."""
    async def run(ns):
        store = _FakeStore()
        act = ns.StoreScaleActuator(store, "graph")
        seen = await act.replicas()
        cr = {"metadata": {"name": "graph"}, "spec": store.get("graph")["spec"]}
        kube_seen = ns.KubeActuator(None, cr).replicas()
        named = ns.KubeActuator(None, cr, {"decode": "pool-cold"}).replicas()
        clock = Clock()
        planner = ns.Planner(
            policy=ns.SlaPolicy(ns.PolicyConfig(**dict(
                BASE, scale_up_cooldown_s=1.0, scale_down_cooldown_s=4.0)),
                clock=clock),
            sources=[lambda: {"decode.slot_busy_ratio": 0.0,
                              "decode.waiting": 0.0}],
            actuators=[act], flight=PKGS["port" if ns is port else "ref"][2](16),
            clock=clock)
        for _ in range(12):
            clock.advance(1.0)
            await planner.step()
        return seen, kube_seen, named, store.rec["spec"]["services"]

    ref_seen, ref_kube, ref_named, ref_after = asyncio.run(run(ref))
    port_seen, port_kube, port_named, port_after = asyncio.run(run(port))
    assert ref_seen == ref_kube == {"decode": 1}
    assert port_seen == port_kube == {"decode": 3}
    assert ref_named == {"decode": 1} and port_named == {"decode": 1}
    assert ref_after["decode"]["replicas"] == 3  # never scaled down
    assert port_after["decode"]["replicas"] == 1  # 3 → 2 → 1, 4 s apart
    assert port_after["pool-cold"] == ref_after["pool-cold"]
