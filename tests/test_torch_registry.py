"""The port's model registry, tenant quotas and pools against the
reference's.

- a ``ModelCard``'s wire bytes (the port's codec) equal msgpack's of the
  reference's card, both ways, and so do the discovery records
  ``register_model(card=)`` and ``RegistryAdmin.add`` write (exact bytes);
- ``ModelRegistry`` (aliases, tenant visibility, alias conflicts,
  removals) resolves as the reference's (exact);
- ``TenantQuotas`` under one injected clock admits, sheds (with the same
  ``Retry-After``), charges and snapshots as the reference's, and counts
  on the same ``dynamo_planner_admissions_total`` / ``dynamo_registry_*``
  samples (exact);
- ``PoolPolicy.decide`` over seeded demand under one clock (exact);
- a ``PoolManager`` cold start that meets its deadline and one that
  misses it (``ColdStartTimeout``, its Retry-After), beside the
  reference's;
- the front over each package's in-process discovery plane: a served
  alias routes to and is echoed as the canonical model, ``/v1/models`` by
  tenant, an invisible model's 404 identical to an unknown one's,
  ``POST /admin/models`` of a pool without a worker answering 503 +
  Retry-After after the cold-start deadline, ``DELETE`` making it a 404,
  ``GET /admin/pools`` (statuses, headers and bodies equal the
  reference's but for wall-time fields);
- the CLI parses the 12 fleet flags as the reference does, refuses
  exactly the 17 others by name, and serves admission and quotas from
  ``in=http``.
"""

import asyncio
import json
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import msgpack
import pytest

from dynamo_tpu.cli import run as ref_run
from dynamo_tpu.http import service as ref_service
from dynamo_tpu.registry import cards as ref_cards
from dynamo_tpu.registry import policy as ref_policy
from dynamo_tpu.registry import pools as ref_pools
from dynamo_tpu.registry import registry as ref_registry
from dynamo_tpu.registry import tenants as ref_tenants
from dynamo_tpu.runtime.component import DistributedRuntime as RefDrt
from dynamo_tpu.runtime.transports.memory import MemoryHub as RefHub
from dynamo_tpu_torch.cli import run as port_run
from dynamo_tpu_torch.http import service as port_service
from dynamo_tpu_torch.registry import cards, policy, pools, registry, tenants
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.transports.memory import MemoryHub
from dynamo_tpu_torch.runtime.wire import packb, unpackb

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 60

CARD_CASES = [
    dict(name="llama"),
    dict(name="llama", endpoint="dyn://ns.proc.chat", model_type="chat",
         family="llama", context_length=131072, aliases=["fast", "l3"],
         tenants=["acme", "beta"], owned_by="team", model_path="/m/llama",
         kv_block_size=16, checksum="abc123"),
    dict(name="scoped", tenants=[], aliases=[]),
    dict(name="ünï", endpoint="dyn://a.b.c", context_length=2**40),
]


@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_card_wire_bytes_equal_msgpack_both_ways(case):
    kw = CARD_CASES[case]
    card, ref = cards.ModelCard(**kw), ref_cards.ModelCard(**kw)
    raw = packb(card.to_wire())
    assert raw == msgpack.packb(ref.to_wire(), use_bin_type=True)
    assert ref_cards.ModelCard.from_wire(msgpack.unpackb(raw, raw=False)) == ref
    assert cards.ModelCard.from_wire(unpackb(
        msgpack.packb(ref.to_wire(), use_bin_type=True))) == card
    # unknown keys are dropped alike; a bad model type raises alike
    extra = dict(card.to_wire(), future_field=1)
    assert cards.ModelCard.from_wire(extra) == card
    for mod in (cards, ref_cards):
        with pytest.raises(ValueError, match="model_type"):
            mod.ModelCard(name="x", model_type="embeddings")
    for tenant in (None, "acme", "beta", "zeta", ""):
        assert card.visible_to(tenant) == ref.visible_to(tenant)
    assert card.served_names() == ref.served_names()


def test_card_from_mdc_matches_the_reference(tmp_path):
    import types

    mdc = types.SimpleNamespace(
        display_name="tiny", model_type="both", config={"model_type": "llama"},
        context_length=256, model_path=str(tmp_path), kv_block_size=8,
        checksum="c0ffee")
    for kw in ({}, dict(name="n", model_type="chat", aliases=["a"],
                        tenants=["t"])):
        got = cards.card_from_mdc(mdc, "dyn://a.b.c", **kw)
        want = ref_cards.card_from_mdc(mdc, "dyn://a.b.c", **kw)
        assert got.to_wire() == want.to_wire()


async def _records(hub_cls, drt_cls, svc, reg_mod, card_mod):
    drt = drt_cls.in_process(hub_cls())
    card = card_mod.ModelCard(**CARD_CASES[1])
    await svc.register_model(drt, "ns", "llama", "dyn://ns.proc.chat",
                             model_type="both", mdc={"context_length": 64},
                             card=card)
    admin = reg_mod.RegistryAdmin(drt, "ns")
    await admin.add(card_mod.ModelCard(name="cold", endpoint="dyn://ns.cold.chat",
                                       context_length=4096))
    with pytest.raises(ValueError):
        await admin.add(card_mod.ModelCard(name="bad", endpoint="dyn://x.y"))
    raw = dict(await drt.discovery.kv_get_prefix("ns/models/"))
    listed = await admin.list()
    await admin.remove("cold")
    after = sorted(await drt.discovery.kv_get_prefix("ns/models/"))
    await drt.close()
    return raw, listed, after


def test_registration_records_are_the_references_bytes():
    got = asyncio.run(_records(MemoryHub, DistributedRuntime, port_service,
                               registry, cards))
    want = asyncio.run(_records(RefHub, RefDrt, ref_service, ref_registry,
                                ref_cards))
    assert got == want
    raw, listed, after = got
    assert sorted(raw) == ["ns/models/both/cold", "ns/models/both/llama"]
    assert after == ["ns/models/both/llama"]
    assert {e["name"] for e in listed} == {"llama", "cold"}


def _registry_script(reg_mod, card_mod, seed):
    rng = random.Random(seed)
    reg = reg_mod.ModelRegistry()
    seen = []
    reg.add_listener(lambda name, card: seen.append(
        (name, None if card is None else card.to_wire())))
    names = ["m0", "m1", "m2", "m3"]
    aliases = ["a0", "a1", "a2", "m1"]
    tenant_sets = [None, [], ["acme"], ["acme", "beta"]]
    out = []
    for _ in range(40):
        if rng.random() < 0.75:
            reg.put(card_mod.ModelCard(
                name=rng.choice(names),
                aliases=rng.sample(aliases, rng.randrange(0, 3)),
                tenants=rng.choice(tenant_sets),
                family=rng.choice([None, "llama"])))
        else:
            reg.remove(rng.choice(names))
        out.append(tuple(
            (q, t, reg.resolve(q, t), reg.lookup(q))
            for q in names + aliases + ["nope"]
            for t in (None, "acme", "beta", "default")))
        out.append(tuple(reg.visible(t) for t in (None, "acme", "beta")))
    lines = sorted(line for line in reg.registry.render().splitlines()
                   if not line.startswith("#"))
    return out, seen, lines


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_registry_resolves_as_the_reference(seed):
    assert (_registry_script(registry, cards, seed)
            == _registry_script(ref_registry, ref_cards, seed))


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _quota_script(ten_mod, adm_mod, tmp_path, seed):
    rng = random.Random(seed)
    overrides = tmp_path / f"quotas-{seed}.json"
    overrides.write_text(json.dumps({
        "burst": {"requests_per_s": 0.5, "burst_s": 2.0},
        "tok": {"tokens_per_s": 20, "burst_s": 1.0},
        "both": {"requests_per_s": 3, "tokens_per_s": 50, "burst_s": 0.5}}))
    quotas = ten_mod.TenantQuotas.from_flags(
        2.0, 0.0, overrides_path=str(overrides), burst_s=1.5)
    clock = _Clock()
    quotas.clock = clock
    quotas.max_tracked = 4
    ctl = adm_mod.AdmissionController()
    quotas.bind_admissions(ctl.registry)
    out = []
    headers = [None, "", "burst", "tok", "both", "acme", " acme ", "bad tenant!",
               "x" * 80, "t1", "t2", "t3"]
    for _ in range(120):
        clock.t += rng.choice([0.0, 0.0, 0.05, 0.3, 1.0])
        tenant = quotas.resolve(rng.choice(headers))
        try:
            quotas.admit(tenant, request_id="r")
            quotas.charge_tokens(tenant, rng.choice([0, 1, 7, 30]))
            out.append((tenant, "ok"))
        except adm_mod.AdmissionRejected as e:
            out.append((tenant, e.outcome, e.retry_after_header, str(e)))
        out.append(quotas.snapshot())
    lines = sorted(line for reg in (quotas.registry, ctl.registry)
                   for line in reg.render().splitlines()
                   if not line.startswith("#"))
    return out, lines


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tenant_quotas_decide_as_the_reference_under_one_clock(tmp_path, seed):
    from dynamo_tpu.planner import admission as ref_admission
    from dynamo_tpu_torch.planner import admission

    got = _quota_script(tenants, admission, tmp_path, seed)
    assert got == _quota_script(ref_tenants, ref_admission, tmp_path, seed)
    outcomes = [o[1] for o in got[0] if isinstance(o, tuple)]
    assert "ok" in outcomes and "quota" in outcomes
    assert any('outcome="quota"' in line for line in got[1])
    for value in (None, "", "acme", " acme ", "bad tenant!", "x" * 64, "x" * 65):
        assert tenants.parse_tenant(value) == ref_tenants.parse_tenant(value)


def test_a_bad_overrides_file_is_refused_as_the_reference(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"no spaces": {"requests_per_s": 1}}))
    for mod in (tenants, ref_tenants):
        with pytest.raises(ValueError, match="bad tenant name"):
            mod.TenantQuotas.from_flags(1.0, 0.0, overrides_path=str(bad))


def _policy_script(pol_mod, seed):
    rng = random.Random(seed)
    clock = _Clock()
    pol = pol_mod.PoolPolicy(pol_mod.PoolPolicyConfig(
        idle_to_zero_s=rng.choice([0.0, 5.0, 30.0]),
        min_workers=rng.choice([0, 0, 1]), cooldown_s=10.0), clock=clock)
    out = []
    for _ in range(60):
        clock.t += rng.choice([0.0, 1.0, 4.0, 12.0])
        demand = {f"m{i}": pol_mod.PoolDemand(
            workers=rng.choice([0, 1, 2]), idle_s=rng.choice([0.0, 6.0, 40.0]),
            cold_pending=rng.random() < 0.3) for i in range(rng.randrange(0, 4))}
        out.append([(a.model, a.kind) for a in pol.decide(demand)])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_policy_decides_as_the_reference(seed):
    got = _policy_script(policy, seed)
    assert got == _policy_script(ref_policy, seed)


async def _cold_start(pool_mod, reg_mod, card_mod, meets):
    """A cold pool with a spawner: a worker joins after 0.15 s (``meets``)
    or never, against a 0.6 s deadline."""
    view = reg_mod.ModelRegistry()
    view.put(card_mod.ModelCard(name="m", endpoint="dyn://a.b.c"))
    size = {"m": 0}
    spawned = []

    async def spawner(card):
        spawned.append(card.name)
        if meets:
            await asyncio.sleep(0.15)
            size["m"] = 1

    mgr = pool_mod.PoolManager(
        view, lambda name: size.get(name, 0), spawner=spawner,
        config=pool_mod.PoolConfig(cold_start_deadline_s=0.6, retry_after_s=7,
                                   poll_s=0.01, retry_kick_s=10.0))
    t0 = time.monotonic()
    waiters = [mgr.await_capacity("m") for _ in range(3)]
    results = await asyncio.gather(*waiters, return_exceptions=True)
    waited = time.monotonic() - t0
    rows = [{k: v for k, v in row.items() if k != "idle_s"} for row in mgr.snapshot()]
    demand = {k: (d.workers, d.cold_pending) for k, d in mgr.demand().items()}
    await mgr.stop()
    lines = sorted(line.split(" ")[0] + (" " + line.split(" ")[1]
                   if "_sum" not in line else "")
                   for line in mgr.registry.render().splitlines()
                   if not line.startswith("#"))
    out = [type(r).__name__ if r is not None else None for r in results]
    retry = [getattr(r, "retry_after_s", None) for r in results]
    return out, retry, spawned, rows, demand, lines, waited


@pytest.mark.parametrize("meets", [True, False], ids=["meets", "misses"])
def test_a_cold_start_meets_or_misses_its_deadline_as_the_reference(meets):
    got = asyncio.run(asyncio.wait_for(
        _cold_start(pools, registry, cards, meets), TIMEOUT_S))
    want = asyncio.run(asyncio.wait_for(
        _cold_start(ref_pools, ref_registry, ref_cards, meets), TIMEOUT_S))
    assert got[:6] == want[:6]
    out, retry, spawned, _, _, _, waited = got
    assert spawned == ["m"]  # one spawn shared by the three waiters
    if meets:
        assert out == [None] * 3 and 0.1 < waited < 0.6
    else:
        assert out == ["ColdStartTimeout"] * 3 and retry == [7] * 3
        assert waited >= 0.6


def test_pool_service_spec_and_backends_match_the_reference():
    card = cards.ModelCard(name="Llama 3/8B", model_path="/m")
    ref = ref_cards.ModelCard(name="Llama 3/8B", model_path="/m")
    got, want = {}, {}
    pools.pool_service_spec(got, card.name, card)
    ref_pools.pool_service_spec(want, ref.name, ref)
    assert got == want and pools.pool_service_name("a b") == ref_pools.pool_service_name("a b")

    class Store:
        def __init__(self):
            self.rec = {"spec": {"services": {}}}

        def get(self, name):
            return self.rec

        def update(self, name, spec):
            self.rec = {"spec": spec}

    async def drive(mod, c):
        store = Store()
        backend = mod.StorePoolBackend(store, "dep", replicas=2)
        await backend.spawn(c)
        up = json.dumps(store.rec, sort_keys=True)
        await backend.drain(c.name)
        return up, json.dumps(store.rec, sort_keys=True)

    assert asyncio.run(drive(pools, card)) == asyncio.run(drive(ref_pools, ref))


# ---------------------------------------------------------------- the front


def _pkg(name):
    from dynamo_tpu import registry as ref_reg_pkg
    from dynamo_tpu_torch import registry as reg_pkg

    if name == "port":
        return dict(hub=MemoryHub, drt=DistributedRuntime, svc=port_service,
                    reg=reg_pkg, cards=cards)
    return dict(hub=RefHub, drt=RefDrt, svc=ref_service, reg=ref_reg_pkg,
                cards=ref_cards)


async def _front(name, deadline_s=0.4):
    """A processor-like endpoint serving "llama" (card: alias llama-fast,
    tenants default and acme) behind a registry-aware front with pools and
    the registry admin; returns what each request answered."""
    p = _pkg(name)
    hub = p["hub"]()
    worker, front = p["drt"].in_process(hub), p["drt"].in_process(hub)
    ep = worker.namespace("ns").component("proc").endpoint("chat")

    async def handler(payload, ctx):
        yield {"id": "c", "object": "chat.completion.chunk", "created": 1,
               "model": payload["model"], "choices": [
                   {"index": 0, "delta": {"role": "assistant", "content": "hi"}}]}
        yield {"id": "c", "object": "chat.completion.chunk", "created": 1,
               "model": payload["model"], "choices": [
                   {"index": 0, "delta": {}, "finish_reason": "stop"}]}

    serving = await ep.serve(handler, metadata={"model": "llama"})
    card = p["cards"].ModelCard(name="llama", endpoint="dyn://ns.proc.chat",
                                family="llama", context_length=2048,
                                aliases=["llama-fast"],
                                tenants=["default", "acme"])
    await p["svc"].register_model(worker, "ns", "llama", "dyn://ns.proc.chat",
                                  model_type="both",
                                  mdc={"context_length": 2048}, card=card)
    manager = p["svc"].ModelManager()
    watcher = p["svc"].ModelWatcher(front, manager, "ns")
    await watcher.start()
    mgr = p["reg"].PoolManager(
        manager.registry, watcher.pool_size,
        config=p["reg"].PoolConfig(cold_start_deadline_s=deadline_s))
    service = p["svc"].HttpService(manager, host="127.0.0.1", port=0,
                                   pools=mgr)
    service.registry_admin = p["reg"].RegistryAdmin(front, "ns")
    await service.start()
    base = f"http://127.0.0.1:{service.port}"
    answers = {}
    try:
        async with aiohttp.ClientSession() as s:
            async def call(tag, method, path, body=None, tenant=None):
                headers = {} if tenant is None else {"X-Tenant": tenant}
                t0 = time.monotonic()
                async with s.request(method, base + path, json=body,
                                     headers=headers) as r:
                    raw = await r.read()
                    answers[tag] = (r.status, r.headers.get("Retry-After"),
                                    json.loads(raw) if raw else None,
                                    time.monotonic() - t0)
                    return answers[tag]

            def chat(model, stream=False):
                return dict(model=model, stream=stream,
                            messages=[{"role": "user", "content": "x"}])

            await call("models", "GET", "/v1/models")
            await call("models_acme", "GET", "/v1/models", tenant="acme")
            await call("models_out", "GET", "/v1/models", tenant="outsider")
            await call("alias", "POST", "/v1/chat/completions",
                       chat("llama-fast"), tenant="acme")
            await call("canonical", "POST", "/v1/chat/completions",
                       chat("llama"))
            await call("invisible", "POST", "/v1/chat/completions",
                       chat("llama"), tenant="outsider")
            await call("invisible_alias", "POST", "/v1/chat/completions",
                       chat("llama-fast"), tenant="outsider")
            await call("unknown", "POST", "/v1/chat/completions",
                       chat("nope"), tenant="outsider")
            await call("bad_card", "POST", "/admin/models", {"name": "x"})
            await call("add", "POST", "/admin/models",
                       {"name": "cold", "endpoint": "dyn://ns.coldpool.chat",
                        "model_type": "both"})
            while "cold" not in manager.chat_engines:
                await asyncio.sleep(0.01)
            await call("admin_models", "GET", "/admin/models")
            await call("cold", "POST", "/v1/chat/completions", chat("cold"))
            await call("pools", "GET", "/admin/pools")
            await call("remove", "DELETE", "/admin/models/cold")
            while "cold" in manager.chat_engines:
                await asyncio.sleep(0.01)
            await call("removed", "POST", "/v1/chat/completions", chat("cold"))
    finally:
        await service.stop()
        await mgr.stop()
        await watcher.stop()
        await serving.stop()
        await front.close()
        await worker.close()
    return answers


def _stable(answers):
    """Drop wall-time fields (created stamps, idle ages, chunk ids)."""
    def clean(obj):
        if isinstance(obj, dict):
            return {k: clean(v) for k, v in obj.items()
                    if k not in ("created", "idle_s", "id")}
        if isinstance(obj, list):
            return [clean(v) for v in obj]
        return obj
    return {tag: (status, retry, clean(body))
            for tag, (status, retry, body, _) in answers.items()}


@pytest.mark.asyncio
async def test_the_front_resolves_aliases_tenants_and_cold_pools_as_the_reference():
    got = await asyncio.wait_for(_front("port"), TIMEOUT_S)
    want = await asyncio.wait_for(_front("reference"), TIMEOUT_S)
    assert _stable(got) == _stable(want)
    ids = {tag: [m["id"] for m in got[tag][2]["data"]]
           for tag in ("models", "models_acme", "models_out")}
    assert ids == {"models": ["llama"], "models_acme": ["llama"],
                   "models_out": []}
    llama = got["models"][2]["data"][0]
    assert llama["aliases"] == ["llama-fast"] and llama["family"] == "llama"
    assert got["alias"][0] == 200 and got["alias"][2]["model"] == "llama"
    assert got["canonical"][0] == 200
    # an invisible model answers exactly as an unknown one
    for tag in ("invisible", "invisible_alias"):
        status, retry, body, _ = got[tag]
        asked = "llama" if tag == "invisible" else "llama-fast"
        assert (status, retry) == (404, None)
        assert json.dumps(body).replace(asked, "nope") == json.dumps(got["unknown"][2])
    assert got["bad_card"][0] == 400
    assert got["add"][:3] == (200, None, {"registered": "cold"})
    assert [c["name"] for c in got["admin_models"][2]["models"]] == ["cold", "llama"]
    status, retry, body, waited = got["cold"]
    assert (status, retry) == (503, "5") and waited >= 0.4
    assert body["error"]["type"] == "service_unavailable"
    rows = {r["model"]: r["workers"] for r in got["pools"][2]["pools"]}
    assert rows == {"cold": 0, "llama": 1}
    assert got["remove"][:3] == (200, None, {"removed": "cold"})
    assert got["removed"][0] == 404


@pytest.mark.asyncio
async def test_admin_routes_answer_501_without_their_subsystems():
    for svc in (port_service, ref_service):
        service = svc.HttpService(svc.ModelManager(), host="127.0.0.1", port=0)
        await service.start()
        try:
            async with aiohttp.ClientSession() as s:
                base = f"http://127.0.0.1:{service.port}"
                async with s.post(base + "/admin/models", json={}) as r:
                    assert r.status == 501
                async with s.delete(base + "/admin/models/x") as r:
                    assert r.status == 501
                async with s.get(base + "/admin/pools") as r:
                    assert r.status == 501
                async with s.get(base + "/admin/models") as r:
                    assert r.status == 200 and await r.json() == {"models": []}
        finally:
            await service.stop()


# ------------------------------------------------------------------ the CLI

FLEET_FLAGS = {  # flag → (value given, the parsed field)
    "--admission-limit": ("4", "admission_limit"),
    "--admission-queue-depth": ("3", "admission_queue_depth"),
    "--admission-queue-timeout-s": ("2.5", "admission_queue_timeout_s"),
    "--served-alias": ("fast", "served_alias"),
    "--model-tenants": ("acme,beta", "model_tenants"),
    "--tenant-rps": ("1.5", "tenant_rps"),
    "--tenant-tps": ("200", "tenant_tps"),
    "--tenant-burst-s": ("4", "tenant_burst_s"),
    "--tenant-quotas": ("/tmp/q.json", "tenant_quotas"),
    "--pool-scale-to-zero-idle-s": ("60", "pool_scale_to_zero_idle_s"),
    "--pool-cold-start-deadline-s": ("3", "pool_cold_start_deadline_s"),
    "--pool-cooldown-s": ("9", "pool_cooldown_s"),
}
STILL_REFUSED = {
    "--tensor-parallel-size", "--expert-parallel-size",
    "--data-parallel-size", "--pipeline-parallel-size", "--ici-sender-rank",
    "--ici-receiver-rank", "--num-nodes", "--node-rank", "--leader-addr",
    "--profiler-port",
}
# refused until the planner and deploy slice; served since, as the reference
NOW_SERVED = {
    "--planner": None, "--planner-interval-s": "0.5",
    "--planner-min-replicas": "2", "--planner-max-replicas": "3",
    "--planner-cooldown-s": "1", "--planner-deployment": "graph",
    "--api-store-url": "http://127.0.0.1:8790",
}


@pytest.mark.parametrize("flag", sorted(FLEET_FLAGS))
def test_cli_fleet_flags_parse_as_the_reference(flag):
    value, field = FLEET_FLAGS[flag]
    assert flag not in port_run.REFUSED_FLAGS
    for args in ([], [flag, value], [flag, value, flag, value + "x"]):
        if len(args) == 4 and flag != "--served-alias":
            args = args[:2]
        got = port_run.parse_flags(args)
        want = ref_run.build_parser().parse_args(args)
        assert getattr(got, field) == getattr(want, field), (flag, args)


def test_cli_refuses_exactly_the_seventeen_with_their_reasons():
    """Of the seventeen flags the port once refused, the ten for multiple
    cards and the profiler server still raise by name; the planner's seven
    parse to the reference's values."""
    assert len(port_run.REFUSED_FLAGS) == 10
    assert set(port_run.REFUSED_FLAGS) == STILL_REFUSED
    assert len(STILL_REFUSED | set(NOW_SERVED)) == 17
    for flag in sorted(STILL_REFUSED):
        with pytest.raises(SystemExit) as e:
            port_run.parse_flags([flag, "1"])
        why = str(e.value)
        assert flag in why
        if flag == "--profiler-port":
            assert "torch has no counterpart" in why
    for flag, value in sorted(NOW_SERVED.items()):
        argv = [flag] if value is None else [flag, value]
        got, want = port_run.parse_flags(argv), ref_run.build_parser().parse_args(argv)
        field = flag[2:].replace("-", "_")
        assert getattr(got, field) == getattr(want, field), flag


def test_cli_builders_match_the_reference(tmp_path):
    import types

    q = tmp_path / "q.json"
    q.write_text(json.dumps({"burst": {"requests_per_s": 0.5}}))
    argv = ["--tenant-rps", "2", "--tenant-quotas", str(q),
            "--served-alias", "a", "--served-alias", "b",
            "--model-tenants", " acme, ,beta", "--model-name", "m",
            "--pool-scale-to-zero-idle-s", "60", "--pool-cooldown-s", "9",
            "--pool-cold-start-deadline-s", "3", "--admission-limit", "5"]
    got = port_run.parse_flags(argv)
    want = ref_run.build_parser().parse_args(argv)
    gq, wq = port_run._build_quotas(got), ref_run._build_quotas(want)
    def quotas(q):
        return (vars(q.default),
                {k: vars(v) for k, v in sorted(q.overrides.items())})

    assert quotas(gq) == quotas(wq)
    mdc = types.SimpleNamespace(
        display_name="tiny", model_type="both", config={"model_type": "llama"},
        context_length=256, model_path="/m", kv_block_size=8, checksum="c")
    assert (port_run._model_card(got, mdc, "dyn://a.b.c").to_wire()
            == ref_run._model_card(want, mdc, "dyn://a.b.c").to_wire())
    assert port_run._build_quotas(port_run.parse_flags([])) is None
    assert port_run._build_admission(port_run.parse_flags([])) is None
    adm = port_run._build_admission(got)
    assert (adm.config.limit, adm.config.queue_depth,
            adm.config.queue_timeout_s) == (5, 64, 10.0)

    class Watcher:
        def pool_size(self, name):
            return 0

    manager = port_service.ModelManager()
    mgr = port_run._build_pools(got, manager, Watcher())
    assert mgr.config.cold_start_deadline_s == 3.0
    assert (mgr.policy.config.idle_to_zero_s, mgr.policy.config.cooldown_s) == (60.0, 9.0)
    assert mgr.spawner is None and mgr.drainer is None
    assert port_run._build_pools(port_run.parse_flags([]), manager, Watcher()) is None


def test_cli_front_serves_admission_and_quotas(tmp_path):
    """``in=http out=echo_full`` with admission and a tenant override: the
    over-quota tenant's second request is a 429 with Retry-After, another
    tenant is served, and /metrics carries the admission family with the
    quota outcome; /admin/models' writes answer 501 without a store."""
    q = tmp_path / "q.json"
    q.write_text(json.dumps({"burst": {"requests_per_s": 0.1, "burst_s": 1}}))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               DYN_TOKEN_ECHO_DELAY_MS="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.run", "in=http",
         "out=echo_full", "--http-host", "127.0.0.1", "--http-port", "0",
         "--admission-limit", "3", "--tenant-quotas", str(q)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line, deadline = "", time.monotonic() + 60
        while "listening on" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                raise AssertionError(proc.stderr.read())
        port = int(line.strip().rsplit(":", 1)[1])

        async def drive():
            out = []
            async with aiohttp.ClientSession() as s:
                url = f"http://127.0.0.1:{port}"
                body = dict(model="echo", messages=[{"role": "user",
                                                     "content": "a b"}])
                for tenant in ("burst", "burst", "other", "other"):
                    async with s.post(url + "/v1/chat/completions", json=body,
                                      headers={"X-Tenant": tenant}) as r:
                        out.append((r.status, r.headers.get("Retry-After")))
                async with s.post(url + "/admin/models", json={}) as r:
                    out.append(r.status)
                async with s.get(url + "/metrics") as r:
                    out.append(await r.text())
            return out

        *answers, admin, text = asyncio.run(drive())
        assert answers == [(200, None), (429, "10"), (200, None), (200, None)]
        assert admin == 501
        assert 'dynamo_planner_admission_limit_requests 3.0' in text
        assert ('dynamo_planner_admissions_total{outcome="quota",tenant="burst"} 1.0'
                in text)
        assert ('dynamo_planner_admissions_total{outcome="admitted",'
                'priority="normal"} 3.0' in text)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
