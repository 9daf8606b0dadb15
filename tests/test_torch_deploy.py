"""The port's deployment plane against the JAX package's.

``dynamo_tpu_torch/deploy/`` is the port's copy of ``dynamo_tpu/deploy``.
Its manifests equal the reference's after exactly the documented mapping
and nothing else: the module path (``dynamo_tpu`` → ``dynamo_tpu_torch``),
``out=jax`` → ``out=torch``, a service's ``tpus`` → ``gpus`` (the
``google.com/tpu`` request and limit → ``nvidia.com/gpu``) and the GKE node
selectors → ``nvidia.com/gpu.product`` from ``gpuProduct``. A CR that
still carries ``tpus``, ``tpuAccelerator`` or ``tpuTopology`` is refused by
name. The Reconciler runs the same apply, prune, repair and status
sequence; both api-stores answer one request sequence with the same
statuses and bodies (404, 409 and 400 included); the REST kube client
makes the same requests of ``tests/test_kube_api.py``'s fake API server;
the watch loop, the leases and the lease elector behave as the
reference's under a fake clock.
"""

import asyncio
import copy
import http.client
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import yaml
from test_kube_api import FakeKubeApiServer

from dynamo_tpu.deploy import api_store as ref_store
from dynamo_tpu.deploy import kube_api as ref_kube
from dynamo_tpu.deploy import leader as ref_leader
from dynamo_tpu.deploy import operator as ref_op
from dynamo_tpu.deploy import store_source as ref_source
from dynamo_tpu.deploy import watch as ref_watch
from dynamo_tpu_torch.deploy import api_store as port_store
from dynamo_tpu_torch.deploy import kube_api as port_kube
from dynamo_tpu_torch.deploy import leader as port_leader
from dynamo_tpu_torch.deploy import operator as port_op
from dynamo_tpu_torch.deploy import store_source as port_source
from dynamo_tpu_torch.deploy import watch as port_watch

REPO = Path(__file__).resolve().parent.parent
PORT_DEPLOY = REPO / "dynamo_tpu_torch" / "deploy"

# the documented mapping, argv word by argv word
ARGV_MAP = {
    "dynamo_tpu.cli.run": "dynamo_tpu_torch.cli.run",
    "dynamo_tpu.runtime.transports.dynstore":
        "dynamo_tpu_torch.runtime.transports.dynstore",
    "out=jax": "out=torch",
}


def ref_to_port(m: dict, products=None) -> dict:
    """A reference manifest as the port renders it: the module path,
    ``out=``, the device request and the node selector (``products``:
    Deployment name → the port CR's ``gpuProduct``)."""
    m = copy.deepcopy(m)
    if m["kind"] != "Deployment":
        return m
    pod = m["spec"]["template"]["spec"]
    for c in pod["containers"]:
        c["command"] = [ARGV_MAP.get(a, a) for a in c["command"]]
        res = c.get("resources")
        if res is not None:
            for k in ("requests", "limits"):
                res[k] = {"nvidia.com/gpu": res[k].pop("google.com/tpu")}
    if pod.pop("nodeSelector", None) is not None:
        product = (products or {}).get(m["metadata"]["name"])
        if product:
            pod["nodeSelector"] = {"nvidia.com/gpu.product": product}
    return m


def to_port_cr(cr: dict):
    """A reference CR with its TPU fields in the port's words, and each
    Deployment's ``gpuProduct``."""
    cr = copy.deepcopy(cr)
    products = {}
    for name, spec in (cr["spec"].get("services") or {}).items():
        if "tpus" in spec:
            spec["gpus"] = spec.pop("tpus")
        acc = spec.pop("tpuAccelerator", None)
        if acc:
            spec["gpuProduct"] = f"NVIDIA-H100-for-{acc}"
            products[f"{cr['metadata']['name']}-{name}"] = spec["gpuProduct"]
        spec.pop("tpuTopology", None)
    return cr, products


def _cr(name="g1", services=None, **spec):
    # tests/test_deploy.py's CR
    return {
        "apiVersion": "dynamo.tpu/v1alpha1",
        "kind": "DynamoTpuGraphDeployment",
        "metadata": {"name": name, "namespace": "serving", "uid": "u-1"},
        "spec": {"image": "dynamo-tpu:test", "namespace": "public",
                 "services": services or {}, **spec},
    }


def _example_cr():
    doc = yaml.safe_load((REPO / "deploy" / "kubernetes"
                          / "example-disagg.yaml").read_text())
    return doc


CRS = {
    "defaults": _cr(),
    "decode_prefill_tpus": _cr(services={
        "decode": {"role": "decode", "replicas": 2, "tpus": 4,
                   "tpuTopology": "2x2", "modelPath": "/models/llama",
                   "extraArgs": ["--max-local-prefill-length", "512"]},
        "prefill": {"role": "prefill", "replicas": 4, "tpus": 1,
                    "modelPath": "/models/llama"}}, modelName="llama"),
    "accelerator_env_image": _cr(services={
        "worker": {"role": "worker", "tpus": 8, "tpuAccelerator": "tpu-v5p",
                   "image": "custom:1", "env": {"A": 1, "B": "x"},
                   "modelName": "m2"},
        "frontend": {"role": "frontend", "replicas": 2}}),
    "planner_and_hub": _cr(services={"planner": {"role": "planner"},
                                     "hub": {"role": "hub"},
                                     "processor": {"role": "processor"}}),
    "store_e2e": _cr(services={"worker": {"role": "worker", "tpus": 4}},
                     modelName="tiny"),
    "artifact": _cr(services={"worker": {"role": "worker"}},
                    artifact={"name": "agg", "version": "abc123def456"}),
    "example_disagg": _example_cr(),
}


@pytest.mark.parametrize("name", sorted(CRS))
def test_render_matches_the_reference_up_to_the_device_mapping(name):
    cr = CRS[name]
    port_cr, products = to_port_cr(cr)
    want = [ref_to_port(m, products) for m in ref_op.render_manifests(cr)]
    got = port_op.render_manifests(port_cr)
    assert got == want
    cmds = [c["command"] for m in got if m["kind"] == "Deployment"
            for c in m["spec"]["template"]["spec"]["containers"]]
    assert all("dynamo_tpu_torch" in " ".join(c) for c in cmds)
    assert not any("out=jax" in c or "dynamo_tpu.cli.run" in c for c in cmds)


def test_render_gpu_requests_and_product_selector():
    cr = _cr(services={"decode": {"role": "decode", "gpus": 2,
                                  "gpuProduct": "NVIDIA-H100-80GB-HBM3"},
                       "worker": {"role": "worker", "gpus": 1}})
    by = {m["metadata"]["name"]: m for m in port_op.render_manifests(cr)}
    pod = by["g1-decode"]["spec"]["template"]["spec"]
    assert pod["containers"][0]["resources"] == {
        "requests": {"nvidia.com/gpu": "2"}, "limits": {"nvidia.com/gpu": "2"}}
    assert pod["nodeSelector"] == {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    assert "nodeSelector" not in by["g1-worker"]["spec"]["template"]["spec"]
    cmd = pod["containers"][0]["command"]
    assert cmd[:5] == ["python", "-m", "dynamo_tpu_torch.cli.run",
                       "in=dyn://public.backend.generate", "out=torch"]


@pytest.mark.parametrize("field,value", [("tpus", 1), ("tpuAccelerator", "v5e"),
                                         ("tpuTopology", "2x2")])
def test_tpu_fields_are_refused_by_name(field, value):
    cr = _cr(services={"decode": {"role": "decode", field: value}})
    with pytest.raises(ValueError, match=field):
        port_op.render_manifests(cr)
    kube = port_op.InMemoryKube()
    rec = port_op.Reconciler(kube)
    assert not port_op.safe_reconcile(rec, cr)
    (cond,) = kube.statuses[("serving", "g1")]["conditions"]
    assert (cond["status"], cond["reason"]) == ("False", "ReconcileError")
    assert repr(field) in cond["message"] and kube.objects == {}


def test_unknown_role_is_refused_with_the_reference_words():
    cr = _cr(services={"x": {"role": "nonsense"}})
    with pytest.raises(ValueError) as want:
        ref_op.render_manifests(cr)
    with pytest.raises(ValueError) as got:
        port_op.render_manifests(cr)
    assert str(got.value) == str(want.value)


def _status(s):
    s = copy.deepcopy(s)
    for c in s.get("conditions", []):
        c.pop("lastTransitionTime")
    return s


def _reconcile_sequence(op):
    """tests/test_deploy.py's reconcile sequence: apply, the idempotent
    pass, a scale, a pruned service, an external deletion repaired, a
    finalize, and a failing CR; every step's summary, the objects and the
    statuses."""
    kube = op.InMemoryKube()
    rec = op.Reconciler(kube)
    cr = _cr(services={"worker": {"role": "worker", "replicas": 1,
                                  "modelPath": "/m"}})
    cr["metadata"]["generation"] = 3
    trace = []

    def snap(tag, out):
        trace.append((tag, out, copy.deepcopy(kube.objects),
                      {k: _status(v) for k, v in kube.statuses.items()}))

    snap("apply", rec.reconcile(cr))
    snap("again", rec.reconcile(cr))
    cr["spec"]["services"]["worker"]["replicas"] = 3
    snap("scale", rec.reconcile(cr))
    cr["spec"]["services"]["processor"] = {"role": "processor"}
    snap("add", rec.reconcile(cr))
    del cr["spec"]["services"]["worker"]
    snap("prune", rec.reconcile(cr))
    kube.delete("Deployment", "serving", "g1-processor")
    snap("repair", rec.reconcile(cr))
    snap("finalize", rec.finalize(cr))
    bad = _cr(name="g2", services={"worker": {"role": "no-such-role"}})
    snap("error", op.safe_reconcile(rec, bad))
    snap("relist", op.relist_reconcile(rec, [cr], {("serving", "g2"): bad}))
    return trace


def test_reconciler_runs_the_reference_sequence():
    want, got = _reconcile_sequence(ref_op), _reconcile_sequence(port_op)
    assert [t[0] for t in got] == [t[0] for t in want]
    for (tag, w_out, w_obj, w_st), (_, g_out, g_obj, g_st) in zip(want, got):
        assert g_out == w_out, tag
        assert g_obj == {k: ref_to_port(v) for k, v in w_obj.items()}, tag
        assert g_st == w_st, tag
    assert want[1][1] == {"applied": [], "deleted": []}
    assert want[5][1]["applied"] == ["Deployment/serving/g1-processor"]


def test_control_loop_skips_a_failed_listing():
    kube = port_op.InMemoryKube()
    rec = port_op.Reconciler(kube)
    stop = threading.Event()
    listings = iter([[_cr()], None, None])

    def get_crs():
        try:
            return next(listings)
        except StopIteration:
            stop.set()
            return None

    port_op.control_loop(rec, get_crs, interval=0.0, stop=stop)
    # the failed listings never read as "no CRs": nothing was finalized
    assert len(kube.objects) == 4


# ---------------------------------------------------------------- api-store

API_SEQUENCE = [
    ("GET", "/health", None),
    ("GET", "/api/v1/deployments", None),
    ("POST", "/api/v1/deployments", {"name": "g1", "spec": {"replicas": 2}}),
    ("POST", "/api/v1/deployments", {"name": "g1", "spec": {}}),
    ("POST", "/api/v1/deployments", b"{"),
    ("POST", "/api/v1/deployments", [1, 2]),
    ("POST", "/api/v1/deployments", {"spec": {}}),
    ("POST", "/api/v1/deployments", {"name": "g2", "spec": [1]}),
    ("POST", "/api/v1/deployments", b""),
    ("POST", "/api/v1/deployments", {"name": "g3"}),
    ("GET", "/api/v1/deployments/g1", None),
    ("GET", "/api/v1/deployments/nope", None),
    ("PUT", "/api/v1/deployments/g1", {"spec": {"replicas": 5}}),
    ("PUT", "/api/v1/deployments/g1", {"name": "g1", "spec": {"spec": {"a": 1}}}),
    ("PUT", "/api/v1/deployments/g1", {"name": "other", "spec": {}}),
    ("PUT", "/api/v1/deployments/g1", [1, 2]),
    ("PUT", "/api/v1/deployments/g1", {"a": 1}),
    ("PUT", "/api/v1/deployments/g1", b"{"),
    ("PUT", "/api/v1/deployments/g1", {"spec": 3}),
    ("PUT", "/api/v1/deployments/nope", {"spec": {}}),
    ("PUT", "/api/v1/deployments/g1/status", {"status": {"conditions": []}}),
    ("PUT", "/api/v1/deployments/g1/status", {"status": 1}),
    ("PUT", "/api/v1/deployments/g1/status", b"]"),
    ("PUT", "/api/v1/deployments/nope/status", {"status": {}}),
    ("GET", "/api/v1/deployments", None),
    ("DELETE", "/api/v1/deployments/g1", None),
    ("DELETE", "/api/v1/deployments/g1", None),
    ("GET", "/api/v1/deployments/g1", None),
    ("GET", "/api/v1/deployments", None),
]


def _scrub(obj):
    """Timestamps → a placeholder (each store stamps its own clock)."""
    if isinstance(obj, dict):
        return {k: ("<t>" if k in ("created", "updated")
                    and isinstance(v, float) else _scrub(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_scrub(x) for x in obj]
    return obj


def _send(port, method, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    data = (body if isinstance(body, bytes) or body is None
            else json.dumps(body).encode())
    headers = {"Content-Type": "application/json"} if data is not None else {}
    conn.request(method, path, body=data, headers=headers)
    resp = conn.getresponse()
    raw = resp.read()
    ctype = resp.getheader("Content-Type")
    conn.close()
    return resp.status, ctype, _scrub(json.loads(raw))


def test_api_store_answers_the_reference_sequence():
    async def run(mod):
        svc = mod.ApiStoreService(mod.DeploymentStore(":memory:"),
                                  "127.0.0.1", 0)
        await svc.start()
        loop = asyncio.get_running_loop()
        try:
            return [await loop.run_in_executor(None, _send, svc.port, *req)
                    for req in API_SEQUENCE]
        finally:
            await svc.stop()

    want = asyncio.run(run(ref_store))
    got = asyncio.run(run(port_store))
    for req, w, g in zip(API_SEQUENCE, want, got):
        assert g == w, req
    statuses = [w[0] for w in want]
    assert {201, 400, 404, 409} <= set(statuses)


def test_api_store_main_serves_a_file_backed_store(tmp_path):
    """``python -m dynamo_tpu_torch.deploy.api_store`` with the reference's
    flags: a record written survives the process, and SIGINT exits 0."""
    import signal
    import subprocess
    import sys
    import time

    db = tmp_path / "store.sqlite"

    def start():
        return subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.deploy.api_store",
             "--host", "127.0.0.1", "--port", "0", "--db", str(db)],
            cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    proc = start()
    try:
        line = proc.stdout.readline()
        port = int(line.strip().rsplit(":", 1)[1])
        client = port_source.ApiStoreClient(f"http://127.0.0.1:{port}")
        client.create("g1", {"services": {}})
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0, proc.stderr.read()
        proc = start()
        port = int(proc.stdout.readline().strip().rsplit(":", 1)[1])
        client = port_source.ApiStoreClient(f"http://127.0.0.1:{port}")
        t0 = time.monotonic()
        assert client.get("g1")["spec"] == {"services": {}}
        assert time.monotonic() - t0 < 5
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)


def test_store_source_records_and_an_unreachable_store():
    rec = {"name": "g1", "updated": 12.7,
           "spec": {"k8sNamespace": "serving", "services": {}}}
    assert port_source.record_to_cr(rec) == ref_source.record_to_cr(rec)
    assert port_source.record_to_cr(rec)["metadata"] == {
        "name": "g1", "namespace": "serving", "generation": 12}
    # a dead store is None (skip the cycle), never [] (finalize everything)
    dead = port_source.ApiStoreClient("http://127.0.0.1:1", timeout=0.5)
    assert dead.get_crs() is None


# ----------------------------------------------------------------- kube_api


def _kube_ops(kube_mod, op_mod, leader_mod, fake):
    """One scripted session of a package's REST client against the fake
    API server: reconcile, shrink, status, delete, list, lease CAS."""
    client = kube_mod.KubeApiClient(f"http://127.0.0.1:{fake.port}")
    out = []
    cr = fake.put_cr("g1", {"services": {"worker": {"role": "worker"}},
                            "modelName": "tiny",
                            "artifact": {"name": "agg", "version": "v1"}})
    rec = op_mod.Reconciler(client)
    out.append(rec.reconcile(cr))
    cr2 = fake.put_cr("g1", {"services": {}}, generation=2)
    out.append(rec.reconcile(cr2))
    client.delete("Deployment", "default", "ghost")
    try:
        client.update_status({"metadata": {"name": "ghost",
                                           "namespace": "default"}}, {"x": 1})
    except kube_mod.KubeApiError as e:
        out.append(("error", e.status))
    crs = client.get_crs()
    out.append([(c["kind"], c["apiVersion"], c["metadata"]["name"]) for c in crs])
    out.append(kube_mod.KubeApiClient("http://127.0.0.1:1",
                                      timeout=0.3).get_crs())
    leases = kube_mod.KubeApiLeases(client)
    electors = [leader_mod.LeaderElector(leases, f"e{i}") for i in range(4)]
    out.append([e.try_acquire_or_renew() for e in electors])
    spec, version = leases.read("default", "dynamo-tpu-operator")
    out.append(leases.write("default", "dynamo-tpu-operator",
                            dict(spec, holderIdentity="usurper"), version))
    out.append(leases.write("default", "dynamo-tpu-operator",
                            dict(spec, holderIdentity="stale"), version))
    out.append(leases.read("default", "absent"))
    return out


def test_kube_api_client_makes_the_reference_requests():
    async def run(pkg):
        fake = FakeKubeApiServer()
        await fake.start()
        try:
            out = await asyncio.get_running_loop().run_in_executor(
                None, _kube_ops, *pkg, fake)
            status = _status(fake.crs[("default", "g1")]["status"])
            return out, fake.requests, fake.objects, status
        finally:
            await fake.stop()

    want = asyncio.run(run((ref_kube, ref_op, ref_leader)))
    got = asyncio.run(run((port_kube, port_op, port_leader)))
    assert got[0] == want[0]
    assert got[1] == want[1]  # method, path and query of every request
    assert got[2] == {k: ref_to_port(v) for k, v in want[2].items()}
    assert got[3] == want[3] and want[3]["conditions"][0]["status"] == "True"
    assert want[0][2] == ("error", 404) and sum(want[0][5]) == 1
    assert want[0][6:] == [True, False, (None, None)]


def test_kube_api_watch_stream_and_in_cluster_refusal(monkeypatch):
    """``open_watch`` yields the fake server's events as the reference's
    does, and drives ``watch_loop``: ADDED reconciles, DELETED finalizes."""
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(RuntimeError) as want:
        ref_kube.KubeApiClient.from_in_cluster()
    with pytest.raises(RuntimeError) as got:
        port_kube.KubeApiClient.from_in_cluster()
    assert str(got.value) == str(want.value)

    async def run(kube_mod, op_mod, watch_mod):
        fake = FakeKubeApiServer()
        await fake.start()
        loop = asyncio.get_running_loop()
        client = kube_mod.KubeApiClient(f"http://127.0.0.1:{fake.port}")
        rec = op_mod.Reconciler(client)
        stop = threading.Event()
        t = threading.Thread(target=watch_mod.watch_loop, daemon=True,
                             args=(rec, client.get_crs, client.open_watch, stop),
                             kwargs={"reconnect_backoff_s": 0.05})
        t.start()
        try:
            async def until(pred, what):
                for _ in range(200):
                    if pred():
                        return
                    await asyncio.sleep(0.025)
                raise AssertionError(what)

            await until(lambda: fake.watch_queues, "no watch stream")
            fake.put_cr("w1", {"services": {"worker": {"role": "worker"}}})
            await until(lambda: fake.crs[("default", "w1")].get("status"),
                        "ADDED did not reconcile")
            objs = sorted(fake.objects)
            fake.delete_cr("w1")
            await until(lambda: not fake.objects, "DELETED did not finalize")
            return objs, [(m, p) for m, p, _ in fake.requests
                          if m != "GET" or "watch" not in p]
        finally:
            stop.set()
            for q in list(fake.watch_queues):
                q.put_nowait(None)
            await loop.run_in_executor(None, t.join, 5)
            await fake.stop()

    want = asyncio.run(run(ref_kube, ref_op, ref_watch))
    got = asyncio.run(run(port_kube, port_op, port_watch))
    assert got[0] == want[0] and len(want[0]) == 5
    assert {r for r in got[1] if r[0] != "GET"} == {
        r for r in want[1] if r[0] != "GET"}


# --------------------------------------------------------- watch and leader


@pytest.mark.parametrize("seed", range(3))
def test_iter_watch_events_on_split_documents(seed):
    rng = np.random.default_rng(seed)
    docs = "".join(
        json.dumps({"type": t, "object": {"a": i, "s": "x" * int(rng.integers(0, 40))}},
                   indent=int(rng.integers(0, 3)) or None) + " \n" * int(rng.integers(0, 3))
        for i, t in enumerate(["ADDED", "MODIFIED", "DELETED", "BOOKMARK"] * 5))
    cuts = sorted(set(int(x) for x in rng.integers(1, len(docs), 30)))
    chunks = [docs[a:b] for a, b in zip([0] + cuts, cuts + [len(docs)])]
    want = list(ref_watch.iter_watch_events(chunks))
    got = list(port_watch.iter_watch_events(chunks))
    assert got == want and len(want) == 20


def _cr_w(name="g1", namespace="default", services=None, generation=1):
    return {"metadata": {"name": name, "namespace": namespace,
                         "generation": generation, "uid": "u-" + name},
            "spec": {"namespace": "public", "services": services or {}}}


def _watch_scenarios(op, watch):
    """tests/test_operator_watch.py's streams through one package: the
    children left after each."""

    def once(rec, listed, streams):
        stop = threading.Event()
        it = iter(streams)

        def open_stream():
            try:
                return next(it)
            except StopIteration:
                stop.set()
                return []

        watch.watch_loop(rec, lambda: listed, open_stream, stop=stop,
                         reconnect_backoff_s=0.0)

    out = {}
    cr = _cr_w("g1")
    for name, listed, streams in (
            ("added_deleted", [], [[{"type": "ADDED", "object": cr},
                                    {"type": "DELETED", "object": cr}]]),
            ("added", [cr], [[{"type": "ADDED", "object": cr}]]),
            ("relist_finalizes", [], [[{"type": "ADDED", "object": cr}], []]),
            ("error_event", [cr], [[{"type": "ERROR", "object": {"code": 410}},
                                    {"type": "ADDED", "object": _cr_w("g2")}]])):
        kube = op.InMemoryKube()
        once(op.Reconciler(kube), listed, streams)
        out[name] = sorted(kube.objects)
    # churn across reconnects (the relist repairs what a stream dropped)
    rng = np.random.default_rng(7)
    names = [f"g{i}" for i in range(5)]
    alive, streams = {}, []
    for _ in range(6):
        events = []
        for _ in range(8):
            n = names[int(rng.integers(0, 5))]
            if n in alive and rng.random() < 0.4:
                events.append({"type": "DELETED", "object": alive.pop(n)})
            else:
                c = _cr_w(n, generation=int(rng.integers(0, 100)))
                alive[n] = c
                events.append({"type": "ADDED", "object": c})
        streams.append(events[: int(rng.integers(4, len(events) + 1))])
        for e in events[len(streams[-1]):]:
            key = e["object"]["metadata"]["name"]
            if e["type"] == "DELETED":
                alive.pop(key, None)
            else:
                alive[key] = e["object"]
    kube = op.InMemoryKube()
    once(op.Reconciler(kube), list(alive.values()), streams)
    out["churn"] = sorted(kube.objects)
    out["churn_alive"] = sorted(alive)
    # a failed reconcile abandons the stream; the relist retries it
    kube = op.InMemoryKube()
    rec = op.Reconciler(kube)
    calls = {"n": 0}
    orig = rec.reconcile

    def flaky(c):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient apply failure")
        return orig(c)

    rec.reconcile = flaky
    once(rec, [cr], [[{"type": "ADDED", "object": cr}], []])
    out["early_relist"] = (calls["n"], sorted(kube.objects))
    return out


def test_watch_loop_runs_the_reference_scenarios():
    want = _watch_scenarios(ref_op, ref_watch)
    assert _watch_scenarios(port_op, port_watch) == want
    assert want["added_deleted"] == [] and want["relist_finalizes"] == []
    assert want["early_relist"][0] >= 2 and want["early_relist"][1]
    got_instances = {k.split("/")[2].rsplit("-", 1)[0] for k in want["churn"]}
    assert got_instances == set(want["churn_alive"])


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _lease_sequence(leader):
    """The follower's wait, the holder's renewals, the takeover, the
    deposed leader's failed renewal, and a four-way CAS race."""
    leases = leader.InMemoryLeases()
    ca, cb = FakeClock(), FakeClock()
    a = leader.LeaderElector(leases, "a", lease_duration_s=15, clock=ca)
    b = leader.LeaderElector(leases, "b", lease_duration_s=15, clock=cb)
    seq = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
    cb.t = 10.0
    seq.append(b.try_acquire_or_renew())
    seq.append(a.try_acquire_or_renew())
    cb.t = 20.0
    seq.append(b.try_acquire_or_renew())
    cb.t = 36.0
    seq.append(b.try_acquire_or_renew())
    seq.append(a.try_acquire_or_renew())
    spec, version = leases.read("default", "dynamo-tpu-operator")
    race = leader.InMemoryLeases()
    wins = [leader.LeaderElector(race, f"e{i}", clock=FakeClock())
            .try_acquire_or_renew() for i in range(4)]
    return seq, {k: v for k, v in spec.items() if k != "renewTime"}, version, wins


def test_leader_election_matches_the_reference():
    want = _lease_sequence(ref_leader)
    assert _lease_sequence(port_leader) == want
    assert want[0] == [True, False, False, True, False, True, False]
    assert want[1] == {"holderIdentity": "b", "leaseDurationSeconds": 15,
                       "leaseTransitions": 1} and sum(want[3]) == 1
    cas = port_leader.KubectlLeases._CAS_REASON
    assert cas.pattern == ref_leader.KubectlLeases._CAS_REASON.pattern


class FlakyLeases(port_leader.InMemoryLeases):
    def __init__(self):
        super().__init__()
        self.fail = False

    def read(self, namespace, name):
        if self.fail:
            raise RuntimeError("apiserver unreachable")
        return super().read(namespace, name)


def test_leader_steps_down_past_the_renew_deadline_not_before():
    clock = FakeClock()
    leases = FlakyLeases()
    e = port_leader.LeaderElector(leases, "a", lease_duration_s=15,
                                  renew_deadline_s=10, clock=clock)
    assert e.try_acquire_or_renew()
    leases.fail = True
    with pytest.raises(RuntimeError):
        e.try_acquire_or_renew()  # a blip inside the deadline: retried
    leases.fail = False
    assert e.try_acquire_or_renew()
    # renewal failing past the deadline (real clock): the leader steps down
    leases = FlakyLeases()
    e = port_leader.LeaderElector(leases, "a", lease_duration_s=0.3,
                                  renew_interval_s=0.01, renew_deadline_s=0.05)
    assert e.try_acquire_or_renew()
    leases.fail = True
    stop = threading.Event()
    t = threading.Thread(target=e._renew_until_lost, args=(stop,), daemon=True)
    t.start()
    assert stop.wait(timeout=5.0), "the leader did not step down"
    t.join(timeout=2.0)


def test_leader_run_leads_then_steps_down_when_the_lease_is_taken():
    leases = port_leader.InMemoryLeases()
    clock = FakeClock()
    e = port_leader.LeaderElector(leases, "a", renew_interval_s=0.01,
                                  clock=clock)
    led, stop = threading.Event(), threading.Event()

    def lead():
        led.set()
        other = port_leader.LeaderElector(leases, "b", clock=clock)
        spec, version = leases.read("default", "dynamo-tpu-operator")
        assert leases.write("default", "dynamo-tpu-operator", other._spec(1),
                            version)
        assert stop.wait(timeout=5.0)

    e.run(stop, lead)
    assert led.is_set() and stop.is_set()


# -------------------------------------------------------- the port's CRD


def test_port_crd_declares_the_served_fields_and_roles():
    crd = yaml.safe_load((PORT_DEPLOY / "crd.yaml").read_text())
    ref_crd = yaml.safe_load((REPO / "deploy" / "kubernetes" / "crd.yaml").read_text())
    assert (crd["spec"]["group"], crd["spec"]["names"]["kind"],
            crd["spec"]["names"]["plural"]) == (
        port_op.GROUP, port_op.KIND, port_op.PLURAL) == (
        ref_crd["spec"]["group"], ref_crd["spec"]["names"]["kind"],
        ref_crd["spec"]["names"]["plural"])
    (version,) = crd["spec"]["versions"]
    assert version["name"] == port_op.VERSION
    schema = version["schema"]["openAPIV3Schema"]["properties"]
    svc = schema["spec"]["properties"]["services"]["additionalProperties"]
    props = svc["properties"]
    assert {"gpus", "gpuProduct"} <= set(props)
    assert not set(port_op.TPU_FIELDS) & set(props)
    # every role the operator renders passes the enum (the reference's
    # enum lacks planner and hub: a structural schema rejects those CRs)
    roles = set(port_op.ROLE_ARGS) | {"dynstore"}
    assert set(props["role"]["enum"]) == roles
    ref_roles = ref_crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"][
        "properties"]["spec"]["properties"]["services"][
        "additionalProperties"]["properties"]["role"]["enum"]
    assert roles - set(ref_roles) == {"planner", "hub"}
    # the status the reconciler writes survives pruning
    kube = port_op.InMemoryKube()
    port_op.Reconciler(kube).reconcile(dict(CRS["artifact"], metadata=dict(
        CRS["artifact"]["metadata"], generation=2)))
    (status,) = kube.statuses.values()
    assert set(status) <= set(schema["status"]["properties"])


def test_port_example_is_json_and_renders():
    spec = json.loads((PORT_DEPLOY / "example-disagg.json").read_text())
    cr = {"apiVersion": f"{port_op.GROUP}/{port_op.VERSION}",
          "kind": port_op.KIND, "metadata": {"name": "llama8b-disagg"},
          "spec": spec}
    by = {m["metadata"]["name"]: m for m in port_op.render_manifests(cr)}
    assert sorted(by) == ["llama8b-disagg-decode", "llama8b-disagg-dynstore",
                          "llama8b-disagg-frontend", "llama8b-disagg-planner",
                          "llama8b-disagg-prefill", "llama8b-disagg-processor"]
    decode = by["llama8b-disagg-decode"]["spec"]["template"]["spec"]
    assert decode["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    # the example is the reference's graph with its TPU words mapped
    ref_spec = _example_cr()["spec"]
    assert set(spec["services"]) == set(ref_spec["services"]) | {"planner"}
    assert spec["services"]["prefill"]["replicas"] == ref_spec["services"][
        "prefill"]["replicas"]


def test_deploy_package_exports_the_reference_names():
    import dynamo_tpu.deploy as ref_pkg
    import dynamo_tpu_torch.deploy as port_pkg

    assert port_pkg.__all__ == ref_pkg.__all__
    assert (port_op.GROUP, port_op.VERSION, port_op.KIND, port_op.PLURAL) == (
        ref_op.GROUP, ref_op.VERSION, ref_op.KIND, ref_op.PLURAL)
