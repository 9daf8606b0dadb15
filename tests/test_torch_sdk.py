"""The port's graph SDK against the reference's.

Every case of the reference's ``tests/test_sdk.py`` has its counterpart
here on ``dynamo_tpu_torch.sdk`` (decorators and graph composition,
``ServiceConfig``'s Common opt-in, the allocator, in-process graphs end to
end, the ladder configs), each held against the reference where both
packages can run it: the same declarations give the same metadata, the
same config documents give the same ``get`` and ``as_args``, the same
graphs stream the same items. Where the port differs on purpose the
case says so: cards are ``gpu`` handed out by ``CUDA_VISIBLE_DEVICES``
(``GpuAllocator``), and a ``tpu`` resource, the parallel sizes, the
multi-host keys and ``kv-transfer: ici`` raise by name. Beyond the
reference: ``ServiceConfig`` on every ``examples/llm/configs/*.yaml`` and
on the port's JSON copies, YAML without the ``yaml`` package, the
hello-world graph, and ``python -m dynamo_tpu_torch.sdk.worker`` processes
under ``GraphSupervisor`` on the CPU.

Tolerance: exact equality throughout.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dynamo_tpu import sdk as ref_sdk
from dynamo_tpu.runtime.component import DistributedRuntime as RefDrt
from dynamo_tpu.runtime.transports.memory import MemoryHub as RefHub
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.transports.memory import MemoryHub
from dynamo_tpu_torch.sdk import (
    AllocationError,
    DynamoClient,
    GpuAllocator,
    ServiceConfig,
    async_on_start,
    depends,
    dynamo_endpoint,
    graph_services,
    serve_graph_inprocess,
    service,
    stop_graph,
)

REPO = Path(__file__).resolve().parent.parent
REF_CONFIGS = REPO / "examples" / "llm" / "configs"
PORT_CONFIGS = REPO / "dynamo_tpu_torch" / "examples" / "llm" / "configs"


# ---- a tiny two-service graph used across tests (the reference's, with a
# card asked for as "gpu") ----

@service(dynamo={"namespace": "testns"}, resources={"gpu": 1}, workers=2)
class Backend:
    @dynamo_endpoint
    async def generate(self, request):
        for tok in request["prompt"].split():
            yield {"token": tok.upper()}

    @dynamo_endpoint(name="ping")
    async def ping_handler(self, request):
        yield {"pong": True}


@service(dynamo={"namespace": "testns"})
class Middle:
    backend = depends(Backend)

    @async_on_start
    async def setup(self):
        self.started = True

    @dynamo_endpoint
    async def chat(self, request):
        assert self.started
        async for item in self.backend.generate(request):
            yield {"echo": item["token"]}


def _declare(sdk, resources):
    """The same two-service graph declared with ``sdk``."""

    @sdk.service(dynamo={"namespace": "testns"}, resources=resources, workers=2)
    class Backend:
        @sdk.dynamo_endpoint
        async def generate(self, request):
            for tok in request["prompt"].split():
                yield {"token": tok.upper()}

        @sdk.dynamo_endpoint(name="ping")
        async def ping_handler(self, request):
            yield {"pong": True}

    @sdk.service(dynamo={"namespace": "testns"})
    class Middle:
        backend = sdk.depends(Backend)

        @sdk.async_on_start
        async def setup(self):
            self.started = True

        @sdk.dynamo_endpoint
        async def chat(self, request):
            async for item in self.backend.generate(request):
                yield {"echo": item["token"]}

    return Backend, Middle


def _meta(svc):
    return dict(name=svc.name, namespace=svc.spec.namespace,
                workers=svc.spec.workers, enabled=svc.spec.enabled,
                endpoints=dict(svc.endpoints), on_start=list(svc.on_start),
                deps={k: d.target.name for k, d in svc.dependencies.items()},
                path=svc.endpoint_path("generate"))


class TestDecorators:
    def test_service_metadata(self):
        assert Backend.name == "Backend"
        assert Backend.spec.namespace == "testns"
        assert Backend.spec.resources == {"gpu": 1}
        assert Backend.spec.workers == 2
        assert set(Backend.endpoints) == {"generate", "ping"}
        assert Backend.endpoints["ping"] == "ping_handler"
        assert Backend.endpoint_path("generate") == "dyn://testns.Backend.generate"
        # the reference's declaration gives the same metadata
        ref_b, _ = _declare(ref_sdk, {"tpu": 1})
        assert _meta(ref_b) == _meta(Backend)

    def test_dependencies_and_hooks(self):
        assert "backend" in Middle.dependencies
        assert Middle.dependencies["backend"].target is Backend
        assert Middle.on_start == ["setup"]
        _, ref_m = _declare(ref_sdk, {})
        assert ref_m.on_start == Middle.on_start
        assert list(ref_m.dependencies) == list(Middle.dependencies)

    def test_depends_rejects_plain_class(self):
        for sdk in (ref_sdk, sys.modules["dynamo_tpu_torch.sdk"]):
            with pytest.raises(TypeError):
                sdk.depends(object)

    def test_link_chain_and_graph(self):
        names = []
        for sdk in (ref_sdk, sys.modules["dynamo_tpu_torch.sdk"]):
            @sdk.service
            class A:
                pass

            @sdk.service
            class B:
                pass

            @sdk.service
            class C:
                pass

            # reference-style chain: A -> B -> C
            A.link(B).link(C)
            names.append([s.name for s in sdk.graph_services(A)])
        assert names == [["A", "B", "C"]] * 2
        # Middle's graph pulls Backend through depends()
        assert [s.name for s in graph_services(Middle)] == ["Middle", "Backend"]


class TestServiceConfig:
    def _both(self, data):
        return ref_sdk.ServiceConfig(data), ServiceConfig(data)

    def test_common_opt_in(self):
        data = {
            "Common": {"model": "m8b", "block-size": 64, "max-model-len": 16384},
            "Worker": {"enforce-eager": True,
                       "common-configs": ["model", "block-size"]},
        }
        ref, cfg = self._both(data)
        merged = cfg.get("Worker")
        assert merged == ref.get("Worker") == {
            "enforce-eager": True, "model": "m8b", "block-size": 64}
        args = cfg.as_args("Worker")
        assert args == ref.as_args("Worker")
        assert "--enforce-eager" in args
        assert args[args.index("--model") + 1] == "m8b"
        assert "--max-model-len" not in args

    def test_no_opt_in_no_common(self):
        ref, cfg = self._both({"Common": {"model": "m8b"},
                               "Worker": {"enforce-eager": True}})
        assert "model" not in cfg.get("Worker")
        assert cfg.get("Worker") == ref.get("Worker")

    def test_service_values_beat_common(self):
        ref, cfg = self._both({
            "Common": {"model": "common-model"},
            "Worker": {"model": "mine", "common-configs": ["model"]},
        })
        assert cfg.get("Worker")["model"] == ref.get("Worker")["model"] == "mine"

    def test_false_bool_and_list_args(self):
        ref, cfg = self._both({"W": {"flag-off": False, "multi": [1, 2]}})
        args = cfg.as_args("W")
        assert args == ref.as_args("W")
        assert "--flag-off" not in args
        assert args.count("--multi") == 2


class TestAllocator:
    """``GpuAllocator`` hands out ``CUDA_VISIBLE_DEVICES`` where the
    reference's ``TpuAllocator`` hands out ``TPU_VISIBLE_CHIPS``: the same
    assignment order, exhaustion and release."""

    def test_assign_and_exhaust(self, monkeypatch):
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        alloc = GpuAllocator(total_gpus=4)
        ref = ref_sdk.TpuAllocator(total_chips=4)
        env, gpus = alloc.env_for({"gpu": 2})
        assert env == {"CUDA_VISIBLE_DEVICES": "0,1"} and gpus == [0, 1]
        assert ref.env_for({"tpu": 2}) == ({"TPU_VISIBLE_CHIPS": "0,1"}, gpus)
        env, gpus2 = alloc.env_for({"gpu": 2})
        assert env == {"CUDA_VISIBLE_DEVICES": "2,3"}
        assert ref.env_for({"tpu": 2})[1] == gpus2
        with pytest.raises(AllocationError):
            alloc.env_for({"gpu": 1})
        with pytest.raises(ref_sdk.AllocationError):
            ref.env_for({"tpu": 1})

    def test_release_makes_chips_reusable(self, monkeypatch):
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        alloc = GpuAllocator(total_gpus=2)
        _env, gpus = alloc.env_for({"gpu": 2})
        assert alloc.available == 0
        alloc.release(gpus)
        assert alloc.available == 2
        _env, again = alloc.env_for({"gpu": 2})
        assert again == [0, 1]

    def test_cpu_only_service(self):
        alloc = GpuAllocator(total_gpus=1)
        env, gpus = alloc.env_for({})
        # no card: CUDA stays closed to the service (the reference keeps
        # jax off the TPU with JAX_PLATFORMS=cpu)
        assert env == {"CUDA_VISIBLE_DEVICES": ""} and gpus == []
        assert alloc.available == 1
        assert ref_sdk.TpuAllocator(total_chips=1).env_for({}) == (
            {"JAX_PLATFORMS": "cpu"}, [])


def test_allocator_names_the_cards_this_process_sees(monkeypatch):
    """Under ``CUDA_VISIBLE_DEVICES=3,5`` the cards are counted from it and
    a worker's variable names the cards themselves, not their indices."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    monkeypatch.delenv("DYNAMO_TPU_NUM_GPUS", raising=False)
    alloc = GpuAllocator()
    assert alloc.total_gpus == 2
    assert alloc.env_for({"gpu": 1}) == ({"CUDA_VISIBLE_DEVICES": "3"}, [0])
    assert alloc.env_for({"gpu": 1}) == ({"CUDA_VISIBLE_DEVICES": "5"}, [1])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert GpuAllocator().total_gpus == 0
    monkeypatch.setenv("DYNAMO_TPU_NUM_GPUS", "4")
    assert GpuAllocator().total_gpus == 4


def test_tpu_resources_raise_by_name():
    """A ``tpu`` resource asks for a card the port does not serve: the
    declaration, the allocator and a service spec built by hand raise,
    naming it."""
    with pytest.raises(AllocationError, match="'tpu'.*'gpu'"):
        @service(resources={"tpu": 1})
        class Chips:
            pass
    with pytest.raises(AllocationError, match="'tpu'"):
        GpuAllocator(total_gpus=8).env_for({"tpu": 1})


async def _round_trip(sdk, drt, hub_drt, root, target, endpoint, payload):
    drt2, handles, objs = await sdk.serve_graph_inprocess(root, drt)
    try:
        client = sdk.DynamoClient(target, hub_drt)
        await client.start()
        await client.wait_ready(timeout=5.0)
        return [item async for item in getattr(client, endpoint)(payload)]
    finally:
        await sdk.stop_graph(drt2, handles)


async def test_e2e_graph_inprocess():
    """Full depends() round trip: Middle.chat -> network -> Backend.generate,
    in both packages."""
    drt = DistributedRuntime.in_process(MemoryHub())
    out = await _round_trip(sys.modules["dynamo_tpu_torch.sdk"], drt, drt,
                            Middle, Middle, "chat", {"prompt": "hello tpu world"})
    assert out == [{"echo": "HELLO"}, {"echo": "TPU"}, {"echo": "WORLD"}]
    _, ref_m = _declare(ref_sdk, {})
    rdrt = RefDrt.in_process(RefHub())
    ref = await _round_trip(ref_sdk, rdrt, rdrt, ref_m, ref_m, "chat",
                            {"prompt": "hello tpu world"})
    assert ref == out


async def test_optional_second_param_is_not_ctx():
    """generate(self, request, temperature=0.7) must NOT receive the ctx."""

    @service(dynamo={"namespace": "optns"})
    class Sampler:
        @dynamo_endpoint
        async def generate(self, request, temperature=0.7):
            yield {"temperature": temperature}

    drt = DistributedRuntime.in_process(MemoryHub())
    out = await _round_trip(sys.modules["dynamo_tpu_torch.sdk"], drt, drt,
                            Sampler, Sampler, "generate", {})
    assert out == [{"temperature": 0.7}]


def test_inherited_endpoints_are_discovered():
    class BaseWorker:
        @dynamo_endpoint
        async def generate(self, request):
            yield {"base": True}

    @service
    class Derived(BaseWorker):
        @dynamo_endpoint
        async def extra(self, request):
            yield {}

    assert set(Derived.endpoints) == {"generate", "extra"}


async def test_endpoint_receives_ctx_and_stops():
    """(request, ctx) endpoints get the engine context; stop is cooperative."""

    @service(dynamo={"namespace": "ctxns"})
    class Stoppable:
        @dynamo_endpoint
        async def stream(self, request, ctx):
            for i in range(1000):
                if ctx.is_stopped:
                    return
                yield {"i": i}
                await asyncio.sleep(0)

    drt = DistributedRuntime.in_process(MemoryHub())
    drt2, handles, _objs = await serve_graph_inprocess(Stoppable, drt)
    try:
        from dynamo_tpu_torch.runtime.client import Client
        from dynamo_tpu_torch.runtime.engine import Context

        client = Client(
            drt.namespace("ctxns").component("Stoppable").endpoint("stream")
        )
        await client.start()
        await client.wait_for_instances(timeout=5.0)
        request = Context({"x": 1})
        seen = 0
        async for _item in client.generate(request):
            seen += 1
            if seen == 3:
                request.context.stop_generating()
        assert seen < 1000  # stopped early, not fully drained
    finally:
        await stop_graph(drt2, handles)


async def test_e2e_unknown_endpoint_raises():
    drt = DistributedRuntime.in_process(MemoryHub())
    drt2, handles, _objs = await serve_graph_inprocess(Backend, drt)
    try:
        client = DynamoClient(Backend, drt)
        with pytest.raises(AttributeError, match="no endpoint"):
            client.nope
    finally:
        await stop_graph(drt2, handles)


async def test_stop_graph_closes_the_services():
    """The port's ``stop_graph`` also closes each service that has a
    ``close()`` (a Worker's engine, a Frontend's server), the graph's root
    first."""
    closed = []

    @service(dynamo={"namespace": "closens"})
    class Leaf:
        @dynamo_endpoint
        async def generate(self, request):
            yield {}

        async def close(self):
            closed.append("Leaf")

    @service(dynamo={"namespace": "closens"})
    class Root:
        leaf = depends(Leaf)

        async def close(self):
            closed.append("Root")

    drt = DistributedRuntime.in_process(MemoryHub())
    drt2, handles, objs = await serve_graph_inprocess(Root, drt)
    assert set(objs) == {"Leaf", "Root"}
    assert objs["Root"].resources == {} and objs["Leaf"].drt is drt
    await stop_graph(drt2, handles, objs)
    assert closed == ["Root", "Leaf"]


async def test_hello_world_graph_matches_the_reference():
    """``examples/hello_world``'s three services stream the same items in
    both packages."""
    sys.path.insert(0, str(REPO))
    from dynamo_tpu_torch.examples import hello_world as port_hw
    from examples.hello_world import hello_world as ref_hw

    payload = {"text": "a, b,c"}
    drt = DistributedRuntime.in_process(MemoryHub())
    got = await _round_trip(sys.modules["dynamo_tpu_torch.sdk"], drt, drt,
                            port_hw.Frontend, port_hw.Frontend, "generate",
                            payload)
    rdrt = RefDrt.in_process(RefHub())
    want = await _round_trip(ref_sdk, rdrt, rdrt, ref_hw.Frontend,
                             ref_hw.Frontend, "generate", payload)
    assert got == want == [{"text": "front-mid-back-a"},
                           {"text": "front-mid-back-b"},
                           {"text": "front-mid-back-c"}]


# ---------------------------------------------------------------- configs


def _all_yaml():
    return sorted(p.name for p in REF_CONFIGS.glob("*.yaml"))


@pytest.mark.parametrize("name", _all_yaml())
def test_reference_yaml_configs_read_the_same(name):
    """``ServiceConfig.get`` and ``as_args`` of every reference config
    (read on this machine, which has PyYAML) agree in both packages for
    every section."""
    path = str(REF_CONFIGS / name)
    ref = ref_sdk.ServiceConfig.from_file(path)
    port = ServiceConfig.from_file(path)
    assert port.data == ref.data
    for svc in ref.data:
        assert port.get(svc) == ref.get(svc)
        assert port.as_args(svc) == ref.as_args(svc)


@pytest.mark.parametrize("name", ["agg", "agg_router", "disagg_router",
                                  "deepseek_mla_disagg"])
def test_port_json_configs_mirror_the_reference(name):
    """The port's JSON copies have the reference's services and keys, with
    the port's values where the port differs: ``engine: torch``, tcp for
    ici, one card a worker (no parallel sizes, no multi-host keys)."""
    port = ServiceConfig.from_file(str(PORT_CONFIGS / f"{name}.json"))
    ref = ref_sdk.ServiceConfig.from_file(str(REF_CONFIGS / f"{name}.yaml"))
    assert list(port.data) == list(ref.data)
    dropped = {"tensor-parallel-size", "expert-parallel-size", "num-nodes",
               "node-rank", "leader-addr"}
    for svc in ref.data:
        want = {k for k in ref.get(svc) if k not in dropped}
        assert set(port.get(svc)) == want, svc
        for key, value in ref.get(svc).items():
            if key in ("engine", "kv-transfer", "model-path", "model-name",
                       "max-model-len") or key in dropped:
                continue
            assert port.get(svc)[key] == value, (svc, key)
    worker = port.get("Worker")
    assert worker["engine"] == "torch"
    assert worker.get("kv-transfer", "tcp") == "tcp"


def test_yaml_without_the_package_raises_by_name(monkeypatch, tmp_path):
    """JSON always; YAML needs the ``yaml`` package, and without it the
    port raises naming it (the reference's ``import yaml`` fails with a
    bare ModuleNotFoundError); never an empty config in silence."""
    import builtins

    real = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    cfg = tmp_path / "g.yaml"
    cfg.write_text("Worker:\n  engine: torch\n")
    with pytest.raises(ValueError, match="yaml package is not installed"):
        ServiceConfig.from_file(str(cfg))
    js = tmp_path / "g.json"
    js.write_text(json.dumps({"Worker": {"engine": "torch"}}))
    assert ServiceConfig.from_file(str(js)).get("Worker") == {"engine": "torch"}


def test_service_config_from_the_environment(monkeypatch):
    """Both packages read ``DYNAMO_TPU_SERVICE_CONFIG`` (one name for a
    deployment)."""
    doc = {"Common": {"m": 1}, "W": {"x": 2, "common-configs": ["m"]}}
    monkeypatch.setenv("DYNAMO_TPU_SERVICE_CONFIG", json.dumps(doc))
    monkeypatch.setattr(ServiceConfig, "_instance", None)
    monkeypatch.setattr(ref_sdk.ServiceConfig, "_instance", None)
    assert (ServiceConfig.get_instance().get("W")
            == ref_sdk.ServiceConfig.get_instance().get("W") == {"m": 1, "x": 2})


class TestLadderConfigs:
    """The reference's config ladder, read by the port: the configs that
    one host of cards serves parse into Worker flags; the ones that need
    several cards or ici raise by name."""

    def _load(self, name):
        return ServiceConfig.from_file(str(REF_CONFIGS / name))

    def test_all_ladder_configs_parse(self):
        for name in ("agg.yaml", "agg_router.yaml", "disagg_router.yaml",
                     "tp70b_router.yaml", "mixtral_ep.yaml",
                     "disagg_ici.yaml", "deepseek_mla_disagg.yaml"):
            cfg = self._load(name)
            worker = cfg.get("Worker")
            assert worker.get("model-path"), name
            assert cfg.get("Frontend").get("http-port"), name
        for name in ("agg", "agg_router", "disagg_router",
                     "deepseek_mla_disagg"):
            cfg = ServiceConfig.from_file(str(PORT_CONFIGS / f"{name}.json"))
            assert cfg.get("Worker").get("model-path"), name
            assert cfg.get("Frontend").get("http-port"), name

    def test_tp70b_shards_and_routes(self):
        from dynamo_tpu_torch.examples.llm.components import worker_flags

        cfg = self._load("tp70b_router.yaml")
        assert cfg.get("Worker")["tensor-parallel-size"] == 8
        assert cfg.get("Processor")["router-mode"] == "kv"
        with pytest.raises(ValueError, match="--tensor-parallel-size"):
            worker_flags(cfg.get("Worker"))

    def test_ici_configs_join_one_world(self):
        """The reference joins both workers into one jax.distributed world
        over ici; the port refuses the multi-host keys and ici by name."""
        from dynamo_tpu_torch.examples.llm.components import worker_flags

        for name in ("disagg_ici.yaml", "deepseek_mla_disagg.yaml"):
            cfg = self._load(name)
            w, p = cfg.get("Worker"), cfg.get("PrefillWorker")
            assert w["kv-transfer"] == p["kv-transfer"] == "ici", name
            for section in (w, p):
                with pytest.raises(ValueError, match="num-nodes"):
                    worker_flags(section)
                one_host = {k: v for k, v in section.items()
                            if k not in ("num-nodes", "node-rank",
                                         "leader-addr", "tensor-parallel-size",
                                         "expert-parallel-size")}
                with pytest.raises(ValueError, match="--kv-transfer ici"):
                    worker_flags(one_host)

    def test_worker_flags_map_parallelism(self):
        from dynamo_tpu_torch.examples.llm.components import worker_flags

        with pytest.raises(ValueError, match="--expert-parallel-size"):
            worker_flags(self._load("mixtral_ep.yaml").get("Worker"))
        with pytest.raises(ValueError, match="--tensor-parallel-size"):
            worker_flags(self._load("tp70b_router.yaml").get("Worker"))
        # what one card serves maps key for key onto the CLI's flags
        flags = worker_flags(self._load("agg.yaml").get("Worker"))
        assert (flags.model_path, flags.model_name, flags.kv_block_size,
                flags.max_model_len, flags.max_batch_size) == (
            "/path/to/hf/snapshot", "my-model", 16, 4096, 8)


# ------------------------------------------------- processes on the CPU


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _await_listening(port, timeout_s=60.0):
    """Block until something accepts on ``port`` (the dynstore is up)."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def test_supervisor_spawns_the_hello_world_graph(tmp_path):
    """``GraphSupervisor`` runs one ``python -m dynamo_tpu_torch.sdk.worker``
    a service, each with ``CUDA_VISIBLE_DEVICES=""`` (no card asked for);
    the graph answers through the port's dynstore, and ``stop`` leaves no
    child running."""
    from dynamo_tpu_torch.examples import hello_world
    from dynamo_tpu_torch.sdk import GraphSupervisor

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    store = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.runtime.transports.dynstore",
         "--host", "127.0.0.1", "--port", str(port)], cwd=str(REPO), env=env)
    log = open(tmp_path / "workers.log", "w")
    sup = GraphSupervisor("dynamo_tpu_torch.examples.hello_world:Frontend",
                          hello_world.Frontend, store_port=port,
                          allocator=GpuAllocator(total_gpus=0), stdout=log)
    try:
        _await_listening(port)
        sup.start()
        assert sorted(v[:2] for v in sup.started.values()) == [
            ("Backend", ""), ("Frontend", ""), ("Middle", "")]

        async def ask():
            drt = await DistributedRuntime.connect("127.0.0.1", port)
            try:
                # every service has registered (they start at once)
                for svc in (hello_world.Backend, hello_world.Middle):
                    dep = await DynamoClient(svc, drt).start()
                    await dep.wait_ready(timeout=60)
                client = await DynamoClient(hello_world.Frontend, drt).start()
                await client.wait_ready(timeout=60)
                return [i async for i in client.generate({"text": "x,y"})]
            finally:
                await drt.close()

        out = asyncio.run(asyncio.wait_for(ask(), 120))
        assert out == [{"text": "front-mid-back-x"}, {"text": "front-mid-back-y"}]
        pids = list(sup.poll())
        assert all(rc is None for rc in sup.poll().values())
        sup.stop()
        assert sup.procs == []
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
        log.close()
        served = (tmp_path / "workers.log").read_text()
        for name in ("Frontend", "Middle", "Backend"):
            assert f"serving {name} dyn://hello.{name}.generate" in served
    finally:
        sup.stop()
        store.terminate()
        store.wait(timeout=30)


def test_worker_module_refuses_a_graph_spec_without_an_attribute():
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.sdk.worker",
         "dynamo_tpu_torch.examples.hello_world", "--store-port", "1"],
        cwd=str(REPO), capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode != 0 and "must be module:Attr" in proc.stderr
