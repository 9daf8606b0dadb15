"""The port's example LLM graph (``dynamo_tpu_torch/examples/llm``) against
the reference's (``examples/llm``), served in process.

Every case of the reference's ``tests/test_examples_llm.py`` has its
counterpart (the graphs compose; the agg graph end to end over HTTP SSE
with echo engines; the agg_router graph asking the Router service for a
worker). Then both packages serve the same tiny f32 checkpoint written by
``transformers`` at the same seed through their agg and agg_router graphs
(``engine: torch`` on the CPU against ``engine: jax``), greedy: the
streams are equal, text and finish reason. And the port's Worker refuses
by name what it does not serve: ``engine: jax``, ``engine: torch`` on a
card it did not ask for, the multi-host keys and ici.

Tolerance: exact equality (greedy f32 streams of the same weights).
"""

import asyncio
import json
import os
import sys
import urllib.request
from pathlib import Path

import pytest

from dynamo_tpu.runtime.component import DistributedRuntime as RefDrt
from dynamo_tpu.runtime.transports.memory import MemoryHub as RefHub
from dynamo_tpu.sdk import ServiceConfig as RefServiceConfig
from dynamo_tpu.sdk import serving as ref_serving
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.transports.memory import MemoryHub
from dynamo_tpu_torch.sdk import DynamoClient, ServiceConfig, graph_services
from dynamo_tpu_torch.sdk.serving import serve_graph_inprocess, stop_graph
from fixtures import make_model_dir

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from dynamo_tpu_torch.examples.llm import components as C  # noqa: E402
from examples.llm import components as RC  # noqa: E402

SERVICES = ("Frontend", "Processor", "Router", "Worker", "PrefillWorker")


@pytest.fixture
def model_dir(tmp_path):
    return make_model_dir(tmp_path)


@pytest.fixture(autouse=True)
def fresh_links():
    """Link state is process-global; each test composes its own graph."""
    for mod in (C, RC):
        for name in SERVICES:
            getattr(mod, name).unlink_all()
    yield
    for mod in (C, RC):
        for name in SERVICES:
            getattr(mod, name).unlink_all()


def _config(model_dir, extra=None, cls=ServiceConfig):
    data = {
        "Common": {"model-path": model_dir, "model-name": "tiny"},
        "Frontend": {"http-port": 0, "http-host": "127.0.0.1"},
        "Processor": {"router-mode": "round_robin",
                      "common-configs": ["model-path", "model-name"]},
        "Worker": {"engine": "echo_core",
                   "common-configs": ["model-path", "model-name"]},
        "Router": {"block-size": 4},
    }
    for k, v in (extra or {}).items():
        data.setdefault(k, {}).update(v)
    return cls(data)


def test_graphs_compose():
    """The flagship chain reaches all five services; the agg chain does NOT
    pull in Router/PrefillWorker (graph modules link at import time, one
    graph per process; tests compose explicitly instead). Both packages
    compose the same."""
    for mod in (C, RC):
        mod.Frontend.link(mod.Processor).link(mod.Router).link(
            mod.Worker).link(mod.PrefillWorker)
        assert {s.name for s in graph_services(mod.Frontend)} == set(SERVICES)
        for name in SERVICES:
            getattr(mod, name).unlink_all()
        mod.Frontend.link(mod.Processor).link(mod.Worker)
        assert [s.name for s in graph_services(mod.Frontend)] == [
            "Frontend", "Processor", "Worker"]
    # the port's workers ask for one card each; the rest for none
    assert C.Worker.spec.resources == C.PrefillWorker.spec.resources == {"gpu": 1}
    assert C.Frontend.spec.resources == C.Processor.spec.resources == {}


async def _fetch_sse(url, body):
    """POST + parse SSE in a thread (urllib is sync)."""
    def go():
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        chunks = []
        with urllib.request.urlopen(req, timeout=60) as resp:
            for line in resp:
                line = line.decode().strip()
                if line.startswith("data: ") and line != "data: [DONE]":
                    chunks.append(json.loads(line[len("data: "):]))
        return chunks
    return await asyncio.get_running_loop().run_in_executor(None, go)


def _text_and_finish(chunks):
    text = "".join(
        (c.get("choices", [{}])[0].get("delta") or {}).get("content") or ""
        for c in chunks if c.get("choices"))
    finish = [c["choices"][0].get("finish_reason") for c in chunks
              if c.get("choices") and c["choices"][0].get("finish_reason")]
    return text, finish


async def _await_model(port, name="tiny", timeout_s=30.0):
    """Poll the front's /v1/models until the watcher has the model (the
    Processor's registration is observable there)."""
    def models():
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/models", timeout=10) as r:
            return [m["id"] for m in json.loads(r.read())["data"]]

    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while name not in await loop.run_in_executor(None, models):
        assert loop.time() < deadline, "the front never listed the model"
        await asyncio.sleep(0.05)


async def _serve_chats(serving, mod, drt, cfg, bodies):
    """Serve ``mod``'s linked agg graph in process; POST each body to its
    Frontend; the (text, finish) of each stream."""
    drt2, handles, objs = await serving.serve_graph_inprocess(
        mod.Frontend, drt, config=cfg)
    try:
        port = objs["Frontend"].http.port
        await _await_model(port)
        return [_text_and_finish(await _fetch_sse(
            f"http://127.0.0.1:{port}/v1/chat/completions", b)) for b in bodies]
    finally:
        if serving is ref_serving:
            await serving.stop_graph(drt2, handles)
            for obj in objs.values():
                engine = getattr(obj, "engine", None)
                if hasattr(engine, "close"):
                    await engine.close()
            await objs["Frontend"].http.stop()
            await objs["Frontend"].watcher.stop()
        else:
            await serving.stop_graph(drt2, handles, objs)


async def test_agg_graph_end_to_end(model_dir):
    """HTTP SSE -> Frontend -> Processor -> Worker (echo) -> stream back; the
    reference's graph streams the same."""
    body = {"model": "tiny", "stream": True, "max_tokens": 8,
            "messages": [{"role": "user", "content": "hello world"}]}
    C.Frontend.link(C.Processor).link(C.Worker)
    (got,) = await _serve_chats(sys.modules["dynamo_tpu_torch.sdk.serving"], C,
                                DistributedRuntime.in_process(MemoryHub()),
                                _config(model_dir), [body])
    text, finish = got
    assert text  # the echo engine detokenizes the prompt back
    assert finish, "no finish_reason chunk"
    RC.Frontend.link(RC.Processor).link(RC.Worker)
    (want,) = await _serve_chats(ref_serving, RC, RefDrt.in_process(RefHub()),
                                 _config(model_dir, cls=RefServiceConfig), [body])
    assert got == want


async def test_agg_router_graph_kv_routing(model_dir):
    """router-mode kv: the Processor asks the Router service for a worker."""
    C.Frontend.link(C.Processor).link(C.Router).link(C.Worker)
    drt = DistributedRuntime.in_process(MemoryHub())
    cfg = _config(model_dir, extra={"Processor": {"router-mode": "kv"}})
    drt2, handles, objs = await serve_graph_inprocess(C.Frontend, drt, config=cfg)
    try:
        client = DynamoClient(C.Processor, drt)
        await client.start()
        await client.wait_ready(timeout=10)
        chunks = [
            c async for c in client.chat({
                "model": "tiny",
                "messages": [{"role": "user", "content": "route me please"}],
                "stream": True,
                "max_tokens": 4,
            })
        ]
        assert chunks
        # the Router service itself answers scheduling queries
        router_client = DynamoClient(C.Router, drt)
        await router_client.start()
        await router_client.wait_ready(timeout=10)
        decisions = [d async for d in router_client.generate(
            {"token_ids": list(range(16))}
        )]
        assert decisions and decisions[0]["worker_id"] == objs["Worker"].instance_id
    finally:
        await stop_graph(drt2, handles, objs)


# --------------------------------------- a checkpoint through both graphs


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    import torch
    from transformers import LlamaConfig, LlamaForCausalLM

    d = make_model_dir(tmp_path_factory.mktemp("examples"), name="tiny-hf")
    cfg = LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      tie_word_embeddings=False)
    torch.manual_seed(3)
    LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    with open(os.path.join(d, "config.json")) as f:
        c = json.load(f)
    c["eos_token_id"], c["bos_token_id"] = 2, 1
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(c, f)
    with open(os.path.join(d, "f32.json"), "w") as f:
        json.dump({"dtype": "float32"}, f)
    return d


CHATS = [
    {"model": "tiny", "stream": True, "max_tokens": 8, "temperature": 0.0,
     "ignore_eos": True,
     "messages": [{"role": "user", "content": "the quick brown fox"}]},
    {"model": "tiny", "stream": True, "max_tokens": 6, "temperature": 0.0,
     "ignore_eos": True,
     "messages": [{"role": "user", "content": "hello world this is a test"}]},
]


def _engine_config(ckpt, engine, router, cls):
    worker = {"engine": engine, "max-model-len": 128, "kv-block-size": 8,
              "max-batch-size": 4, "extra-engine-args": f"{ckpt}/f32.json"}
    if engine == "torch":
        worker["device"] = "cpu"
    extra = {"Worker": worker, "Router": {"block-size": 8}}
    if router:
        extra["Processor"] = {"router-mode": "kv"}
    return _config(ckpt, extra=extra, cls=cls)


@pytest.mark.parametrize("router", [False, True], ids=["agg", "agg_router"])
async def test_checkpoint_streams_match_the_reference(ckpt_dir, router):
    """The same tiny checkpoint, greedy, through each package's graph
    (``engine: torch`` on the CPU; the reference's ``engine: jax``): the
    same text and finish reason on every stream."""
    for mod in (C, RC):
        chain = mod.Frontend.link(mod.Processor)
        if router:
            chain = chain.link(mod.Router)
        chain.link(mod.Worker)
    got = await _serve_chats(
        sys.modules["dynamo_tpu_torch.sdk.serving"], C,
        DistributedRuntime.in_process(MemoryHub()),
        _engine_config(ckpt_dir, "torch", router, ServiceConfig), CHATS)
    want = await _serve_chats(
        ref_serving, RC, RefDrt.in_process(RefHub()),
        _engine_config(ckpt_dir, "jax", router, RefServiceConfig), CHATS)
    assert got == want
    assert all(f == ["length"] for _, f in got)
    assert all(t for t, _ in got)


# ---------------------------------------------------------------- refusals


async def _setup_worker(cfg, resources):
    obj = C.Worker.cls()
    obj.service_config = cfg
    obj.drt = DistributedRuntime.in_process(MemoryHub())
    obj.resources = resources
    try:
        await obj.setup()
    finally:
        await obj.drt.close()


@pytest.mark.parametrize("cfg,resources,needle", [
    ({"engine": "jax"}, {"gpu": 1}, "engine 'jax' is not served"),
    ({"engine": "torch", "model-path": "/x"}, {}, "name no 'gpu'"),
    ({"engine": "torch", "num-nodes": 2, "node-rank": 0}, {"gpu": 1},
     "multi-host"),
    ({"engine": "torch", "kv-transfer": "ici"}, {"gpu": 1},
     "--kv-transfer ici"),
    ({"engine": "torch", "tensor-parallel-size": 2}, {"gpu": 1},
     "--tensor-parallel-size"),
    ({"engine": "torch", "no-such-flag": 1}, {"gpu": 1}, "--no-such-flag"),
], ids=["jax", "no_gpu", "multi_host", "ici", "tp", "unknown"])
async def test_worker_refuses_what_the_port_does_not_serve(cfg, resources,
                                                           needle):
    with pytest.raises(ValueError, match=needle):
        await _setup_worker(cfg, resources)


def test_prefill_worker_refuses_ici():
    from dynamo_tpu_torch.examples.llm.components import worker_flags

    cfg = ServiceConfig.from_file(
        str(REPO / "examples/llm/configs/disagg_ici.yaml")).get("PrefillWorker")
    with pytest.raises(ValueError, match="multi-host"):
        worker_flags(cfg)
    cfg = {k: v for k, v in cfg.items()
           if k not in ("num-nodes", "node-rank", "leader-addr")}
    with pytest.raises(ValueError, match="--kv-transfer ici"):
        worker_flags(cfg)
