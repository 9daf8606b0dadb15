"""The distributed inference graph of the port against the reference.

- KV events: ``TorchServingEngine`` with a ``KvEventSink`` emits the
  sequence of stored / removed events that ``JaxServingEngine`` emits on
  the same weights and requests (CPU, f32, a tiny Llama): a prefix-cache
  hit, then a concurrent wave in few blocks that preempts and evicts;
  the streams are equal too.
- The in-process graph over a ``MemoryHub``: two token-level workers
  (``TorchServingEngine`` behind ``KvEventPublisher`` and
  ``KvMetricsPublisher``), a processor (preprocess, ``KvRouter``,
  detokenize) and an HTTP frontend whose ``ModelWatcher`` discovers the
  processor's model. Greedy chat streams over HTTP equal the reference's
  ``HttpService`` over ``JaxServingEngine`` on the same weights; each
  group's followers are routed to the worker that served its leader,
  judged from the workers' stats scrape once the router's index holds the
  leader's blocks; after one worker's lease expires the next requests run
  on the survivor; no worker keeps a KV block.
- The CLI's five roles (dynstore, two token-level workers, a processor
  with ``--router-mode kv``, an ``out=none`` frontend) as subprocesses on
  the CPU answer a chat request.

Every test runs its own event loop under its own timeout; servers bind
port 0.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine.block_allocator import KvEventSink as JaxSink
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.http import service as ref_service
from dynamo_tpu.llm.backend import Backend as RefBackend
from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as RefPre
from dynamo_tpu.llm.tokenizer import HFTokenizer as RefTokenizer
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols import sse
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.pipeline import build_pipeline as ref_build_pipeline
from dynamo_tpu_torch.engine.block_allocator import KvEventSink
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.http import service as port_service
from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher, KvMetricsPublisher
from dynamo_tpu_torch.kv_router.router import KvRouter
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.processor import build_processor_pipeline
from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.client import Client, RouterMode
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.memory import MemoryHub
from fixtures import make_model_dir

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=256)
BS = 8


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(7),
                                   jnp.float32)
    return params, jax.device_get(params)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("graph"))


def _recording(cls, events):
    return cls(on_stored=lambda h, p: events.append(("stored", list(h), p)),
               on_removed=lambda h: events.append(("removed", list(h))))


# -------------------------------------------------- KV events of the engines

# 10 blocks of 8: the concurrent wave of four 20-token prompts decoding 14
# tokens needs 16 blocks at its peak, so it preempts and evicts
EVENTS_ENGINE = dict(max_batch_size=4, max_model_len=64, kv_block_size=BS,
                     num_kv_blocks=10, dtype="float32",
                     max_prefill_tokens_per_step=32)


def _event_waves():
    rng = np.random.default_rng(11)
    a = [1] + [int(t) for t in rng.integers(3, 500, 19)]
    hit = a[:16] + [int(t) for t in rng.integers(3, 500, 6)]
    wave = [[1] + [int(t) for t in rng.integers(3, 500, 19)] for _ in range(4)]
    return [[a], [hit], wave]


def test_engine_kv_events_match_the_reference(weights):
    waves = _event_waves()

    async def jax_run():
        events = []
        engine = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None),
            engine_config=JaxEngineConfig(model=JaxModelConfig(**TINY),
                                          **EVENTS_ENGINE),
            params=weights[0], events=_recording(JaxSink, events), warmup=False)

        async def one(p):
            req = JaxRequest(token_ids=p, stop_conditions=JaxStop(
                max_tokens=14, ignore_eos=True),
                sampling_options=JaxSampling(temperature=0.0))
            return [t async for o in engine.generate(JaxContext(req))
                    for t in o["token_ids"]]

        try:
            out = [await asyncio.gather(*(one(p) for p in w)) for w in waves]
            return out, events, engine.scheduler.allocator.used
        finally:
            await engine.close()

    async def torch_run():
        events = []
        cfg = EngineConfig(model=ModelConfig(**TINY), **EVENTS_ENGINE)
        engine = await TorchServingEngine.create(
            cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
            device="cpu", warmup=False, events=_recording(KvEventSink, events))

        async def one(p):
            req = PreprocessedRequest(token_ids=p, stop_conditions=StopConditions(
                max_tokens=14, ignore_eos=True),
                sampling_options=SamplingOptions(temperature=0.0))
            return [t async for o in engine.generate(Context(req))
                    for t in o["token_ids"]]

        try:
            out = [await asyncio.gather(*(one(p) for p in w)) for w in waves]
            return out, events, engine.metrics(), engine.scheduler.allocator.used
        finally:
            await engine.close()

    want, want_events, want_used = asyncio.run(asyncio.wait_for(jax_run(), 120))
    got, got_events, m, used = asyncio.run(asyncio.wait_for(torch_run(), 120))
    assert got == want
    assert got_events == want_events
    # the run shared a prefix, preempted and evicted
    assert m["prefix_hit_tokens"] > 0 and m["preemptions"] > 0
    assert any(e[0] == "removed" for e in got_events)
    assert all(isinstance(h, int) and h >= 0
               for e in got_events for h in e[1])
    assert used == want_used == 0


# ------------------------------------------------ the in-process graph

GRAPH_ENGINE = dict(max_batch_size=4, max_model_len=256, kv_block_size=BS,
                    num_kv_blocks=96, dtype="float32",
                    max_prefill_tokens_per_step=64)
SHARED = ("the quick brown fox jumps over the lazy dog while the cat sleeps "
          "under a warm sun and birds sing in the tall green trees by the "
          "river as the day slowly turns to night ")


def _chat(i, tail, max_tokens=8):
    return dict(model="tiny", max_tokens=max_tokens, temperature=0.0,
                stream=True, ignore_eos=True, messages=[{"role": "user",
                                        "content": f"{i} {SHARED}{tail}"}])


GROUPS = [[_chat(g, t) for t in ("alpha", "beta gamma", "delta", "epsilon zeta")]
          for g in ("one", "two")]


async def _post(session, port, body):
    async with session.post(f"http://127.0.0.1:{port}/v1/chat/completions",
                            json=body) as r:
        raw = await r.read()
        assert r.status == 200, raw
        chunks = list(sse.parse_stream(raw))
        text = "".join((c["choices"][0].get("delta") or {}).get("content") or ""
                       for c in chunks if c.get("choices"))
        finish = [c["choices"][0].get("finish_reason") for c in chunks
                  if c.get("choices")][-1]
        return text, finish


async def _reference_answers(model_dir, weights, bodies):
    mdc = RefCard.from_local_path(model_dir, "tiny")
    tok = RefTokenizer.from_pretrained_dir(model_dir)
    core = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=JaxEngineConfig(
            model=JaxModelConfig(**TINY), **GRAPH_ENGINE), params=weights[0],
        warmup=False)
    pipe = ref_build_pipeline([RefPre(mdc, tok), RefBackend(tok)], core)
    manager = ref_service.ModelManager()
    manager.add_chat_model("tiny", pipe)
    service = ref_service.HttpService(manager, host="127.0.0.1", port=0)
    await service.start()
    try:
        async with aiohttp.ClientSession() as s:
            return [await _post(s, service.port, b) for b in bodies]
    finally:
        await service.stop()
        await core.close()


async def _graph(model_dir, weights, hub):
    """Two token-level workers, a KV-routing processor and a discovering
    frontend on one hub. Returns the parts the test drives."""
    ns = "graph"
    workers = {}
    for i in range(2):
        drt = DistributedRuntime.in_process(hub)
        ep = drt.namespace(ns).component("backend").endpoint("generate")
        iid = f"w-{i}"
        pub = KvEventPublisher(ep.component, iid)
        pub.start()
        cfg = EngineConfig(model=ModelConfig(**TINY), **GRAPH_ENGINE)
        core = await TorchServingEngine.create(
            cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
            device="cpu", warmup=False, events=pub.as_sink())

        async def handler(payload, ctx, core=core):
            async for out in core.generate(Context(payload, ctx)):
                yield out

        serving = await ep.serve(handler, instance_id=iid, stats_handler=(
            KvMetricsPublisher(core.metrics).stats_handler))
        workers[iid] = dict(drt=drt, core=core, pub=pub, serving=serving)

    p_drt = DistributedRuntime.in_process(hub)
    w_ep = p_drt.namespace(ns).component("backend").endpoint("generate")
    client = Client(w_ep, RouterMode.ROUND_ROBIN)
    router = await KvRouter(w_ep.component, client, block_size=BS,
                            poll_interval=0.02).start()
    mdc = ModelDeploymentCard.from_local_path(model_dir, "tiny")
    engine = build_processor_pipeline(mdc, client, router,
                                      HFTokenizer.from_pretrained_dir(model_dir))
    p_ep = p_drt.namespace(ns).component("processor").endpoint("chat")

    async def p_handler(payload, ctx):
        from dynamo_tpu_torch.protocols.annotated import Annotated
        from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest

        req = ChatCompletionRequest.model_validate(payload)
        async for chunk in engine.generate(Context(req, ctx)):
            yield chunk.to_wire() if isinstance(chunk, Annotated) else (
                chunk if isinstance(chunk, dict) else chunk.model_dump(exclude_none=True))

    p_serving = await p_ep.serve(p_handler, stats_handler=router.stats)
    await port_service.register_model(p_drt, ns, "tiny", p_ep.path(),
                                      model_type="chat")

    f_drt = DistributedRuntime.in_process(hub)
    manager = port_service.ModelManager()
    watcher = port_service.ModelWatcher(f_drt, manager, ns)
    await watcher.start()
    service = port_service.HttpService(manager, host="127.0.0.1", port=0)
    await service.start()
    await client.wait_for_instances(2)
    return types.SimpleNamespace(workers=workers, router=router, client=client,
                                 engine=engine, p_serving=p_serving,
                                 p_drt=p_drt, f_drt=f_drt, watcher=watcher,
                                 service=service, manager=manager)


async def _settled(g):
    """Wait on observable state: every event a worker published is in the
    router's index, and both workers' load was scraped."""
    while True:
        pubs = [w["pub"] for w in g.workers.values() if not w.get("dead")]
        if (all(p._queue.empty() for p in pubs)
                and g.router.indexer.events_applied
                >= sum(w["pub"].published for w in g.workers.values())
                and len(g.router.scheduler.workers) == len(pubs)):
            return
        await asyncio.sleep(0.01)


async def _served_by(g):
    # generous: on a loaded CPU a worker's loop may be inside a step
    stats = await g.client.scrape_stats(timeout=10.0)
    return {iid: s["requests_total"] for iid, s in stats.items()}


def test_in_process_graph_routes_followers_to_their_leaders_worker(
        model_dir, weights):
    bodies = [b for grp in GROUPS for b in grp] + [_chat("three", "after kill")]

    async def main():
        want = await _reference_answers(model_dir, weights, bodies)
        hub = MemoryHub()
        g = await _graph(model_dir, weights, hub)
        got, routed = [], []
        try:
            assert g.manager.model_names() == ["tiny"]
            async with aiohttp.ClientSession() as s:
                for grp in GROUPS:
                    before = await _served_by(g)
                    got.append(await _post(s, g.service.port, grp[0]))
                    after = await _served_by(g)
                    leader = next(i for i in after if after[i] > before.get(i, 0))
                    await _settled(g)
                    for body in grp[1:]:
                        before = await _served_by(g)
                        got.append(await _post(s, g.service.port, body))
                        after = await _served_by(g)
                        routed.append((leader, next(
                            i for i in after if after[i] > before.get(i, 0))))
                        await _settled(g)
                # one worker dies (its lease expires): the next request runs
                # on the survivor, re-routed past the stale index
                victim = routed[-1][0]
                w = g.workers[victim]
                w["dead"] = True
                await w["serving"].stop()
                hub.expire_lease((await w["drt"].discovery.primary_lease()).id)
                while victim in g.client.instances:
                    await asyncio.sleep(0.01)
                got.append(await _post(s, g.service.port, bodies[-1]))
            survivor = next(i for i in g.workers if i != victim)
            hits = {i: w["core"].metrics()["prefix_hit_tokens"]
                    for i, w in g.workers.items()}
            used = {i: w["core"].scheduler.allocator.used
                    for i, w in g.workers.items()}
            last = await _served_by(g)
            return want, got, routed, hits, used, survivor, last, g.router.stats()
        finally:
            await g.service.stop()
            await g.watcher.stop()
            await g.p_serving.stop()
            await g.engine.close()
            for w in g.workers.values():
                if not w.get("dead"):
                    await w["serving"].stop()
                await w["core"].close()

    want, got, routed, hits, used, survivor, last, stats = asyncio.run(
        asyncio.wait_for(main(), 240))
    assert got == want
    assert all(f == "length" for _, f in got)
    assert all(leader == follower for leader, follower in routed), routed
    assert sum(hits.values()) > 0
    assert set(last) == {survivor} and last[survivor] >= 1
    assert used == {i: 0 for i in used}
    assert stats["decisions"] >= len(bodies) - 1
    assert stats["event_lag_ms"]["n"] > 0


# ------------------------------------------------------- the CLI's roles


def _tiny_dir(tmp_path):
    d = make_model_dir(tmp_path, config_overrides=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=512))
    extra = Path(d) / "f32.json"
    extra.write_text(json.dumps({"dtype": "float32"}))
    return d, str(extra)


def _spawn(args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-m", *args], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait_line(proc, needle, deadline):
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if needle in line:
            return line
        if not line and proc.poll() is not None:
            raise AssertionError(proc.stderr.read())
    raise AssertionError(f"no {needle!r} line in time")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_roles_serve_the_graph_on_the_cpu(tmp_path):
    """dynstore, two ``--token-level`` workers, an ``out=processor
    --router-mode kv`` processor and an ``in=http out=none`` frontend, each
    a subprocess: the frontend discovers the model and answers a chat
    request; every role exits 0 on SIGINT."""
    d, extra = _tiny_dir(tmp_path)
    store = _free_port()
    common = ["--model-path", d, "--model-name", "tiny", "--store-port",
              str(store), "--namespace", "cli"]
    engine = ["--device", "cpu", "--allow-random-weights", "--extra-engine-args",
              extra, "--max-model-len", "128", "--num-kv-blocks", "64",
              "--kv-block-size", "8"]
    procs = []
    deadline = time.monotonic() + 180
    try:
        procs.append(_spawn(["dynamo_tpu_torch.runtime.transports.dynstore",
                             "--host", "127.0.0.1", "--port", str(store)]))
        time.sleep(0.5)
        for _ in range(2):
            procs.append(_spawn(["dynamo_tpu_torch.cli.run",
                                 "in=dyn://cli.backend.generate", "out=torch",
                                 "--token-level", *common, *engine]))
        for p in procs[1:]:
            _wait_line(p, "token-level worker", deadline)
        procs.append(_spawn(["dynamo_tpu_torch.cli.run",
                             "in=dyn://cli.processor.chat", "out=processor",
                             "--worker-endpoint", "dyn://cli.backend.generate",
                             "--router-mode", "kv", "--kv-block-size", "8",
                             *common]))
        _wait_line(procs[-1], "processor serving", deadline)
        procs.append(_spawn(["dynamo_tpu_torch.cli.run", "in=http", "out=none",
                             "--store-port", str(store), "--namespace", "cli",
                             "--http-host", "127.0.0.1", "--http-port", "0"]))
        line = _wait_line(procs[-1], "listening on", deadline)
        port = int(line.strip().rsplit(":", 1)[1])

        async def ask():
            async with aiohttp.ClientSession() as s:
                for _ in range(200):  # the watcher's first snapshot
                    async with s.get(f"http://127.0.0.1:{port}/v1/models") as r:
                        if (await r.json())["data"]:
                            break
                    await asyncio.sleep(0.05)
                return await _post(s, port, _chat("cli", "x", 5))

        text, finish = asyncio.run(asyncio.wait_for(ask(), 120))
        assert finish == "length"
        for p in reversed(procs):
            p.send_signal(signal.SIGINT)
            assert p.wait(timeout=60) == 0, p.stderr.read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
