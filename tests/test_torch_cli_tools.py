"""The CLI's other inputs and tools in the port, each against the reference:
``in=batch:`` (``cli/batch.py``) over the echo engines and, through an
isolated ``@torch`` child, over a tiny checkpoint against the reference's
JAX engine; ``in=stdin``; ``llmctl http add|list|remove`` (the same key
and record as the reference's, read back by the port's front);
``llmctl deploy`` against the port's api-store (an artifact that asks
for ``tpu`` refused by name); the namespace aggregator
(``cli/metrics.py``: the same exposition for the same stats and events);
``models/hub.resolve_model_path``; the ``dynamo_transfer_*`` family (the
reference's names, help text and labels); and the CLI's wiring of an
isolated core where the reference meets one (the respawn-only recovery
ladder, no KV fabric, no migration receiver).
"""

import argparse
import asyncio
import builtins
import io
import json
import os
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from dynamo_tpu.cli import batch as ref_batch
from dynamo_tpu.cli import llmctl as ref_llmctl
from dynamo_tpu.cli import metrics as ref_metrics
from dynamo_tpu.cli import run as ref_run
from dynamo_tpu.llm.engines.echo import EchoEngineFull as RefEchoFull
from dynamo_tpu.models import hub as ref_hub
from dynamo_tpu.runtime.component import DistributedRuntime as RefDrt
from dynamo_tpu.telemetry.registry import MetricsRegistry as RefRegistry
from dynamo_tpu.transfer.plane import TransferMetrics as RefTransferMetrics
from dynamo_tpu_torch.cli import batch as port_batch
from dynamo_tpu_torch.cli import llmctl as port_llmctl
from dynamo_tpu_torch.cli import metrics as port_metrics
from dynamo_tpu_torch.cli import run as port_run
from dynamo_tpu_torch.http.service import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.engines.echo import EchoEngineFull
from dynamo_tpu_torch.llm.engines.subprocess_host import TORCH_ENGINE, SubprocessEngine
from dynamo_tpu_torch.models import hub as port_hub
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.transports.dynstore import DynStoreServer
from dynamo_tpu_torch.runtime.wire import packb
from dynamo_tpu_torch.telemetry.registry import MetricsRegistry
from dynamo_tpu_torch.transfer.plane import TransferMetrics

REPO = Path(__file__).resolve().parent.parent
TIMING = ("ttft_s", "itl_mean_s", "itl_p99_s", "total_s")


def _run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _records(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(autouse=True)
def _keep_root_logging():
    """``cli.run.amain`` installs the process logging config (its root
    handler and level); a test that calls it in-process gives the worker's
    root logger back as it found it."""
    import logging

    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    root.handlers[:] = handlers
    root.setLevel(level)


# ------------------------------------------------------------------ in=batch:


def test_batch_over_the_echo_engines_matches_the_reference(tmp_path, capsys):
    path = tmp_path / "b.jsonl"
    path.write_text("\n".join(json.dumps(e) for e in (
        {"text": "hello there world"}, {"text": ""},
        {"messages": [{"role": "user", "content": "one two"}]},
        {"text": "a b c d e", "max_tokens": 3})) + "\n\n")
    flags = types.SimpleNamespace(model_name=None)
    out = {}
    for name, mod, eng in (("port", port_batch, EchoEngineFull()),
                           ("ref", ref_batch, RefEchoFull())):
        _run(mod.run_batch(flags, eng, None, str(path)))
        cap = capsys.readouterr()
        out[name] = (_records(cap.out), cap.err)
    (port, port_err), (ref, ref_err) = out["port"], out["ref"]
    assert len(port) == len(ref) == 4
    for p, r in zip(port, ref):
        assert set(r) <= set(p)
        assert {k: v for k, v in p.items() if k in r and k not in TIMING} == \
            {k: v for k, v in r.items() if k not in TIMING}
        # an echo engine reports no usage: the emissions count
        assert p["completion_tokens"] == len(p["output"].split())
    assert "batch summary:" in port_err and "batch summary:" in ref_err
    summary = json.loads(port_err.split("batch summary: ", 1)[1])
    ref_summary = json.loads(ref_err.split("batch summary: ", 1)[1])
    assert set(ref_summary) <= set(summary) and summary["requests"] == 4
    assert summary["completion_tokens"] == sum(p["completion_tokens"] for p in port)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    import torch
    from transformers import LlamaConfig, LlamaForCausalLM

    from fixtures import make_model_dir

    d = make_model_dir(tmp_path_factory.mktemp("cli_tools"), name="tiny-hf")
    cfg = LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      tie_word_embeddings=False)
    torch.manual_seed(1)
    LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    with open(os.path.join(d, "config.json")) as f:
        c = json.load(f)
    c["eos_token_id"], c["bos_token_id"] = 2, 1
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(c, f)
    with open(os.path.join(d, "f32.json"), "w") as f:
        json.dump({"dtype": "float32"}, f)
    return str(d)


BATCH = [
    {"messages": [{"role": "user", "content": "hello there world"}],
     "max_tokens": 6, "temperature": 0.0},
    {"messages": [{"role": "user", "content": "a b c"}], "max_tokens": 4,
     "temperature": 0.0},
    {"messages": [{"role": "system", "content": "be brief"},
                  {"role": "user", "content": "x y"}], "max_tokens": 5,
     "temperature": 0.0},
]
ENGINE_ARGS = ["--kv-block-size", "8", "--max-batch-size", "2",
               "--max-model-len", "96", "--num-kv-blocks", "48"]


def test_batch_through_an_isolated_torch_child_matches_the_jax_engine(
        model_dir, tmp_path):
    """The CLI, ``in=batch: out=torch --isolate-engine --device cpu``: one
    record a request with the reference's fields and greedy output, and
    token counts equal to the usage the reference's pipeline reports for
    the same requests; the summary on stderr; the child gone after."""
    path = tmp_path / "b.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in BATCH))
    extra = os.path.join(model_dir, "f32.json")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               HF_HUB_OFFLINE="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.run", f"in=batch:{path}",
         "out=torch", "--isolate-engine", "--device", "cpu", "--model-path",
         model_dir, "--model-name", "tiny", "--extra-engine-args", extra,
         *ENGINE_ARGS], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    async def reference():
        flags = ref_run.build_parser().parse_args(
            ["--model-path", model_dir, "--model-name", "tiny",
             "--extra-engine-args", extra, *ENGINE_ARGS])
        engine, mdc = await ref_run.build_engine("jax", flags)
        try:
            buf = io.StringIO()
            with redirect_stdout(buf):
                await ref_batch.run_batch(flags, engine, mdc, str(path))
            usage = []
            from dynamo_tpu.protocols.openai import ChatCompletionRequest
            from dynamo_tpu.runtime.engine import Context as RefContext

            for e in BATCH:
                req = ChatCompletionRequest.model_validate({"model": "tiny", **e})
                u = None
                async for chunk in engine.generate(RefContext(req)):
                    d = chunk if isinstance(chunk, dict) else chunk.model_dump(
                        exclude_none=True)
                    u = d.get("usage") or u
                usage.append(u)
            return _records(buf.getvalue()), usage
        finally:
            await engine.close()

    try:
        ref, usage = _run(reference(), timeout=300)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    got = _records(out)
    assert len(got) == len(ref) == len(BATCH)
    for g, r, u, e in zip(got, ref, usage, BATCH):
        assert set(r) <= set(g) and g["index"] == r["index"]
        assert g["output"] == r["output"] and g["ttft_s"] > 0
        assert (g["prompt_tokens"], g["completion_tokens"]) == (
            u["prompt_tokens"], u["completion_tokens"])
        assert g["completion_tokens"] <= e["max_tokens"]
    assert "batch summary:" in err
    # the parent's log names its child; the child is gone once it exited
    pids = [int(line.split("(pid ", 1)[1].split(")", 1)[0])
            for line in err.splitlines() if "engine subprocess for @torch up" in line]
    assert len(pids) == 1
    with pytest.raises(ProcessLookupError):
        os.kill(pids[0], 0)


def test_stdin_input_prints_what_the_reference_prints(monkeypatch):
    lines = iter(["hello there", "", "second line here"])

    def fake_input(prompt=""):
        try:
            return next(lines)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr(builtins, "input", fake_input)
    buf = io.StringIO()
    with redirect_stdout(buf):
        _run(port_run.amain(["in=stdin", "out=echo_full"]))
    port = buf.getvalue()
    lines = iter(["hello there", "", "second line here"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        _run(ref_run.run_text(argparse.Namespace(model_name=None),
                              RefEchoFull(), None))
    assert port == buf.getvalue() == "hello there \nsecond line here \n"


# -------------------------------------------------------------------- llmctl


def test_llmctl_writes_the_reference_record_and_the_front_lists_it(capsys):
    async def main():
        server = DynStoreServer(port=0)
        await server.start()
        try:
            common = ["--store-port", str(server.port), "--namespace", "ns1"]
            add = common + ["http", "add", "chat-models", "m8b",
                            "dyn://ns1.backend.generate"]
            drt = await DistributedRuntime.connect(port=server.port)
            manager = ModelManager()
            watcher = ModelWatcher(drt, manager, "ns1")
            await watcher.start()
            assert await port_llmctl.amain(add) == 0
            port_kv = await drt.discovery.kv_get_prefix("ns1/")
            for _ in range(100):
                if "m8b" in manager.model_names():
                    break
                await asyncio.sleep(0.05)
            listed = "m8b" in manager.model_names()
            assert await port_llmctl.amain(common + ["http", "list"]) == 0
            assert await port_llmctl.amain(
                common + ["http", "remove", "chat-models", "m8b"]) == 0
            after_rm = await drt.discovery.kv_get_prefix("ns1/")
            assert await ref_llmctl.amain(add) == 0
            ref_kv = await drt.discovery.kv_get_prefix("ns1/")
            assert await port_llmctl.amain(
                common + ["http", "add", "chat-models", "m8b", "nodots"]) == 2
            await watcher.stop()
            await drt.close()
            return port_kv, listed, after_rm, ref_kv
        finally:
            await server.stop()

    port_kv, listed, after_rm, ref_kv = _run(main())
    assert port_kv == ref_kv and len(port_kv) == 1
    assert list(port_kv) == ["ns1/models/chat/m8b"]
    assert listed and after_rm == {}
    out = capsys.readouterr().out
    assert "added chat model m8b -> dyn://ns1.backend.generate" in out
    assert "dyn://ns1.backend.generate" in out.split("added")[1]


def test_llmctl_deploy_is_refused_by_name(tmp_path):
    """``llmctl deploy --from-artifact`` is served since the SDK slice; what
    stays refused by name is an artifact whose manifest asks for ``tpu``
    (the reference's resource; the port serves NVIDIA cards), on create and
    update alike, before any store is dialled."""
    import tarfile

    from dynamo_tpu_torch.sdk.build import SCHEMA

    manifest = {"schema": SCHEMA, "name": "g", "version": "0" * 12,
                "graph_target": "graphs:Frontend", "config": {},
                "services": {"Worker": {
                    "class": "Worker", "role": "worker", "namespace": "public",
                    "workers": 1, "resources": {"tpu": 1}, "endpoints": [],
                    "links": []}}}
    data = json.dumps(manifest).encode()
    tgz = tmp_path / "g.dyn.tar.gz"
    with tarfile.open(tgz, "w:gz") as tar:
        info = tarfile.TarInfo("manifest.json")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    for action in ("create", "update"):
        with pytest.raises(SystemExit, match="deploy --from-artifact") as ei:
            _run(port_llmctl.amain(["deploy", action, "g", "--from-artifact",
                                    str(tgz), "--api-store", "http://x:1"]))
        assert "'tpu'" in str(ei.value) and "'gpu'" in str(ei.value)


# ------------------------------------------------------------ the aggregator


class _Sub:
    def __init__(self, payloads):
        self.payloads = payloads

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        for p in self.payloads:
            yield types.SimpleNamespace(payload=p)


def test_aggregator_renders_the_reference_exposition():
    from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics

    fpm = ForwardPassMetrics(request_active_slots=3, request_total_slots=8,
                             kv_active_blocks=40, kv_total_blocks=128,
                             num_requests_waiting=2, gpu_cache_usage_perc=0.3125,
                             gpu_prefix_cache_hit_rate=0.5).to_wire()
    stats = {"w-1": {"inflight": 2, "requests_total": 7, "data": fpm},
             "w-2": {"inflight": 0, "requests_total": 1}}
    events = [packb({"worker_id": "w-1", "isl_blocks": 4, "overlap_blocks": 3}),
              packb({"worker_id": "w-2", "isl_blocks": 2, "overlap_blocks": 0}),
              packb({"worker_id": "w-1", "isl_blocks": 9, "overlap_blocks": 5})]

    async def main():
        server = DynStoreServer(port=0)
        await server.start()
        try:
            texts = []
            for mod, drt_cls in ((port_metrics, DistributedRuntime),
                                 (ref_metrics, RefDrt)):
                drt = await drt_cls.connect(port=server.port)
                agg = mod.MetricsAggregator(drt, "dyn://ns.backend.generate")

                async def scrape(timeout=0.5):
                    return stats

                agg.client.scrape_stats = scrape
                assert await agg.collect_once() == 2
                await agg._consume_hit_events(_Sub(events))
                texts.append(agg.render())
                await drt.close()
            # the port's /metrics route serves the same text
            drt = await DistributedRuntime.connect(port=server.port)
            agg = port_metrics.MetricsAggregator(drt, "dyn://ns.backend.generate")
            agg.client.scrape_stats = scrape
            await agg.collect_once()
            for p in events:
                agg.on_hit_event(p)
            srv = await port_metrics.metrics_server(agg, "127.0.0.1", 0).start()
            from dynamo_tpu_torch.http.server import http_get

            body = await http_get(f"http://127.0.0.1:{srv.port}/metrics", 10.0)
            await srv.stop()
            await drt.close()
            return texts, body
        finally:
            await server.stop()

    (port, ref), body = _run(main())
    assert port == ref
    assert 'dynamo_kv_hit_overlap_blocks_total{worker="w-1"} 8.0' in port
    assert 'dynamo_worker_kv_active_blocks{instance="w-1"} 40.0' in port
    assert body.decode() == port


# ----------------------------------------------------------------------- hub


def test_resolve_model_path_local_paths_and_the_refusal(tmp_path, monkeypatch):
    d = tmp_path / "snap"
    d.mkdir()
    gguf = tmp_path / "m.gguf"
    gguf.write_bytes(b"GGUF")
    for mod in (port_hub, ref_hub):
        assert mod.resolve_model_path(str(d)) == str(d)
        assert mod.resolve_model_path(str(gguf)) == str(gguf)
    # no huggingface_hub (the card's machine has none): a clear refusal
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    errs = []
    for mod in (port_hub, ref_hub):
        with pytest.raises(FileNotFoundError) as ei:
            mod.resolve_model_path("org/not-a-local-dir")
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and "huggingface_hub is unavailable" in errs[0]
    # the CLI resolves through it where the reference does (load_mdc)
    flags = port_run.parse_flags(["--model-path", "org/not-a-local-dir"])
    with pytest.raises(FileNotFoundError, match="huggingface_hub"):
        port_run.load_mdc(flags)


# ------------------------------------------------------- the transfer family


def test_transfer_family_names_help_and_labels_match_the_reference():
    regs = (MetricsRegistry(), RefRegistry())
    for reg, cls in zip(regs, (TransferMetrics, RefTransferMetrics)):
        m = cls(reg, plane="disagg")
        m.channel_opened("tcp")
        m.add_bytes(4096, "tcp")
        m.add_bytes(512, "local", plane="fabric")
        m.observe_duration(0.25, "tcp")
        m.observe_exposed(0.0, "tcp")
        m.channel_opened("tcp", plane="migration")
        m.channel_closed("tcp")
    port, ref = (r.render() for r in regs)
    assert port == ref
    assert 'dynamo_transfer_bytes_total{backend="tcp",plane="disagg"} 4096.0' in port


# ------------------------------------------- the CLI around an isolated core


@pytest.mark.asyncio
async def test_cli_wires_an_isolated_core_as_the_reference_does():
    """An isolated engine gets the respawn-only ladder (its deaths drive
    it) and no migration receiver or KV fabric, in both packages; its
    workers' launch counts come from the child's pongs."""
    from dynamo_tpu.llm.engines.subprocess_host import SubprocessEngine as RefHost

    pflags = port_run.parse_flags(["--self-heal", "--isolate-engine"])
    rflags = ref_run.build_parser().parse_args(["--self-heal", "--isolate-engine"])
    for mod, flags, core in ((port_run, pflags, SubprocessEngine(TORCH_ENGINE)),
                             (ref_run, rflags, RefHost("@jax"))):
        controller, server = await mod._setup_self_healing(flags, core)
        assert server is None and controller.scheduler is None
        assert controller.respawner == core.respawn
        assert core._down_listeners == [controller.on_child_down]
        assert await mod._setup_kv_fabric(flags, core) is None
        await controller.close()
    core = SubprocessEngine(TORCH_ENGINE)
    core._last_metrics = {"launches_paged_decode": 32, "launches_epilogue": 2,
                          "requests_total": 1}
    assert port_run._launches_of("torch", core)() == {"paged_decode": 32,
                                                      "epilogue": 2}
    # the four supervision flags parse to the reference's defaults
    for attr in ("isolate_engine", "engine_heartbeat_s", "engine_heartbeat_misses",
                 "engine_init_timeout_s"):
        assert getattr(pflags, attr) == getattr(rflags, attr)


# ------------------------------------------- the planner and deploy slice

PLANNER_FLAGS = {  # flag → a value (None: a switch), the parsed field
    "--planner": (None, "planner"),
    "--planner-interval-s": ("0.5", "planner_interval_s"),
    "--planner-min-replicas": ("2", "planner_min_replicas"),
    "--planner-max-replicas": ("3", "planner_max_replicas"),
    "--planner-cooldown-s": ("1", "planner_cooldown_s"),
    "--planner-deployment": ("graph", "planner_deployment"),
    "--api-store-url": ("http://127.0.0.1:8790", "api_store_url"),
}


@pytest.mark.parametrize("flag", sorted(PLANNER_FLAGS))
def test_cli_planner_flags_parse_as_the_reference(flag):
    """The seven flags the port refused until the planner and deploy slice:
    each parses to the reference parser's value, given and by default."""
    value, field = PLANNER_FLAGS[flag]
    assert flag not in port_run.REFUSED_FLAGS
    for argv in ([], [flag] if value is None else [flag, value]):
        got = port_run.parse_flags(argv)
        want = ref_run.build_parser().parse_args(argv)
        assert getattr(got, field) == getattr(want, field), (flag, argv)
    # the policy the flags build: the reference's (down waits 4x up)
    argv = ["--planner-min-replicas", "2", "--planner-max-replicas", "5",
            "--planner-cooldown-s", "3"]
    cfg = port_run._planner_policy(port_run.parse_flags(argv)).config
    assert (cfg.min_replicas, cfg.max_replicas, cfg.scale_up_cooldown_s,
            cfg.scale_down_cooldown_s) == (2, 5, 3.0, 12.0)


@pytest.mark.parametrize("src,argv", [
    ("planner", []),
    ("planner", ["--store-port", "1"]),
    ("hub", []),
], ids=["planner_store", "planner_workers", "hub_targets"])
def test_cli_planner_and_hub_refuse_with_the_reference_words(src, argv):
    runner = {"planner": "run_planner", "hub": "run_hub"}[src]
    with pytest.raises(SystemExit) as want:
        _run(getattr(ref_run, runner)(ref_run.build_parser().parse_args(argv)))
    with pytest.raises(SystemExit) as got:
        _run(port_run.amain([f"in={src}", "out=none", *argv]))
    assert str(got.value) == str(want.value)
    assert src in port_run.INPUTS or src == "planner"


def _spec_file(tmp_path, spec, name="spec.json"):
    path = tmp_path / name
    path.write_text(json.dumps(spec))
    return str(path)


def test_llmctl_deploy_round_trip_against_the_port_api_store(tmp_path, capsys):
    """create, list, get, update, delete through the port's llmctl against
    the port's api-store, and the reference's llmctl against it too: the
    same output, line for line."""
    from dynamo_tpu_torch.deploy.api_store import ApiStoreService, DeploymentStore

    spec = {"modelName": "llama", "services": {
        "decode": {"role": "decode", "gpus": 1},
        "planner": {"role": "planner"}}}
    f1 = _spec_file(tmp_path, spec)
    f2 = _spec_file(tmp_path, dict(spec, modelName="llama2"), "spec2.json")

    async def session(mod, name):
        svc = ApiStoreService(DeploymentStore(":memory:"), "127.0.0.1", 0)
        await svc.start()
        loop = asyncio.get_running_loop()
        store = ["--api-store", f"http://127.0.0.1:{svc.port}"]
        rcs = []
        try:
            for argv in (["create", name, "-f", f1], ["list"], ["get", name],
                         ["update", name, "-f", f2], ["delete", name],
                         ["get", name], ["list"]):
                args = mod.build_parser().parse_args(["deploy", *argv, *store])
                rcs.append(await loop.run_in_executor(None, mod.run_deploy, args))
        finally:
            await svc.stop()
        return rcs

    port_rcs = _run(session(port_llmctl, "graph"))
    port_out = capsys.readouterr().out
    ref_rcs = _run(session(ref_llmctl, "graph"))
    ref_out = capsys.readouterr().out

    def scrub(text):  # the records' timestamps differ between the runs
        return [line for line in text.splitlines()
                if '"created"' not in line and '"updated"' not in line]

    assert port_rcs == ref_rcs == [0, 0, 0, 0, 0, 1, 0]
    assert scrub(port_out) == scrub(ref_out)
    assert "created deployment graph" in port_out
    assert "reconciled=-      services=2" in port_out
    assert "(no deployments)" in port_out


def test_llmctl_deploy_yaml_spec_needs_the_package(tmp_path, monkeypatch):
    path = tmp_path / "spec.yaml"
    path.write_text("services:\n  decode:\n    role: decode\n    gpus: 1\n")
    want = {"services": {"decode": {"role": "decode", "gpus": 1}}}
    assert port_llmctl._load_spec(str(path)) == want
    assert port_llmctl._load_spec(_spec_file(tmp_path, want)) == want
    monkeypatch.setitem(sys.modules, "yaml", None)  # as on the card's machine
    with pytest.raises(SystemExit, match="yaml package is not installed"):
        port_llmctl._load_spec(str(path))
    assert port_llmctl._load_spec(_spec_file(tmp_path, want)) == want


def test_service_metrics_attach_registry_as_the_reference():
    from dynamo_tpu.http.metrics import ServiceMetrics as RefMetrics
    from dynamo_tpu_torch.http.metrics import ServiceMetrics

    out = []
    for metrics_cls, reg_cls in ((ServiceMetrics, MetricsRegistry),
                                 (RefMetrics, RefRegistry)):
        m = metrics_cls()
        child = reg_cls()
        child.counter("dynamo_planner_cycles_total", "cycles").inc(3)
        child.gauge("dynamo_planner_replica_target_replicas", "t").set(2, role="decode")
        m.attach_registry(child)
        text = m.render()
        out.append(sorted(line for line in text.splitlines()
                          if line.startswith("dynamo_planner_")))
    assert out[0] == out[1] == [
        "dynamo_planner_cycles_total 3.0",
        'dynamo_planner_replica_target_replicas{role="decode"} 2']


@pytest.mark.asyncio
async def test_in_hub_lists_a_static_target_as_the_reference():
    """``in=hub`` as a user starts it: its /fleet/workers row for a static
    --hub-target has the reference hub's keys and values for the same
    target; SIGINT exits 0."""
    import signal

    from dynamo_tpu.telemetry.hub import FleetHub as RefHub
    from dynamo_tpu.telemetry.hub import parse_target_flag as ref_target
    from dynamo_tpu_torch.http.server import HttpError, http_get
    from dynamo_tpu_torch.telemetry.server import MetricsServer

    reg = MetricsRegistry()
    reg.gauge("dynamo_kv_block_usage_ratio", "usage").set(0.25)
    target = await MetricsServer(reg, "127.0.0.1", 0).start()
    spec = f"decode=http://127.0.0.1:{target.port}"
    loop = asyncio.get_running_loop()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.run", "in=hub", "out=none",
         "--hub-target", spec, "--hub-interval-s", "0.2",
         "--http-host", "127.0.0.1", "--http-port", "0"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    try:
        line = await loop.run_in_executor(None, proc.stdout.readline)
        assert line.startswith("fleet hub on http://127.0.0.1:"), proc.stderr.read()
        port = int(line.split()[3].rsplit(":", 1)[1])
        for _ in range(100):
            rows = json.loads(await http_get(
                f"http://127.0.0.1:{port}/fleet/workers", 5.0))["workers"]
            if rows and rows[0]["up"]:
                break
            await asyncio.sleep(0.1)
        with pytest.raises(HttpError) as off:  # no incident dir: the hint
            await http_get(f"http://127.0.0.1:{port}/debug/incidents", 5.0)
        text = (await http_get(f"http://127.0.0.1:{port}/metrics", 5.0)).decode()
        ref_hub = RefHub(targets=[ref_target(spec)], interval_s=0.2)
        await ref_hub.scrape_once()
        want = ref_hub.fleet_workers()["workers"]
        proc.send_signal(signal.SIGINT)
        rc = await loop.run_in_executor(None, proc.wait, 30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        await target.stop()
    assert rc == 0
    assert len(rows) == len(want) == 1 and rows[0]["up"]
    assert sorted(rows[0]) == sorted(want[0])
    for key in ("name", "role", "up", "kv_usage_ratio"):
        assert rows[0][key] == want[0][key], key
    assert rows[0]["kv_usage_ratio"] == 0.25
    assert off.value.status == 501 and b"--incident-dir" in off.value.body
    assert "dynamo_hub_" in text


@pytest.mark.asyncio
async def test_in_planner_patches_the_record_from_the_workers_load():
    """``in=planner`` over a worker whose stats report 8 waiting requests
    and a port api-store record: the decode replicas go 1 → 2 (and never
    past --planner-max-replicas), the prefill queue's depth never reads a
    fabricated 0, and SIGINT-free cancellation closes the role."""
    from dynamo_tpu_torch.deploy.api_store import ApiStoreService, DeploymentStore
    from dynamo_tpu_torch.deploy.store_source import ApiStoreClient
    from dynamo_tpu_torch.kv_router.publisher import KvMetricsPublisher

    server = DynStoreServer(port=0)
    await server.start()
    svc = ApiStoreService(DeploymentStore(":memory:"), "127.0.0.1", 0)
    await svc.start()
    loop = asyncio.get_running_loop()
    url = f"http://127.0.0.1:{svc.port}"
    client = ApiStoreClient(url)
    await loop.run_in_executor(None, client.create, "graph", {"services": {
        "decode": {"role": "decode", "replicas": 1, "gpus": 1}}})
    drt = await DistributedRuntime.connect(port=server.port)
    load = {"request_active_slots": 8, "request_total_slots": 8,
            "num_requests_waiting": 8, "kv_active_blocks": 10,
            "kv_total_blocks": 100}

    async def no_requests(payload, ctx):
        raise RuntimeError("stats only")
        yield

    ep = drt.namespace("graph").component("backend").endpoint("generate")
    serving = await ep.serve(no_requests,
                             stats_handler=KvMetricsPublisher(lambda: load).stats_handler)
    flags = port_run.parse_flags([
        "--worker-endpoint", "dyn://graph.backend.generate",
        "--store-port", str(server.port), "--namespace", "graph",
        "--api-store-url", url, "--planner-deployment", "graph",
        "--planner-interval-s", "0.1", "--planner-cooldown-s", "0.3",
        "--planner-max-replicas", "3"])
    task = asyncio.ensure_future(port_run.run_planner(flags))
    seen = []
    try:
        for _ in range(200):
            rec = await loop.run_in_executor(None, client.get, "graph")
            n = rec["spec"]["services"]["decode"]["replicas"]
            if not seen or seen[-1] != n:
                seen.append(n)
            if n == 3:
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.5)  # at the maximum: no further patch
        rec = await loop.run_in_executor(None, client.get, "graph")
    finally:
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        await serving.stop()
        await drt.close()
        await svc.stop()
        await server.stop()
    assert seen[:3] == [1, 2, 3]
    assert rec["spec"]["services"]["decode"] == {"role": "decode",
                                                 "replicas": 3, "gpus": 1}


def test_front_planner_sheds_low_when_the_slo_misses():
    """``in=http out=echo_full --planner`` with an SLO every request misses:
    attainment under its floor raises the shed level through the front's
    LocalActuator; a low-class request is then shed with 429 and
    Retry-After while a high one is served, and the planner's instruments
    are on the front's /metrics (``attach_registry``)."""
    import http.client
    import signal

    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.run", "in=http",
         "out=echo_full", "--http-host", "127.0.0.1", "--http-port", "0",
         "--planner", "--planner-interval-s", "0.1", "--admission-limit", "4",
         "--slo-ttft-ms", "0.001"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))

    def ask(port, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        out = r.status, r.getheader("Retry-After"), r.read().decode()
        conn.close()
        return out

    chat = {"model": "echo", "messages": [{"role": "user", "content": "a b c"}]}
    try:
        line = proc.stdout.readline()
        assert line.startswith("listening on"), proc.stderr.read()
        port = int(line.strip().rsplit(":", 1)[1])
        for _ in range(3):
            assert ask(port, "POST", "/v1/chat/completions", chat)[0] == 200
        import time
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            text = ask(port, "GET", "/metrics")[2]
            if "dynamo_planner_shed_level_depth 1" in text:
                break
            time.sleep(0.05)
        low = ask(port, "POST", "/v1/chat/completions", chat, {"X-Priority": "low"})
        high = ask(port, "POST", "/v1/chat/completions", chat, {"X-Priority": "high"})
        text = ask(port, "GET", "/metrics")[2]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "dynamo_planner_shed_level_depth 1" in text
    assert 'dynamo_planner_actions_total{applied="true",kind="admission"}' in text
    assert low[0] == 429 and low[1]
    assert high[0] == 200


@pytest.mark.asyncio
async def test_front_pools_write_a_cold_pool_into_the_record():
    """--api-store-url with --planner-deployment on a front: the pool
    manager's spawner writes ``pool-<slug>`` replicas 1 into the record
    (and its drainer 0), as the reference's front does, and the port's
    operator renders that pool's Deployment from the record."""
    from dynamo_tpu.registry.cards import ModelCard as RefCard
    from dynamo_tpu_torch.deploy.api_store import ApiStoreService, DeploymentStore
    from dynamo_tpu_torch.deploy.operator import render_manifests
    from dynamo_tpu_torch.deploy.store_source import ApiStoreClient, record_to_cr
    from dynamo_tpu_torch.registry.cards import ModelCard

    class Watcher:
        def pool_size(self, name):
            return 0

    records = {}
    for name, mod, card_cls in (("port", port_run, ModelCard),
                                ("ref", ref_run, RefCard)):
        svc = ApiStoreService(DeploymentStore(":memory:"), "127.0.0.1", 0)
        await svc.start()
        loop = asyncio.get_running_loop()
        url = f"http://127.0.0.1:{svc.port}"
        try:
            client = ApiStoreClient(url)
            await loop.run_in_executor(None, client.create, "graph",
                                       {"services": {}})
            argv = ["--api-store-url", url, "--planner-deployment", "graph"]
            flags = (port_run.parse_flags(argv) if name == "port"
                     else ref_run.build_parser().parse_args(argv))
            manager = (ModelManager() if name == "port"
                       else __import__("dynamo_tpu.http.service", fromlist=["x"])
                       .ModelManager())
            pools = mod._build_pools(flags, manager, Watcher())
            assert pools is not None and pools.spawner is not None
            card = card_cls(name="Cold Llama", endpoint="dyn://graph.cold.chat",
                            model_path="/models/cold")
            await pools.spawner(card)
            up = await loop.run_in_executor(None, client.get, "graph")
            await pools.drainer("Cold Llama")
            down = await loop.run_in_executor(None, client.get, "graph")
            records[name] = (up["spec"], down["spec"])
        finally:
            await svc.stop()
    assert records["port"] == records["ref"]
    up, down = records["port"]
    (svc_name,) = up["services"]
    assert svc_name.startswith("pool-") and up["services"][svc_name]["replicas"] == 1
    assert down["services"][svc_name]["replicas"] == 0
    names = [m["metadata"]["name"] for m in render_manifests(
        record_to_cr({"name": "graph", "spec": up}))]
    assert f"graph-{svc_name}" in names


# ------------------------------------------------------------------ logging


def _json_log_line(proc, needle, timeout=60):
    """The first stderr line of ``proc`` that holds ``needle``, parsed as
    one JSON object (a plain-text line fails the parse)."""
    import threading

    found = []

    def read():
        for line in proc.stderr:
            if needle in line:
                found.append(line)
                return

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout)
    assert found, f"no line with {needle!r} on stderr"
    return json.loads(found[0])


@pytest.mark.parametrize("role", ["dynstore", "cli_run"])
def test_entry_points_log_jsonl_under_the_operator_env(role):
    """``DYN_LOGGING_JSONL=1`` (the operator writes it into every pod it
    renders) makes the port's dynstore and ``cli.run`` log one JSON object
    a line with the reference formatter's keys; the dynstore's line is the
    reference dynstore's up to the package name and the port, and
    ``DYN_LOG=warn`` keeps its INFO line out."""
    import signal

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", DYN_LOGGING_JSONL="1")

    def spawn(module, *argv, env=env):
        return subprocess.Popen(
            [sys.executable, "-m", module, *argv], cwd=str(REPO), env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def stop(proc):
        proc.send_signal(signal.SIGINT)
        try:
            return proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    store = spawn("dynamo_tpu_torch.runtime.transports.dynstore",
                  "--host", "127.0.0.1", "--port", "0")
    try:
        line = _json_log_line(store, "dynstore listening on")
        port = int(line["message"].rsplit(":", 1)[1])
        if role == "dynstore":
            ref = spawn("dynamo_tpu.runtime.transports.dynstore",
                        "--host", "127.0.0.1", "--port", "0",
                        env=dict(env, JAX_PLATFORMS="cpu"))
            try:
                want = _json_log_line(ref, "dynstore listening on")
            finally:
                stop(ref)
            quiet = spawn("dynamo_tpu_torch.runtime.transports.dynstore",
                          "--host", "127.0.0.1", "--port", "0",
                          env=dict(env, DYN_LOG="warn"))
            import time
            time.sleep(2.0)
            assert stop(quiet) == 0
            assert "dynstore listening" not in quiet.stderr.read()
            assert sorted(line) == sorted(want) == [
                "level", "message", "target", "time"]
            assert line["level"] == want["level"] == "INFO"
            assert line["target"] == want["target"].replace(
                "dynamo_tpu.", "dynamo_tpu_torch.", 1)
            assert (line["message"].rsplit(":", 1)[0]
                    == want["message"].rsplit(":", 1)[0])
        else:
            cli = spawn("dynamo_tpu_torch.cli.run", "in=planner", "out=none",
                        "--store-port", str(port), "--worker-endpoint",
                        "dyn://logs.backend.generate")
            try:
                line = _json_log_line(cli, "in=planner without --api-store-url")
            finally:
                assert stop(cli) == 0
            assert sorted(line) == ["level", "message", "target", "time"]
            # run as ``-m``, the CLI's own logger is ``__main__``
            assert (line["level"], line["target"]) == ("WARNING", "__main__")
    finally:
        assert stop(store) == 0
