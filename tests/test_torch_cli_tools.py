"""The CLI's other inputs and tools in the port, each against the reference:
``in=batch:`` (``cli/batch.py``) over the echo engines and, through an
isolated ``@torch`` child, over a tiny checkpoint against the reference's
JAX engine; ``in=stdin``; ``llmctl http add|list|remove`` (the same key
and record as the reference's, read back by the port's front);
``llmctl deploy`` refused by name; the namespace aggregator
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


def test_llmctl_deploy_is_refused_by_name():
    with pytest.raises(SystemExit, match="deploy") as ei:
        _run(port_llmctl.amain(["deploy", "list", "--api-store", "http://x:1"]))
    assert "ApiStoreClient" in str(ei.value)


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
