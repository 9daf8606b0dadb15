"""The port's HTTP front (``http/service.py`` on asyncio streams) and CLI.

One case against the reference: the port's ``HttpService`` over
``TorchServingEngine`` (CPU, f32, the tiny model through the weight
bridge) and the reference's over ``JaxServingEngine`` on the same weights
and model directory answer a streamed chat, a non-streamed completion,
``n = 2``, logprobs and a stop string with the same chunks, ids and times
aside (logprobs within 1e-4: f32 on both, summation orders differ). The
other cases hold the port to the reference's answers over echo engines: a
client that disconnects stops its request and frees its KV blocks; 400,
404 and 501 with the reference's status and error type; ``/metrics``
carries the reference's metric names. The CLI serves one request from a
subprocess with ``--device cpu`` and exits 0 on SIGINT; without
``--device`` and without a card it raises instead of falling back.
"""

import asyncio
import json
import os
import signal
import struct
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

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.http import service as ref_service
from dynamo_tpu.llm.backend import Backend as RefBackend
from dynamo_tpu.llm.engines.echo import EchoEngineCore as RefEchoCore
from dynamo_tpu.llm.engines.echo import EchoEngineFull as RefEchoFull
from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as RefPre
from dynamo_tpu.llm.tokenizer import HFTokenizer as RefTokenizer
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols import sse
from dynamo_tpu.runtime.pipeline import build_pipeline as ref_build_pipeline
from dynamo_tpu_torch.cli import run as port_run
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.http import service as port_service
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.engines.echo import EchoEngineCore, EchoEngineFull
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.runtime.pipeline import build_pipeline
from fixtures import make_model_dir

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=256)
BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32")
MSGS = [{"role": "user", "content": "the quick brown fox jumps over"}]


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("id", "created", "system_fingerprint")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _assert_close(got, want, path="$"):
    """Equal, floats within 1e-4."""
    if isinstance(want, float) and isinstance(got, float):
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (path, got, want)
    elif isinstance(want, dict) and isinstance(got, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list) and isinstance(got, list):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


async def _post(session, port, path, body, stream):
    async with session.post(f"http://127.0.0.1:{port}{path}", json=body) as r:
        raw = await r.read()
        if stream:
            assert r.headers["Content-Type"].startswith("text/event-stream")
            assert raw.decode().strip().endswith("data: [DONE]")
            chunks = list(sse.parse_stream(raw))
            # choices of a fan-out interleave in completion order
            key = (lambda c: (c.get("choices") or [{"index": 99}])[0]["index"])
            return r.status, sorted(chunks, key=key)
        return r.status, json.loads(raw)


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(5),
                                   jnp.float32)
    return params, jax.device_get(params)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("http"))


async def _ref_service(model_dir, weights):
    mdc = RefCard.from_local_path(model_dir, "tiny")
    tok = RefTokenizer.from_pretrained_dir(model_dir)
    core = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=JaxEngineConfig(
            model=JaxModelConfig(**TINY), **BASE), params=weights[0],
        warmup=False)
    pipe = ref_build_pipeline([RefPre(mdc, tok), RefBackend(tok)], core)
    manager = ref_service.ModelManager()
    manager.add_chat_model("tiny", pipe)
    manager.add_completion_model("tiny", pipe)
    service = ref_service.HttpService(manager, host="127.0.0.1", port=0)
    await service.start()
    return service, core


async def _port_service(model_dir, weights, core=None):
    mdc = ModelDeploymentCard.from_local_path(model_dir, "tiny")
    tok = HFTokenizer.from_pretrained_dir(model_dir)
    if core is None:
        cfg = EngineConfig(model=ModelConfig(**TINY), **BASE)
        core = await TorchServingEngine.create(
            cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
            device="cpu", warmup=False)
    pipe = build_pipeline([OpenAIPreprocessor(mdc, tok), Backend(tok)], core)
    manager = port_service.ModelManager()
    manager.add_chat_model("tiny", pipe)
    manager.add_completion_model("tiny", pipe)
    service = port_service.HttpService(manager, host="127.0.0.1", port=0)
    if hasattr(core, "metrics"):
        service.metrics.register_callback_gauges("dynamo_engine", core.metrics)
    await service.start()
    return service, core


CASES = {
    "streamed_chat": ("/v1/chat/completions",
                      dict(messages=MSGS, max_tokens=12, temperature=0.0,
                           stream=True), True),
    "completion": ("/v1/completions",
                   dict(prompt="hello world this is a test", max_tokens=10,
                        temperature=0.0), False),
    "n2": ("/v1/chat/completions",
           dict(messages=MSGS, max_tokens=8, temperature=0.0, n=2,
                stream=True, stream_options={"include_usage": True}), True),
    "logprobs": ("/v1/chat/completions",
                 dict(messages=MSGS, max_tokens=8, temperature=0.0,
                      logprobs=True, top_logprobs=3, frequency_penalty=0.5,
                      presence_penalty=0.3), False),
    "stop": ("/v1/completions",
             dict(prompt="the lazy dog", max_tokens=24, temperature=0.0,
                  stream=True), True),
}


@pytest.mark.asyncio
@pytest.mark.parametrize("case", sorted(CASES))
async def test_http_front_matches_the_reference_over_the_engines(
        model_dir, weights, case):
    path, body, stream = CASES[case]
    body = dict(body, model="tiny")
    ref, ref_core = await _ref_service(model_dir, weights)
    ours, our_core = await _port_service(model_dir, weights)
    try:
        async with aiohttp.ClientSession() as s:
            if case == "stop":
                # a stop string from inside the greedy text, so the jail
                # cuts the stream there
                _, first = await _post(s, ref.port, path, body, stream)
                text = "".join(c["choices"][0].get("text", "")
                               for c in first if c.get("choices"))
                assert len(text) > 6, text
                body = dict(body, stop=[text[3:6]])
            want_status, want = await _post(s, ref.port, path, body, stream)
            got_status, got = await _post(s, ours.port, path, body, stream)
        assert got_status == want_status == 200
        _assert_close(_strip(got), _strip(want))
        if case == "stop":
            finishes = [c["choices"][0].get("finish_reason") for c in got
                        if c.get("choices")]
            assert finishes[-1] == "stop"
        assert our_core.metrics()["kv_active_blocks"] == 0
    finally:
        await ours.stop()
        await ref.stop()
        await our_core.close()
        await ref_core.close()


@pytest.mark.asyncio
async def test_disconnect_stops_the_request_and_frees_its_blocks(
        model_dir, weights):
    """A streamed request whose client closes after two chunks stops: the
    engine reaps it (no KV block stays in use), /metrics counts it as a
    disconnect, and the server keeps serving."""
    service, core = await _port_service(model_dir, weights)
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", service.port)
        body = json.dumps(dict(model="tiny", messages=MSGS, max_tokens=110,
                               temperature=0.0, ignore_eos=True,
                               stream=True)).encode()
        writer.write(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        assert b"200 OK" in head and b"chunked" in head.lower()
        seen = b""
        while seen.count(b"data: ") < 2:
            seen += await reader.read(256)
        writer.close()
        for _ in range(200):
            m = core.metrics()
            if not m["kv_active_blocks"] and not m["request_active_slots"]:
                break
            await asyncio.sleep(0.05)
        assert core.metrics()["kv_active_blocks"] == 0
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{service.port}/metrics") as r:
                text = await r.text()
            status, out = await _post(s, service.port, "/v1/chat/completions",
                                      dict(model="tiny", messages=MSGS,
                                           max_tokens=3), False)
        assert 'requests_total{model="tiny",status="disconnect"} 1.0' in text
        assert status == 200 and out["usage"]["completion_tokens"] <= 3
    finally:
        await service.stop()
        await core.close()


ERROR_CASES = [
    ("/v1/chat/completions", b"not json"),
    ("/v1/chat/completions", {"model": "echo"}),
    ("/v1/chat/completions", {"model": "nope", "messages": MSGS}),
    ("/v1/chat/completions", {"model": "tiny", "messages": MSGS,
                              "use_beam_search": True}),
    ("/v1/completions", {"model": "tiny", "prompt": "x",
                         "length_penalty": 0.8}),
    ("/v1/chat/completions", {"model": "tiny", "stream": True, "messages": [
        {"role": "user", "content": "word " * 600}]}),
    ("/v1/completions", {"model": "tiny", "prompt": [[1], [2]]}),
    ("/v1/completions", {"model": "tiny", "prompt": "x", "best_of": 2,
                         "stream": True, "temperature": 1.0}),
    # "tiny" carries an embedder (as the reference's echo stack does),
    # "plain" none: 501
    ("/v1/embeddings", {"model": "plain", "input": "x"}),
    ("/v1/embeddings", {"model": "nope", "input": "x"}),
    ("/v1/embeddings", {"model": "tiny"}),
    ("/v1/embeddings", {"model": "tiny", "input": []}),
    ("/v1/embeddings", {"model": "tiny", "input": {"bad": 1}}),
    ("/v1/embeddings", {"model": "tiny", "input": "x",
                        "encoding_format": "hex"}),
    ("/v1/embeddings", b"[1"),
    ("/v1/chat/completions", {"model": "tiny", "messages": MSGS,
                              "response_format": {"type": "xml"}}),
]


@pytest.mark.asyncio
async def test_errors_answer_as_the_reference(model_dir, monkeypatch):
    """Status and error type of each bad request equal the reference's
    (messages may differ), over the echo core pipeline, whose "tiny" model
    carries each package's echo embedder and whose "plain" model none; an
    unknown route is a 404 and a wrong method a 405."""
    from dynamo_tpu.llm.embeddings import EchoEmbedder as RefEchoEmbedder
    from dynamo_tpu_torch.llm.embeddings import EchoEmbedder

    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "0")
    services = []
    for svc, card, tok, pre, back, build, echo, embedder in (
            (ref_service, RefCard, RefTokenizer, RefPre, RefBackend,
             ref_build_pipeline, RefEchoCore, RefEchoEmbedder),
            (port_service, ModelDeploymentCard, HFTokenizer, OpenAIPreprocessor,
             Backend, build_pipeline, EchoEngineCore, EchoEmbedder)):
        t = tok.from_pretrained_dir(model_dir)
        pipe = build([pre(card.from_local_path(model_dir, "tiny"), t), back(t)],
                     echo())
        pipe.embedder = embedder()
        plain = build([pre(card.from_local_path(model_dir, "tiny"), t), back(t)],
                      echo())
        manager = svc.ModelManager()
        manager.add_chat_model("tiny", pipe)
        manager.add_completion_model("tiny", pipe)
        manager.add_chat_model("plain", plain)
        service = svc.HttpService(manager, host="127.0.0.1", port=0)
        await service.start()
        services.append(service)
    try:
        async with aiohttp.ClientSession() as s:
            for path, body in ERROR_CASES:
                answers = []
                for service in services:
                    url = f"http://127.0.0.1:{service.port}{path}"
                    kw = {"data": body} if isinstance(body, bytes) else {"json": body}
                    async with s.post(url, **kw) as r:
                        payload = json.loads(await r.read())
                        assert "error" in payload, (path, body, r.status, payload)
                        answers.append((r.status, payload["error"]["type"],
                                        payload["error"].get("code")))
                assert answers[1] == answers[0], (path, body, answers)
                assert answers[0][0] in (400, 404, 501), answers
            port = services[1].port
            async with s.get(f"http://127.0.0.1:{port}/v1/nope") as r:
                assert r.status == 404
            async with s.get(f"http://127.0.0.1:{port}/v1/chat/completions") as r:
                assert r.status == 405
    finally:
        for service in services:
            await service.stop()


@pytest.mark.asyncio
async def test_metrics_models_and_health_carry_the_reference_names(monkeypatch):
    """After the same requests, both services expose the same
    ``dynamo_http_service_*`` metric names and request counts, and answer
    /v1/models and /health alike."""
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "0")
    texts, models, health = [], [], []
    for svc, full in ((ref_service, RefEchoFull), (port_service, EchoEngineFull)):
        manager = svc.ModelManager()
        manager.add_chat_model("echo", full())
        manager.set_metadata("echo", model_type="chat", max_model_len=64)
        service = svc.HttpService(manager, host="127.0.0.1", port=0)
        await service.start()
        try:
            async with aiohttp.ClientSession() as s:
                url = f"http://127.0.0.1:{service.port}"
                for stream in (False, True):
                    await _post(s, service.port, "/v1/chat/completions",
                                dict(model="echo", messages=MSGS, stream=stream),
                                stream)
                await _post(s, service.port, "/v1/chat/completions",
                            dict(model="nope", messages=MSGS), False)
                async with s.get(url + "/metrics") as r:
                    assert r.headers["Content-Type"].startswith("text/plain")
                    texts.append(await r.text())
                async with s.get(url + "/v1/models") as r:
                    models.append(_strip(await r.json()))
                async with s.get(url + "/health") as r:
                    health.append(await r.json())
        finally:
            await service.stop()

    def http_lines(text):
        return sorted(line.split(" ")[0] if "_bucket" in line or "_sum" in line
                      else line for line in text.splitlines()
                      if line.startswith("dynamo_http_service_")
                      and "_sum" not in line)
    assert http_lines(texts[1]) == http_lines(texts[0])
    assert 'dynamo_http_service_requests_total{model="echo",status="success"} 2.0' in texts[1]
    assert models[1] == models[0] and health[1] == health[0]


def _tiny_model_dir(tmp_path):
    d = make_model_dir(tmp_path, config_overrides=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=512))
    extra = Path(d) / "f32.json"
    extra.write_text(json.dumps({"dtype": "float32"}))
    return d, str(extra)


def _cli(args, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    return subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.run", *args],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, **kw)


def test_cli_serves_on_the_cpu_and_exits_0_on_sigint(tmp_path):
    d, extra = _tiny_model_dir(tmp_path)
    proc = _cli(["in=http", "out=torch", "--model-path", d, "--device", "cpu",
                 "--allow-random-weights", "--extra-engine-args", extra,
                 "--max-model-len", "128", "--num-kv-blocks", "64",
                 "--http-host", "127.0.0.1", "--http-port", "0",
                 "--decode-pipeline-depth", "2", "--kv-block-size", "8"])
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "listening on" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                raise AssertionError(proc.stderr.read())
        port = int(line.strip().rsplit(":", 1)[1])

        async def ask():
            async with aiohttp.ClientSession() as s:
                return await _post(s, port, "/v1/chat/completions", dict(
                    model="tiny-llama", messages=MSGS, max_tokens=5,
                    temperature=0.0, ignore_eos=True), False)
        status, body = asyncio.run(ask())
        assert status == 200 and body["usage"]["completion_tokens"] == 5
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_without_device_raises_on_a_machine_without_a_card(tmp_path):
    d, extra = _tiny_model_dir(tmp_path)
    proc = _cli(["in=http", "out=torch", "--model-path", d,
                 "--allow-random-weights", "--extra-engine-args", extra,
                 "--http-port", "0"])
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in err
    assert "listening on" not in out


@pytest.mark.parametrize("args,needle", [
    (["in=stdin", "out=torch"], "in=stdin"),
    (["in=http", "out=jax"], "out=jax"),
    (["in=http", "out=torch", "--kv-transfer", "ici"], "--kv-transfer"),
    (["in=http", "out=torch", "--isolate-engine"], "--isolate-engine"),
])
def test_cli_refuses_unported_inputs_outputs_and_flags_by_name(args, needle):
    proc = _cli(args)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0 and needle in err


def test_random_weights_need_the_flag_and_a_checkpoint_is_refused(tmp_path):
    from dynamo_tpu_torch.engine.serving import (
        check_random_weights,
        engine_config_from_mdc,
    )

    d, _ = _tiny_model_dir(tmp_path)
    mdc = ModelDeploymentCard.from_local_path(d)
    flags = types.SimpleNamespace(max_model_len=64, num_kv_blocks=32)
    cfg = engine_config_from_mdc(mdc, flags)
    assert (cfg.max_model_len, cfg.num_kv_blocks, cfg.model.hidden_size) == (
        64, 32, 64)
    with pytest.raises(FileNotFoundError, match="allow_random_weights"):
        check_random_weights(d, cfg)
    # a checkpoint is loaded now: an empty or truncated shard is refused
    # with a parse error that names the file, before a model is built
    shard = Path(d) / "model.safetensors"
    shard.write_bytes(b"")
    with pytest.raises(ValueError, match="model.safetensors"):
        check_random_weights(d, cfg)
    shard.write_bytes(struct.pack("<Q", 64) + b'{"w": {"dtype": "F32"')
    with pytest.raises(ValueError, match="model.safetensors"):
        check_random_weights(d, cfg)
    with pytest.raises(ValueError, match="matches no ModelConfig"):
        engine_config_from_mdc(mdc, flags, extra={"nope": 1})


# ------------------------------------------------------- the CLI's engine flags

MAPPED_FLAGS = {  # flag → the EngineConfig field it sets
    "--multi-step-decode": "multi_step_decode",
    "--device-finish": "device_finish",
    "--fused-epilogue": "fused_epilogue",
    "--guided-table-max-states": "guided_table_max_states",
    "--no-guided-device-table": "guided_device_table",
    "--no-device-stop-strings": "device_stop_strings",
    "--spec-ngram-tokens": "spec_ngram_tokens",
    "--spec-ngram-match": "spec_ngram_match",
    "--sequence-parallel-size": "sp_size",
}


@pytest.mark.parametrize("argv", [
    [],
    ["--multi-step-decode", "4", "--decode-pipeline-depth", "2",
     "--device-finish", "on", "--fused-epilogue", "off"],
    ["--fused-epilogue", "on", "--device-finish", "off"],
    # explicit zeros take the reference's fallbacks (`or 1`, `or 3`, ...)
    ["--multi-step-decode", "0", "--guided-table-max-states", "0",
     "--spec-ngram-tokens", "0", "--spec-ngram-match", "0",
     "--sequence-parallel-size", "0"],
    ["--no-guided-device-table", "--no-device-stop-strings",
     "--guided-table-max-states", "64"],
    ["--spec-ngram-tokens", "4", "--spec-ngram-match", "2"],
    ["--sequence-parallel-size", "4", "--long-prefill-threshold-tokens", "64"],
], ids=["defaults", "chain", "fused", "zeros", "guided", "spec", "sp"])
def test_cli_engine_flags_map_to_the_reference_fields(tmp_path, argv):
    from dynamo_tpu.cli import run as ref_run
    from dynamo_tpu.engine.serving import engine_config_from_mdc as ref_config
    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.engine.serving import engine_config_from_mdc

    d, _ = _tiny_model_dir(tmp_path)
    want = ref_config(RefCard.from_local_path(d), ref_run.build_parser().parse_args(
        argv + ["--max-model-len", "64"]))
    got = engine_config_from_mdc(ModelDeploymentCard.from_local_path(d),
                                 run.parse_flags(argv + ["--max-model-len", "64"]))
    for flag, field in MAPPED_FLAGS.items():
        assert flag not in run.REFUSED_FLAGS
        assert getattr(got, field) == getattr(want, field), (flag, field)
    assert got.decode_pipeline_depth == want.decode_pipeline_depth


@pytest.mark.parametrize("flag", sorted(port_run.REFUSED_FLAGS))
def test_cli_still_refuses_the_unported_flags_by_name(flag):
    with pytest.raises(SystemExit, match=flag):
        port_run.parse_flags([flag, "1"])
    # a refused flag is none of the mapped ones (the draft flags are mapped)
    assert flag not in MAPPED_FLAGS and flag not in DRAFT_FLAGS


DRAFT_FLAGS = {"--spec-draft-model": "spec_draft_model",
               "--spec-draft-tokens": "spec_draft_tokens"}


@pytest.mark.parametrize("tokens", [None, "2", "4", "16"])
@pytest.mark.parametrize("chain", [False, True], ids=["sync", "chain"])
def test_cli_draft_flags_map_to_the_reference_fields(tmp_path, tokens, chain):
    """``--spec-draft-model`` and ``--spec-draft-tokens`` set the
    reference's ``EngineConfig`` fields (a model without tokens is the
    reference's refusal, with its message), with and without the chained
    loop."""
    from dynamo_tpu.cli import run as ref_run
    from dynamo_tpu.engine.serving import engine_config_from_mdc as ref_config
    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.engine.serving import engine_config_from_mdc

    d, _ = _tiny_model_dir(tmp_path)
    argv = ["--max-model-len", "64", "--spec-draft-model", d]
    if tokens is not None:
        argv += ["--spec-draft-tokens", tokens]
    if chain:
        argv += ["--decode-pipeline-depth", "2"]
    ref_flags = ref_run.build_parser().parse_args(argv)
    port_flags = run.parse_flags(argv)
    if tokens is None:
        with pytest.raises(ValueError) as want:
            ref_config(RefCard.from_local_path(d), ref_flags)
        with pytest.raises(ValueError, match="spec_draft_tokens in 2..16") as got:
            engine_config_from_mdc(ModelDeploymentCard.from_local_path(d),
                                   port_flags)
        assert str(got.value) == str(want.value)
        return
    want = ref_config(RefCard.from_local_path(d), ref_flags)
    got = engine_config_from_mdc(ModelDeploymentCard.from_local_path(d),
                                 port_flags)
    for flag, field in DRAFT_FLAGS.items():
        assert flag not in run.REFUSED_FLAGS
        assert getattr(got, field) == getattr(want, field), (flag, field)
    assert got.spec_draft_model == d and got.spec_draft_tokens == int(tokens)
    assert got.decode_pipeline_depth == want.decode_pipeline_depth


# ---------- the telemetry routes and flags ----------

TELEMETRY_FLAGS = {  # flag → (value given, the parsed field)
    "--trace-capacity": ("16", "trace_capacity"),
    "--trace-ttl-s": ("30", "trace_ttl_s"),
    "--slo-ttft-ms": ("250", "slo_ttft_ms"),
    "--slo-itl-ms": ("40", "slo_itl_ms"),
    "--profile-dir": ("/tmp/prof", "profile_dir"),
    "--metrics-port": ("9400", "metrics_port"),
    "--hub": (None, "hub"),
    "--hub-interval-s": ("0.5", "hub_interval_s"),
    "--hub-target": ("decode=127.0.0.1:9400", "hub_target"),
    "--incident-dir": ("/tmp/inc", "incident_dir"),
    "--incident-cooldown-s": ("12", "incident_cooldown_s"),
    "--incident-profile-s": ("2", "incident_profile_s"),
}


@pytest.mark.parametrize("flag", sorted(TELEMETRY_FLAGS))
def test_cli_telemetry_flags_parse_as_the_reference(flag):
    """Each telemetry flag the port serves parses to the reference's field
    and value, default and given."""
    from dynamo_tpu.cli import run as ref_run

    value, field = TELEMETRY_FLAGS[flag]
    argv = [flag] + ([value] if value is not None else [])
    assert flag not in port_run.REFUSED_FLAGS
    for args in ([], argv):
        got = port_run.parse_flags(args)
        want = ref_run.build_parser().parse_args(args)
        assert getattr(got, field) == getattr(want, field), (flag, args)


def test_cli_refuses_the_profiler_port_with_its_reason():
    with pytest.raises(SystemExit) as e:
        port_run.parse_flags(["--profiler-port", "9012"])
    msg = str(e.value)
    assert "--profiler-port" in msg and "torch has no counterpart" in msg
    assert "--profile-dir" in msg


async def _telemetry_answers(svc_mod, full, **svc_kw):
    """The same echo requests (two with an X-Request-Id) through one
    service; the debug routes' answers."""
    manager = svc_mod.ModelManager()
    manager.add_chat_model("echo", full())
    service = svc_mod.HttpService(manager, host="127.0.0.1", port=0, **svc_kw)
    await service.start()
    out = {}
    try:
        async with aiohttp.ClientSession() as s:
            url = f"http://127.0.0.1:{service.port}"
            for i, stream in enumerate((False, True, True)):
                headers = {"X-Request-Id": f"rid-{i}"} if i < 2 else {}
                async with s.post(url + "/v1/chat/completions", headers=headers,
                                  json=dict(model="echo", messages=MSGS,
                                            stream=stream)) as r:
                    await r.read()
            for name, path in (("request", "/debug/requests/rid-1"),
                               ("recent", "/debug/requests?limit=2"),
                               ("trace", "/debug/trace/rid-0"),
                               ("unknown", "/debug/trace/nope"),
                               ("bad_limit", "/debug/requests?limit=x"),
                               ("flight", "/debug/flight?request=rid-0"),
                               ("fleet", "/fleet/metrics"),
                               ("incidents", "/debug/incidents")):
                async with s.get(url + path) as r:
                    out[name] = (r.status, await r.json())
            async with s.get(url + "/metrics") as r:
                out["metrics"] = await r.text()
    finally:
        await service.stop()
    return out


@pytest.fixture(scope="module")
def telemetry_answers():
    os.environ["DYN_TOKEN_ECHO_DELAY_MS"] = "0"
    try:
        return [asyncio.run(_telemetry_answers(
                    mod, full, slo=slo_mod.SloTracker(ttft_s=5.0, itl_s=5.0)))
                for mod, full, slo_mod in (
                    (ref_service, RefEchoFull, __import__(
                        "dynamo_tpu.telemetry.slo", fromlist=["x"])),
                    (port_service, EchoEngineFull, __import__(
                        "dynamo_tpu_torch.telemetry.slo", fromlist=["x"])))]
    finally:
        os.environ.pop("DYN_TOKEN_ECHO_DELAY_MS", None)


def _shape(name, status, body):
    """What must agree across the services for one route's answer."""
    if name == "request":
        return status, sorted(body), [s["name"] for s in body["spans"]]
    if name == "recent":  # the third request's id is a fresh uuid
        ids = [t["request_id"] for t in body["traces"]]
        return status, ids[:1], len(ids)
    if name == "trace":
        return (status, sorted(body), body["sources"],
                [(r["source"], r["name"]) for r in body["timeline"]])
    if name == "flight":
        return (status, sorted(body), body["filtered_to_request"],
                body["events"])
    return status, body


@pytest.mark.parametrize("name", ["request", "recent", "trace", "unknown",
                                  "bad_limit", "flight", "fleet", "incidents"])
def test_debug_routes_answer_as_the_reference(telemetry_answers, name):
    ref, port = telemetry_answers
    assert _shape(name, *port[name]) == _shape(name, *ref[name])


def test_slo_counters_sum_to_the_finished_requests(telemetry_answers):
    def slo_lines(text):
        return sorted(line for line in text.splitlines()
                      if line.startswith(("dynamo_slo_", "dynamo_trace_store")))

    ref, port = telemetry_answers
    assert slo_lines(port["metrics"]) == slo_lines(ref["metrics"])
    assert ('dynamo_slo_attainment_total{met="true",slo="request"} 3.0'
            in port["metrics"])


@pytest.mark.asyncio
async def test_debug_profile_is_served_only_with_a_profile_dir(tmp_path):
    plain = port_service.HttpService(port_service.ModelManager(),
                                     host="127.0.0.1", port=0)
    prof = port_service.HttpService(port_service.ModelManager(),
                                    host="127.0.0.1", port=0,
                                    profile_dir=str(tmp_path))
    await plain.start()
    await prof.start()
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{plain.port}/debug/profile") as r:
                off = r.status
            async with s.get(f"http://127.0.0.1:{prof.port}/debug/profile"
                             "?seconds=abc") as r:
                bad = r.status
            async with s.get(f"http://127.0.0.1:{prof.port}/debug/profile"
                             "?seconds=0.1") as r:
                ok = (r.status, await r.json())
    finally:
        await plain.stop()
        await prof.stop()
    assert off == 404 and bad == 400
    status, body = ok
    assert status == 200 and body["seconds"] == 0.1
    assert body["trace_dir"].startswith(str(tmp_path))
    assert body["summary"]["cuda"] is False
