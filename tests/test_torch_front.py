"""The port's OpenAI front (protocols, preprocessor, backend, SSE) against
the reference's, and the engine's ``n > 1`` fan-out.

The same requests go through both packages' stages on the fixture model
directory (``make_model_dir``): ``PromptFormatter`` output,
``OpenAIPreprocessor``'s ``PreprocessedRequest.to_wire()``, the
``Backend``'s deltas (stop-string jail included) over the same token
streams, the chat and completion chunks (logprobs blocks, tool calls, the
``n`` fan-out, annotations) and SSE frames are equal. Request validation
accepts, coerces and rejects as the reference's pydantic models do. The
engine-level fan-out of ``TorchServingEngine`` streams what
``JaxServingEngine._generate_fanout`` streams (greedy, f32, the tiny model
through the weight bridge), and its seeds are offset by choice.
"""

import asyncio
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.llm import backend as ref_backend
from dynamo_tpu.llm import preprocessor as ref_pre
from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
from dynamo_tpu.llm.tokenizer import HFTokenizer as RefTokenizer
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols import openai as ref_openai
from dynamo_tpu.protocols import sse as ref_sse
from dynamo_tpu.protocols.annotated import Annotated as RefAnnotated
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import AsyncEngine as RefAsyncEngine
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.engine import EngineError as RefEngineError
from dynamo_tpu.runtime.pipeline import build_pipeline as ref_build_pipeline
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.llm import backend as port_backend
from dynamo_tpu_torch.llm import preprocessor as port_pre
from dynamo_tpu_torch.llm.engines.echo import EchoEngineCore, EchoEngineFull
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as PortCard
from dynamo_tpu_torch.llm.tokenizer import HFTokenizer as PortTokenizer
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols import openai as port_openai
from dynamo_tpu_torch.protocols import sse as port_sse
from dynamo_tpu_torch.protocols.annotated import Annotated as PortAnnotated
from dynamo_tpu_torch.protocols.common import (
    EngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import AsyncEngine as PortAsyncEngine
from dynamo_tpu_torch.runtime.engine import Context, EngineError
from dynamo_tpu_torch.runtime.pipeline import build_pipeline
from fixtures import make_model_dir

MSGS = [{"role": "system", "content": "be brief"},
        {"role": "user", "content": "the quick brown fox?"}]
CHAT_REQUESTS = [
    dict(messages=MSGS),
    dict(messages=MSGS, max_tokens=7, temperature=0.7, top_p=0.9, top_k=5,
         min_p=0.1, seed=3, stop=["fox", "dog"], frequency_penalty=0.5,
         presence_penalty=0.3, repetition_penalty=1.1, logprobs=True,
         top_logprobs=3, logit_bias={"5": 200, "7": -3}, min_tokens=2,
         ignore_eos=True, n=2),
    dict(messages=[{"role": "user", "content": [
        {"type": "text", "text": "hello "}, {"type": "text", "text": "world"}]}],
         max_completion_tokens=0, stop="x", nvext={
             "annotations": ["formatted_prompt", "token_ids"],
             "greed_sampling": True}),
    dict(messages=MSGS, guided_choice=["paris", "the fox"]),
    dict(messages=MSGS, nvext={"use_raw_prompt": True, "ignore_eos": True}),
    dict(messages=MSGS, tools=[{"type": "function", "function": {"name": "f"}}],
         tool_choice={"type": "function", "function": {"name": "f"}}),
]
COMPLETION_REQUESTS = [
    dict(prompt="hello world this is"),
    dict(prompt=[5, 6, 7, 8], max_tokens=3, logprobs=2, echo=True),
    dict(prompt="a b c", best_of=3, n=1, temperature=0.8, max_tokens=4),
    dict(prompt="x y", stop=["y"], n=3, seed=11, stream=True),
]
BAD_REQUESTS = [  # chat requests both packages answer with a 400
    dict(),
    dict(messages="x"),
    dict(messages=[{"content": "x"}]),
    dict(messages=[{"role": 1}]),
    dict(messages=MSGS, use_beam_search=True),
    dict(messages=MSGS, length_penalty=0.8),
    dict(messages=MSGS, response_format={"type": "xml"}),
    dict(messages=MSGS, response_format={"type": "json_schema"}),
    dict(messages=MSGS, max_tokens=5.5),
    dict(messages=MSGS, stream="maybe"),
    dict(messages=MSGS, stream=2),
    dict(messages=MSGS, stop=5),
    dict(messages=MSGS, stop=["a", 1]),
    dict(messages=MSGS, logprobs=3),
    dict(messages=MSGS, tool_choice=5),
    dict(messages=MSGS, logit_bias=[1]),
    dict(messages=MSGS, temperature="hot"),
]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("front"))


@pytest.fixture(scope="module")
def stages(model_dir):
    """(reference preprocessor, port preprocessor, ref tok, port tok)."""
    rtok = RefTokenizer.from_pretrained_dir(model_dir)
    ptok = PortTokenizer.from_pretrained_dir(model_dir)
    rpre = ref_pre.OpenAIPreprocessor(
        RefCard.from_local_path(model_dir, "tiny"), rtok)
    ppre = port_pre.OpenAIPreprocessor(
        PortCard.from_local_path(model_dir, "tiny"), ptok)
    return rpre, ppre, rtok, ptok


def _req(mod, kind, body):
    cls = (mod.ChatCompletionRequest if kind == "chat"
           else mod.CompletionRequest)
    return cls.model_validate(dict(model="tiny", **body))


def _strip_ids(obj):
    """A chunk dict without its request id and creation time."""
    if isinstance(obj, dict):
        return {k: _strip_ids(v) for k, v in obj.items()
                if k not in ("id", "created", "system_fingerprint")}
    if isinstance(obj, list):
        return [_strip_ids(v) for v in obj]
    return obj


# ------------------------------------------------------------- protocols

@pytest.mark.parametrize("body", CHAT_REQUESTS + [
    dict(messages=MSGS, use_beam_search=False, length_penalty=1.0,
         stream_options={"include_usage": "yes"}, max_tokens="5",
         temperature=1, stream=1, seed=True, extra_field={"a": [1, None]}),
])
def test_requests_validate_and_dump_as_the_reference(body):
    a = _req(ref_openai, "chat", body)
    b = _req(port_openai, "chat", body)
    assert b.model_dump(exclude_none=True) == a.model_dump(exclude_none=True)
    assert b.model_dump() == a.model_dump()
    assert b.model_extra == a.model_extra


@pytest.mark.parametrize("body", COMPLETION_REQUESTS + [
    dict(prompt=[[1, 2], [3]]), dict(prompt=["a", "b"]), dict(prompt=[])])
def test_completion_requests_validate_as_the_reference(body):
    a = _req(ref_openai, "completion", body)
    b = _req(port_openai, "completion", body)
    assert b.model_dump(exclude_none=True) == a.model_dump(exclude_none=True)


@pytest.mark.parametrize("i", range(len(BAD_REQUESTS)))
def test_rejections_match_the_reference(i):
    body = dict(model="m", **BAD_REQUESTS[i])
    with pytest.raises(ValueError):
        ref_openai.ChatCompletionRequest.model_validate(body)
    with pytest.raises(ValueError):
        port_openai.ChatCompletionRequest.model_validate(body)


@pytest.mark.parametrize("prompt", [5, [1, "a"], [[1], "a"], None])
def test_completion_prompt_rejections_match(prompt):
    with pytest.raises(ValueError):
        ref_openai.CompletionRequest.model_validate({"model": "m", "prompt": prompt})
    with pytest.raises(ValueError):
        port_openai.CompletionRequest.model_validate({"model": "m", "prompt": prompt})


def test_sse_frames_and_annotations_match():
    chunk = {"id": "x", "choices": [{"index": 0, "delta": {"content": "é ✓\n"}}]}
    for args in ((chunk,), ("[DONE]",), (None, "token_ids", "[1, 2]"),
                 ({"error": {"message": "m"}},)):
        assert port_sse.encode_event(*args) == ref_sse.encode_event(*args)
    assert port_sse.encode_done() == ref_sse.encode_done()
    model_chunk = dict(id="c", model="m", created=1, choices=[
        dict(delta=dict(content="hi"), finish_reason="stop")])
    assert port_sse.encode_event(port_openai.ChatCompletionChunk.model_validate(
        model_chunk)) == ref_sse.encode_event(
        ref_openai.ChatCompletionChunk.model_validate(model_chunk))
    raw = port_sse.encode_event(chunk) + port_sse.encode_done()
    assert list(port_sse.parse_stream(raw)) == list(ref_sse.parse_stream(raw))
    ann_a = RefAnnotated.from_annotation("token_ids", [1, 2])
    ann_b = PortAnnotated.from_annotation("token_ids", [1, 2])
    assert ann_b.to_wire() == ann_a.to_wire()
    assert PortAnnotated.maybe_from_wire(ann_a.to_wire()) == ann_b


# ----------------------------------------------------------- preprocessor

def test_prompt_formatter_matches_the_reference(model_dir):
    tmpl = ("{% for m in messages %}{{ m.role }}={{ m.content | tojson }};"
            "{% endfor %}{% if tools %}{{ tools | tojson }}{% endif %}"
            "{% if add_generation_prompt %}>{% endif %}{{ bos_token }}")
    for template in (None, tmpl, PortCard.from_local_path(model_dir).chat_template):
        a = ref_pre.PromptFormatter(template, "<s>", "</s>")
        b = port_pre.PromptFormatter(template, "<s>", "</s>")
        for gen in (True, False):
            kw = dict(add_generation_prompt=gen, tools=[{"name": "f<&>"}])
            assert b.render(MSGS, **kw) == a.render(MSGS, **kw)
    bad = "{{ raise_exception('no system role') }}"
    with pytest.raises(RefEngineError, match="no system role"):
        ref_pre.PromptFormatter(bad).render(MSGS)
    with pytest.raises(EngineError, match="no system role"):
        port_pre.PromptFormatter(bad).render(MSGS)


@pytest.mark.parametrize("kind,body", [("chat", b) for b in CHAT_REQUESTS]
                         + [("completion", b) for b in COMPLETION_REQUESTS])
def test_preprocessed_requests_match_the_reference(stages, kind, body):
    rpre, ppre, _, _ = stages
    fn = "preprocess_chat" if kind == "chat" else "preprocess_completion"
    a = getattr(rpre, fn)(_req(ref_openai, kind, body))
    b = getattr(ppre, fn)(_req(port_openai, kind, body))
    assert b.to_wire() == a.to_wire()
    assert b.annotation_values == a.annotation_values


@pytest.mark.parametrize("kind,body", [
    ("chat", dict(messages=[{"role": "user", "content": "word " * 300}])),
    ("chat", dict(messages=MSGS, guided_choice=[])),
    ("chat", dict(messages=MSGS, tool_choice="required")),
    ("chat", dict(messages=MSGS, tool_choice={"type": "function",
                                              "function": {"name": "g"}})),
    ("completion", dict(prompt="x", best_of=2, n=3)),
    ("completion", dict(prompt="x", best_of=2, stream=True)),
    ("completion", dict(prompt=["a", "b"])),
])
def test_preprocessor_refusals_match_the_reference(stages, kind, body):
    rpre, ppre, _, _ = stages
    fn = "preprocess_chat" if kind == "chat" else "preprocess_completion"
    with pytest.raises(RefEngineError):
        getattr(rpre, fn)(_req(ref_openai, kind, body))
    with pytest.raises(EngineError):
        getattr(ppre, fn)(_req(port_openai, kind, body))


def test_guided_json_is_refused_by_name(stages):
    _, ppre, _, _ = stages
    for body in (dict(response_format={"type": "json_object"}),
                 dict(guided_json={"type": "object"})):
        with pytest.raises(EngineError, match="guided JSON"):
            ppre.preprocess_chat(_req(port_openai, "chat",
                                      dict(messages=MSGS, **body)))


# ---------------------------------------------------------------- backend

class _Scripted:
    """A token-level engine that streams given EngineOutputs (a dict per
    delta), for both packages' stages."""

    def __init__(self, base, outs):
        self.base, self.outs = base, outs

    def engine(self):
        outs = self.outs

        class E(self.base):
            async def generate(self, request):
                for o in outs:
                    yield dict(o)
        return E()


def _token_script(tok, text, extra=()):
    ids = tok.encode(text) + list(extra)
    return [dict(token_ids=[t]) for t in ids] + [
        dict(token_ids=[], finish_reason="length")]


@pytest.mark.parametrize("stop,hidden,text", [
    (["fox"], None, "the quick brown fox jumps"),
    (["row", "qu"], None, "the quick brown fox"),
    (["zzz"], None, "the quick brown fox émojis ✓ 中文"),
    (None, [4], "hello world"),
    (["ld th"], None, "hello world this is"),
])
def test_backend_deltas_match_the_reference(stages, stop, hidden, text):
    """The detokenizer's deltas, the stop-string jail (a string across
    tokens, one that never completes, multi-byte text) and hidden stop ids
    give the same BackendOutputs in both packages."""
    _, _, rtok, ptok = stages
    script = _token_script(rtok, text, extra=[4, 9])
    results = []
    for mod, tok, base, ctx, req_cls, st_cls in (
            (ref_backend, rtok, RefAsyncEngine, JaxContext, JaxRequest, JaxStop),
            (port_backend, ptok, PortAsyncEngine, Context, PreprocessedRequest,
             StopConditions)):
        req = req_cls(token_ids=[1], eos_token_ids=[2], stop_conditions=st_cls(
            max_tokens=40, stop=stop, stop_token_ids_hidden=hidden))
        pipe = (ref_build_pipeline if mod is ref_backend else build_pipeline)(
            [mod.Backend(tok)], _Scripted(base, script).engine())

        async def run():
            return [dataclasses.asdict(o) for o in [
                o async for o in pipe.generate(ctx(req))]]
        results.append(asyncio.run(run()))
    for out in results[0] + results[1]:
        out["finish_reason"] = out["finish_reason"] and str(
            getattr(out["finish_reason"], "value", out["finish_reason"]))
    assert results[1] == results[0]


def test_decoder_held_suffix_matches_the_reference(stages):
    _, _, rtok, ptok = stages
    for stops in (["abc", "bcd"], ["a", "aaab"], ["</s>"]):
        a = ref_backend.Decoder(rtok, stops)
        b = port_backend.Decoder(ptok, stops)
        for text in ("xxab", "xab", "aaa", "aaab", "</", "zz<", ""):
            assert b._longest_held_suffix(text) == a._longest_held_suffix(text)


# ------------------------------------------------------- whole front (echo)

async def _front_chunks(pre_mod, backend_mod, build, echo, tok, card, ctx_cls,
                        openai_mod, kind, body):
    pipe = build([pre_mod.OpenAIPreprocessor(card, tok),
                  backend_mod.Backend(tok)], echo)
    req = _req(openai_mod, kind, body)
    out = []
    async for c in pipe.generate(ctx_cls(req)):
        out.append(c.to_wire() if hasattr(c, "to_wire") else
                   c.model_dump(exclude_none=True))
    return out


@pytest.mark.parametrize("kind,body", [
    ("chat", dict(messages=MSGS, stream=True)),
    ("chat", dict(messages=MSGS, logprobs=True, top_logprobs=2,
                  stream_options={"include_usage": True}, stream=True)),
    ("chat", dict(messages=MSGS, stop=["brown"], n=2, stream=True)),
    ("chat", dict(messages=MSGS, nvext={"annotations": ["token_ids"]},
                  max_tokens=4)),
    ("chat", dict(messages=[{"role": "user", "content":
                             '<tool_call>{"name": "f", "arguments": {"x": 1}}'
                             '</tool_call>'}],
                  tools=[{"type": "function", "function": {"name": "f"}}],
                  nvext={"use_raw_prompt": True})),
    ("completion", dict(prompt="hello world this is a test", max_tokens=5,
                        logprobs=1)),
    ("completion", dict(prompt="hello world", echo=True, n=2)),
])
def test_front_chunks_match_the_reference_over_the_echo_engine(
        stages, model_dir, monkeypatch, kind, body):
    """The whole front (preprocessor, backend, echo core engine) streams
    the same chunks in both packages, ids and times aside; the echo
    engine's logprobs are none, so the logprob blocks are empty on both."""
    from dynamo_tpu.llm.engines.echo import EchoEngineCore as RefEcho

    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "0")
    rpre, ppre, rtok, ptok = stages
    a = asyncio.run(_front_chunks(
        ref_pre, ref_backend, ref_build_pipeline, RefEcho(), rtok, rpre.mdc,
        JaxContext, ref_openai, kind, body))
    b = asyncio.run(_front_chunks(
        port_pre, port_backend, build_pipeline, EchoEngineCore(), ptok,
        ppre.mdc, Context, port_openai, kind, body))
    key = (lambda c: (c.get("choices") or [{}])[0].get("index", -1))
    if body.get("n", 1) > 1:  # choices interleave in completion order
        a, b = sorted(a, key=key), sorted(b, key=key)
    assert _strip_ids(b) == _strip_ids(a)
    aggregate = ("aggregate_chat_stream" if kind == "chat"
                 else "aggregate_completion_stream")
    chunk = "ChatCompletionChunk" if kind == "chat" else "CompletionResponse"
    agg_a = getattr(ref_openai, aggregate)([
        getattr(ref_openai, chunk).model_validate(c) for c in a
        if "__annotated__" not in c])
    agg_b = getattr(port_openai, aggregate)([
        getattr(port_openai, chunk).model_validate(c) for c in b
        if "__annotated__" not in c])
    assert _strip_ids(agg_b.model_dump(exclude_none=True)) == _strip_ids(
        agg_a.model_dump(exclude_none=True))


def test_echo_full_streams_as_the_reference(monkeypatch):
    from dynamo_tpu.llm.engines.echo import EchoEngineFull as RefFull

    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "0")
    body = dict(model="echo", messages=[{"role": "user", "content": "a b c"}])

    async def run(engine, ctx_cls):
        return [c async for c in engine.generate(ctx_cls(body))]
    assert _strip_ids(asyncio.run(run(EchoEngineFull(), Context))) == _strip_ids(
        asyncio.run(run(RefFull(), JaxContext)))


# ------------------------------------------------------------ n > 1 fan-out

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=256)
BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32")


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(3),
                                   jnp.float32)
    return params, jax.device_get(params)


async def _by_choice(engine, ctx, req):
    got = {}
    async for out in engine.generate(ctx(req)):
        got.setdefault(out.get("choice"), []).extend(out["token_ids"])
    return got


@pytest.mark.asyncio
async def test_engine_fanout_matches_jax_engine(weights):
    """n = 3 greedy over one prompt: each choice's stream equals the
    reference engine's ``_generate_fanout``, and every delta carries its
    choice."""
    prompt = [int(t) for t in np.random.default_rng(8).integers(3, 512, 21)]
    jcfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **BASE)
    jeng = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=jcfg,
        params=weights[0], warmup=False)
    try:
        want = await _by_choice(jeng, JaxContext, JaxRequest(
            token_ids=prompt, stop_conditions=JaxStop(max_tokens=6, ignore_eos=True),
            sampling_options=JaxSampling(temperature=0.0, n=3)))
    finally:
        await jeng.close()
    cfg = EngineConfig(model=ModelConfig(**TINY), **BASE)
    teng = await TorchServingEngine.create(
        cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
        device="cpu", warmup=False)
    try:
        got = await _by_choice(teng, Context, PreprocessedRequest(
            token_ids=prompt, stop_conditions=StopConditions(max_tokens=6,
                                                            ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0, n=3)))
        assert got == want and sorted(got) == [0, 1, 2]
        assert all(len(s) == 6 for s in got.values())
        assert teng.metrics()["kv_active_blocks"] == 0
    finally:
        await teng.close()


@pytest.mark.asyncio
async def test_engine_fanout_offsets_seeds_by_choice(weights):
    """Choice i of a seeded n = 3 request streams what a single request
    seeded seed + i streams; n above 20 is refused."""
    cfg = EngineConfig(model=ModelConfig(**TINY), **BASE)
    eng = await TorchServingEngine.create(
        cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
        device="cpu", warmup=False)
    prompt = [int(t) for t in np.random.default_rng(9).integers(3, 512, 15)]

    def req(n, seed):
        return PreprocessedRequest(
            token_ids=prompt, stop_conditions=StopConditions(max_tokens=8),
            sampling_options=SamplingOptions(temperature=0.9, seed=seed, n=n))
    try:
        fan = await _by_choice(eng, Context, req(3, 40))
        singles = [await _by_choice(eng, Context, req(1, 40 + i))
                   for i in range(3)]
        assert [fan[i] for i in range(3)] == [s[None] for s in singles]
        assert len({tuple(s) for s in fan.values()}) > 1
        with pytest.raises(EngineError, match="n must be <= 20"):
            await _by_choice(eng, Context, req(21, 1))
    finally:
        await eng.close()


def test_engine_output_choice_round_trips():
    out = EngineOutput(token_ids=[1], choice=2)
    assert EngineOutput.from_wire(out.to_wire()).choice == 2
