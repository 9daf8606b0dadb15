"""Whole-engine differential: greedy streams of ``TorchServingEngine`` on
the CPU equal ``JaxServingEngine``'s on the same weights.

Both engines run their plain attention route (CPU). Scenarios: a batch of
concurrent prompts, chunked prefill (a small per-step token budget), a
prefix-cache hit, and preemption under a tiny KV block budget. Tiny widths
(2 layers, hidden 64, 4 heads over 2 KV heads, head_dim 16, block size 8,
vocab 512), f32.
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
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols.common import OutputOptions as JaxOutput
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    OutputOptions,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context, EngineError

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


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, 512, n)] for n in lengths]


async def _jax_streams(weights, cfg_kw, batches, max_tokens):
    cfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **cfg_kw)
    engine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=cfg,
        params=weights[0], warmup=False)

    async def one(p):
        req = JaxRequest(token_ids=p,
                         stop_conditions=JaxStop(max_tokens=max_tokens,
                                                 ignore_eos=True),
                         sampling_options=JaxSampling(temperature=0.0))
        toks = []
        async for out in engine.generate(JaxContext(req)):
            toks.extend(out["token_ids"])
        return toks

    try:
        return [await asyncio.gather(*(one(p) for p in batch))
                for batch in batches]
    finally:
        await engine.close()


async def _torch_streams(weights, cfg_kw, batches, max_tokens):
    cfg = EngineConfig(model=ModelConfig(**TINY), **cfg_kw)
    engine = await TorchServingEngine.create(
        cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
        device="cpu", warmup=False)

    async def one(p):
        req = PreprocessedRequest(
            token_ids=p,
            stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0))
        toks, reasons = [], []
        async for out in engine.generate(Context(req)):
            toks.extend(out["token_ids"])
            reasons.append(out.get("finish_reason"))
        assert reasons[-1] == FinishReason.LENGTH.value
        return toks

    try:
        streams = [await asyncio.gather(*(one(p) for p in batch))
                   for batch in batches]
        return streams, engine.metrics()
    finally:
        await engine.close()


def _prefix_waves():
    first = _prompts(0, [5, 19, 33, 12])
    return [first, [first[2][:24] + [7, 8, 9], first[2]]]


SCENARIOS = {
    # four concurrent prompts in one prefill batch, then a second wave
    # that shares a 24-token (3-block) prefix with the first: prefix hits
    "batched_prefix_hit": (
        {}, _prefix_waves, 8),
    # a 16-token per-step budget chunks every prompt over several steps,
    # interleaved with decode of the already-admitted rows
    "chunked_prefill": (
        dict(max_prefill_tokens_per_step=16, prefill_buckets=[8, 16, 32, 64, 128]),
        lambda: [_prompts(1, [40, 9, 27])], 6),
    # 12 blocks of 8 cannot hold four 20-token prompts growing by 16: the
    # decode loop preempts, and the re-prefill continues each stream
    "preemption": (
        dict(num_kv_blocks=12, enable_prefix_caching=False),
        lambda: [_prompts(2, [20, 20, 20, 20])], 16),
}


@pytest.mark.asyncio
@pytest.mark.parametrize("name", list(SCENARIOS))
async def test_greedy_streams_match_jax_engine(weights, name):
    overrides, batches_fn, max_tokens = SCENARIOS[name]
    cfg_kw = dict(BASE, **overrides)
    batches = batches_fn()
    want = await _jax_streams(weights, cfg_kw, batches, max_tokens)
    got, metrics = await _torch_streams(weights, cfg_kw, batches, max_tokens)
    assert got == want
    assert all(len(s) == max_tokens for batch in got for s in batch)
    if name == "batched_prefix_hit":
        assert metrics["gpu_prefix_cache_hit_rate"] > 0
    if name == "chunked_prefill":
        assert metrics["prefill_steps"] > 3
    if name == "preemption":
        assert metrics["preemptions"] > 0


async def _outputs(engine, ctx_cls, reqs):
    async def one(req):
        outs = []
        async for out in engine.generate(ctx_cls(req)):
            outs.append(out)
        return outs
    return await asyncio.gather(*(one(r) for r in reqs))


@pytest.mark.asyncio
async def test_logprobs_penalties_and_bias_match_jax_engine(weights):
    """Greedy requests with penalties and logit_bias, asking for top
    logprobs and prompt logprobs: the same tokens, and logprobs within
    1e-4 (f32 on both sides; summation order differs)."""
    prompts = _prompts(5, [13, 30, 7])
    kinds = [
        dict(samp=dict(temperature=0.0, repetition_penalty=1.3,
                       frequency_penalty=0.4, presence_penalty=0.3),
             out=dict(logprobs=3, prompt_logprobs=1)),
        dict(samp=dict(temperature=0.0, logit_bias={5: 4.0, 17: -100.0}),
             out=dict(logprobs=0)),
        dict(samp=dict(temperature=0.0, repetition_penalty=0.8),
             out=dict(logprobs=2, prompt_logprobs=1)),
    ]
    jax_reqs = [JaxRequest(token_ids=p, stop_conditions=JaxStop(
        max_tokens=6, ignore_eos=True), sampling_options=JaxSampling(**k["samp"]),
        output_options=JaxOutput(**k["out"])) for p, k in zip(prompts, kinds)]
    torch_reqs = [PreprocessedRequest(token_ids=p, stop_conditions=StopConditions(
        max_tokens=6, ignore_eos=True), sampling_options=SamplingOptions(**k["samp"]),
        output_options=OutputOptions(**k["out"])) for p, k in zip(prompts, kinds)]

    jcfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **BASE)
    jeng = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=jcfg,
        params=weights[0], warmup=False)
    try:
        want = await _outputs(jeng, JaxContext, jax_reqs)
    finally:
        await jeng.close()
    cfg = EngineConfig(model=ModelConfig(**TINY), **BASE)
    teng = await TorchServingEngine.create(
        cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
        device="cpu", warmup=False)
    try:
        got = await _outputs(teng, Context, torch_reqs)
    finally:
        await teng.close()

    def flat(outs):
        toks, lps, tops, plps = [], [], [], None
        for o in outs:
            toks += o["token_ids"]
            for lp in o.get("logprobs") or []:
                lps.append(lp["logprob"])
                tops.append(lp["top"])
            plps = o.get("prompt_logprobs", plps)
        return toks, lps, tops, plps

    for g, w in zip(got, want):
        gt, gl, gtop, gp = flat(g)
        wt, wl, wtop, wp = flat(w)
        assert gt == wt and len(gt) == 6
        np.testing.assert_allclose(gl, wl, rtol=1e-4, atol=1e-4)
        for a, b in zip(gtop, wtop):
            assert (a or {}).keys() == (b or {}).keys()
            for key in a or {}:
                assert abs(a[key] - b[key]) < 1e-4
        assert (gp is None) == (wp is None)
        if gp is not None:
            assert gp[0] is None and wp[0] is None and len(gp) == len(wp)
            np.testing.assert_allclose(gp[1:], wp[1:], rtol=1e-4, atol=1e-4)
    # the options really asked for something: 3 alternatives per token on
    # the first request, prompt logprobs on two of three
    assert all(len(t) == 3 for t in flat(got[0])[2])
    assert sum(flat(g)[3] is not None for g in got) == 2


@pytest.mark.asyncio
async def test_seeded_sampling_reproduces_and_validation(weights):
    """A seeded temperature request gives the same stream twice (alone and
    beside a batchmate); unported request shapes are refused."""
    cfg = EngineConfig(model=ModelConfig(**TINY), **BASE)
    engine = await TorchServingEngine.create(
        cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
        device="cpu", warmup=False)
    prompt = _prompts(4, [14])[0]

    async def run(p, seed):
        req = PreprocessedRequest(
            token_ids=p, stop_conditions=StopConditions(max_tokens=10),
            sampling_options=SamplingOptions(temperature=0.9, top_p=0.95,
                                             seed=seed))
        toks = []
        async for out in engine.generate(Context(req)):
            toks.extend(out["token_ids"])
        return toks

    try:
        a = await run(prompt, 1234)
        b, _ = await asyncio.gather(run(prompt, 1234), run(prompt[:5], 99))
        assert a == b and len(a) == 10
        for bad in (
            PreprocessedRequest(token_ids=[]),
            PreprocessedRequest(token_ids=[600]),
            # n > 1 is served (a fan-out); above OpenAI's cap of 20 it is not
            PreprocessedRequest(token_ids=[1], sampling_options=SamplingOptions(n=21)),
            PreprocessedRequest(token_ids=[1], sampling_options=SamplingOptions(
                guided_json={"type": "object"})),
            # choices given as text only: the engine holds no tokenizer
            PreprocessedRequest(token_ids=[1], sampling_options=SamplingOptions(
                guided_choice=["a"])),
        ):
            with pytest.raises(EngineError):
                async for _ in engine.generate(Context(bad)):
                    pass
    finally:
        await engine.close()


def test_config_refuses_unported_features():
    model = ModelConfig(**TINY)
    # several devices stay refused by name
    for kw in (dict(tp_size=2), dict(sp_size=2, tp_size=2)):
        with pytest.raises(NotImplementedError, match="multi-device"):
            EngineConfig(model=model, **kw)
    # an fp8 KV cache is served (below); a cache dtype the reference does
    # not know raises its ValueError
    with pytest.raises(ValueError, match="unknown kv_cache_dtype"):
        EngineConfig(model=model, kv_cache_dtype="int8")
    # served since the second slice: bursts, ngram speculation, the
    # epilogue's route on any device; since the fourth: the dispatch-ahead
    # pipeline and the chained device-finish loop with its knobs
    for kw in (dict(multi_step_decode=4), dict(spec_ngram_tokens=2),
               dict(fused_epilogue="on"), dict(fused_epilogue="auto"),
               dict(kv_cache_dtype="fp8"),
               dict(decode_pipeline_depth=2),
               dict(decode_pipeline_depth=2, device_finish="off"),
               dict(device_finish="on", decode_pipeline_depth=2,
                    multi_step_decode=4, guided_device_table=False,
                    guided_table_max_states=64, device_stop_strings=False),
               # the KV tiers and prefix pulls
               dict(host_kv_blocks=8), dict(prefix_pull=True),
               # draft models and the chained propose-verify round
               dict(spec_draft_model="draft", spec_draft_tokens=4),
               dict(decode_pipeline_depth=2, spec_ngram_tokens=2),
               dict(device_finish="on", decode_pipeline_depth=2,
                    spec_ngram_tokens=4),
               dict(decode_pipeline_depth=2, spec_draft_model="draft",
                    spec_draft_tokens=16),
               dict(host_kv_blocks=8, cold_tier_dir="/nonexistent",
                    cold_tier_blocks=8)):
        EngineConfig(model=model, **kw)
    assert EngineConfig(model=model, decode_pipeline_depth=2).device_finish_enabled
    # "on" below the pipeline depth is an error, as in the reference
    with pytest.raises(ValueError):
        EngineConfig(model=model, device_finish="on")
    # a MoE config builds the Mixtral family; int8 weights are served, any other scheme is refused by name before
    # a weight is drawn, as in the reference
    moe = EngineConfig(model=dataclasses.replace(model, num_experts=4))
    assert ModelRunner(moe, device="cpu").arch.__name__.endswith("mixtral")
    EngineConfig(model=dataclasses.replace(model, quantization="int8"))
    with pytest.raises(ValueError, match="unknown quantization 'fp8'"):
        EngineConfig(model=dataclasses.replace(model, quantization="fp8"))


def test_runner_refuses_float32_on_a_card_by_name(monkeypatch):
    """The attention kernels take bf16 only: a runner built on a CUDA
    device with ``dtype="float32"`` raises by name before it allocates
    anything (here the card is faked: the check needs none), while the CPU
    keeps f32 for the differential tests."""
    import torch

    model = ModelConfig(**TINY)
    assert ModelRunner(EngineConfig(model=model, **BASE), device="cpu").dtype \
        == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="dtype='float32' on a CUDA"):
        ModelRunner(EngineConfig(model=model, **BASE), device="cuda")
