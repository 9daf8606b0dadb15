"""Differential tests of the port's speculative-verify path and K-step
decode bursts against the JAX package, plus stream equalities within the
port.

- ``paged_verify_attention_ref`` against the Pallas verify kernel in
  interpret mode (S in {2, 5, 17, 32}, a window, a padded row, head_dim 16
  and 128), f32;
- ``ngram_propose`` against the reference's;
- whole-engine greedy streams of ``TorchServingEngine`` equal
  ``JaxServingEngine``'s with ngram speculation and with 4-step bursts;
- within the port, the same streams with ``fused_epilogue`` "on" and "off"
  and with ``multi_step_decode`` 4 and 1, for greedy, seeded, penalty, bias
  and logprob requests.

Tiny widths (2 layers, hidden 64, 4 heads over 2 KV heads, head_dim 16,
block size 8, vocab 512), f32, on the CPU (the plain routes).
"""

import asyncio
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.scheduler import ngram_propose as jax_ngram_propose
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.ops.pallas_decode import paged_verify_attention as jax_verify
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.scheduler import ngram_propose
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import paged_verify
from dynamo_tpu_torch.ops.attention import attention
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    OutputOptions,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

L, H, KVH, D, BS = 2, 4, 2, 16, 8
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=256)
BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32")


@pytest.mark.parametrize("head_dim", [D, 128])  # 128: the kernel's second width
@pytest.mark.parametrize("s", [2, 5, 17, 32])
@pytest.mark.parametrize("window", [None, 6])
def test_verify_plain_version_matches_pallas_interpret(s, window, head_dim):
    rng = np.random.default_rng(s)
    w = 9
    # a row from a long context, a short one, a padded proposal (ctx <
    # base + S: rows past ctx are discarded), and a pad row (base 0, ctx 1,
    # block table 0)
    base = np.array([40, 3, 20, 0], np.int32)
    ctx = np.array([40 + s, 3 + s, 20 + s - 1, 1], np.int32)
    b = len(base)
    n_blocks = b * w + 3
    k = rng.standard_normal((L, n_blocks, BS, KVH, head_dim)).astype(np.float32)
    v = rng.standard_normal((L, n_blocks, BS, KVH, head_dim)).astype(np.float32)
    bt = rng.permutation(n_blocks)[: b * w].reshape(b, w).astype(np.int32)
    bt[-1] = 0
    q = rng.standard_normal((b, s, H, head_dim)).astype(np.float32)
    ref = np.asarray(jax_verify(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(base), jnp.asarray(ctx), layer_idx=jnp.int32(1),
        interpret=True, window=window))
    args = [torch.from_numpy(x) for x in (q, k, v, bt, base, ctx)]
    got = paged_verify.paged_verify_attention(
        *args, layer_idx=1,
        window=window if window is not None else paged_verify.NO_WINDOW).numpy()
    # the CPU dispatch of the stacked-cache attention takes the same route
    pos = torch.from_numpy(base).long()[:, None] + torch.arange(s)[None, :]
    got2 = attention(args[0], args[1], args[2], args[3], pos, args[5],
                     layer_idx=1, sliding_window=window).numpy()
    for i in range(b):
        valid = min(s, ctx[i] - base[i])
        np.testing.assert_allclose(got[i, :valid], ref[i, :valid],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got2[i, :valid], ref[i, :valid],
                                   rtol=1e-5, atol=1e-5)
    assert paged_verify.launches == 0


def test_ngram_propose_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        hist = [int(t) for t in rng.integers(0, 4, rng.integers(0, 30))]
        match, k = int(rng.integers(1, 4)), int(rng.integers(0, 6))
        assert ngram_propose(hist, match, k) == jax_ngram_propose(hist, match, k)


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(3),
                                   jnp.float32)
    return params, jax.device_get(params)


# greedy prompts: three looping ones (the ngram lookup finds their
# continuation) and a plain one
GREEDY_PROMPTS = [[1, 9, 8, 9, 8, 9, 8], [5, 6, 7, 8] * 6,
                  [1, 42, 42, 42, 42], [1, 17, 43, 99, 7, 250, 3]]


async def _jax_greedy(weights, cfg_kw, prompts, max_tokens):
    cfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **cfg_kw)
    engine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=cfg,
        params=weights[0], warmup=False)

    async def one(p):
        req = JaxRequest(token_ids=p, stop_conditions=JaxStop(
            max_tokens=max_tokens, ignore_eos=True),
            sampling_options=JaxSampling(temperature=0.0))
        toks = []
        async for out in engine.generate(JaxContext(req)):
            toks.extend(out["token_ids"])
        return toks

    try:
        return await asyncio.gather(*(one(p) for p in prompts))
    finally:
        await engine.close()


async def _jax_spec_metrics(weights, cfg_kw, prompts, max_tokens):
    """The reference engine's greedy streams and its spec counts."""
    cfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **cfg_kw)
    engine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=cfg,
        params=weights[0], warmup=False)

    async def one(p):
        req = JaxRequest(token_ids=p, stop_conditions=JaxStop(
            max_tokens=max_tokens, ignore_eos=True),
            sampling_options=JaxSampling(temperature=0.0))
        toks = []
        async for out in engine.generate(JaxContext(req)):
            toks.extend(out["token_ids"])
        return toks

    try:
        outs = [await one(p) for p in prompts]
        m = engine.scheduler.metrics()
        return outs, (m["spec_proposed_tokens"], m["spec_accepted_tokens"])
    finally:
        await engine.close()


async def _torch_outputs(weights, cfg_kw, requests):
    """Serve ``requests`` ([(prompt, sampling kwargs, output kwargs)])
    concurrently; returns ([(tokens, logprobs)], metrics)."""
    cfg = EngineConfig(model=ModelConfig(**TINY), **cfg_kw)
    engine = await TorchServingEngine.create(
        cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
        device="cpu", warmup=False)

    async def one(prompt, samp, out_opts, max_tokens):
        req = PreprocessedRequest(
            token_ids=prompt,
            stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
            sampling_options=SamplingOptions(**samp),
            output_options=OutputOptions(**out_opts))
        toks, lps, reasons = [], [], []
        async for out in engine.generate(Context(req)):
            toks.extend(out["token_ids"])
            lps.extend(lp["logprob"] for lp in out.get("logprobs") or [])
            reasons.append(out.get("finish_reason"))
        assert reasons[-1] == FinishReason.LENGTH.value
        assert len(toks) == max_tokens
        return toks, lps

    try:
        outs = await asyncio.gather(*(one(*r) for r in requests))
        return outs, engine.metrics()
    finally:
        await engine.close()


def _greedy_requests(max_tokens):
    return [(p, dict(temperature=0.0), {}, max_tokens) for p in GREEDY_PROMPTS]


@pytest.mark.asyncio
async def test_spec_greedy_streams_match_jax_engine_and_accept(weights):
    cfg_kw = dict(BASE, spec_ngram_tokens=2, spec_ngram_match=2)
    want = await _jax_greedy(weights, cfg_kw, GREEDY_PROMPTS, 20)
    got, metrics = await _torch_outputs(weights, cfg_kw, _greedy_requests(20))
    assert [t for t, _ in got] == want
    assert metrics["spec_proposed_tokens"] > 0
    assert metrics["spec_accepted_tokens"] > 0


@pytest.mark.asyncio
@pytest.mark.parametrize("match", [1, 2])
async def test_chained_spec_streams_and_counts_match_jax_engine(weights, match):
    """ngram speculation inside the chained loop: proposals drawn on the
    device from the carry's suffix ring, rounds chained with no host
    barrier. One request at a time (each round's counts then follow the
    stream alone): streams, proposed and accepted tokens equal the
    reference's."""
    cfg_kw = dict(BASE, spec_ngram_tokens=4, spec_ngram_match=match,
                  decode_pipeline_depth=2)
    want, want_counts = await _jax_spec_metrics(weights, cfg_kw,
                                                GREEDY_PROMPTS, 20)
    got = []
    for p in GREEDY_PROMPTS:
        out, metrics = await _torch_outputs(
            weights, cfg_kw, [(p, dict(temperature=0.0), {}, 20)])
        got.append((out[0][0], metrics))
    assert [t for t, _ in got] == want
    counts = tuple(sum(m[k] for _, m in got) for k in (
        "spec_proposed_tokens", "spec_accepted_tokens"))
    assert counts == want_counts
    assert counts[0] > 0 and counts[1] > 0
    assert all(m["chain_len_max"] > 1 for _, m in got)


@pytest.mark.asyncio
async def test_burst_greedy_streams_match_jax_engine(weights):
    # 10 tokens: the last burst of each request ends mid-burst
    cfg_kw = dict(BASE, multi_step_decode=4)
    want = await _jax_greedy(weights, cfg_kw, GREEDY_PROMPTS, 10)
    got, metrics = await _torch_outputs(weights, cfg_kw, _greedy_requests(10))
    assert [t for t, _ in got] == want
    # bursts ran: fewer decode passes than tokens
    assert metrics["decode_steps"] < 9


def _mixed_requests():
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(3, 512, n)] for n in (13, 30, 7, 21, 9)]
    return [
        (prompts[0], dict(temperature=0.0), {}, 12),
        (prompts[1], dict(temperature=0.9, top_p=0.95, top_k=20, seed=1234), {}, 12),
        (prompts[2], dict(temperature=0.8, seed=5, repetition_penalty=1.3,
                          frequency_penalty=0.4, presence_penalty=0.3,
                          min_p=0.05), {}, 12),
        (prompts[3], dict(temperature=0.0, logit_bias={5: 4.0, 17: -100.0}), {}, 12),
        (prompts[4], dict(temperature=0.7, seed=11), dict(logprobs=3), 12),
    ]


@pytest.mark.asyncio
@pytest.mark.parametrize("variant", [dict(fused_epilogue="on"),
                                     dict(multi_step_decode=4)])
async def test_streams_equal_within_port(weights, variant):
    """The epilogue's route against the unfused tail, and 4-step bursts
    against single steps: the same tokens and logprobs for greedy, seeded,
    penalty, bias and logprob requests (max_batch_size 8 holds all five)."""
    base = dict(BASE, max_batch_size=8)
    reqs = _mixed_requests()
    want, _ = await _torch_outputs(weights, dict(base, fused_epilogue="off"), reqs)
    got, metrics = await _torch_outputs(
        weights, {**base, "fused_epilogue": "off", **variant}, reqs)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert len(got[4][1]) == 12  # the logprob request got one per token
    if "multi_step_decode" in variant:
        assert metrics["decode_steps"] < 11
