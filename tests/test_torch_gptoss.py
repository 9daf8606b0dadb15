"""Differential tests of the port's GPT-OSS family against the JAX package.

- ``mixtral.gptoss_moe`` against the reference's, with inputs scaled so the
  GLU's ±7 clamp bites and with drops at capacity 1;
- ``gptoss.forward`` prefill and decode logits and caches against
  ``dynamo_tpu.models.gptoss.forward`` (the XLA route), with non-zero sinks
  and biases carried across by ``from_jax_params`` and a prompt longer than
  the window;
- the plain attention with sinks (decode S 1, verify S 5 and 17 at G 8,
  flash S 64) against the reference's Pallas kernels with sinks in
  interpret mode;
- whole-engine greedy streams against ``JaxServingEngine`` at K 1, at K 4
  and with ngram speculation;
- a K = 4 burst in which a row ends on a stop id streams exactly as K = 1
  when the experts hold one token each (the rows after the finished one
  must not lose expert slots to it);
- ``models.resolve`` and the published gpt-oss-20b config.

Tiny widths (the reference's own GPT-OSS test: 4 layers, hidden 32, 4 heads
over 2 KV heads of head_dim 8, window 4, 4 experts top 2), f32, on the CPU.
"""

import asyncio
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.models import gptoss as jax_gptoss
from dynamo_tpu.models.mixtral import gptoss_moe as jax_gptoss_moe
from dynamo_tpu.ops.pallas_attention import paged_flash_attention as jax_flash
from dynamo_tpu.ops.pallas_decode import paged_decode_attention as jax_decode
from dynamo_tpu.ops.pallas_decode import paged_verify_attention as jax_verify
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models import gemma2, gptoss, llama, mixtral, resolve
from dynamo_tpu_torch.models.mixtral import gptoss_moe
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import paged_decode, paged_flash, paged_verify
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

# the reference's tiny GPT-OSS (tests/test_gptoss.py), as a config.json
TINY = {
    "architectures": ["GptOssForCausalLM"], "vocab_size": 256,
    "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 4,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
    "num_local_experts": 4, "num_experts_per_tok": 2,
    "max_position_embeddings": 128, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "sliding_window": 4, "tie_word_embeddings": False,
    "attention_bias": True,
    "layer_types": ["sliding_attention", "full_attention"] * 2,
    "rope_scaling": {"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0,
                     "beta_slow": 1.0, "original_max_position_embeddings": 32,
                     "truncate": False},
}
# 32 experts at top 4: at a decode batch of 4 rows an expert holds
# int(4 * 4 * 2 / 32) = 1 token (gpt-oss-20b at 8 rows holds 2)
TINY_CAP1 = dict(TINY, num_local_experts=32, num_experts_per_tok=4,
                 intermediate_size=16)
BS, N_BLOCKS = 8, 16
TOL = dict(rtol=1e-4, atol=1e-4)
OP_TOL = dict(rtol=1e-5, atol=1e-5)
# leaves the reference inits to zero; seeded non-zero values exercise them
_NONZERO = ("sinks", "bq", "bk", "bv", "bo", "router_bias", "b_gate_up",
            "b_down")


def _configs(hf):
    return JaxModelConfig.from_hf_config(hf), ModelConfig.from_hf_config(hf)


def _np_params(jcfg, seed):
    """The reference's init, leaves in numpy, with sinks and biases drawn
    from the seed."""
    params = jax.device_get(jax_gptoss.init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for name in _NONZERO:
        layers[name] = rng.normal(0.0, 0.5, layers[name].shape).astype(np.float32)
    return dict(params, layers=layers)


def _both(hf, seed=0):
    """(jax cfg, jax params, port cfg, port params on the CPU in f32)."""
    jcfg, cfg = _configs(hf)
    np_params = _np_params(jcfg, seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return jcfg, jparams, cfg, from_jax_params(np_params, cfg, "cpu", "float32")


@pytest.mark.parametrize("capacity,pads", [(16, False), (1, True)],
                         ids=["no_drop", "capacity1_pads"])
def test_gptoss_moe_matches_jax(capacity, pads):
    """Large inputs so the gate's +7 cap and up's ±7 clamp both bite; at
    capacity 1 the later tokens of a shared expert are dropped and pad
    tokens claim nothing."""
    rng = np.random.default_rng(capacity)
    t, d, e, inter, k = 6, 32, 4, 16, 2
    x = (8.0 * rng.standard_normal((t, d))).astype(np.float32)
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    router_b = rng.standard_normal(e).astype(np.float32)
    wgu = (rng.standard_normal((e, d, 2 * inter)) / np.sqrt(d)).astype(np.float32)
    bgu = rng.standard_normal((e, 2 * inter)).astype(np.float32)
    wd = (rng.standard_normal((e, inter, d)) / np.sqrt(inter)).astype(np.float32)
    bd = rng.standard_normal((e, d)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1, 1], np.float32) if pads else None
    gu = np.einsum("td,edi->tei", x, wgu) + bgu[None]
    assert (gu[..., 0::2] > 7).any() and (gu[..., 1::2] < -7).any()
    want = jax_gptoss_moe(*(jnp.asarray(a) for a in (x, router, router_b, wgu,
                                                     bgu, wd, bd)),
                          k, capacity,
                          valid=None if valid is None else jnp.asarray(valid))
    got = gptoss_moe(*(torch.from_numpy(a) for a in (x, router, router_b, wgu,
                                                     bgu, wd, bd)),
                     k, capacity,
                     valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    if pads:
        assert not got[2].any()


def test_gptoss_forward_prefill_then_decode_matches_jax():
    """A padded prefill of 13 tokens (past the window of 4), then two decode
    steps, through both packages with identical weights (non-zero sinks and
    biases): logits to 1e-4 and both caches on every layer."""
    jcfg, jparams, cfg, params = _both(TINY)
    jcfg = dataclasses.replace(jcfg, attention_impl="xla")
    for name in _NONZERO:
        assert params["layers"][name].abs().sum() > 0
    jcache = jax_gptoss.init_kv_cache(jcfg, N_BLOCKS, BS, jnp.float32)
    cache = gptoss.init_kv_cache(cfg, N_BLOCKS, BS, torch.float32)
    rng = np.random.default_rng(7)
    n, bucket = 13, 16
    blocks = np.array([[5, 2, 9, 0]], np.int32)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = rng.integers(0, 256, n)
    positions = np.full((1, bucket), n - 1, np.int32)
    positions[0, :n] = np.arange(n)
    slots = np.full((1, bucket), -1, np.int32)
    slots[0, :n] = blocks[0, np.arange(n) // BS] * BS + np.arange(n) % BS

    def run(tok, pos, slot, ctx):
        nonlocal jcache, cache
        jl, jcache = jax_gptoss.forward(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
            jnp.asarray(blocks), jnp.asarray(slot), jnp.asarray(ctx))
        tl, cache = gptoss.forward(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos), cache,
            torch.from_numpy(blocks), torch.from_numpy(slot),
            torch.from_numpy(ctx))
        return np.asarray(jl), tl.numpy()

    jl, tl = run(tokens, positions, slots, np.array([n], np.int32))
    np.testing.assert_allclose(tl[0, :n], jl[0, :n], **TOL)
    nxt = int(np.argmax(jl[0, n - 1]))
    for step in range(2):
        pos = n + step
        jl, tl = run(np.array([[nxt]], np.int32), np.array([[pos]], np.int32),
                     np.array([[blocks[0, pos // BS] * BS + pos % BS]], np.int32),
                     np.array([pos + 1], np.int32))
        np.testing.assert_allclose(tl, jl, **TOL)
        nxt = int(np.argmax(jl[0, 0]))
    hd = cfg.head_dim
    for t, j in zip(cache, jcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j)[..., :hd], **TOL)


def test_alternating_window_and_resolve():
    """Even layers windowed, odd ones not; gptoss resolves to the new module,
    gemma2 to its own, and a Mixtral-style MoE config to mixtral."""
    _, cfg = _configs(TINY)
    assert [llama.alternating_window(cfg, li) for li in range(4)] == [4, None, 4, None]
    assert llama.alternating_window(dataclasses.replace(cfg, sliding_window=0), 0) is None
    assert resolve(cfg) is gptoss
    assert resolve(ModelConfig(vocab_size=64, hidden_size=32, num_heads=2,
                               num_kv_heads=1, num_experts=4)) is mixtral
    assert resolve(ModelConfig(vocab_size=64, hidden_size=32, num_heads=2,
                               num_kv_heads=1, model_family="gemma2")) is gemma2
    with pytest.raises(NotImplementedError, match="softcapping"):
        gptoss.check_supported(dataclasses.replace(cfg, attn_logit_softcap=30.0))


def test_weight_bridge_needs_every_gptoss_leaf():
    jcfg, cfg = _configs(TINY)
    np_params = _np_params(jcfg, 1)
    for name in ("sinks", "router_bias", "b_down"):
        broken = dict(np_params, layers={k: v for k, v in np_params["layers"].items()
                                         if k != name})
        with pytest.raises(ValueError, match=f"layers.{name}"):
            from_jax_params(broken, cfg)


# gpt-oss-20b's published config.json (the fields the engine reads)
GPT_OSS_20B = {
    "architectures": ["GptOssForCausalLM"], "vocab_size": 201088,
    "hidden_size": 2880, "intermediate_size": 2880, "num_hidden_layers": 24,
    "num_attention_heads": 64, "num_key_value_heads": 8, "head_dim": 64,
    "num_local_experts": 32, "num_experts_per_tok": 4,
    "experts_per_token": 4, "sliding_window": 128,
    "layer_types": ["sliding_attention", "full_attention"] * 12,
    "rope_theta": 150000, "rope_scaling": {
        "rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
        "beta_slow": 1.0, "original_max_position_embeddings": 4096,
        "truncate": False},
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
    "attention_bias": True, "tie_word_embeddings": False, "swiglu_limit": 7.0,
}


def test_gpt_oss_20b_config_parses_to_20_9b_parameters():
    """Both packages parse the published config alike; its leaves hold
    20.91 B parameters (41.8 GB in bf16), counted from the reference's
    shapes without drawing them."""
    jcfg, cfg = _configs(GPT_OSS_20B)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.model_family, cfg.num_experts, cfg.num_experts_per_tok,
            cfg.sliding_window, cfg.head_dim) == ("gptoss", 32, 4, 128, 64)
    assert resolve(cfg) is gptoss
    shapes = jax.eval_shape(lambda: jax_gptoss.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert abs(n - 20.91e9) < 0.01e9
    assert set(shapes["layers"]) == gptoss.param_keys(cfg)["layers"]


@pytest.mark.parametrize("case", ["decode_s1", "verify_s5", "verify_s17",
                                  "flash_s64"])
def test_sink_attention_plain_version_matches_pallas_interpret(case):
    """The plain versions with sinks (some above every score) and a window
    against the reference's Pallas kernels with sinks in interpret mode, at
    G 8 (16 heads over 2 KV heads): ragged contexts, a ctx-0 decode row, a
    verify pad row (base 0, ctx 1, table 0), a flash prefix hit."""
    rng = np.random.default_rng(len(case))
    h, kvh, d, layers, li = 16, 2, 16, 3, 1
    kind, s = case.split("_s")
    s = int(s)
    w = 12
    if kind == "decode":
        ctx = np.array([0, 1, 9, 40, 57], np.int32)
        base = ctx - 1
    elif kind == "verify":
        base = np.array([40, 3, 20, 0], np.int32)
        ctx = np.array([40 + s, 3 + s, 20 + s - 1, 1], np.int32)
    else:
        base = np.array([0, 20], np.int32)
        ctx = np.array([64, 84], np.int32)
    b = len(ctx)
    n_blocks = b * w + 3
    k = rng.standard_normal((layers, n_blocks, BS, kvh, d)).astype(np.float32)
    v = rng.standard_normal((layers, n_blocks, BS, kvh, d)).astype(np.float32)
    bt = rng.permutation(n_blocks)[: b * w].reshape(b, w).astype(np.int32)
    if kind == "verify":
        bt[-1] = 0
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    sinks = (3.0 * rng.standard_normal(h)).astype(np.float32)
    window = 6
    jargs = [jnp.asarray(a) for a in (q, k, v, bt)]
    targs = [torch.from_numpy(a) for a in (q, k, v, bt)]
    common = dict(layer_idx=li, window=window)
    if kind == "decode":
        want = jax_decode(*jargs, jnp.asarray(ctx), layer_idx=jnp.int32(li),
                          interpret=True, window=window, sinks=jnp.asarray(sinks))
        got = paged_decode.paged_decode_attention(
            *targs, torch.from_numpy(ctx), sinks=torch.from_numpy(sinks), **common)
        # the ctx-0 row is zeros on both sides
        assert not got[0].any()
    else:
        jfn = jax_verify if kind == "verify" else jax_flash
        extra = {} if kind == "verify" else dict(q_chunk=16)
        want = jfn(*jargs, jnp.asarray(base), jnp.asarray(ctx),
                   layer_idx=jnp.int32(li), interpret=True, window=window,
                   sinks=jnp.asarray(sinks), **extra)
        mod = paged_verify if kind == "verify" else paged_flash
        fn = (mod.paged_verify_attention if kind == "verify"
              else mod.paged_flash_attention)
        got = fn(*targs, torch.from_numpy(base), torch.from_numpy(ctx),
                 sinks=torch.from_numpy(sinks), **common)
    want, got = np.asarray(want), got.numpy()
    for i in range(b):
        valid = max(0, min(s, ctx[i] - base[i])) if kind != "decode" else 1
        np.testing.assert_allclose(got[i, :valid], want[i, :valid], **OP_TOL)
    assert paged_decode.launches == paged_verify.launches == paged_flash.launches == 0


ENGINE = dict(max_batch_size=4, max_model_len=128, kv_block_size=BS,
              num_kv_blocks=64, dtype="float32")


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, vocab, n)] for n in lengths]


def _repeats(seed):
    """Prompts that repeat a short pattern, so the ngram lookup proposes."""
    rng = np.random.default_rng(seed)
    out = []
    for n, period in ((17, 3), (22, 5), (9, 2), (30, 7)):
        pattern = [int(t) for t in rng.integers(3, 256, period)]
        out.append((pattern * (n // period + 1))[:n])
    return out


async def _streams(engine, req_cls, ctx_cls, stop_cls, samp_cls, prompts,
                   stops):
    """Greedy streams of ``prompts`` with per-request stop kwargs; returns
    (tokens, finish reason) per request."""
    async def one(p, stop):
        req = req_cls(token_ids=p, stop_conditions=stop_cls(**stop),
                      sampling_options=samp_cls(temperature=0.0))
        toks, reasons = [], []
        async for out in engine.generate(ctx_cls(req)):
            toks.extend(out["token_ids"])
            reasons.append(out.get("finish_reason"))
        return toks, reasons[-1]
    try:
        return await asyncio.gather(*(one(p, s) for p, s in zip(prompts, stops)))
    finally:
        await engine.close()


async def _jax_streams(jcfg, jparams, cfg_kw, prompts, stops):
    engine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None),
        engine_config=JaxEngineConfig(model=jcfg, **cfg_kw), params=jparams,
        warmup=False)
    return await _streams(engine, JaxRequest, JaxContext, JaxStop, JaxSampling,
                          prompts, stops)


async def _torch_streams(cfg, params, cfg_kw, prompts, stops):
    engine = await TorchServingEngine.create(
        EngineConfig(model=cfg, **cfg_kw), params=params, device="cpu",
        warmup=False)
    return await _streams(engine, PreprocessedRequest, Context, StopConditions,
                          SamplingOptions, prompts, stops)


@pytest.mark.asyncio
@pytest.mark.parametrize("overrides", [
    {},
    dict(multi_step_decode=4),
    dict(spec_ngram_tokens=3, spec_ngram_match=2),
], ids=["k1", "burst4", "ngram_spec"])
async def test_gptoss_greedy_streams_match_jax_engine(overrides):
    """Greedy streams of the GPT-OSS engine against the reference's, prompts
    past the window of 4: single steps, 4-step bursts and ngram
    speculation (verify steps at S 4 over the windowed layers)."""
    jcfg, jparams, cfg, params = _both(TINY, seed=3)
    cfg_kw = dict(ENGINE, **overrides)
    prompts = (_repeats(4) if "spec_ngram_tokens" in overrides
               else _prompts(0, [5, 19, 33, 12]))
    stops = [dict(max_tokens=12, ignore_eos=True)] * len(prompts)
    want = await _jax_streams(jcfg, jparams, cfg_kw, prompts, stops)
    got = await _torch_streams(cfg, params, cfg_kw, prompts, stops)
    assert got == want
    assert all(len(t) == 12 and r == FinishReason.LENGTH.value for t, r in got)


@pytest.mark.asyncio
@pytest.mark.parametrize("seed", [1, 5, 8])
async def test_burst_stop_id_mid_burst_streams_as_single_steps(seed):
    """32 experts at top 4, decode batch 4: capacity 1, so a row's experts
    depend on the rows before it. The first request ends on a hidden stop id
    in the middle of a 4-step burst while the three after it go on: the
    finished row must be, for the rest of its burst, the pad single steps
    carry (no KV write, no expert slot), so K = 4 streams exactly as K = 1."""
    _, _, cfg, params = _both(TINY_CAP1, seed=seed)
    prompts = _prompts(seed + 1, [9, 6, 14, 11])
    free = [dict(max_tokens=16, ignore_eos=True)] * 4
    first, _ = (await _torch_streams(cfg, params, ENGINE, prompts, free))[0]
    # a stop id the first request samples at a step inside a burst (its
    # first token comes from the prefill, so stream index j is burst step
    # (j - 1) % 4) and not before
    j = next(j for j in range(2, 12)
             if (j - 1) % 4 != 3 and first[j] not in first[:j])
    stops = [dict(max_tokens=16, ignore_eos=True,
                  stop_token_ids_hidden=[first[j]])] + free[1:]
    single = await _torch_streams(cfg, params, ENGINE, prompts, stops)
    burst = await _torch_streams(cfg, params, dict(ENGINE, multi_step_decode=4),
                                 prompts, stops)
    assert single[0] == (first[:j + 1], FinishReason.STOP.value)
    assert [len(t) for t, _ in single[1:]] == [16, 16, 16]
    assert burst == single
