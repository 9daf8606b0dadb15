"""Differential tests of the port's DeepSeek MLA path against the JAX
package: yarn rope and the MLA softmax scale, the MLA decode kernel's plain
version (against the Pallas kernel in interpret mode and the reference's
gather formulation), the attention dispatch, the whole model (dense prefix
+ routed MoE with a shared expert) and whole-engine greedy streams.

Tiny widths: 3 layers (1 dense + 2 MoE), hidden 64, 4 heads, kv_lora_rank
16, rope dims 8, 4 experts top-2 with 1 shared expert, block size 8, vocab
256; inputs made from a seed with numpy and handed to both packages, f32.
The reference pads its caches' R and RD to 128 lanes; the port's are
unpadded, so caches are compared on the reference's first R / RD lanes.
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
from dynamo_tpu.models import deepseek as jax_deepseek
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.ops.pallas_decode import mla_paged_decode_attention as jax_mla_kernel
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models import deepseek, gemma2, gptoss, llama, mixtral, resolve
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import mla_decode
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

YARN = {"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64,
        "beta_fast": 32, "beta_slow": 1, "mscale": 1.0, "mscale_all_dim": 0.707}
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=3,
            num_heads=4, num_kv_heads=4, head_dim=16, kv_lora_rank=16,
            qk_rope_head_dim=8, qk_nope_head_dim=12, v_head_dim=12,
            num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
            n_shared_experts=1, first_k_dense_replace=1, norm_topk_prob=False,
            routed_scaling_factor=1.5, rope_scaling=YARN,
            max_position_embeddings=256)
BS, N_BLOCKS = 8, 16
TOL = dict(rtol=1e-4, atol=1e-4)
OP_TOL = dict(rtol=1e-5, atol=1e-5)

# DeepSeek-V2-Lite's published rope_scaling (config.json)
V2_LITE_YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                "mscale_all_dim": 0.707}


@pytest.mark.parametrize("dim,theta,scaling", [
    (64, 10000.0, V2_LITE_YARN),
    (64, 10000.0, dict(V2_LITE_YARN, mscale=1.0)),           # ratio != 1
    (64, 10000.0, {"rope_type": "yarn", "factor": 8.0}),      # no mscale keys
    (8, 10000.0, YARN),
    (32, 1e6, {"type": "yarn", "factor": 4.0, "attention_factor": 0.8,
               "original_max_position_embeddings": 2048, "beta_fast": 8}),
    (16, 10000.0, {"type": "yarn", "factor": 2.0, "beta_fast": 4096,
                   "beta_slow": 4096, "original_max_position_embeddings": 64}),
], ids=["v2_lite", "mscale_ratio", "plain_mscale", "tiny", "attention_factor",
        "zero_width_ramp"])
def test_yarn_rope_and_mla_scale_match_jax(dim, theta, scaling):
    jf, ja = jax_llama.rope_frequencies(dim, theta, scaling)
    tf, ta = llama.rope_frequencies(dim, theta, scaling)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-6)
    assert abs(ta - ja) <= 1e-6
    kw = dict(TINY, qk_rope_head_dim=dim, rope_theta=theta, rope_scaling=scaling)
    want = jax_deepseek.mla_softmax_scale(JaxModelConfig(**kw))
    assert abs(deepseek.mla_softmax_scale(ModelConfig(**kw)) - want) <= 1e-6 * want


def test_v2_lite_scale_values():
    """192^-0.5 * mscale(40, 0.707)^2 on the whole score; cos/sin factor 1."""
    cfg = ModelConfig(**dict(TINY, qk_nope_head_dim=128, qk_rope_head_dim=64,
                             rope_scaling=V2_LITE_YARN))
    assert abs(deepseek.mla_softmax_scale(cfg) - 0.11472) < 1e-5
    assert llama.rope_frequencies(64, 10000.0, V2_LITE_YARN)[1] == 1.0


def _caches(rng, layers, n, r, rd):
    return (rng.standard_normal((layers, n, BS, 1, r)).astype(np.float32),
            rng.standard_normal((layers, n, BS, 1, rd)).astype(np.float32))


@pytest.mark.parametrize("layer", [1, 2])
def test_mla_decode_plain_version_matches_pallas_kernel(layer):
    """The plain version against the Pallas MLA decode kernel in interpret
    mode (as tests/test_pallas_decode.py runs it) and the reference's gather
    formulation: ragged contexts across page edges, a row at ctx 1, a
    layer other than 0."""
    rng = np.random.default_rng(layer)
    layers, b, h, r, rd, w = 3, 5, 4, 16, 8, 6
    n = b * w + 2
    q_lat = rng.standard_normal((b, 1, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((b, 1, h, rd)).astype(np.float32)
    c, kr = _caches(rng, layers, n, r, rd)
    bt = rng.permutation(n)[: b * w].reshape(b, w).astype(np.int32)
    ctx = np.array([1, 7, 8, 9, 48], np.int32)
    scale = 0.3
    got = mla_decode.mla_paged_decode_attention(
        torch.from_numpy(q_lat), torch.from_numpy(q_rope), torch.from_numpy(c),
        torch.from_numpy(kr), torch.from_numpy(bt), torch.from_numpy(ctx),
        layer_idx=layer, scale=scale).numpy()
    kern = jax_mla_kernel(
        jnp.asarray(q_lat), jnp.asarray(q_rope), jnp.asarray(c), jnp.asarray(kr),
        jnp.asarray(bt), jnp.asarray(ctx), layer_idx=jnp.int32(layer),
        scale=scale, pages_per_chunk=2, interpret=True)
    gather = jax_deepseek.mla_paged_attention(
        jnp.asarray(q_lat), jnp.asarray(q_rope), jnp.asarray(c[layer]),
        jnp.asarray(kr[layer]), jnp.asarray(bt), jnp.asarray(ctx - 1)[:, None],
        jnp.asarray(ctx), scale)
    np.testing.assert_allclose(got, np.asarray(kern), **OP_TOL)
    np.testing.assert_allclose(got, np.asarray(gather), **OP_TOL)
    # the ctx-1 row attends to its one key: the output is that key's latent
    np.testing.assert_allclose(
        got[0, 0], np.broadcast_to(c[layer, bt[0, 0], 0, 0], (h, r)), **OP_TOL)


def test_mla_decode_plain_version_zero_context_row():
    """A row with no key outputs zeros (the kernel's l == 0 guard)."""
    rng = np.random.default_rng(3)
    c, kr = _caches(rng, 2, 4, 16, 8)
    out = mla_decode.mla_paged_decode_attention_ref(
        torch.randn(2, 1, 4, 16), torch.randn(2, 1, 4, 8), torch.from_numpy(c),
        torch.from_numpy(kr), torch.tensor([[0, 1], [2, 3]]),
        torch.tensor([0, 5]), layer_idx=1, scale=0.5)
    assert not out[0].any() and out[1].abs().sum() > 0


@pytest.mark.parametrize("s", [1, 5])
def test_mla_attention_dispatch_matches_jax(s):
    """deepseek.mla_attention over the stacked caches at layer 2: decode
    (S 1) and a verify-shaped S 5 with rows at their own positions."""
    rng = np.random.default_rng(10 + s)
    layers, b, h, r, rd, w = 3, 3, 4, 16, 8, 5
    n = b * w + 1
    q_lat = rng.standard_normal((b, s, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((b, s, h, rd)).astype(np.float32)
    c, kr = _caches(rng, layers, n, r, rd)
    bt = rng.permutation(n)[: b * w].reshape(b, w).astype(np.int32)
    ctx = np.array([s, 17, 40], np.int32)
    positions = (ctx - s)[:, None] + np.arange(s)[None, :]
    want = jax_deepseek.mla_attention(
        jnp.asarray(q_lat), jnp.asarray(q_rope), jnp.asarray(c), jnp.asarray(kr),
        2, jnp.asarray(bt), jnp.asarray(positions), jnp.asarray(ctx), 0.4)
    got = deepseek.mla_attention(
        torch.from_numpy(q_lat), torch.from_numpy(q_rope), torch.from_numpy(c),
        torch.from_numpy(kr), 2, torch.from_numpy(bt), torch.from_numpy(positions),
        torch.from_numpy(ctx), 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def _jax_params(kw, seed=0):
    jcfg = JaxModelConfig(**kw)
    return jcfg, jax_deepseek.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)


@pytest.mark.parametrize("extra", [{}, {"q_lora_rank": 12},
                                   {"num_experts": 0, "num_layers": 2}],
                         ids=["v2_lite_shape", "q_lora", "dense_only"])
def test_deepseek_forward_prefill_then_decode_matches_jax(extra):
    """A padded prefill of 11 tokens, then two decode steps, through both
    packages with identical weights: logits to 1e-4, and both caches on
    every layer (an off-by-first_k_dense_replace layer index would write
    the MoE layers' latents over the dense layer's)."""
    kw = dict(TINY, **extra)
    jcfg, jparams = _jax_params(kw)
    cfg = ModelConfig(**kw)
    params = from_jax_params(jax.device_get(jparams), cfg, "cpu", "float32")
    assert ("layers" in params) == bool(cfg.num_experts)
    jcache = jax_deepseek.init_kv_cache(jcfg, N_BLOCKS, BS, jnp.float32)
    cache = deepseek.init_kv_cache(cfg, N_BLOCKS, BS, torch.float32)
    assert cache[0].shape == (cfg.num_layers, N_BLOCKS, BS, 1, 16)
    assert cache[1].shape == (cfg.num_layers, N_BLOCKS, BS, 1, 8)

    rng = np.random.default_rng(7)
    n, bucket = 11, 16
    blocks = np.array([[5, 2, 9, 0]], np.int32)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = rng.integers(0, 256, n)
    positions = np.full((1, bucket), n - 1, np.int32)
    positions[0, :n] = np.arange(n)
    slots = np.full((1, bucket), -1, np.int32)
    slots[0, :n] = blocks[0, np.arange(n) // BS] * BS + np.arange(n) % BS

    def run(tok, pos, slot, ctx):
        nonlocal jcache, cache
        jl, jcache = jax_deepseek.forward(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
            jnp.asarray(blocks), jnp.asarray(slot), jnp.asarray(ctx))
        tl, cache = deepseek.forward(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos), cache,
            torch.from_numpy(blocks), torch.from_numpy(slot), torch.from_numpy(ctx))
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
    np.testing.assert_allclose(cache[0].numpy(), np.asarray(jcache[0])[..., :16], **TOL)
    np.testing.assert_allclose(cache[1].numpy(), np.asarray(jcache[1])[..., :8], **TOL)
    assert all(cache[0][li].abs().sum() > 0 for li in range(cfg.num_layers))


def test_resolve_and_weight_bridge_checks():
    cfg = ModelConfig(**TINY)
    assert resolve(cfg) is deepseek
    assert resolve(ModelConfig(vocab_size=64, hidden_size=32, num_heads=2,
                               num_kv_heads=1)) is llama
    assert resolve(ModelConfig(vocab_size=64, hidden_size=32, num_heads=2,
                               num_kv_heads=1, num_experts=4)) is mixtral
    assert resolve(ModelConfig(vocab_size=64, hidden_size=32, num_heads=2,
                               num_kv_heads=1, model_family="gemma2")) is gemma2
    assert resolve(ModelConfig(vocab_size=64, hidden_size=32, num_heads=2,
                               num_kv_heads=1, model_family="gptoss",
                               num_experts=4)) is gptoss
    _, jparams = _jax_params(TINY)
    np_params = jax.device_get(jparams)
    broken = dict(np_params, layers={k: v for k, v in np_params["layers"].items()
                                     if k != "w_sh_gate"})
    with pytest.raises(ValueError, match="layers.w_sh_gate"):
        from_jax_params(broken, cfg)
    with pytest.raises(ValueError, match="dense_layers"):
        from_jax_params({k: v for k, v in np_params.items() if k != "dense_layers"}, cfg)
    with pytest.raises(ValueError, match="layers.w_uq"):
        # a q_lora config needs w_dq / ln_q / w_uq where this tree has wq
        from_jax_params(np_params, dataclasses.replace(cfg, q_lora_rank=12))


ENGINE = dict(max_batch_size=4, max_model_len=128, kv_block_size=BS,
              num_kv_blocks=64, dtype="float32")


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, 256, n)] for n in lengths]


async def _jax_streams(jparams, cfg_kw, batches, max_tokens):
    cfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **cfg_kw)
    engine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=cfg,
        params=jparams, warmup=False)

    async def one(p):
        req = JaxRequest(token_ids=p, stop_conditions=JaxStop(
            max_tokens=max_tokens, ignore_eos=True),
            sampling_options=JaxSampling(temperature=0.0))
        toks = []
        async for out in engine.generate(JaxContext(req)):
            toks.extend(out["token_ids"])
        return toks

    try:
        return [await asyncio.gather(*(one(p) for p in batch)) for batch in batches]
    finally:
        await engine.close()


async def _torch_streams(params, cfg_kw, batches, max_tokens):
    cfg = EngineConfig(model=ModelConfig(**TINY), **cfg_kw)
    engine = await TorchServingEngine.create(cfg, params=params, device="cpu",
                                             warmup=False)

    async def one(p):
        req = PreprocessedRequest(
            token_ids=p, stop_conditions=StopConditions(max_tokens=max_tokens,
                                                        ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0))
        toks, reasons = [], []
        async for out in engine.generate(Context(req)):
            toks.extend(out["token_ids"])
            reasons.append(out.get("finish_reason"))
        assert reasons[-1] == FinishReason.LENGTH.value
        return toks

    try:
        streams = [await asyncio.gather(*(one(p) for p in batch)) for batch in batches]
        return streams, engine.metrics()
    finally:
        await engine.close()


def _waves():
    first = _prompts(0, [5, 19, 33, 12])
    return [first, [first[2][:24] + [7, 8, 9], first[2]]]


@pytest.mark.asyncio
@pytest.mark.parametrize("overrides", [
    {},
    # a 16-token budget chunks the prompts; 4-step decode bursts
    dict(max_prefill_tokens_per_step=16, prefill_buckets=[8, 16, 32, 64, 128],
         multi_step_decode=4),
], ids=["batched_prefix_hit", "chunked_burst4"])
async def test_deepseek_greedy_streams_match_jax_engine(overrides):
    """Greedy streams of the MLA + MoE engine: concurrent prompts in one
    prefill batch, then a prefix-hit wave — the decode steps route at a
    batch of 4 rows with capacity int(4 * 2 * 2 / 4) = 4, the prefill
    steps over padded rows, both as the reference does."""
    cfg_kw = dict(ENGINE, **overrides)
    _, jparams = _jax_params(TINY, seed=3)
    params = from_jax_params(jax.device_get(jparams), ModelConfig(**TINY),
                             "cpu", "float32")
    batches = _waves()
    want = await _jax_streams(jparams, cfg_kw, batches, 8)
    got, metrics = await _torch_streams(params, cfg_kw, batches, 8)
    assert got == want
    assert all(len(s) == 8 for batch in got for s in batch)
    assert metrics["gpu_prefix_cache_hit_rate"] > 0


@pytest.mark.asyncio
async def test_capacity_one_decode_parts_twins_as_the_reference_does():
    """32 experts, top 4, decode batch 4: capacity int(4 * 4 * 2 / 32) = 1
    (DeepSeek-V2-Lite at batch 8 has the same capacity). Two identical
    prompts in one wave collide on every routed expert and the second
    loses them all, so the twins part; the port parts them exactly as the
    reference does."""
    kw = dict(TINY, num_experts=32, num_experts_per_tok=4, moe_intermediate_size=8)
    jcfg, jparams = _jax_params(kw, seed=5)
    cfg = ModelConfig(**kw)
    params = from_jax_params(jax.device_get(jparams), cfg, "cpu", "float32")
    twin = _prompts(6, [9])[0]
    batch = [twin, twin] + _prompts(7, [14, 5])
    jeng = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None),
        engine_config=JaxEngineConfig(model=jcfg, **ENGINE), params=jparams,
        warmup=False)
    teng = await TorchServingEngine.create(
        EngineConfig(model=cfg, **ENGINE), params=params, device="cpu",
        warmup=False)

    async def streams(engine, req_cls, ctx_cls, stop_cls, samp_cls):
        async def one(p):
            req = req_cls(token_ids=p, stop_conditions=stop_cls(
                max_tokens=10, ignore_eos=True),
                sampling_options=samp_cls(temperature=0.0))
            toks = []
            async for out in engine.generate(ctx_cls(req)):
                toks.extend(out["token_ids"])
            return toks
        try:
            return await asyncio.gather(*(one(p) for p in batch))
        finally:
            await engine.close()

    want = await streams(jeng, JaxRequest, JaxContext, JaxStop, JaxSampling)
    got = await streams(teng, PreprocessedRequest, Context, StopConditions,
                        SamplingOptions)
    assert got == want
    assert got[0] != got[1]


@pytest.mark.asyncio
@pytest.mark.parametrize("seed", [5, 8, 11])
async def test_capacity_one_bursts_stream_as_single_steps(seed):
    """32 experts, top 4, decode batch 4: capacity 1, so a row's experts
    depend on the rows before it. The first two requests end early and
    ride the later bursts as inactive rows ahead of the live ones: a K = 4
    burst streams every request as K = 1 single steps do, because its
    inactive rows stay the pads the single steps carry."""
    kw = dict(TINY, num_experts=32, num_experts_per_tok=4, moe_intermediate_size=8)
    _, jparams = _jax_params(kw, seed=seed)
    cfg = ModelConfig(**kw)
    params = from_jax_params(jax.device_get(jparams), cfg, "cpu", "float32")
    prompts = _prompts(seed + 1, [9, 6, 14, 11])
    max_tokens = [2, 5, 16, 16]

    async def streams(**over):
        eng = await TorchServingEngine.create(
            EngineConfig(model=cfg, **dict(ENGINE, **over)), params=params,
            device="cpu", warmup=False)

        async def one(p, n):
            req = PreprocessedRequest(
                token_ids=p, stop_conditions=StopConditions(max_tokens=n,
                                                            ignore_eos=True),
                sampling_options=SamplingOptions(temperature=0.0))
            toks = []
            async for out in eng.generate(Context(req)):
                toks.extend(out["token_ids"])
            return toks
        try:
            return await asyncio.gather(*(one(p, n) for p, n in zip(prompts, max_tokens)))
        finally:
            await eng.close()

    single = await streams()
    burst = await streams(multi_step_decode=4)
    assert [len(s) for s in single] == max_tokens
    assert burst == single


def test_runner_serves_mla_and_refuses_other_moe_families():
    """The runner resolves the family: MLA + MoE builds its own params and
    unpadded cache; a Mixtral-style MoE config builds the mixtral family,
    whose module refuses the MLA config."""
    cfg = EngineConfig(model=ModelConfig(**TINY), **ENGINE)
    runner = ModelRunner(cfg, device="cpu")
    assert runner.arch is deepseek
    assert set(runner.params) == {"embed", "final_norm", "lm_head",
                                  "dense_layers", "layers"}
    assert runner.kv_cache[1].shape == (3, 64, BS, 1, 8)
    mix = dataclasses.replace(cfg, model=ModelConfig(
        vocab_size=64, hidden_size=32, num_heads=2, num_kv_heads=1,
        num_experts=4))
    assert ModelRunner(mix, device="cpu").arch is mixtral
    with pytest.raises(NotImplementedError, match="MLA attention"):
        mixtral.check_supported(cfg.model)
