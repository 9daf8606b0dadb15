"""Differential tests of the port's Mixtral / Qwen3-MoE family against the
JAX package.

- ``mixtral.forward`` prefill and decode logits and caches against
  ``dynamo_tpu.models.mixtral.forward`` (the XLA route) in f32: a
  Mixtral-shaped config, a Qwen3-MoE-shaped one with per-head q/k norms in
  the tree (as its checkpoint loader adds them) and head_dim unlike
  hidden / heads, a capacity that drops tokens, and a batch with pad rows;
- whole-engine greedy streams against ``JaxServingEngine`` at K 1, at K 4
  and with ngram speculation;
- ``models.resolve`` tests ``num_experts`` before ``model_family``, as the
  reference does;
- the published Qwen3-30B-A3B and Mixtral-8x7B configs: both packages parse
  them alike, and the shapes ``init_params`` draws hold 30.53 B and 46.70 B
  parameters (counted without drawing them).

Tiny widths (the reference's own MoE tests: ``tests/test_moe.py`` and
``tests/test_qwen_moe.py``), f32, on the CPU.
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
from dynamo_tpu.models import mixtral as jax_mixtral
from dynamo_tpu.models import resolve as jax_resolve
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models import mixtral, resolve
from dynamo_tpu_torch.models.quant import QUANT_KEYS
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

# the reference's tiny Mixtral (tests/test_moe.py MOE_CFG) as a config.json
MIXTRAL = {
    "architectures": ["MixtralForCausalLM"], "vocab_size": 256,
    "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "num_local_experts": 4, "num_experts_per_tok": 2,
    "max_position_embeddings": 128, "rope_theta": 10000.0,
}
# the reference's tiny Qwen3-MoE (tests/test_qwen_moe.py), head_dim 16
# against hidden / heads = 8 (Qwen3-30B-A3B: 128 against 64)
QWEN3_MOE = {
    "architectures": ["Qwen3MoeForCausalLM"], "vocab_size": 256,
    "hidden_size": 32, "intermediate_size": 64, "moe_intermediate_size": 48,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "num_experts": 4,
    "num_experts_per_tok": 2, "norm_topk_prob": True,
    "max_position_embeddings": 128, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "tie_word_embeddings": False,
    "use_sliding_window": False, "decoder_sparse_step": 1,
    "mlp_only_layers": [],
}
BS, N_BLOCKS = 8, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(hf, **overrides):
    jcfg = dataclasses.replace(JaxModelConfig.from_hf_config(hf), **overrides)
    return jcfg, dataclasses.replace(ModelConfig.from_hf_config(hf), **overrides)


def _np_params(jcfg, seed, qk_norms):
    """The reference's init, leaves in numpy; with ``qk_norms`` seeded
    non-unit per-head q/k norms [L, head_dim], as the Qwen3-MoE loader adds
    them to the tree."""
    params = jax.device_get(jax_mixtral.init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    if qk_norms:
        rng = np.random.default_rng(seed + 1)
        shape = (jcfg.num_layers, jcfg.head_dim)
        params["layers"] = dict(params["layers"], **{
            name: (1.0 + 0.3 * rng.standard_normal(shape)).astype(np.float32)
            for name in ("q_norm", "k_norm")})
    return params


def _both(hf, seed=0, qk_norms=False, **overrides):
    """(jax cfg, jax params, port cfg, port params on the CPU in f32)."""
    jcfg, cfg = _configs(hf, **overrides)
    np_params = _np_params(jcfg, seed, qk_norms)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return jcfg, jparams, cfg, from_jax_params(np_params, cfg, "cpu", "float32")


def _steps(rows, rng, vocab):
    """A batched prefill of ``rows`` (prompt lengths; None a pad row: base
    0, ctx 1, block table 0, every slot dropped) in a 16-token bucket, then
    two decode steps of the same rows. Returns (block tables, steps of
    (tokens, positions, slots, ctx), valid positions per prefill row)."""
    b, bucket = len(rows), 16
    blocks = np.zeros((b, 4), np.int32)
    free = list(rng.permutation(N_BLOCKS - 1) + 1)
    for i, n in enumerate(rows):
        if n is not None:
            blocks[i] = [free.pop() for _ in range(4)]
    tokens = np.zeros((b, bucket), np.int32)
    positions = np.zeros((b, bucket), np.int32)
    slots = np.full((b, bucket), -1, np.int32)
    ctx = np.ones(b, np.int32)
    for i, n in enumerate(rows):
        if n is None:
            continue
        tokens[i, :n] = rng.integers(0, vocab, n)
        positions[i] = n - 1
        positions[i, :n] = np.arange(n)
        slots[i, :n] = blocks[i, np.arange(n) // BS] * BS + np.arange(n) % BS
        ctx[i] = n
    steps = [(tokens, positions, slots, ctx)]
    for j in range(2):
        tok = rng.integers(0, vocab, (b, 1)).astype(np.int32)
        pos = np.zeros((b, 1), np.int32)
        slot = np.full((b, 1), -1, np.int32)
        c = np.ones(b, np.int32)
        for i, n in enumerate(rows):
            if n is not None:
                p = n + j
                pos[i], c[i] = p, p + 1
                slot[i] = blocks[i, p // BS] * BS + p % BS
        steps.append((tok, pos, slot, c))
    return blocks, steps


def _forward_both(hf, rows, seed=1, qk_norms=False, **overrides):
    """The steps of ``_steps`` through both packages with identical
    weights: the logits of each, and both caches."""
    jcfg, jparams, cfg, params = _both(hf, seed, qk_norms, **overrides)
    jcfg = dataclasses.replace(jcfg, attention_impl="xla")
    jcache = jax_mixtral.init_kv_cache(jcfg, N_BLOCKS, BS, jnp.float32)
    cache = mixtral.init_kv_cache(cfg, N_BLOCKS, BS, torch.float32)
    blocks, steps = _steps(rows, np.random.default_rng(7), cfg.vocab_size)
    jl, tl = [], []
    for tok, pos, slot, ctx in steps:
        j, jcache = jax_mixtral.forward(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
            jnp.asarray(blocks), jnp.asarray(slot), jnp.asarray(ctx))
        jl.append(np.asarray(j))
        t, cache = mixtral.forward(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos), cache,
            torch.from_numpy(blocks), torch.from_numpy(slot),
            torch.from_numpy(ctx))
        tl.append(t.numpy())
    return jl, tl, jcache, cache, cfg


CASES = {
    # (config.json, prefill rows, q/k norms, ModelConfig overrides)
    "mixtral": (MIXTRAL, [13], False, {}),
    "qwen3_moe_qk_norms": (QWEN3_MOE, [13], True, {}),
    # 13 tokens x top 2 over 4 experts at capacity int(16 * 2 * 0.5 / 4) = 4
    "capacity_drops": (QWEN3_MOE, [13], True, dict(moe_capacity_factor=0.5)),
    "pad_rows": (MIXTRAL, [13, 6, None, None], False, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mixtral_forward_prefill_then_decode_matches_jax(case):
    """Logits of the prefill's valid positions and of two decode steps to
    1e-4, and both caches on every layer; pad rows claim no expert slot,
    so the real rows match the reference's."""
    hf, rows, qk_norms, overrides = CASES[case]
    jl, tl, jcache, cache, cfg = _forward_both(hf, rows, qk_norms=qk_norms,
                                               **overrides)
    live = [i for i, n in enumerate(rows) if n is not None]
    for i in live:
        np.testing.assert_allclose(tl[0][i, :rows[i]], jl[0][i, :rows[i]], **TOL)
        for t, j in zip(tl[1:], jl[1:]):
            np.testing.assert_allclose(t[i], j[i], **TOL)
    for t, j in zip(cache, jcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j)[..., :cfg.head_dim],
                                   **TOL)
    if case == "capacity_drops":
        # the drops change the answer: a roomy capacity gives other logits
        _, roomy, _, _, _ = _forward_both(hf, rows, qk_norms=True,
                                          moe_capacity_factor=8.0)
        assert np.abs(roomy[0][0, :13] - tl[0][0, :13]).max() > 1e-2
    if case == "qwen3_moe_qk_norms":
        # the norms take part: without them the logits move
        jcfg, cfg = _configs(hf)
        params = from_jax_params(_np_params(jcfg, 1, False), cfg, "cpu",
                                 "float32")
        blocks, steps = _steps(rows, np.random.default_rng(7), cfg.vocab_size)
        tok, pos, slot, ctx = (torch.from_numpy(a) for a in steps[0])
        plain, _ = mixtral.forward(
            params, cfg, tok, pos, mixtral.init_kv_cache(
                cfg, N_BLOCKS, BS, torch.float32),
            torch.from_numpy(blocks), slot, ctx)
        assert np.abs(plain.numpy()[0, :13] - tl[0][0, :13]).max() > 1e-2


def test_resolve_tests_experts_before_the_family_in_both_packages():
    """A config with both ``model_family="gemma2"`` and experts resolves to a
    module of the same name in both packages: mixtral, as the reference
    tests ``num_experts`` first; the module then refuses the family."""
    kw = dict(vocab_size=64, hidden_size=32, num_heads=2, num_kv_heads=1,
              num_experts=4, model_family="gemma2")
    got, want = resolve(ModelConfig(**kw)), jax_resolve(JaxModelConfig(**kw))
    assert got is mixtral
    assert got.__name__.rsplit(".", 1)[1] == want.__name__.rsplit(".", 1)[1]
    with pytest.raises(NotImplementedError, match="model family 'gemma2'"):
        mixtral.check_supported(ModelConfig(**kw))
    with pytest.raises(NotImplementedError, match="num_experts 0"):
        mixtral.check_supported(ModelConfig(vocab_size=64, hidden_size=32,
                                            num_heads=2, num_kv_heads=1))


@pytest.mark.parametrize("hf,norms", [(MIXTRAL, False), (QWEN3_MOE, True)],
                         ids=["mixtral", "qwen3_moe"])
def test_init_params_and_bridge_match_the_reference_tree(hf, norms):
    """The port's init draws the reference's names and shapes; the bridge
    carries a reference tree with and without the optional q/k norms, and
    refuses one that lacks a required leaf by name."""
    jcfg, cfg = _configs(hf)
    np_params = _np_params(jcfg, 0, norms)
    ours = mixtral.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32)
    flat = {f"layers.{k}": v for k, v in ours["layers"].items()}
    flat.update({k: v for k, v in ours.items() if k != "layers"})
    ref = {f"layers.{k}": v for k, v in np_params["layers"].items()
           if k not in ("q_norm", "k_norm")}
    ref.update({k: v for k, v in np_params.items() if k != "layers"})
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    bridged = from_jax_params(np_params, cfg)
    assert ("q_norm" in bridged["layers"]) == norms
    broken = dict(np_params, layers={k: v for k, v in np_params["layers"].items()
                                     if k != "router"})
    with pytest.raises(ValueError, match="layers.router"):
        from_jax_params(broken, cfg)


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


async def _streams(engine, req_cls, ctx_cls, stop_cls, samp_cls, prompts):
    """Greedy streams of ``prompts``, 12 tokens each, eos ignored; returns
    (tokens, finish reason) per request."""
    async def one(p):
        req = req_cls(token_ids=p,
                      stop_conditions=stop_cls(max_tokens=12, ignore_eos=True),
                      sampling_options=samp_cls(temperature=0.0))
        toks, reasons = [], []
        async for out in engine.generate(ctx_cls(req)):
            toks.extend(out["token_ids"])
            reasons.append(out.get("finish_reason"))
        return toks, reasons[-1]
    try:
        return await asyncio.gather(*(one(p) for p in prompts))
    finally:
        await engine.close()


@pytest.mark.asyncio
@pytest.mark.parametrize("model,overrides", [
    ("mixtral", {}),
    ("qwen3_moe", {}),
    ("qwen3_moe", dict(multi_step_decode=4)),
    ("qwen3_moe", dict(spec_ngram_tokens=3, spec_ngram_match=2)),
], ids=["mixtral_k1", "qwen3_moe_k1", "qwen3_moe_burst4",
        "qwen3_moe_ngram_spec"])
async def test_mixtral_greedy_streams_match_jax_engine(model, overrides):
    """Greedy streams of the Mixtral-family engine against the reference's:
    single steps, 4-step bursts and ngram speculation (verify steps at
    S 4), the Qwen3-MoE trunk with its q/k norms."""
    hf = MIXTRAL if model == "mixtral" else QWEN3_MOE
    jcfg, jparams, cfg, params = _both(hf, seed=3, qk_norms=model != "mixtral")
    cfg_kw = dict(ENGINE, **overrides)
    prompts = (_repeats(4) if "spec_ngram_tokens" in overrides
               else _prompts(0, [5, 19, 33, 12]))
    jengine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None),
        engine_config=JaxEngineConfig(model=jcfg, **cfg_kw), params=jparams,
        warmup=False)
    want = await _streams(jengine, JaxRequest, JaxContext, JaxStop, JaxSampling,
                          prompts)
    engine = await TorchServingEngine.create(
        EngineConfig(model=cfg, **cfg_kw), params=params, device="cpu",
        warmup=False)
    got = await _streams(engine, PreprocessedRequest, Context, StopConditions,
                         SamplingOptions, prompts)
    assert got == want
    assert all(len(t) == 12 and r == FinishReason.LENGTH.value for t, r in got)


# the published config.json values (the fields the engine reads)
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe",
    "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 6144,
    "moe_intermediate_size": 768, "num_hidden_layers": 48,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "num_experts": 128, "num_experts_per_tok": 8, "norm_topk_prob": True,
    "decoder_sparse_step": 1, "mlp_only_layers": [],
    "max_position_embeddings": 40960, "rope_theta": 1000000.0,
    "rope_scaling": None, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
    "attention_bias": False, "sliding_window": None,
    "use_sliding_window": False,
}
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "max_position_embeddings": 32768,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-5, "sliding_window": None,
    "tie_word_embeddings": False,
}


@pytest.mark.parametrize("hf,want,int8_gb", [
    (QWEN3_30B_A3B, 30_532_110_336, None),
    (MIXTRAL_8X7B, 46_702_792_704, (46.4, 47.0)),
], ids=["qwen3_30b_a3b", "mixtral_8x7b"])
def test_published_moe_configs_parse_to_their_parameter_counts(hf, want,
                                                               int8_gb):
    """Both packages parse the published config alike, the family resolves
    to mixtral, and the shapes ``init_params`` draws (counted through the
    reference's ``jax.eval_shape``, never drawn; the port draws the same
    names and shapes, as the tiny test above holds) hold 30.53 B
    (Qwen3-30B-A3B, 61 GB in bf16) and 46.70 B parameters (Mixtral-8x7B:
    93 GB in bf16, about 46.7 GB in int8 with its f32 scales, which fits
    one 80 GB card)."""
    jcfg, cfg = _configs(hf)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert resolve(cfg) is mixtral
    assert (cfg.head_dim, cfg.sliding_window, cfg.num_heads // cfg.num_kv_heads) \
        == (128, 0, 8 if hf is QWEN3_30B_A3B else 4)
    shapes = jax.eval_shape(lambda: jax_mixtral.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert n == want
    assert set(shapes["layers"]) == mixtral.param_keys(cfg)["layers"]
    if int8_gb:
        leaves = dict(shapes["layers"], lm_head=shapes["lm_head"],
                      embed=shapes["embed"], final_norm=shapes["final_norm"])
        nbytes = sum(
            int(np.prod(a.shape)) + 4 * int(np.prod(a.shape[:-2] + a.shape[-1:]))
            if k in QUANT_KEYS else 2 * int(np.prod(a.shape))
            for k, a in leaves.items())
        assert int8_gb[0] <= nbytes / 1e9 <= int8_gb[1]
