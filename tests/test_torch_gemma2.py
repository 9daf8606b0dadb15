"""Differential tests of the port's Gemma-2 family against the JAX package.

- ``rms_norm`` (the ``1 + w`` form), ``embed_tokens`` (the sqrt(hidden)
  factor rounded to bf16 first) and the GeGLU MLP against the reference's
  functions;
- ``gemma2.forward`` prefill and decode logits and caches against
  ``dynamo_tpu.models.gemma2.forward`` (the XLA route) in f32, at head_dim
  32 and 256, ``query_pre_attn_scalar`` unlike head_dim, a window shorter
  than the prompt, non-zero norms, and a case whose caps bind;
- the plain attention with a softcap (decode S 1, verify S 5 and 17,
  flash S 64) against the reference's Pallas kernels in interpret mode,
  at head_dim 32 and 256, with a cap that binds;
- whole-engine greedy streams against ``JaxServingEngine`` at K 1, at K 4
  and with ngram speculation;
- the weight bridge's gemma2 leaves, ``models.resolve`` and the published
  gemma-2-9b config (9,241,705,984 parameters).

Tiny widths (the reference's own Gemma-2 test: 4 layers, hidden 64, 4
heads over 2 KV heads), f32, on the CPU. The reference inits every norm
to 0, so ``1 + w`` would go untested: the tests draw the norms non-zero.
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
from dynamo_tpu.models import gemma2 as jax_gemma2
from dynamo_tpu.ops.pallas_attention import paged_flash_attention as jax_flash
from dynamo_tpu.ops.pallas_decode import paged_decode_attention as jax_decode
from dynamo_tpu.ops.pallas_decode import paged_verify_attention as jax_verify
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models import gemma2, llama, mixtral, resolve
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import paged_decode, paged_flash, paged_verify
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

# the reference's tiny Gemma-2 (tests/test_gemma2.py) as a config.json,
# with query_pre_attn_scalar 24 against head_dim 32 (gemma-2-27b's 144
# against 128: at 9b the two are equal and a wrong scale would not show)
TINY = {
    "architectures": ["Gemma2ForCausalLM"], "vocab_size": 256,
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 4,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
    "max_position_embeddings": 256, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "query_pre_attn_scalar": 24, "sliding_window": 6,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
}
# gemma-2-9b's attention form: head_dim 256, G 2
TINY_D256 = dict(TINY, num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=1, head_dim=256, query_pre_attn_scalar=144)
# caps small enough to bind at these widths (scores and logits are O(1))
TINY_CAP = dict(TINY, attn_logit_softcapping=2.0, final_logit_softcapping=1.5)
BS, N_BLOCKS = 8, 16
TOL = dict(rtol=1e-4, atol=1e-4)
OP_TOL = dict(rtol=1e-5, atol=1e-5)
NORMS = ("ln1", "ln_post_attn", "ln_pre_mlp", "ln_post_mlp")


def _configs(hf):
    return JaxModelConfig.from_hf_config(hf), ModelConfig.from_hf_config(hf)


def _np_params(jcfg, seed):
    """The reference's init, leaves in numpy, with every norm drawn
    non-zero from the seed."""
    params = jax.device_get(jax_gemma2.init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for name in NORMS:
        layers[name] = rng.normal(0.0, 0.3, layers[name].shape).astype(np.float32)
    final = rng.normal(0.0, 0.3, params["final_norm"].shape).astype(np.float32)
    return dict(params, layers=layers, final_norm=final)


def _both(hf, seed=0):
    """(jax cfg, jax params, port cfg, port params on the CPU in f32)."""
    jcfg, cfg = _configs(hf)
    np_params = _np_params(jcfg, seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return jcfg, jparams, cfg, from_jax_params(np_params, cfg, "cpu", "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_embed_and_mlp_match_jax(dtype):
    """The (1 + w) norm, the scaled embedding (hidden 3584 as gemma-2-9b:
    sqrt 59.87 rounds to 59.75 in bf16) and the GeGLU MLP."""
    rng = np.random.default_rng(3)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = rng.normal(0.0, 0.3, 48).astype(np.float32)
    # f32 compute in both, the sums in their own order: an f32 ulp, or a
    # bf16 ulp where that rounds the other way
    tol = dict(rtol=2 ** -8, atol=0) if dtype == "bfloat16" else OP_TOL
    want = jax_gemma2.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-6)
    got = gemma2.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), 1e-6)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)

    emb = rng.standard_normal((16, 3584)).astype(np.float32)
    tokens = np.array([[3, 0, 15], [7, 7, 1]], np.int32)
    want = jax_gemma2.embed_tokens({"embed": jnp.asarray(emb, jd)}, jnp.asarray(tokens))
    got = gemma2.embed_tokens({"embed": torch.from_numpy(emb).to(td)},
                              torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(),
                                      (torch.from_numpy(emb).to(td)[tokens].float()
                                       * 59.75).to(td).float().numpy())

    lp = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for k, s in (("w_gate", (48, 96)), ("w_up", (48, 96)),
                       ("w_down", (96, 48)))}
    want = jax_gemma2.mlp_fn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()})
    got = gemma2.mlp(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in lp.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def _forward_both(hf, seed, caps=True):
    """A padded prefill of 13 tokens (past the window of 6), then two
    decode steps, through both packages with identical weights: the logits
    of each, and both caches. ``caps=False`` runs the port alone with both
    caps off."""
    jcfg, jparams, cfg, params = _both(hf, seed)
    jcfg = dataclasses.replace(jcfg, attention_impl="xla")
    if not caps:
        cfg = dataclasses.replace(cfg, attn_logit_softcap=0.0,
                                  final_logit_softcap=0.0)
    jcache = jax_gemma2.init_kv_cache(jcfg, N_BLOCKS, BS, jnp.float32)
    cache = gemma2.init_kv_cache(cfg, N_BLOCKS, BS, torch.float32)
    rng = np.random.default_rng(7)
    n, bucket = 13, 16
    blocks = np.array([[5, 2, 9, 0]], np.int32)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = rng.integers(0, 256, n)
    positions = np.full((1, bucket), n - 1, np.int32)
    positions[0, :n] = np.arange(n)
    slots = np.full((1, bucket), -1, np.int32)
    slots[0, :n] = blocks[0, np.arange(n) // BS] * BS + np.arange(n) % BS
    decode = [(np.array([[int(rng.integers(0, 256))]], np.int32), n + i)
              for i in range(2)]
    steps = [(tokens, positions, slots, np.array([n], np.int32))] + [
        (t, np.array([[p]], np.int32),
         np.array([[blocks[0, p // BS] * BS + p % BS]], np.int32),
         np.array([p + 1], np.int32)) for t, p in decode]
    jl, tl = [], []
    for tok, pos, slot, ctx in steps:
        if caps:
            j, jcache = jax_gemma2.forward(
                jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
                jnp.asarray(blocks), jnp.asarray(slot), jnp.asarray(ctx))
            jl.append(np.asarray(j))
        t, cache = gemma2.forward(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos), cache,
            torch.from_numpy(blocks), torch.from_numpy(slot),
            torch.from_numpy(ctx))
        tl.append(t.numpy())
    return jl, tl, jcache, cache, cfg


@pytest.mark.parametrize("hf", [TINY, TINY_D256, TINY_CAP],
                         ids=["d32", "d256", "binding_caps"])
def test_gemma2_forward_prefill_then_decode_matches_jax(hf):
    """Logits of the prefill's valid positions and of two decode steps to
    1e-4, and both caches on every layer. With the binding caps the
    logits stay within ±1.5 and differ from the uncapped forward's."""
    jl, tl, jcache, cache, cfg = _forward_both(hf, seed=1)
    np.testing.assert_allclose(tl[0][0, :13], jl[0][0, :13], **TOL)
    for t, j in zip(tl[1:], jl[1:]):
        np.testing.assert_allclose(t, j, **TOL)
    for t, j in zip(cache, jcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j)[..., :cfg.head_dim], **TOL)
    if hf is TINY_CAP:
        assert max(abs(x).max() for x in tl) <= 1.5
        _, free, _, _, _ = _forward_both(hf, seed=1, caps=False)
        rel = np.linalg.norm(free[0][0, :13] - tl[0][0, :13]) / np.linalg.norm(tl[0][0, :13])
        assert rel > 0.2


@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("case", ["decode_s1", "verify_s5", "verify_s17",
                                  "flash_s64"])
def test_softcap_attention_plain_version_matches_pallas_interpret(case, d):
    """The plain versions with a softcap of 2 (it binds: scores are
    ~N(0, 2^2)), a window and a scale unlike head_dim^-0.5 against the
    reference's Pallas kernels in interpret mode, at G 2 (4 heads over 2
    KV heads): ragged contexts, a ctx-0 decode row, a verify pad row (base
    0, ctx 1, table 0), a flash prefix hit."""
    rng = np.random.default_rng(len(case) + d)
    h, kvh, layers, li, cap = 4, 2, 3, 1, 2.0
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
    scale = 2.0 / np.sqrt(d)
    window = 6
    jargs = [jnp.asarray(a) for a in (q, k, v, bt)]
    targs = [torch.from_numpy(a) for a in (q, k, v, bt)]
    common = dict(layer_idx=li, window=window, scale=scale)
    if kind == "decode":
        want = jax_decode(*jargs, jnp.asarray(ctx), layer_idx=jnp.int32(li),
                          interpret=True, window=window, softcap=cap, scale=scale)

        def port(c):
            return paged_decode.paged_decode_attention(
                *targs, torch.from_numpy(ctx), softcap=c, **common)
    else:
        jfn = jax_verify if kind == "verify" else jax_flash
        extra = {} if kind == "verify" else dict(q_chunk=16)
        want = jfn(*jargs, jnp.asarray(base), jnp.asarray(ctx),
                   layer_idx=jnp.int32(li), interpret=True, window=window,
                   softcap=cap, scale=scale, **extra)
        fn = (paged_verify.paged_verify_attention if kind == "verify"
              else paged_flash.paged_flash_attention)

        def port(c):
            return fn(*targs, torch.from_numpy(base), torch.from_numpy(ctx),
                      softcap=c, **common)
    want, got, free = np.asarray(want), port(cap).numpy(), port(0.0).numpy()
    if kind == "decode":
        assert not got[0].any()  # the ctx-0 row is zeros on both sides
    gap = 0.0
    for i in range(b):
        valid = max(0, min(s, ctx[i] - base[i])) if kind != "decode" else 1
        np.testing.assert_allclose(got[i, :valid], want[i, :valid], **OP_TOL)
        if valid:
            gap = max(gap, np.abs(got[i, :valid] - free[i, :valid]).max())
    assert gap > 0.05  # the cap changes the answer
    assert paged_decode.launches == paged_verify.launches == paged_flash.launches == 0


def test_alternating_window_and_resolve():
    """Even layers windowed, odd ones not; gemma2 resolves to the new
    module, a Mixtral-style MoE config to mixtral, and the gemma2 module
    refuses experts by name."""
    _, cfg = _configs(TINY)
    assert [llama.alternating_window(cfg, li) for li in range(4)] == [6, None, 6, None]
    assert resolve(cfg) is gemma2
    assert resolve(ModelConfig(vocab_size=64, hidden_size=32, num_heads=2,
                               num_kv_heads=1, num_experts=4)) is mixtral
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        gemma2.check_supported(dataclasses.replace(cfg, num_experts=4))


@pytest.mark.parametrize("name", sorted(gemma2._LAYER_KEYS) + ["embed", "final_norm"])
def test_weight_bridge_needs_every_gemma2_leaf(name):
    jcfg, cfg = _configs(TINY)
    np_params = _np_params(jcfg, 1)
    if name in np_params:
        broken = {k: v for k, v in np_params.items() if k != name}
        want = name
    else:
        broken = dict(np_params, layers={k: v for k, v in np_params["layers"].items()
                                         if k != name})
        want = f"layers.{name}"
    with pytest.raises(ValueError, match=want):
        from_jax_params(broken, cfg)
    assert set(from_jax_params(np_params, cfg)["layers"]) == gemma2._LAYER_KEYS


# gemma-2-9b's published config.json (the fields the engine reads)
GEMMA_2_9B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "vocab_size": 256000, "hidden_size": 3584, "intermediate_size": 14336,
    "num_hidden_layers": 42, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256,
    "max_position_embeddings": 8192, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "sliding_window": 4096,
    "query_pre_attn_scalar": 256, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "hidden_activation": "gelu_pytorch_tanh",
    "attention_bias": False,
}


def test_gemma_2_9b_config_parses_to_9_24b_parameters():
    """Both packages parse the published config alike; its leaves hold
    9,241,705,984 parameters (18.48 GB in bf16), counted from the
    reference's shapes without drawing them."""
    jcfg, cfg = _configs(GEMMA_2_9B)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.model_family, cfg.head_dim, cfg.sliding_window,
            cfg.query_pre_attn_scalar, cfg.attn_logit_softcap,
            cfg.final_logit_softcap) == ("gemma2", 256, 4096, 256, 50.0, 30.0)
    assert resolve(cfg) is gemma2
    shapes = jax.eval_shape(lambda: jax_gemma2.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert n == 9_241_705_984
    assert set(shapes["layers"]) == gemma2.param_keys(cfg)["layers"]
    assert set(shapes) == {"embed", "layers", "final_norm"}


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
@pytest.mark.parametrize("overrides", [
    {},
    dict(multi_step_decode=4),
    dict(spec_ngram_tokens=3, spec_ngram_match=2),
], ids=["k1", "burst4", "ngram_spec"])
async def test_gemma2_greedy_streams_match_jax_engine(overrides):
    """Greedy streams of the Gemma-2 engine against the reference's, prompts
    past the window of 6: single steps, 4-step bursts and ngram
    speculation (verify steps at S 4 over the windowed layers)."""
    jcfg, jparams, cfg, params = _both(TINY, seed=3)
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
