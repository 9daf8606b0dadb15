"""Differential tests of the port's Phi-3 family against the JAX package.

Phi-3 is the Llama family with longrope (Phi-3-mini-128k,
Phi-3.5-mini), head_dim 96 and, at Phi-3-mini, one query head a KV head.
The tiny config keeps that shape: hidden 192, 2 heads over 2 KV heads,
head_dim 96, 2 layers, vocab 512, longrope with 48-entry short and long
factor lists, ``original_max_position_embeddings`` 16 and
``max_position_embeddings`` 64, a window of 24. Weights and inputs come
from a seed (numpy / the reference's init) and are shared; f32 on the CPU.

- ``longrope_frequencies`` and ``rope_cos_sin`` against the reference's
  ``_longrope_frequencies`` and ``apply_rope``: both profiles, the per-row
  choice (a short row beside a long one), the attention factor, the
  missing-field error;
- ``forward`` of a short and a long prompt in one batch, then a decode
  step: logits to 2e-4 (``tests/test_model_families.py``'s bound against
  HF) and every cache layer against the reference's first 96 lanes;
- the engine's greedy streams against ``JaxServingEngine``'s: prompts that
  cross ``original`` and the window while they decode, a prefix hit whose
  short-roped keys serve a long row, plain, chained and ngram speculation;
- an SP chunk of a longrope trunk without a window, past ``original``,
  against the reference's SP path on the virtual mesh, and the windowed
  trunk refused by ``check_sp_trunk`` as the reference refuses it;
- the embeddings (``embed_prompts``, the ``/v1/embeddings`` path) of a
  long and a short prompt against the reference's;
- the loader's split of the fused ``qkv_proj`` and ``gate_up_proj`` at
  head_dim 96 and G 1, against the reference's loader on one snapshot.
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
from dynamo_tpu.engine.model_runner import ModelRunner as JaxModelRunner
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.models import loader as jax_loader
from dynamo_tpu.models import resolve as jax_resolve
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner, build_prefill_arrays
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models import llama, loader, resolve
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

_RNG = np.random.default_rng(21)
SHORT_FACTOR = [float(x) for x in 1.0 + 0.2 * _RNG.random(48)]
LONG_FACTOR = [float(x) for x in 2.0 + 6.0 * _RNG.random(48)]
# the tiny Phi-3 as its config.json (Phi-3-mini-128k's form at small widths)
TINY = {
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
    "vocab_size": 512, "hidden_size": 192, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 2,
    "num_key_value_heads": 2, "max_position_embeddings": 64,
    "original_max_position_embeddings": 16, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "sliding_window": 24, "tie_word_embeddings": False,
    "rope_scaling": {"type": "longrope", "short_factor": SHORT_FACTOR,
                     "long_factor": LONG_FACTOR},
}
NO_WINDOW = dict(TINY, sliding_window=None)
ORIGINAL = 16
BS = 8
# f32 logits: the bound tests/test_model_families.py holds Phi-3 to
TOL = dict(rtol=2e-4, atol=2e-4)
ROPE_TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(hf):
    return JaxModelConfig.from_hf_config(hf), ModelConfig.from_hf_config(hf)


def _both(hf=TINY, seed=0):
    """(jax cfg, jax params, port cfg, port params on the CPU in f32)."""
    jcfg, cfg = _configs(hf)
    np_params = jax.device_get(jax_llama.init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, np_params), cfg,
            from_jax_params(np_params, cfg, "cpu", "float32"))


def test_phi3_config_is_the_llama_family_with_longrope():
    """``from_hf_config`` of both packages: the Llama family (empty
    ``model_family``), head_dim 96, the window, longrope with the injected
    window fields; nothing in the port's refusals stops it."""
    jcfg, cfg = _configs(TINY)
    assert cfg.model_family == "" and resolve(cfg) is llama
    assert (cfg.head_dim, cfg.num_kv_heads, cfg.sliding_window) == (96, 2, 24)
    assert cfg.rope_scaling == jcfg.rope_scaling
    assert cfg.rope_scaling["original_max_position_embeddings"] == ORIGINAL
    assert cfg.rope_scaling["max_position_embeddings"] == 64
    llama.check_supported(cfg)
    EngineConfig(model=cfg, max_model_len=64, kv_block_size=BS,
                 num_kv_blocks=32, dtype="float32")


def test_longrope_frequencies_match_reference():
    """Both profiles' inverse frequencies (the reference builds the row's
    profile from positions: a row within ``original`` takes the short one,
    a row past it the long one) and the attention factor, computed and
    given."""
    scaling = _configs(TINY)[1].rope_scaling
    got, factor = llama.longrope_frequencies(96, 1e4, scaling)
    assert got.shape == (2, 48)
    for row, last in ((0, ORIGINAL - 1), (1, ORIGINAL)):
        want, jf = jax_llama._longrope_frequencies(
            96, 1e4, scaling, jnp.arange(last + 1)[None])
        np.testing.assert_allclose(got[row].numpy(), np.asarray(want)[0, 0],
                                   rtol=1e-6)
        assert factor == jf == pytest.approx(np.sqrt(1 + np.log(4) / np.log(16)))
    given = dict(scaling, attention_factor=1.5)
    assert llama.longrope_frequencies(96, 1e4, given)[1] == 1.5 == \
        jax_llama._longrope_frequencies(96, 1e4, given, jnp.zeros((1, 1)))[1]
    inv, f = llama.rope_frequencies(96, 1e4, scaling)
    assert torch.equal(inv, got) and f == factor


@pytest.mark.parametrize("drop", ["short_factor", "long_factor",
                                  "original_max_position_embeddings"])
def test_longrope_missing_field_raises_the_reference_words(drop):
    scaling = dict(_configs(TINY)[1].rope_scaling)
    del scaling[drop]
    with pytest.raises(ValueError) as want:
        jax_llama._longrope_frequencies(96, 1e4, scaling, jnp.zeros((1, 1)))
    with pytest.raises(ValueError) as got:
        llama.longrope_frequencies(96, 1e4, scaling)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("basis", [None, (10, 40), (17, 16), 40, 3])
def test_rope_profile_per_row_matches_reference(basis):
    """``apply_rope`` of a short row beside a long one: each row keeps the
    profile of its own covered context (``seq_basis``; without it, its max
    position + 1; an int for every row), and the short row equals itself
    roped alone."""
    scaling = _configs(TINY)[1].rope_scaling
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 2, 96)).astype(np.float32)
    pos = np.stack([np.arange(6), np.arange(30, 36)]).astype(np.int32)
    jb = tb = None
    if isinstance(basis, tuple):
        jb, tb = jnp.asarray(basis, jnp.int32), torch.tensor(basis)
    elif basis is not None:
        jb, tb = jnp.full((2,), basis, jnp.int32), basis
    want = np.asarray(jax_llama.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                           1e4, scaling, seq_basis=jb))
    got = llama.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                           scaling, seq_basis=tb)
    np.testing.assert_allclose(got.numpy(), want, **ROPE_TOL)
    if isinstance(basis, tuple):
        alone = llama.apply_rope(torch.from_numpy(x[:1]), torch.from_numpy(pos[:1]),
                                 1e4, scaling, seq_basis=tb[:1])
        np.testing.assert_array_equal(alone.numpy(), got[:1].numpy())
        other = llama.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                                 scaling, seq_basis=torch.tensor(basis[::-1]))
        assert not np.allclose(other.numpy(), got.numpy())


def test_forward_short_and_long_prompt_matches_jax():
    """One prefill of a short (10) and a long (40, past ``original``)
    prompt and a decode step of both through each package's ``forward``
    (the reference's XLA route): logits to 2e-4 and both caches, the
    reference's first 96 lanes of its padded cache."""
    jcfg, jparams, cfg, params = _both(NO_WINDOW, seed=1)
    jcfg = dataclasses.replace(jcfg, attention_impl="xla")
    n_blocks, lens, bucket = 16, (10, 40), 40
    jcache = jax_llama.init_kv_cache(jcfg, n_blocks, BS, jnp.float32)
    cache = llama.init_kv_cache(cfg, n_blocks, BS, torch.float32)
    rng = np.random.default_rng(5)
    blocks = np.array([[3, 9, 0, 0, 0, 0], [1, 2, 4, 5, 6, 7]], np.int32)
    tokens = np.zeros((2, bucket), np.int32)
    positions = np.zeros((2, bucket), np.int32)
    slots = np.full((2, bucket), -1, np.int32)
    for r, n in enumerate(lens):
        tokens[r, :n] = rng.integers(3, 512, n)
        positions[r, :n] = np.arange(n)
        positions[r, n:] = n - 1
        slots[r, :n] = blocks[r, np.arange(n) // BS] * BS + np.arange(n) % BS
    dec_pos = np.array([[lens[0]], [lens[1]]], np.int32)
    steps = [(tokens, positions, slots, np.array(lens, np.int32)),
             (rng.integers(3, 512, (2, 1)).astype(np.int32), dec_pos,
              np.array([[blocks[r, p // BS] * BS + p % BS]
                        for r, p in enumerate(dec_pos[:, 0])], np.int32),
              dec_pos[:, 0] + 1)]
    for i, (tok, pos, slot, ctx) in enumerate(steps):
        want, jcache = jax_llama.forward(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
            jnp.asarray(blocks), jnp.asarray(slot), jnp.asarray(ctx))
        got, cache = llama.forward(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos), cache,
            torch.from_numpy(blocks), torch.from_numpy(slot),
            torch.from_numpy(ctx))
        want = np.asarray(want)
        for r, n in enumerate(lens if i == 0 else (1, 1)):
            np.testing.assert_allclose(got[r, :n].numpy(), want[r, :n], **TOL)
    for t, j in zip(cache, jcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j)[..., :96], **TOL)


# ------------------------------------------------------------- the engine

ENGINE = dict(max_batch_size=4, max_model_len=64, kv_block_size=BS,
              num_kv_blocks=48, dtype="float32", max_prefill_tokens_per_step=16)
NEW_TOKENS = 12


def _wave1():
    """Prompts under ``original`` that cross it while they decode (10, 14),
    one that crosses the window of 24 while it decodes (20), one long from
    the start past the window (30), and a repeating pattern for the ngram
    lookup (18)."""
    rng = np.random.default_rng(8)
    out = [[int(t) for t in rng.integers(3, 512, n)] for n in (10, 14, 20, 30)]
    pattern = [int(t) for t in rng.integers(3, 512, 5)]
    return out + [(pattern * 4)[:18]]


def _wave2(wave1):
    """A prefix hit: the first prompt's first block (roped short) under a
    row of 36 tokens (long)."""
    rng = np.random.default_rng(9)
    return [wave1[0][:BS] + [int(t) for t in rng.integers(3, 512, 28)]]


async def _streams(engine, req_cls, ctx_cls, stop_cls, samp_cls, waves):
    """Greedy streams of each wave in turn (a wave's requests at once),
    ``NEW_TOKENS`` each, eos ignored."""
    async def one(p):
        req = req_cls(token_ids=p,
                      stop_conditions=stop_cls(max_tokens=NEW_TOKENS,
                                               ignore_eos=True),
                      sampling_options=samp_cls(temperature=0.0))
        toks = []
        async for out in engine.generate(ctx_cls(req)):
            toks.extend(out["token_ids"])
        return toks
    try:
        out = []
        for wave in waves:
            out.append(await asyncio.gather(*(one(p) for p in wave)))
        return out, engine.metrics()
    finally:
        await engine.close()


@pytest.fixture(scope="module")
def jax_streams():
    """The reference engine's greedy streams of both waves, and its
    metrics: one compile for every port mode below."""
    jcfg, jparams, _, _ = _both(seed=3)
    waves = [_wave1()]
    waves.append(_wave2(waves[0]))

    async def run():
        engine = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None),
            engine_config=JaxEngineConfig(model=jcfg, **ENGINE),
            params=jparams, warmup=False)
        return await _streams(engine, JaxRequest, JaxContext, JaxStop,
                              JaxSampling, waves)
    return waves, asyncio.run(run())


@pytest.mark.parametrize("overrides", [
    {},
    dict(decode_pipeline_depth=2, multi_step_decode=4),
    dict(spec_ngram_tokens=3, spec_ngram_match=2),
], ids=["plain", "chained", "ngram_spec"])
def test_phi3_greedy_streams_match_jax_engine(jax_streams, overrides):
    """The port's engine streams both waves as the reference's does: rows
    that cross ``original`` and the window while they decode, and wave 2's
    prefix hit (its first block's keys roped short under a long row); the
    chained loop and ngram speculation stream the same tokens."""
    waves, (want, jmetrics) = jax_streams
    _, _, cfg, params = _both(seed=3)

    async def run():
        engine = await TorchServingEngine.create(
            EngineConfig(model=cfg, **dict(ENGINE, **overrides)),
            params=params, device="cpu", warmup=False)
        return await _streams(engine, PreprocessedRequest, Context,
                              StopConditions, SamplingOptions, waves)
    got, metrics = asyncio.run(run())
    assert got == want
    assert all(len(t) == NEW_TOKENS for wave in got for t in wave)
    assert metrics["gpu_prefix_cache_hit_rate"] > 0
    assert jmetrics["gpu_prefix_cache_hit_rate"] > 0
    if "spec_ngram_tokens" in overrides:
        assert metrics["spec_proposed_tokens"] > 0
    if "decode_pipeline_depth" in overrides:
        assert metrics["decode_pipeline_bursts"] > 0


# ------------------------------------------------ SP, embeddings, loader

def test_sp_chunk_of_a_longrope_trunk_matches_jax():
    """Two SP chunks of a 40-token prompt (16 tokens, then 24, past
    ``original``) of the longrope trunk without a window, 4 ranks, against
    the reference's SP path on the virtual mesh: the valid rows' hidden
    states and every cache layer to 1e-4."""
    jcfg, jparams, cfg, params = _both(NO_WINDOW, seed=4)
    n_blocks, S, sp = 12, 32, 4
    ecfg = EngineConfig(model=cfg, max_model_len=64, kv_block_size=BS,
                        num_kv_blocks=n_blocks, dtype="float32")
    jcache = jax_llama.init_kv_cache(jcfg, n_blocks, BS, jnp.float32)
    cache = llama.init_kv_cache(cfg, n_blocks, BS, torch.float32)
    mesh = make_mesh({"sp": sp})
    prompt = [int(t) for t in np.random.default_rng(10).integers(3, 512, 40)]
    blocks = [7, 2, 10, 4, 1]

    def t(x):
        return torch.from_numpy(np.asarray(x))
    for start, end in ((0, 16), (16, 40)):
        tok, pos, bt, slots, _, _ = build_prefill_arrays(
            ecfg, prompt[:end], start, blocks, bucket=S)
        jh, jcache = jax_llama.sp_decoder_forward(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
            jnp.asarray(bt), jnp.asarray(slots), jnp.asarray([end], jnp.int32),
            start, mesh)
        th, cache = llama.sp_decoder_forward(
            params, cfg, t(tok), t(pos), cache, t(bt), t(slots), end, start, sp)
        take = end - start
        np.testing.assert_allclose(th[0, :take].numpy(), np.asarray(jh)[0, :take],
                                   rtol=1e-4, atol=1e-4)
        for i in range(2):
            np.testing.assert_allclose(cache[i].numpy(),
                                       np.asarray(jcache[i])[..., :96],
                                       rtol=1e-4, atol=1e-4)


def test_sp_gate_refuses_the_windowed_phi3_as_the_reference_does():
    jcfg, cfg = _configs(TINY)
    kw = dict(max_model_len=64, kv_block_size=BS, num_kv_blocks=32,
              dtype="float32", sp_size=2, long_prefill_threshold_tokens=32)
    with pytest.raises(ValueError, match="sliding_window"):
        EngineConfig(model=cfg, **kw).check_sp_trunk()
    jcfg_nw, cfg_nw = _configs(NO_WINDOW)
    EngineConfig(model=cfg_nw, **kw).check_sp_trunk()
    _, jparams, _, _ = _both(seed=0)
    with pytest.raises(ValueError, match="without sliding windows"):
        JaxModelRunner(JaxEngineConfig(model=jcfg, **kw), params=jparams)


def test_embeddings_of_a_long_and_a_short_prompt_match_reference():
    """``embed_prompts`` (what ``/v1/embeddings`` runs) of a prompt past
    ``original`` and one within it, on the longrope trunk without a
    window, against the reference runner's ``embed_forward``: f32 to 1e-5;
    the long row alone equals itself beside the short one."""
    jcfg, jparams, cfg, params = _both(NO_WINDOW, seed=5)
    kw = dict(max_model_len=64, kv_block_size=BS, num_kv_blocks=16)
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(3, 512, n)] for n in (40, 9)]
    want = JaxModelRunner(JaxEngineConfig(model=jcfg, **kw),
                          params=jparams).embed_prompts(prompts)
    runner = ModelRunner(EngineConfig(model=cfg, dtype="float32", **kw),
                         params=params, device="cpu")
    assert runner.embed_ready
    got = runner.embed_prompts(prompts)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runner.embed_prompts(prompts[:1])[0], got[0],
                               rtol=1e-6, atol=1e-6)


def test_loader_splits_phi3_fused_projections_at_head_dim_96(tmp_path):
    """A Phi-3 snapshot written by ``transformers`` (fused ``qkv_proj`` and
    ``gate_up_proj``, head_dim 96, G 1, longrope) read by both loaders: the
    same leaves bit for bit, in f32 and bf16, and the port's forward from
    them against HF's logits."""
    from transformers import Phi3Config, Phi3ForCausalLM

    hf_cfg = {k: v for k, v in TINY.items()
              if k not in ("architectures", "model_type")}
    model = Phi3ForCausalLM(Phi3Config(pad_token_id=0, **hf_cfg))
    torch.manual_seed(12)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(1.0 + 0.2 * torch.randn_like(p))
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    jcfg = JaxModelConfig.from_model_dir(str(tmp_path))
    cfg = ModelConfig.from_model_dir(str(tmp_path))
    assert (cfg.head_dim, cfg.num_heads // cfg.num_kv_heads) == (96, 1)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = jax.device_get(jax_loader.load_checkpoint_params(
            str(tmp_path), jcfg, jax_resolve(jcfg), jdt))
        got = loader.load_checkpoint_params(str(tmp_path), cfg, llama, tdt, "cpu")
        assert sorted(got["layers"]) == sorted(ref["layers"])
        for name in got["layers"]:
            np.testing.assert_array_equal(
                got["layers"][name].float().numpy(),
                np.asarray(ref["layers"][name]).astype(np.float32), err_msg=name)
        for name in ("embed", "final_norm", "lm_head"):
            np.testing.assert_array_equal(got[name].float().numpy(),
                                          np.asarray(ref[name]).astype(np.float32))
    params = loader.load_checkpoint_params(str(tmp_path), cfg, llama,
                                           torch.float32, "cpu")
    prompt = [int(t) for t in np.random.default_rng(13).integers(3, 512, 20)]
    cache = llama.init_kv_cache(cfg, 4, BS, torch.float32)
    n = len(prompt)
    pos = torch.arange(n)[None]
    logits, _ = llama.forward(params, cfg, torch.tensor([prompt]), pos, cache,
                              torch.arange(4)[None], pos, torch.tensor([n]))
    model.eval()
    with torch.no_grad():
        hf = model(torch.tensor([prompt])).logits[0].numpy()
    np.testing.assert_allclose(logits[0].numpy(), hf, **TOL)
