"""Differential tests of the port's int8 weight-only serving
(``dynamo_tpu_torch/models/quant.py``) against the JAX package's
``dynamo_tpu/models/quant.py``.

- ``quantize_int8`` equal bit for bit to the reference's on seeded inputs,
  with an all-zero column and values at .5 after the division (both round
  half to even);
- slice-by-slice quantization at init (``llama.normal_slices(quantize=
  True)``, the Mixtral family's ``init_params``) equal to quantizing the
  whole leaf;
- ``dense`` and ``expert_bmm`` against the reference's ``dense`` and
  ``expert_einsum``;
- per family (llama, DeepSeek, gpt-oss, gemma-2, mixtral): ``quantize_params``
  quantizes exactly the reference's leaves, the quantized forward matches
  the reference's quantized forward with the weights carried by the bridge,
  and a quantized ``ModelRunner`` keeps every quantized leaf int8;
- a quantized engine streams as the reference's quantized engine;
- unknown schemes and an fp8 KV cache are refused by name, before any
  weight is drawn.

Tiny widths, f32, on the CPU.
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
from dynamo_tpu.models import quant as jax_quant
from dynamo_tpu.models import resolve as jax_resolve
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models import llama, mixtral, quant, resolve
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

BS, N_BLOCKS = 8, 16
TOL = dict(rtol=1e-4, atol=1e-4)
OP_TOL = dict(rtol=1e-5, atol=1e-5)

# one tiny config a family, as a config.json (the families' own tests use
# these widths); DeepSeek with the query low-rank bottleneck, so w_dq and
# w_uq are quantized too
FAMILIES = {
    "llama": {
        "architectures": ["LlamaForCausalLM"], "vocab_size": 256,
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 8, "num_key_value_heads": 4,
        "max_position_embeddings": 128},
    "deepseek": {
        "architectures": ["DeepseekV2ForCausalLM"], "vocab_size": 256,
        "hidden_size": 64, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "n_routed_experts": 4, "num_experts_per_tok": 2,
        "n_shared_experts": 1, "first_k_dense_replace": 1,
        "norm_topk_prob": False, "kv_lora_rank": 16, "q_lora_rank": 12,
        "qk_nope_head_dim": 12, "qk_rope_head_dim": 8, "v_head_dim": 12,
        "max_position_embeddings": 128},
    "gptoss": {
        "architectures": ["GptOssForCausalLM"], "vocab_size": 256,
        "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
        "num_local_experts": 4, "num_experts_per_tok": 2,
        "max_position_embeddings": 128, "sliding_window": 4,
        "attention_bias": True,
        "layer_types": ["sliding_attention", "full_attention"]},
    "gemma2": {
        "architectures": ["Gemma2ForCausalLM"], "vocab_size": 256,
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
        "max_position_embeddings": 128, "query_pre_attn_scalar": 24,
        "sliding_window": 6, "attn_logit_softcapping": 50.0,
        "final_logit_softcapping": 30.0},
    "mixtral": {
        "architectures": ["MixtralForCausalLM"], "vocab_size": 256,
        "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_local_experts": 4, "num_experts_per_tok": 2,
        "max_position_embeddings": 128},
}


def _configs(family, **overrides):
    hf = FAMILIES[family]
    return (dataclasses.replace(JaxModelConfig.from_hf_config(hf), **overrides),
            dataclasses.replace(ModelConfig.from_hf_config(hf), **overrides))


def _np_params(jcfg, seed=0):
    return jax.device_get(jax_resolve(jcfg).init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))


def _quantized_paths(tree, cls, prefix=""):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _quantized_paths(v, cls, f"{prefix}{k}.")
        elif isinstance(v, cls):
            out.add(prefix + k)
    return out


def test_quantize_int8_is_bit_identical_to_the_reference():
    """Seeded leaves of rank 2, 3 and 4 (a stacked expert leaf), each with
    an all-zero column; and a column whose quotients fall on .5 (2.5 and
    -3.5 round to 2 and -4, as ``jnp.round`` does)."""
    rng = np.random.default_rng(0)
    cases = [(rng.standard_normal(s) * 0.2).astype(np.float32)
             for s in ((64, 40), (3, 48, 32), (2, 4, 16, 24))]
    for w in cases:
        w[..., 3] = 0.0
    half = np.zeros((5, 3), np.float32)
    half[:, 0] = [127.0, 2.5, -3.5, 0.5, -1.5]
    half[:, 1] = [-254.0, 5.0, 1.0, -7.0, 3.0]
    for w in cases + [half]:
        want = jax.device_get(jax_quant.quantize_int8(jnp.asarray(w)))
        got = quant.quantize_int8(torch.from_numpy(w))
        assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
        np.testing.assert_array_equal(got.q.numpy(), want.q)
        np.testing.assert_array_equal(got.scale.numpy(), want.scale)
        assert got.shape == w.shape
    got = quant.quantize_int8(torch.from_numpy(half))
    assert got.q[:, 0].tolist() == [127, 2, -4, 0, -2]
    assert float(got.scale[2]) == pytest.approx(1e-8)


@pytest.mark.parametrize("shape", [(3, 4, 16, 24), (3, 48, 32), (40, 24)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slice_by_slice_quantization_equals_the_whole_leaf(shape, dtype):
    """A leaf quantized a layer slice at a time as it is drawn equals the
    same draw rounded to ``dtype`` and quantized whole."""
    def draw(quantize):
        return llama.normal_slices(shape, shape[-2], torch.Generator().manual_seed(5),
                                   dtype, "cpu", quantize=quantize)
    sliced = draw(True)
    whole = quant.quantize_int8(draw(False))
    assert torch.equal(sliced.q, whole.q)
    assert torch.equal(sliced.scale, whole.scale)
    assert sliced[1].shape == whole.q[1].shape


def test_mixtral_init_quantizes_as_it_draws():
    """``mixtral.init_params`` with ``quantization="int8"`` gives exactly
    ``quantize_params`` of its bf16 draw, every ``QUANT_KEYS`` leaf int8."""
    _, cfg = _configs("mixtral")
    q8 = dataclasses.replace(cfg, quantization="int8")
    got = mixtral.init_params(q8, torch.Generator().manual_seed(1))
    want = quant.quantize_params(mixtral.init_params(
        cfg, torch.Generator().manual_seed(1)))
    paths = _quantized_paths(got, quant.QuantizedWeight)
    assert paths == _quantized_paths(want, quant.QuantizedWeight) == {
        "lm_head", "layers.wq", "layers.wk", "layers.wv", "layers.wo",
        "layers.w_gate", "layers.w_up", "layers.w_down"}
    for path in paths:
        a, b = got, want
        for k in path.split("."):
            a, b = a[k], b[k]
        assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    assert torch.equal(got["embed"], want["embed"])
    assert got["layers"]["router"].dtype == torch.bfloat16


def test_dense_and_expert_bmm_match_the_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 0.2).astype(np.float32)
    qw = jax_quant.quantize_int8(jnp.asarray(w))
    tw = quant.quantize_int8(torch.from_numpy(w))
    want = jax_quant.dense(jnp.asarray(x), qw)
    got = quant.dense(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    # a plain tensor is exactly x @ w
    assert torch.equal(quant.dense(torch.from_numpy(x), torch.from_numpy(w)),
                       torch.from_numpy(x) @ torch.from_numpy(w))
    xe = rng.standard_normal((4, 6, 48)).astype(np.float32)
    we = (rng.standard_normal((4, 48, 40)) * 0.2).astype(np.float32)
    want = jax_quant.expert_einsum("ecd,edi->eci", jnp.asarray(xe),
                                   jax_quant.quantize_int8(jnp.asarray(we)))
    got = quant.expert_bmm(torch.from_numpy(xe),
                           quant.quantize_int8(torch.from_numpy(we)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    assert torch.equal(quant.expert_bmm(torch.from_numpy(xe), torch.from_numpy(we)),
                       torch.bmm(torch.from_numpy(xe), torch.from_numpy(we)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantize_params_touches_the_reference_leaves(family):
    """The port's ``quantize_params`` of a family's tree quantizes exactly
    the leaves the reference's quantizes, to the same ``q`` and
    ``scale``; the bridge carries the reference's quantized leaves with
    their own dtypes whatever ``dtype`` it is asked for."""
    jcfg, cfg = _configs(family)
    np_params = _np_params(jcfg)
    jq = jax.device_get(jax_quant.quantize_params(
        jax.tree_util.tree_map(jnp.asarray, np_params)))
    ours = quant.quantize_params(from_jax_params(np_params, cfg))
    paths = _quantized_paths(ours, quant.QuantizedWeight)
    assert paths == _quantized_paths(jq, jax_quant.QuantizedWeight)
    assert paths  # every family has quantized leaves
    bridged = from_jax_params(jq, cfg, "cpu", "bfloat16")
    for path in paths:
        a, b, c = ours, jq, bridged
        for k in path.split("."):
            a, b, c = a[k], b[k], c[k]
        np.testing.assert_array_equal(a.q.numpy(), b.q)
        np.testing.assert_array_equal(a.scale.numpy(), b.scale)
        assert c.q.dtype == torch.int8 and c.scale.dtype == torch.float32
    assert bridged["embed"].dtype == torch.bfloat16


def _forward_steps(vocab):
    """A 13-token prefill padded to 16, then one decode step."""
    rng = np.random.default_rng(7)
    n, bucket = 13, 16
    blocks = np.array([[5, 2, 9, 0]], np.int32)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = rng.integers(0, vocab, n)
    positions = np.full((1, bucket), n - 1, np.int32)
    positions[0, :n] = np.arange(n)
    slots = np.full((1, bucket), -1, np.int32)
    slots[0, :n] = blocks[0, np.arange(n) // BS] * BS + np.arange(n) % BS
    steps = [(tokens, positions, slots, np.array([n], np.int32)),
             (np.array([[int(rng.integers(0, vocab))]], np.int32),
              np.array([[n]], np.int32),
              np.array([[blocks[0, n // BS] * BS + n % BS]], np.int32),
              np.array([n + 1], np.int32))]
    return blocks, steps


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_forward_matches_the_reference(family):
    """The family's forward over int8 weights (the reference's
    ``quantize_params``, carried by the bridge) against the reference's
    quantized forward: the prefill's valid positions and a decode step to
    1e-4; and it differs from the full-precision forward (the int8 path
    runs)."""
    jcfg, cfg = _configs(family)
    jcfg = dataclasses.replace(jcfg, attention_impl="xla")
    np_params = _np_params(jcfg, seed=1)
    jparams = jax_quant.quantize_params(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    params = from_jax_params(jax.device_get(jparams), cfg, "cpu", "float32")
    full = from_jax_params(np_params, cfg, "cpu", "float32")
    jarch, arch = jax_resolve(jcfg), resolve(cfg)
    jcache = jarch.init_kv_cache(jcfg, N_BLOCKS, BS, jnp.float32)
    caches = {name: arch.init_kv_cache(cfg, N_BLOCKS, BS, torch.float32)
              for name in ("int8", "full")}
    blocks, steps = _forward_steps(cfg.vocab_size)
    for i, (tok, pos, slot, ctx) in enumerate(steps):
        want, jcache = jarch.forward(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
            jnp.asarray(blocks), jnp.asarray(slot), jnp.asarray(ctx))
        out = {}
        for name, prm in (("int8", params), ("full", full)):
            out[name], caches[name] = arch.forward(
                prm, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
                caches[name], torch.from_numpy(blocks), torch.from_numpy(slot),
                torch.from_numpy(ctx))
        n = 13 if i == 0 else 1
        got = out["int8"].numpy()[0, :n]
        np.testing.assert_allclose(got, np.asarray(want)[0, :n], **TOL)
        assert np.abs(got - out["full"].numpy()[0, :n]).max() > 1e-4


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_runner_keeps_int8_leaves(family):
    """A runner with ``quantization="int8"``: drawn by the runner, or handed
    a tree the bridge carried over already quantized, every quantized leaf
    stays int8 with an f32 scale after ``_to_device`` (which casts every
    other leaf to the runner's dtype), and they are exactly the
    ``QUANT_KEYS`` leaves."""
    jcfg, cfg = _configs(family, quantization="int8")
    econf = EngineConfig(model=cfg, max_batch_size=2, max_model_len=64,
                         kv_block_size=BS, num_kv_blocks=32, dtype="float32")
    jq = jax.device_get(jax_quant.quantize_params(
        jax.tree_util.tree_map(jnp.asarray, _np_params(jcfg))))
    for given in (None, from_jax_params(jq, cfg)):
        runner = ModelRunner(econf, params=given, device="cpu")

        def walk(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                elif k in quant.QUANT_KEYS:
                    assert isinstance(v, quant.QuantizedWeight), prefix + k
                    assert v.q.dtype == torch.int8, prefix + k
                    assert v.scale.dtype == torch.float32, prefix + k
                else:
                    assert v.dtype == torch.float32, prefix + k

        walk(runner.params)
        assert _quantized_paths(runner.params, quant.QuantizedWeight) == \
            _quantized_paths(jq, jax_quant.QuantizedWeight)


def test_unknown_schemes_and_fp8_kv_are_refused_by_name(monkeypatch):
    """Any scheme but int8 raises the reference's ValueError when the
    config is built and again in the runner before a weight is drawn; int8
    weights beside an fp8 KV cache are served."""
    _, cfg = _configs("mixtral")
    for scheme in ("fp8", "int4", "awq"):
        with pytest.raises(ValueError,
                           match=f"unknown quantization '{scheme}' \\(only int8\\)"):
            EngineConfig(model=dataclasses.replace(cfg, quantization=scheme))
    econf = EngineConfig(model=dataclasses.replace(cfg, quantization="int8"),
                         max_model_len=64, num_kv_blocks=16, dtype="float32")
    econf.model.quantization = "gptq"   # set after the config's own check

    def drew(*args, **kw):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(mixtral, "init_params", drew)
    with pytest.raises(ValueError, match="unknown quantization 'gptq'"):
        ModelRunner(econf, device="cpu")
    monkeypatch.undo()
    both = ModelRunner(EngineConfig(
        model=dataclasses.replace(cfg, quantization="int8"), max_model_len=64,
        num_kv_blocks=16, dtype="float32", kv_cache_dtype="fp8"), device="cpu")
    assert all(t.dtype == torch.float8_e4m3fn for t in both.kv_cache)
    assert any(isinstance(v, quant.QuantizedWeight)
               for v in both.params["layers"].values())


async def _streams(engine, req_cls, ctx_cls, stop_cls, samp_cls, prompts):
    async def one(p):
        req = req_cls(token_ids=p,
                      stop_conditions=stop_cls(max_tokens=10, ignore_eos=True),
                      sampling_options=samp_cls(temperature=0.0))
        toks = []
        async for out in engine.generate(ctx_cls(req)):
            toks.extend(out["token_ids"])
        return toks
    try:
        return await asyncio.gather(*(one(p) for p in prompts))
    finally:
        await engine.close()


@pytest.mark.asyncio
@pytest.mark.parametrize("family", ["llama", "mixtral"])
@pytest.mark.parametrize("k", [1, 4])
async def test_quantized_engine_streams_match_jax_engine(family, k):
    """Greedy streams of an int8 engine (the runner quantizes the f32
    weights it is handed, as the reference's runner does) against the
    reference's int8 engine, at K 1 and 4-step bursts."""
    jcfg, cfg = _configs(family, quantization="int8")
    np_params = _np_params(jcfg, seed=3)
    cfg_kw = dict(max_batch_size=4, max_model_len=128, kv_block_size=BS,
                  num_kv_blocks=64, dtype="float32", multi_step_decode=k)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(3, 256, n)] for n in (5, 19, 33, 12)]
    jengine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None),
        engine_config=JaxEngineConfig(model=jcfg, **cfg_kw),
        params=jax.tree_util.tree_map(jnp.asarray, np_params), warmup=False)
    want = await _streams(jengine, JaxRequest, JaxContext, JaxStop, JaxSampling,
                          prompts)
    engine = await TorchServingEngine.create(
        EngineConfig(model=cfg, **cfg_kw),
        params=from_jax_params(np_params, cfg, "cpu", "float32"), device="cpu",
        warmup=False)
    assert isinstance(engine.runner.params["layers"]["wq"], quant.QuantizedWeight)
    got = await _streams(engine, PreprocessedRequest, Context, StopConditions,
                         SamplingOptions, prompts)
    assert got == want
    assert all(len(t) == 10 for t in got)
