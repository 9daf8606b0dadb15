"""fp8 (e4m3) paged-KV serving: the port against the JAX package.

The cache stores ``float8_e4m3fn`` with no scale; every write casts into it
and every read upcasts (``kv_cache_dtype="fp8"``). Inputs are made with
numpy from a seed and handed to both packages, f32 on the CPU, where the
two casts give the same bytes for every |x| <= 464: so the tolerances are
the f32 differentials' own (``OP_TOL`` for one op, token for token for an
engine), not the ~6% e4m3 error bound of ``tests/test_kv_fp8.py``. The
reference's Pallas kernels run in interpret mode, as its own tests run them
(``tests/test_kv_fp8.py``, ``tests/test_pallas_campaign.py``); the port's
kernel modules take their plain versions for CPU tensors.
"""

import asyncio
import dataclasses
import types
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.cli.run import build_parser as jax_build_parser
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model_runner import ModelRunner as JaxModelRunner
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.engine.serving import engine_config_from_mdc as jax_config_from_mdc
from dynamo_tpu.models import deepseek as jax_deepseek
from dynamo_tpu.models import resolve as jax_resolve
from dynamo_tpu.ops.attention import scatter_kv_stacked as jax_scatter
from dynamo_tpu.ops.pallas_attention import paged_flash_attention as jax_flash
from dynamo_tpu.ops.pallas_decode import mla_paged_decode_attention as jax_mla_kernel
from dynamo_tpu.ops.pallas_decode import paged_decode_attention as jax_decode
from dynamo_tpu.ops.pallas_decode import paged_verify_attention as jax_verify
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.cli import run
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.serving import TorchServingEngine, engine_config_from_mdc
from dynamo_tpu_torch.models import deepseek
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops import mla_decode, paged_decode, paged_flash, paged_verify, sp_prefix
from dynamo_tpu_torch.ops.attention import FP8, alloc_kv_cache, scatter_kv_stacked
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

BS = 8
OP_TOL = dict(rtol=1e-5, atol=1e-5)  # one op in f32 over the same e4m3 values

# one tiny config a family, as a config.json
FAMILIES = {
    "llama": {
        "architectures": ["LlamaForCausalLM"], "vocab_size": 512,
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 256, "rope_theta": 10000.0},
    "deepseek": {
        "architectures": ["DeepseekV2ForCausalLM"], "vocab_size": 256,
        "hidden_size": 64, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "n_routed_experts": 4, "num_experts_per_tok": 2,
        "n_shared_experts": 1, "first_k_dense_replace": 1,
        "norm_topk_prob": False, "kv_lora_rank": 16, "q_lora_rank": None,
        "qk_nope_head_dim": 12, "qk_rope_head_dim": 8, "v_head_dim": 12,
        "max_position_embeddings": 256},
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


def _e4m3_bytes_jax(x) -> np.ndarray:
    return np.asarray(x).view(np.uint8)


def _e4m3_bytes_torch(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


def _both_fp8(a: np.ndarray):
    """``a`` cast to e4m3 by each package: (jax array, torch tensor), with
    their bytes checked equal (every |a| <= 464)."""
    j = jnp.asarray(a).astype(jnp.float8_e4m3fn)
    t = torch.from_numpy(a).to(FP8)
    np.testing.assert_array_equal(_e4m3_bytes_torch(t), _e4m3_bytes_jax(j))
    return j, t


# --------------------------------------------------------------- the writes


def _special_values(rng, n):
    """n values covering e4m3's range: normals up to 464, subnormals
    (2^-9 .. 7 * 2^-9), values that round into and out of the subnormals,
    +-0, ties, 448 and 464 (which round to 448)."""
    special = np.array([0.0, -0.0, 2.0 ** -9, -(2.0 ** -9), 3 * 2.0 ** -9,
                        7 * 2.0 ** -9, 2.0 ** -10, 1.5 * 2.0 ** -10,
                        2.0 ** -6, 0.001, 1.0625, 1.1875, 17.0, 448.0, -448.0,
                        460.0, 464.0, -464.0, 463.99, 240.0, 1e-7],
                       np.float32)
    vals = (rng.standard_normal(n) * rng.choice([0.01, 1.0, 30.0, 200.0], n))
    vals = np.clip(vals, -464.0, 464.0).astype(np.float32)
    vals[: len(special)] = special
    return vals


@pytest.mark.parametrize("spare", [True, False], ids=["spare_row", "no_spare_row"])
@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
def test_fp8_writes_give_the_reference_bytes(src_dtype, spare):
    """``scatter_kv_stacked`` into e4m3 caches writes the reference's bytes
    for every |x| <= 464 (subnormals, +-0, 448-464 included), in place, on
    both write routes (a cache with the spare row and one without), from
    f32 and bf16 sources; the -1 sentinel and slots past the layer drop,
    so the rows they name stay untouched."""
    rng = np.random.default_rng(0)
    layers, n_blocks, kvh, d = 2, 5, 2, 16
    per_layer = n_blocks * BS
    shape = (layers, n_blocks, BS, kvh, d)
    new_k = _special_values(rng, 2 * 6 * kvh * d).reshape(2, 6, kvh, d)
    new_v = _special_values(rng, 2 * 6 * kvh * d)[::-1].copy().reshape(2, 6, kvh, d)
    slots = np.array([[3, -1, 17, per_layer, 0, -1],
                      [per_layer + 7, 39, 8, -1, 21, 22]], np.int32)
    jdt = jnp.float32 if src_dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if src_dtype == "float32" else torch.bfloat16
    for li in range(layers):
        jk = jnp.zeros(shape, jnp.float8_e4m3fn)
        jv = jnp.zeros(shape, jnp.float8_e4m3fn)
        jk, jv = jax_scatter(jk, jv, jnp.asarray(new_k, jdt), jnp.asarray(new_v, jdt),
                             jnp.asarray(slots), jnp.int32(li))
        if spare:
            tk, tv = alloc_kv_cache(shape, FP8, "cpu"), alloc_kv_cache(shape, FP8, "cpu")
        else:
            tk = torch.zeros(shape, dtype=torch.uint8).view(FP8)
            tv = torch.zeros(shape, dtype=torch.uint8).view(FP8)
        ok, ov = scatter_kv_stacked(tk, tv, torch.from_numpy(new_k).to(tdt),
                                    torch.from_numpy(new_v).to(tdt),
                                    torch.from_numpy(slots), li)
        assert ok.data_ptr() == tk.data_ptr() and ok.dtype == FP8  # in place
        np.testing.assert_array_equal(_e4m3_bytes_torch(ok), _e4m3_bytes_jax(jk))
        np.testing.assert_array_equal(_e4m3_bytes_torch(ov), _e4m3_bytes_jax(jv))
        # the rows written are exactly the kept slots of layer li
        written = (_e4m3_bytes_torch(ok).reshape(layers * per_layer, -1) != 0).any(1)
        kept = {li * per_layer + s for s in slots.ravel() if 0 <= s < per_layer}
        assert set(np.flatnonzero(written)) <= kept


def test_fp8_cast_above_464_saturates_where_the_reference_stores_nan():
    """Past e4m3's rounding range the two packages part, by decision: the
    port clamps to +-448 before the cast (``to_cache_dtype``: byte 0x7E /
    0xFE), the reference's ``astype`` stores NaN (0x7F / 0xFF), which would
    poison every later token that reads the row."""
    vals = np.array([464.5, 465.0, 480.0, 1e4, np.inf, -465.0, -1e4, -np.inf],
                    np.float32)
    shape = (1, 1, BS, 1, len(vals))
    jk, _ = jax_scatter(jnp.zeros(shape, jnp.float8_e4m3fn),
                        jnp.zeros(shape, jnp.float8_e4m3fn),
                        jnp.asarray(vals)[None, None, None, :],
                        jnp.asarray(vals)[None, None, None, :],
                        jnp.asarray([[2]], jnp.int32), jnp.int32(0))
    tk, _ = scatter_kv_stacked(alloc_kv_cache(shape, FP8, "cpu"),
                               alloc_kv_cache(shape, FP8, "cpu"),
                               torch.from_numpy(vals)[None, None, None, :],
                               torch.from_numpy(vals)[None, None, None, :],
                               torch.tensor([[2]]), 0)
    sign = np.signbit(vals)
    np.testing.assert_array_equal(_e4m3_bytes_torch(tk)[0, 0, 2, 0],
                                  np.where(sign, 0xFE, 0x7E))
    np.testing.assert_array_equal(_e4m3_bytes_jax(jk)[0, 0, 2, 0],
                                  np.where(sign, 0xFF, 0x7F))
    assert np.isnan(np.asarray(jk[0, 0, 2, 0], np.float32)).all()
    assert tk[0, 0, 2, 0].float().abs().eq(448.0).all()


# ------------------------------------------------------------ the kernels


def _attn_case(kind, d, rng):
    """(q, k, v, bt, base, ctx, s) for one kernel at 4 heads over 2 KV heads:
    decode rows at ragged contexts (a ctx-0 row), verify rows with a pad
    row (base 0, ctx 1, table 0), flash rows with a prefix hit."""
    h, kvh, layers, w = 4, 2, 3, 12
    if kind == "decode":
        s = 1
        ctx = np.array([0, 1, 9, 40, 57], np.int32)
        base = ctx - 1
    elif kind == "verify":
        s = 5
        base = np.array([40, 3, 20, 0], np.int32)
        ctx = np.array([45, 8, 24, 1], np.int32)
    else:
        s = 40
        base = np.array([0, 20], np.int32)
        ctx = np.array([40, 60], np.int32)
    b = len(ctx)
    n_blocks = b * w + 3
    k = rng.standard_normal((layers, n_blocks, BS, kvh, d)).astype(np.float32)
    v = rng.standard_normal((layers, n_blocks, BS, kvh, d)).astype(np.float32)
    bt = rng.permutation(n_blocks)[: b * w].reshape(b, w).astype(np.int32)
    if kind == "verify":
        bt[-1] = 0
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, bt, base, ctx, s


# forms the reference serves with fp8 (probe.py:340-359): plain, a window
# with sinks, a softcap that binds (scores ~N(0, 4)) with a scale unlike
# head_dim^-0.5
FORMS = {
    "plain": {},
    "window_sinks": dict(window=6, sinks=True),
    "softcap": dict(softcap=2.0, scale=2.0),
}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("kind", ["decode", "verify", "flash"])
def test_fp8_attention_plain_versions_match_pallas_interpret(kind, d, form):
    """The port's plain decode, verify and flash versions over e4m3 caches
    against the reference's Pallas kernels in interpret mode over the same
    bytes, at head_dim 64, 128 and 256 (the kernels' widths), each with a
    window and sinks, a binding softcap, or neither."""
    rng = np.random.default_rng(zlib.crc32(f"{kind}-{d}-{form}".encode()))
    q, k, v, bt, base, ctx, s = _attn_case(kind, d, rng)
    jk, tk = _both_fp8(k)
    jv, tv = _both_fp8(v)
    opts = FORMS[form]
    window = opts.get("window")
    softcap = opts.get("softcap", 0.0)
    scale = opts.get("scale", 1.0) / np.sqrt(d)
    sinks = (rng.standard_normal(q.shape[2]).astype(np.float32) * 2.0
             if opts.get("sinks") else None)
    li = 1
    jkw = dict(layer_idx=jnp.int32(li), interpret=True, window=window,
               softcap=softcap, scale=scale,
               sinks=None if sinks is None else jnp.asarray(sinks))
    tkw = dict(layer_idx=li, scale=scale, softcap=softcap,
               window=paged_decode.NO_WINDOW if window is None else window,
               sinks=None if sinks is None else torch.from_numpy(sinks))
    tq, tbt = torch.from_numpy(q), torch.from_numpy(bt)
    if kind == "decode":
        want = jax_decode(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                          jnp.asarray(ctx), **jkw)
        got = paged_decode.paged_decode_attention(
            tq, tk, tv, tbt, torch.from_numpy(ctx), **tkw)
    elif kind == "verify":
        want = jax_verify(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                          jnp.asarray(base), jnp.asarray(ctx), **jkw)
        got = paged_verify.paged_verify_attention(
            tq, tk, tv, tbt, torch.from_numpy(base), torch.from_numpy(ctx), **tkw)
    else:
        want = jax_flash(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                         jnp.asarray(base), jnp.asarray(ctx), q_chunk=8, **jkw)
        got = paged_flash.paged_flash_attention(
            tq, tk, tv, tbt, torch.from_numpy(base), torch.from_numpy(ctx), **tkw)
    want, got = np.asarray(want), got.numpy()
    for i in range(len(ctx)):
        valid = 1 if kind == "decode" else max(0, min(s, ctx[i] - base[i]))
        np.testing.assert_allclose(got[i, :valid], want[i, :valid], **OP_TOL)
    if kind == "decode":
        assert not got[0].any()  # the ctx-0 row: zeros on both sides
    assert (paged_decode.launches_fp8 == paged_verify.launches_fp8
            == paged_flash.launches_fp8 == 0)  # CPU tensors never launch


def _mla_caches(rng, layers, n, r, rd):
    return (rng.standard_normal((layers, n, BS, 1, r)).astype(np.float32),
            rng.standard_normal((layers, n, BS, 1, rd)).astype(np.float32))


@pytest.mark.parametrize("r,rd", [(16, 8), (512, 64)])  # 512/64: DeepSeek's
def test_fp8_mla_decode_plain_version_matches_pallas_interpret(r, rd):
    """The MLA decode plain version over e4m3 latent and rope caches against
    the reference's MLA Pallas kernel in interpret mode over the same bytes:
    ragged contexts across page edges, a ctx-1 row, layer 1."""
    rng = np.random.default_rng(r)
    layers, b, h, w = 3, 5, 4, 6
    n = b * w + 2
    q_lat = rng.standard_normal((b, 1, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((b, 1, h, rd)).astype(np.float32)
    c, kr = _mla_caches(rng, layers, n, r, rd)
    jc, tc = _both_fp8(c)
    jkr, tkr = _both_fp8(kr)
    bt = rng.permutation(n)[: b * w].reshape(b, w).astype(np.int32)
    ctx = np.array([1, 7, 8, 9, 48], np.int32)
    scale = r ** -0.5
    got = mla_decode.mla_paged_decode_attention(
        torch.from_numpy(q_lat), torch.from_numpy(q_rope), tc, tkr,
        torch.from_numpy(bt), torch.from_numpy(ctx), layer_idx=1,
        scale=scale).numpy()
    want = jax_mla_kernel(
        jnp.asarray(q_lat), jnp.asarray(q_rope), jc, jkr, jnp.asarray(bt),
        jnp.asarray(ctx), layer_idx=jnp.int32(1), scale=scale,
        pages_per_chunk=2, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **OP_TOL)
    # the ctx-1 row's output is its one key's latent, upcast from e4m3
    np.testing.assert_allclose(
        got[0, 0], np.broadcast_to(tc[1, bt[0, 0], 0, 0].float().numpy(), (h, r)),
        **OP_TOL)
    assert mla_decode.launches_fp8 == 0


@pytest.mark.parametrize("s", [1, 5, 12])
def test_fp8_mla_dense_gather_matches_reference(s):
    """``deepseek.mla_attention`` over e4m3 caches at layer 2 (the dense
    gather that prefill and verify take, S > 1, and decode on the CPU)
    against the reference's over the same bytes."""
    rng = np.random.default_rng(20 + s)
    layers, b, h, r, rd, w = 3, 3, 4, 16, 8, 5
    n = b * w + 1
    q_lat = rng.standard_normal((b, s, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((b, s, h, rd)).astype(np.float32)
    c, kr = _mla_caches(rng, layers, n, r, rd)
    jc, tc = _both_fp8(c)
    jkr, tkr = _both_fp8(kr)
    bt = rng.permutation(n)[: b * w].reshape(b, w).astype(np.int32)
    ctx = np.array([s, 17, 40], np.int32)
    positions = (ctx - s)[:, None] + np.arange(s)[None, :]
    want = jax_deepseek.mla_attention(
        jnp.asarray(q_lat), jnp.asarray(q_rope), jc, jkr, 2, jnp.asarray(bt),
        jnp.asarray(positions), jnp.asarray(ctx), 0.4)
    got = deepseek.mla_attention(
        torch.from_numpy(q_lat), torch.from_numpy(q_rope), tc, tkr, 2,
        torch.from_numpy(bt), torch.from_numpy(positions),
        torch.from_numpy(ctx), 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


# ------------------------------------------------------- config and CLI


def _configs(family):
    hf = FAMILIES[family]
    return JaxModelConfig.from_hf_config(hf), ModelConfig.from_hf_config(hf)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fp8_runner_builds_e4m3_caches_for_every_family(family):
    """``kv_cache_dtype="fp8"`` builds every family's cache in e4m3 (half
    the bytes of a bf16 cache of the same blocks); the weights and the
    activations keep their dtype."""
    _, mcfg = _configs(family)
    runner = ModelRunner(EngineConfig(model=mcfg, max_model_len=64,
                                      num_kv_blocks=8, kv_block_size=BS,
                                      kv_cache_dtype="fp8", dtype="float32"),
                         device="cpu")
    assert runner.kv_dtype == FP8 and runner.dtype == torch.float32
    assert all(t.dtype == FP8 and t.element_size() == 1 for t in runner.kv_cache)
    assert runner.params["embed"].dtype == torch.float32
    bf16 = ModelRunner(EngineConfig(model=mcfg, max_model_len=64,
                                    num_kv_blocks=8, kv_block_size=BS,
                                    dtype="bfloat16"), device="cpu")
    assert [t.dtype for t in bf16.kv_cache] == [torch.bfloat16] * 2
    assert sum(t.numel() * t.element_size() for t in runner.kv_cache) * 2 == sum(
        t.numel() * t.element_size() for t in bf16.kv_cache)


def test_fp8_is_accepted_and_an_unknown_cache_dtype_raises_the_reference_error():
    jcfg, mcfg = _configs("llama")
    EngineConfig(model=mcfg, kv_cache_dtype="fp8")
    EngineConfig(model=mcfg, kv_cache_dtype="auto")
    # int8 weights beside an fp8 cache
    EngineConfig(model=dataclasses.replace(mcfg, quantization="int8"),
                 kv_cache_dtype="fp8")
    for bad in ("int8", "fp16", "e5m2"):
        with pytest.raises(ValueError) as port:
            EngineConfig(model=mcfg, kv_cache_dtype=bad)
        with pytest.raises(ValueError) as ref:
            JaxModelRunner(JaxEngineConfig(model=jcfg, kv_cache_dtype=bad))
        assert str(port.value) == str(ref.value) == (
            f"unknown kv_cache_dtype {bad!r} (auto | fp8)")
    # set after the config's own check: the runner checks again
    econf = EngineConfig(model=mcfg, max_model_len=64, num_kv_blocks=8,
                         dtype="float32")
    econf.kv_cache_dtype = "fp16"
    with pytest.raises(ValueError, match="unknown kv_cache_dtype 'fp16'"):
        ModelRunner(econf, device="cpu")


def test_sequence_parallel_prefill_with_fp8_is_refused_by_name():
    """SP prefill over an fp8 cache is served now (kernel 6's fp8 form):
    the config takes it and the kernel's guard routes e4m3 caches to the
    fp8 entry. What stays refused is refused by name: a mixed pair of
    caches, and head_dim 256 in either form."""
    _, mcfg = _configs("llama")
    EngineConfig(model=mcfg, sp_size=4, long_prefill_threshold_tokens=64,
                 max_model_len=256, kv_cache_dtype="fp8")
    q = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 4, BS, 2, 64, dtype=torch.bfloat16)
    bt = torch.zeros(1, 4, dtype=torch.int32)
    assert sp_prefix._check_cuda_inputs(q, k, k, bt, 8, 0) == "bf16"
    assert sp_prefix._check_cuda_inputs(q, k.to(FP8), k.to(FP8), bt, 8, 0) == "fp8"
    with pytest.raises(NotImplementedError, match="all bfloat16 or all float8_e4m3fn"):
        sp_prefix._check_cuda_inputs(q, k.to(FP8), k, bt, 8, 0)
    q256 = torch.zeros(1, 4, 4, 256, dtype=torch.bfloat16)
    k256 = torch.zeros(2, 4, BS, 2, 256, dtype=torch.bfloat16).to(FP8)
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        sp_prefix._check_cuda_inputs(q256, k256, k256, bt, 8, 0)


@pytest.mark.parametrize("heads", [8, 14], ids=["G4", "G7"])
@pytest.mark.parametrize("d", [64, 128])
def test_fp8_prefix_partials_plain_version_matches_pallas_interpret(d, heads):
    """Kernel 6's plain version over e4m3 caches against the reference's
    prefix kernel in interpret mode over the same bytes (it upcasts each
    page, ``pallas_sp.py:127-129``), at head_dim 64 and 128 and GQA groups
    4 and 7 over 2 KV heads, layer 2 of a stacked cache, a partial last
    page; f32 to ``OP_TOL``. CPU tensors never launch the kernel."""
    from dynamo_tpu.ops.pallas_sp import (
        paged_prefix_attention_partials as jax_prefix_partials,
    )

    rng = np.random.default_rng(zlib.crc32(f"sp-{d}-{heads}".encode()))
    b, s, kvh, layers, n, w = 2, 8, 2, 3, 12, 5
    q = rng.standard_normal((b, s, heads, d)).astype(np.float32)
    k = rng.standard_normal((layers, n, BS, kvh, d)).astype(np.float32)
    v = rng.standard_normal((layers, n, BS, kvh, d)).astype(np.float32)
    bt = rng.permutation(n)[: b * w].reshape(b, w).astype(np.int32)
    jk, tk = _both_fp8(k)
    jv, tv = _both_fp8(v)
    pfx = 2 * BS + 3
    ja, jm, jl = jax_prefix_partials(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                     pfx, 2, interpret=True)
    acc, m, l = sp_prefix.paged_prefix_attention_partials(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt), pfx, 2)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ja), **OP_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **OP_TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **OP_TOL)
    assert sp_prefix.launches == sp_prefix.launches_fp8 == 0


def test_cli_kv_cache_dtype_reaches_the_engine_config_as_in_the_reference():
    """``--kv-cache-dtype fp8`` is a served flag (no longer refused by
    name) and maps into ``EngineConfig.kv_cache_dtype`` as the reference's
    ``engine_config_from_mdc`` maps it; its default stays "auto"."""
    assert "--kv-cache-dtype" not in run.REFUSED_FLAGS
    mdc = types.SimpleNamespace(config=FAMILIES["llama"], context_length=256,
                                kv_block_size=16)
    for argv, want in ((["--kv-cache-dtype", "fp8"], "fp8"),
                       (["--kv-cache-dtype=fp8"], "fp8"), ([], "auto")):
        flags = run.parse_flags(argv + ["--num-kv-blocks", "32"])
        ref_flags = jax_build_parser().parse_args(argv + ["--num-kv-blocks", "32"])
        got = engine_config_from_mdc(mdc, flags, extra={})
        ref = jax_config_from_mdc(mdc, ref_flags, extra={})
        assert got.kv_cache_dtype == ref.kv_cache_dtype == want
    with pytest.raises(SystemExit):
        run.parse_flags(["--kv-cache-dtype", "fp16"])


# ----------------------------------------------------- whole-engine streams


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, vocab, n)] for n in lengths]


async def _jax_streams(jcfg, jparams, cfg_kw, batches, max_tokens):
    cfg = JaxEngineConfig(model=jcfg, **cfg_kw)
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


async def _torch_streams(mcfg, params, cfg_kw, batches, max_tokens):
    engine = await TorchServingEngine.create(
        EngineConfig(model=mcfg, **cfg_kw), params=params, device="cpu",
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
        streams = [await asyncio.gather(*(one(p) for p in batch))
                   for batch in batches]
        assert engine.runner.kv_cache[0].dtype == FP8
        return streams, engine.metrics()
    finally:
        await engine.close()


ENGINE = dict(max_batch_size=4, max_model_len=128, kv_block_size=BS,
              num_kv_blocks=64, dtype="float32", kv_cache_dtype="fp8")
# looping prompts: the ngram lookup finds their continuation
LOOPS = [[1, 9, 8, 9, 8, 9, 8], [5, 6, 7, 8] * 6, [1, 42, 42, 42, 42],
         [1, 17, 43, 99, 7, 250, 3]]

STREAMS = {
    # four prompts in one prefill batch, then a wave that shares a 24-token
    # prefix (prefix-cache hits over e4m3 blocks)
    "llama_prefix_hit": ("llama", {}, lambda v: (
        lambda first: [first, [first[2][:24] + [7, 8, 9], first[2]]])(
            _prompts(0, [5, 19, 33, 12], v)), 8),
    # chunked prefill and 4-step decode bursts
    "llama_chunked_burst4": ("llama", dict(
        max_prefill_tokens_per_step=16, prefill_buckets=[8, 16, 32, 64, 128],
        multi_step_decode=4), lambda v: [_prompts(1, [40, 9, 27], v)], 10),
    # ngram speculation: the verify step reads the e4m3 cache
    "llama_spec_ngram": ("llama", dict(spec_ngram_tokens=2, spec_ngram_match=2),
                         lambda v: [LOOPS], 20),
    # the MLA + MoE trunk: e4m3 latent and rope caches, a prefix-hit wave
    "mla_prefix_hit": ("deepseek", {}, lambda v: (
        lambda first: [first, [first[2][:24] + [7, 8, 9], first[2]]])(
            _prompts(0, [5, 19, 33, 12], v)), 8),
}


@pytest.mark.asyncio
@pytest.mark.parametrize("name", list(STREAMS))
async def test_fp8_greedy_streams_match_jax_engine(name):
    """Greedy streams of ``TorchServingEngine`` with an fp8 cache equal
    ``JaxServingEngine``'s with an fp8 cache, token for token, on shared
    weights (the weight bridge), on a Llama trunk (batched prefill and a
    prefix hit, chunked prefill with 4-step bursts, ngram speculation) and
    on an MLA trunk. Both write the same e4m3 bytes and compute in f32."""
    family, overrides, batches_fn, max_tokens = STREAMS[name]
    jcfg, mcfg = _configs(family)
    jparams = jax_resolve(jcfg).init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    params = from_jax_params(jax.device_get(jparams), mcfg, "cpu", "float32")
    cfg_kw = dict(ENGINE, **overrides)
    batches = batches_fn(mcfg.vocab_size)
    want = await _jax_streams(jcfg, jparams, cfg_kw, batches, max_tokens)
    got, metrics = await _torch_streams(mcfg, params, cfg_kw, batches, max_tokens)
    assert got == want
    assert all(len(s) == max_tokens for batch in got for s in batch)
    if "prefix_hit" in name:
        assert metrics["gpu_prefix_cache_hit_rate"] > 0
    if "spec" in name:
        assert metrics["spec_proposed_tokens"] > 0 and metrics["spec_accepted_tokens"] > 0
    if "burst4" in name:
        assert metrics["decode_steps"] < max_tokens - 1


def test_ml_dtypes_and_torch_agree_on_every_e4m3_byte_below_464():
    """The premise of the byte-exact tests: every e4m3 value (all 256
    bytes but NaN) and the midpoints between neighbours cast to the same
    byte in both packages, and every byte upcasts to the same value."""
    all_bytes = np.arange(256, dtype=np.uint8)
    vals = all_bytes.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    finite = np.isfinite(vals)
    t = torch.from_numpy(all_bytes.copy()).view(FP8).float().numpy()
    np.testing.assert_array_equal(t[finite], vals[finite])
    assert np.isnan(t[~finite]).all()
    srt = np.unique(vals[finite])
    mids = ((srt[1:] + srt[:-1]) / 2).astype(np.float32)
    probe = np.concatenate([srt, mids, np.nextafter(mids, np.float32(np.inf)),
                            np.nextafter(mids, np.float32(-np.inf))])
    probe = probe[np.abs(probe) <= 464.0]
    np.testing.assert_array_equal(
        torch.from_numpy(probe).to(FP8).view(torch.uint8).numpy(),
        probe.astype(ml_dtypes.float8_e4m3fn).view(np.uint8))
