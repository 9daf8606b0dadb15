"""Differential tests of the port's checkpoint loader
(``dynamo_tpu_torch/models/loader.py``) against the JAX package's
(``dynamo_tpu/models/loader.py``).

For each family ``transformers`` writes a tiny checkpoint of seeded weights
with ``save_pretrained`` (as the reference's ``tests/test_loaders.py``
does): Llama, Qwen2 at a GQA group of 7 (14 heads over 2), Phi-3 (fused
qkv and gate_up projections), Mixtral,
Qwen3-MoE, DeepSeek-V2 (MLA, a dense first layer, shared experts), Gemma-2
(non-zero norms) and GPT-OSS (non-zero sinks and biases). Both loaders read
it: every leaf of the port's tree equals the reference's after
``jax.device_get`` bit for bit, in f32 and in bf16. Then each family's
``ModelRunner(model_dir=...)`` in both packages: the port's prefill logits
over its loaded leaves equal the reference's to 1e-5 in f32, and four
greedy tokens are equal.

Dedicated cases: a sharded snapshot (index file, several shards); fp8
checkpoints in both scale schemes (``weight_scale`` per channel and per
tensor, DeepSeek's 128 x 128 ``weight_scale_inv`` blocks with partial edge
blocks); MXFP4 expert blocks (``_dequant_mxfp4`` and a GPT-OSS checkpoint
in the release format); int8 at load against the reference's
``quantize_params`` (``q`` and ``scale`` equal); a missing layer tensor and
a missing key, which raise by name; an architecture with no loader; the
runner's weight rule (no checkpoint: random weights only when allowed);
the safetensors reader's refusals of empty, truncated and malformed files.

Everything runs on the CPU at tiny widths.
"""

import dataclasses
import json
import os
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model_runner import ModelRunner as JaxModelRunner
from dynamo_tpu.models import loader as jax_loader
from dynamo_tpu.models import quant as jax_quant
from dynamo_tpu.models import resolve as jax_resolve
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.models import loader, resolve
from dynamo_tpu_torch.models.quant import QUANT_KEYS, QuantizedWeight

PROMPT = [1, 17, 43, 99, 7, 3, 25, 12, 5, 77, 31, 8]
GREEDY_TOKENS = 4
LOGITS_TOL = 1e-5

# tiny transformers configs, one a family (the reference tests' widths)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(
        vocab_size=256, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False)),
    # Qwen2.5-7B's group of 7 query heads a KV head, qkv biases
    "qwen2_g7": ("Qwen2Config", "Qwen2ForCausalLM", dict(
        vocab_size=256, hidden_size=112, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=14, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False,
        rope_theta=1000000.0, use_sliding_window=False)),
    # Phi-3's fused qkv and gate_up projections, split at load
    "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(
        vocab_size=256, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False,
        pad_token_id=0, bos_token_id=1, eos_token_id=2)),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM", dict(
        vocab_size=256, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, tie_word_embeddings=False)),
    "qwen3moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM", dict(
        vocab_size=256, hidden_size=32, intermediate_size=64,
        moe_intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, num_experts=4,
        num_experts_per_tok=2, norm_topk_prob=True,
        max_position_embeddings=128, rms_norm_eps=1e-6,
        tie_word_embeddings=False)),
    "deepseek_v2": ("DeepseekV2Config", "DeepseekV2ForCausalLM", dict(
        vocab_size=256, hidden_size=32, intermediate_size=64,
        moe_intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, n_routed_experts=4,
        num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1,
        norm_topk_prob=False, routed_scaling_factor=1.0,
        scoring_func="softmax", kv_lora_rank=16, q_lora_rank=24,
        qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
        max_position_embeddings=128, tie_word_embeddings=False, n_group=1,
        topk_group=1, topk_method="greedy")),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM", dict(
        vocab_size=256, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, query_pre_attn_scalar=8, sliding_window=4,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        max_position_embeddings=128)),
    "gptoss": ("GptOssConfig", "GptOssForCausalLM", dict(
        vocab_size=256, hidden_size=32, intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, rms_norm_eps=1e-6, sliding_window=4,
        tie_word_embeddings=False)),
}


def _save_family(name, d, dtype=torch.float32, **save_kw):
    """``transformers`` writes family ``name``'s tiny checkpoint to ``d``
    from seeded weights (norms, sinks and biases drawn non-zero, so their
    paths are exercised); returns the model."""
    import transformers

    cfg_cls, model_cls, kw = FAMILIES[name]
    cfg = getattr(transformers, cfg_cls)(**kw)
    torch.manual_seed(7)
    model = getattr(transformers, model_cls)(cfg)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if "norm" in pname:
                p.copy_(1.0 + 0.2 * torch.randn_like(p))
            elif "sinks" in pname or "bias" in pname:
                p.normal_(0.0, 0.5)
    model.to(dtype).save_pretrained(str(d), safe_serialization=True, **save_kw)
    return model


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            d = tmp_path_factory.mktemp(name)
            _save_family(name, d)
            cache[name] = str(d)
        return cache[name]
    return get


def _configs(model_dir, **overrides):
    jcfg = dataclasses.replace(JaxModelConfig.from_model_dir(model_dir),
                               **overrides)
    return jcfg, dataclasses.replace(ModelConfig.from_model_dir(model_dir),
                                     **overrides)


def _leaves(tree, prefix=""):
    """{dotted name: leaf} of a nested param dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _np(t):
    """A port leaf as numpy, bf16 as its bits (uint16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _np_ref(a):
    a = np.asarray(jax.device_get(a))
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(port, ref):
    lp, lr = _leaves(port), _leaves(jax.device_get(ref))
    assert sorted(lp) == sorted(lr)
    for name in lr:
        a, b = _np(lp[name]), _np_ref(lr[name])
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape)
        assert np.array_equal(a, b), name


def _load_both(model_dir, dtype, **overrides):
    jcfg, cfg = _configs(model_dir, **overrides)
    ref = jax_loader.load_checkpoint_params(
        model_dir, jcfg, jax_resolve(jcfg),
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    port = loader.load_checkpoint_params(
        model_dir, cfg, resolve(cfg),
        torch.bfloat16 if dtype == "bfloat16" else torch.float32, "cpu")
    return port, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_leaves_equal_reference(family_dirs, family, dtype):
    port, ref = _load_both(family_dirs(family), dtype)
    _assert_trees_equal(port, ref)


def _runners(model_dir, **overrides):
    """The reference's and the port's runner over ``model_dir`` in f32
    (the MoE capacity ample: no token drops in either)."""
    jcfg, cfg = _configs(model_dir, moe_capacity_factor=8.0, **overrides)
    kw = dict(max_batch_size=1, max_model_len=64, kv_block_size=8,
              num_kv_blocks=32, dtype="float32", prefill_buckets=[32])
    jrun = JaxModelRunner(JaxEngineConfig(
        model=dataclasses.replace(jcfg, attention_impl="xla"), **kw),
        model_dir=model_dir)
    prun = ModelRunner(EngineConfig(model=cfg, **kw), device="cpu",
                       model_dir=model_dir)
    return jrun, prun


def _prefill_logits(runner, tokens, port: bool):
    """Logits [n, V] of one prefill of ``tokens`` on blocks 0.. of the
    runner's cache through its family's forward."""
    s = 32
    cfg = runner.config
    bs, w = cfg.kv_block_size, cfg.blocks_per_seq
    n = len(tokens)
    tok = np.zeros((1, s), np.int32)
    tok[0, :n] = tokens
    pos = np.arange(s, dtype=np.int32)[None]
    btab = np.zeros((1, w), np.int32)
    btab[0, : s // bs] = np.arange(s // bs)
    slots = btab[0, pos // bs] * bs + pos % bs
    slots[pos >= n] = -1
    ctx = np.full(1, n, np.int32)
    if port:
        args = [torch.from_numpy(a) for a in (tok, pos, btab, slots, ctx)]
        with torch.inference_mode():
            out, _ = runner.arch.forward(runner.params, cfg.model, args[0],
                                         args[1], runner.kv_cache, *args[2:])
        return out[0, :n].float().numpy()
    out, _ = runner.arch.forward(runner.params, cfg.model, tok, pos,
                                 runner.kv_cache, btab, slots, ctx,
                                 mesh=runner.mesh)
    return np.asarray(out)[0, :n]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_runner_forward_and_greedy_equal_reference(family_dirs, family):
    jrun, prun = _runners(family_dirs(family))
    _assert_trees_equal(prun.params, jrun.params)
    np.testing.assert_allclose(_prefill_logits(prun, PROMPT, True),
                               _prefill_logits(jrun, PROMPT, False),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    seq_p, seq_j = list(PROMPT), list(PROMPT)
    for _ in range(GREEDY_TOKENS):
        seq_p.append(int(_prefill_logits(prun, seq_p, True)[-1].argmax()))
        seq_j.append(int(_prefill_logits(jrun, seq_j, False)[-1].argmax()))
    assert seq_p == seq_j


def test_sharded_snapshot_loads_like_one_file(tmp_path):
    one, many = tmp_path / "one", tmp_path / "many"
    _save_family("qwen2_g7", one)
    _save_family("qwen2_g7", many, max_shard_size="40KB")
    shards = sorted(p.name for p in many.iterdir() if p.suffix == ".safetensors")
    assert len(shards) > 2 and (many / "model.safetensors.index.json").exists()
    port, ref = _load_both(str(many), "float32")
    _assert_trees_equal(port, ref)
    single, _ = _load_both(str(one), "float32")
    for name, leaf in _leaves(single).items():
        assert torch.equal(leaf, _leaves(port)[name]), name


# ------------------------------------------------------------------ fp8


def _rewrite(model_dir, fn):
    """Replace ``model_dir``'s shards by one ``model.safetensors`` of
    ``fn(name, tensor)``'s {name: tensor} pieces (None drops the tensor)."""
    from safetensors.torch import load_file, save_file

    tensors = {}
    for f in sorted(os.listdir(model_dir)):
        if f.endswith(".safetensors"):
            tensors.update(load_file(os.path.join(model_dir, f)))
            os.remove(os.path.join(model_dir, f))
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        os.remove(index)
    out = {}
    for name, t in tensors.items():
        out.update(fn(name, t) or {})
    save_file(out, os.path.join(model_dir, "model.safetensors"))


def _fp8_per_channel(name, w):
    if not name.endswith("_proj.weight"):
        return {name: w.contiguous()}
    scale = (w.abs().amax(dim=1, keepdim=True).clamp(min=1e-8) / 448.0).float()
    return {name: (w / scale).to(torch.float8_e4m3fn), name + "_scale": scale[:, 0]}


def _fp8_per_tensor(name, w):
    if not name.endswith("_proj.weight"):
        return {name: w.contiguous()}
    scale = (w.abs().max().clamp(min=1e-8) / 448.0).float()
    return {name: (w / scale).to(torch.float8_e4m3fn), name + "_scale": scale}


def _fp8_blocks(name, w):
    """DeepSeek-native: a 128 x 128 block's scale inverse, partial blocks at
    the edges."""
    if not name.endswith("_proj.weight"):
        return {name: w.contiguous()}
    r, c = w.shape
    br, bc = -(-r // 128), -(-c // 128)
    pad = torch.zeros(br * 128, bc * 128)
    pad[:r, :c] = w.abs()
    amax = pad.reshape(br, 128, bc, 128).amax(dim=(1, 3)).clamp(min=1e-8)
    inv = (amax / 448.0).float()
    expanded = inv.repeat_interleave(128, 0).repeat_interleave(128, 1)[:r, :c]
    return {name: (w / expanded).to(torch.float8_e4m3fn),
            name + "_scale_inv": inv}


# widths over 128 so the blocks have partial edges (136 and 200)
FP8_LLAMA = dict(vocab_size=256, hidden_size=136, intermediate_size=200,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=128,
                 tie_word_embeddings=False)


@pytest.mark.parametrize("scheme", ["per_channel", "per_tensor", "blocks"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_checkpoint_leaves_equal_reference(tmp_path, scheme, dtype):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(11)
    LlamaForCausalLM(LlamaConfig(**FP8_LLAMA)).save_pretrained(
        str(tmp_path), safe_serialization=True)
    _rewrite(str(tmp_path), {"per_channel": _fp8_per_channel,
                             "per_tensor": _fp8_per_tensor,
                             "blocks": _fp8_blocks}[scheme])
    port, ref = _load_both(str(tmp_path), dtype)
    # the dequant is the reference's one f32 multiply, rounded to bf16
    # first: no reassociation, so bit for bit (0 ulp)
    _assert_trees_equal(port, ref)


def test_fp8_scales_in_another_shard(tmp_path):
    """The scales in a shard of their own (read outside its walk)."""
    from safetensors.torch import load_file, save_file
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(12)
    LlamaForCausalLM(LlamaConfig(**FP8_LLAMA)).save_pretrained(
        str(tmp_path), safe_serialization=True)
    _rewrite(str(tmp_path), _fp8_blocks)
    tensors = load_file(str(tmp_path / "model.safetensors"))
    (tmp_path / "model.safetensors").unlink()
    scales = {n: t for n, t in tensors.items() if n.endswith("_scale_inv")}
    save_file({n: t for n, t in tensors.items() if n not in scales},
              str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file(scales, str(tmp_path / "model-00002-of-00002.safetensors"))
    port, ref = _load_both(str(tmp_path), "bfloat16")
    _assert_trees_equal(port, ref)


def test_fp8_dequant_block_and_channel_scales():
    arr = torch.ones(130, 200)
    out = loader._dequant_fp8(arr, torch.tensor([[2.0, 3.0], [5.0, 7.0]]), True)
    assert out[0, 0] == 2.0 and out[127, 127] == 2.0 and out[0, 199] == 3.0
    assert out[129, 0] == 5.0 and out[129, 199] == 7.0
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 7)).astype(np.float32)
    for scale, inv in ((rng.random(5).astype(np.float32), False),
                       (np.float32(0.37), False),
                       (rng.random((1, 1)).astype(np.float32), True)):
        got = loader._dequant_fp8(torch.from_numpy(a), torch.tensor(scale), inv)
        want = jax_loader._dequant_fp8(a, np.asarray(scale), inv)
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------- MXFP4


def test_dequant_mxfp4_equals_reference():
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 256, (3, 6, 4, 16), dtype=np.uint8)
    scales = rng.integers(100, 150, (3, 6, 4), dtype=np.uint8)
    scales[0, 0, 0], scales[0, 0, 1] = 0, 255   # 2^-127 and 2^128 = inf
    got = loader._dequant_mxfp4(torch.from_numpy(blocks),
                                torch.from_numpy(scales)).numpy()
    want = jax_loader._dequant_mxfp4(blocks, scales)
    assert got.shape == want.shape == (3, 6, 128)
    assert np.array_equal(got, want, equal_nan=True)


def _mxfp4(name, t):
    """GPT-OSS's release format: the expert stacks as e2m1 blocks and e8m0
    scales ([E, out, in / 32, 16] and [E, out, in / 32]) of seeded values."""
    if not name.endswith(("experts.gate_up_proj", "experts.down_proj")):
        return {name: t.contiguous()}
    e, d_in, d_out = t.shape
    g = torch.Generator().manual_seed(len(name) + e)
    blocks = torch.randint(0, 256, (e, d_out, d_in // 32, 16), generator=g,
                           dtype=torch.uint8)
    scales = torch.randint(118, 130, (e, d_out, d_in // 32), generator=g,
                           dtype=torch.uint8)
    return {name + "_blocks": blocks, name + "_scales": scales}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mxfp4_checkpoint_leaves_equal_reference(tmp_path, dtype):
    _save_family("gptoss", tmp_path)
    _rewrite(str(tmp_path), _mxfp4)
    port, ref = _load_both(str(tmp_path), dtype)
    _assert_trees_equal(port, ref)


# ----------------------------------------------------------------- int8


@pytest.mark.parametrize("family", ["qwen2_g7", "mixtral", "deepseek_v2",
                                    "gptoss"])
def test_int8_at_load_equals_reference_quantize_params(family_dirs, family):
    d = family_dirs(family)
    jcfg, cfg = _configs(d, quantization="int8")
    ref = jax_quant.quantize_params(jax_loader.load_checkpoint_params(
        d, jcfg, jax_resolve(jcfg), jnp.bfloat16))
    port = loader.load_checkpoint_params(d, cfg, resolve(cfg), torch.bfloat16,
                                         "cpu")
    lp, lr = _leaves(port), _leaves(jax.device_get(ref))
    assert sorted(lp) == sorted(lr)
    n_quant = 0
    for name, want in lr.items():
        got = lp[name]
        if hasattr(want, "q"):
            n_quant += 1
            assert isinstance(got, QuantizedWeight), name
            assert name.rsplit(".", 1)[-1] in QUANT_KEYS
            assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
            assert np.array_equal(got.q.numpy(), np.asarray(want.q)), name
            assert np.array_equal(got.scale.numpy(), np.asarray(want.scale)), name
        else:
            assert np.array_equal(_np(got), _np_ref(want)), name
    assert n_quant >= 5


def test_runner_int8_loads_quantized_leaves_once(family_dirs):
    d = family_dirs("llama")
    _, cfg = _configs(d, quantization="int8")
    run = ModelRunner(EngineConfig(model=cfg, max_batch_size=1,
                                   max_model_len=64, kv_block_size=8,
                                   num_kv_blocks=16, dtype="bfloat16",
                                   prefill_buckets=[32]),
                      device="cpu", model_dir=d)
    direct = loader.load_checkpoint_params(d, cfg, resolve(cfg),
                                           torch.bfloat16, "cpu")
    for name, leaf in _leaves(direct).items():
        got = _leaves(run.params)[name]
        if isinstance(leaf, QuantizedWeight):
            assert torch.equal(got.q, leaf.q) and torch.equal(got.scale, leaf.scale)
        else:
            assert torch.equal(got, leaf)


# ------------------------------------------------------- refusals by name


def test_missing_layer_tensor_raises_by_name(tmp_path):
    _save_family("llama", tmp_path)
    _rewrite(str(tmp_path), lambda n, t: None if n == (
        "model.layers.1.mlp.down_proj.weight") else {n: t.contiguous()})
    _, cfg = _configs(str(tmp_path))
    with pytest.raises(ValueError, match=r"w_down has 1/2"):
        loader.load_checkpoint_params(str(tmp_path), cfg, resolve(cfg),
                                      torch.float32, "cpu")


def test_missing_key_raises_by_name(tmp_path):
    _save_family("mixtral", tmp_path)
    _rewrite(str(tmp_path), lambda n, t: None if "post_attention_layernorm" in n
             else {n: t.contiguous()})
    _, cfg = _configs(str(tmp_path))
    with pytest.raises(ValueError, match="ln2"):
        loader.load_checkpoint_params(str(tmp_path), cfg, resolve(cfg),
                                      torch.float32, "cpu")
    _save_family("llama", tmp_path / "b")
    _rewrite(str(tmp_path / "b"), lambda n, t: None if n == (
        "model.embed_tokens.weight") else {n: t.contiguous()})
    _, cfg = _configs(str(tmp_path / "b"))
    with pytest.raises(ValueError, match="embed"):
        loader.load_checkpoint_params(str(tmp_path / "b"), cfg, resolve(cfg),
                                      torch.float32, "cpu")


def test_architecture_without_loader_raises(tmp_path):
    fake = types.SimpleNamespace(__name__="dynamo_tpu_torch.models.rwkv")
    (tmp_path / "model.safetensors").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="rwkv"):
        loader.load_checkpoint_params(str(tmp_path), ModelConfig(), fake,
                                      torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="llama-family only"):
        loader.load_checkpoint_params(str(tmp_path / "m.gguf"), ModelConfig(),
                                      fake, torch.float32, "cpu")


def test_runner_weight_rule(tmp_path, family_dirs):
    _, cfg = _configs(family_dirs("llama"))
    ecfg = EngineConfig(model=cfg, max_batch_size=1, max_model_len=32,
                        kv_block_size=8, num_kv_blocks=8, dtype="float32",
                        prefill_buckets=[16])
    with pytest.raises(FileNotFoundError, match="random weights"):
        ModelRunner(ecfg, device="cpu", model_dir=str(tmp_path))
    drawn = ModelRunner(dataclasses.replace(ecfg, allow_random_weights=True),
                        device="cpu", model_dir=str(tmp_path))
    seeded = ModelRunner(ecfg, device="cpu")
    assert torch.equal(drawn.params["layers"]["wq"],
                       seeded.params["layers"]["wq"])
    loaded = ModelRunner(dataclasses.replace(ecfg, allow_random_weights=True),
                         device="cpu", model_dir=family_dirs("llama"))
    assert not torch.equal(loaded.params["layers"]["wq"],
                           seeded.params["layers"]["wq"])


def _write_header(path, header: dict, data: bytes = b""):
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


def test_reader_refuses_malformed_shards_by_file(tmp_path):
    cases = {
        "empty": b"",
        "short": b"\x01\x02",
        "runs_past": struct.pack("<Q", 1 << 20) + b"{}",
        "not_json": struct.pack("<Q", 4) + b"{{{{",
    }
    for name, blob in cases.items():
        p = tmp_path / f"{name}.safetensors"
        p.write_bytes(blob)
        with pytest.raises(loader.SafetensorsError, match=name):
            loader.read_header(str(p))
    bad = tmp_path / "offsets.safetensors"
    _write_header(bad, {"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}},
                  b"\0" * 8)
    with pytest.raises(loader.SafetensorsError, match="offsets.safetensors.*'w'"):
        loader.read_header(str(bad))
    dtype = tmp_path / "dtype.safetensors"
    _write_header(dtype, {"w": {"dtype": "C64", "shape": [1], "data_offsets": [0, 8]}},
                  b"\0" * 8)
    with pytest.raises(loader.SafetensorsError, match="unsupported dtype"):
        loader.read_header(str(dtype))


def test_reader_views_every_dtype(tmp_path):
    from safetensors.torch import save_file

    tensors = {
        "bf16": torch.randn(3, 5).bfloat16(), "f16": torch.randn(4).half(),
        "f32": torch.randn(2, 2, 2), "i8": torch.randint(-128, 127, (9,),
                                                         dtype=torch.int8),
        "u8": torch.randint(0, 255, (3, 3), dtype=torch.uint8),
        "i32": torch.randint(-9, 9, (5,), dtype=torch.int32),
        "i64": torch.randint(-9, 9, (2, 3)), "empty": torch.zeros(0, 4),
        "e4m3": torch.randn(6, 2).to(torch.float8_e4m3fn),
    }
    save_file(tensors, str(tmp_path / "all.safetensors"))
    shard = loader._Shard(str(tmp_path / "all.safetensors"))
    # read outside a walk (another shard's fp8 scale), then viewed in the
    # mapping while the shard is walked
    for opened in (False, True):
        if opened:
            shard.open()
        for name, want in tensors.items():
            got = shard.tensor(name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), name
