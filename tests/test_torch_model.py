"""Differential tests of the port's model, sampling and token hashing
against the JAX package.

Tiny widths (2 layers, hidden 64, 4 heads over 2 KV heads, head_dim 16,
block size 8, vocab 512); inputs and weights are made from a seed and
shared through numpy; f32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as jax_sampling
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.tokens import compute_block_hashes as jax_block_hashes
from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.tokens import TokenSequence, compute_block_hashes

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=256)
BS, N_BLOCKS = 8, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_params(cfg_kwargs, seed=0, qk_norms=False):
    jcfg = JaxModelConfig(**cfg_kwargs)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    if qk_norms:
        # Qwen3-family per-head q/k norms: the reference applies them when
        # the layer params carry them (qkv_prologue)
        rng = np.random.default_rng(seed + 1)
        for name in ("q_norm", "k_norm"):
            params["layers"][name] = jnp.asarray(
                1.0 + 0.2 * rng.standard_normal(
                    (jcfg.num_layers, jcfg.head_dim)), jnp.float32)
    if jcfg.attention_bias:
        # the reference initializes biases to zero: make them bite
        rng = np.random.default_rng(seed)
        for name in ("bq", "bk", "bv"):
            shape = params["layers"][name].shape
            params["layers"][name] = jnp.asarray(
                0.1 * rng.standard_normal(shape), jnp.float32)
    return jcfg, params


@pytest.mark.parametrize("extra", [
    {},
    {"tie_word_embeddings": True,
     "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64}},
    {"attention_bias": True, "rope_scaling": {"type": "linear", "factor": 2.0}},
    {"qk_norms": True},
], ids=["plain", "tied_llama3", "bias_linear", "qwen3_qk_norms"])
def test_forward_prefill_then_decode_matches_jax(extra):
    """Prefill, then two decode steps, through both packages with identical
    weights. Tolerance 1e-4, tighter than the reference's own HF bound
    (2e-3, tests/test_jax_engine.py): f32 on both sides agrees to a few
    1e-6, the rest is summation order. The cache is held against the JAX
    cache's unpadded head_dim."""
    extra = dict(extra)
    qk_norms = extra.pop("qk_norms", False)
    kw = dict(TINY, **extra)
    jcfg, jparams = _jax_params(kw, qk_norms=qk_norms)
    cfg = ModelConfig(**kw)
    params = from_jax_params(jax.device_get(jparams), cfg, "cpu", "float32")
    jcache = jax_llama.init_kv_cache(jcfg, N_BLOCKS, BS, jnp.float32)
    cache = llama.init_kv_cache(cfg, N_BLOCKS, BS, torch.float32)

    rng = np.random.default_rng(7)
    prompt_len, bucket = 11, 16
    blocks = np.array([[5, 2, 9, 0, 0, 0]], np.int32)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :prompt_len] = rng.integers(0, 512, prompt_len)
    positions = np.full((1, bucket), prompt_len - 1, np.int32)
    positions[0, :prompt_len] = np.arange(prompt_len)
    slots = np.full((1, bucket), -1, np.int32)
    slots[0, :prompt_len] = blocks[0, np.arange(prompt_len) // BS] * BS \
        + np.arange(prompt_len) % BS

    def run(tok, pos, slot, ctx):
        nonlocal jcache, cache
        jl, jcache = jax_llama.forward(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
            jnp.asarray(blocks), jnp.asarray(slot), jnp.asarray(ctx))
        tl, cache = llama.forward(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos), cache,
            torch.from_numpy(blocks), torch.from_numpy(slot),
            torch.from_numpy(ctx))
        return np.asarray(jl), tl.numpy()

    jl, tl = run(tokens, positions, slots, np.array([prompt_len], np.int32))
    np.testing.assert_allclose(tl[0, :prompt_len], jl[0, :prompt_len], **TOL)
    nxt = int(np.argmax(jl[0, prompt_len - 1]))
    for step in range(2):
        pos = prompt_len + step
        jl, tl = run(np.array([[nxt]], np.int32), np.array([[pos]], np.int32),
                     np.array([[blocks[0, pos // BS] * BS + pos % BS]], np.int32),
                     np.array([pos + 1], np.int32))
        np.testing.assert_allclose(tl, jl, **TOL)
        nxt = int(np.argmax(jl[0, 0]))
    hd = cfg.head_dim
    np.testing.assert_allclose(cache[0].numpy(), np.asarray(jcache[0])[..., :hd],
                               **TOL)
    np.testing.assert_allclose(cache[1].numpy(), np.asarray(jcache[1])[..., :hd],
                               **TOL)


def test_rope_frequencies_match_jax():
    for scaling in (None, {"type": "linear", "factor": 4.0},
                    {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192},
                    {"rope_type": "yarn", "factor": 4.0}):
        jf, ja = jax_llama.rope_frequencies(64, 500000.0, scaling)
        tf, ta = llama.rope_frequencies(64, 500000.0, scaling)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
        assert ta == ja
    # yarn is served since the MLA slice (tests/test_torch_mla.py covers
    # its variants); longrope belongs to a later family's slice
    with pytest.raises(NotImplementedError):
        llama.rope_frequencies(64, 1e4, {"rope_type": "longrope", "factor": 4.0})


def _jax_noise(keys, counters, v):
    """Gumbel noise drawn exactly as the reference runner draws it from
    its per-row keys (model_runner._sample_and_logprobs, fused branch)."""
    samp = jax_sampling.SamplingParams.zeros(len(counters))
    samp.keys = jnp.asarray(keys, jnp.uint32)
    samp.counters = jnp.asarray(counters, jnp.int32)
    row_keys = jax_sampling._row_keys(samp)
    return np.array(jax.vmap(
        lambda kk: jax.random.gumbel(kk, (v,), jnp.float32))(row_keys))


@pytest.mark.parametrize("case", [
    dict(temperature=0.0),
    dict(temperature=0.8),
    dict(temperature=1.0, top_k=5),
    dict(temperature=1.2, top_p=0.7),
    dict(temperature=0.9, min_p=0.2),
    dict(temperature=0.0, repetition_penalty=1.5),
    dict(temperature=0.0, frequency_penalty=0.7),
    dict(temperature=0.7, presence_penalty=1.1),
    dict(temperature=0.0, bias=True),
    dict(temperature=1.0, top_k=40, top_p=0.9, min_p=0.05,
         repetition_penalty=1.2, frequency_penalty=0.3, presence_penalty=0.2,
         bias=True),
], ids=["greedy", "temp", "topk", "topp", "minp", "rep", "freq", "pres",
        "bias", "all"])
def test_sample_and_logprobs_match_jax(case):
    rng = np.random.default_rng(11)
    b, v = 6, 512
    logits = (3.0 * rng.standard_normal((b, v))).astype(np.float32)
    counts = rng.integers(0, 3, (b, v)).astype(np.int32) * (rng.random((b, v)) < 0.05)
    seen = rng.random((b, v)) < 0.05
    bias = np.zeros((b, v), np.float32)
    if case.get("bias"):
        bias[:, rng.integers(0, v, 8)] = rng.standard_normal(8).astype(np.float32) * 5
    keys = rng.integers(0, 2**32, (b, 2), dtype=np.uint32)
    counters = rng.integers(0, 100, b).astype(np.int32)
    row = {k: np.full(b, case.get(k, d), np.float32) for k, d in (
        ("temperature", 0.0), ("top_p", 1.0), ("min_p", 0.0),
        ("presence_penalty", 0.0), ("frequency_penalty", 0.0),
        ("repetition_penalty", 1.0))}
    top_k = np.full(b, case.get("top_k", 0), np.int32)

    jsamp = jax_sampling.SamplingParams(
        temperature=jnp.asarray(row["temperature"]), top_k=jnp.asarray(top_k),
        top_p=jnp.asarray(row["top_p"]), min_p=jnp.asarray(row["min_p"]),
        presence_penalty=jnp.asarray(row["presence_penalty"]),
        frequency_penalty=jnp.asarray(row["frequency_penalty"]),
        repetition_penalty=jnp.asarray(row["repetition_penalty"]),
        keys=jnp.asarray(keys), counters=jnp.asarray(counters))
    jtok = np.asarray(jax_sampling.sample(
        jnp.asarray(logits), jsamp, jnp.asarray(counts), jnp.asarray(seen),
        bias=jnp.asarray(bias)))
    jlogp = jax.nn.log_softmax(jnp.asarray(logits) + jnp.asarray(bias), axis=-1)
    jtv, jti = jax_sampling.top_logprobs_for(jnp.asarray(logits), jlogp)

    samp = sampling.SamplingParams.from_host(
        "cpu", row["temperature"], top_k, row["top_p"], row["min_p"],
        row["presence_penalty"], row["frequency_penalty"],
        row["repetition_penalty"])
    gum = torch.from_numpy(_jax_noise(keys, counters, v))
    ttok = sampling.sample(torch.from_numpy(logits), samp, gum,
                           torch.from_numpy(counts), torch.from_numpy(seen),
                           bias=torch.from_numpy(bias)).numpy()
    np.testing.assert_array_equal(ttok, jtok)
    tlogp = torch.log_softmax(torch.from_numpy(logits + bias), dim=-1)
    tlp = torch.gather(tlogp, 1, torch.from_numpy(ttok)[:, None])[:, 0].numpy()
    jlp = np.take_along_axis(np.asarray(jlogp), jtok[:, None], 1)[:, 0]
    np.testing.assert_allclose(tlp, jlp, rtol=1e-5, atol=1e-5)
    ttv, tti = sampling.top_logprobs_for(torch.from_numpy(logits), tlogp)
    np.testing.assert_array_equal(tti.numpy(), np.asarray(jti))
    np.testing.assert_allclose(ttv.numpy(), np.asarray(jtv), rtol=1e-5, atol=1e-5)


def test_runner_noise_is_reproducible_per_request():
    """A seeded request samples the same tokens whatever its batch row or
    batchmates; different step counters draw different noise."""
    keys = np.array([[0, 42], [0, 42], [7, 9]], np.uint32)
    a = sampling.gumbel_noise(keys, np.array([3, 3, 3]), 64, "cpu")
    b = sampling.gumbel_noise(keys[::-1].copy(), np.array([3, 3, 3]), 64, "cpu")
    np.testing.assert_array_equal(a[0].numpy(), a[1].numpy())
    np.testing.assert_array_equal(a[0].numpy(), b[2].numpy())
    c = sampling.gumbel_noise(keys, np.array([4, 4, 4]), 64, "cpu")
    assert not np.array_equal(a[0].numpy(), c[0].numpy())
    only = sampling.gumbel_noise(keys, np.array([3, 3, 3]), 64, "cpu", rows=[2])
    assert not only[0].any() and np.array_equal(only[2].numpy(), a[2].numpy())


def test_count_commit_is_a_scatter_add():
    """Pad rows of a batched prefill share sample slot 0 with commit=False:
    they add 0 and never overwrite the live row's count."""
    cfg = EngineConfig(model=ModelConfig(**TINY), max_batch_size=4,
                       max_model_len=64, kv_block_size=BS, num_kv_blocks=N_BLOCKS,
                       dtype="float32")
    runner = ModelRunner(cfg, device="cpu")
    runner.sample_state[0][0, :] = 0
    rows, s = 4, 16
    z = np.zeros((rows, s), np.int32)
    toks = runner.step(z, z, np.zeros((rows, cfg.blocks_per_seq), np.int32),
                       np.full((rows, s), -1, np.int32), np.ones(rows, np.int32),
                       np.zeros(rows, np.int32), np.zeros(rows, np.float32),
                       np.zeros(rows, np.int32), np.ones(rows, np.float32),
                       sample_slots=np.zeros(rows, np.int32),
                       commit=np.array([True, False, False, False]))[0]
    counts = runner.sample_state[0]
    assert int(counts.sum()) == 1
    assert int(counts[0, int(toks[0])]) == 1


def test_block_hashes_match_reference():
    rng = np.random.default_rng(5)
    for n, bs in ((0, 16), (15, 16), (16, 16), (300, 16), (77, 8)):
        ids = [int(t) for t in rng.integers(0, 128256, n)]
        assert compute_block_hashes(ids, bs) == jax_block_hashes(ids, bs)
        assert compute_block_hashes(ids, bs, seed=9) == jax_block_hashes(ids, bs, seed=9)
    seq = TokenSequence(list(range(40)), block_size=8)
    assert seq.sequence_hashes() == jax_block_hashes(list(range(40)), 8)
