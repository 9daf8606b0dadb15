"""Draft-model speculation and the chained propose-verify round of the
port, against the JAX package.

- ``_ngram_props`` (the in-round prompt lookup over the carry's suffix ring)
  against the reference's on seeded rings, exactly;
- ``ModelRunner.decode_burst_spec`` against the reference's chained round,
  with given (draft) proposals and with ngram proposals: two rounds off one
  carry over rows that accept, reject, freeze on a stop id, on
  ``max_tokens`` and inside the round, and a row that is no member. Tokens,
  proposal and acceptance counts and the six carry arrays exactly; the
  cache to 1e-5 (f32 on both sides);
- ``TorchServingEngine`` with a draft against ``JaxServingEngine``: greedy
  streams and ``spec_proposed_tokens`` / ``spec_accepted_tokens`` equal on
  the synchronous and the chained path, self-drafts that accept every
  proposal, a prefix-cache hit, a preemption's resume, mixed greedy and
  sampled rows (the sampled rows step per token and keep the draft's
  mirror), an fp8 cache, and the named sync fallbacks of the chain;
- ``build_draft_config``'s refusals with the reference's messages.

The reference's fixtures: a 2-layer target and a different 1-layer draft,
written as HF safetensors snapshots with ``transformers`` (vocab 512,
hidden 64, 4 heads over 2 KV heads, head_dim 16), served in f32 on the CPU
(the port's plain routes).
"""

import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model_runner import ModelRunner as JaxModelRunner
from dynamo_tpu.engine.model_runner import _ngram_props as jax_ngram_props
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.engine.serving import build_draft_config as jax_build_draft_config
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols.common import OutputOptions as JaxOutput
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner, _ngram_props
from dynamo_tpu_torch.engine.sampling import (
    STOP_ID_WIDTH,
    STOP_SEQ_WIDTH,
    SUFFIX_RING_W,
    ring_init,
)
from dynamo_tpu_torch.engine.scheduler import build_prefill_arrays
from dynamo_tpu_torch.engine.serving import TorchServingEngine, build_draft_config
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    OutputOptions,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

from fixtures import make_model_dir

TINY_HF = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=256,
               rms_norm_eps=1e-5, rope_theta=10000.0)
BASE = dict(max_batch_size=2, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32", prefill_buckets=[32])
CHAIN = dict(decode_pipeline_depth=2)
PROMPTS = [[1, 17, 43, 99, 7, 3], [1, 250, 12, 5, 77, 140, 9, 33]]


def _save_llama(d, seed, layers=2):
    """An HF snapshot of a seeded random Llama (the reference's fixture)."""
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**{**TINY_HF, "num_hidden_layers": layers},
                      tie_word_embeddings=False)
    torch.manual_seed(seed)
    LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    with open(os.path.join(d, "config.json")) as f:
        c = json.load(f)
    c["eos_token_id"] = 2
    c["bos_token_id"] = 1
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(c, f)
    return d


@pytest.fixture(scope="module")
def target_dir(tmp_path_factory):
    return _save_llama(
        make_model_dir(tmp_path_factory.mktemp("target"), name="tiny-hf"), 0)


@pytest.fixture(scope="module")
def draft_dir(tmp_path_factory):
    # other weights and one layer: a different (worse) model
    return _save_llama(
        make_model_dir(tmp_path_factory.mktemp("draft"), name="tiny-draft"),
        7, layers=1)


# ------------------------------------------------------------ _ngram_props


@pytest.mark.parametrize("match,k", [(1, 2), (2, 4), (3, 4), (3, 16), (2, 16)])
def test_ngram_props_match_the_reference(match, k):
    """Rings over a small alphabet (so grams repeat), with -1 left pads of
    every length, including all-pad and pad-free rows."""
    rng = np.random.default_rng(100 * match + k)
    b, w = 64, SUFFIX_RING_W
    ring = rng.integers(0, 4, (b, w)).astype(np.int32)
    pads = rng.integers(0, w + 1, b)
    pads[:3] = (0, w, w - match)
    for i, n in enumerate(pads):
        ring[i, :n] = -1
    want = np.asarray(jax_ngram_props(jnp.asarray(ring), match, k))
    got = _ngram_props(torch.from_numpy(ring), match, k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got == -1).any()


# ------------------------------------------------------- decode_burst_spec


TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=256)
K = 4


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(5),
                                   jnp.float32)
    return params, jax.device_get(params)


def _round_cfgs(draft):
    common = dict(max_batch_size=4, max_model_len=64, kv_block_size=8,
                  num_kv_blocks=32, dtype="float32", **CHAIN)
    common.update(dict(spec_draft_model="draft", spec_draft_tokens=K) if draft
                  else dict(spec_ngram_tokens=K, spec_ngram_match=2))
    return (JaxEngineConfig(model=JaxModelConfig(**TINY), **common),
            EngineConfig(model=ModelConfig(**TINY), **common))


# looping prompts: the ring lookup finds continuations in them
ROUND_PROMPTS = [[7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8], [3, 4, 3, 4, 3, 4, 3],
                 [int(t) for t in np.random.default_rng(4).integers(3, 512, 12)],
                 [5, 6, 5, 6, 5]]
ROUND_BLOCKS = [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9, 10], [11, 12]]


def _round_inputs(first, probe):
    """Carry and finish rows: row 0 stops on the third token of its greedy
    stream (``probe``; none while probing), row 1 on ``max_tokens`` 3, row
    2 runs on, row 3 is no member."""
    b = 4
    stop_ids = np.full((b, STOP_ID_WIDTH), -1, np.int32)
    max_new = np.full(b, 40, np.int32)
    if probe is not None:
        stop_ids[0, 0] = probe[0][2]
        max_new[1] = 3
    btab = np.zeros((b, 8), np.int32)
    for i, blk in enumerate(ROUND_BLOCKS):
        btab[i, : len(blk)] = blk
    ring0 = np.stack([ring_init(p + [f]) for p, f in zip(ROUND_PROMPTS, first)])
    if probe is not None:
        # the carry's ring is an input: rows 0 and 2 hold their trailing
        # 2-gram earlier, followed by the greedy stream's next two tokens
        # and two others (the ngram lookup proposes all four)
        for r in (0, 2):
            ring0[r] = ring_init([50, first[r], *probe[r][:2], 77, 88, 50,
                                  first[r]])
    carry = (np.asarray(first, np.int32),
             np.asarray([len(p) for p in ROUND_PROMPTS], np.int32),
             np.ones(b, np.int32), np.zeros(b, bool), ring0,
             np.full(b, -1, np.int32))
    static = dict(
        commit=np.array([1, 1, 1, 0], bool), stop_ids=stop_ids,
        min_new=np.zeros(b, np.int32), max_new=max_new,
        stop_hash=np.zeros((b, STOP_SEQ_WIDTH), np.uint32),
        stop_hlen=np.zeros((b, STOP_SEQ_WIDTH), np.int32))
    return btab, carry, static


def _proposals(rnd, emitted, probe):
    """[B, K] proposals for round ``rnd``: seeded ids beside the greedy
    stream's next tokens (row 0 its first, row 2 its first two: accepted),
    -1 pads in row 1's tail and the non-member's row. No probe: all -1."""
    props = np.full((4, K), -1, np.int32)
    if probe is None:
        return props
    props[:] = np.random.default_rng(rnd).integers(3, 512, (4, K))
    for row, n in ((0, 1), (2, 2)):
        nxt = probe[row][emitted[row]: emitted[row] + n]
        props[row, : len(nxt)] = nxt
    props[1, 2:] = -1
    props[3] = -1
    return props


def _run_rounds(runner, cfg, draft, probe=None, rounds_n=2):
    first = []
    for i, (p, blk) in enumerate(zip(ROUND_PROMPTS, ROUND_BLOCKS)):
        t, pos, bt, sm, cl, li = build_prefill_arrays(cfg, p, 0, blk)
        out = runner.step(t, pos, bt, sm, cl, li, np.zeros(1, np.float32),
                          np.zeros(1, np.int32), np.ones(1, np.float32),
                          sample_slots=np.asarray([i], np.int32),
                          commit=np.zeros(1, bool), want_top=False)
        first.append(int(np.asarray(out[0])[0]))
    btab, carry, static = _round_inputs(first, probe)
    rounds, emitted = [], [0] * 4
    for rnd in range(rounds_n):
        props = _proposals(rnd, emitted, probe) if draft else None
        toks, nprop, nacc, carry = runner.decode_burst_spec(
            *carry, btab, proposals=props, **static)
        toks = np.asarray(toks)
        emitted = [e + int((toks[:, i] >= 0).sum()) for i, e in enumerate(emitted)]
        rounds.append((toks, np.asarray(nprop), np.asarray(nacc),
                       [np.asarray(c) for c in carry]))
    cache = [np.asarray(c)[..., :16] for c in runner.kv_cache]
    return first, rounds, cache


@pytest.mark.parametrize("draft", [True, False], ids=["proposals", "ngram"])
def test_decode_burst_spec_matches_reference(weights, draft):
    jcfg, cfg = _round_cfgs(draft)
    # a probe run learns each row's greedy stream (the accepted proposals
    # and the stop id are built from it)
    _, probe_rounds, _ = _run_rounds(JaxModelRunner(jcfg, params=weights[0]),
                                     jcfg, draft, rounds_n=8)
    probe = [[int(t) for r in probe_rounds for t in r[0][:, i] if t >= 0]
             for i in range(4)]
    want_first, want, want_cache = _run_rounds(
        JaxModelRunner(jcfg, params=weights[0]), jcfg, draft, probe)
    runner = ModelRunner(
        cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
        device="cpu")
    assert runner.spec_burst_ready
    first, got, cache = _run_rounds(runner, cfg, draft, probe)
    assert first == want_first
    for (toks, nprop, nacc, carry), (wt, wp, wa, wc) in zip(got, want):
        np.testing.assert_array_equal(toks, wt)
        np.testing.assert_array_equal(nprop, wp)
        np.testing.assert_array_equal(nacc, wa)
        for g, w in zip(carry, wc):   # tokens, positions, gen, done, ring,
            np.testing.assert_array_equal(g, w)   # gstate
    for g, w in zip(cache, want_cache):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # the case exercises what it claims: proposals counted and accepted,
    # a row frozen inside the rounds, the non-member silent
    toks_all = np.concatenate([r[0] for r in want])
    assert sum(int(r[1].sum()) for r in want) > 0
    assert sum(int(r[2].sum()) for r in want) > 0
    assert want[1][3][3][0]                 # row 0 froze on its stop id
    assert want[1][3][3][1]                 # row 1 froze on max_tokens
    assert (toks_all[:, 3] == -1).all() and not want[1][3][3][3]


# ------------------------------------------------------------ engines


def _reqs(prompts, max_tokens, samp=None):
    return [dict(prompt=p, max_tokens=max_tokens,
                 samp=dict(samp or dict(temperature=0.0))) for p in prompts]


async def _serve_jax(model_dir, requests, draft=None, k=4, concurrent=False,
                     **cfg_kw):
    cfg = JaxEngineConfig(
        model=JaxModelConfig.from_model_dir(model_dir),
        **{**BASE, "spec_draft_model": draft,
           "spec_draft_tokens": k if draft else 0, **cfg_kw})
    engine = await JaxServingEngine.create(
        JaxCard.from_local_path(model_dir), engine_config=cfg, warmup=False)

    async def one(r):
        req = JaxRequest(
            token_ids=r["prompt"],
            stop_conditions=JaxStop(max_tokens=r["max_tokens"], ignore_eos=True,
                                    **r.get("stop", {})),
            sampling_options=JaxSampling(**r["samp"]),
            output_options=JaxOutput(**r.get("out", {})))
        toks = []
        async for out in engine.generate(JaxContext(req)):
            toks.extend(out["token_ids"])
        return toks

    try:
        if concurrent:
            outs = list(await asyncio.gather(*(one(r) for r in requests)))
        else:
            outs = [await one(r) for r in requests]
        sched = engine.scheduler
        fallback = {dict(key)["reason"]: int(v)
                    for key, v in sched._sync_fallback_ctr.values.items()}
        return outs, sched.metrics(), fallback
    finally:
        await engine.close()


async def _serve_torch(model_dir, requests, draft=None, k=4, concurrent=False,
                       hook=None, **cfg_kw):
    cfg = EngineConfig(
        model=ModelConfig.from_model_dir(model_dir),
        **{**BASE, "spec_draft_model": draft,
           "spec_draft_tokens": k if draft else 0, **cfg_kw})
    engine = await TorchServingEngine.create(
        cfg, mdc=ModelDeploymentCard.from_local_path(model_dir), device="cpu",
        warmup=False)
    if hook is not None:
        hook(engine)

    async def one(r):
        req = PreprocessedRequest(
            token_ids=r["prompt"],
            stop_conditions=StopConditions(max_tokens=r["max_tokens"],
                                           ignore_eos=True, **r.get("stop", {})),
            sampling_options=SamplingOptions(**r["samp"]),
            output_options=OutputOptions(**r.get("out", {})))
        toks = []
        async for out in engine.generate(Context(req)):
            toks.extend(out["token_ids"])
        return toks

    try:
        if concurrent:
            outs = list(await asyncio.gather(*(one(r) for r in requests)))
        else:
            outs = [await one(r) for r in requests]
        sched = engine.scheduler
        assert not sched._chain and not sched._chain_members
        assert sched.allocator.used == 0
        return outs, engine.metrics(), dict(engine.metrics()["sync_fallback"])
    finally:
        await engine.close()


def _spec(metrics):
    return metrics["spec_proposed_tokens"], metrics["spec_accepted_tokens"]


@pytest.mark.asyncio
@pytest.mark.parametrize("chain", [False, True], ids=["sync", "chained"])
@pytest.mark.parametrize("concurrent", [False, True], ids=["serial", "batched"])
async def test_draft_engine_matches_jax_engine(target_dir, draft_dir, chain,
                                               concurrent):
    """The synchronous rounds (a draft burst, its host read, the verify) and
    the chained rounds (the draft's burst on the target's carry): the same
    streams as the reference's draft engine and as plain greedy decoding,
    the same proposals and acceptances."""
    kw = dict(CHAIN) if chain else {}
    reqs = _reqs(PROMPTS, 16)
    plain, _, _ = await _serve_torch(target_dir, reqs)
    want, wm, wfb = await _serve_jax(target_dir, reqs, draft_dir,
                                     concurrent=concurrent, **kw)
    got, gm, gfb = await _serve_torch(target_dir, reqs, draft_dir,
                                      concurrent=concurrent, **kw)
    assert got == want == plain
    assert _spec(gm) == _spec(wm)
    # a different random model: proposals flow, few or none verify (the
    # self-drafts below hold acceptance)
    assert gm["spec_proposed_tokens"] > 0
    assert 0 <= gm["spec_accepted_tokens"] <= gm["spec_proposed_tokens"]
    assert gfb == wfb
    if chain:
        # rounds chained: fewer chains than rounds, no fallback but the
        # prefill's
        assert gm["chain_len_max"] > 1
        assert set(gfb) <= {"not_idle"}


@pytest.mark.asyncio
@pytest.mark.parametrize("chain", [False, True], ids=["sync", "chained"])
async def test_self_draft_accepts_every_proposal(target_dir, chain):
    """Draft = target: every proposal verifies (a hole in the mirror cache
    would reject one), each round emits K + 1 tokens."""
    kw = dict(CHAIN) if chain else {}
    reqs = _reqs(PROMPTS, 16)
    plain, _, _ = await _serve_torch(target_dir, reqs)
    want, wm, _ = await _serve_jax(target_dir, reqs, target_dir, **kw)
    got, gm, _ = await _serve_torch(target_dir, reqs, target_dir, **kw)
    assert got == want == plain
    assert _spec(gm) == _spec(wm)
    assert gm["spec_proposed_tokens"] > 0
    assert gm["spec_accepted_tokens"] == gm["spec_proposed_tokens"]


@pytest.mark.asyncio
@pytest.mark.parametrize("chain", [False, True], ids=["sync", "chained"])
async def test_draft_prefix_hit_keeps_the_mirror(target_dir, chain):
    """A repeated prompt hits the target's prefix cache: the draft mirror
    shares the block ids, so its context is valid too (a self-draft still
    accepts everything) and the streams stay exact."""
    kw = dict(CHAIN) if chain else {}
    reqs = _reqs([PROMPTS[1] * 2, PROMPTS[1] * 2], 12)
    want, wm, _ = await _serve_jax(target_dir, reqs, target_dir, **kw)
    got, gm, _ = await _serve_torch(target_dir, reqs, target_dir, **kw)
    assert got == want and got[0] == got[1]
    assert gm["prefix_hit_tokens"] > 0
    assert gm["gpu_prefix_cache_hit_rate"] == wm["gpu_prefix_cache_hit_rate"]
    assert _spec(gm) == _spec(wm)
    assert gm["spec_accepted_tokens"] == gm["spec_proposed_tokens"] > 0


@pytest.mark.asyncio
@pytest.mark.parametrize("chain", [False, True], ids=["sync", "chained"])
async def test_draft_preemption_resume(target_dir, chain):
    """A KV budget too small for both streams preempts one: its re-prefill
    (prompt and emitted tokens) replays on the draft, so a self-draft still
    accepts every proposal, and the streams equal the reference's."""
    kw = dict(CHAIN) if chain else {}
    kw.update(num_kv_blocks=9, max_prefill_tokens_per_step=16)
    reqs = _reqs([PROMPTS[0] * 3, PROMPTS[1] * 2], 24)
    plain, pm, _ = await _serve_torch(target_dir, reqs, concurrent=True, **kw)
    want, wm, _ = await _serve_jax(target_dir, reqs, target_dir,
                                   concurrent=True, **kw)
    got, gm, _ = await _serve_torch(target_dir, reqs, target_dir,
                                    concurrent=True, **kw)
    assert got == want == plain
    assert gm["preemptions"] > 0 and pm["preemptions"] > 0
    assert _spec(gm) == _spec(wm)
    assert gm["spec_accepted_tokens"] == gm["spec_proposed_tokens"] > 0


def _mixed_requests():
    return [
        dict(prompt=PROMPTS[0], max_tokens=10, samp=dict(temperature=0.0)),
        dict(prompt=PROMPTS[1], max_tokens=6,
             samp=dict(temperature=1.0, seed=3)),
        dict(prompt=[1, 9, 9, 2], max_tokens=10,
             samp=dict(temperature=0.0,
                       guided_choice_token_ids=[[5, 9, 7], [40, 41]])),
        dict(prompt=[1, 40, 41, 7], max_tokens=8, samp=dict(temperature=0.0),
             out=dict(logprobs=2)),
    ]


@pytest.mark.asyncio
@pytest.mark.parametrize("chain", [False, True], ids=["sync", "chained"])
async def test_draft_mixed_traffic_keeps_the_mirror(target_dir, chain):
    """Greedy, seeded sampled, guided and logprob requests at once on a
    self-drafted engine: while a row is not spec-eligible every pass steps
    per token and mirrors the step on the draft, so once the greedy row
    speculates alone every proposal verifies. All four streams equal the
    draft-less engine's and the reference's, the spec counts the
    reference's (a chained engine names its sync passes as the reference
    does)."""
    kw = dict(CHAIN, max_batch_size=4) if chain else dict(max_batch_size=4)
    reqs = _mixed_requests()
    plain, _, _ = await _serve_torch(target_dir, reqs, concurrent=True, **kw)
    want, wm, wfb = await _serve_jax(target_dir, reqs, target_dir,
                                     concurrent=True, **kw)
    got, gm, gfb = await _serve_torch(target_dir, reqs, target_dir,
                                      concurrent=True, **kw)
    assert got == plain
    # the seeded row draws the port's own noise: it is held within the
    # port, the greedy rows against the reference too
    assert [got[i] for i in (0, 2, 3)] == [want[i] for i in (0, 2, 3)]
    assert len(got[1]) == len(want[1]) == 6
    assert got[2] in ([5, 9, 7], [40, 41])
    assert _spec(gm) == _spec(wm)
    assert gm["spec_accepted_tokens"] == gm["spec_proposed_tokens"] > 0
    assert gfb == wfb
    if chain:
        assert gfb.get("draft_mirror", 0) > 0


@pytest.mark.asyncio
async def test_draft_on_an_fp8_cache(target_dir, draft_dir):
    """The draft inherits the target's cache dtype: with an e4m3 cache the
    drafted streams equal the plain fp8 engine's and the reference's, and
    a self-draft accepts every proposal."""
    reqs = _reqs(PROMPTS, 10)
    plain, _, _ = await _serve_torch(target_dir, reqs, kv_cache_dtype="fp8")
    want, wm, _ = await _serve_jax(target_dir, reqs, draft_dir,
                                   kv_cache_dtype="fp8")
    got, gm, _ = await _serve_torch(target_dir, reqs, draft_dir,
                                    kv_cache_dtype="fp8")
    assert got == want == plain
    assert _spec(gm) == _spec(wm)
    got_self, sm, _ = await _serve_torch(target_dir, reqs, target_dir,
                                         kv_cache_dtype="fp8", **CHAIN)
    assert got_self == plain
    assert sm["spec_accepted_tokens"] == sm["spec_proposed_tokens"] > 0


FALLBACK_CASES = {
    # more hidden stop ids than the device row holds: not device-checkable
    "stop_ids_overflow": (dict(stop=dict(stop_token_ids_hidden=list(
        range(300, 300 + STOP_ID_WIDTH + 1)))), {}),
    # a stop string while the device's approximation is off
    "stop_strings_disabled": (dict(stop=dict(
        stop=["zz"], stop_token_seqs=[[500, 501]])),
        dict(device_stop_strings=False)),
    # rows run into the model length: the last rounds go synchronous
    "spec_near_horizon": (dict(max_tokens=30), dict(max_model_len=48)),
}


@pytest.mark.asyncio
@pytest.mark.parametrize("source", ["draft", "ngram"])
@pytest.mark.parametrize("case", sorted(FALLBACK_CASES))
async def test_spec_chain_fallbacks_are_named_as_the_reference(
        target_dir, case, source):
    """Passes the speculative chain cannot take are counted under the
    reference's reason (``_spec_chain_reason``), pass for pass, beside the
    prefill's ``not_idle``: the same ``sync_fallback`` counts, streams and
    spec counts as the reference's engine."""
    req_kw, cfg_kw = FALLBACK_CASES[case]
    reqs = [dict(prompt=PROMPTS[i] * 3, samp=dict(temperature=0.0),
                 **{"max_tokens": 12, **req_kw}) for i in (0, 1)]
    kw = dict(CHAIN, **cfg_kw)
    if source == "ngram":
        kw.update(spec_ngram_tokens=4, spec_ngram_match=1)
    draft = target_dir if source == "draft" else None
    want, wm, wfb = await _serve_jax(target_dir, reqs, draft, **kw)
    got, gm, gfb = await _serve_torch(target_dir, reqs, draft, **kw)
    assert got == want
    assert gfb == wfb
    assert gfb.get(case, 0) > 0
    assert _spec(gm) == _spec(wm)


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("case", ["vocab", "horizon", "tokens_low",
                                  "tokens_high", "exclusive", "host_tier",
                                  "no_model"])
def test_draft_refusals_match_the_reference(target_dir, tmp_path, case):
    """``build_draft_config`` and ``EngineConfig`` refuse the same draft
    setups with the reference's messages."""
    other = make_model_dir(tmp_path, name="wide-vocab",
                           config_overrides=dict(vocab_size=1024))
    kw = dict(spec_draft_model=target_dir, spec_draft_tokens=4,
              max_model_len=128)
    build = False
    if case == "vocab":
        kw["spec_draft_model"], build = other, True
    elif case == "horizon":
        kw["max_model_len"], build = 4096, True
    elif case == "tokens_low":
        kw["spec_draft_tokens"] = 1
    elif case == "tokens_high":
        kw["spec_draft_tokens"] = 17
    elif case == "exclusive":
        kw["spec_ngram_tokens"] = 4
    elif case == "host_tier":
        kw["host_kv_blocks"] = 8
    else:
        kw["spec_draft_model"] = None

    def port():
        cfg = EngineConfig(model=ModelConfig.from_model_dir(target_dir), **kw)
        build_draft_config(cfg)

    def ref():
        cfg = JaxEngineConfig(model=JaxModelConfig.from_model_dir(target_dir),
                              **kw)
        jax_build_draft_config(cfg)

    assert _refusal(port) == _refusal(ref)
    if build:
        assert "draft" in _refusal(port)


@pytest.mark.parametrize("kw", [dict(prefix_pull=True),
                                dict(decode_pipeline_depth=2, sp_size=1),
                                dict(kv_cache_dtype="fp8")],
                         ids=["prefix_pull", "chain", "fp8"])
def test_draft_is_accepted_where_the_reference_serves_it(target_dir, draft_dir,
                                                         kw):
    """A draft beside peer prefix pulls (a pulled block's draft KV is stale:
    acceptance drops, the stream does not), the chained loop and an fp8
    cache: accepted by both packages."""
    common = dict(spec_draft_model=draft_dir, spec_draft_tokens=4,
                  max_model_len=128, **kw)
    for cfg in (EngineConfig(model=ModelConfig.from_model_dir(target_dir),
                             **common),
                JaxEngineConfig(model=JaxModelConfig.from_model_dir(target_dir),
                                **common)):
        assert cfg.spec_draft_model == draft_dir
        for k, v in kw.items():
            assert getattr(cfg, k) == v


def test_draft_config_mirrors_the_target(target_dir, draft_dir):
    kw = dict(max_model_len=128, spec_draft_model=draft_dir,
              spec_draft_tokens=6, kv_cache_dtype="fp8", num_kv_blocks=40,
              decode_pipeline_depth=2)
    got = build_draft_config(
        EngineConfig(model=ModelConfig.from_model_dir(target_dir), **kw))
    want = jax_build_draft_config(
        JaxEngineConfig(model=JaxModelConfig.from_model_dir(target_dir), **kw))
    for f in ("multi_step_decode", "spec_draft_model", "spec_draft_tokens",
              "tp_size", "kv_cache_dtype", "num_kv_blocks", "kv_block_size",
              "max_model_len", "max_batch_size", "decode_pipeline_depth"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.multi_step_decode == 7 and got.spec_draft_model is None
    assert got.model.num_layers == want.model.num_layers == 1
    assert not ModelRunner(got, device="cpu").spec_burst_ready
