"""The dispatch-ahead and chained device-finish decode loop of the port,
against the JAX package and within the port.

- ``kv_write_plan`` (fixed shape, no host read) leaves the cache equal to
  the reference's ``mode="drop"`` scatter with ``-1`` and out-of-layer
  slots mixed in, exactly.
- ``ModelRunner.decode_burst_chained`` against the reference's on a tiny
  Llama with the weights carried across: greedy rows, two chained bursts,
  rows that freeze on ``max_new``, on a stop id, on a stop-sequence hash
  and on a guided table, and a row that is no member. Tokens and the six
  carry arrays exact; logprobs and every cache layer to 1e-4 (f32 on both
  sides, different summation order).
- ``TorchServingEngine`` at ``decode_pipeline_depth=2``,
  ``multi_step_decode=4`` against ``JaxServingEngine`` at the same
  settings: greedy streams and finish reasons exactly equal.
- Within the port: chained = pipelined (``device_finish="off"``) =
  synchronous, tokens and finish reasons exact, logprobs to 1e-6, with
  seeded ``temperature > 0`` rows, penalties, bias, logprobs and guided
  rows; chain bookkeeping (length, device finishes, named fallbacks, a
  forced hash collision, a KV budget that runs out, no leaked block).

Tiny widths (2 layers, hidden 64, 4 heads over 2 KV heads, head_dim 16,
block size 8, vocab 512), f32, CPU: the port takes its plain versions.
"""

import asyncio
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import guided as jax_guided
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model_runner import ModelRunner as JaxModelRunner
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.ops.attention import scatter_kv_stacked as jax_scatter
from dynamo_tpu.protocols.common import OutputOptions as JaxOutput
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import guided
from dynamo_tpu_torch.engine import scheduler as torch_scheduler
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.sampling import (
    STOP_ID_WIDTH,
    ring_init,
    stop_seq_hash,
    stop_seq_rows,
)
from dynamo_tpu_torch.engine.scheduler import build_prefill_arrays
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops.attention import (
    alloc_kv_cache,
    kv_write_plan,
    scatter_kv_stacked,
)
from dynamo_tpu_torch.protocols.common import (
    OutputOptions,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=256)
HD = 16
BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32")
LOOP = dict(decode_pipeline_depth=2, multi_step_decode=4)


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(3),
                                   jnp.float32)
    return params, jax.device_get(params)


# ------------------------------------------------------------ kv_write_plan


@pytest.mark.parametrize("spare", [False, True])
@pytest.mark.parametrize("case", ["mixed", "all_dropped", "all_kept",
                                  "drops_first"])
def test_kv_write_plan_leaves_the_reference_cache(case, spare):
    """Both formulations of the plan: caches with the spare row dropped
    writes go to (``alloc_kv_cache``, what the engine allocates) and plain
    tensors (dropped rows repeat the first kept row's write)."""
    rng = np.random.default_rng(0)
    layers, n_blocks, bs, kvh, d = 3, 5, 8, 2, 16
    per_layer = n_blocks * bs
    k = rng.standard_normal((layers, n_blocks, bs, kvh, d)).astype(np.float32)
    v = rng.standard_normal((layers, n_blocks, bs, kvh, d)).astype(np.float32)
    new_k = rng.standard_normal((2, 6, kvh, d)).astype(np.float32)
    new_v = rng.standard_normal((2, 6, kvh, d)).astype(np.float32)
    slots = {
        # -1 sentinels, slots past the layer, ordinary slots (unique), and a
        # kept row on slot 0 (where a dropped row must not land its value)
        "mixed": [[3, -1, 17, per_layer, 0, -1],
                  [per_layer + 7, 39, 8, -1, 21, 22]],
        "all_dropped": [[-1, -1, per_layer, -1, -1, 3 * per_layer],
                        [-1] * 6],
        "all_kept": [[0, 1, 2, 3, 4, 5], [39, 38, 37, 36, 35, 34]],
        "drops_first": [[-1, -1, -1, 12, -1, -1], [-1, per_layer, 5, -1, -1, 0]],
    }[case]
    slots = np.asarray(slots, np.int32)
    plan = kv_write_plan(torch.from_numpy(slots), per_layer)
    # fixed shapes, whatever the data
    assert plan.rows.shape == plan.slots.shape == (12,)
    assert plan.any_kept.shape == () and plan.dst(layers).shape == (layers, 12)
    assert bool(plan.any_kept) == (case != "all_dropped")
    if spare:
        tk = alloc_kv_cache(k.shape, torch.float32, "cpu").copy_(torch.from_numpy(k))
        tv = alloc_kv_cache(v.shape, torch.float32, "cpu").copy_(torch.from_numpy(v))
        assert tk.shape == k.shape and tk.is_contiguous()
    else:
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    for li in (2, 0, 1):       # every layer of one cache, as a forward does
        jk, jv = jax_scatter(jk, jv, jnp.asarray(new_k), jnp.asarray(new_v),
                             jnp.asarray(slots), jnp.int32(li))
        ok, ov = scatter_kv_stacked(tk, tv, torch.from_numpy(new_k),
                                    torch.from_numpy(new_v),
                                    torch.from_numpy(slots), li)
        assert ok.data_ptr() == tk.data_ptr()  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if case == "all_dropped":
        np.testing.assert_array_equal(tk.numpy(), k)


# ------------------------------------------------- decode_burst_chained


def _runner_cfgs(**kw):
    common = dict(BASE, max_model_len=64, num_kv_blocks=32, **LOOP, **kw)
    return (JaxEngineConfig(model=JaxModelConfig(**TINY), **common),
            EngineConfig(model=ModelConfig(**TINY), **common))


PROMPTS = [[int(t) for t in np.random.default_rng(11).integers(3, 512, n)]
           for n in (13, 9, 21, 5)]
CHOICES = [[40, 41, 42, 43, 44, 45, 46, 47, 48, 49], [40, 41, 50], [60]]
# the runner case's guided row must walk its table: no one-token choice
WALK_CHOICES = CHOICES[:2]


def _prefill(runner, cfg, prompts, blocks):
    """Greedy prefill of every prompt as one batch-of-1 step each; returns
    the first sampled token of each row."""
    first = []
    for i, (p, blk) in enumerate(zip(prompts, blocks)):
        t, pos, bt, sm, cl, li = build_prefill_arrays(cfg, p, 0, blk)
        out = runner.step(t, pos, bt, sm, cl, li, np.zeros(1, np.float32),
                          np.zeros(1, np.int32), np.ones(1, np.float32),
                          sample_slots=np.asarray([i], np.int32),
                          commit=np.zeros(1, bool), want_top=False)
        first.append(int(np.asarray(out[0])[0]))
    return first


def _chained_inputs(cfg, first, blocks, stops):
    b = cfg.max_batch_size
    btab = np.zeros((b, cfg.blocks_per_seq), np.int32)
    for i, blk in enumerate(blocks):
        btab[i, : len(blk)] = blk
    ring0 = np.stack([ring_init(p + [f]) for p, f in zip(PROMPTS, first)])
    zf = np.zeros(b, np.float32)
    static = dict(
        min_p=zf, presence_penalty=zf, frequency_penalty=zf,
        repetition_penalty=np.ones(b, np.float32),
        seed_keys=np.zeros((b, 2), np.uint32),
        commit=np.array([1, 1, 1, 0], bool), want_top=True, **stops)
    carry = (np.asarray(first, np.int32),
             np.asarray([len(p) for p in PROMPTS], np.int32),
             np.ones(b, np.int32), np.zeros(b, bool), ring0,
             np.array([-1, -1, 1, -1], np.int32))
    return btab, static, carry


def _run_chain(runner, cfg, stops, gtable, is_torch):
    """Prefill, then two chained bursts; returns per burst (toks, lps) and
    the carry, plus the final cache, as numpy."""
    blocks = [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9, 10, 11], [12, 13]]
    first = _prefill(runner, cfg, PROMPTS, blocks)
    btab, static, carry = _chained_inputs(cfg, first, blocks, stops)
    bursts = []
    for n in range(2):
        tokens0, positions0, gen0, done0, ring0, gstate0 = carry
        extra = dict(counters=np.ones(4, np.int32) + 4 * n) if is_torch else {}
        toks, lps, tvs, tis, carry = runner.decode_burst_chained(
            tokens0, positions0, gen0, done0, btab, np.zeros(4, np.float32),
            np.zeros(4, np.int32), np.ones(4, np.float32), ring0=ring0,
            gstate0=gstate0, gtable=gtable, **static, **extra)
        bursts.append((np.asarray(toks), np.asarray(lps), np.asarray(tvs),
                       np.asarray(tis), [np.asarray(c) for c in carry]))
    cache = [np.asarray(c)[..., :HD] for c in runner.kv_cache]
    return first, bursts, cache


def _stops(probe_tokens):
    """Finish inputs built around the reference's unconstrained greedy
    tokens: row 0 stops on the id it samples at step 5 (second burst), row
    1 on the hash of its tokens 2..3 (first burst), row 2 is guided."""
    b = 4
    stop_ids = np.full((b, STOP_ID_WIDTH), -1, np.int32)
    stop_ids[0, :2] = [int(probe_tokens[0][5]), 2]
    stop_hash = np.zeros((b, 4), np.uint32)
    stop_hlen = np.zeros((b, 4), np.int32)
    stop_hash[1, 1] = stop_seq_hash(probe_tokens[1][2:4])
    stop_hlen[1, 1] = 2
    return dict(stop_ids=stop_ids, min_new=np.zeros(b, np.int32),
                max_new=np.array([50, 50, 50, 50], np.int32),
                stop_hash=stop_hash, stop_hlen=stop_hlen)


@pytest.fixture(scope="module")
def jax_chain(weights):
    jcfg, _ = _runner_cfgs()
    none = dict(stop_ids=np.full((4, STOP_ID_WIDTH), -1, np.int32),
                min_new=np.zeros(4, np.int32), max_new=np.full(4, 50, np.int32))
    jtable = jax_guided.compile_device_table(
        jax_guided.TrieConstraint(WALK_CHOICES), TINY["vocab_size"], [2])
    first, probe, _ = _run_chain(JaxModelRunner(jcfg, params=weights[0]), jcfg,
                                 none, jtable.device(64), False)
    # each row's greedy stream after the prefill token, steps 0..7
    probe_tokens = [[first[r]] + [int(bst[0][j, r]) for bst in probe
                                  for j in range(4)] for r in range(4)]
    stops = _stops(probe_tokens)
    stops["max_new"][2] = 50
    want = _run_chain(JaxModelRunner(jcfg, params=weights[0]), jcfg, stops,
                      jtable.device(64), False)
    return stops, want


@pytest.mark.parametrize("fused", ["auto", "on"])
def test_decode_burst_chained_matches_reference(weights, jax_chain, fused):
    stops, (want_first, want_bursts, want_cache) = jax_chain
    _, cfg = _runner_cfgs(fused_epilogue=fused)
    runner = ModelRunner(
        cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
        device="cpu")
    assert runner.fused_epilogue == (fused == "on")
    table = guided.compile_device_table(
        guided.TrieConstraint(WALK_CHOICES), TINY["vocab_size"], [2])
    gtable = table.device(runner.guided_state_bucket(table.n_states), "cpu")
    first, bursts, cache = _run_chain(runner, cfg, stops, gtable, True)
    assert first == want_first
    for (toks, lps, tvs, tis, carry), (wt, wl, wtv, wti, wcarry) in zip(
            bursts, want_bursts):
        np.testing.assert_array_equal(toks, wt)
        np.testing.assert_allclose(lps, wl, rtol=1e-4, atol=1e-4)
        # the guided row's masked ids tie at -1e9, in either package's
        # own order: its alternatives are held by value only
        np.testing.assert_array_equal(tis[:, [0, 1, 3]], wti[:, [0, 1, 3]])
        np.testing.assert_allclose(tvs, wtv, rtol=1e-4, atol=1e-4)
        for got, want in zip(carry, wcarry):   # tokens, positions, gen,
            np.testing.assert_array_equal(got, want)  # done, ring, gstate
    for got, want in zip(cache, want_cache):
        np.testing.assert_allclose(got.numpy() if hasattr(got, "numpy") else got,
                                   want, rtol=1e-4, atol=1e-4)
    # the case really froze rows ([K, B] tokens): row 0 on its stop id at
    # the first step of the second burst, row 1 on the stop-sequence hash
    # within the first, the guided row 2 walks 40, 41 and then a third
    # state; row 3 is no member and emits pads only
    t1, t2 = want_bursts[0][0], want_bursts[1][0]
    assert (t1[:, 0] >= 0).all() and t2[0, 0] >= 0 and (t2[1:, 0] == -1).all()
    assert t1[0, 1] >= 0 and t1[3, 1] == -1 and (t2[:, 1] == -1).all()
    assert t1[:3, 2].tolist()[:2] == [40, 41] and t1[2, 2] in (42, 50)
    assert (t1[:, 3] == -1).all() and (t2[:, 3] == -1).all()
    done = want_bursts[1][4][3]
    assert done[0] and done[1] and not done[3]
    gstate = want_bursts[0][4][5]
    assert gstate[2] > 1 and (gstate[[0, 1, 3]] == -1).all()


# ------------------------------------------------------ engine streams


def _probe_prompts():
    rng = np.random.default_rng(21)
    return [[int(t) for t in rng.integers(3, 512, n)]
            for n in (14, 9, 23, 6, 17, 11, 8)]


async def _serve_torch(weights, cfg_kw, requests, hook=None):
    """Serve ``requests`` (dicts: prompt, samp, stop, out, after) on a CPU
    engine; returns ([(tokens, logprobs, finish)], metrics, blocks in use
    after the run)."""
    cfg = EngineConfig(model=ModelConfig(**TINY), **cfg_kw)
    engine = await TorchServingEngine.create(
        cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
        device="cpu", warmup=False)
    if hook is not None:
        hook(engine)
    started = asyncio.Event()

    async def one(r):
        if r.get("after"):
            # a late arrival: admitted while the first wave is decoding
            await started.wait()
        req = PreprocessedRequest(
            token_ids=r["prompt"], eos_token_ids=r.get("eos") or [],
            stop_conditions=StopConditions(**r["stop"]),
            sampling_options=SamplingOptions(**r.get("samp", dict(temperature=0.0))),
            output_options=OutputOptions(**r.get("out", {})))
        toks, lps, reasons = [], [], []
        async for out in engine.generate(Context(req)):
            toks.extend(out["token_ids"])
            lps.extend(lp["logprob"] for lp in out.get("logprobs") or [])
            reasons.append(out.get("finish_reason"))
            if len(toks) >= 3:
                started.set()
        return toks, lps, reasons[-1]

    try:
        outs = await asyncio.gather(*(one(r) for r in requests))
        metrics = engine.metrics()
        sched = engine.scheduler
        assert not sched._chain and not sched._chain_members
        assert sched._inflight is None
        return outs, metrics, sched.allocator.used
    finally:
        await engine.close()


async def _serve_jax(weights, cfg_kw, requests):
    cfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **cfg_kw)
    engine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=cfg,
        params=weights[0], warmup=False)
    started = asyncio.Event()

    async def one(r):
        if r.get("after"):
            await started.wait()
        req = JaxRequest(
            token_ids=r["prompt"], eos_token_ids=r.get("eos") or [],
            stop_conditions=JaxStop(**r["stop"]),
            sampling_options=JaxSampling(**r.get("samp", dict(temperature=0.0))),
            output_options=JaxOutput(**r.get("out", {})))
        toks, reasons = [], []
        async for out in engine.generate(JaxContext(req)):
            toks.extend(out["token_ids"])
            reasons.append(out.get("finish_reason"))
            if len(toks) >= 3:
                started.set()
        return toks, reasons[-1]

    try:
        return await asyncio.gather(*(one(r) for r in requests))
    finally:
        await engine.close()


@pytest.fixture(scope="module")
def probe(weights):
    """Each probe prompt's unconstrained greedy stream of 16 tokens, from
    the port's synchronous engine."""
    reqs = [dict(prompt=p, stop=dict(max_tokens=16, ignore_eos=True))
            for p in _probe_prompts()]
    outs = []
    for i in range(0, len(reqs), 4):
        got, _, _ = asyncio.run(_serve_torch(weights, BASE, reqs[i: i + 4]))
        outs += [t for t, _, _ in got]
    return outs


def _finish_requests(probe):
    """Greedy requests that end every way the device can end them. Token 0
    of a stream comes from the prefill; with K = 4 the bursts hold tokens
    1-4, 5-8, 9-12, ..."""
    p = _probe_prompts()
    return [
        # eos in the middle of a burst (token 6)
        dict(prompt=p[0], eos=[probe[0][6]], stop=dict(max_tokens=16)),
        # max_tokens off and on a burst boundary (9 = 1 + 2 bursts)
        dict(prompt=p[1], stop=dict(max_tokens=8, ignore_eos=True)),
        dict(prompt=p[2], stop=dict(max_tokens=12, ignore_eos=True)),
        dict(prompt=p[3], stop=dict(max_tokens=9, ignore_eos=True)),
        # a hidden stop id; min_tokens holds an earlier eos back
        dict(prompt=p[4], eos=[probe[4][2]],
             stop=dict(max_tokens=16, min_tokens=4,
                       stop_token_ids_hidden=[probe[4][7]])),
        # a stop string by its canonical token sequence (tokens 4..6)
        dict(prompt=p[5], stop=dict(max_tokens=16, ignore_eos=True, stop=["x"],
                                    stop_token_seqs=[probe[5][4:7]])),
        # guided choices sharing one list, and a late arrival that forces
        # a barrier
        dict(prompt=p[6], eos=[2], samp=dict(
            temperature=0.0, guided_choice_token_ids=CHOICES),
             stop=dict(max_tokens=16)),
        dict(prompt=p[0][:7], eos=[2], after=True, samp=dict(
            temperature=0.0, guided_choice_token_ids=CHOICES),
             stop=dict(max_tokens=16)),
        dict(prompt=p[2][:10], after=True,
             stop=dict(max_tokens=11, ignore_eos=True)),
    ]


def _first_index(stream, pred, start=0):
    return next(i for i in range(start, len(stream)) if pred(i))


def test_chained_engine_streams_match_jax_engine(weights, probe):
    reqs = _finish_requests(probe)
    cfg_kw = dict(BASE, max_batch_size=8, **LOOP)
    want = asyncio.run(_serve_jax(weights, cfg_kw, reqs))
    got, metrics, used = asyncio.run(_serve_torch(weights, cfg_kw, reqs))
    assert [(t, f) for t, _, f in got] == [(t, f) for t, f in want]
    toks = [t for t, _, _ in got]
    # the streams end where the probe says they must
    assert toks[0] == probe[0][: _first_index(
        probe[0], lambda i: probe[0][i] == probe[0][6]) + 1]
    assert got[0][2] == "eos"
    assert [len(t) for t in toks[1:4]] == [8, 12, 9]
    assert all(f == "length" for _, _, f in got[1:4])
    stop_at = _first_index(probe[4], lambda i: probe[4][i] in (
        probe[4][7], probe[4][2]) , 3)
    assert toks[4] == probe[4][: stop_at + 1] and got[4][2] in ("stop", "eos")
    seq = probe[5][4:7]
    seq_at = _first_index(probe[5], lambda i: probe[5][i - 2: i + 1] == seq, 2)
    assert toks[5] == probe[5][: seq_at + 1] and got[5][2] == "stop"
    for t, _, f in got[6:8]:
        assert f == "stop" and (t in CHOICES or t[:-1] in CHOICES)
    assert len(toks[8]) == 11
    # the chain engaged, rows froze on the device, nothing leaked, and every
    # pass that did not chain has a named reason
    assert metrics["chain_len_max"] > 1 and metrics["decode_pipeline_bursts"] > 2
    assert metrics["device_finished_rows"] > 0
    assert used == 0
    assert metrics["sync_fallback"].get("not_idle", 0) > 0
    assert set(metrics["sync_fallback"]) <= {
        "not_idle", "guided_table_pending", "membership", "no_rows"}


def _mixed_requests(probe):
    """Seeded sampling, penalties, bias, logprobs and guided rows beside
    the device-finished ones."""
    p = _probe_prompts()
    return [
        dict(prompt=p[0], eos=[probe[0][6]], stop=dict(max_tokens=16),
             out=dict(logprobs=0)),
        dict(prompt=p[1], stop=dict(max_tokens=13, ignore_eos=True),
             samp=dict(temperature=0.9, top_p=0.95, top_k=20, seed=1234)),
        dict(prompt=p[2], stop=dict(max_tokens=12, ignore_eos=True),
             samp=dict(temperature=0.8, seed=5, repetition_penalty=1.3,
                       frequency_penalty=0.4, presence_penalty=0.3, min_p=0.05),
             out=dict(logprobs=2)),
        dict(prompt=p[3], stop=dict(max_tokens=10, ignore_eos=True),
             samp=dict(temperature=0.0, logit_bias={5: 4.0, 17: -100.0})),
        dict(prompt=p[5], stop=dict(max_tokens=16, ignore_eos=True, stop=["x"],
                                    stop_token_seqs=[probe[5][4:7]]),
             out=dict(logprobs=1)),
        # guided rows with logprobs: the mask must be applied exactly once
        # on either path; one greedy with a logit_bias on an allowed id,
        # one sampled
        dict(prompt=p[6], eos=[2], stop=dict(max_tokens=16),
             samp=dict(temperature=0.0, guided_choice_token_ids=CHOICES,
                       logit_bias={50: 1.5}), out=dict(logprobs=2)),
        dict(prompt=p[4], eos=[2], stop=dict(max_tokens=16),
             samp=dict(temperature=1.0, seed=77,
                       guided_choice_token_ids=CHOICES), out=dict(logprobs=0)),
        dict(prompt=p[2][:10], after=True,
             stop=dict(max_tokens=11, ignore_eos=True),
             samp=dict(temperature=0.7, seed=11), out=dict(logprobs=0)),
    ]


MODES = {
    "sync_k1": {},
    "sync_k4": dict(multi_step_decode=4),
    "pipelined": dict(LOOP, device_finish="off"),
    "chained": dict(LOOP),
    "chained_fused": dict(LOOP, fused_epilogue="on"),
    # the loop without bursts: one step per dispatch
    "chained_k1": dict(decode_pipeline_depth=2),
    "chained_no_table": dict(LOOP, guided_device_table=False,
                             device_stop_strings=False),
}


@pytest.fixture(scope="module")
def mixed_sync(weights, probe):
    return asyncio.run(_serve_torch(weights, dict(BASE, max_batch_size=8),
                                    _mixed_requests(probe)))


@pytest.mark.parametrize("mode", [m for m in MODES if m != "sync_k1"])
def test_decode_modes_stream_identically_within_port(weights, probe,
                                                     mixed_sync, mode):
    want, _, _ = mixed_sync
    got, metrics, used = asyncio.run(_serve_torch(
        weights, dict(BASE, max_batch_size=8, **MODES[mode]),
        _mixed_requests(probe)))
    assert [(t, f) for t, _, f in got] == [(t, f) for t, _, f in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert sum(bool(lp) for _, lp, _ in got) == 6
    assert used == 0
    fb = metrics["sync_fallback"]
    if mode in ("chained", "chained_fused", "chained_k1"):
        assert metrics["chain_len_max"] > 1
        assert metrics["device_finished_rows"] > 0
        assert "guided_disabled" not in fb and "stop_strings_disabled" not in fb
    elif mode == "chained_no_table":
        # guided and stop-string rows keep the chain closed, by name
        assert fb.get("guided_disabled", 0) + fb.get("stop_strings_disabled", 0) > 0
    elif mode == "pipelined":
        assert metrics["decode_pipeline_bursts"] > 0
        # no chain to fall back from: nothing is counted
        assert metrics["chain_len_max"] == 0 and fb == {}
    else:
        # no dispatch-ahead pipeline: its counter is not served at all
        assert "decode_pipeline_bursts" not in metrics and fb == {}


def test_hash_collision_resumes_with_the_same_stream(weights, probe, monkeypatch):
    """A stop sequence that never occurs, whose device hash is forced onto
    a suffix that does: the device freezes the row, the host's exact check
    refuses, the chain closes and the row resumes."""
    p = _probe_prompts()
    never = [probe[5][5], probe[5][4]]           # reversed: never a suffix
    assert all(probe[5][i: i + 2] != never for i in range(15))
    reqs = [dict(prompt=p[5], stop=dict(max_tokens=14, ignore_eos=True,
                                        stop=["x"], stop_token_seqs=[never])),
            dict(prompt=p[1], stop=dict(max_tokens=14, ignore_eos=True))]
    want, _, _ = asyncio.run(_serve_torch(weights, BASE, reqs))
    assert [len(t) for t, _, _ in want] == [14, 14]

    def colliding_rows(seqs):
        hashes, lens = stop_seq_rows(seqs)
        hashes[0] = stop_seq_hash(probe[5][5:7])  # tokens 5..6: second burst
        return hashes, lens

    monkeypatch.setattr(torch_scheduler, "stop_seq_rows", colliding_rows)
    got, metrics, used = asyncio.run(_serve_torch(weights, dict(BASE, **LOOP), reqs))
    assert [(t, f) for t, _, f in got] == [(t, f) for t, _, f in want]
    assert metrics["sync_fallback"]["stop_false_positive"] >= 1
    assert used == 0


def test_kv_budget_closes_the_chain_before_preemption(weights):
    """12 blocks of 8 cannot hold four 20-token prompts growing by 16: the
    chain's reservation fails, the chain closes at a barrier, and only then
    the synchronous path preempts; every stream continues."""
    rng = np.random.default_rng(2)
    reqs = [dict(prompt=[int(t) for t in rng.integers(3, 512, 20)],
                 stop=dict(max_tokens=16, ignore_eos=True)) for _ in range(4)]
    tight = dict(BASE, num_kv_blocks=12, enable_prefix_caching=False)
    want, _, _ = asyncio.run(_serve_torch(weights, tight, reqs))
    seen = []

    def hook(engine):
        sched = engine.scheduler
        inner = sched._preempt

        def checked(er):
            seen.append((len(sched._chain), len(sched._chain_members),
                         sched._inflight is not None))
            inner(er)

        sched._preempt = checked

    got, metrics, used = asyncio.run(
        _serve_torch(weights, dict(tight, **LOOP), reqs, hook))
    assert [(t, f) for t, _, f in got] == [(t, f) for t, _, f in want]
    assert all(len(t) == 16 for t, _, _ in got)
    assert metrics["sync_fallback"].get("kv_oom", 0) > 0
    assert metrics["preemptions"] > 0 and seen
    assert all(s == (0, 0, False) for s in seen)
    assert used == 0


def test_chained_rows_attend_within_their_block_table(weights, monkeypatch):
    """A long row that finishes first stays a frozen member of the chain
    while two short rows keep decoding, and the chain's block table narrows
    to the live rows' width: every forward's context lengths must stay
    within the table it is given (a CUDA kernel reads ``ceil(ctx / bs)``
    table entries, so a frozen row past the width read out of bounds: an
    illegal address on the card), and the streams equal the synchronous
    engine's."""
    from dynamo_tpu_torch.models import llama as torch_llama

    rng = np.random.default_rng(11)
    reqs = [dict(prompt=[int(t) for t in rng.integers(3, 512, 100)],
                 stop=dict(max_tokens=2, ignore_eos=True))] + [
        dict(prompt=[int(t) for t in rng.integers(3, 512, 5)],
             stop=dict(max_tokens=40, ignore_eos=True)) for _ in range(2)]
    want, _, _ = asyncio.run(_serve_torch(weights, BASE, reqs))
    forward = torch_llama.forward
    beyond = []

    def checked(params, cfg, tokens, positions, kv_cache, block_tables,
                slot_mapping, context_lens, **kw):
        width = block_tables.shape[1] * BASE["kv_block_size"]
        beyond.append(int((context_lens > width).sum()))
        return forward(params, cfg, tokens, positions, kv_cache, block_tables,
                       slot_mapping, context_lens, **kw)

    monkeypatch.setattr(torch_llama, "forward", checked)
    got, metrics, used = asyncio.run(_serve_torch(weights, dict(BASE, **LOOP),
                                                  reqs))
    assert [(t, f) for t, _, f in got] == [(t, f) for t, _, f in want]
    assert metrics["chain_len_max"] > 1 and beyond
    assert sum(beyond) == 0, beyond
    assert used == 0


def test_to_device_passes_tensors_through_and_converts():
    """The transfer helper: host arrays (uint32 too) become tensors of the
    asked type, and a tensor already on the device passes through."""
    from dynamo_tpu_torch.ops.transfer import to_device

    t = to_device(np.array([1, 2**32 - 1], np.uint32), "cpu")
    assert t.dtype == torch.int64 and t.tolist() == [1, 2**32 - 1]
    assert to_device([1, 2], "cpu", torch.int32).dtype == torch.int32
    x = torch.arange(3)
    assert to_device(x, "cpu") is x
    assert to_device(x, torch.device("cpu"), torch.int64) is x
    assert to_device(x, "cpu", torch.float32).dtype == torch.float32
    # several arrays in one buffer: values, types and shapes survive, bools
    # and odd byte counts included; a tensor passes through
    from dynamo_tpu_torch.ops.transfer import to_device_packed

    rng = np.random.default_rng(0)
    arrays = dict(
        a=(rng.integers(-5, 5, (3, 5)).astype(np.int32), torch.int64),
        b=(np.array([True, False, True]), torch.bool),
        c=(rng.standard_normal(7).astype(np.float32), torch.float32),
        d=(np.array([2**32 - 1, 7], np.uint32), torch.int64),
        e=(np.zeros((0,), np.int32), torch.int32),
        f=(x, torch.int64))
    got = to_device_packed("cpu", **arrays)
    assert got["f"] is x
    for name in "abcde":
        want = np.asarray(arrays[name][0])
        assert got[name].dtype == arrays[name][1]
        assert tuple(got[name].shape) == want.shape
        np.testing.assert_array_equal(got[name].numpy(), want.astype(
            got[name].numpy().dtype))
