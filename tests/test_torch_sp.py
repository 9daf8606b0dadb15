"""Sequence-parallel prefill of the port against the JAX package, with the
``sp`` ranks laid out on one device.

The reference runs on its 8-device virtual CPU mesh (``tests/conftest.py``);
the port stacks the ranks as the leading dimension. Inputs and weights are
made from a seed with numpy and shared. f32 throughout; tolerances are
stated per test (summation order only: both sides compute in f32).

- the prefix kernel's plain version against the Pallas kernel in interpret
  mode, across page boundaries and the empty prefix;
- the one-card ring partials against the reference's under ``shard_map``;
- ``sp_chunk_attention`` against both reference routes (the Pallas kernel
  route in interpret mode and the XLA gather route);
- ``sp_decoder_forward`` hidden states and cache layers;
- the engine: greedy streams equal ``JaxServingEngine``'s, seeded streams
  equal the port's dense engine, the early handoff, cancellation, the
  backlog cap, the chained engine, and the config's refusals.
"""

import asyncio
import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.ops.compat import shard_map
from dynamo_tpu.ops.pallas_sp import (
    paged_prefix_attention_partials as jax_prefix_partials,
)
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.parallel.sequence import sp_chunk_attention as jax_sp_chunk
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner, build_prefill_arrays
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops.sp_prefix import (
    MASK_VALUE,
    paged_prefix_attention_partials,
    paged_prefix_attention_partials_ref,
)
from dynamo_tpu_torch.parallel import ring_attention
from dynamo_tpu_torch.parallel.sequence import sp_chunk_attention
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

# the module (the package re-exports a function of the same name)
jax_ring = importlib.import_module("dynamo_tpu.parallel.ring_attention")

# f32 on both sides: only the summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ----------------------------------------------------------- prefix kernel

_PFX = dict(b=2, s=8, h=4, kvh=2, d=16, L=3, N=12, bs=4, W=5)


def _prefix_case(seed=0, d=_PFX["d"]):
    c = _PFX
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((c["b"], c["s"], c["h"], d)).astype(np.float32)
    shape = (c["L"], c["N"], c["bs"], c["kvh"], d)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    bt = rng.permutation(c["N"])[: c["b"] * c["W"]].reshape(
        c["b"], c["W"]).astype(np.int32)
    return q, kc, vc, bt


@pytest.mark.parametrize("head_dim", [_PFX["d"], 128])  # 128: the kernel's second width
@pytest.mark.parametrize("prefix_len", [0, 1, 3, 4, 5, 20],
                         ids=["empty", "one", "bs-1", "bs", "bs+1", "W*bs"])
def test_prefix_partials_match_pallas_interpret(prefix_len, head_dim):
    """The plain version (what CPU tensors take) against the reference's
    Pallas kernel in interpret mode, layer 2 of a 3-layer stacked cache,
    a partial last page and the whole table; f32 to 1e-5."""
    q, kc, vc, bt = _prefix_case(d=head_dim)
    ja, jm, jl = jax_prefix_partials(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        prefix_len, 2, interpret=True)
    acc, m, l = paged_prefix_attention_partials(
        _t(q), _t(kc), _t(vc), _t(bt), prefix_len, 2)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)
    if prefix_len == 0:
        # the empty prefix reads nothing: exact empties, m finite
        assert (m == MASK_VALUE).all() and (l == 0).all() and (acc == 0).all()


@pytest.mark.parametrize("h", [14, 10])  # G 7 and G 5 over 2 KV heads
def test_prefix_partials_match_pallas_interpret_at_odd_groups(h):
    """Qwen2.5's GQA groups, which leave spare rows in the kernel's
    128-row CTA: the plain version against the reference's kernel (any G)
    in interpret mode, head_dim 128, a partial last page."""
    c = _PFX
    rng = np.random.default_rng(4)
    q = rng.standard_normal((c["b"], c["s"], h, 128)).astype(np.float32)
    shape = (c["L"], c["N"], c["bs"], c["kvh"], 128)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    bt = rng.permutation(c["N"])[: c["b"] * c["W"]].reshape(
        c["b"], c["W"]).astype(np.int32)
    ja, jm, jl = jax_prefix_partials(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        17, 2, interpret=True)
    acc, m, l = paged_prefix_attention_partials(
        _t(q), _t(kc), _t(vc), _t(bt), 17, 2)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)


def test_prefix_partials_take_a_broadcast_block_table():
    """The ranks share one block table as a stride-0 row: the result is
    the per-rank call's, row for row."""
    q, kc, vc, bt = _prefix_case(1)
    row = _t(bt[:1])
    got = paged_prefix_attention_partials_ref(
        _t(q), _t(kc), _t(vc), row.expand(2, row.shape[1]), 13, 1)
    for r in range(2):
        want = paged_prefix_attention_partials_ref(
            _t(q[r: r + 1]), _t(kc), _t(vc), row, 13, 1)
        for a, b in zip(got, want):
            torch.testing.assert_close(a[r: r + 1], b, rtol=0, atol=0)


# ------------------------------------------------------------- ring pass

def _ring_case(b, s, h, kvh, d, pad, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    pos = np.tile(np.arange(10, 10 + s, dtype=np.int32), (b, 1))
    if pad:
        pos[:, -pad:] = -1
    return q, k, v, pos


@pytest.mark.parametrize("b,pad", [(1, 0), (1, 5), (2, 3)])
def test_ring_partials_match_shard_map(b, pad):
    """``_ring_partials`` with the ranks as dim 0 against the reference's
    per-device body under ``shard_map`` on a 4-device mesh: o, m and l of
    every rank, pad rows included (m stays _NEG, l 0); f32 to 1e-5."""
    sp, s, h, kvh, d = 4, 16, 4, 2, 16
    q, k, v, pos = _ring_case(b, s, h, kvh, d, pad)
    scale = d ** -0.5
    mesh = make_mesh({"sp": sp})
    seq, rows = P(None, "sp", None, None), P(None, "sp")
    jo, jm, jl = shard_map(
        functools.partial(jax_ring._ring_partials, axis="sp", scale=scale),
        mesh=mesh, in_specs=(seq, seq, seq, rows, rows),
        out_specs=(P(None, None, None, "sp", None), P(None, None, None, "sp"),
                   P(None, None, None, "sp")),
        check_vma=False,
    )(*(jnp.asarray(x) for x in (q, k, v, pos, pos)))
    shard = ring_attention.shard_ranks
    o, m, l = ring_attention._ring_partials(
        shard(_t(q), sp), shard(_t(k), sp), shard(_t(v), sp),
        shard(_t(pos), sp), shard(_t(pos), sp), scale=scale)
    g = h // kvh
    o = o.permute(1, 2, 3, 0, 4, 5).reshape(b, kvh, g, s, d)
    m = m.permute(1, 2, 3, 0, 4).reshape(b, kvh, g, s)
    l = l.permute(1, 2, 3, 0, 4).reshape(b, kvh, g, s)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)


def test_ring_attention_matches_reference_and_dense_oracle():
    sp = 4
    q, k, v, pos = _ring_case(2, 16, 4, 2, 16, 2, seed=5)
    mesh = make_mesh({"sp": sp})
    want = jax_ring.ring_attention(*(jnp.asarray(x) for x in (q, k, v, pos, pos)),
                                   mesh)
    got = ring_attention.ring_attention(*(_t(x) for x in (q, k, v, pos, pos)), sp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = ring_attention.dense_reference(*(_t(x) for x in (q, k, v, pos, pos)))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


# ------------------------------------------------------------ chunk attention

_SP = dict(s=16, h=4, kvh=2, d=16, L=2, N=8, bs=8, W=8)


def _sp_case(seed=0):
    c = _SP
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, c["s"], c["h"], c["d"])).astype(np.float32)
    k = rng.standard_normal((1, c["s"], c["kvh"], c["d"])).astype(np.float32)
    v = rng.standard_normal((1, c["s"], c["kvh"], c["d"])).astype(np.float32)
    shape = (c["L"], c["N"], c["bs"], c["kvh"], c["d"])
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    bt = rng.permutation(c["N"])[: c["W"]].astype(np.int32)[None, :]
    return q, k, v, kc, vc, bt


@pytest.mark.parametrize("chunk_start,context_len", [
    (24, 37),   # a multi-page prefix ending mid-page (3 pad rows)
    (0, 13),    # the first chunk: empty prefix, ring pass only
    (19, 35),   # a prefix boundary mid-page, no pad row
    (40, 42),   # a short last chunk: 14 pad rows
    (48, 64),   # the whole table
])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_sp_chunk_attention_matches_both_reference_routes(chunk_start,
                                                          context_len, impl):
    """The port's chunk (ring partials + prefix partials, one merge) against
    the reference's kernel route in interpret mode and its XLA gather route
    (one joint softmax), 4 ranks, layer 1; f32 to 2e-5 (the reference's own
    bound between its two routes, tests/test_pallas_campaign.py). Pad rows
    are exactly 0 on both sides."""
    q, k, v, kc, vc, bt = _sp_case()
    want = np.asarray(jax_sp_chunk(
        *(jnp.asarray(x) for x in (q, k, v, kc, vc, bt)), chunk_start,
        context_len, 1, make_mesh({"sp": 4}), impl=impl,
        interpret=impl == "pallas"))
    got = sp_chunk_attention(*(_t(x) for x in (q, k, v, kc, vc, bt)),
                             chunk_start, context_len, 1, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    valid = context_len - chunk_start
    assert (got[:, valid:] == 0).all()


# ------------------------------------------------------------- the trunk

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=512, rms_norm_eps=1e-5)


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(3),
                                   jnp.float32)
    return params, jax.device_get(params)


def test_sp_decoder_forward_matches_jax(weights):
    """Two SP chunks of a 27-token prompt (16 tokens, then 11 and 5 pad
    rows) through both trunks, 4 ranks: hidden states of the valid rows and
    every cache layer after each chunk; f32 to 1e-4 (the forward
    differential's bound, tests/test_torch_model.py)."""
    jcfg = JaxModelConfig(**TINY)
    cfg = ModelConfig(**TINY)
    params = from_jax_params(weights[1], cfg, "cpu", "float32")
    bs, n_blocks, S, sp = 8, 12, 16, 4
    # the arrays as the runner builds them: a 6-block table (48 positions)
    ecfg = EngineConfig(model=cfg, max_model_len=48, kv_block_size=bs,
                        num_kv_blocks=n_blocks, dtype="float32")
    jcache = jax_llama.init_kv_cache(jcfg, n_blocks, bs, jnp.float32)
    cache = llama.init_kv_cache(cfg, n_blocks, bs, torch.float32)
    mesh = make_mesh({"sp": sp})
    prompt = [int(t) for t in np.random.default_rng(9).integers(3, 512, 27)]
    blocks = [7, 2, 10, 4]
    hd = cfg.head_dim
    for start, end in ((0, 16), (16, 27)):
        tok, pos, bt, slots, _, _ = build_prefill_arrays(
            ecfg, prompt[:end], start, blocks, bucket=S)
        jh, jcache = jax_llama.sp_decoder_forward(
            weights[0], jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
            jnp.asarray(bt), jnp.asarray(slots), jnp.asarray([end], jnp.int32),
            start, mesh)
        th, cache = llama.sp_decoder_forward(
            params, cfg, _t(tok), _t(pos), cache, _t(bt), _t(slots), end, start,
            sp)
        take = end - start
        np.testing.assert_allclose(th[0, :take].numpy(),
                                   np.asarray(jh)[0, :take], rtol=1e-4, atol=1e-4)
        for i in range(2):
            np.testing.assert_allclose(cache[i].numpy(),
                                       np.asarray(jcache[i])[..., :hd],
                                       rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- the engine

# the reference's SP engine test config (tests/test_sp_prefill.py): the SP
# bucket is 128 (sp 8 x budget 16), so a 200-token prompt takes 2 chunks
SP_ENGINE = dict(max_batch_size=4, kv_block_size=8, dtype="float32",
                 max_model_len=384, num_kv_blocks=160)


def _sp_kw(sp, **kw):
    if sp > 1:
        kw = dict(dict(long_prefill_threshold_tokens=48,
                       max_prefill_tokens_per_step=16), **kw)
    kw.setdefault("max_prefill_tokens_per_step", 32)
    return dict(SP_ENGINE, sp_size=sp, **kw)


def _prompt(n, seed=3):
    return [1] + [int(t) for t in np.random.default_rng(seed).integers(3, 500, n - 1)]


GREEDY = dict(temperature=0.0)
SEEDED = dict(temperature=0.8, seed=11)


async def _torch_engine(weights, sp, **kw):
    cfg = EngineConfig(model=ModelConfig(**TINY), **_sp_kw(sp, **kw))
    return await TorchServingEngine.create(
        cfg, params=from_jax_params(weights[1], cfg.model, "cpu", "float32"),
        device="cpu", warmup=False)


async def _collect(engine, prompt, samp, max_tokens=16):
    req = PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=SamplingOptions(**samp))
    toks, finish = [], None
    async for out in engine.generate(Context(req)):
        toks.extend(out["token_ids"])
        finish = out.get("finish_reason") or finish
    return toks, finish


def test_sp_engine_matches_jax_engine_and_dense_ladder(weights):
    """Greedy streams of the port's SP engine (sp 8) equal the reference's
    SP engine on a 200-token prompt; seeded streams equal the port's own
    dense engine (the two packages draw different noise); the long prompt
    takes at least 2 chunks and no engine leaks a block. A short prompt
    stays on the dense ladder."""

    async def jax_run():
        cfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **_sp_kw(8))
        engine = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None), engine_config=cfg,
            params=weights[0], warmup=False)
        try:
            out = []
            for p in (_prompt(200), _prompt(20)):
                req = JaxRequest(token_ids=p,
                                 stop_conditions=JaxStop(max_tokens=16,
                                                         ignore_eos=True),
                                 sampling_options=JaxSampling(temperature=0.0))
                toks = []
                async for o in engine.generate(JaxContext(req)):
                    toks.extend(o["token_ids"])
                out.append(toks)
            chunks = sum(engine.scheduler._sp_chunks_c.values.values())
            return out, chunks, engine.scheduler.allocator.used
        finally:
            await engine.close()

    async def torch_run(sp):
        engine = await _torch_engine(weights, sp)
        try:
            # the seeded prompt is another one: the same prompt would hit
            # the prefix cache and leave a suffix below the threshold
            out = [await _collect(engine, _prompt(200), GREEDY),
                   await _collect(engine, _prompt(200, seed=4), SEEDED),
                   await _collect(engine, _prompt(20), GREEDY)]
            return out, engine.metrics(), engine.scheduler.allocator.used
        finally:
            await engine.close()

    j_out, j_chunks, j_used = asyncio.run(jax_run())
    sp_out, sp_m, sp_used = asyncio.run(torch_run(8))
    dense_out, dense_m, dense_used = asyncio.run(torch_run(1))
    assert [sp_out[0][0], sp_out[2][0]] == j_out
    assert sp_out == dense_out
    assert all(len(t) == 16 and f == "length" for t, f in sp_out)
    assert sp_m["sp_chunks"] == 4 and sp_m["sp_tokens"] == 400
    assert sp_m["sp_handoffs"] == 2 and dense_m["sp_chunks"] == 0
    assert j_chunks >= 2
    assert sp_used == dense_used == j_used == 0


def test_fp8_sp_engine_matches_jax_engine(weights):
    """SP prefill over an fp8 (e4m3) cache: greedy streams of the port's SP
    engine (sp 4) equal ``JaxServingEngine(sp_size=4,
    kv_cache_dtype="fp8")``'s on a 200-token prompt (2 chunks read the
    e4m3 prefix through kernel 6's fp8 plain version) and a short dense
    one; both write the same e4m3 bytes and compute in f32."""
    prompts = (_prompt(200), _prompt(20))

    async def jax_run():
        cfg = JaxEngineConfig(model=JaxModelConfig(**TINY),
                              **_sp_kw(4, kv_cache_dtype="fp8"))
        engine = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None), engine_config=cfg,
            params=weights[0], warmup=False)
        try:
            out = []
            for p in prompts:
                req = JaxRequest(token_ids=p,
                                 stop_conditions=JaxStop(max_tokens=16,
                                                         ignore_eos=True),
                                 sampling_options=JaxSampling(temperature=0.0))
                toks = []
                async for o in engine.generate(JaxContext(req)):
                    toks.extend(o["token_ids"])
                out.append(toks)
            return out
        finally:
            await engine.close()

    async def torch_run():
        engine = await _torch_engine(weights, 4, kv_cache_dtype="fp8")
        try:
            assert engine.runner.kv_dtype == torch.float8_e4m3fn
            out = [await _collect(engine, p, GREEDY) for p in prompts]
            return out, engine.metrics(), engine.scheduler.allocator.used
        finally:
            await engine.close()

    want = asyncio.run(jax_run())
    got, m, used = asyncio.run(torch_run())
    assert [t for t, _ in got] == want
    assert all(len(t) == 16 and f == "length" for t, f in got)
    assert m["sp_chunks"] >= 2 and used == 0


def test_sp_early_handoff_dispatches_before_the_drain(weights):
    """The first decode burst takes the final chunk's token as a device
    tensor, and is dispatched before the host reads the final chunk's
    outputs (one drain reads both)."""

    async def go():
        engine = await _torch_engine(weights, 8)
        runner = engine.runner
        events = []
        sp_chunk, burst, stage = (runner.sp_prefill_chunk, runner.decode_burst,
                                  runner.stage_to_host)

        def spy_chunk(*a, **kw):
            events.append(("chunk", kw["commit"]))
            return sp_chunk(*a, **kw)

        def spy_burst(tokens0, *a, **kw):
            events.append(("burst", type(tokens0)))
            return burst(tokens0, *a, **kw)

        def spy_stage(*tensors):
            out = stage(*tensors)
            read = out.numpy

            def numpy():
                events.append(("drain", None))
                return read()

            out.numpy = numpy
            return out

        runner.sp_prefill_chunk = spy_chunk
        runner.decode_burst = spy_burst
        runner.stage_to_host = spy_stage
        try:
            toks, _ = await _collect(engine, _prompt(200), GREEDY)
        finally:
            await engine.close()
        return toks, events

    toks, events = asyncio.run(go())
    assert len(toks) == 16
    final = events.index(("chunk", True))
    assert events[:final].count(("chunk", False)) >= 1
    kinds = [e[0] for e in events[final + 1:]]
    assert kinds[:2] == ["burst", "drain"]
    assert events[final + 1][1] is torch.Tensor


def test_sp_cancel_mid_ladder_leaks_nothing(weights):
    """A client that goes away mid-ladder: the request leaves the ladder,
    every block frees, and the engine serves afterwards."""

    async def go():
        engine = await _torch_engine(weights, 8)
        sched = engine.scheduler
        sp_chunk = engine.runner.sp_prefill_chunk
        req = PreprocessedRequest(
            token_ids=_prompt(300),
            stop_conditions=StopConditions(max_tokens=16, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0))
        ctx = Context(req)

        def cancel_after_first(*a, **kw):
            ctx.context.stop_generating()   # the client drops mid-ladder
            return sp_chunk(*a, **kw)

        engine.runner.sp_prefill_chunk = cancel_after_first
        got = [o async for o in engine.generate(ctx)]
        engine.runner.sp_prefill_chunk = sp_chunk
        for _ in range(100):
            await asyncio.sleep(0.01)
            if sched.allocator.used == 0 and sched.sp_active is None:
                break
        used, active, chunks = sched.allocator.used, sched.sp_active, sched.sp_chunks
        try:
            toks, _ = await _collect(engine, _prompt(60, seed=9), GREEDY)
        finally:
            await engine.close()
        return got, used, active, chunks, toks

    got, used, active, chunks, toks = asyncio.run(go())
    assert [o["finish_reason"] for o in got] == ["cancelled"]
    assert chunks == 1          # 300 tokens would take 3 chunks
    assert used == 0 and active is None
    assert len(toks) == 16


def test_sp_backlog_honours_the_prefill_batch_cap(weights):
    """SP admissions hold their whole prompt's blocks, so the SP backlog
    (queue + active) never exceeds ``max_prefill_batch``; everyone still
    completes."""

    async def go():
        engine = await _torch_engine(weights, 8, max_prefill_batch=2)
        sched = engine.scheduler
        tasks = [asyncio.ensure_future(_collect(engine, _prompt(180, seed=20 + i),
                                                GREEDY, max_tokens=4))
                 for i in range(4)]
        most = 0
        while not all(t.done() for t in tasks):
            most = max(most, len(sched.sp_queue) + (sched.sp_active is not None))
            await asyncio.sleep(0.002)
        res = [await t for t in tasks]
        used = sched.allocator.used
        chunks = sched.sp_chunks
        await engine.close()
        return most, res, used, chunks

    most, res, used, chunks = asyncio.run(go())
    assert 1 <= most <= 2
    assert all(len(t) == 4 for t, _ in res)
    assert chunks == 8 and used == 0


def test_chained_sp_engine_streams_as_the_synchronous_one(weights):
    """Long SP prompts beside short dense ones that decode while the ladder
    works: the chained loop (which falls back to the synchronous path while
    the ladder is busy, "not_idle") streams exactly as the synchronous
    4-step-burst engine, and both as the dense engine."""
    batch = [(_prompt(200), GREEDY), (_prompt(20, seed=4), GREEDY),
             (_prompt(150, seed=5), SEEDED), (_prompt(30, seed=6), SEEDED)]

    async def run(sp, **kw):
        engine = await _torch_engine(weights, sp, multi_step_decode=4, **kw)
        try:
            res = await asyncio.gather(*(_collect(engine, p, s, 24)
                                         for p, s in batch))
            return res, engine.metrics(), engine.scheduler.allocator.used
        finally:
            await engine.close()

    sync, m_sync, u_sync = asyncio.run(run(8))
    chained, m_ch, u_ch = asyncio.run(run(8, decode_pipeline_depth=2))
    dense, _, _ = asyncio.run(run(1))
    assert chained == sync == dense
    assert m_sync["sp_chunks"] >= 3 and m_ch["sp_chunks"] == m_sync["sp_chunks"]
    assert m_ch["sync_fallback"].get("not_idle", 0) > 0
    assert m_ch["decode_pipeline_bursts"] > 0
    assert u_sync == u_ch == 0


def test_one_chunk_sp_prompt_meets_an_open_chain(weights):
    """A one-chunk SP prompt admitted while the chained loop has bursts in
    flight: the handoff burst is dispatched with the chain still open (its
    other rows are inert: no commit, KV writes to the spare row), and every
    stream equals the synchronous engine's."""
    long_decode = (_prompt(20, seed=7), GREEDY, 40)
    one_chunk = (_prompt(100, seed=8), GREEDY, 12)

    async def run(**kw):
        engine = await _torch_engine(weights, 8, multi_step_decode=4, **kw)
        sched = engine.scheduler
        seen = []
        finish = sched._sp_finish

        async def spy(loop, er, outs):
            seen.append(bool(sched._chain) or bool(sched._chain_members))
            return await finish(loop, er, outs)

        sched._sp_finish = spy
        try:
            first = asyncio.ensure_future(_collect(engine, *long_decode))
            while sched.decode_steps < 3:
                await asyncio.sleep(0.001)
            second = await _collect(engine, *one_chunk)
            return [await first, second], seen, engine.metrics(), sched.allocator.used
        finally:
            await engine.close()

    sync, _, _, _ = asyncio.run(run())
    chained, seen, m, used = asyncio.run(run(decode_pipeline_depth=2))
    assert chained == sync
    assert seen == [True] and m["sp_chunks"] == 1 and m["sp_handoffs"] == 1
    assert used == 0


def test_runner_gate_and_chunk_shape():
    """The SP chunk is one fixed shape: the largest prefill bucket whose
    per-rank share fits the step budget, as the reference computes it."""
    cfg = EngineConfig(model=ModelConfig(**TINY), **_sp_kw(8))
    jcfg = JaxEngineConfig(model=JaxModelConfig(**TINY), **_sp_kw(8))
    assert cfg.sp_prefill_bucket() == jcfg.sp_prefill_bucket() == 128
    assert cfg.long_prefill_threshold_tokens == 48
    runner = ModelRunner(cfg, device="cpu")
    assert runner.sp_ready and runner.sp_chunk_tokens == 128
    assert not ModelRunner(EngineConfig(model=ModelConfig(**TINY), **_sp_kw(1)),
                           device="cpu").sp_ready
    # the default threshold is one dense step's budget
    cfg2 = EngineConfig(model=ModelConfig(**TINY), **dict(
        _sp_kw(4), long_prefill_threshold_tokens=0))
    assert cfg2.long_prefill_threshold_tokens == 16


DEEPSEEK = dict(TINY, kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, num_kv_heads=4)


@pytest.mark.parametrize("model_kw,engine_kw,err,words", [
    ({}, dict(tp_size=2), NotImplementedError, "tp_size"),
    ({}, dict(pp_size=2), ValueError, "pipeline"),
    # the chained propose-verify round is served beside SP, as in the
    # reference: accepted, and the runner serves both
    ({}, dict(decode_pipeline_depth=2, spec_ngram_tokens=4), None, None),
    (DEEPSEEK, {}, ValueError, "MLA"),
    (dict(num_experts=4), {}, ValueError, "mixture-of-experts"),
    (dict(sliding_window=64), {}, ValueError, "sliding_window"),
    (dict(attn_logit_softcap=30.0), {}, ValueError, "attn_logit_softcap"),
], ids=["tp", "pp", "propose_verify_round", "deepseek_mla", "moe", "window",
        "softcap"])
def test_config_refuses_what_sp_does_not_serve(model_kw, engine_kw, err, words):
    mcfg = ModelConfig(**dict(TINY, **model_kw))
    kw = dict(engine_kw)
    sp = kw.pop("sp_size", 8)
    if err is None:
        runner = ModelRunner(EngineConfig(model=mcfg, **_sp_kw(sp, **kw)),
                             device="cpu")
        assert runner.sp_ready and runner.spec_burst_ready
        return
    with pytest.raises(err, match=words):
        EngineConfig(model=mcfg, **_sp_kw(sp, **kw))
    if model_kw:
        # the same trunk without SP is accepted: the refusal is SP's own
        EngineConfig(model=mcfg, **_sp_kw(1))


def test_threshold_at_sp_size_1_is_accepted():
    """The long-prefill admission class without SP (a disagg decode
    worker's: past the threshold, prompts prefer the prefill pool) is
    served; such a runner serves no SP chunk."""
    cfg = EngineConfig(model=ModelConfig(**TINY),
                       **_sp_kw(1, long_prefill_threshold_tokens=64))
    assert cfg.long_prefill_threshold_tokens == 64 and cfg.sp_size == 1
    assert not ModelRunner(cfg, device="cpu").sp_ready
