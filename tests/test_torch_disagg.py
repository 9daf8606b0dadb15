"""Disaggregated prefill and decode in the port, against the reference.

- Block ops: gather / scatter round trips on a port runner (f32, bf16,
  e4m3 and DeepSeek's ``(c_kv, k_rope)`` pair: bytes equal), and the
  blocks a port runner gathers after a prefill against the reference's
  ``gather_blocks`` over the same weights and prompt (f32, 1e-5).
- Transfer and routing (mirroring ``tests/test_disagg.py``): the server's
  round trip over TCP, its drop of unauthorized frames and of frames of
  another cache layout, the router's decision and live config, the
  queue's ack and redelivery, over the port's ``MemoryHub``; the ici
  backend and prefix pulls refused by name.
- Wire: ``RemotePrefillRequest.to_wire()`` and a block frame are byte
  for byte the reference's.
- Streams: a port decode engine with a port prefill worker streams the
  greedy tokens of ``JaxServingEngine`` running local and of the
  reference's disagg pair (exact), including a prefix-hit prompt's
  suffix-only transfer; streamed chunks; a mid-stream sender failure and
  the timeout fall back to a local prefill; the worker's SP and dense
  ladders; a seeded sampled request is the same remote and local.
- The CLI's roles as CPU subprocesses: ``remote_prefill_completed`` rises
  in the decode worker's stats scrape, the prefill worker's stats show
  the shipped bytes.
- ``metrics()`` keys and values against ``JaxServingEngine`` for plain,
  ngram spec, the chained loop and disagg.

Tiny widths (2 layers, hidden 64, 4 heads over 2 KV heads, head_dim 16,
block size 8, vocab 512), f32 unless named. Every test runs under its own
timeout; servers bind port 0.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg import DisaggRouter as RefRouter
from dynamo_tpu.disagg import PrefillWorker as RefPrefillWorker
from dynamo_tpu.disagg import RemotePrefillCoordinator as RefCoordinator
from dynamo_tpu.disagg.protocols import RemotePrefillRequest as RefRequest
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.engine.scheduler import build_prefill_arrays as jax_prefill_arrays
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.protocols.common import StopConditions as JaxStop
from dynamo_tpu.runtime.component import DistributedRuntime as RefDrt
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.transports.memory import MemoryHub as RefHub
from dynamo_tpu.transfer.tcp import TcpBackend as RefTcp
from dynamo_tpu_torch.disagg import (
    DisaggRouter,
    KvTransferClient,
    KvTransferServer,
    PrefillWorker,
    RemotePrefillCoordinator,
)
from dynamo_tpu_torch.disagg.protocols import PrefillQueue, RemotePrefillRequest
from dynamo_tpu_torch.disagg.transfer import cache_layout
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner, build_prefill_arrays
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.memory import MemoryHub
from dynamo_tpu_torch.transfer.tcp import TcpBackend
from fixtures import make_model_dir

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=512, rms_norm_eps=1e-5)
BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32")
# the prefill worker's small chunks: several frames per prompt
CHUNKED = dict(max_prefill_tokens_per_step=8, prefill_buckets=[8, 16, 32, 64, 128])
DEEPSEEK = dict(TINY, kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, num_kv_heads=4)
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.init_params(JaxModelConfig(**TINY), jax.random.PRNGKey(3),
                                   jnp.float32)
    host = jax.device_get(params)
    return params, from_jax_params(host, ModelConfig(**TINY), "cpu", "float32")


def _cfg(model=TINY, **kw):
    return EngineConfig(model=ModelConfig(**model), **dict(BASE, **kw))


def _jax_cfg(**kw):
    return JaxEngineConfig(model=JaxModelConfig(**TINY), **dict(BASE, **kw))


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 512, n)]


def _request(prompt, max_tokens=8, **sampling):
    sampling.setdefault("temperature", 0.0)
    return PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=SamplingOptions(**sampling))


async def _tokens(engine, prompt, max_tokens=8, **sampling):
    toks = []
    async for out in engine.generate(Context(_request(prompt, max_tokens,
                                                      **sampling))):
        toks.extend(out["token_ids"])
    return toks


async def _jax_tokens(engine, prompt, max_tokens=8):
    req = JaxRequest(token_ids=list(prompt),
                     stop_conditions=JaxStop(max_tokens=max_tokens, ignore_eos=True),
                     sampling_options=JaxSampling(temperature=0.0))
    toks = []
    async for out in engine.generate(JaxContext(req)):
        toks.extend(out["token_ids"])
    return toks


def _run(coro, timeout=TIMEOUT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class _Pair:
    """A port decode engine with a remote-prefill coordinator and, unless
    ``worker`` is False, a port prefill worker on the same hub."""

    def __init__(self, params, engine_kw=None, worker_kw=None, worker=True,
                 timeout=60.0, max_local=0, model=TINY):
        self.params, self.engine_kw, self.worker_kw = params, engine_kw or {}, worker_kw
        self.with_worker, self.timeout, self.max_local = worker, timeout, max_local
        self.model = model

    async def __aenter__(self):
        self.hub = MemoryHub()
        self.drt = DistributedRuntime.in_process(self.hub)

        async def factory(runner):
            self.coord = await RemotePrefillCoordinator(
                self.drt, runner, router=DisaggRouter(
                    max_local_prefill_length=self.max_local,
                    max_prefill_queue_size=100),
                depth_refresh_s=0.05, prefill_timeout_s=self.timeout).start()
            return self.coord

        self.engine = await TorchServingEngine.create(
            _cfg(self.model, **self.engine_kw), params=self.params,
            device="cpu", warmup=False, disagg_factory=factory)
        self.worker = self.task = None
        self.drt_p = DistributedRuntime.in_process(self.hub)
        if self.with_worker:
            pcfg = _cfg(self.model, **(self.worker_kw or {}))
            self.worker = PrefillWorker(
                self.drt_p, ModelRunner(pcfg, params=self.params, device="cpu"),
                pcfg)
            self.task = asyncio.ensure_future(self.worker.run())
        return self

    async def __aexit__(self, *exc):
        if self.worker is not None:
            self.worker.stop()
            await self.task
            await self.worker.close()
        await self.engine.close()
        await self.drt_p.close()
        await self.drt.close()


# ---------------------------------------------------------------- block ops


def _random_blocks(cache, n, seed):
    """Random bytes of ``n`` blocks of ``cache``'s shape and dtype."""
    shape = (cache.shape[0], n, *cache.shape[2:])
    raw = np.random.default_rng(seed).integers(
        0, 256, int(np.prod(shape)) * cache.element_size(), dtype=np.uint8)
    t = torch.from_numpy(raw)
    if cache.dtype == torch.float32:
        # finite values: a random f32 bit pattern may be a NaN
        return torch.from_numpy(np.random.default_rng(seed).normal(
            size=shape).astype(np.float32))
    return t.view(cache.dtype).reshape(shape)


def _bytes_of(t):
    return t.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("model,kw", [
    (TINY, dict(dtype="float32")),
    (TINY, dict(dtype="bfloat16")),
    (TINY, dict(dtype="bfloat16", kv_cache_dtype="fp8")),
    (DEEPSEEK, dict(dtype="float32")),
], ids=["f32", "bf16", "e4m3", "deepseek_pair"])
def test_block_ops_round_trip(model, kw):
    """Scatter random blocks, gather them back: the same bytes (exact);
    untouched blocks stay zero; ids outside the cache and blocks of
    another dtype or shape are refused by name."""
    runner = ModelRunner(_cfg(model, **kw), device="cpu")
    ids = [3, 7, 11, 12, 40]
    k0, v0 = runner.kv_cache
    k, v = _random_blocks(k0, len(ids), 0), _random_blocks(v0, len(ids), 1)
    runner.scatter_blocks(ids, k, v)
    k2, v2 = runner.gather_blocks(ids)
    assert k2.dtype == k0.dtype and v2.dtype == v0.dtype
    assert tuple(k2.shape) == tuple(k.shape) and tuple(v2.shape) == tuple(v.shape)
    assert torch.equal(_bytes_of(k2), _bytes_of(k))
    assert torch.equal(_bytes_of(v2), _bytes_of(v))
    kz, vz = runner.gather_blocks([0, 63])
    assert not _bytes_of(kz).any() and not _bytes_of(vz).any()
    # the device form of the gather, then the host copy, is the same
    kd, vd = runner.gather_blocks_device(ids[1:3])
    kh, vh = runner.blocks_to_host(kd, vd)
    assert torch.equal(_bytes_of(kh), _bytes_of(k[:, 1:3]))
    assert torch.equal(_bytes_of(vh), _bytes_of(v[:, 1:3]))
    with pytest.raises(ValueError, match="block ids outside"):
        runner.gather_blocks([64])
    with pytest.raises(ValueError, match="do not fit"):
        runner.scatter_blocks(ids[:1], k[:, :1].to(torch.float16),
                              v[:, :1].to(torch.float16))
    with pytest.raises(ValueError, match="do not fit"):
        runner.scatter_blocks(ids[:2], k[:, :1], v[:, :1])


def test_gathered_blocks_match_the_reference(weights):
    """The same prompt prefilled on a port runner and a reference runner
    over the same weights: the blocks each gathers agree (f32, atol 1e-5)."""
    prompt = _prompt(29, 5)
    block_ids = [9, 2, 30, 17]
    port = ModelRunner(_cfg(), params=weights[1], device="cpu")
    ref = JaxRunner(_jax_cfg(), params=weights[0])
    z = np.zeros(1, np.float32)
    port.step(*build_prefill_arrays(port.config, prompt, 0, block_ids),
              z, np.zeros(1, np.int32), np.ones(1, np.float32), want_top=False)
    ref.step(*jax_prefill_arrays(ref.config, prompt, 0, block_ids),
             z, np.zeros(1, np.int32), np.ones(1, np.float32))
    pk, pv = port.gather_blocks(block_ids)
    rk, rv = ref.gather_blocks(block_ids)
    np.testing.assert_allclose(pk.numpy(), np.asarray(rk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), atol=1e-5, rtol=0)
    assert np.abs(np.asarray(rk)).max() > 0.1  # the prefill wrote them


# ------------------------------------------------------- transfer plane


@pytest.mark.parametrize("model", [TINY, DEEPSEEK], ids=["llama", "deepseek"])
def test_transfer_server_round_trip(model):
    """Blocks pushed over real TCP land in the destination runner's cache
    byte for byte; the commit reaches on_commit and is acked."""
    runner_a = ModelRunner(_cfg(model), device="cpu")
    runner_b = ModelRunner(_cfg(model), device="cpu")
    k0, v0 = runner_a.kv_cache
    src, dst = [2, 5, 9], [10, 20, 30]
    runner_a.scatter_blocks(src, _random_blocks(k0, 3, 2), _random_blocks(v0, 3, 3))

    async def main():
        commits = []
        server = await KvTransferServer(
            scatter=lambda rid, ids, k, v: runner_b.scatter_blocks(ids, k, v),
            on_commit=lambda rid, tok, lp, top=None, spans=None:
                commits.append((rid, tok, lp)),
            layout=cache_layout(runner_b)).start()
        try:
            client = await KvTransferClient("127.0.0.1", server.port).connect()
            kk, vv = runner_a.gather_blocks(src)
            sent = await client.send_blocks("r1", dst, kk, vv, chunk_blocks=2)
            ok = await client.send_commit("r1", 42, 0.5)
            await client.close()
        finally:
            await server.close()
        return commits, ok, sent, server.frames_received, server.bytes_received

    commits, ok, sent, frames, received = _run(main())
    assert commits == [("r1", 42, 0.5)] and ok
    assert frames == 2 and received == sent
    ka, va = runner_a.gather_blocks(src)
    kb, vb = runner_b.gather_blocks(dst)
    assert torch.equal(ka, kb) and torch.equal(va, vb)


def test_transfer_drops_unauthorized_frames():
    runner = ModelRunner(_cfg(), device="cpu")
    k0, _ = runner.kv_cache

    async def main():
        server = await KvTransferServer(
            scatter=lambda rid, ids, k, v: runner.scatter_blocks(ids, k, v),
            on_commit=lambda *a: None,
            authorize=lambda rid, ids: False).start()  # e.g. cancelled
        try:
            ones = torch.ones((k0.shape[0], 1, *k0.shape[2:]))
            client = await KvTransferClient("127.0.0.1", server.port).connect()
            await client.send_blocks("ghost", [4], ones, ones)
            ok = await client.send_commit("ghost", 1, None)
            await client.close()
        finally:
            await server.close()
        return ok

    assert _run(main()) is False  # the commit is nacked
    kz, _ = runner.gather_blocks([4])
    assert not kz.any()  # the frame was dropped, the cache untouched


def test_transfer_refuses_another_cache_layout(weights):
    """A bf16 sender to an e4m3 receiver: the frame is refused by name (the
    cache untouched, the commit nacked), never reinterpreted; and a
    prefill worker refuses a decode engine whose descriptor differs."""
    bf16 = ModelRunner(_cfg(dtype="bfloat16"), device="cpu")
    fp8 = ModelRunner(_cfg(dtype="bfloat16", kv_cache_dtype="fp8"), device="cpu")

    async def main():
        server = await KvTransferServer(
            scatter=lambda rid, ids, k, v: fp8.scatter_blocks(ids, k, v),
            on_commit=lambda *a: None, layout=cache_layout(fp8)).start()
        try:
            k, v = bf16.gather_blocks([1])
            client = await KvTransferClient("127.0.0.1", server.port).connect()
            await client.send_blocks("r", [4], k + 1, v + 1)
            ok = await client.send_commit("r", 1, None)
            await client.close()
        finally:
            await server.close()
        hub = MemoryHub()
        drt_d, drt_p = DistributedRuntime.in_process(hub), DistributedRuntime.in_process(hub)
        coord = await RemotePrefillCoordinator(drt_d, fp8).start()
        worker = PrefillWorker(drt_p, bf16, bf16.config)
        try:
            with pytest.raises(ValueError, match="cache layout differs.*dtype"):
                await worker._client(coord.engine_id)
        finally:
            await coord.close()
            await drt_p.close()
            await drt_d.close()
        return ok

    assert _run(main()) is False
    kz, vz = fp8.gather_blocks([4])
    assert not _bytes_of(kz).any() and not _bytes_of(vz).any()


def test_unported_transfer_paths_are_refused_by_name():
    """The ici collective backend is not ported: the negotiation, the
    client and the server each refuse it by name (the server ends the
    connection on its frame, poisoning what it streamed). A prefix pull is
    served since the cluster KV fabric was ported: a server with no pull
    source answers it with ``pull_end``, 0 served, and keeps the
    connection."""
    from dynamo_tpu_torch.transfer.framing import pack_frame, read_header
    from dynamo_tpu_torch.transfer.plane import negotiate_backend

    assert negotiate_backend({"modes": ["tcp", "ici"]}) == "tcp"
    with pytest.raises(NotImplementedError, match="ici transfer backend"):
        negotiate_backend({"modes": ["tcp", "ici"]}, ici=object())
    with pytest.raises(ValueError, match="offers no tcp"):
        negotiate_backend({"modes": ["ici"]})

    async def main():
        server = await KvTransferServer(scatter=lambda *a: None,
                                        on_commit=lambda *a: None).start()
        try:
            client = await KvTransferClient("127.0.0.1", server.port).connect()
            with pytest.raises(NotImplementedError, match="send_ici_blocks"):
                await client.send_ici_blocks("r", [1], seq=1)
            c = await KvTransferClient("127.0.0.1", server.port).connect()
            pack_frame(c.writer, {"type": "ici_blocks", "request_id": "r",
                                  "block_ids": [1], "seq": 1})
            await c.writer.drain()
            ended = await c.reader.read() == b""  # closed by the server
            await c.close()
            c = await KvTransferClient("127.0.0.1", server.port).connect()
            pack_frame(c.writer, {"type": "pull", "hashes": [1]})
            await c.writer.drain()
            pulled = await read_header(c.reader)
            pack_frame(c.writer, {"type": "pull", "hashes": []})
            await c.writer.drain()
            again = await read_header(c.reader)  # the connection stays up
            await c.close()
            await client.close()
            return ended, "r" in server._poison, pulled, again
        finally:
            await server.close()

    end = {"type": "pull_end", "served": 0}
    assert _run(main()) == (True, True, end, end)


# ---------------------------------------------------------------- router


def test_disagg_router_decision():
    r = DisaggRouter(max_local_prefill_length=100, max_prefill_queue_size=2)
    assert not r.prefill_remote(100, 0, 0)        # at the threshold: local
    assert r.prefill_remote(101, 0, 0)            # above: remote
    assert not r.prefill_remote(300, 250, 0)      # a prefix hit absorbs it
    assert not r.prefill_remote(500, 0, 2)        # queue full: local
    assert r.prefill_remote(500, 0, 1)


def test_disagg_router_dynamic_config():
    async def main():
        drt = DistributedRuntime.in_process(MemoryHub())
        r = DisaggRouter(max_local_prefill_length=100, model_name="m")
        await r.start(drt.discovery, drt.runtime)
        before = r.prefill_remote(200, 0, 0)
        await DisaggRouter.publish_config(drt.discovery, "public", "m",
                                          max_local_prefill_length=1000,
                                          max_prefill_queue_size=5)
        for _ in range(100):
            if r.max_prefill_queue_size == 5:
                break
            await asyncio.sleep(0.01)
        after = r.prefill_remote(200, 0, 0)
        await r.stop()
        await drt.close()
        return before, after, r.max_prefill_queue_size

    assert _run(main()) == (True, False, 5)  # the threshold was raised live


def test_prefill_queue_ack_and_redelivery():
    async def main():
        drt = DistributedRuntime.in_process(MemoryHub())
        q = PrefillQueue(drt.messaging, "ns", visibility=0.2)
        await q.push(RemotePrefillRequest("r1", "e1", [1, 2, 3], [0], 0))
        got, _ack = await q.pop(timeout=1)
        first = (got.request_id, got.token_ids)
        await asyncio.sleep(0.3)  # no ack: redelivered after the window
        got2, ack2 = await q.pop(timeout=1)
        ack2()
        await asyncio.sleep(0.3)
        depth = await q.depth()
        # a malformed item is acked away, never crash-looped
        await drt.messaging.queue_push(q.name, b"\xc1 not msgpack")
        bad = await q.pop(timeout=1)
        await asyncio.sleep(0.3)
        depth_bad = await q.depth()
        await drt.close()
        return first, got2.request_id, depth, bad, depth_bad

    assert _run(main()) == (("r1", [1, 2, 3]), "r1", 0, None, 0)


# ------------------------------------------------------------------ wire


def test_remote_prefill_request_wire_matches_the_reference():
    fields = dict(request_id="r-9", engine_id="eng-1",
                  token_ids=[1, 500, 70000], block_ids=[3, 4], num_cached=16,
                  temperature=0.7, top_k=40, top_p=0.9, min_p=0.05,
                  presence_penalty=0.1, frequency_penalty=0.2,
                  repetition_penalty=1.1, seed=123, want_logprobs=True,
                  logprobs_n=2, logit_bias={7: -2.5, 11: 1.0},
                  trace_id="t-1", enqueued_at=1700000000.25)
    port, ref = RemotePrefillRequest(**fields), RefRequest(**fields)
    assert port.to_wire() == ref.to_wire()
    assert RemotePrefillRequest.from_wire(ref.to_wire()) == port
    bare = dict(request_id="r", engine_id="e", token_ids=[1], block_ids=[0])
    assert RemotePrefillRequest(**bare).to_wire() == RefRequest(**bare).to_wire()


class _Sink:
    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += bytes(b)

    async def drain(self):
        pass


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_frame_matches_the_reference(dtype):
    """The same blocks framed by the port and by the reference: the same
    bytes (the reference's bf16 through ml_dtypes, the port's through the
    raw bytes)."""
    import ml_dtypes

    rng = np.random.default_rng(4)
    k = rng.normal(size=(2, 3, 8, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 3, 8, 2, 16)).astype(np.float32)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if dtype == "bfloat16":
        kt, vt = kt.to(torch.bfloat16), vt.to(torch.bfloat16)
        k = kt.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        v = vt.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    header = {"type": "blocks", "request_id": "r", "block_ids": [1, 2, 3]}

    async def main():
        a, b = _Sink(), _Sink()
        na = await TcpBackend.send_blocks(a, header, kt, vt)
        nb = await RefTcp.send_blocks(b, header, k, v)
        return bytes(a.data), bytes(b.data), na, nb

    pa, pb, na, nb = _run(main())
    assert pa == pb and na == nb


# ---------------------------------------------------------------- streams


async def _jax_local(weights, prompts, max_tokens=8, **kw):
    engine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=_jax_cfg(**kw),
        params=weights[0], warmup=False)
    try:
        return [await _jax_tokens(engine, p, max_tokens) for p in prompts]
    finally:
        await engine.close()


async def _jax_disagg(weights, prompts, max_tokens=8):
    hub = RefHub()
    drt, drt_p = RefDrt.in_process(hub), RefDrt.in_process(hub)

    async def factory(runner):
        return await RefCoordinator(
            drt, runner, router=RefRouter(max_local_prefill_length=0,
                                          max_prefill_queue_size=100),
            depth_refresh_s=0.05).start()

    engine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=_jax_cfg(),
        params=weights[0], warmup=False, disagg_factory=factory)
    pcfg = _jax_cfg(**CHUNKED)
    worker = RefPrefillWorker(drt_p, JaxRunner(pcfg, params=weights[0]), pcfg)
    task = asyncio.ensure_future(worker.run())
    try:
        return [await _jax_tokens(engine, p, max_tokens) for p in prompts]
    finally:
        worker.stop()
        await task
        await worker.close()
        await engine.close()
        await drt_p.close()
        await drt.close()


def test_remote_prefill_matches_local_and_the_reference(weights):
    """Greedy streams after a remote prefill equal ``JaxServingEngine``'s
    local streams and the reference's disagg pair's (exact); the second,
    identical prompt hits the decode side's prefix cache and only its
    suffix is computed and shipped."""
    prompt = _prompt(30, 11)

    async def main():
        async with _Pair(weights[1], worker_kw=CHUNKED) as pair:
            got = [await _tokens(pair.engine, prompt) for _ in range(2)]
            return got, pair.coord.metrics(), pair.worker.metrics()

    got, coord, worker = _run(main())
    want = _run(_jax_local(weights, [prompt]))[0]
    ref = _run(_jax_disagg(weights, [prompt, prompt]))
    assert got == [want, want] == ref
    assert coord["remote_prefill_completed"] == 2
    assert coord["remote_prefill_failures"] == {}
    assert worker["prefills_total"] == 2
    # the second prefill computed only the suffix past the decode side's
    # 3 cached blocks, and shipped only the blocks past them
    first, second = worker["transfers"]
    assert second["computed_tokens"] < len(prompt)
    assert (first["shipped_blocks"], second["shipped_blocks"]) == (4, 1)
    assert worker["transfer_bytes_total"] == coord["kv_transfer_bytes_received"]
    assert worker["kv_active_blocks"] == 0


def test_remote_prefill_streamed_chunks_match_local(weights):
    """A 28-token prompt at 8 tokens a chunk: one frame per chunk, streamed
    while later chunks compute, never more than two host frames live;
    the stream equals the local one."""
    prompt = [1 + (i * 37) % 200 for i in range(28)]

    async def main():
        async with _Pair(weights[1], worker_kw=CHUNKED) as pair:
            got = await _tokens(pair.engine, prompt)
            return got, pair.worker.metrics()

    got, worker = _run(main())
    assert got == _run(_jax_local(weights, [prompt]))[0]
    assert worker["transfer_frames_total"] >= 4
    assert worker["max_live_host_frames"] <= 2
    assert worker["prefix_total_tokens"] == len(prompt)
    assert worker["prefix_hit_tokens"] == 0


def test_mid_stream_sender_failure_nacks_and_falls_back(weights):
    """The sender dies between two frames: the request's commit is
    poisoned, a later full stream's commit is nacked, and the decode side
    falls back to a local prefill at its timeout; the stream equals the
    local one, and the revoked request's late frames are dropped."""
    prompt = _prompt(16, 12)

    async def main():
        async with _Pair(weights[1], worker=False, timeout=2.0) as pair:
            gen = asyncio.ensure_future(_tokens(pair.engine, prompt))
            q = PrefillQueue(pair.drt_p.messaging, "public")
            rpr, ack = await q.pop(timeout=10)
            ack()  # this test plays the only prefill worker
            k0, _ = pair.engine.runner.kv_cache
            ones = torch.ones((k0.shape[0], 1, *k0.shape[2:]))
            port = pair.coord._server.port
            c1 = await KvTransferClient("127.0.0.1", port).connect()
            await c1.send_blocks(rpr.request_id, rpr.block_ids[:1], ones, ones)
            await c1.close()          # dies between frames, no commit
            await asyncio.sleep(0.1)  # the server sees the EOF
            c2 = await KvTransferClient("127.0.0.1", port).connect()
            for i in range(len(rpr.block_ids)):
                await c2.send_blocks(rpr.request_id, rpr.block_ids[i: i + 1],
                                     ones, ones)
            nacked = not await c2.send_commit(rpr.request_id, 42, None)
            got = await gen
            # revoked at the fallback: a late frame is dropped and a late
            # commit nacked again
            await c2.send_blocks(rpr.request_id, rpr.block_ids[:1], ones, ones)
            nacked_late = not await c2.send_commit(rpr.request_id, 42, None)
            await c2.close()
            return got, nacked, nacked_late, pair.coord.metrics()

    got, nacked, nacked_late, coord = _run(main())
    assert nacked and nacked_late
    assert got == _run(_jax_local(weights, [prompt]))[0]
    assert coord["remote_prefill_completed"] == 0
    assert coord["remote_prefill_failures"] == {"timeout": 1}
    assert coord["kv_transfer_nacks"] == 2


def test_remote_prefill_timeout_falls_back_local(weights):
    """No prefill worker: the decode worker prefills locally at its
    timeout, and counts the prompt's prefix once."""
    prompt = _prompt(20, 13)

    async def main():
        async with _Pair(weights[1], worker=False, timeout=0.4) as pair:
            got = await _tokens(pair.engine, prompt)
            return got, pair.engine.metrics()

    got, m = _run(main())
    assert got == _run(_jax_local(weights, [prompt]))[0]
    assert (m["remote_prefill_submitted"], m["remote_prefill_completed"]) == (1, 0)
    assert m["remote_prefill_failures"] == {"timeout": 1}
    assert m["prefix_total_tokens"] == len(prompt)
    assert m["kv_active_blocks"] == 0


SP_WORKER = dict(sp_size=4, long_prefill_threshold_tokens=48,
                 max_prefill_tokens_per_step=16, max_model_len=384,
                 num_kv_blocks=160)


@pytest.mark.parametrize("n,ladder", [(100, "sp"), (20, "dense")])
def test_prefill_worker_ladders(weights, n, ladder):
    """A prefill worker with the SP chunk: a prompt past the threshold takes
    the SP ladder (64-token chunks), a shorter one the dense ladder; each
    stream equals a local engine's with the same SP config (which takes the
    same ladder on its own)."""
    prompt = _prompt(n, 14)
    engine_kw = dict(max_model_len=384, num_kv_blocks=160)

    async def main():
        async with _Pair(weights[1], engine_kw=engine_kw,
                         worker_kw=SP_WORKER) as pair:
            got = await _tokens(pair.engine, prompt)
            w = pair.worker.metrics()
        local = await TorchServingEngine.create(
            _cfg(**SP_WORKER), params=weights[1], device="cpu", warmup=False)
        try:
            want = await _tokens(local, prompt)
            sp_chunks = local.metrics()["sp_chunks"]
        finally:
            await local.close()
        return got, want, w, sp_chunks

    got, want, w, sp_chunks = _run(main())
    assert got == want
    assert w["prefills_total"] == 1
    assert w["sp_prefills_total"] == (1 if ladder == "sp" else 0)
    assert (sp_chunks > 0) == (ladder == "sp")
    # two 64-token SP chunks; one dense chunk (the smallest bucket, 32)
    assert w["transfers"][0]["chunks"] == (2 if ladder == "sp" else 1)


def test_a_request_arriving_mid_submit_meets_the_router(weights):
    """A prompt that arrives while another's submit awaits its queue push
    is routed on the next pass, not prefilled locally by default: both
    long prompts go remote."""
    prompts = [_prompt(30, 17), _prompt(26, 18)]

    async def main():
        async with _Pair(weights[1], worker_kw=CHUNKED) as pair:
            push = pair.coord.queue.push

            async def slow_push(req):
                await asyncio.sleep(0.3)
                await push(req)

            pair.coord.queue.push = slow_push
            first = asyncio.ensure_future(_tokens(pair.engine, prompts[0]))
            await asyncio.sleep(0.1)  # the first submit is mid-push
            second = await _tokens(pair.engine, prompts[1])
            return [await first, second], pair.coord.metrics()

    got, coord = _run(main())
    assert coord["remote_prefill_completed"] == 2
    assert got == _run(_jax_local(weights, prompts))


def test_seeded_sampled_request_same_remote_and_local(weights):
    """A seeded sampled request: the prefill worker draws the first token
    with the decode side's local key and counter, so the stream is the
    same remote and local (exact); another seed gives another stream."""
    prompt = _prompt(24, 15)
    sampling = dict(temperature=0.9, seed=77)

    async def main():
        async with _Pair(weights[1], worker_kw=CHUNKED) as pair:
            remote = await _tokens(pair.engine, prompt, 12, **sampling)
            done = pair.coord.remote_completed
        local = await TorchServingEngine.create(
            _cfg(), params=weights[1], device="cpu", warmup=False)
        try:
            same = await _tokens(local, prompt, 12, **sampling)
            other = await _tokens(local, prompt, 12, temperature=0.9, seed=78)
        finally:
            await local.close()
        return remote, same, other, done

    remote, same, other, done = _run(main())
    assert done == 1
    assert remote == same
    assert other != same


# --------------------------------------------------------- metrics names

METRIC_CONFIGS = {
    "plain": {},
    "ngram_spec": dict(spec_ngram_tokens=4, spec_ngram_match=2),
    "chained": dict(decode_pipeline_depth=2, multi_step_decode=4),
    # the KV tiers and the fabric: a cache small enough that the second
    # prompt evicts the first into the host tier, whose overflow spills to
    # the cold tier (each engine gets a directory of its own)
    "tiers": dict(num_kv_blocks=4, host_kv_blocks=1, cold_tier_dir="<tmp>",
                  cold_tier_blocks=16, prefix_pull=True),
}


async def _metrics_pair(weights, kw, prompts, disagg, tmp=None):
    """The same requests through JaxServingEngine and TorchServingEngine
    (each with its own disagg pair when ``disagg``); their metrics."""
    out = []
    asked = kw
    for port in (False, True):
        if asked.get("cold_tier_dir") == "<tmp>":
            kw = dict(asked, cold_tier_dir=str(tmp / ("port" if port else "ref")))
        hub = (MemoryHub if port else RefHub)()
        Drt = DistributedRuntime if port else RefDrt
        drt, drt_p = Drt.in_process(hub), Drt.in_process(hub)
        worker = task = None
        factory = None
        if disagg:
            Coord, Router = ((RemotePrefillCoordinator, DisaggRouter) if port
                             else (RefCoordinator, RefRouter))

            async def factory(runner, Coord=Coord, Router=Router, drt=drt):
                return await Coord(drt, runner, router=Router(
                    max_local_prefill_length=0, max_prefill_queue_size=100),
                    depth_refresh_s=0.05).start()
        if port:
            engine = await TorchServingEngine.create(
                _cfg(**kw), params=weights[1], device="cpu", warmup=False,
                disagg_factory=factory)
            gen = _tokens
        else:
            engine = await JaxServingEngine.create(
                types.SimpleNamespace(model_path=None),
                engine_config=_jax_cfg(**kw), params=weights[0],
                warmup=False, disagg_factory=factory)
            gen = _jax_tokens
        if disagg:
            if port:
                pcfg = _cfg()
                worker = PrefillWorker(
                    drt_p, ModelRunner(pcfg, params=weights[1], device="cpu"), pcfg)
            else:
                pcfg = _jax_cfg()
                worker = RefPrefillWorker(
                    drt_p, JaxRunner(pcfg, params=weights[0]), pcfg)
            task = asyncio.ensure_future(worker.run())
        try:
            streams = [await gen(engine, p, 12) for p in prompts]
            await asyncio.sleep(0.2)  # the queue depth's refresh
            out.append((streams, engine.metrics()))
        finally:
            if worker is not None:
                worker.stop()
                await task
                await worker.close()
            await engine.close()
            await drt_p.close()
            await drt.close()
    return out


TIMED = {"decode_pipeline_bursts", "decode_burst_chain_length"}


@pytest.mark.parametrize("name", list(METRIC_CONFIGS) + ["disagg"])
def test_metrics_keys_match_the_reference(weights, name, tmp_path):
    """``metrics()`` carries the reference's keys under the reference's
    conditions, with its values (exact), beside the port's own counters;
    the four names the port used to rename are gone."""
    kw = METRIC_CONFIGS.get(name, {})
    prompts = [[5, 9, 8, 9, 8, 9, 8, 9, 8, 21, 40, 2], _prompt(20, 16)]
    (want_s, ref), (got_s, port) = _run(_metrics_pair(
        weights, kw, prompts, disagg=name == "disagg", tmp=tmp_path))
    assert got_s == want_s
    missing = set(ref) - set(port)
    assert not missing, missing
    for key in ref:
        if key in TIMED:
            # how many bursts a chain dispatches before the drain sees the
            # finishes depends on host timing, in either engine
            assert port[key] > 0 and ref[key] > 0, (key, port[key], ref[key])
        else:
            assert port[key] == ref[key], (key, port[key], ref[key])
    assert not {"spec_proposed", "spec_accepted", "pipeline_bursts",
                "chain_len_last"} & set(port)
    on = {"ngram_spec": "spec_proposed_tokens", "chained": "decode_pipeline_bursts",
          "disagg": "remote_prefill_completed", "tiers": "host_kv_evicted_total"}
    for cfg_name, key in on.items():
        assert (key in port) == (cfg_name == name)
    if name == "disagg":
        assert port["remote_prefill_completed"] == len(prompts)
    if name == "tiers":
        # the tiers moved blocks: offloads, a host eviction, a cold spill
        assert port["host_kv_evicted_total"] > 0 and port["cold_kv_blocks"] > 0


# ------------------------------------------------------- the CLI's roles


def _spawn(args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-m", *args], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait_line(proc, needle, deadline):
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if needle in line:
            return line
        if not line and proc.poll() is not None:
            raise AssertionError(proc.stderr.read())
    raise AssertionError(f"no {needle!r} line in time")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_disagg_roles_on_the_cpu(tmp_path):
    """dynstore, a ``--token-level --remote-prefill`` decode worker, an
    ``in=prefill`` prefill worker, a KV-routing processor and an ``in=http
    out=none`` frontend, each a subprocess: a chat request's prompt goes
    remote (``remote_prefill_completed`` rises in the decode worker's stats
    scrape; the prefill worker's stats show the bytes it shipped) and every
    role exits 0 on SIGINT."""
    import aiohttp

    from dynamo_tpu_torch.runtime.client import Client

    d = make_model_dir(tmp_path, config_overrides=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=512))
    extra = Path(d) / "f32.json"
    extra.write_text(json.dumps({"dtype": "float32"}))
    store = _free_port()
    common = ["--model-path", d, "--model-name", "tiny", "--store-port",
              str(store), "--namespace", "dis"]
    engine = ["--device", "cpu", "--allow-random-weights", "--extra-engine-args",
              str(extra), "--max-model-len", "128", "--num-kv-blocks", "64",
              "--kv-block-size", "8"]
    procs = []
    deadline = time.monotonic() + 180
    try:
        procs.append(_spawn(["dynamo_tpu_torch.runtime.transports.dynstore",
                             "--host", "127.0.0.1", "--port", str(store)]))
        time.sleep(0.5)
        procs.append(_spawn(["dynamo_tpu_torch.cli.run", "in=prefill",
                             "out=torch", *common, *engine]))
        procs.append(_spawn(["dynamo_tpu_torch.cli.run",
                             "in=dyn://dis.backend.generate", "out=torch",
                             "--token-level", "--remote-prefill",
                             "--max-local-prefill-length", "0",
                             "--disagg-stream-depth", "2", *common, *engine]))
        _wait_line(procs[1], "prefill worker consuming", deadline)
        _wait_line(procs[2], "token-level worker", deadline)
        procs.append(_spawn(["dynamo_tpu_torch.cli.run",
                             "in=dyn://dis.processor.chat", "out=processor",
                             "--worker-endpoint", "dyn://dis.backend.generate",
                             "--router-mode", "kv", "--kv-block-size", "8",
                             *common]))
        _wait_line(procs[-1], "processor serving", deadline)
        procs.append(_spawn(["dynamo_tpu_torch.cli.run", "in=http", "out=none",
                             "--store-port", str(store), "--namespace", "dis",
                             "--http-host", "127.0.0.1", "--http-port", "0"]))
        line = _wait_line(procs[-1], "listening on", deadline)
        port = int(line.strip().rsplit(":", 1)[1])

        async def ask():
            from dynamo_tpu_torch.runtime.component import DistributedRuntime as D

            async with aiohttp.ClientSession() as s:
                for _ in range(200):  # the watcher's first snapshot
                    async with s.get(f"http://127.0.0.1:{port}/v1/models") as r:
                        if (await r.json())["data"]:
                            break
                    await asyncio.sleep(0.05)
                body = dict(model="tiny", stream=True, max_tokens=5,
                            temperature=0.0, ignore_eos=True,
                            messages=[{"role": "user", "content": "x y z"}])
                async with s.post(f"http://127.0.0.1:{port}/v1/chat/completions",
                                  json=body) as r:
                    text = await r.text()
            drt = await D.connect("127.0.0.1", store)
            ns = drt.namespace("dis")
            backend = await Client(ns.component("backend").endpoint("generate")).start()
            prefill = await Client(ns.component("prefill").endpoint("stats")).start()
            await backend.wait_for_instances(1, timeout=30)
            await prefill.wait_for_instances(1, timeout=30)
            b = next(iter((await backend.scrape_stats(timeout=5.0)).values()))["data"]
            p = next(iter((await prefill.scrape_stats(timeout=5.0)).values()))["data"]
            await backend.close()
            await prefill.close()
            await drt.close()
            return text, b, p

        text, b, p = asyncio.run(asyncio.wait_for(ask(), 120))
        assert '"finish_reason":"length"' in text.replace(" ", "")
        assert b["remote_prefill_completed"] == 1 and b["remote_prefill_failures"] == {}
        assert p["prefills_total"] == 1 and p["transfer_bytes_total"] > 0
        assert p["transfer_bytes_total"] == b["kv_transfer_bytes_received"]
        for proc in reversed(procs):
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_cli_disagg_trace_stitches_every_role_on_the_cpu(tmp_path):
    """The disaggregated CLI roles with telemetry on: a chat request sent
    with an ``X-Request-Id`` has a ``/debug/trace/{id}`` whose sources are
    the frontend, the processor, the decode engine and the prefill worker,
    each hop's offset inside its error bound (one host: the true offset is
    0), and the prefill worker's sidecar counts the prefill."""
    import aiohttp

    d = make_model_dir(tmp_path, config_overrides=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=512))
    extra = Path(d) / "f32.json"
    extra.write_text(json.dumps({"dtype": "float32"}))
    store, side = _free_port(), _free_port()
    common = ["--model-path", d, "--model-name", "tiny", "--store-port",
              str(store), "--namespace", "trc"]
    engine = ["--device", "cpu", "--allow-random-weights", "--extra-engine-args",
              str(extra), "--max-model-len", "128", "--num-kv-blocks", "64",
              "--kv-block-size", "8"]
    procs = []
    deadline = time.monotonic() + 180
    try:
        procs.append(_spawn(["dynamo_tpu_torch.runtime.transports.dynstore",
                             "--host", "127.0.0.1", "--port", str(store)]))
        time.sleep(0.5)
        procs.append(_spawn(["dynamo_tpu_torch.cli.run", "in=prefill",
                             "out=torch", "--metrics-port", str(side),
                             *common, *engine]))
        procs.append(_spawn(["dynamo_tpu_torch.cli.run",
                             "in=dyn://trc.backend.generate", "out=torch",
                             "--token-level", "--remote-prefill",
                             "--max-local-prefill-length", "0",
                             *common, *engine]))
        _wait_line(procs[1], "prefill worker consuming", deadline)
        _wait_line(procs[2], "token-level worker", deadline)
        procs.append(_spawn(["dynamo_tpu_torch.cli.run",
                             "in=dyn://trc.processor.chat", "out=processor",
                             "--worker-endpoint", "dyn://trc.backend.generate",
                             "--router-mode", "kv", "--kv-block-size", "8",
                             *common]))
        _wait_line(procs[-1], "processor serving", deadline)
        procs.append(_spawn(["dynamo_tpu_torch.cli.run", "in=http", "out=none",
                             "--store-port", str(store), "--namespace", "trc",
                             "--trace-capacity", "16",
                             "--http-host", "127.0.0.1", "--http-port", "0"]))
        line = _wait_line(procs[-1], "listening on", deadline)
        port = int(line.strip().rsplit(":", 1)[1])

        async def ask():
            async with aiohttp.ClientSession() as s:
                for _ in range(200):
                    async with s.get(f"http://127.0.0.1:{port}/v1/models") as r:
                        if (await r.json())["data"]:
                            break
                    await asyncio.sleep(0.05)
                body = dict(model="tiny", stream=True, max_tokens=5,
                            temperature=0.0, ignore_eos=True,
                            messages=[{"role": "user", "content": "x y z"}])
                async with s.post(f"http://127.0.0.1:{port}/v1/chat/completions",
                                  json=body,
                                  headers={"X-Request-Id": "trace-1"}) as r:
                    await r.text()
                async with s.get(f"http://127.0.0.1:{port}/debug/trace/trace-1") as r:
                    trace = await r.json()
                async with s.get(f"http://127.0.0.1:{port}/debug/requests") as r:
                    recent = await r.json()
                async with s.get(f"http://127.0.0.1:{side}/metrics") as r:
                    text = await r.text()
            return trace, recent, text

        trace, recent, text = asyncio.run(asyncio.wait_for(ask(), 120))
        sources = {h["source"]: h for h in trace["sources"]}
        assert set(sources) == {"frontend", "processor", "decode_engine",
                                "prefill_worker"}, trace
        for name, hop in sources.items():
            # composed offsets: each hop's error bound is its round trip
            assert abs(hop["offset_s"]) <= 0.5 + hop["rtt_s"], (name, hop)
        names = {(r["source"], r["name"]) for r in trace["timeline"]}
        assert ("decode_engine", "kv_transfer") in names
        assert ("prefill_worker", "prefill.compute") in names
        assert [t["request_id"] for t in recent["traces"]] == ["trace-1"]
        assert "dynamo_prefill_worker_prefills_total 1.0" in text
        for proc in reversed(procs):
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
