"""/v1/embeddings in the port against the reference.

- ``ops/attention.prefill_attention`` (the embed trunk's dense causal
  attention) against the reference's in f32 (1e-5) and bf16 (four bf16
  units), and its query-chunked walk against the unchunked one.
- ``models/llama.embed_forward`` against the reference's on a tiny Llama
  (plain, Qwen2 biases, Qwen3 q/k norms): f32 within 1e-5 relative, bf16
  within 2e-2 relative L2.
- ``ModelRunner.embed_prompts`` against the reference runner's at several
  row and bucket counts (one batch, a padded row bucket, more prompts than
  the largest row bucket, prompts across the bucket ladder).
- ``embed_ready`` per family and the refusal message for MLA, MoE and
  windowed trunks, the reference's.
- ``llm/embeddings``: ``normalize_inputs`` and ``Embedder``'s errors equal
  the reference's; ``EchoEmbedder``'s vectors are the reference's.
- The route: ``HttpService`` over an ``Embedder`` on ``TorchServingEngine``
  and the reference's over ``JaxServingEngine`` on the same weights answer
  the same statuses and bodies (vectors within 1e-5), 400, 404 and 501
  included; over the echo stack the bodies are equal outright. The CLI's
  builders attach the embedders.

Tiny widths (2 layers, hidden 64, 4 heads over 2 KV heads, head_dim 16),
CPU: the port takes its plain versions.
"""

import asyncio
import json
import types

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model_runner import ModelRunner as JaxModelRunner
from dynamo_tpu.engine.serving import JaxServingEngine
from dynamo_tpu.http import service as ref_service
from dynamo_tpu.llm import embeddings as ref_emb
from dynamo_tpu.llm.engines.echo import EchoEngineFull as RefEchoFull
from dynamo_tpu.llm.tokenizer import HFTokenizer as RefTokenizer
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.models import resolve as jax_resolve
from dynamo_tpu.ops.attention import prefill_attention as jax_prefill_attention
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.serving import TorchServingEngine
from dynamo_tpu_torch.http import service as port_service
from dynamo_tpu_torch.llm import embeddings as port_emb
from dynamo_tpu_torch.llm.engines.echo import EchoEngineFull
from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models import resolve
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops.attention import prefill_attention
from fixtures import make_model_dir

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=256)
BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
            num_kv_blocks=64, dtype="float32")
# config fields, and whether the layers carry Qwen3's per-head q/k norms
# (a parameter, not a config field, in both packages)
FAMILY_EXTRA = {
    "plain": ({}, False),
    "qwen2_bias": (dict(attention_bias=True), False),
    "qwen3_norms": ({}, True),
}


def _bf16_to_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    valid = rng.integers(1, s + 1, b).astype(np.int32)
    valid[0] = s
    return q, k, v, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 17, 4, 2, 16), (2, 40, 8, 2, 32),
                                   (1, 5, 2, 2, 8)])
def test_prefill_attention_matches_reference(dtype, shape, monkeypatch):
    q, k, v, valid = _qkv(1, *shape)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = _bf16_to_f32(jax_prefill_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(valid)))
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    tvalid = torch.from_numpy(valid)
    got = prefill_attention(tq, tk, tv, tvalid)
    # bf16: logits and probabilities round to bf16 on both sides, each
    # after its own summation order: four bf16 units at unit scale
    tol = 1e-5 if dtype == "float32" else 4 * 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # the query-chunked walk (a budget of 1, 3 and S - 1 query rows a
    # chunk) computes the unchunked numbers
    from dynamo_tpu_torch.ops import attention

    b, s, h = shape[:3]
    for rows in (1, 3, max(1, s - 1)):
        monkeypatch.setattr(attention, "PREFILL_LOGITS_BUDGET", rows * b * h * s)
        chunked = prefill_attention(tq, tk, tv, tvalid)
        np.testing.assert_allclose(chunked.float().numpy(),
                                   got.float().numpy(), rtol=1e-6, atol=1e-6)


def _family_params(extra=({}, False), seed=3):
    fields, norms = extra
    jcfg = JaxModelConfig(**TINY, **fields)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    if norms:
        # drawn away from 1 so the norms matter
        rng = np.random.default_rng(seed)
        shape = (TINY["num_layers"], TINY["hidden_size"] // TINY["num_heads"])
        layers = dict(params["layers"])
        for name in ("q_norm", "k_norm"):
            layers[name] = jnp.asarray(
                1 + 0.2 * rng.standard_normal(shape), jnp.float32)
        params = dict(params, layers=layers)
    return jcfg, params


def _prompt_rows(seed, lens, s):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lens), s), np.int32)
    positions = np.zeros((len(lens), s), np.int32)
    for j, n in enumerate(lens):
        tokens[j, :n] = rng.integers(3, TINY["vocab_size"], n)
        positions[j, :n] = np.arange(n)
        positions[j, n:] = n - 1
    return tokens, positions, np.asarray(lens, np.int32)


@pytest.mark.parametrize("family", sorted(FAMILY_EXTRA))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_forward_matches_reference(family, dtype):
    jcfg, params = _family_params(FAMILY_EXTRA[family])
    cfg = ModelConfig(**TINY, **FAMILY_EXTRA[family][0])
    tokens, positions, valid = _prompt_rows(7, [16, 5, 11, 1], 16)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jd), params)
    want = np.asarray(jax_llama.embed_forward(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(valid)))
    tparams = from_jax_params(jax.device_get(params), cfg, "cpu", dtype)
    got = llama.embed_forward(
        tparams, cfg, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == (4, TINY["hidden_size"])
    got = got.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 2e-2, rel


@pytest.mark.parametrize("lens", [
    [7],                      # one row, the smallest bucket
    [3, 9, 30],               # a padded row bucket (3 → 4)
    [2, 5, 8, 13, 21, 34, 55, 89, 100],  # past the largest row bucket
    [1, 127],                 # across the bucket ladder
])
def test_embed_prompts_matches_reference(lens):
    jcfg, params = _family_params()
    rng = np.random.default_rng(len(lens))
    prompts = [[int(t) for t in rng.integers(3, 500, n)] for n in lens]
    want = JaxModelRunner(JaxEngineConfig(model=jcfg, **BASE),
                          params=params).embed_prompts(prompts)
    cfg = EngineConfig(model=ModelConfig(**TINY), **BASE)
    runner = ModelRunner(cfg, params=from_jax_params(
        jax.device_get(params), cfg.model, "cpu", "float32"), device="cpu")
    assert runner.embed_ready
    got = runner.embed_prompts(prompts)
    assert got.dtype == np.float32 and got.shape == (len(lens), 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # no KV block, no slot: the runner's cache and sample state untouched
    assert not runner.kv_cache[0].any() and not runner.sample_state[2].any()


REFUSED = {
    "windowed": dict(TINY, sliding_window=8),
    "moe": dict(TINY, num_experts=4, num_experts_per_tok=2),
    "mla": dict(TINY, num_kv_heads=4, head_dim=16, kv_lora_rank=16,
                qk_rope_head_dim=8, qk_nope_head_dim=12, v_head_dim=12),
    "gemma2": dict(TINY, model_family="gemma2", head_dim=16,
                   query_pre_attn_scalar=16),
    "llama": dict(TINY),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_embed_refusals_match_reference(name):
    kw = REFUSED[name]
    ready = []
    for cfg_cls, eng_cls, runner_cls, res in (
            (JaxModelConfig, JaxEngineConfig, JaxModelRunner, jax_resolve),
            (ModelConfig, EngineConfig, ModelRunner, resolve)):
        cfg = eng_cls(model=cfg_cls(**kw), **BASE)
        fake = types.SimpleNamespace(config=cfg, arch=res(cfg.model))
        ready.append(runner_cls.embed_ready.fget(fake))
    assert ready[0] == ready[1] == (name == "llama")
    msgs = []
    for runner_cls in (JaxModelRunner, ModelRunner):
        with pytest.raises(ValueError) as e:
            runner_cls.embed_prompts(types.SimpleNamespace(embed_ready=False),
                                     [[1, 2]])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "no MoE/MLA/sliding-window" in msgs[1]


@pytest.mark.parametrize("raw", [
    "hello", ["a", "b"], [1, 2, 3], [[1, 2], [3]], [], [[]], [1, "a"],
    {"x": 1}, 5, None, [[1, "a"]], [True, 2],
])
def test_normalize_inputs_matches_reference(raw):
    outs = []
    for mod in (ref_emb, port_emb):
        try:
            outs.append(("ok", mod.normalize_inputs(raw)))
        except mod.EmbeddingError as e:
            outs.append(("err", str(e)))
    assert outs[0] == outs[1]


class _Vectors:
    """A token-level engine's embed half: fixed vectors, one per prompt."""

    def __init__(self):
        self.seen = []

    async def embed(self, prompts):
        self.seen.append(prompts)
        return np.arange(len(prompts) * 3, dtype=np.float32).reshape(-1, 3) + 1


@pytest.mark.parametrize("raw,tok,limit,vocab", [
    ("the quick brown fox", True, 64, 512),
    ("the quick brown fox", False, 64, 512),   # no tokenizer for text
    ([[1, 2, 3], [4]], False, 64, 512),
    ([[1, 2, 3]], False, 2, 512),              # past the context length
    ([[1, 600]], False, 64, 512),              # outside the vocabulary
    ([[1, 600]], False, 64, None),             # no vocabulary check
    (["the quick", ""], True, 64, 512),        # zero tokens
])
def test_embedder_matches_reference(tmp_path_factory, raw, tok, limit, vocab):
    model_dir = make_model_dir(tmp_path_factory.mktemp("emb"))
    outs = []
    for mod, tok_cls in ((ref_emb, RefTokenizer), (port_emb, HFTokenizer)):
        engine = _Vectors()
        e = mod.Embedder(tok_cls.from_pretrained_dir(model_dir) if tok else None,
                         engine, max_model_len=limit, vocab_size=vocab)
        try:
            vecs, ntok = asyncio.run(e.embed(raw))
            outs.append(("ok", vecs, ntok, engine.seen))
        except mod.EmbeddingError as err:
            outs.append(("err", str(err)))
    assert outs[0] == outs[1]
    if outs[0][0] == "ok":
        assert all(abs(np.linalg.norm(v) - 1) < 1e-6 for v in outs[1][1])


def test_echo_embedder_matches_reference():
    for raw in ("hello world", ["a b c", "d"], [1, 2, 3], [[4, 5], [6]]):
        want = asyncio.run(ref_emb.EchoEmbedder(dim=8).embed(raw))
        got = asyncio.run(port_emb.EchoEmbedder(dim=8).embed(raw))
        assert got == want


# ------------------------------------------------------------------ the route

EMBED_CASES = [
    ("tiny", {"input": "the quick brown fox"}),
    ("tiny", {"input": ["hello world", "a b c d e f g", "x"]}),
    ("tiny", {"input": [5, 6, 7, 8, 9]}),
    ("tiny", {"input": [[5, 6], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]]}),
    ("tiny", {"input": "hello world", "encoding_format": "base64"}),
    ("tiny", {"input": []}),
    ("tiny", {"input": {"bad": 1}}),
    ("tiny", {"input": [[1, 700]]}),
    ("tiny", {"input": [list(range(3, 200))]}),
    ("tiny", {"input": ["a", ""]}),
    ("tiny", {"input": "x", "encoding_format": "hex"}),
    ("tiny", {}),
    ("nope", {"input": "x"}),
    ("plain", {"input": "x"}),
    (None, {"input": "x"}),
]


async def _post_all(port, model_key):
    out = []
    async with aiohttp.ClientSession() as s:
        for model, body in EMBED_CASES:
            payload = dict(body, **({"model": model} if model else {}))
            if model_key and model == "tiny":
                payload["model"] = model_key
            async with s.post(f"http://127.0.0.1:{port}/v1/embeddings",
                              json=payload) as r:
                out.append((r.status, json.loads(await r.read())))
    return out


def _assert_bodies(got, want, tol):
    for (gs, gb), (ws, wb) in zip(got, want):
        assert gs == ws, (gb, wb)
        if gs != 200:
            assert gb["error"]["type"] == wb["error"]["type"]
            assert gb["error"].get("code") == wb["error"].get("code")
            if gs == 400:
                assert gb["error"]["message"] == wb["error"]["message"]
            continue
        assert {k: v for k, v in gb.items() if k != "data"} == {
            k: v for k, v in wb.items() if k != "data"}
        assert [(d["object"], d["index"]) for d in gb["data"]] == [
            (d["object"], d["index"]) for d in wb["data"]]
        for dg, dw in zip(gb["data"], wb["data"]):
            eg, ew = dg["embedding"], dw["embedding"]
            if isinstance(ew, str):
                import base64

                eg = np.frombuffer(base64.b64decode(eg), np.float32)
                ew = np.frombuffer(base64.b64decode(ew), np.float32)
            np.testing.assert_allclose(np.asarray(eg), np.asarray(ew),
                                       rtol=tol, atol=tol)
            assert abs(np.linalg.norm(eg) - 1) < 1e-5


@pytest.fixture(scope="module")
def route_setup(tmp_path_factory):
    model_dir = make_model_dir(tmp_path_factory.mktemp("route"))
    params = jax_llama.init_params(JaxModelConfig(**TINY),
                                   jax.random.PRNGKey(11), jnp.float32)
    return model_dir, params, jax.device_get(params)


def test_embeddings_route_matches_reference_over_the_engines(route_setup):
    from dynamo_tpu.llm.backend import Backend as RefBackend
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
    from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as RefPre
    from dynamo_tpu.runtime.pipeline import build_pipeline as ref_build
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime.pipeline import build_pipeline

    model_dir, params, host_params = route_setup

    async def serve(svc, core, card, tok_cls, pre, back, build, emb):
        tok = tok_cls.from_pretrained_dir(model_dir)
        mdc = card.from_local_path(model_dir, "tiny")
        pipe = build([pre(mdc, tok), back(tok)], core)
        pipe.embedder = emb.Embedder(tok, core, max_model_len=BASE["max_model_len"],
                                     vocab_size=TINY["vocab_size"])
        plain = build([pre(mdc, tok), back(tok)], core)  # no embedder: 501
        manager = svc.ModelManager()
        for name, eng in (("tiny", pipe), ("plain", plain)):
            manager.add_chat_model(name, eng)
            manager.add_completion_model(name, eng)
        service = svc.HttpService(manager, host="127.0.0.1", port=0)
        await service.start()
        try:
            return await _post_all(service.port, None)
        finally:
            await service.stop()
            await core.close()

    async def main():
        jcore = await JaxServingEngine.create(
            types.SimpleNamespace(model_path=None), engine_config=JaxEngineConfig(
                model=JaxModelConfig(**TINY), **BASE), params=params,
            warmup=False)
        want = await serve(ref_service, jcore, RefCard, RefTokenizer, RefPre,
                           RefBackend, ref_build, ref_emb)
        cfg = EngineConfig(model=ModelConfig(**TINY), **BASE)
        tcore = await TorchServingEngine.create(
            cfg, params=from_jax_params(host_params, cfg.model, "cpu", "float32"),
            device="cpu", warmup=False)
        assert tcore.embed_ready
        got = await serve(port_service, tcore, ModelDeploymentCard,
                          HFTokenizer, OpenAIPreprocessor, Backend,
                          build_pipeline, port_emb)
        return got, want

    got, want = asyncio.run(asyncio.wait_for(main(), 240))
    _assert_bodies(got, want, 1e-5)
    statuses = [s for s, _ in got]
    assert statuses[:5] == [200] * 5 and 404 in statuses and 501 in statuses
    assert got[1][1]["usage"]["prompt_tokens"] == sum(
        len(HFTokenizer.from_pretrained_dir(model_dir).encode(t))
        for t in EMBED_CASES[1][1]["input"])
    assert got[3][1]["usage"] == {"prompt_tokens": 14, "total_tokens": 14}


def test_embeddings_route_matches_reference_over_the_echo_stack():
    async def serve(svc, full, emb):
        manager = svc.ModelManager()
        engine = full()
        engine.embedder = emb.EchoEmbedder()
        manager.add_chat_model("tiny", engine)
        manager.add_chat_model("plain", full())
        service = svc.HttpService(manager, host="127.0.0.1", port=0)
        await service.start()
        try:
            return await _post_all(service.port, None)
        finally:
            await service.stop()

    want = asyncio.run(serve(ref_service, RefEchoFull, ref_emb))
    got = asyncio.run(serve(port_service, EchoEngineFull, port_emb))
    _assert_bodies(got, want, 0.0)
    assert [s for s, _ in got if s == 200] and got[0][1] == want[0][1]


def test_cli_builders_attach_the_embedders(tmp_path):
    from dynamo_tpu_torch.cli import run

    d = make_model_dir(tmp_path, config_overrides=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=512))
    extra = tmp_path / "f32.json"
    extra.write_text(json.dumps({"dtype": "float32"}))

    async def main():
        echo, _ = await run.build_engine("echo_full", run.parse_flags([]))
        assert isinstance(echo.embedder, port_emb.EchoEmbedder)
        pipe, mdc = await run.build_engine("torch", run.parse_flags([
            "--model-path", d, "--allow-random-weights", "--device", "cpu",
            "--extra-engine-args", str(extra), "--max-model-len", "64",
            "--num-kv-blocks", "32"]))
        try:
            assert isinstance(pipe.embedder, port_emb.Embedder)
            assert pipe.embedder.engine is pipe.core_engine
            assert pipe.embedder.max_model_len == 64
            text_vecs, text_tok = await pipe.embedder.embed(["hello world"])
            id_vecs, id_tok = await pipe.embedder.embed([[5, 6, 7]])
            return text_vecs + id_vecs, text_tok + id_tok
        finally:
            await pipe.close()

    vecs, ntok = asyncio.run(main())
    assert len(vecs) == 2 and len(vecs[0]) == 64
    assert ntok == 3 + len(HFTokenizer.from_pretrained_dir(d).encode("hello world"))
