"""Differential tests of the port's guided decoding
(``dynamo_tpu_torch/engine/guided.py``) against the JAX package's.

- Choices: tries, the ``TrieConstraint`` cursor's ``allowed`` / ``advance``
  verdicts along seeded walks, ``compile_device_table``'s tables and state
  ids, all exactly equal, over seeded choice lists with shared prefixes,
  with and without eos ids, and at the ``max_states`` bound.
- JSON: ``compile_schema``'s node lists and refusal messages; seeded walks
  of ``JsonGrammar`` (json_object and schemas, over an adversarial piece
  table and over the fixtures' tokenizer) with the state, the mask and
  ``at_end`` equal at every step; the JSON branch of
  ``compile_device_table`` (equal tables and state ids, None from both past
  the bound); ``build_piece_table`` over the port's tokenizer against the
  reference's over ``tokenizers``; the bounded, locked LRU mask cache; the
  table key, which the reference takes from ``id(grammar)`` (a dropped
  grammar's id is reused and its table served to another schema).
- Engines: greedy guided JSON streams of ``TorchServingEngine`` equal
  ``JaxServingEngine``'s token for token on the synchronous and the
  chained engine, sampled streams conform, a lone compiled grammar rides
  the chain, two compiled grammars fall back as ``guided_multi_grammar``,
  ``n > 1`` gives a cursor per child, a preempted stream's cursor is
  re-walked, and an ``out=none`` frontend forwards ``json_object`` and
  ``guided_json`` through the processor to a token-level worker.
"""

import asyncio

import numpy as np
import pytest
import torch

from dynamo_tpu.engine import guided as jax_guided
from dynamo_tpu_torch.engine import guided

VOCAB = 300


def _choices(seed, n=6, max_len=5):
    """``n`` choices that share prefixes: each new choice keeps a random
    prefix of an earlier one; some are prefixes of others."""
    rng = np.random.default_rng(seed)
    out = [[int(t) for t in rng.integers(0, VOCAB, rng.integers(1, max_len + 1))]]
    while len(out) < n:
        base = out[rng.integers(0, len(out))]
        keep = int(rng.integers(0, len(base) + 1))
        tail = [int(t) for t in rng.integers(0, VOCAB, rng.integers(0, max_len))]
        cand = (base[:keep] + tail) or [int(rng.integers(0, VOCAB))]
        out.append(cand)
    return out


@pytest.mark.parametrize("seed", range(5))
def test_trie_and_cursor_match_reference(seed):
    choices = _choices(seed)
    assert guided.GUIDED_END == jax_guided.GUIDED_END
    assert guided.build_choice_trie(choices) == jax_guided.build_choice_trie(choices)
    rng = np.random.default_rng(100 + seed)
    for choice in choices + [[VOCAB + 5], choices[0][:1] + [VOCAB - 1]]:
        a, b = guided.TrieConstraint(choices), jax_guided.TrieConstraint(choices)
        # walk the choice, then one token that may derail
        for t in list(choice) + [int(rng.integers(0, VOCAB))]:
            ia, ea = a.allowed()
            ib, eb = b.allowed()
            assert (sorted(ia), ea) == (sorted(ib), eb)
            va, vb = a.advance(t), b.advance(t)
            assert va == vb and a.path == b.path
            if va != "ok":
                break
        a.reset()
        b.reset()
        assert a.path == b.path == () and a.allowed() == b.allowed()
    # state_key: equal positions share a key, an advance changes it
    c = guided.TrieConstraint(choices)
    k0 = c.state_key()
    assert c.advance(choices[0][0]) in ("ok", "done") and c.state_key() != k0


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("eos", [(), (2,), (2, 299, 1000)])
def test_device_table_matches_reference(seed, eos):
    choices = _choices(seed, n=8)
    got = guided.compile_device_table(
        guided.TrieConstraint(choices), VOCAB, eos, max_states=256)
    want = jax_guided.compile_device_table(
        jax_guided.TrieConstraint(choices), VOCAB, eos, max_states=256)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got.table, want.table)
    assert got.table.dtype == want.table.dtype == np.int32
    assert got.state_ids == want.state_ids
    assert got.n_states == want.n_states and got.kind == want.kind == "trie"
    # the cursor's state id follows both along every choice
    for choice in choices:
        a, b = guided.TrieConstraint(choices), jax_guided.TrieConstraint(choices)
        for t in choice:
            assert got.state_id(a) == want.state_id(b) is not None
            row = got.table[got.state_id(a)]
            allowed, at_end = a.allowed()
            legal = set(t for t in allowed if t < VOCAB)
            if at_end:
                legal |= {e for e in eos if e < VOCAB}
            assert set(np.nonzero(row >= 0)[0].tolist()) == legal
            if a.advance(t) != "ok":
                assert row[t] == guided.DeviceGuidedTable.DONE
                break
            b.advance(t)
    # the device form: padded to the bucket with reject rows, cached
    dev = got.device(64, "cpu")
    assert dev.dtype == torch.int32 and dev.shape == (64, VOCAB)
    np.testing.assert_array_equal(dev.numpy()[: got.n_states], got.table)
    assert (dev.numpy()[got.n_states:] == -1).all()
    assert got.device(64, "cpu") is dev


def test_device_table_state_bound_and_foreign_constraint():
    choices = _choices(7, n=8)
    full = guided.compile_device_table(guided.TrieConstraint(choices), VOCAB)
    n = len(full.state_ids)
    for bound, fits in ((n, True), (n - 1, False), (2, False)):
        got = guided.compile_device_table(
            guided.TrieConstraint(choices), VOCAB, max_states=bound)
        want = jax_guided.compile_device_table(
            jax_guided.TrieConstraint(choices), VOCAB, max_states=bound)
        assert (got is not None) == (want is not None) == fits
    assert guided.compile_device_table(object(), VOCAB) is None
    # a live cursor is never touched by the compile
    c = guided.TrieConstraint(choices)
    c.advance(choices[0][0])
    path = c.path
    guided.compile_device_table(c, VOCAB)
    assert c.path == path


# ---------------------------------------------------------------- guided JSON

# an adversarial piece table: structural chars, multi-char fusions, numbers,
# escapes, literals, and junk the masks must ban (ids 0/1 reserved: None,
# banned like specials)
PIECES = [None] * 128
for _i, _s in enumerate([
    '{', '}', '[', ']', '"', ':', ',', ' ', '\n', '-',
    '0', '1', '7', '25', '3.5', '0.25', 'e5', 'E-2', '.5',
    'a', 'b', 'ab', 'name', 'x', 'y z', 'true', 'false', 'null',
    '{"', '"}', '":', '": ', '", "', '"a"', '\\', '\\n', '\\u00e9',
    'tr', 'ue', 'nu', 'll', '[]', '{}', '[1', ',2]', 'word up',
    '!', '@#', '<tag>', "'", '\t', '\x01', 'r', 'e', 'd', 'g', 'n',
    'red', 'gr', 'een', 'blue', 'l', 'u', 'age', 'ok', 'color', 'scores',
    '"red"', '"n', 'ame"', '"age":', '�', '"ok": ', 'col', 'or"',
]):
    PIECES[_i + 2] = _s

SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "ok": {"type": "boolean"},
        "color": {"enum": ["red", "green", "blue", 7, None]},
        "scores": {"type": "array", "items": {"type": "number"}},
        "a": {"type": "null"},
        "ab": {"type": "object", "properties": {"x": {"type": "string"}},
               "required": ["x"]},
    },
    "required": ["name", "age"],
}
SCHEMAS = [
    SCHEMA,
    {"type": "array", "items": {"type": "boolean"}},
    {"enum": ["a", "ab", 25, True]},
    {"type": "object"},
    {"properties": {"n": {}}, "title": "T", "description": "d"},
    True,
    {},
    {"type": "string"},
    {"type": "number"},
    {"type": "array"},
]
BAD_SCHEMAS = [
    {"type": "string", "pattern": "a+"},
    {"type": "number", "minimum": 3},
    {"type": "array", "items": {}, "minItems": 1},
    {"oneOf": [{"type": "string"}]},
    {"type": ["string", "number"]},
    {"type": "object", "required": ["id"]},
    {"type": "object", "properties": {'a"b': {"type": "string"}}},
    {"type": "object", "properties": {"a\nb": {"type": "string"}}},
    {"type": "object", "properties": {}},
    {"type": "object", "properties": {"a": {}}, "required": ["b"]},
    {"enum": []},
    {"enum": [[1]]},
    {"type": "tuple"},
    3,
]


@pytest.mark.parametrize("schema", SCHEMAS, ids=range(len(SCHEMAS)))
def test_compile_schema_matches_reference(schema):
    assert guided.compile_schema(schema) == jax_guided.compile_schema(schema)


@pytest.mark.parametrize("schema", BAD_SCHEMAS, ids=range(len(BAD_SCHEMAS)))
def test_compile_schema_refusals_match_reference(schema):
    with pytest.raises(ValueError) as want:
        jax_guided.compile_schema(schema)
    with pytest.raises(ValueError) as got:
        guided.compile_schema(schema)
    assert str(got.value) == str(want.value)


def _fixture_pieces(vocab=None):
    """Both packages' piece tables over the fixtures' tokenizer (the HF
    ``tokenizers`` one for the reference, the port's own reader of the same
    ``tokenizer.json``)."""
    import json as _json
    import os
    import sys
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fixtures import build_tiny_tokenizer

    from dynamo_tpu.llm.tokenizer import HFTokenizer as RefTokenizer
    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer

    hf = build_tiny_tokenizer()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tokenizer.json")
        hf.save(path)
        port_tok = HFTokenizer.from_file(path)
    ref_tok = RefTokenizer(hf)
    n = vocab or ref_tok.vocab_size
    return (guided.build_piece_table(port_tok, n),
            jax_guided.build_piece_table(ref_tok, n), ref_tok)


def test_piece_table_matches_reference():
    got, want, ref_tok = _fixture_pieces()
    assert got == want
    assert sum(p is not None for p in got) > 100
    # larger than the tokenizer: the tail is None in both
    got, want, _ = _fixture_pieces(ref_tok.vocab_size + 7)
    assert got == want and got[-7:] == [None] * 7


def _walk_both(schema, pieces, seed, steps=200):
    """One seeded walk of both machines over the masks: the state, the
    allowed ids, ``at_end`` and the verdict equal at every step."""
    rng = np.random.default_rng(seed)
    ga, gb = guided.JsonGrammar(pieces, schema), jax_guided.JsonGrammar(pieces, schema)
    a, b = guided.JsonConstraint(ga), jax_guided.JsonConstraint(gb)
    visited = 0
    for _ in range(steps):
        assert a.state == b.state and a.state_key() == b.state_key()
        ia, ea = a.allowed()
        ib, eb = b.allowed()
        assert ia == ib and ea == eb
        visited += 1
        if not ia:
            break
        t = int(ia[rng.integers(0, len(ia))])
        # now and then a token off the mask: both derail alike
        if rng.random() < 0.05:
            t = int(rng.integers(0, len(pieces)))
        va, vb = a.advance(t), b.advance(t)
        assert va == vb and a.state == b.state
        if va != "ok":
            break
    a.reset()
    b.reset()
    assert a.state == b.state == ga.initial()
    return visited


@pytest.mark.parametrize("which", ["synthetic", "tokenizer"])
@pytest.mark.parametrize("schema", [None, SCHEMA, SCHEMAS[1], SCHEMAS[2]],
                         ids=["json_object", "schema", "bool_array", "enum"])
def test_json_walks_match_reference(which, schema):
    pieces = PIECES if which == "synthetic" else _fixture_pieces()[0]
    steps = [_walk_both(schema, pieces, seed) for seed in range(6)]
    # the walks went past their first state (an enum's are short)
    assert sum(steps) > (8 if schema is SCHEMAS[2] else 30)


SMALL_OBJECT = {"type": "object", "required": ["ok"], "properties": {
    "ok": {"type": "boolean"}, "color": {"enum": ["red", "blue", None]}}}


@pytest.mark.parametrize("schema", [SCHEMAS[1], SCHEMAS[2], SMALL_OBJECT],
                         ids=["bool_array", "enum", "object"])
@pytest.mark.parametrize("eos", [(), (1,), (1, 127, 1000)])
def test_json_device_table_matches_reference(schema, eos):
    """The JSON branch: equal tables and state ids at a bound that fits,
    None from both at one that does not (and for json_object's deep state
    space at the default bound)."""
    vocab = len(PIECES)
    ga = guided.JsonGrammar(PIECES, schema)
    gb = jax_guided.JsonGrammar(PIECES, schema)
    want = jax_guided.compile_device_table(
        jax_guided.JsonConstraint(gb), vocab, eos, max_states=4096, budget_s=60)
    got = guided.compile_device_table(
        guided.JsonConstraint(ga), vocab, eos, max_states=4096, budget_s=60)
    assert got is not None and want is not None and got.kind == want.kind == "json"
    np.testing.assert_array_equal(got.table, want.table)
    assert got.state_ids == want.state_ids and got.n_states == want.n_states
    n = len(got.state_ids)
    for bound, fits in ((n, True), (n - 1, False)):
        a = guided.compile_device_table(guided.JsonConstraint(ga), vocab, eos,
                                        max_states=bound, budget_s=60)
        b = jax_guided.compile_device_table(jax_guided.JsonConstraint(gb),
                                            vocab, eos, max_states=bound,
                                            budget_s=60)
        assert (a is not None) == (b is not None) == fits
    # a live cursor maps to the same id in both along a walk
    a, b = guided.JsonConstraint(ga), jax_guided.JsonConstraint(gb)
    rng = np.random.default_rng(5)
    for _ in range(40):
        assert got.state_id(a) == want.state_id(b) is not None
        ids, _ = a.allowed()
        if not ids:
            break
        t = int(ids[rng.integers(0, len(ids))])
        if a.advance(t) != "ok":
            break
        b.advance(t)


def test_json_object_table_exceeds_the_default_bound():
    for mod in (guided, jax_guided):
        g = mod.JsonGrammar(PIECES)
        assert mod.compile_device_table(mod.JsonConstraint(g), len(PIECES),
                                        (1,), budget_s=60) is None


def test_mask_cache_is_a_bounded_lru_of_the_reference_lists(monkeypatch):
    """The port bounds the reference's unbounded per-grammar mask cache: an
    LRU over states, whose lists equal the reference's, a hit returning the
    cached list itself, and two threads sweeping one grammar agreeing."""
    import threading

    monkeypatch.setattr(guided.JsonGrammar, "MASK_CACHE_STATES", 4)
    ga = guided.JsonGrammar(PIECES, SCHEMA)
    gb = jax_guided.JsonGrammar(PIECES, SCHEMA)
    states = []
    c = jax_guided.JsonConstraint(gb)
    rng = np.random.default_rng(2)
    while len(states) < 12:
        if c.state not in states:
            states.append(c.state)
        ids, _ = c.allowed()
        if not ids or c.advance(int(ids[rng.integers(0, len(ids))])) != "ok":
            c.reset()
    for s in states:
        assert ga.allowed_tokens(s) == gb.allowed_tokens(s)
        assert len(ga._mask_cache) <= 4
    assert list(ga._mask_cache) == states[-4:]
    hit = ga.allowed_tokens(states[-2])
    assert hit is ga._mask_cache[states[-2]]
    assert list(ga._mask_cache)[-1] == states[-2]  # the touch moved it last
    assert len(gb._mask_cache) == len(set(states))  # the reference keeps all
    # more threads than cores sweep and touch one grammar, switching often:
    # a lost update of the LRU would break its bound or hand back a list
    # that is not the reference's
    import sys

    fresh = guided.JsonGrammar(PIECES, SCHEMA)
    want = [gb.allowed_tokens(s) for s in states]
    out = {}

    def sweep(i):
        order = list(range(len(states)))
        np.random.default_rng(i).shuffle(order)
        out[i] = {j: fresh.allowed_tokens(states[j]) for j in order * 3}

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=sweep, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(fresh._mask_cache) <= 4
    for i in range(12):
        assert [out[i][j] for j in range(len(states))] == want


def _sched_request(mod, spec, grammar, eos=(2,)):
    """An EngineRequest of either package carrying a JSON cursor."""
    import asyncio as _asyncio

    from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
    from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
    )

    from dynamo_tpu.engine import scheduler as jax_scheduler
    from dynamo_tpu_torch.engine import scheduler as torch_scheduler

    torch_side = mod is guided
    req_cls = PreprocessedRequest if torch_side else JaxRequest
    samp_cls = SamplingOptions if torch_side else JaxSampling
    sched = torch_scheduler if torch_side else jax_scheduler
    return sched.EngineRequest(
        request_id="r", prompt=[1], ctx=None, out_queue=_asyncio.Queue(),
        req=req_cls(token_ids=[1], eos_token_ids=list(eos),
                    sampling_options=samp_cls(guided_json=spec)),
        guided=mod.JsonConstraint(grammar)), sched.Scheduler


def test_json_table_key_never_reuses_a_dropped_grammars_id():
    """The reference keys a compiled JSON table by ``id(grammar)``: once the
    serving LRU drops a grammar, a new grammar for ANOTHER schema can take
    its id and be served the old table (its initial state is the same
    tuple, so the cursor even maps). The port keys by the spec's canonical
    text (the serving cache's key), or by the grammar itself."""
    spec_a = {"type": "json_schema", "schema": SCHEMAS[1]}
    spec_b = {"type": "json_schema", "schema": SCHEMAS[2]}
    # the port: equal specs share a key across grammar objects, different
    # specs never do, whatever the ids
    ea, sched = _sched_request(guided, spec_a, guided.JsonGrammar(PIECES, SCHEMAS[1]))
    eb, _ = _sched_request(guided, dict(reversed(list(spec_a.items()))),
                           guided.JsonGrammar(PIECES, SCHEMAS[1]))
    ec, _ = _sched_request(guided, spec_b, guided.JsonGrammar(PIECES, SCHEMAS[2]))
    ka, kb, kc = (sched._guided_table_key(None, e) for e in (ea, eb, ec))
    assert ka == kb != kc and ka[0] == "json"
    # without a spec the key holds the grammar itself (alive)
    ed, _ = _sched_request(guided, None, guided.JsonGrammar(PIECES, SCHEMAS[1]))
    kd = sched._guided_table_key(None, ed)
    assert kd[1] is ed.guided.grammar
    # the reference: drop a grammar and allocate the next one at once, so it
    # takes the freed block (CPython reuses it nearly every time); its key
    # equals the dropped grammar's
    for _ in range(50):
        g = jax_guided.JsonGrammar(PIECES, SCHEMAS[1])
        er, ref_sched = _sched_request(jax_guided, spec_a, g)
        stale_key = ref_sched._guided_table_key(None, er)
        table = jax_guided.compile_device_table(er.guided, len(PIECES), [2])
        old_id = id(g)
        del er, g  # the grammar's own block is the last one freed
        g2 = jax_guided.JsonGrammar.__new__(jax_guided.JsonGrammar)
        if id(g2) == old_id:
            g2.__init__(PIECES, SCHEMAS[2])
            break
    else:
        raise AssertionError("CPython never reused a dropped grammar's id")
    er2, _ = _sched_request(jax_guided, spec_b, g2)
    assert ref_sched._guided_table_key(None, er2) == stale_key
    # the stale table maps the new schema's cursor: the reference would
    # chain an enum request on the bool array's transitions
    assert table.state_id(er2.guided) == 1
    port_key = sched._guided_table_key(
        None, _sched_request(guided, spec_b, guided.JsonGrammar(
            PIECES, SCHEMAS[2]))[0])
    assert port_key != ka


# ------------------------------------------------- guided JSON through engines

ENG_TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
                max_position_embeddings=256)
ENG_BASE = dict(max_batch_size=4, max_model_len=128, kv_block_size=8,
                num_kv_blocks=64, dtype="float32")
ENG_LOOP = dict(decode_pipeline_depth=2, multi_step_decode=4)
EOS = 2  # the fixtures' tokenizer's "</s>"
JSON_SPECS = [
    {"type": "json_object"},
    {"type": "json_schema", "schema": SMALL_OBJECT},
    {"type": "json_schema", "schema": SCHEMA},
    {"type": "json_schema", "schema": SCHEMAS[1]},
]


@pytest.fixture(scope="module")
def json_setup(tmp_path_factory):
    import os
    import sys

    import jax
    import jax.numpy as jnp

    from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
    from dynamo_tpu.models import llama as jax_llama

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fixtures import make_model_dir

    model_dir = make_model_dir(tmp_path_factory.mktemp("guided_json"))
    params = jax_llama.init_params(JaxModelConfig(**ENG_TINY),
                                   jax.random.PRNGKey(9), jnp.float32)
    return model_dir, params, jax.device_get(params)


def _json_requests(n_sampled=0):
    rng = np.random.default_rng(31)
    reqs = [dict(prompt=[int(t) for t in rng.integers(3, 500, 9 + 3 * i)],
                 spec=spec, samp=dict(temperature=0.0), max_tokens=40)
            for i, spec in enumerate(JSON_SPECS)]
    for i in range(n_sampled):
        reqs.append(dict(prompt=[int(t) for t in rng.integers(3, 500, 12)],
                         spec=JSON_SPECS[i % len(JSON_SPECS)], max_tokens=40,
                         samp=dict(temperature=0.9, seed=100 + i)))
    return reqs


async def _json_torch(setup, cfg_kw, reqs, hook=None, pieces=None, eos=EOS):
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.models.weights import from_jax_params
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    model_dir, _, host_params = setup
    cfg = EngineConfig(model=ModelConfig(**ENG_TINY), **cfg_kw)
    engine = await TorchServingEngine.create(
        cfg, params=from_jax_params(host_params, cfg.model, "cpu", "float32"),
        device="cpu", warmup=False)
    engine._model_path = model_dir
    if pieces is not None:  # a piece table injected, as tests/test_guided.py does
        engine._pieces, engine._model_path = pieces, "<injected>"
    if hook is not None:
        hook(engine)

    async def one(r):
        req = PreprocessedRequest(
            token_ids=r["prompt"], eos_token_ids=[eos],
            stop_conditions=StopConditions(max_tokens=r["max_tokens"]),
            sampling_options=SamplingOptions(guided_json=r["spec"],
                                             **r["samp"]))
        toks, finish = {}, {}
        async for out in engine.generate(Context(req)):
            c = out.get("choice") or 0
            toks.setdefault(c, []).extend(out["token_ids"])
            if out.get("finish_reason"):
                finish[c] = out["finish_reason"]
        return [(toks[c], finish.get(c)) for c in sorted(toks)]

    try:
        outs = await asyncio.gather(*(one(r) for r in reqs))
        return outs, engine.metrics(), engine.scheduler.allocator.used
    finally:
        await engine.close()


async def _json_jax(setup, cfg_kw, reqs, pieces=None, eos=EOS):
    import types

    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
    from dynamo_tpu.engine.serving import JaxServingEngine
    from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
    from dynamo_tpu.protocols.common import SamplingOptions as JaxSampling
    from dynamo_tpu.protocols.common import StopConditions as JaxStop
    from dynamo_tpu.runtime.engine import Context as JaxContext

    model_dir, params, _ = setup
    cfg = JaxEngineConfig(model=JaxModelConfig(**ENG_TINY), **cfg_kw)
    engine = await JaxServingEngine.create(
        types.SimpleNamespace(model_path=None), engine_config=cfg,
        params=params, warmup=False)
    engine._model_path = model_dir
    if pieces is not None:
        engine._pieces, engine._model_path = pieces, "<injected>"

    async def one(r):
        req = JaxRequest(
            token_ids=r["prompt"], eos_token_ids=[eos],
            stop_conditions=JaxStop(max_tokens=r["max_tokens"]),
            sampling_options=JaxSampling(guided_json=r["spec"], **r["samp"]))
        toks, finish = [], None
        async for out in engine.generate(JaxContext(req)):
            toks.extend(out["token_ids"])
            finish = out.get("finish_reason") or finish
        return [(toks, finish)]

    try:
        return await asyncio.gather(*(one(r) for r in reqs))
    finally:
        await engine.close()


def _conforms(spec, pieces, toks, finish, eos=EOS):
    """A finished reply parses (and meets its schema's required keys); a
    cut one is a legal prefix under a fresh walk of the grammar."""
    import json as _json

    schema = spec.get("schema") if spec["type"] == "json_schema" else None
    g = guided.JsonGrammar(pieces, schema)
    text = "".join(pieces[t] or "" for t in toks if t != eos)
    state = g.run_piece(g.initial(), text)
    assert state is not None, (text, finish)
    if finish == "length":
        return False
    assert g.at_end(state), (text, finish)
    obj = _json.loads(text)
    if schema is None:
        assert isinstance(obj, dict)
    elif isinstance(schema, dict) and schema.get("type") == "object":
        assert set(schema.get("required", ())) <= set(obj)
        assert set(obj) <= set(schema["properties"])
    return True


@pytest.mark.parametrize("table", ["tokenizer", "injected"])
@pytest.mark.parametrize("mode", ["sync", "chained"])
def test_json_engine_streams_match_jax_engine(json_setup, mode, table):
    """Greedy guided JSON streams of ``TorchServingEngine`` equal
    ``JaxServingEngine``'s token for token, on the synchronous and the
    chained engine, each over its own package's piece table of the same
    ``tokenizer.json`` or over the adversarial table injected in both;
    sampled streams conform."""
    cfg_kw = dict(ENG_BASE, **(ENG_LOOP if mode == "chained" else {}))
    reqs = _json_requests()
    if table == "injected":
        # id 1 is no piece: an eos that only a legal end admits
        injected = PIECES + [None] * (ENG_TINY["vocab_size"] - len(PIECES))
        kw = dict(pieces=injected, eos=1)
    else:
        kw = {}
    want = asyncio.run(_json_jax(json_setup, cfg_kw, reqs, **kw))
    got, metrics, used = asyncio.run(_json_torch(json_setup, cfg_kw, reqs, **kw))
    assert got == want
    assert used == 0
    pieces = kw.get("pieces") or _fixture_pieces(ENG_TINY["vocab_size"])[0]
    eos = kw.get("eos", EOS)
    finished = [_conforms(r["spec"], pieces, *o[0], eos=eos)
                for r, o in zip(reqs, got)]
    assert any(finished)
    if mode == "chained":
        # the small grammars' tables compiled (or were still compiling);
        # json_object's deep state space fell back by name
        assert set(metrics["sync_fallback"]) & {
            "guided_table_bound", "guided_table_pending",
            "guided_multi_grammar"}
    sampled = _json_requests(n_sampled=8)[len(JSON_SPECS):]
    outs, _, used = asyncio.run(_json_torch(json_setup, cfg_kw, sampled, **kw))
    assert used == 0
    for r, o in zip(sampled, outs):
        _conforms(r["spec"], pieces, *o[0], eos=eos)


def test_json_chained_table_serves_a_lone_grammar(json_setup):
    """A lone request whose grammar compiles rides the chain on its device
    table once the table lands, and streams as the synchronous engine."""
    reqs = [dict(prompt=[5, 6, 7, 8, 9, 10], spec=JSON_SPECS[3],
                 samp=dict(temperature=0.0), max_tokens=60)]
    sync, _, _ = asyncio.run(_json_torch(json_setup, ENG_BASE, reqs))
    tables = []

    def hook(engine):
        compile_table = engine.scheduler._compile_guided_table

        def record(er):
            table = compile_table(er)
            tables.append(table)
            return table
        engine.scheduler._compile_guided_table = record

    got, metrics, _ = asyncio.run(_json_torch(
        json_setup, dict(ENG_BASE, **ENG_LOOP), reqs, hook))
    assert got == sync
    assert len(tables) == 1 and tables[0] is not None
    assert tables[0].kind == "json"
    assert metrics["chain_len_max"] >= 1 and metrics["decode_pipeline_bursts"] > 0
    assert metrics["device_finished_rows"] >= 1  # the table's DONE state


def test_json_n2_gives_one_cursor_per_child(json_setup):
    seen = []

    def hook(engine):
        add = engine.scheduler.add_request

        def record(er):
            seen.append(er)
            return add(er)
        engine.scheduler.add_request = record

    reqs = [dict(prompt=[4, 9, 16, 25, 36], spec=JSON_SPECS[1], max_tokens=30,
                 samp=dict(temperature=0.9, seed=7, n=2))]
    (outs,), _, used = asyncio.run(_json_torch(json_setup, ENG_BASE, reqs, hook))
    assert len(outs) == 2 and used == 0
    assert len(seen) == 2
    a, b = (er.guided for er in seen)
    assert isinstance(a, guided.JsonConstraint) and a is not b
    assert a.grammar is b.grammar
    pieces = _fixture_pieces(ENG_TINY["vocab_size"])[0]
    for toks, finish in outs:
        _conforms(JSON_SPECS[1], pieces, toks, finish)


def test_json_preemption_resume_rewalks_the_cursor(json_setup):
    """A wave that outgrows a small cache preempts; each resumed stream's
    cursor is reset and re-walked over its emitted tokens, so the streams
    equal a roomy engine's and the reference's at the same size."""
    small = dict(ENG_BASE, num_kv_blocks=12, max_prefill_tokens_per_step=32)
    rng = np.random.default_rng(44)
    reqs = [dict(prompt=[int(t) for t in rng.integers(3, 500, 20)],
                 spec=JSON_SPECS[i % 2], samp=dict(temperature=0.0),
                 max_tokens=28) for i in range(4)]
    got, metrics, used = asyncio.run(_json_torch(json_setup, small, reqs))
    roomy, _, _ = asyncio.run(_json_torch(json_setup, ENG_BASE, reqs))
    want = asyncio.run(_json_jax(json_setup, small, reqs))
    assert metrics["preemptions"] > 0 and used == 0
    assert got == roomy == want


def test_json_object_through_the_processor_path(json_setup):
    """The distributed graph's processor path: an ``in=http out=none``
    frontend (``ModelWatcher``) forwards ``response_format`` json_object
    and the ``guided_json`` extra field to a processor (preprocess, route,
    detokenize), whose token-level worker's engine walks the grammar; each
    reply is the worker engine's own stream and conforms."""
    import aiohttp

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.http import service as port_service
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.processor import build_processor_pipeline
    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
    from dynamo_tpu_torch.models.weights import from_jax_params
    from dynamo_tpu_torch.protocols import sse
    from dynamo_tpu_torch.protocols.annotated import Annotated
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.client import Client, RouterMode
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.transports.memory import MemoryHub

    model_dir, _, host_params = json_setup
    schema = {"type": "object", "properties": {"ok": {"type": "boolean"}},
              "required": ["ok"]}
    bodies = [dict(model="tiny", max_tokens=40, temperature=0.0, stream=True,
                   messages=[{"role": "user", "content": content}], **extra)
              for content, extra in (
                  ("give me json", dict(response_format={"type": "json_object"})),
                  ("a flag please", dict(guided_json=schema)))]

    async def main():
        hub = MemoryHub()
        drt = DistributedRuntime.in_process(hub)
        ep = drt.namespace("g").component("backend").endpoint("generate")
        cfg = EngineConfig(model=ModelConfig(**ENG_TINY), **ENG_BASE)
        mdc = ModelDeploymentCard.from_local_path(model_dir, "tiny")
        core = await TorchServingEngine.create(
            cfg, params=from_jax_params(host_params, cfg.model, "cpu", "float32"),
            device="cpu", warmup=False, mdc=mdc)
        seen = []

        async def handler(payload, ctx):
            ids = []
            seen.append((payload["sampling_options"].get("guided_json"), ids))
            async for out in core.generate(Context(payload, ctx)):
                ids.extend(out["token_ids"])
                yield out

        serving = await ep.serve(handler, instance_id="w-0")
        p_drt = DistributedRuntime.in_process(hub)
        client = Client(p_drt.namespace("g").component("backend").endpoint(
            "generate"), RouterMode.ROUND_ROBIN)
        await client.start()
        await client.wait_for_instances(1)
        engine = build_processor_pipeline(
            mdc, client, None, HFTokenizer.from_pretrained_dir(model_dir))
        p_ep = p_drt.namespace("g").component("processor").endpoint("chat")

        async def p_handler(payload, ctx):
            req = ChatCompletionRequest.model_validate(payload)
            async for chunk in engine.generate(Context(req, ctx)):
                yield chunk.to_wire() if isinstance(chunk, Annotated) else (
                    chunk if isinstance(chunk, dict)
                    else chunk.model_dump(exclude_none=True))

        p_serving = await p_ep.serve(p_handler)
        await port_service.register_model(p_drt, "g", "tiny", p_ep.path(),
                                          model_type="chat")
        f_drt = DistributedRuntime.in_process(hub)
        manager = port_service.ModelManager()
        watcher = port_service.ModelWatcher(f_drt, manager, "g")
        await watcher.start()
        service = port_service.HttpService(manager, host="127.0.0.1", port=0)
        await service.start()
        try:
            while manager.model_names() != ["tiny"]:
                await asyncio.sleep(0.01)
            replies = []
            async with aiohttp.ClientSession() as session:
                for body in bodies:
                    async with session.post(
                            f"http://127.0.0.1:{service.port}/v1/chat/completions",
                            json=body) as r:
                        raw = await r.read()
                        assert r.status == 200, raw
                    chunks = [c for c in sse.parse_stream(raw) if c.get("choices")]
                    replies.append((
                        "".join((c["choices"][0].get("delta") or {}).get(
                            "content") or "" for c in chunks),
                        [c["choices"][0].get("finish_reason") for c in chunks][-1]))
            return replies, seen
        finally:
            await service.stop()
            await watcher.stop()
            await p_serving.stop()
            await serving.stop()
            await engine.close()
            await core.close()

    replies, seen = asyncio.run(asyncio.wait_for(main(), 120))
    specs = [s for s, _ in seen]
    assert specs == [{"type": "json_object"},
                     {"type": "json_schema", "schema": schema}]
    pieces = _fixture_pieces(ENG_TINY["vocab_size"])[0]
    for (text, finish), (spec, ids) in zip(replies, seen):
        assert text == "".join(pieces[t] or "" for t in ids if t != EOS)
        _conforms(spec, pieces, ids, "length" if finish == "length" else "stop")


def test_json_rows_of_two_grammars_fall_back_by_name(json_setup):
    """Two rows whose grammars both compiled to tables cannot share one
    chained burst: the chained engine counts ``guided_multi_grammar`` and
    serves them on the host path, streaming as the reference's chained
    engine does; json_object's deep grammar falls back as
    ``guided_table_bound``."""
    cfg_kw = dict(ENG_BASE, **ENG_LOOP)
    warm = [dict(prompt=[7, 8, 9, 10], spec=spec, samp=dict(temperature=0.0),
                 max_tokens=40) for spec in (JSON_SPECS[1], JSON_SPECS[3],
                                             JSON_SPECS[0])]
    pair = [dict(prompt=[11, 12, 13, 14, 15], spec=spec,
                 samp=dict(temperature=0.0), max_tokens=40)
            for spec in (JSON_SPECS[1], JSON_SPECS[3])]

    async def torch_side():
        from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
        from dynamo_tpu_torch.engine.serving import TorchServingEngine
        from dynamo_tpu_torch.models.weights import from_jax_params

        model_dir, _, host_params = json_setup
        cfg = EngineConfig(model=ModelConfig(**ENG_TINY), **cfg_kw)
        engine = await TorchServingEngine.create(
            cfg, params=from_jax_params(host_params, cfg.model, "cpu", "float32"),
            device="cpu", warmup=False)
        engine._model_path = model_dir
        try:
            outs = [await _serve_one(engine, r) for r in warm]
            # every table compiled or refused before the pair arrives
            while engine.scheduler._guided_table_futs:
                await asyncio.sleep(0.01)
            before = dict(engine.metrics()["sync_fallback"])
            outs += await asyncio.gather(*(_serve_one(engine, r) for r in pair))
            after = engine.metrics()["sync_fallback"]
            return outs, before, after
        finally:
            await engine.close()

    outs, before, after = asyncio.run(torch_side())
    assert before.get("guided_table_bound", 0) > 0
    assert after.get("guided_multi_grammar", 0) > before.get(
        "guided_multi_grammar", 0)
    want = asyncio.run(_json_jax(json_setup, cfg_kw, warm + pair))
    assert [o for o in outs] == [w[0] for w in want]


async def _serve_one(engine, r):
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    req = PreprocessedRequest(
        token_ids=r["prompt"], eos_token_ids=[EOS],
        stop_conditions=StopConditions(max_tokens=r["max_tokens"]),
        sampling_options=SamplingOptions(guided_json=r["spec"], **r["samp"]))
    toks, finish = [], None
    async for out in engine.generate(Context(req)):
        toks.extend(out["token_ids"])
        finish = out.get("finish_reason") or finish
    return toks, finish


class _HeldExecutor:
    """A default executor whose jobs run only when the test says so, in the
    order it says, on the loop's thread: the grammar builds of
    ``_json_constraint`` then complete in a fixed order."""

    def __new__(cls):
        import concurrent.futures

        class Held(concurrent.futures.ThreadPoolExecutor):
            def __init__(self):
                super().__init__(max_workers=1)
                self.held = {}

            def submit(self, fn, *args, **kwargs):
                fut = concurrent.futures.Future()
                self.held[fn] = (fut, args, kwargs)
                return fut

            def finish(self, fn):
                fut, args, kwargs = self.held.pop(fn)
                fut.set_result(fn(*args, **kwargs))

        return Held()


def _follower_touch_outcome(engine_cls):
    """Drive the order that evicts a follower's key: X's leader and its
    follower, 31 other builds pending (futures, never evictable), Z's build;
    X's build finishes (nothing evictable, X stays), then Z's in the same
    loop pass evicts X before the follower wakes and touches it. Returns the
    follower's outcome."""
    import threading

    engine = engine_cls.__new__(engine_cls)
    engine._json_grammars = {}
    engine._model_path = "pieces-preset"
    engine._pieces = PIECES
    engine._pieces_lock = threading.Lock()
    engine.piece_table_s = None
    spec = lambda schema: {"type": "json_schema", "schema": schema}  # noqa: E731
    x, z = spec(SCHEMAS[1]), spec(SCHEMAS[2])
    others = [spec({"type": "object", "title": f"p{i}"}) for i in range(31)]

    async def go():
        loop = asyncio.get_running_loop()
        held = _HeldExecutor()
        loop.set_default_executor(held)
        leader = asyncio.ensure_future(engine._json_constraint(x))
        await asyncio.sleep(0)
        (build_x,) = held.held
        follower = asyncio.ensure_future(engine._json_constraint(x))
        pending = [asyncio.ensure_future(engine._json_constraint(s))
                   for s in others]
        await asyncio.sleep(0)
        builds_p = [fn for fn in held.held if fn is not build_x]
        last = asyncio.ensure_future(engine._json_constraint(z))
        await asyncio.sleep(0)
        (build_z,) = [fn for fn in held.held
                      if fn is not build_x and fn not in builds_p]
        assert len(engine._json_grammars) == 33
        held.finish(build_x)
        held.finish(build_z)
        await asyncio.gather(leader, last)
        out = (await asyncio.gather(follower, return_exceptions=True))[0]
        for fn in builds_p:
            held.finish(fn)
        await asyncio.gather(*pending)
        return out

    return asyncio.run(go())


def test_follower_lru_touch_survives_its_key_evicted():
    """A follower that awaited its leader's build touches the LRU entry
    after a third spec's build evicted it: the reference's ``pop(key)``
    raises ``KeyError``, the port's serves the follower."""
    from dynamo_tpu.engine.serving import JaxServingEngine
    from dynamo_tpu_torch.engine.serving import TorchServingEngine

    ref = _follower_touch_outcome(JaxServingEngine)
    assert isinstance(ref, KeyError), ref
    port = _follower_touch_outcome(TorchServingEngine)
    assert isinstance(port, guided.JsonConstraint), port
