"""Differential tests of the port's GGUF reading (``dynamo_tpu_torch/llm/
gguf.py``, ``llm/gguf_tensors.py``, ``models/loader.load_gguf_llama_params``
and the GGUF tokenizers of ``llm/tokenizer.py``) against the JAX package's.

A struct-level GGUF v3 writer (below, as ``tests/test_gguf.py`` has one)
writes every file:

- each of the 11 ggml types the reference reads (f32, f16, bf16, q8_0,
  q4_0, q4_1, q5_0, q5_1, q4_k, q5_k, q6_k) dequantizes bit for bit as
  ``dynamo_tpu.llm.gguf_tensors.dequantize`` does, on random blocks;
- the metadata: ``hf_config_from_gguf``, ``ModelConfig.from_model_dir``
  and ``mdc_from_gguf`` equal the reference's;
- the q/k unpermute equals the reference's and inverts llama.cpp's permute;
- a tiny Llama exported as llama.cpp exports it (q/k permuted, all 11
  types among its tensors) loads into the tree the reference loads, bit for
  bit in f32 and bf16, and ``ModelRunner(model_dir=<.gguf>)`` gives the
  reference runner's logits;
- both tokenizer kinds — ``gpt2`` (byte-level BPE from the embedded
  merges: ``chip_smoke``'s synthetic vocabulary) and ``llama``
  (SentencePiece-semantics Unigram over the pieces' scores, byte fallback,
  CONTROL and USER_DEFINED pieces) — encode ids and decode text as the
  reference's ``tokenizers`` reconstruction does over a fixed text set.
"""

import dataclasses
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model_runner import ModelRunner as JaxModelRunner
from dynamo_tpu.llm import gguf as jax_gguf
from dynamo_tpu.llm import gguf_tensors as jax_gguf_tensors
from dynamo_tpu.models import loader as jax_loader
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.llm import gguf, gguf_tensors
from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
from dynamo_tpu_torch.models import loader

# gguf metadata value types
U32, I32, F32, BOOL, STR, ARR = 4, 5, 6, 7, 8, 9
# ggml tensor types: id, bytes a block, elements a block
GGML = {"f32": (0, 4, 1), "f16": (1, 2, 1), "bf16": (30, 2, 1),
        "q4_0": (2, 18, 32), "q4_1": (3, 20, 32), "q5_0": (6, 22, 32),
        "q5_1": (7, 24, 32), "q8_0": (8, 34, 32), "q4_k": (12, 144, 256),
        "q5_k": (13, 176, 256), "q6_k": (14, 210, 256)}
# the f16 scale fields of a block (byte offsets)
F16_FIELDS = {"q4_0": (0,), "q4_1": (0, 2), "q5_0": (0,), "q5_1": (0, 2),
              "q8_0": (0,), "q4_k": (0, 2), "q5_k": (0, 2), "q6_k": (208,)}


def _str(text: str) -> bytes:
    raw = text.encode()
    return struct.pack("<Q", len(raw)) + raw


def _value(vtype, v) -> bytes:
    if vtype == STR:
        return _str(v)
    if vtype == BOOL:
        return struct.pack("<B", int(v))
    if vtype == ARR:
        item, vals = v
        return (struct.pack("<IQ", item, len(vals))
                + b"".join(_value(item, x) for x in vals))
    return struct.pack({U32: "<I", I32: "<i", F32: "<f"}[vtype], v)


def write_gguf(path, metadata, tensors=()):
    """GGUF v3: ``metadata`` [(key, type, value)], ``tensors`` [(name, ggml
    type name, numpy shape, raw bytes)], data aligned to 32 bytes."""
    descs, blobs, off = [], [], 0
    for name, kind, shape, raw in tensors:
        descs.append((name, tuple(reversed(shape)), GGML[kind][0], off))
        blobs.append(raw + b"\0" * ((-len(raw)) % 32))
        off += len(blobs[-1])
    with open(path, "wb") as f:
        f.write(b"GGUF" + struct.pack("<IQQ", 3, len(descs), len(metadata)))
        for key, vtype, v in metadata:
            f.write(_str(key) + struct.pack("<I", vtype) + _value(vtype, v))
        for name, ne, ggml_type, offset in descs:
            f.write(_str(name) + struct.pack("<I", len(ne)))
            f.write(b"".join(struct.pack("<Q", d) for d in ne))
            f.write(struct.pack("<IQ", ggml_type, offset))
        f.write(b"\0" * ((-f.tell()) % 32))
        for blob in blobs:
            f.write(blob)


def _random_blocks(kind, n, rng, finite=True):
    """Raw bytes of ``n`` elements of ggml type ``kind``: random bits, the
    f16 scales made small and finite when ``finite``."""
    _, block_bytes, block_elems = GGML[kind]
    nb = n // block_elems
    if kind in ("f32", "f16", "bf16"):
        x = rng.standard_normal(n).astype(np.float32)
        if kind == "f32":
            return x.tobytes()
        if kind == "f16":
            return x.astype("<f2").tobytes()
        return (x.view(np.uint32) >> 16).astype("<u2").tobytes()
    raw = rng.integers(0, 256, nb * block_bytes, dtype=np.uint8).reshape(nb, -1)
    if finite:
        for o in F16_FIELDS[kind]:
            raw[:, o:o + 2] = (rng.uniform(-0.004, 0.004, nb)
                               .astype("<f2").view(np.uint8).reshape(nb, 2))
    return raw.tobytes()


@pytest.mark.parametrize("kind", sorted(GGML))
def test_dequantize_equals_reference(kind):
    rng = np.random.default_rng(GGML[kind][0])
    n = 3 * 256
    raw = np.frombuffer(_random_blocks(kind, n, rng, finite=False), np.uint8)
    info = gguf.GgufTensorInfo("t", (256, 3), GGML[kind][0], 0)
    rinfo = jax_gguf.GgufTensorInfo("t", (256, 3), GGML[kind][0], 0)
    assert gguf_tensors.tensor_nbytes(info) == jax_gguf_tensors.tensor_nbytes(rinfo)
    got = gguf_tensors.dequantize(info, raw.copy())
    want = jax_gguf_tensors.dequantize(rinfo, raw.copy())
    assert got.shape == want.shape == (3, 256) and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_unpermute_equals_reference_and_inverts_the_permute():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((7 * 8, 12)).astype(np.float32)
    permuted = (w.reshape(7, 2, 4, 12).swapaxes(1, 2).reshape(56, 12))
    got = loader._gguf_unpermute(torch.from_numpy(permuted), 7).numpy()
    assert np.array_equal(got, jax_loader._gguf_unpermute(permuted, 7))
    assert np.array_equal(got, w)


# a tiny Llama (the reference's tests/test_gguf_tensors.py TINY) with every
# ggml type among its tensors; tensors a multiple of 256 elements
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0)
LAYER_TYPES = {"attn_q": "q8_0", "attn_k": "q4_0", "attn_v": "q4_1",
               "attn_output": "q5_0", "ffn_gate": "q5_1", "ffn_up": "q4_k",
               "ffn_down": "q5_k"}


def _meta(arch="llama", **extra):
    h, kvh = TINY["num_attention_heads"], TINY["num_key_value_heads"]
    meta = [("general.architecture", STR, arch),
            ("general.name", STR, "tiny-gguf"),
            (f"{arch}.context_length", U32, TINY["max_position_embeddings"]),
            (f"{arch}.embedding_length", U32, TINY["hidden_size"]),
            (f"{arch}.block_count", U32, TINY["num_hidden_layers"]),
            (f"{arch}.feed_forward_length", U32, TINY["intermediate_size"]),
            (f"{arch}.attention.head_count", U32, h),
            (f"{arch}.attention.head_count_kv", U32, kvh),
            (f"{arch}.rope.freq_base", F32, TINY["rope_theta"]),
            (f"{arch}.attention.layer_norm_rms_epsilon", F32,
             TINY["rms_norm_eps"]),
            (f"{arch}.vocab_size", U32, TINY["vocab_size"]),
            ("tokenizer.ggml.bos_token_id", U32, 1),
            ("tokenizer.ggml.eos_token_id", U32, 2),
            ("tokenizer.chat_template", STR, "{{ messages }}")]
    return meta + [(k, t, v) for k, (t, v) in extra.items()]


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    rng = np.random.default_rng(1)
    d, v, inter = TINY["hidden_size"], TINY["vocab_size"], TINY["intermediate_size"]
    kvd = d // TINY["num_attention_heads"] * TINY["num_key_value_heads"]
    shapes = {"attn_q": (d, d), "attn_k": (kvd, d), "attn_v": (kvd, d),
              "attn_output": (d, d), "ffn_gate": (inter, d), "ffn_up": (inter, d),
              "ffn_down": (d, inter)}
    tensors = [("token_embd.weight", "f16", (v, d), None),
               ("output_norm.weight", "f32", (d,), None),
               ("output.weight", "q6_k", (v, d), None)]
    for i in range(TINY["num_hidden_layers"]):
        tensors += [(f"blk.{i}.attn_norm.weight", "f32", (d,), None),
                    (f"blk.{i}.ffn_norm.weight", "bf16", (d,), None)]
        tensors += [(f"blk.{i}.{k}.weight", LAYER_TYPES[k], shapes[k], None)
                    for k in LAYER_TYPES]
    tensors = [(n, k, s, _random_blocks(k, int(np.prod(s)), rng))
               for n, k, s, _ in tensors]
    path = str(tmp_path_factory.mktemp("gguf") / "tiny.gguf")
    write_gguf(path, _meta(), tensors)
    return path


def test_metadata_equals_reference(tiny_gguf):
    g, rg = gguf.read_gguf(tiny_gguf), jax_gguf.read_gguf(tiny_gguf)
    assert g.metadata == rg.metadata and g.data_offset == rg.data_offset
    assert [dataclasses.astuple(t) for t in g.tensors] == [
        dataclasses.astuple(t) for t in rg.tensors]
    assert gguf.hf_config_from_gguf(g) == jax_gguf.hf_config_from_gguf(rg)
    assert dataclasses.asdict(ModelConfig.from_model_dir(tiny_gguf)) == \
        dataclasses.asdict(JaxModelConfig.from_model_dir(tiny_gguf))
    mdc = dataclasses.asdict(gguf.mdc_from_gguf(tiny_gguf, kv_block_size=8))
    rmdc = dataclasses.asdict(jax_gguf.mdc_from_gguf(tiny_gguf, kv_block_size=8))
    assert mdc == {k: rmdc[k] for k in mdc}


def test_unsupported_architecture_raises(tmp_path):
    path = str(tmp_path / "q.gguf")
    write_gguf(path, _meta(arch="qwen2"))
    with pytest.raises(gguf.GgufError, match="qwen2"):
        gguf.hf_config_from_gguf(gguf.read_gguf(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loaded_tree_equals_reference(tiny_gguf, dtype):
    cfg = ModelConfig.from_model_dir(tiny_gguf)
    jcfg = JaxModelConfig.from_model_dir(tiny_gguf)
    port = loader.load_gguf_llama_params(
        tiny_gguf, cfg, torch.float32 if dtype == "float32" else torch.bfloat16)
    ref = jax.device_get(jax_loader.load_gguf_llama_params(
        tiny_gguf, jcfg, jnp.float32 if dtype == "float32" else jnp.bfloat16))
    flat = dict(port["layers"], **{k: v for k, v in port.items() if k != "layers"})
    rflat = dict(ref["layers"], **{k: v for k, v in ref.items() if k != "layers"})
    assert sorted(flat) == sorted(rflat)
    for k, want in rflat.items():
        want = np.asarray(want)
        got = flat[k]
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        else:
            got = got.numpy()
        assert got.shape == want.shape and np.array_equal(got, want), k


def test_runner_serves_gguf_like_reference(tiny_gguf):
    kw = dict(max_batch_size=1, max_model_len=64, kv_block_size=8,
              num_kv_blocks=32, dtype="float32", prefill_buckets=[16])
    jcfg = dataclasses.replace(JaxModelConfig.from_model_dir(tiny_gguf),
                               attention_impl="xla")
    jrun = JaxModelRunner(JaxEngineConfig(model=jcfg, **kw), model_dir=tiny_gguf)
    prun = ModelRunner(EngineConfig(model=ModelConfig.from_model_dir(tiny_gguf),
                                    **kw), device="cpu", model_dir=tiny_gguf)
    prompt = [1, 5, 9, 20, 33, 400, 7]
    s, bs, w = 16, 8, prun.config.blocks_per_seq
    tok = np.zeros((1, s), np.int32)
    tok[0, :len(prompt)] = prompt
    pos = np.arange(s, dtype=np.int32)[None]
    btab = np.zeros((1, w), np.int32)
    btab[0, :2] = [0, 1]
    slots = btab[0, pos // bs] * bs + pos % bs
    slots[pos >= len(prompt)] = -1
    ctx = np.full(1, len(prompt), np.int32)
    want, _ = jrun.arch.forward(jrun.params, jcfg, tok, pos, jrun.kv_cache,
                                btab, slots, ctx, mesh=jrun.mesh)
    t = [torch.from_numpy(a) for a in (tok, pos, btab, slots, ctx)]
    with torch.inference_mode():
        got, _ = prun.arch.forward(prun.params, prun.config.model, t[0], t[1],
                                   prun.kv_cache, *t[2:])
    np.testing.assert_allclose(got[0, :len(prompt)].numpy(),
                               np.asarray(want)[0, :len(prompt)],
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- tokenizers

TEXTS = ["hello world", "The quick brown fox jumps over the lazy dog.",
         "  two leading spaces and  double  gaps ", "tabs\tand\nnew\nlines",
         "ünïcödé — 日本語 ✓ 😀 emoji", "numbers 12345 and 3.14159",
         "<s>a control piece inside</s> the text", "<|user|>user defined",
         "", " ", "x"]


def _gguf_tokenizers(path):
    return (HFTokenizer.from_model_path(path),
            jax_gguf.tokenizer_from_gguf(jax_gguf.read_gguf(path)))


def _assert_tokenizers_agree(port, ref):
    for text in TEXTS:
        ids = ref.encode(text, add_special_tokens=False).ids
        assert port.encode(text) == ids, text
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip), (text, skip)
    every = list(range(ref.get_vocab_size()))[::7]
    assert port.decode(every) == ref.decode(every)


def test_gpt2_kind_tokenizer_equals_reference(tmp_path):
    import chip_smoke

    spec = chip_smoke.synthetic_tokenizer(vocab_size=1200, n_special=16)
    vocab = spec["model"]["vocab"]
    tokens = [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    specials = {t["content"] for t in spec["added_tokens"]}
    types = [3 if t in specials else 1 for t in tokens]
    path = str(tmp_path / "bpe.gguf")
    write_gguf(path, [
        ("general.architecture", STR, "llama"),
        ("tokenizer.ggml.model", STR, "gpt2"),
        ("tokenizer.ggml.tokens", ARR, (STR, tokens)),
        ("tokenizer.ggml.merges", ARR, (STR, [" ".join(m) for m in
                                              spec["model"]["merges"]])),
        ("tokenizer.ggml.token_type", ARR, (I32, types))])
    port, ref = _gguf_tokenizers(path)
    _assert_tokenizers_agree(port, ref)
    assert port.encode("<|reserved_special_token_3|>x") == ref.encode(
        "<|reserved_special_token_3|>x", add_special_tokens=False).ids


def _spm_vocab(seed=0):
    """A SentencePiece-style vocabulary: <unk>, two CONTROL pieces, the 256
    byte pieces, one USER_DEFINED piece, the corpus's characters and ▁-words
    and random word pieces, with random scores (some pieces repeated)."""
    from fixtures import CORPUS

    rng = np.random.default_rng(seed)
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    tokens.append("<|user|>")
    types.append(4)
    pieces = set()
    for line in CORPUS:
        text = "▁" + line.replace(" ", "▁")
        pieces.update(c for c in text if c not in "中✓")
        for _ in range(60):
            a = int(rng.integers(0, len(text) - 1))
            pieces.add(text[a:a + int(rng.integers(2, 7))])
    pieces = sorted(pieces)
    tokens += pieces + pieces[:5]
    types += [1] * (len(pieces) + 5)
    scores = [0.0] * 260 + list(-rng.uniform(1, 12, len(tokens) - 260))
    return tokens, [float(np.float32(s)) for s in scores], types


def test_llama_kind_tokenizer_equals_reference(tmp_path):
    tokens, scores, types = _spm_vocab()
    path = str(tmp_path / "spm.gguf")
    write_gguf(path, [
        ("general.architecture", STR, "llama"),
        ("tokenizer.ggml.model", STR, "llama"),
        ("tokenizer.ggml.tokens", ARR, (STR, tokens)),
        ("tokenizer.ggml.scores", ARR, (F32, scores)),
        ("tokenizer.ggml.token_type", ARR, (I32, types)),
        ("tokenizer.ggml.unknown_token_id", U32, 0)])
    port, ref = _gguf_tokenizers(path)
    _assert_tokenizers_agree(port, ref)
    # a text of random corpus characters and unknowns, segmented alike
    rng = np.random.default_rng(9)
    alphabet = list("abcdefghij klmnop▁.,中✓😀é")
    for _ in range(20):
        text = "".join(rng.choice(alphabet, int(rng.integers(1, 40))))
        assert port.encode(text) == ref.encode(text, add_special_tokens=False).ids


def test_unsupported_tokenizer_kind_raises(tmp_path):
    path = str(tmp_path / "t.gguf")
    write_gguf(path, [("general.architecture", STR, "llama"),
                      ("tokenizer.ggml.model", STR, "bert"),
                      ("tokenizer.ggml.tokens", ARR, (STR, ["a"]))])
    with pytest.raises(gguf.GgufError, match="bert"):
        HFTokenizer.from_model_path(path)
