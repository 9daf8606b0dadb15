"""The port's pure-Python ``tokenizer.json`` reader against ``tokenizers``
and the reference's ``HFTokenizer``.

Four tokenizers: the fixture tokenizer (``make_model_dir``), the synthetic
128,256-id byte-level BPE that ``chip_smoke.py`` serves, a Llama-2-style
byte-fallback BPE (Prepend / Replace normalizers, unknowns fused) with a
Metaspace twin, and a ``Split``-pattern BPE with Llama-3's pattern,
``ignore_merges`` and added tokens of every option. Text from hypothesis
covers scripts, emoji, digits, whitespace runs and special tokens: encode
ids equal exactly; decode text (both ``skip_special_tokens``) and
``DecodeStream`` increments equal exactly. The regex translation is held
against Oniguruma inside ``tokenizers`` and the ``regex`` module on every
code point below 0x30000.
"""

import json
import re

import numpy as np
import pytest
import regex
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models
from tokenizers import normalizers, pre_tokenizers, processors, trainers

import chip_smoke
from dynamo_tpu.llm.tokenizer import HFTokenizer as RefHFTokenizer
from dynamo_tpu_torch.llm import tokenizer as port
from fixtures import CORPUS, build_tiny_tokenizer, make_model_dir

TEXT_CORPUS = CORPUS + [
    "Hello World! HELLO world, it's 2024 and we'll see 3.14159 or 1000000.",
    "Привет мир, как дела? Γειά σου κόσμε. مرحبا بالعالم. नमस्ते दुनिया",
    "日本語のテキストと中文文本 한국어 텍스트 ünïcode naïve café résumé",
    "def f(x):\n    return x ** 2  # tabs\tand\r\nnewlines\n\n\n",
    "emoji 😀 🎉 👍🏽 ✓ ✗ → ← ∑ ∫ ½ ³ ① ⅷ",
]
PIECES = [
    "hello", " world", "The", "don't", "I'LL", "'s", "'Re", "123456", "3.14",
    " ", "  ", "   ", "\t", "\n", "\n\n", "\r\n", " \n ", "\x85", "　",
    "\x1c", "\xa0", "é", "ünïcode", "Ünï", "Ünï", "中文", "日本語", "😀",
    "🎉👍🏽", "Привет", "γειά", "مرحبا", "नमस्ते", '{"a": [1, -2]}', "ſ", "K",
    "ʕ", "①", "³", "١٢٣", "word", "words", " word ", "<s>", "</s>", "<unk>",
    "<|user|>", "<|assistant|>", "<|eot|>", "<mask>", " <mask> ", " zzyzx",
    "zzyzx", "<|begin_of_text|>", "<|eot_id|>", "<|start_header_id|>",
    "<0x41>", "▁", "▁▁x",
]
TEXT = st.lists(st.one_of(st.sampled_from(PIECES), st.text(max_size=6)),
                max_size=24).map("".join)
SETTINGS = settings(max_examples=150, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _pair(ref: Tokenizer):
    """(reference tokenizer, port tokenizer) from one tokenizer.json."""
    return ref, port.Tokenizer.from_str(ref.to_str())


def _check(ref: Tokenizer, tok: port.Tokenizer, text: str) -> None:
    for special in (False, True):
        ids = ref.encode(text, add_special_tokens=special).ids
        assert tok.encode(text, add_special_tokens=special) == ids, (text, special)
    _check_decode(ref, tok, ids)


def _check_decode(ref: Tokenizer, tok: port.Tokenizer, ids) -> None:
    for skip in (True, False):
        assert tok.decode(ids, skip_special_tokens=skip) == ref.decode(
            ids, skip_special_tokens=skip), (ids, skip)
        a = RefHFTokenizer(ref).decode_stream(skip)
        b = port.HFTokenizer(tok).decode_stream(skip)
        assert [b.step(i) for i in ids] == [a.step(i) for i in ids], ids


# ------------------------------------------------------------ the tokenizers

def _llama2_style(metaspace: bool) -> Tokenizer:
    """Byte-fallback BPE with unknowns fused: Llama-2's normalizers and
    decoder, or a Metaspace pre-tokenizer / decoder twin with digits
    split; the 4-byte UTF-8 lead bytes are left out of the byte tokens, so
    emoji fall to the fused unknown."""
    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True,
                               byte_fallback=True))
    if metaspace:
        tok.normalizer = normalizers.NFKC()
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Metaspace(prepend_scheme="first"),
            pre_tokenizers.Digits(individual_digits=True)])
        tok.decoder = decoders.Sequence([
            decoders.Metaspace(prepend_scheme="first"),
            decoders.ByteFallback(), decoders.Fuse()])
    else:
        tok.normalizer = normalizers.Sequence([
            normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
        tok.decoder = decoders.Sequence([
            decoders.Replace("▁", " "), decoders.ByteFallback(),
            decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.train_from_iterator(TEXT_CORPUS, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<unk>", "<s>", "</s>"]))
    spec = json.loads(tok.to_str())
    vocab = spec["model"]["vocab"]
    for b in range(256):
        if not 0xF0 <= b <= 0xF4:
            vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    return Tokenizer.from_str(json.dumps(spec))


def _llama3_style() -> Tokenizer:
    """Llama-3's Split pattern over a byte-level BPE, ``ignore_merges``
    (with vocabulary words no merge reaches), NFC, a template
    post-processor, and added tokens with lstrip / rstrip / single_word /
    normalized."""
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(chip_smoke.LLAMA3_SPLIT), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(TEXT_CORPUS, trainers.BpeTrainer(
        vocab_size=600, special_tokens=["<|bos|>", "<|eot|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    spec = json.loads(tok.to_str())
    spec["model"]["ignore_merges"] = True
    vocab = spec["model"]["vocab"]
    for word in ("Ġzzyzx", "zzyzx", "Ġworld", "Ġwords"):
        vocab.setdefault(word, len(vocab))
    tok = Tokenizer.from_str(json.dumps(spec))
    tok.add_special_tokens([AddedToken("<mask>", lstrip=True, rstrip=True,
                                       special=True)])
    tok.add_tokens([AddedToken("word", single_word=True),
                    AddedToken("Ünï", normalized=True)])
    tok.post_processor = processors.TemplateProcessing(
        single="<|bos|> $A", pair="<|bos|> $A <|bos|> $B",
        special_tokens=[("<|bos|>", tok.token_to_id("<|bos|>"))])
    return tok


@pytest.fixture(scope="module")
def synthetic():
    return _pair(Tokenizer.from_str(json.dumps(chip_smoke.synthetic_tokenizer())))


TOKENIZERS = {
    "fixture": lambda: build_tiny_tokenizer(),
    "llama2_byte_fallback": lambda: _llama2_style(False),
    "metaspace_byte_fallback": lambda: _llama2_style(True),
    "llama3_split_ignore_merges": _llama3_style,
}


@pytest.fixture(scope="module", params=sorted(TOKENIZERS))
def built(request):
    return _pair(TOKENIZERS[request.param]())


# ------------------------------------------------------------------- tests

@SETTINGS
@given(text=TEXT)
def test_encode_decode_and_stream_match_tokenizers(built, text):
    _check(*built, text)


@SETTINGS
@given(text=TEXT)
def test_synthetic_tokenizer_matches_tokenizers(synthetic, text):
    _check(*synthetic, text)


def test_synthetic_tokenizer_decodes_every_id_and_random_streams(synthetic):
    """Every id of the 128,256 decodes as ``tokenizers`` decodes it; random
    id streams (the random-weight model's output) decode and stream alike,
    and the text of random ids re-encodes alike."""
    ref, tok = synthetic
    assert tok.get_vocab_size() == ref.get_vocab_size() == 128256
    for i in range(0, 128256, 7):
        assert tok.decode([i], False) == ref.decode([i], skip_special_tokens=False)
    rng = np.random.default_rng(0)
    for n in (1, 5, 64, 400):
        ids = [int(t) for t in rng.integers(0, 128256, n)]
        _check_decode(ref, tok, ids)
        _check(ref, tok, ref.decode(ids))


def test_reference_surface_matches(tmp_path):
    """The port's ``HFTokenizer`` from the fixture directory answers as the
    reference's: encode, decode, token / id lookups, vocab size."""
    d = make_model_dir(tmp_path)
    a = RefHFTokenizer.from_pretrained_dir(d)
    b = port.HFTokenizer.from_pretrained_dir(d)
    text = "<s>USER: the quick brown fox? ASSISTANT: paris</s> 中文 ✓"
    assert b.encode(text) == a.encode(text)
    assert b.encode(text, add_special_tokens=True) == a.encode(
        text, add_special_tokens=True)
    ids = a.encode(text)
    assert b.decode(ids) == a.decode(ids)
    assert b.decode(ids, False) == a.decode(ids, False)
    assert b.vocab_size == a.vocab_size
    for t in ("<s>", "the", "Ġthe", "nope"):
        assert b.token_to_id(t) == a.token_to_id(t)
    for i in (0, 1, 5, 285, 286, 10_000):
        assert b.id_to_token(i) == a.id_to_token(i)


def _onig_set(prop: str, chars: str) -> set:
    """The chars Oniguruma (inside ``tokenizers``) matches with ``prop``."""
    split = pre_tokenizers.Split(Regex(prop), behavior="removed")
    kept = "".join(p for p, _ in split.pre_tokenize_str(chars))
    return set(chars) - set(kept)


PROPS = ("L", "Lu", "Ll", "Lt", "Lm", "Lo", "M", "Mn", "Mc", "Me", "N",
         "Nd", "Nl", "No", "P", "S", "Z", "C", "Letter", "Number")


def test_property_classes_match_oniguruma_and_regex():
    """Each ``\\p{..}`` class (and ``\\s``, ``\\d``) the translation builds
    equals Oniguruma's inside ``tokenizers`` on every code point below
    0x30000, and the ``regex`` module's wherever ``regex`` and Oniguruma
    agree: they disagree only on code points whose category Unicode 17
    (``regex``) changed or assigned after Unicode 16 (``tokenizers``'
    Oniguruma), and there the port follows ``tokenizers``, whose ids it
    must reproduce."""
    chars = "".join(chr(c) for c in range(0x30000) if not 0xD800 <= c < 0xE000)
    for prop in [rf"\p{{{p}}}" for p in PROPS] + [r"\P{L}", r"\s", r"\S", r"\d"]:
        ours = set(re.findall(port.translate_pattern(prop), chars))
        onig = _onig_set(prop, chars)
        assert ours == onig, (prop, sorted(map(ord, ours ^ onig))[:10])
        theirs = set(regex.findall(prop, chars))
        assert ours ^ theirs == onig ^ theirs, prop
        # Unicode 17's additions and recategorisations: hundreds, not more
        assert len(onig ^ theirs) < 1000, prop
        inside = set(re.findall(port.translate_pattern(f"[x{prop}]"), chars))
        assert inside == ours | {"x"}, prop


def test_llama3_and_o200k_patterns_split_as_tokenizers():
    """Whole pre-tokenizer patterns (Llama-3's, Qwen2's and o200k's, whose
    case-insensitive groups, possessive classes and lookaheads ``re``
    must take) split text as Oniguruma does."""
    o200k = (r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}"
             r"\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?|[^\r\n\p{L}\p{N}]?"
             r"[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
             r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+"
             r"[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+")
    qwen2 = chip_smoke.LLAMA3_SPLIT.replace(r"\p{N}{1,3}", r"\p{N}")
    texts = TEXT_CORPUS + ["".join(PIECES), "HELLOworld DON'T camelCaseWord"]
    for pattern in (chip_smoke.LLAMA3_SPLIT, qwen2, o200k, port.GPT2_PATTERN):
        ref = pre_tokenizers.Split(Regex(pattern), "isolated")
        rx = port.compile_pattern(("Regex", pattern))
        for t in texts:
            want = [p for p, _ in ref.pre_tokenize_str(t)]
            got = [t[a:e] for a, e in port._apply_behavior(
                port._find_matches(rx, t), "isolated")]
            assert got == want, (pattern, t)


@pytest.mark.parametrize("behavior", ["removed", "isolated",
                                      "merged_with_previous",
                                      "merged_with_next", "contiguous"])
@pytest.mark.parametrize("invert", [False, True])
def test_split_behaviors_match_tokenizers(behavior, invert):
    for pattern, kind in ((" ", "String"), (r"\d+|-", "Regex")):
        ref = pre_tokenizers.Split(Regex(pattern) if kind == "Regex" else pattern,
                                   behavior, invert=invert)
        fn = port._pre_tokenizer({"type": "Split", "pattern": {kind: pattern},
                                  "behavior": behavior, "invert": invert})
        for t in (" a  b ", "x1-22 y--3", "", "   ", "abc"):
            want = [p for p, _ in ref.pre_tokenize_str(t)]
            got = [p.text for p in fn([port._Piece(t, True)])]
            assert got == want, (pattern, t)


@pytest.mark.parametrize("spec,name", [
    ({"model": {"type": "WordLevel", "vocab": {}}}, "WordLevel"),
    ({"model": {"type": "WordPiece", "vocab": {}}}, "WordPiece"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "pre_tokenizer": {"type": "Whitespace"}}, "Whitespace"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "normalizer": {"type": "Lowercase"}}, "Lowercase"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "decoder": {"type": "WordPiece"}}, "WordPiece"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "pre_tokenizer": {"type": "Split", "pattern": {"Regex": r"\w+"},
                        "behavior": "Isolated"}}, r"\w"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "pre_tokenizer": {"type": "Split", "pattern": {"Regex": r"\p{Han}"},
                        "behavior": "Isolated"}}, "Han"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": [], "dropout": 0.1}},
     "dropout"),
])
def test_unsupported_forms_raise_by_name(spec, name):
    with pytest.raises(NotImplementedError, match=re.escape(name)):
        port.Tokenizer(spec)


# the characters at a single_word added token's edge: Devanagari vowel
# sign (Mc), a nonspacing mark, a circled letter (So, Other_Alphabetic), an
# underscore (Pc), ZWJ, Arabic-Indic 3 (Nd), Roman numeral 12 (Nl), one
# half (No), a hyphen, a space, a Latin letter, a Han ideograph
WORD_EDGES = ["\u0947", "\u0301", "\u24d0", "_", "\u200d", "\u0663",
              "\u216b", "\u00bd", "-", " ", "x", "\u4e2d"]


@pytest.mark.parametrize("edge", WORD_EDGES)
def test_single_word_edges_follow_tokenizers_word_characters(edge):
    """``single_word`` matches only between non-word characters, with
    ``tokenizers``' Unicode ``\\w`` (marks, Other_Alphabetic, Pc,
    Join_Control count; No does not)."""
    ref = _llama3_style()
    tok = port.Tokenizer(json.loads(ref.to_str()))
    for text in (f"{edge}word", f"word{edge}", f"a{edge}word{edge}b"):
        assert tok.encode(text, add_special_tokens=False) == ref.encode(
            text, add_special_tokens=False).ids, repr(text)


def test_post_processor_raises_only_with_special_tokens():
    spec = json.loads(build_tiny_tokenizer().to_str())
    spec["post_processor"] = {"type": "BertProcessing", "sep": ["</s>", 2],
                              "cls": ["<s>", 1]}
    tok = port.Tokenizer(spec)
    assert tok.encode("hello", add_special_tokens=False)
    with pytest.raises(NotImplementedError, match="BertProcessing"):
        tok.encode("hello", add_special_tokens=True)


def test_sentencepiece_only_directory_and_gguf_raise_by_name(tmp_path):
    """A directory with only a SentencePiece ``tokenizer.model`` loads
    through the port's protobuf reader, and a corrupt one raises by name
    (``SpmModelError`` naming the file); a GGUF file's tokenizer loads."""
    from test_torch_gguf import ARR, STR, write_gguf

    (tmp_path / "tokenizer.model").write_bytes(_spm_proto(1).SerializeToString())
    tok = port.HFTokenizer.from_pretrained_dir(str(tmp_path))
    assert tok.decode(tok.encode("hello world")) == "hello world"
    for corrupt in (b"\x00", b"\x0a\x05ab", b"\x0a\x80", b"\x0b",
                    b"\x12\x02\x18\x02"):
        (tmp_path / "tokenizer.model").write_bytes(corrupt)
        with pytest.raises(port.SpmModelError, match="tokenizer.model"):
            port.HFTokenizer.from_pretrained_dir(str(tmp_path))
    path = str(tmp_path / "m.gguf")
    write_gguf(path, [("general.architecture", STR, "llama"),
                      ("tokenizer.ggml.model", STR, "gpt2"),
                      ("tokenizer.ggml.tokens", ARR, (STR, ["a", "b", "ab"])),
                      ("tokenizer.ggml.merges", ARR, (STR, ["a b"]))])
    tok = port.HFTokenizer.from_model_path(path)
    assert tok.encode("abab") == [2, 2] and tok.decode([2, 0]) == "aba"
    with pytest.raises(FileNotFoundError):
        port.HFTokenizer.from_pretrained_dir(str(tmp_path / "missing"))


# -------------------------------------------------- SentencePiece models

SPM_PIECES = [
    ("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
    ("<|user|>", 0.0, 4), ("<|end|>", 0.0, 3), ("<mask>", 0.0, 4),
] + [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)] + [
    ("▁", -1.0, 1), ("h", -2.0, 1), ("e", -2.0, 1), ("l", -2.0, 1),
    ("o", -2.0, 1), ("w", -2.0, 1), ("r", -2.0, 1), ("d", -2.0, 1),
    ("a", -2.5, 1), ("t", -2.5, 1), ("é", -3.0, 1), ("1", -3.0, 1),
    ("he", -3.0, 1), ("ll", -3.5, 1), ("llo", -4.0, 1), ("hello", -5.0, 1),
    ("▁hello", -5.5, 1), ("▁w", -6.0, 1), ("or", -6.0, 1), ("▁wor", -7.0, 1),
    ("ld", -7.0, 1), ("▁world", -8.0, 1), ("at", -8.5, 1), ("▁at", -9.0, 1),
    ("▁t", -9.0, 1), ("ello", -9.5, 1), ("▁he", -10.0, 1), ("lo", -10.0, 1),
    ("▁é", -11.0, 1), ("é1", -12.0, 1), ("▁▁", -12.5, 1),
]
SPM_TEXTS = [
    "hello world", "hello  world  ", " leading space", "héllo wörld",
    "日本語のテキスト", "emoji 😀 🎉", "tab\tand\nnewline\r\n", "<|user|>hi<|end|>",
    "x<mask>y <s> </s> <unk>", "", "▁▁ already", "at at at", "é1é1 é", "1234567",
    "\x00\x7f\u200b", "a" * 40, "hello<|user|> world",
]


def _spm_proto(model_type, pieces=SPM_PIECES, unk_id=0, trainer=True):
    """A ``ModelProto`` written by ``google.protobuf`` through transformers'
    bundled schema (the reference's own reader), with a normalizer spec and
    self-test data the readers must skip."""
    from transformers.convert_slow_tokenizer import import_protobuf

    proto = import_protobuf().ModelProto()
    for piece, score, kind in pieces:
        p = proto.pieces.add()
        p.piece, p.score, p.type = piece, score, kind
    if trainer:
        proto.trainer_spec.model_type = model_type
        proto.trainer_spec.unk_id = unk_id
        proto.trainer_spec.vocab_size = len(pieces)
        proto.trainer_spec.byte_fallback = True
    proto.normalizer_spec.name = "identity"
    proto.normalizer_spec.add_dummy_prefix = True
    sample = proto.self_test_data.samples.add()
    sample.input, sample.expected = "hello", "▁hello"
    return proto


@pytest.mark.parametrize("model_type,trainer", [(1, True), (2, True),
                                                (1, False)],
                         ids=["unigram", "bpe", "no_trainer_spec"])
def test_spm_reader_matches_reference(tmp_path, model_type, trainer):
    """``tokenizer_from_spm`` against the reference's (protobuf through
    transformers' schema, ``tokenizers``) on Unigram and BPE models with
    byte fallback, CONTROL, USER_DEFINED and UNKNOWN pieces: the same ids
    for text with non-ASCII characters and bytes outside the vocabulary,
    and the same text back (both ``skip_special_tokens``)."""
    from dynamo_tpu.llm.tokenizer import tokenizer_from_spm

    path = tmp_path / "tokenizer.model"
    path.write_bytes(_spm_proto(model_type, trainer=trainer).SerializeToString())
    ref, tok = tokenizer_from_spm(str(path)), port.tokenizer_from_spm(str(path))
    assert tok.get_vocab_size() == ref.get_vocab_size()
    for text in SPM_TEXTS:
        ids = tok.encode(text, add_special_tokens=False)
        assert ids == ref.encode(text, add_special_tokens=False).ids, repr(text)
        for skip in (True, False):
            assert tok.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip), repr(text)
    for i in range(len(SPM_PIECES)):
        assert tok.id_to_token(i) == ref.id_to_token(i)


@given(text=TEXT)
@SETTINGS
def test_spm_bpe_reader_matches_reference_on_any_text(text):
    ref, tok = _SPM_BPE_PAIR
    assert tok.encode(text, add_special_tokens=False) == ref.encode(
        text, add_special_tokens=False).ids
    ids = ref.encode(text, add_special_tokens=False).ids
    assert tok.decode(ids) == ref.decode(ids)


def _spm_bpe_pair():
    import tempfile

    from dynamo_tpu.llm.tokenizer import tokenizer_from_spm

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/tokenizer.model"
        with open(path, "wb") as f:
            f.write(_spm_proto(2).SerializeToString())
        return tokenizer_from_spm(path), port.tokenizer_from_spm(path)


_SPM_BPE_PAIR = _spm_bpe_pair()


def test_spm_reader_refuses_other_model_types_with_the_reference_words(tmp_path):
    from dynamo_tpu.llm.tokenizer import tokenizer_from_spm

    path = tmp_path / "tokenizer.model"
    path.write_bytes(_spm_proto(3).SerializeToString())  # WORD
    with pytest.raises(ValueError) as want:
        tokenizer_from_spm(str(path))
    with pytest.raises(ValueError) as got:
        port.tokenizer_from_spm(str(path))
    assert str(got.value) == str(want.value)


def test_chip_smoke_spm_writer_is_read_by_protobuf(tmp_path):
    """``chip_smoke.spm_model_bytes`` (the card's ``tokenizer.model``
    writer, no protobuf package there) parsed by ``google.protobuf``: every
    piece, score and type, the trainer and normalizer specs; and both
    readers build the same tokenizer from its bytes."""
    from transformers.convert_slow_tokenizer import import_protobuf

    from dynamo_tpu.llm.tokenizer import tokenizer_from_spm

    pieces = chip_smoke.synthetic_spm_pieces(2000, seed=3)
    data = chip_smoke.spm_model_bytes(pieces, model_type=2, unk_id=0)
    proto = import_protobuf().ModelProto()
    proto.ParseFromString(data)
    assert [(p.piece, p.score, int(p.type)) for p in proto.pieces] == [
        (p, np.float32(s), k) for p, s, k in pieces]
    assert (proto.trainer_spec.model_type, proto.trainer_spec.unk_id) == (2, 0)
    assert proto.normalizer_spec.name == "identity"
    assert proto.SerializeToString() == data
    assert port.read_spm_model(data) == ([(p, float(np.float32(s)), k)
                                          for p, s, k in pieces], 2, 0)
    path = tmp_path / "tokenizer.model"
    path.write_bytes(data)
    ref, tok = tokenizer_from_spm(str(path)), port.tokenizer_from_spm(str(path))
    text = chip_smoke._phi3_cli_text(pieces)
    ids = tok.encode(text, add_special_tokens=False)
    assert ids == ref.encode(text, add_special_tokens=False).ids
    assert tok.decode(ids) == ref.decode(ids) == text
    assert len(chip_smoke.synthetic_spm_pieces()) == chip_smoke.PHI3_SPM_PIECES


def test_bytes_to_unicode_and_chip_smoke_alphabet_agree():
    table = port.bytes_to_unicode()
    assert sorted(table) == list(range(256)) and len(set(table.values())) == 256
    assert chip_smoke._byte_level_alphabet() == [table[b] for b in range(256)]
    assert set(pre_tokenizers.ByteLevel.alphabet()) == set(table.values())
