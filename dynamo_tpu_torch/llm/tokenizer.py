"""A pure-Python reader of HuggingFace ``tokenizer.json`` + incremental
detokenization.

The port's copy of ``dynamo_tpu/llm/tokenizer.py`` (``HFTokenizer``,
``DecodeStream``). The reference wraps the ``tokenizers`` package, which
the port does not depend on; ``Tokenizer`` below reads the same file
and computes what ``tokenizers`` computes, id for id and character for
character, for the forms the served families use:

- model: ``BPE`` (``byte_fallback``, ``ignore_merges``, ``fuse_unk``,
  ``unk_token``; merges as "a b" strings or pairs) and ``Unigram``
  (``unk_id``, ``byte_fallback``: the best-scoring segmentation, the
  SentencePiece-semantics tokenizers of GGUF files, ``spm_unigram_spec``);
- normalizers: ``NFC``, ``NFKC``, ``NFD``, ``NFKD``, ``Prepend``,
  ``Replace``, ``Sequence``;
- pre-tokenizers: ``ByteLevel`` (``add_prefix_space``, ``use_regex``),
  ``Split`` (a string or an Oniguruma regex, ``behavior``, ``invert``),
  ``Metaspace``, ``Digits``, ``Sequence``;
- decoders: ``ByteLevel``, ``Replace``, ``ByteFallback``, ``Fuse``,
  ``Strip``, ``Metaspace``, ``Sequence``;
- ``added_tokens`` (``special``, ``normalized``, ``lstrip``, ``rstrip``,
  ``single_word``), split out before pre-tokenization, the non-normalized
  ones on the raw text and the normalized ones on the normalized pieces;
- the ``TemplateProcessing`` post-processor (with ``ByteLevel`` and
  ``Sequence`` around it), for ``add_special_tokens=True`` only;
- a SentencePiece ``tokenizer.model`` (``tokenizer_from_spm``: its
  protobuf read by a wire-format decoder of its own, then the Unigram or
  BPE tokenizer the reference rebuilds from it).

Anything else raises ``NotImplementedError`` by name. Regexes are
Oniguruma's (the engine ``tokenizers`` runs): ``\\p{..}``, ``\\P{..}``,
``\\s``, ``\\S``, ``\\d`` and ``\\D`` become explicit character classes
built once from ``unicodedata``'s general categories, corrected by
``unicode_delta`` for the code points assigned or recategorised after the
Unicode version of this interpreter's ``unicodedata`` (``\\s`` is Oniguruma's: tab to CR,
NEL and the Z categories, not Python's, which adds U+001C-U+001F).
Possessive quantifiers and atomic groups need Python 3.11.
"""

from __future__ import annotations

import bisect
import functools
import heapq
import json
import os
import re
import sys
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

REPLACEMENT_CHAR = "�"


# ------------------------------------------------------------ unicode classes

_GC = ("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No",
       "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So",
       "Zs", "Zl", "Zp", "Cc", "Cf", "Cs", "Co", "Cn")
_LONG = {
    "Letter": "L", "Cased_Letter": "LC", "Uppercase_Letter": "Lu",
    "Lowercase_Letter": "Ll", "Titlecase_Letter": "Lt",
    "Modifier_Letter": "Lm", "Other_Letter": "Lo", "Mark": "M",
    "Combining_Mark": "M", "Nonspacing_Mark": "Mn", "Spacing_Mark": "Mc",
    "Enclosing_Mark": "Me", "Number": "N", "Decimal_Number": "Nd",
    "Letter_Number": "Nl", "Other_Number": "No", "Punctuation": "P",
    "Connector_Punctuation": "Pc", "Dash_Punctuation": "Pd",
    "Open_Punctuation": "Ps", "Close_Punctuation": "Pe",
    "Initial_Punctuation": "Pi", "Final_Punctuation": "Pf",
    "Other_Punctuation": "Po", "Symbol": "S", "Math_Symbol": "Sm",
    "Currency_Symbol": "Sc", "Modifier_Symbol": "Sk", "Other_Symbol": "So",
    "Separator": "Z", "Space_Separator": "Zs", "Line_Separator": "Zl",
    "Paragraph_Separator": "Zp", "Other": "C", "Control": "Cc",
    "Format": "Cf", "Surrogate": "Cs", "Private_Use": "Co",
    "Unassigned": "Cn",
}


@functools.lru_cache(maxsize=None)
def _category_table() -> Dict[str, List[Tuple[int, int]]]:
    """Two-letter general category → sorted code-point ranges, from this
    interpreter's ``unicodedata`` with ``unicode_delta``'s corrections (the
    categories of the Unicode version ``tokenizers`` was built with)."""
    from .unicode_delta import DELTA

    cats = [unicodedata.category(chr(cp)) for cp in range(sys.maxunicode + 1)]
    for gc, ranges in DELTA.items():
        for lo, hi in ranges:
            for cp in range(lo, hi + 1):
                cats[cp] = gc
    table: Dict[str, List[Tuple[int, int]]] = {gc: [] for gc in _GC}
    start = 0
    for cp in range(1, len(cats) + 1):
        if cp == len(cats) or cats[cp] != cats[start]:
            table[cats[start]].append((start, cp - 1))
            start = cp
    return table


def _merge(ranges: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _complement(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out, nxt = [], 0
    for lo, hi in ranges:
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= sys.maxunicode:
        out.append((nxt, sys.maxunicode))
    return out


_WHITESPACE = [(0x09, 0x0D), (0x85, 0x85)]


@functools.lru_cache(maxsize=None)
def property_ranges(name: str) -> Tuple[Tuple[int, int], ...]:
    """Code-point ranges of an Oniguruma property: a general category in
    its short or long name (``L``, ``Lu``, ``LC``, ``Letter``, ...), or the
    ``\\s`` and ``\\d`` classes as ``space`` and ``digit``."""
    table = _category_table()
    if name == "space":
        return tuple(_merge(_WHITESPACE + table["Zs"] + table["Zl"]
                            + table["Zp"]))
    if name == "digit":
        return tuple(table["Nd"])
    short = _LONG.get(name, name)
    if short in ("LC", "L&"):
        gcs = ["Lu", "Ll", "Lt"]
    elif short in table:
        gcs = [short]
    elif len(short) == 1 and any(g[0] == short for g in _GC):
        gcs = [g for g in _GC if g[0] == short]
    else:
        raise NotImplementedError(
            f"regex property \\p{{{name}}} is not supported by the port's "
            "tokenizer (general categories only)")
    return tuple(_merge(r for g in gcs for r in table[g]))


def _class_body(ranges: Iterable[Tuple[int, int]]) -> str:
    parts = []
    for lo, hi in ranges:
        parts.append(f"\\U{lo:08x}" if lo == hi
                     else f"\\U{lo:08x}-\\U{hi:08x}")
    return "".join(parts)


_UNSUPPORTED_ESCAPES = set("wWbBhHXRKGzyYO")


@functools.lru_cache(maxsize=None)
def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern (``tokenizers``' ``Regex``) as a Python ``re``
    pattern with the same matches: property and space classes expanded to
    explicit ranges, inside a bracket class and outside it."""
    out: List[str] = []
    i, n = 0, len(pattern)
    in_class = class_start = False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP" and i + 2 < n and pattern[i + 2] == "{":
                j = pattern.index("}", i + 3)
                name = pattern[i + 3:j]
                neg = e == "P"
                if name.startswith("^"):
                    name, neg = name[1:], not neg
                ranges = list(property_ranges(name))
                i = j + 1
            elif e in "sSdD":
                ranges = list(property_ranges("space" if e in "sS" else "digit"))
                neg = e in "SD"
                i += 2
            elif e in _UNSUPPORTED_ESCAPES:
                raise NotImplementedError(
                    f"regex escape \\{e} is not supported by the port's "
                    f"tokenizer: {pattern!r}")
            else:
                class_start = False
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                class_start = False
                out.append(_class_body(_complement(ranges) if neg else ranges))
            else:
                out.append(("[^" if neg else "[") + _class_body(ranges) + "]")
            continue
        if in_class:
            if c == "[" or pattern.startswith("&&", i):
                raise NotImplementedError(
                    f"nested or intersected character classes are not "
                    f"supported by the port's tokenizer: {pattern!r}")
            if c == "]" and not class_start:
                in_class = False
            class_start = False
            out.append(c)
            i += 1
            continue
        if c == "[":
            in_class, class_start = True, True
            out.append(c)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=None)
def compile_pattern(spec: Tuple[str, str]) -> "re.Pattern":
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern of tokenizer.json,
    given as (kind, text)."""
    kind, text = spec
    if kind == "String":
        return re.compile(re.escape(text))
    if kind == "Regex":
        return re.compile(translate_pattern(text))
    raise NotImplementedError(f"tokenizer pattern kind {kind!r}")


def _pattern_spec(p: dict) -> Tuple[str, str]:
    if not isinstance(p, dict) or len(p) != 1:
        raise NotImplementedError(f"tokenizer pattern {p!r}")
    (kind, text), = p.items()
    return kind, text


# ------------------------------------------------------------- byte level

@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte → printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=None)
def unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                r"|\s+(?!\S)|\s+")


# --------------------------------------------------------------- splitting

def _find_matches(regex: "re.Pattern", s: str, invert: bool = False):
    """(start, end, is_match) spans covering ``s`` (tokenizers'
    ``Pattern::find_matches``)."""
    if not s:
        return [(0, 0, False)]
    spans, prev = [], 0
    for m in regex.finditer(s):
        a, b = m.span()
        if a == b:
            continue
        if prev != a:
            spans.append((prev, a, False))
        spans.append((a, b, True))
        prev = b
    if prev != len(s):
        spans.append((prev, len(s), False))
    if invert:
        spans = [(a, b, not m) for a, b, m in spans]
    return spans


def _char_matches(pred, s: str):
    spans, last = [], 0
    for i, ch in enumerate(s):
        if pred(ch):
            if last < i:
                spans.append((last, i, False))
            spans.append((i, i + 1, True))
            last = i + 1
    if last < len(s):
        spans.append((last, len(s), False))
    return spans


def _apply_behavior(spans, behavior: str) -> List[Tuple[int, int]]:
    """tokenizers' ``SplitDelimiterBehavior`` over find_matches spans."""
    b = behavior.lower()
    out: List[List[int]] = []
    if b == "removed":
        out = [[a, e] for a, e, m in spans if not m]
    elif b == "isolated":
        out = [[a, e] for a, e, _ in spans]
    elif b == "mergedwithprevious" or b == "merged_with_previous":
        prev = False
        for a, e, m in spans:
            if m and not prev and out:
                out[-1][1] = e
            else:
                out.append([a, e])
            prev = m
    elif b == "mergedwithnext" or b == "merged_with_next":
        prev = False
        for a, e, m in reversed(spans):
            if m and not prev and out:
                out[-1][0] = a
            else:
                out.append([a, e])
            prev = m
        out.reverse()
    elif b == "contiguous":
        prev = False
        for a, e, m in spans:
            if m == prev and out:
                out[-1][1] = e
            else:
                out.append([a, e])
            prev = m
    else:
        raise NotImplementedError(f"split behavior {behavior!r}")
    return [(a, e) for a, e in out if a != e]


class _Piece:
    """A span of the text being encoded: its (normalized) text, whether it
    starts at the original text's offset 0, and its token id once it is an
    added token."""

    __slots__ = ("text", "at_start", "token_id")

    def __init__(self, text: str, at_start: bool, token_id=None):
        self.text, self.at_start, self.token_id = text, at_start, token_id


def _split(pieces: List[_Piece], fn) -> List[_Piece]:
    """Replace each not-yet-tokenized piece by ``fn(piece)``'s pieces."""
    out = []
    for p in pieces:
        if p.token_id is not None:
            out.append(p)
        elif p.text:
            out.extend(q for q in fn(p) if q.text or q.token_id is not None)
    return out


def _sub(p: _Piece, spans) -> List[_Piece]:
    return [_Piece(p.text[a:e], p.at_start and a == 0) for a, e in spans]


# -------------------------------------------------------------- normalizers

def _normalizer(spec: Optional[dict]):
    """tokenizer.json normalizer → str → str."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind in ("NFC", "NFKC", "NFD", "NFKD"):
        return functools.partial(unicodedata.normalize, kind)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        rx = compile_pattern(_pattern_spec(spec["pattern"]))
        content = spec["content"]
        return lambda s: rx.sub(lambda _m: content, s)
    if kind == "Sequence":
        fns = [_normalizer(n) for n in spec["normalizers"]]

        def seq(s):
            for f in fns:
                s = f(s)
            return s
        return seq
    raise NotImplementedError(f"tokenizer normalizer {kind!r} is not supported "
                              "by the port's tokenizer")


# ----------------------------------------------------------- pre-tokenizers

def _pre_tokenizer(spec: Optional[dict]):
    """tokenizer.json pre_tokenizer → (list of pieces → list of pieces)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        fns = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces):
            for f in fns:
                pieces = f(pieces)
            return pieces
        return seq
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space", True))
        rx = (compile_pattern(("Regex", GPT2_PATTERN))
              if spec.get("use_regex", True) else None)
        table = bytes_to_unicode()

        def byte_level(p: _Piece):
            text = p.text
            if prefix and not text.startswith(" "):
                text = " " + text
            spans = (_apply_behavior(_find_matches(rx, text), "isolated")
                     if rx is not None else [(0, len(text))])
            return [_Piece("".join(table[b] for b in text[a:e].encode()),
                           p.at_start and a == 0) for a, e in spans]
        return lambda pieces: _split(pieces, byte_level)
    if kind == "Split":
        rx = compile_pattern(_pattern_spec(spec["pattern"]))
        behavior, invert = spec["behavior"], bool(spec.get("invert", False))
        return lambda pieces: _split(pieces, lambda p: _sub(p, _apply_behavior(
            _find_matches(rx, p.text, invert), behavior)))
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        do_split = spec.get("split", True)

        def metaspace(p: _Piece):
            text = p.text.replace(" ", rep)
            if not text.startswith(rep) and (
                    scheme == "always" or (scheme == "first" and p.at_start)):
                text = rep + text
            q = _Piece(text, p.at_start)
            if not do_split:
                return [q]
            return _sub(q, _apply_behavior(
                _char_matches(lambda c: c == rep, text), "merged_with_next"))
        return lambda pieces: _split(pieces, metaspace)
    if kind == "Digits":
        table = _category_table()
        numeric = set()
        for gc in ("Nd", "Nl", "No"):
            for lo, hi in table[gc]:
                numeric.update(map(chr, range(lo, hi + 1)))
        behavior = "isolated" if spec.get("individual_digits") else "contiguous"
        return lambda pieces: _split(pieces, lambda p: _sub(p, _apply_behavior(
            _char_matches(numeric.__contains__, p.text), behavior)))
    raise NotImplementedError(f"tokenizer pre_tokenizer {kind!r} is not "
                              "supported by the port's tokenizer")


# ---------------------------------------------------------------- decoders

def _decoder(spec: Optional[dict]):
    """tokenizer.json decoder → (list of token strings → list of strings)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        fns = [_decoder(d) for d in spec["decoders"]]

        def seq(tokens):
            for f in fns:
                tokens = f(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        table = unicode_to_bytes()

        def byte_level(tokens):
            out = bytearray()
            for t in tokens:
                try:
                    out += bytes(table[c] for c in t)
                except KeyError:
                    out += t.encode()
            return [out.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Replace":
        rx = compile_pattern(_pattern_spec(spec["pattern"]))
        content = spec["content"]
        return lambda tokens: [rx.sub(lambda _m: content, t) for t in tokens]
    if kind == "ByteFallback":
        def byte_fallback(tokens):
            out, pending = [], bytearray()

            def flush():
                if pending:
                    try:
                        out.append(pending.decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend([REPLACEMENT_CHAR] * len(pending))
                    pending.clear()
            for t in tokens:
                byte = None
                if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                    try:
                        byte = int(t[3:5], 16)
                    except ValueError:
                        byte = None
                if byte is not None:
                    pending.append(byte)
                else:
                    flush()
                    out.append(t)
            flush()
            return out
        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens):
            out = []
            for t in tokens:
                a, e = 0, len(t)
                for _ in range(start):
                    if a < e and t[a] == content:
                        a += 1
                    else:
                        break
                for _ in range(stop):
                    if e > a and t[e - 1] == content:
                        e -= 1
                    else:
                        break
                out.append(t[a:e])
            return out
        return strip
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        strip_first = scheme != "never"

        def metaspace(tokens):
            return ["".join(("" if i == 0 and strip_first else " ")
                            if c == rep else c for c in t)
                    for i, t in enumerate(tokens)]
        return metaspace
    raise NotImplementedError(f"tokenizer decoder {kind!r} is not supported "
                              "by the port's tokenizer")


# --------------------------------------------------------------------- BPE

class BPE:
    """tokenizers' BPE model: per-character symbols (byte fallback, fused
    unknowns), then merges by rank, the leftmost first among equal ranks."""

    def __init__(self, spec: dict):
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise NotImplementedError(
                    f"BPE {key}={spec[key]!r} is not supported by the port's "
                    "tokenizer")
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.vocab_r: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            ia, ib, inew = (self.vocab.get(a), self.vocab.get(b),
                            self.vocab.get(a + b))
            if ia is None or ib is None or inew is None:
                raise ValueError(f"BPE merge {a!r} + {b!r} names a token "
                                 "outside the vocabulary")
            self.merges.setdefault((ia, ib), (rank, inew))
        self._cache: Dict[str, List[int]] = {}

    def _symbols(self, word: str) -> List[int]:
        ids: List[int] = []
        unk = None  # (id, fused)
        unk_id = (self.vocab.get(self.unk_token)
                  if self.unk_token is not None else None)
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(tid)
                continue
            if self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode()]
                if all(b is not None for b in byte_ids):
                    ids.extend(byte_ids)
                    continue
            if self.unk_token is not None:
                if unk_id is None:
                    raise ValueError(f"unk_token {self.unk_token!r} is not in "
                                     "the vocabulary")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = unk_id
        if unk is not None:
            ids.append(unk)
        return ids

    def _merge_all(self, sym: List[int]) -> List[int]:
        n = len(sym)
        if n < 2 or not self.merges:
            return sym
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prv[nxt[right]] = pos
            p = prv[pos]
            if p >= 0:
                m = self.merges.get((sym[p], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            q = nxt[pos]
            if q != -1:
                m = self.merges.get((new_id, sym[q]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]

    def tokenize(self, word: str) -> List[int]:
        if self.ignore_merges:
            tid = self.vocab.get(word)
            if tid is not None:
                return [tid]
        hit = self._cache.get(word)
        if hit is None:
            hit = self._merge_all(self._symbols(word))
            if len(self._cache) < 100_000:
                self._cache[word] = hit
        return list(hit)


# ----------------------------------------------------------------- Unigram

class Unigram:
    """tokenizers' Unigram model (its ``encode_optimized``): the
    segmentation of highest total score over the pieces (Viterbi; ties keep
    the first path found, shorter pieces first), a character no
    one-character piece covers taking the unknown id at the lowest score
    less 10; consecutive unknowns fused into one piece; a piece outside the
    vocabulary becomes its ``<0xXX>`` byte pieces (``byte_fallback``) or
    the unknown id."""

    K_UNK_PENALTY = 10.0

    def __init__(self, spec: dict):
        pieces = spec.get("vocab") or []
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.scores = [float(sc) for _, sc in pieces]
        self.vocab: Dict[str, int] = {}
        for i, (piece, _) in enumerate(pieces):
            self.vocab[piece] = i      # a repeated piece: its last id
        self.vocab_r: Dict[int, str] = {i: p for i, (p, _) in enumerate(pieces)}
        self.min_score = min(self.scores, default=float("inf"))
        self.max_len = max((len(p) for p in self.vocab), default=1)
        self._cache: Dict[str, List[int]] = {}

    def _segment(self, text: str) -> List[str]:
        n = len(text)
        unk_score = self.min_score - self.K_UNK_PENALTY
        score = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        node = [0] * (n + 1)
        for i in range(n):
            here = score[i]
            single = False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                tid = self.vocab.get(text[i:j])
                if tid is None:
                    continue
                cand = self.scores[tid] + here
                if start[j] is None or cand > score[j]:
                    score[j], start[j], node[j] = cand, i, tid
                if j == i + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram model has no unk_id for a "
                                     f"character outside it: {text[i]!r}")
                cand = unk_score + here
                if start[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start[i + 1], node[i + 1] = cand, i, self.unk_id
        out: List[str] = []
        fused: List[str] = []
        end = n
        while end > 0:
            begin = start[end]
            if self.unk_id is not None and node[end] == self.unk_id:
                fused.append(text[begin:end])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(text[begin:end])
            end = begin
        if fused:
            out.append("".join(reversed(fused)))
        return out[::-1]

    def tokenize(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return list(hit)
        ids: List[int] = []
        for piece in self._segment(word):
            tid = self.vocab.get(piece)
            if tid is None and self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in piece.encode()]
                if all(b is not None for b in byte_ids):
                    ids.extend(byte_ids)
                    continue
            if tid is None:
                if self.unk_id is None:
                    raise ValueError(f"piece {piece!r} is outside the Unigram "
                                     "vocabulary and there is no unk_id")
                tid = self.unk_id
            ids.append(tid)
        if len(self._cache) < 100_000:
            self._cache[word] = ids
        return list(ids)


# SentencePiece piece types (sentencepiece.proto; GGUF's token_type reuses
# them): NORMAL (also a piece's type when the field is absent), and the
# ones the tokenizer treats apart from normal pieces
SPM_NORMAL, SPM_UNKNOWN, SPM_CONTROL, SPM_USER_DEFINED = 1, 2, 3, 4


def spm_added_tokens(tokens, types) -> List[dict]:
    """``added_tokens`` entries for a SentencePiece-typed vocabulary (the
    reference's ``add_spm_added_tokens``): CONTROL pieces special,
    USER_DEFINED pieces matched whole and visible in decode, neither
    normalized; each keeps its vocabulary id (a repeated piece its last)."""
    ids = {t: i for i, t in enumerate(tokens)}
    out, seen = [], set()
    for kind, special in ((SPM_CONTROL, True), (SPM_USER_DEFINED, False)):
        for i, t in enumerate(types):
            if t == kind and tokens[i] not in seen:
                seen.add(tokens[i])
                out.append(dict(id=ids[tokens[i]], content=tokens[i],
                                single_word=False, lstrip=False, rstrip=False,
                                normalized=False, special=special))
    return out


def spm_unigram_spec(tokens, scores, types, unk_id=None) -> dict:
    """The ``tokenizer.json`` of a SentencePiece-semantics Unigram tokenizer
    (the reference's ``build_unigram_tokenizer``): the ▁ whitespace
    convention (``_spm_surface``), byte fallback, and the SPM added
    tokens."""
    if unk_id is None:
        unk_id = next((i for i, t in enumerate(types) if t == SPM_UNKNOWN), 0)
    return dict(_spm_surface(tokens, types), model={
        "type": "Unigram", "unk_id": int(unk_id),
        "vocab": [[t, float(sc)] for t, sc in zip(tokens, scores)],
        "byte_fallback": True})


def spm_bpe_spec(tokens, types, unk_id=None) -> dict:
    """The ``tokenizer.json`` of a SentencePiece BPE model (``model_type``
    2; the reference's ``_build_spm_bpe_tokenizer``): byte fallback, fused
    unknowns, the ▁ surface and the SPM added tokens. SentencePiece keeps
    no merges, only the pieces ranked by id, so they are recovered as the
    reference does: every split of a NORMAL piece whose two halves are both
    pieces, ordered by the merged piece's id, then within a piece by the
    id of its later half."""
    vocab = {t: i for i, t in enumerate(tokens)}
    merges = []
    for piece, piece_id in vocab.items():
        if len(piece) < 2 or types[piece_id] != SPM_NORMAL:
            continue
        local = [(piece[:i], piece[i:]) for i in range(1, len(piece))
                 if piece[:i] in vocab and piece[i:] in vocab]
        local.sort(key=lambda ab: max(vocab[ab[0]], vocab[ab[1]]))
        merges.extend(((piece_id, j), ab) for j, ab in enumerate(local))
    if unk_id is None:
        unk_id = next((i for i, t in enumerate(types) if t == SPM_UNKNOWN), 0)
    return dict(_spm_surface(tokens, types), model={
        "type": "BPE", "vocab": vocab,
        "merges": [list(ab) for _, ab in sorted(merges)],
        "unk_token": tokens[int(unk_id)], "fuse_unk": True,
        "byte_fallback": True})


def _spm_surface(tokens, types) -> dict:
    """The SentencePiece surface of a ``tokenizer.json`` (the reference's
    ``_set_spm_surface``): prepend ▁ and spaces to ▁ on the way in; on the
    way out ▁ to a space, byte fallback, fuse, one leading space stripped;
    and the SPM added tokens."""
    return {
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "added_tokens": spm_added_tokens(tokens, types),
    }


# ------------------------------------------------- SentencePiece protobuf

class SpmModelError(ValueError):
    """A ``tokenizer.model`` that is not a readable SentencePiece
    ``ModelProto``."""


def _varint(buf: bytes, at: int) -> Tuple[int, int]:
    """(value, next offset) of the base-128 varint at ``at``."""
    out = shift = 0
    while True:
        if at >= len(buf) or shift > 63:
            raise SpmModelError(f"truncated varint at byte {at}")
        b = buf[at]
        at += 1
        out |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            return out, at


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of a message: an int
    for a varint (0), bytes for a fixed64 (1), a length-delimited field (2)
    or a fixed32 (5). Groups and unknown wire types raise."""
    at = 0
    while at < len(buf):
        key, at = _varint(buf, at)
        field, wire = key >> 3, key & 7
        if field == 0:
            raise SpmModelError(f"field number 0 at byte {at}")
        if wire == 0:
            value, at = _varint(buf, at)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            if at + n > len(buf):
                raise SpmModelError(f"truncated fixed field {field}")
            value, at = buf[at:at + n], at + n
        elif wire == 2:
            n, at = _varint(buf, at)
            if at + n > len(buf):
                raise SpmModelError(f"field {field} runs past the end "
                                    f"({n} bytes at byte {at})")
            value, at = buf[at:at + n], at + n
        else:
            raise SpmModelError(f"wire type {wire} (field {field}) is not "
                                "used by sentencepiece_model.proto")
        yield field, wire, value


def _int32(v: int) -> int:
    """A varint read as protobuf's int32 / enum (negatives take 10 bytes)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def read_spm_model(data: bytes):
    """A SentencePiece ``ModelProto`` from its wire format: (pieces as
    (piece, score, type) triples, the trainer spec's ``model_type`` and
    ``unk_id``, each None without a ``trainer_spec``). Read: ``pieces``
    (field 1: ``piece`` 1, ``score`` 2 as a fixed32 float, ``type`` 3) and
    ``trainer_spec`` (field 2: ``model_type`` 3, ``unk_id`` 40, defaults
    UNIGRAM and 0); every other field is skipped by its wire type."""
    import struct

    pieces, model_type, unk_id = [], None, None
    for field, wire, value in _fields(data):
        if field == 1 and wire == 2:
            piece, score, kind = "", 0.0, SPM_NORMAL
            for f, w, v in _fields(value):
                if f == 1 and w == 2:
                    try:
                        piece = v.decode("utf-8")
                    except UnicodeDecodeError as e:
                        raise SpmModelError(f"piece {len(pieces)}: {e}") from e
                elif f == 2 and w == 5:
                    score = struct.unpack("<f", v)[0]
                elif f == 3 and w == 0:
                    kind = _int32(v)
            pieces.append((piece, score, kind))
        elif field == 2 and wire == 2:
            model_type, unk_id = 1, 0
            for f, w, v in _fields(value):
                if f == 3 and w == 0:
                    model_type = _int32(v)
                elif f == 40 and w == 0:
                    unk_id = _int32(v)
    if not pieces:
        raise SpmModelError("no pieces")
    return pieces, model_type, unk_id


def tokenizer_from_spm(path: str) -> "Tokenizer":
    """The tokenizer of a SentencePiece ``tokenizer.model`` (the reference's
    ``tokenizer_from_spm``, which reads the protobuf through transformers'
    schema; here ``read_spm_model``): ``model_type`` 1 (Unigram, also
    without a trainer spec) through ``spm_unigram_spec``, 2 (BPE) through
    ``spm_bpe_spec``; any other type raises with the reference's words, and
    a file that is no ``ModelProto`` raises ``SpmModelError`` naming it."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        pieces, model_type, unk_id = read_spm_model(data)
    except SpmModelError as e:
        raise SpmModelError(f"{path} is not a SentencePiece model: {e}") from e
    tokens = [p for p, _, _ in pieces]
    scores = [s for _, s, _ in pieces]
    types = [t for _, _, t in pieces]
    model_type = 1 if model_type is None else model_type
    if model_type == 2:
        return Tokenizer(spm_bpe_spec(tokens, types, unk_id))
    if model_type != 1:
        raise ValueError(
            f"unsupported SentencePiece model_type {model_type} in {path} "
            "(supported: 1=unigram, 2=bpe)"
        )
    return Tokenizer(spm_unigram_spec(tokens, scores, types, unk_id))


# --------------------------------------------------------------- tokenizer

# Other_Alphabetic code points outside the letter, mark and Nl categories
# (the circled and squared Latin letters) and Join_Control (ZWNJ, ZWJ)
_WORD_EXTRA = ((0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149),
               (0x1F150, 0x1F169), (0x1F170, 0x1F189))


@functools.lru_cache(maxsize=None)
def _word_ranges() -> Tuple[List[int], List[int]]:
    """(starts, ends) of the code points of Rust's Unicode ``\\w``, which
    ``tokenizers`` tests at a ``single_word`` added token's edges:
    Alphabetic (letters, Nl, Other_Alphabetic), every mark, Nd, Pc and
    Join_Control."""
    ranges = _merge([r for name in ("L", "M", "Nd", "Nl", "Pc")
                     for r in property_ranges(name)] + list(_WORD_EXTRA))
    return [lo for lo, _ in ranges], [hi for _, hi in ranges]


def _is_word_char(c: str) -> bool:
    starts, ends = _word_ranges()
    i = bisect.bisect_right(starts, ord(c)) - 1
    return i >= 0 and ord(c) <= ends[i]


class Tokenizer:
    """``tokenizers.Tokenizer`` for the forms listed in the module doc."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        kind = model.get("type", "BPE" if "merges" in model else None)
        if kind not in ("BPE", "Unigram"):
            raise NotImplementedError(
                f"tokenizer model {kind!r} is not supported by the port's "
                "tokenizer (BPE and Unigram; WordPiece is still to port)")
        if spec.get("truncation") or spec.get("padding"):
            raise NotImplementedError(
                "tokenizer.json truncation / padding is not supported by the "
                "port's tokenizer")
        self.model = BPE(model) if kind == "BPE" else Unigram(model)
        self.normalizer = _normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.decoder = _decoder(spec.get("decoder"))
        self.post_processor = spec.get("post_processor")
        self.added: Dict[str, dict] = {}
        self.added_r: Dict[int, str] = {}
        self.special: set = set()
        for t in spec.get("added_tokens") or []:
            self.added[t["content"]] = t
            self.added_r[int(t["id"])] = t["content"]
            if t.get("special"):
                self.special.add(t["content"])
        self._raw_rx = self._added_regex(
            [t["content"] for t in self.added.values() if not t.get("normalized")])
        normalized = {}
        for t in self.added.values():
            if t.get("normalized"):
                key = (self.normalizer(t["content"]) if self.normalizer
                       else t["content"])
                normalized.setdefault(key, t)
        self._norm_added = normalized
        self._norm_rx = self._added_regex(list(normalized))

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    @classmethod
    def from_str(cls, text: str) -> "Tokenizer":
        return cls(json.loads(text))

    @staticmethod
    def _added_regex(contents: List[str]):
        """Leftmost-longest matching of the added tokens (tokenizers'
        Aho-Corasick): an alternation, longest first."""
        contents = [c for c in contents if c]
        if not contents:
            return None
        contents.sort(key=len, reverse=True)
        return re.compile("|".join(map(re.escape, contents)))

    def _split_added(self, piece: _Piece, rx, lookup) -> List[_Piece]:
        """tokenizers' ``AddedVocabulary::find_matches`` over one piece."""
        s = piece.text
        if rx is None or not s:
            return [piece]
        out, start_off = [], 0
        for m in rx.finditer(s):
            a, e = m.span()
            tok = lookup[m.group()]
            if tok.get("single_word"):
                before = a == 0 or not _is_word_char(s[a - 1])
                after = e == len(s) or not _is_word_char(s[e])
                if not (before and after):
                    continue
            if tok.get("lstrip"):
                k = a
                while k > 0 and s[k - 1] in _WHITE_SPACE:
                    k -= 1
                a = max(k, start_off)
            if tok.get("rstrip"):
                while e < len(s) and s[e] in _WHITE_SPACE:
                    e += 1
            if a < start_off:
                continue
            if start_off < a:
                out.append(_Piece(s[start_off:a], piece.at_start and start_off == 0))
            out.append(_Piece(s[a:e], piece.at_start and a == 0, int(tok["id"])))
            start_off = e
        if start_off < len(s):
            out.append(_Piece(s[start_off:], piece.at_start and start_off == 0))
        return out

    def _normalize_piece(self, p: _Piece) -> List[_Piece]:
        if self.normalizer is not None:
            p = _Piece(self.normalizer(p.text), p.at_start)
        return self._split_added(p, self._norm_rx, self._norm_added)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        pieces = self._split_added(_Piece(text, True), self._raw_rx, self.added)
        pieces = _split(pieces, self._normalize_piece)
        if self.pre_tokenizer is not None:
            pieces = self.pre_tokenizer(pieces)
        ids: List[int] = []
        for p in pieces:
            if p.token_id is not None:
                ids.append(p.token_id)
            elif p.text:
                ids.extend(self.model.tokenize(p.text))
        return self._post_process(ids, add_special_tokens)

    def _post_process(self, ids: List[int], add_special: bool) -> List[int]:
        pp = self.post_processor
        if pp is None or not add_special:
            return ids
        kind = pp.get("type")
        if kind == "Sequence":
            templates = [p for p in pp["processors"] if p.get("type") != "ByteLevel"]
            others = [p.get("type") for p in templates
                      if p.get("type") != "TemplateProcessing"]
            if others or len(templates) > 1:
                raise NotImplementedError(
                    f"post_processor {others or 'Sequence'} is not supported "
                    "by the port's tokenizer")
            if not templates:
                return ids
            pp = templates[0]
            kind = "TemplateProcessing"
        if kind == "ByteLevel":
            return ids
        if kind != "TemplateProcessing":
            raise NotImplementedError(
                f"post_processor {kind!r} is not supported by the port's "
                "tokenizer (add_special_tokens=True)")
        out: List[int] = []
        for item in pp["single"]:
            if "Sequence" in item:
                out.extend(ids)
            else:
                out.extend(pp["special_tokens"][item["SpecialToken"]["id"]]["ids"])
        return out

    def id_to_token(self, token_id: int) -> Optional[str]:
        tok = self.added_r.get(int(token_id))
        return tok if tok is not None else self.model.vocab_r.get(int(token_id))

    def token_to_id(self, token: str) -> Optional[int]:
        t = self.added.get(token)
        return int(t["id"]) if t is not None else self.model.vocab.get(token)

    def get_vocab_size(self) -> int:
        """Ids of the vocabulary and the added tokens together."""
        return len(set(self.model.vocab.values()) | set(self.added_r))

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self.id_to_token(i)
            if tok is None or (skip_special_tokens and tok in self.special
                               and int(i) in self.added_r):
                continue
            tokens.append(tok)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))


# Unicode White_Space (Rust's char::is_whitespace: the lstrip / rstrip of an
# added token)
_WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(map(chr, range(0x2000, 0x200B))))


# ----------------------------------------------------- the framework surface

class HFTokenizer:
    """The framework surface over ``Tokenizer`` (the reference's
    ``HFTokenizer`` wraps ``tokenizers.Tokenizer`` with the same methods)."""

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer

    @classmethod
    def from_file(cls, path: str) -> "HFTokenizer":
        return cls(Tokenizer.from_file(path))

    @classmethod
    def from_pretrained_dir(cls, model_dir: str) -> "HFTokenizer":
        path = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(path):
            return cls.from_file(path)
        spm = os.path.join(model_dir, "tokenizer.model")
        if os.path.exists(spm):
            # SentencePiece-only snapshots (original Llama / Mistral exports)
            return cls(tokenizer_from_spm(spm))
        raise FileNotFoundError(
            f"no tokenizer.json or tokenizer.model under {model_dir}"
        )

    @classmethod
    def from_model_path(cls, model_path: str) -> "HFTokenizer":
        """An HF snapshot dir (tokenizer.json) or a .gguf file (its
        vocabulary rebuilt from the GGUF metadata, ``llm/gguf.py``)."""
        if model_path.endswith(".gguf"):
            from .gguf import read_gguf, tokenizer_from_gguf

            return cls(tokenizer_from_gguf(read_gguf(model_path)))
        return cls.from_pretrained_dir(model_path)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def id_to_token(self, token_id: int) -> Optional[str]:
        return self._tok.id_to_token(token_id)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens)


class DecodeStream:
    """Incremental detokenizer: feed ids one at a time, get text deltas.

    Keeps ``prefix_offset``/``read_offset`` into the id history; each step
    decodes ``ids[prefix:]`` and emits the stable suffix beyond the last
    emitted text. Returns None while the tail is an incomplete UTF-8
    sequence (e.g. the first half of a multi-token emoji).
    """

    def __init__(self, tokenizer: HFTokenizer, skip_special_tokens: bool = True):
        self.tokenizer = tokenizer
        self.skip_special_tokens = skip_special_tokens
        self.ids: List[int] = []
        self.prefix_offset = 0
        self.read_offset = 0

    def step(self, token_id: int) -> Optional[str]:
        self.ids.append(int(token_id))
        prefix_text = self.tokenizer.decode(
            self.ids[self.prefix_offset : self.read_offset], self.skip_special_tokens
        )
        new_text = self.tokenizer.decode(
            self.ids[self.prefix_offset :], self.skip_special_tokens
        )
        if new_text.endswith(REPLACEMENT_CHAR):
            # incomplete multi-byte sequence — wait for more tokens
            return None
        if len(new_text) <= len(prefix_text):
            return None
        delta = new_text[len(prefix_text) :]
        self.prefix_offset = self.read_offset
        self.read_offset = len(self.ids)
        return delta
