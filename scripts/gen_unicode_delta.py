#!/usr/bin/env python3
"""Writes ``dynamo_tpu_torch/llm/unicode_delta.py``: the general category of
every code point whose category in the Oniguruma build inside the
``tokenizers`` package differs from this interpreter's ``unicodedata``
(code points assigned, or recategorised, by a later Unicode version).

The port's tokenizer builds its ``\\p{..}`` classes from ``unicodedata``
and completes them with this table, so its regexes match what
``tokenizers`` matches on a machine whose Python is older than the Unicode
version ``tokenizers`` was built with. Needs the ``tokenizers`` package;
run it from the repository root: ``python3 scripts/gen_unicode_delta.py``.
"""

import sys
import unicodedata
from pathlib import Path

from tokenizers import Regex, pre_tokenizers

GC = ("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No",
      "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So",
      "Zs", "Zl", "Zp", "Cc", "Cf", "Co")


def matching(pattern, chars):
    """The chars that ``pattern`` matches (a "removed" split keeps the
    others)."""
    split = pre_tokenizers.Split(Regex(pattern), behavior="removed")
    kept = set("".join(p for p, _ in split.pre_tokenize_str("".join(chars))))
    return [c for c in chars if c not in kept]


def main():
    by_cat = {}
    for cp in range(sys.maxunicode + 1):
        by_cat.setdefault(unicodedata.category(chr(cp)), []).append(chr(cp))
    by_cat.pop("Cs")  # surrogates never reach a tokenizer
    # per category, the code points Oniguruma does not put in it
    moved = [c for gc, chars in by_cat.items()
             for c in sorted(set(chars) - set(matching(r"\p{%s}" % gc, chars)))]
    delta = {}
    for gc in GC + ("Cn",):
        for c in matching(r"\p{%s}" % gc, moved):
            delta.setdefault(gc, []).append(ord(c))
    for cps in delta.values():
        cps.sort()
    lines = [
        '"""General categories of the code points whose category in the',
        "Oniguruma build of the ``tokenizers`` package differs from Python's",
        f"``unicodedata`` {unicodedata.unidata_version} (written by "
        "``scripts/gen_unicode_delta.py``;",
        'do not edit)."""', "",
        f'BASE_UNICODE_VERSION = "{unicodedata.unidata_version}"', "",
        "DELTA = {"]
    for gc, cps in sorted(delta.items()):
        ranges, lo = [], cps[0]
        for a, b in zip(cps, cps[1:] + [None]):
            if b != a + 1:
                ranges.append((lo, a))
                lo = b
        body = ", ".join(f"(0x{a:X}, 0x{b:X})" for a, b in ranges)
        lines.append(f'    "{gc}": [{body}],')
    lines.append("}")
    out = Path(__file__).resolve().parent.parent / "dynamo_tpu_torch/llm/unicode_delta.py"
    text = "\n".join(lines) + "\n"
    import textwrap
    wrapped = []
    for line in text.splitlines():
        if len(line) > 79 and line.startswith('    "'):
            head, body = line.split(": ", 1)
            wrapped.append(head + ": [")
            wrapped.extend(textwrap.wrap(body[1:-2], 72,
                                         initial_indent="        ",
                                         subsequent_indent="        "))
            wrapped.append("    ],")
        else:
            wrapped.append(line)
    out.write_text("\n".join(wrapped) + "\n")
    print(out, sum(len(v) for v in delta.values()), "code points")


if __name__ == "__main__":
    main()
