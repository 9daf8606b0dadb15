"""Mini Prometheus text-format parser.

The port's copy of ``dynamo_tpu/telemetry/exposition.py``.

Just enough of the exposition grammar to validate our own /metrics
output (the telemetry tests) and to let tooling diff scrapes (the fleet
hub and the local history sampler read every exposition through it):
``# TYPE``/``# HELP`` headers, samples with escaped label values, and
histogram family suffixes. Not a general scraper — one metric per line,
no exemplars, no OpenMetrics extensions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Sample:
    name: str
    labels: Dict[str, str]
    value: float


@dataclasses.dataclass
class MetricFamily:
    name: str
    type: str = "untyped"
    help: Optional[str] = None
    samples: List[Sample] = dataclasses.field(default_factory=list)


def _unescape(value: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ("\\", '"'):
                out.append(nxt)
            else:
                out.append(c)
                out.append(nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(body: str) -> Dict[str, str]:
    """``a="x",b="y"`` → dict, honoring escapes inside quoted values."""
    labels: Dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        key = body[i:eq].strip().lstrip(",").strip()
        if body[eq + 1] != '"':
            raise ValueError(f"unquoted label value at {body[eq:]!r}")
        j = eq + 2
        raw: List[str] = []
        while True:
            if j >= len(body):
                raise ValueError(f"unterminated label value in {body!r}")
            c = body[j]
            if c == "\\":
                raw.append(body[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            raw.append(c)
            j += 1
        labels[key] = _unescape("".join(raw))
        i = j + 1
    return labels


def parse_sample_line(line: str) -> Sample:
    if "{" in line:
        name, rest = line.split("{", 1)
        body, value_part = rest.rsplit("}", 1)
        labels = _parse_labels(body)
    else:
        name, value_part = line.split(None, 1)
        labels = {}
    value_str = value_part.strip()
    if value_str == "+Inf":
        value = math.inf
    elif value_str == "-Inf":
        value = -math.inf
    else:
        value = float(value_str)
    return Sample(name.strip(), labels, value)


def base_family(sample_name: str) -> str:
    """Histogram/summary suffixes map to their family name."""
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            return sample_name[: -len(suffix)]
    return sample_name


def parse_exposition(text: str) -> Dict[str, MetricFamily]:
    """Exposition text → family name → MetricFamily.

    Samples attach to the family declared by ``# TYPE`` when one exists
    (so histogram ``_bucket``/``_sum``/``_count`` group together);
    headerless samples get an untyped family of their own name.
    """
    families: Dict[str, MetricFamily] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            fam = families.setdefault(name, MetricFamily(name))
            fam.help = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, type_text = rest.partition(" ")
            fam = families.setdefault(name, MetricFamily(name))
            fam.type = type_text.strip()
            continue
        if line.startswith("#"):
            continue
        sample = parse_sample_line(line)
        fam_name = base_family(sample.name)
        if fam_name not in families and sample.name in families:
            fam_name = sample.name  # e.g. a gauge literally named *_count
        fam = families.setdefault(fam_name, MetricFamily(fam_name))
        fam.samples.append(sample)
    return families


def histogram_series(
    family: MetricFamily,
) -> Dict[Tuple[Tuple[str, str], ...], dict]:
    """Group a histogram family's samples per label set (minus ``le``).

    Returns label-key → {"buckets": [(le, cum_count)...sorted], "sum": x,
    "count": n} for validity checks (bucket monotonicity, +Inf == count).
    """
    series: Dict[Tuple[Tuple[str, str], ...], dict] = {}
    for s in family.samples:
        labels = dict(s.labels)
        le = labels.pop("le", None)
        key = tuple(sorted(labels.items()))
        entry = series.setdefault(key, {"buckets": [], "sum": None, "count": None})
        if s.name.endswith("_bucket"):
            bound = math.inf if le == "+Inf" else float(le)
            entry["buckets"].append((bound, s.value))
        elif s.name.endswith("_sum"):
            entry["sum"] = s.value
        elif s.name.endswith("_count"):
            entry["count"] = s.value
    for entry in series.values():
        entry["buckets"].sort(key=lambda b: b[0])
    return series
