"""The metrics registry and its Prometheus instruments.

The port's copy of ``dynamo_tpu/telemetry/registry.py``, cut to what the
HTTP front's ``ServiceMetrics``, the engine's dict gauges and the KV
tiers use: counters, gauges, histograms, callback gauges (a number, or
labelled samples, pulled at render), dict-returning callback gauges,
attached child registries and the text exposition (no client library: the
format is simple enough to emit).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: backslash, double quote, and
    newline must be escaped or the exposition line is unparseable (model
    names and error strings routinely contain all three)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def format_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self.values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        self.values[key] = self.values.get(key, 0.0) + amount

    def set_sample(self, value: float, **labels: str) -> None:
        """Overwrite a series with a snapshot of another object's monotonic
        total (the federation pattern), NOT for first-party counting, which
        goes through ``inc``."""
        self.values[tuple(sorted(labels.items()))] = value

    def _type(self) -> str:
        return "counter"

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self._type()}",
        ]
        for key, val in sorted(self.values.items()):
            lines.append(f"{self.name}{format_labels(dict(key))} {val}")
        return lines


class Gauge(Counter):
    def set(self, value: float, **labels: str) -> None:
        self.values[tuple(sorted(labels.items()))] = value

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def _type(self) -> str:
        return "gauge"


class Histogram:
    def __init__(self, name: str, help_: str, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = buckets
        self.counts: Dict[Tuple[Tuple[str, str], ...], List[int]] = {}
        self.sums: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self.totals: Dict[Tuple[Tuple[str, str], ...], int] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        if key not in self.counts:
            self.counts[key] = [0] * len(self.buckets)
            self.sums[key] = 0.0
            self.totals[key] = 0
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[key][i] += 1
        self.sums[key] += value
        self.totals[key] += 1

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} histogram",
        ]
        for key in sorted(self.counts):
            labels = dict(key)
            for i, b in enumerate(self.buckets):
                lines.append(
                    f"{self.name}_bucket{format_labels({**labels, 'le': str(b)})} {self.counts[key][i]}"
                )
            lines.append(
                f"{self.name}_bucket{format_labels({**labels, 'le': '+Inf'})} {self.totals[key]}"
            )
            lines.append(f"{self.name}_sum{format_labels(labels)} {self.sums[key]}")
            lines.append(f"{self.name}_count{format_labels(labels)} {self.totals[key]}")
        return lines


class CallbackGauge:
    """A gauge whose value(s) come from a callback at render time.

    The callback may return a plain number (one unlabelled sample) or an
    iterable of ``(labels_dict, value)`` pairs (one sample per label set).
    A broken or non-numeric callback renders nothing; /metrics must never
    go down with a component.
    """

    def __init__(self, name: str, help_: str, fn: Callable):
        self.name = name
        self.help = help_
        self.fn = fn

    def render(self) -> List[str]:
        try:
            value = self.fn()
            samples: List[Tuple[Dict[str, str], float]] = []
            if isinstance(value, bool):
                return []
            if isinstance(value, (int, float)):
                samples = [({}, float(value))]
            else:
                for labels, v in value:
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    samples.append((dict(labels), float(v)))
        # dynlint: allow(silent-except) - a broken callback must not take /metrics down
        except Exception:
            return []
        if not samples:
            return []
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} gauge",
        ]
        for labels, v in samples:
            lines.append(f"{self.name}{format_labels(labels)} {v}")
        return lines


class CallbackGauges:
    """Dict-returning callback → one unlabelled gauge per numeric key.

    The escape hatch for metrics whose NAMES are dynamic (BYO python-file
    engines return arbitrary dicts); first-party components should prefer
    named instruments, which the name lint can check.
    """

    def __init__(self, prefix: str, fn: Callable):
        self.prefix = prefix
        self.fn = fn

    def render(self) -> List[str]:
        lines: List[str] = []
        try:
            vals = self.fn() or {}
            if not isinstance(vals, dict):
                return []  # BYO engines may return anything
            for k, v in sorted(vals.items()):
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                name = f"{self.prefix}_{k}"
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {float(v)}")
        # dynlint: allow(silent-except) - a broken engine must not take /metrics down
        except Exception:
            return []
        return lines


class MetricsRegistry:
    """One exposition surface: named instruments, got or created, dict
    gauges pulled at every render, and the instruments of ``attach``-ed
    child registries (a component that owns its registry, such as the
    cold tier, renders into its owner's scrape)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._order: List[object] = []
        self._children: List["MetricsRegistry"] = []

    # ---------- instrument creation ----------

    def _get_or_create(self, name: str, cls, *args):
        existing = self._metrics.get(name)
        if existing is not None:
            if not isinstance(existing, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(existing).__name__}, not {cls.__name__}"
                )
            return existing
        metric = cls(name, *args)
        self._metrics[name] = metric
        self._order.append(metric)
        return metric

    def counter(self, name: str, help_: str) -> Counter:
        return self._get_or_create(name, Counter, help_)

    def gauge(self, name: str, help_: str) -> Gauge:
        return self._get_or_create(name, Gauge, help_)

    def histogram(self, name: str, help_: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, Histogram, help_, buckets)

    def callback_gauge(self, name: str, help_: str, fn: Callable) -> CallbackGauge:
        existing = self._metrics.get(name)
        if isinstance(existing, CallbackGauge):
            existing.fn = fn  # re-bind (a rebuilt component)
            return existing
        return self._get_or_create(name, CallbackGauge, help_, fn)

    def register_callback_gauges(self, prefix: str, fn: Callable) -> None:
        """Dict-returning callback → ``{prefix}_{key}`` gauges, pulled
        fresh at every render (BYO engines; dynamic names)."""
        self._order.append(CallbackGauges(prefix, fn))

    def attach(self, child: "MetricsRegistry") -> None:
        """Render ``child``'s instruments as part of this exposition."""
        if child is self or child in self._children:
            return
        self._children.append(child)

    def names(self) -> List[str]:
        out = list(self._metrics)
        for child in self._children:
            out.extend(child.names())
        return out

    def render_lines(self) -> List[str]:
        lines: List[str] = []
        for metric in self._order:
            lines.extend(metric.render())
        for child in self._children:
            lines.extend(child.render_lines())
        return lines

    def render(self) -> str:
        return "\n".join(self.render_lines()) + "\n"
