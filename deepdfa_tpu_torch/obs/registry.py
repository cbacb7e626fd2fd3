"""One metrics registry for every endpoint: counter/gauge/histogram
families with labels, rendered in the Prometheus text exposition format
with exactly one ``# HELP`` + ``# TYPE`` line per family.

A copy of ``deepdfa_tpu/obs/registry.py``: the port's ``/metrics`` and
``/slo`` bodies are rendered here, byte for byte the JAX package's for the
same staged values.

Stdlib-only, thread-safe, and deliberately small:

- ``counter``/``gauge`` families hold ``{label-values: number}``;
  ``set()`` stages an absolute value (the scrape-time path — the
  existing metric objects keep their own counters and snapshot
  semantics), ``inc()`` mutates in place (the live path);
- ``histogram`` families hold per-label bucket counts with fixed upper
  edges; ``observe()`` is the live path, ``set_histogram()`` stages a
  precomputed window (how the drift sentinel's score histogram is
  exposed);
- label values are escaped per the exposition format (backslash, quote,
  newline); families with no staged samples are omitted entirely.
"""

from __future__ import annotations

import math
import threading

__all__ = ["MetricsRegistry", "Family", "escape_label_value"]

_KINDS = ("counter", "gauge", "histogram")


def escape_label_value(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value) -> str:
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, float):
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
        if value == int(value) and abs(value) < 1e15:
            # keep float-typed whole numbers readable ("3.0" -> "3")
            return str(int(value))
        return repr(value)
    return str(value)


def _label_str(label_names, label_values) -> str:
    if not label_names:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in zip(label_names, label_values))
    return "{" + inner + "}"


class Family:
    """One metric family. Do not construct directly — use
    :meth:`MetricsRegistry.counter` / ``gauge`` / ``histogram``."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help_: str, labels: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = ()):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help_
        self.labels = tuple(labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._values: dict[tuple, float] = {}
        self._hists: dict[tuple, dict] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labels):
            raise ValueError(
                f"{self.name}: expected labels {self.labels}, got "
                f"{tuple(labels)}")
        return tuple(labels[k] for k in self.labels)

    def set(self, value, **labels) -> None:
        if value is None:
            return
        with self.registry._lock:
            self._values[self._key(labels)] = value

    def inc(self, by=1, **labels) -> None:
        with self.registry._lock:
            key = self._key(labels)
            self._values[key] = self._values.get(key, 0) + by

    def observe(self, value: float, **labels) -> None:
        if self.kind != "histogram":
            raise TypeError(f"{self.name} is a {self.kind}, not a histogram")
        with self.registry._lock:
            h = self._hists.setdefault(
                self._key(labels),
                {"counts": [0] * len(self.buckets), "sum": 0.0, "count": 0})
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    h["counts"][i] += 1  # per-bucket; cumulated at render
                    break
            h["sum"] += float(value)
            h["count"] += 1

    def set_histogram(self, counts, sum_: float, count: int,
                      **labels) -> None:
        """Stage a precomputed (non-cumulative, per-bucket) count vector
        for this label set — the scrape-time histogram path."""
        if self.kind != "histogram":
            raise TypeError(f"{self.name} is a {self.kind}, not a histogram")
        counts = list(counts)
        if len(counts) != len(self.buckets):
            raise ValueError(
                f"{self.name}: {len(counts)} counts for "
                f"{len(self.buckets)} buckets")
        cumulative, running = [], 0
        for c in counts:
            running += int(c)
            cumulative.append(running)
        with self.registry._lock:
            self._hists[self._key(labels)] = {
                "counts_cumulative": cumulative,
                "sum": float(sum_), "count": int(count)}

    def _lines(self, prefix: str) -> list[str]:
        name = prefix + self.name
        lines: list[str] = []
        if self.kind != "histogram":
            for key in sorted(self._values, key=lambda k: tuple(map(str, k))):
                lines.append(
                    f"{name}{_label_str(self.labels, key)} "
                    f"{_fmt(self._values[key])}")
            return lines
        for key in sorted(self._hists, key=lambda k: tuple(map(str, k))):
            h = self._hists[key]
            if "counts_cumulative" in h:
                cum = h["counts_cumulative"]
            else:
                cum, running = [], 0
                for c in h["counts"]:
                    running += c
                    cum.append(running)
            for edge, c in zip(self.buckets, cum):
                ls = _label_str(self.labels + ("le",), key + (_fmt(edge),))
                lines.append(f"{name}_bucket{ls} {c}")
            ls = _label_str(self.labels + ("le",), key + ("+Inf",))
            lines.append(f"{name}_bucket{ls} {h['count']}")
            lines.append(
                f"{name}_sum{_label_str(self.labels, key)} {_fmt(h['sum'])}")
            lines.append(
                f"{name}_count{_label_str(self.labels, key)} {h['count']}")
        return lines

    def _has_samples(self) -> bool:
        return bool(self._values) or bool(self._hists)


class MetricsRegistry:
    """Family declarations + one conformant renderer. ``prefix`` is
    prepended to every family name (``deepdfa_serve_``, ``deepdfa_router_``,
    ``deepdfa_train_``)."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._lock = threading.RLock()
        self._families: dict[str, Family] = {}

    def _family(self, name: str, kind: str, help_: str,
                labels=(), buckets=()) -> Family:
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"{name} already declared as {fam.kind}, not {kind}")
                return fam
            fam = Family(self, name, kind, help_, tuple(labels),
                         tuple(buckets))
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str, labels=()) -> Family:
        return self._family(name, "counter", help_, labels)

    def gauge(self, name: str, help_: str, labels=()) -> Family:
        return self._family(name, "gauge", help_, labels)

    def histogram(self, name: str, help_: str, buckets, labels=()) -> Family:
        return self._family(name, "histogram", help_, labels, buckets)

    def render(self) -> str:
        """The exposition text: declaration order, one ``# HELP`` + one
        ``# TYPE`` per family, families without samples omitted."""
        lines: list[str] = []
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            if not fam._has_samples():
                continue
            name = self.prefix + fam.name
            lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            lines.extend(fam._lines(self.prefix))
        return "\n".join(lines) + "\n"
