"""Typed metrics registry: counters, gauges, timer-histograms.

A copy of ``raft_tpu/core/metrics.py`` (which holds no JAX), kept here
because the port imports nothing of the JAX package.  Metric names keep
the ``raft_tpu_`` prefix, so dashboards read both packages alike.

The reference's only runtime observability is NVTX ranges
(cpp/include/raft/common/nvtx.hpp) — numbers live in external profilers.
This module is the in-process half the TPU build needs for
measurement-driven work (the CUDA-L2 / HiCCL methodology both start from
per-primitive timing and per-collective byte accounting): a small,
thread-safe, dependency-free registry whose snapshots travel with bench
artifacts.

Metric model (a deliberately tiny subset of the Prometheus data model):

- ``Counter``  — monotonically increasing float/int.
- ``Gauge``    — settable value; tracks the max it has ever held
  (``high_water``) so peak accounting needs no second metric.
- ``Timer``    — duration histogram: exact count/total/min/max plus a
  bounded reservoir of recent samples for p50/p95 quantiles.

Every metric is a *family* that may carry labels
(``registry.counter("raft_tpu_comms_bytes_total", labels=("verb",))``;
``fam.labels(verb="allreduce").inc(n)``).  Families declared without
label names act directly as their single unlabeled series.

Naming scheme: ``raft_tpu_<layer>_<name>`` (see docs/OBSERVABILITY.md);
:func:`metric_name` builds and validates it.

Export: :meth:`MetricsRegistry.snapshot` (plain dicts, isolated from
later mutation), :meth:`~MetricsRegistry.to_json`, and
:meth:`~MetricsRegistry.to_prometheus` (text exposition format;
:func:`parse_prometheus` reads it back for round-trip tests and for
scraping bench artifacts).

The ``RAFT_TPU_METRICS`` environment variable ("0" disables) or
:func:`set_enabled` turn recording into a no-op globally — the registry
and its metric objects stay usable so instrumented code never branches.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import threading
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Timer", "MetricsRegistry",
    "default_registry", "metric_name", "parse_prometheus",
    "set_enabled", "is_enabled",
]

_enabled = os.environ.get("RAFT_TPU_METRICS", "1") != "0"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# bounded reservoir: quantiles reflect the most recent window, while
# count/total/min/max stay exact over the metric's whole lifetime
TIMER_RESERVOIR = 2048


def set_enabled(on: bool) -> None:
    """Globally enable/disable metric recording (RAFT_TPU_METRICS=0)."""
    global _enabled
    _enabled = on


def is_enabled() -> bool:
    return _enabled


def metric_name(layer: str, name: str) -> str:
    """Canonical ``raft_tpu_<layer>_<name>`` metric name."""
    full = "raft_tpu_%s_%s" % (layer, name)
    if not _NAME_RE.match(full):
        raise ValueError("invalid metric name %r" % full)
    return full


class _Series:
    """One labeled child of a metric family; subclasses add semantics."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock


class Counter(_Series):
    """Monotonic counter."""

    def __init__(self, lock):
        super().__init__(lock)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        if n < 0:
            raise ValueError("Counter.inc: negative increment %r" % n)
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _snapshot(self):
        return {"value": self.value}


class Gauge(_Series):
    """Settable value; remembers the highest value it has held."""

    def __init__(self, lock):
        super().__init__(lock)
        self._value = 0.0
        self._high_water = 0.0

    def set(self, v: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = v
            if v > self._high_water:
                self._high_water = v

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += n
            if self._value > self._high_water:
                self._high_water = self._value

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def _add_raw(self, n: float) -> None:
        """Unconditional adjustment, bypassing the enable gate — for
        *paired* accounting (alloc/free) whose halves must balance even
        if recording is toggled between them."""
        with self._lock:
            self._value += n
            if self._value > self._high_water:
                self._high_water = self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def high_water(self) -> float:
        with self._lock:
            return self._high_water

    def _snapshot(self):
        with self._lock:
            return {"value": self._value, "high_water": self._high_water}


class Timer(_Series):
    """Duration histogram (seconds): exact count/total/min/max, plus a
    bounded reservoir of recent samples for p50/p95."""

    def __init__(self, lock):
        super().__init__(lock)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._samples = collections.deque(maxlen=TIMER_RESERVOIR)

    def observe(self, seconds: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self.count += 1
            self.total += seconds
            if seconds < self.min:
                self.min = seconds
            if seconds > self.max:
                self.max = seconds
            self._samples.append(seconds)

    def time(self):
        """``with timer.time(): ...`` — observe the block's wall time."""
        return _TimerScope(self)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the sample reservoir (0 if empty):
        the ceil(q*n)-th smallest sample, so p50 of two samples is the
        *lower* one, not the max."""
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
        idx = max(0, math.ceil(q * len(s)) - 1)
        return s[min(len(s) - 1, idx)]

    def _snapshot(self):
        with self._lock:
            if self.count == 0:
                return {"count": 0, "total": 0.0, "mean": 0.0, "min": 0.0,
                        "max": 0.0, "p50": 0.0, "p95": 0.0}
            snap = {"count": self.count, "total": self.total,
                    "mean": self.total / self.count,
                    "min": self.min, "max": self.max}
            s = sorted(self._samples)
        # one sort shared by both quantiles (snapshots walk every timer
        # series; the reservoir is up to 2048 samples)
        for key, q in (("p50", 0.50), ("p95", 0.95)):
            snap[key] = s[min(len(s) - 1,
                              max(0, math.ceil(q * len(s)) - 1))]
        return snap


class _TimerScope:
    def __init__(self, timer: Timer):
        self._timer = timer

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.observe(time.perf_counter() - self._t0)


_KINDS = {"counter": Counter, "gauge": Gauge, "timer": Timer}


class _Family:
    """A named metric with optional label dimensions."""

    def __init__(self, kind: str, name: str, help: str,
                 label_names: Tuple[str, ...], lock: threading.RLock):
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = label_names
        self._lock = lock
        self._children: Dict[Tuple[str, ...], _Series] = {}

    def labels(self, **labels) -> _Series:
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                "%s: labels %r do not match declared %r"
                % (self.name, tuple(sorted(labels)), self.label_names))
        key = tuple(str(labels[k]) for k in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind](self._lock)
                self._children[key] = child
            return child

    def _default(self) -> _Series:
        if self.label_names:
            raise ValueError(
                "%s is labeled %r; use .labels(...)"
                % (self.name, self.label_names))
        return self.labels()

    # unlabeled families act directly as their single series
    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, seconds: float) -> None:
        self._default().observe(seconds)

    def time(self):
        return self._default().time()

    def quantile(self, q: float) -> float:
        return self._default().quantile(q)

    @property
    def value(self):
        return self._default().value

    @property
    def high_water(self):
        return self._default().high_water

    def series(self) -> Iterator[Tuple[Dict[str, str], _Series]]:
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            yield dict(zip(self.label_names, key)), child

    def _snapshot(self):
        return {
            "type": self.kind,
            "help": self.help,
            "series": [dict(labels=lbls, **child._snapshot())
                       for lbls, child in self.series()],
        }


class MetricsRegistry:
    """Thread-safe named collection of metric families.

    ``counter``/``gauge``/``timer`` are get-or-create: re-declaring an
    existing name returns the same family (and raises if the kind or
    label names disagree — two call sites silently feeding different
    schemas into one name is the classic metrics bug).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._generation = 0

    @property
    def generation(self) -> int:
        """Bumped by :meth:`reset`.  Callers that cache resolved series
        (hot paths) or schedule paired updates (alloc/free accounting)
        compare generations so a reset invalidates the cache instead of
        corrupting a freshly recreated family."""
        with self._lock:
            return self._generation

    def _get_or_create(self, kind: str, name: str, help: str,
                       labels: Sequence[str]) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % name)
        label_names = tuple(labels)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError("invalid label name %r" % ln)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(kind, name, help, label_names, self._lock)
                self._families[name] = fam
            elif fam.kind != kind or fam.label_names != label_names:
                raise ValueError(
                    "metric %s already registered as %s%r, requested %s%r"
                    % (name, fam.kind, fam.label_names, kind, label_names))
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._get_or_create("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._get_or_create("gauge", name, help, labels)

    def timer(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._get_or_create("timer", name, help, labels)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def family_total(self, name: str) -> float:
        """Sum of a family's series values, 0.0 when the family was
        never materialized — the one spelling of the "total of a
        counter across labels" read (bench.py / tools/loadgen.py /
        tests all share it, so absent-family handling cannot skew)."""
        fam = self.get(name)
        if fam is None:
            return 0.0
        return float(sum(s.value for _, s in fam.series()))

    def reset(self) -> None:
        """Drop every family (test isolation / stats-window rollover).
        Bumps :attr:`generation` so cached series and in-flight paired
        accounting from before the reset are discarded, not misapplied
        to the recreated families."""
        with self._lock:
            self._families.clear()
            self._generation += 1

    def locked(self):
        """The registry's (reentrant) lock, for callers that must make
        a generation check atomic with the update it guards — e.g. the
        buffer accounting's check-then-adjust pair, where a reset
        racing between the two would corrupt the recreated gauge.
        Metric operations may be nested inside (same RLock)."""
        return self._lock

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict copy of every family; isolated from later updates."""
        with self._lock:
            fams = list(self._families.items())
        return {name: fam._snapshot() for name, fam in sorted(fams)}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def dump_json(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json(indent=2))
            f.write("\n")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format.

        Timers render as summaries: ``<name>{quantile="..."}``,
        ``<name>_sum``, ``<name>_count``, plus a ``<name>_max`` gauge
        (exact lifetime max, which quantiles over a reservoir can't
        promise).  Gauges additionally expose ``<name>_peak`` — the
        high-water mark, so a scraper sees the same peak the JSON
        snapshot carries without needing a second metric.
        """
        lines = []
        for name, fam in sorted(self.snapshot().items()):
            kind = fam["type"]
            if fam["help"]:
                lines.append("# HELP %s %s" % (name, fam["help"]))
            lines.append("# TYPE %s %s"
                         % (name, "summary" if kind == "timer" else kind))
            for s in fam["series"]:
                lbl = s["labels"]
                if kind == "counter":
                    lines.append("%s %r" % (_fmt(name, lbl), s["value"]))
                elif kind == "gauge":
                    lines.append("%s %r" % (_fmt(name, lbl), s["value"]))
                    lines.append("%s %r" % (_fmt(name + "_peak", lbl),
                                            s["high_water"]))
                else:
                    for q, v in (("0.5", s["p50"]), ("0.95", s["p95"])):
                        lines.append("%s %r" % (
                            _fmt(name, dict(lbl, quantile=q)), v))
                    lines.append("%s %r" % (_fmt(name + "_sum", lbl),
                                            s["total"]))
                    lines.append("%s %d" % (_fmt(name + "_count", lbl),
                                            s["count"]))
                    lines.append("%s %r" % (_fmt(name + "_max", lbl),
                                            s["max"]))
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    body = ",".join('%s="%s"' % (k, _escape(v))
                    for k, v in sorted(labels.items()))
    return "%s{%s}" % (name, body)


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


# the label body may contain '}' inside quoted values, so it is matched
# as a sequence of quoted strings / non-brace runs, not [^}]*
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(?:\{(?P<labels>(?:[^{}"]|"(?:[^"\\]|\\.)*")*)\})?\s+(?P<value>\S+)$')
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape(v: str) -> str:
    # single left-to-right pass: sequential str.replace would corrupt a
    # literal backslash followed by 'n' into a newline
    return _UNESCAPE_RE.sub(
        lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), v)


def parse_prometheus(text: str) -> Dict[str, Dict[Tuple, float]]:
    """Parse Prometheus exposition text into
    ``{metric_name: {sorted-label-items-tuple: value}}`` — enough to
    round-trip :meth:`MetricsRegistry.to_prometheus` output and to
    assert on scraped bench artifacts; not a full openmetrics parser."""
    out: Dict[str, Dict[Tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError("unparseable metrics line: %r" % line)
        labels = tuple(sorted(
            (k, _unescape(v))
            for k, v in _LABEL_PAIR_RE.findall(m.group("labels") or "")))
        out.setdefault(m.group("name"), {})[labels] = float(m.group("value"))
    return out


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every raft_tpu layer reports into."""
    return _default
