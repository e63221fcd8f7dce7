"""Process-wide metrics registry (DESIGN.md §9).

A copy of ``repro/obs/metrics.py`` (standard library and numpy only);
``tests/test_torch_obs.py`` holds it against the reference.

One registry instance (:data:`REGISTRY`) holds every counter, gauge and
histogram the serving and kernel layers emit.  Three instrument kinds:

  * :class:`Counter`   — monotonically increasing float;
  * :class:`Gauge`     — set/inc/dec to any value;
  * :class:`Histogram` — fixed upper-bound buckets with numpy-backed
    cumulative counts, plus running sum/count.

A metric declared with ``labelnames`` is a family: ``met.labels(k=v)``
returns (creating on first use) the child instrument for that label
combination, so call sites write ``DISPATCH.labels(backend="v3").inc()``.

Everything here is **host-side python** — instruments are plain numpy /
float state, never torch tensors, so emitting a metric reads nothing
back from the device.

Enable/disable contract: :func:`enabled` is the single gate every
*instrumentation hook* (core/backend, hardware/autotune, ServeEngine's
timing histograms and spans) checks before doing any work — with
telemetry off the hot path pays one branch, nothing else.  The
instruments themselves do NOT check the gate: ServeEngine's lifetime
counters double as its functional stats (``run()`` derives its returned
dict from them, DESIGN.md §9), so they count unconditionally.  The
default follows the ``SME_TELEMETRY`` env var ("0"/"off" disables);
:func:`set_enabled` overrides it for the process.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "get_registry", "enabled", "set_enabled", "DEFAULT_BUCKETS",
    "flatten_snapshot", "write_snapshot",
]

SNAPSHOT_VERSION = 1

#: default histogram upper bounds (seconds-flavored: latencies from 50us
#: to 2 minutes); fractions/occupancies pass their own 0..1 buckets
DEFAULT_BUCKETS = (5e-5, 2e-4, 1e-3, 5e-3, 0.025, 0.1, 0.5, 2.0, 10.0,
                   60.0, 120.0)

_ENABLED = os.environ.get("SME_TELEMETRY", "1").lower() not in (
    "0", "off", "false", "no")


def enabled() -> bool:
    """True when telemetry hooks should record (the one hot-path gate)."""
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


# ------------------------------------------------------------- instruments
class _Instrument:
    """State shared by every child: the label values that identify it."""

    __slots__ = ("labels_kv",)

    def __init__(self, labels_kv: Dict[str, str]):
        self.labels_kv = labels_kv


class Counter(_Instrument):
    __slots__ = ("value",)

    def __init__(self, labels_kv=None):
        super().__init__(labels_kv or {})
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += amount

    def snapshot(self) -> Dict[str, object]:
        return {"labels": self.labels_kv, "value": self.value}


class Gauge(_Instrument):
    __slots__ = ("value",)

    def __init__(self, labels_kv=None):
        super().__init__(labels_kv or {})
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def snapshot(self) -> Dict[str, object]:
        return {"labels": self.labels_kv, "value": self.value}


class Histogram(_Instrument):
    """Fixed-bucket histogram: ``bounds`` are inclusive upper edges; one
    extra +inf bucket catches the tail.  ``counts`` stores per-bucket
    (non-cumulative) int64 counts; the text exposition renders the
    Prometheus cumulative form."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, labels_kv=None, bounds: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(labels_kv or {})
        b = tuple(float(x) for x in bounds)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram bounds must strictly increase: {b}")
        self.bounds = b
        self.counts = np.zeros(len(b) + 1, dtype=np.int64)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[int(np.searchsorted(self.bounds, v, side="left"))] += 1
        self.sum += v
        self.count += 1

    def snapshot(self) -> Dict[str, object]:
        return {"labels": self.labels_kv,
                "buckets": {str(b): int(c) for b, c in
                            zip(self.bounds + ("+Inf",), self.counts)},
                "sum": self.sum, "count": self.count}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Metric:
    """A named family: either a single unlabeled instrument or a map of
    label-value tuples to child instruments."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets is not None else None
        self._children: Dict[Tuple[str, ...], _Instrument] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._make({})

    def _make(self, labels_kv: Dict[str, str]) -> _Instrument:
        if self.kind == "histogram":
            return Histogram(labels_kv, self.buckets or DEFAULT_BUCKETS)
        return _KINDS[self.kind](labels_kv)

    def labels(self, **kv: str):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {tuple(kv)}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, self._make(dict(zip(self.labelnames, key))))
        return child

    # unlabeled families proxy the instrument API straight through
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; call .labels() first")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    def children(self) -> List[_Instrument]:
        return list(self._children.values())

    def snapshot(self) -> Dict[str, object]:
        return {"type": self.kind, "help": self.help,
                "values": [c.snapshot() for c in self.children()]}


# ---------------------------------------------------------------- registry
class MetricsRegistry:
    """Name -> :class:`Metric`; get-or-create with kind/label validation.

    ``snapshot()`` is the machine-readable dump (what ``--metrics-out``
    writes); ``render_text()`` is the
    Prometheus text exposition ``--metrics-port`` serves.
    """

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str,
             labelnames: Sequence[str],
             buckets: Optional[Sequence[float]] = None) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = Metric(name, kind, help, labelnames, buckets)
                    self._metrics[name] = m
        if m.kind != kind or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name} already registered as {m.kind}"
                f"{m.labelnames}, requested {kind}{tuple(labelnames)}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Metric:
        return self._get(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Metric:
        return self._get(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Metric:
        return self._get(name, "histogram", help, labelnames, buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def value(self, name: str, **labels: str) -> float:
        """Counter/gauge child value (0.0 when never touched) — the read
        path ServeEngine's derived stats dict uses."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        if not labels and not m.labelnames:
            return m._solo().value
        key = tuple(str(labels.get(k, "")) for k in m.labelnames)
        child = m._children.get(key)
        return 0.0 if child is None else child.value

    def sum_values(self, name: str, **match: str) -> float:
        """Sum of a family's counter/gauge values over children whose
        labels match every ``match`` item (histograms sum their counts)."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        total = 0.0
        for c in m.children():
            if all(c.labels_kv.get(k) == str(v) for k, v in match.items()):
                total += c.count if isinstance(c, Histogram) else c.value
        return total

    def snapshot(self) -> Dict[str, object]:
        return {"version": SNAPSHOT_VERSION,
                "metrics": {n: m.snapshot()
                            for n, m in sorted(self._metrics.items())}}

    def flat_values(self) -> Dict[str, float]:
        return flatten_snapshot(self.snapshot())

    def render_text(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        out: List[str] = []
        for name in self.names():
            m = self._metrics[name]
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            for c in m.children():
                lab = _fmt_labels(c.labels_kv)
                if isinstance(c, Histogram):
                    cum = 0
                    for b, n in zip(c.bounds + (float("inf"),), c.counts):
                        cum += int(n)
                        le = "+Inf" if b == float("inf") else _fmt_num(b)
                        out.append(f"{name}_bucket"
                                   f"{_fmt_labels({**c.labels_kv, 'le': le})}"
                                   f" {cum}")
                    out.append(f"{name}_sum{lab} {_fmt_num(c.sum)}")
                    out.append(f"{name}_count{lab} {c.count}")
                else:
                    out.append(f"{name}{lab} {_fmt_num(c.value)}")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        """Drop every metric (tests; never called by serving code)."""
        with self._lock:
            self._metrics.clear()


def _fmt_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(kv: Dict[str, str]) -> str:
    if not kv:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(kv.items()))
    return "{" + inner + "}"


def flatten_snapshot(snap: Dict[str, object]) -> Dict[str, float]:
    """``snapshot()`` (or its JSON round-trip) -> flat ``{series: value}``:
    counters/gauges as ``name{labels}``, histograms as ``name_count{...}``
    and ``name_sum{...}``.  The gate and the benchmark delta hook both
    diff registries through this one view."""
    flat: Dict[str, float] = {}
    for name, m in snap.get("metrics", {}).items():
        for v in m.get("values", []):
            lab = _fmt_labels(v.get("labels", {}))
            if m.get("type") == "histogram":
                flat[f"{name}_count{lab}"] = float(v["count"])
                flat[f"{name}_sum{lab}"] = float(v["sum"])
            else:
                flat[f"{name}{lab}"] = float(v["value"])
    return flat


def write_snapshot(path: str,
                   registry: Optional["MetricsRegistry"] = None) -> str:
    """Write the registry snapshot as JSON (``--metrics-out``)."""
    reg = registry if registry is not None else REGISTRY
    with open(path, "w") as f:
        json.dump(reg.snapshot(), f, indent=1, sort_keys=True)
    return path


#: the process-wide registry every subsystem emits into
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
