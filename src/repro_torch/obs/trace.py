"""Per-request lifecycle tracing (DESIGN.md §9).

A copy of ``repro/obs/trace.py`` (standard library only);
``tests/test_torch_obs.py`` holds it against the reference.

A :class:`Span` is one host-side event in a request's life —
``enqueue -> admit -> prefill -> token* -> finish | evict | reject`` —
with a start timestamp (seconds on the tracer's monotonic clock), an
optional duration (0 = instant event), the request id it belongs to and
free-form ``attrs``.

Spans land in a :class:`TraceBuffer`: a bounded ring (deque) that never
grows past ``capacity`` — when full, the *oldest* span is evicted and
counted in ``dropped``, so a long-lived engine holds the most recent
window of activity at O(capacity) memory, never O(tokens served).

Two exporters:

  * :func:`export_jsonl` / :func:`read_jsonl` — one JSON object per line,
    lossless round-trip (``--trace-out foo.jsonl``);
  * :func:`export_trace_event` — the Chrome/Perfetto ``trace_event``
    format (``--trace-out foo.json``): load the file at
    ``chrome://tracing`` or https://ui.perfetto.dev.  Durations become
    complete ("X") events, instants become "i" events; the track (tid)
    is the request id so each request reads as one timeline row.

Everything is host-side python; the tracer is consulted only *around*
the engine's device calls, so tracing cannot perturb tokens.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional

from .metrics import enabled

__all__ = ["Span", "TraceBuffer", "Tracer", "export_jsonl", "read_jsonl",
           "export_trace_event"]


@dataclasses.dataclass
class Span:
    name: str                            # e.g. "prefill", "token", "finish"
    ts: float                            # start, seconds on the trace clock
    dur: float = 0.0                     # 0.0 => instant event
    rid: Optional[int] = None            # request id; None => engine-level
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        d = {"name": self.name, "ts": self.ts, "dur": self.dur,
             "rid": self.rid}
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "Span":
        return Span(name=d["name"], ts=float(d["ts"]),
                    dur=float(d.get("dur", 0.0)), rid=d.get("rid"),
                    attrs=dict(d.get("attrs", {})))


class TraceBuffer:
    """Bounded ring of spans: append is O(1), capacity is a hard cap."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0

    def add(self, span: Span) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1            # deque evicts the oldest itself
        self._ring.append(span)

    def __len__(self) -> int:
        return len(self._ring)

    def spans(self) -> List[Span]:
        """Oldest-first snapshot of the current window."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0


class Tracer:
    """Span factory bound to one buffer and one monotonic clock origin.

    Every record method is a no-op (one branch) when telemetry is
    disabled (:func:`repro_torch.obs.enabled`).  ``now()`` is seconds since the
    tracer was built — exporters multiply to microseconds."""

    def __init__(self, capacity: int = 4096):
        self.buffer = TraceBuffer(capacity)
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def event(self, name: str, rid: Optional[int] = None, **attrs) -> None:
        if not enabled():
            return
        self.buffer.add(Span(name, self.now(), 0.0, rid, attrs))

    def span(self, name: str, start: float, rid: Optional[int] = None,
             **attrs) -> None:
        """Record a completed span that began at ``start`` (= an earlier
        ``now()``) and ends now."""
        if not enabled():
            return
        t = self.now()
        self.buffer.add(Span(name, start, t - start, rid, attrs))


# ---------------------------------------------------------------- exporters
def _spans_of(buf) -> Iterable[Span]:
    return buf.spans() if isinstance(buf, (TraceBuffer,)) else buf


def export_jsonl(buf, path: str) -> str:
    """One span per line; lossless (see :func:`read_jsonl`)."""
    with open(path, "w") as f:
        for s in _spans_of(buf):
            f.write(json.dumps(s.to_dict(), sort_keys=True) + "\n")
    return path


def read_jsonl(path: str) -> List[Span]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(Span.from_dict(json.loads(line)))
    return out


def export_trace_event(buf, path: str, pid: int = 0) -> str:
    """Chrome/Perfetto ``trace_event`` JSON.  One row (tid) per request;
    engine-level spans (rid None) land on tid 0."""
    events = []
    for s in _spans_of(buf):
        ev = {"name": s.name, "pid": pid,
              "tid": 0 if s.rid is None else int(s.rid) + 1,
              "ts": s.ts * 1e6, "args": dict(s.attrs)}
        if s.rid is not None:
            ev["args"]["rid"] = s.rid
        if s.dur > 0:
            ev.update(ph="X", dur=s.dur * 1e6)
        else:
            ev.update(ph="i", s="t")
        events.append(ev)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
