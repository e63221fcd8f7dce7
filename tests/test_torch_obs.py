"""``repro_torch.obs`` (copies of the reference's standard-library
modules) against ``repro.obs``: one seeded sequence of registry
operations gives equal snapshots, flattened snapshots and Prometheus text,
and the same spans export to the same JSONL and trace_event files.  Also
the ring bound and the ``enabled`` gate.  Exact equality throughout."""
import json

import numpy as np
import pytest

from repro import obs as ref
from repro_torch import obs as port


@pytest.fixture(autouse=True)
def _telemetry_on():
    yield
    ref.set_enabled(True)
    port.set_enabled(True)


def _drive(mod, seed):
    """The same operations on a fresh registry of ``mod``."""
    rng = np.random.default_rng(seed)
    R = mod.MetricsRegistry()
    c = R.counter("req_total", "requests", ("engine", "outcome"))
    g = R.gauge("queue_depth", "waiting", ("engine",))
    h = R.histogram("lat_seconds", "latency", ("engine",))
    f = R.histogram("occ", "occupancy", buckets=(0.25, 0.5, 1.0))
    solo = R.counter("solo_total", 'quoted "help"')
    for _ in range(100):
        eng = str(rng.integers(3))
        op = rng.integers(5)
        if op == 0:
            c.labels(engine=eng, outcome=("ok", 'q"x')[rng.integers(2)]
                     ).inc(float(rng.integers(1, 4)))
        elif op == 1:
            g.labels(engine=eng).set(float(rng.normal()))
        elif op == 2:
            h.labels(engine=eng).observe(float(rng.exponential(0.5)))
        elif op == 3:
            f.observe(float(rng.random()))
        else:
            solo.inc()
    with pytest.raises(ValueError):
        c.labels(engine="0")
    with pytest.raises(ValueError):
        R.gauge("req_total")
    with pytest.raises(ValueError):
        c.labels(engine="0", outcome="ok").inc(-1)
    return R


@pytest.mark.parametrize("seed", range(3))
def test_registry_matches_reference(seed):
    a, b = _drive(ref, seed), _drive(port, seed)
    assert a.snapshot() == b.snapshot()
    assert a.flat_values() == b.flat_values()
    assert ref.flatten_snapshot(a.snapshot()) == \
        port.flatten_snapshot(b.snapshot())
    assert a.render_text() == b.render_text()
    assert a.value("req_total", engine="1", outcome="ok") == \
        b.value("req_total", engine="1", outcome="ok")
    assert a.sum_values("lat_seconds", engine="2") == \
        b.sum_values("lat_seconds", engine="2")


def test_snapshot_files_and_trace_exports_match_reference(tmp_path):
    paths = {}
    for name, mod in (("ref", ref), ("port", port)):
        mod.write_snapshot(str(tmp_path / f"{name}.json"), _drive(mod, 7))
        spans = [mod.Span("enqueue", 0.0, rid=1, attrs={"prompt_len": 5}),
                 mod.Span("prefill", 0.001, dur=0.5, attrs={"n_reqs": 2}),
                 mod.Span("token", 0.7, rid=2)]
        mod.export_jsonl(spans, str(tmp_path / f"{name}.jsonl"))
        mod.export_trace_event(spans, str(tmp_path / f"{name}.tr.json"))
        paths[name] = [tmp_path / f"{name}{ext}"
                       for ext in (".json", ".jsonl", ".tr.json")]
    for a, b in zip(paths["ref"], paths["port"]):
        assert a.read_text() == b.read_text()
    back = port.read_jsonl(str(paths["port"][1]))
    assert [s.name for s in back] == ["enqueue", "prefill", "token"]
    assert json.loads(paths["port"][0].read_text())["version"] == 1


def test_trace_ring_is_bounded_and_drops_oldest():
    buf = port.TraceBuffer(capacity=8)
    for i in range(20):
        buf.add(port.Span(name=f"s{i}", ts=float(i)))
        assert len(buf) <= 8
    assert buf.dropped == 12
    assert [s.name for s in buf.spans()] == [f"s{i}" for i in range(12, 20)]
    with pytest.raises(ValueError):
        port.TraceBuffer(capacity=0)


def test_tracer_respects_enabled_gate():
    tr = port.Tracer(capacity=8)
    tr.event("enqueue", rid=0)
    tr.span("prefill", tr.now(), rid=0, n_reqs=1)
    assert len(tr.buffer) == 2
    port.set_enabled(False)
    assert not port.enabled()
    tr.event("enqueue", rid=1)
    tr.span("prefill", tr.now(), rid=1)
    assert len(tr.buffer) == 2
    # the gate is the port's own: the reference's stays on
    assert ref.enabled()
