"""The engine and backend remainder of the port: the metrics gate
(``repro_torch.obs.gate``) and the HTTP exposition (``obs.httpd``,
``--metrics-port``), following ``tests/test_obs.py``; the process default
backend (``SME_BACKEND``, ``set_default_backend``, ``use_backend``); the
``SME_DECODE_KERNEL`` on/off/auto rule with the draft override; and
``use_block``/``resolve_block_m``/``--bm``, which set v3's decode
threshold only.  Each rule is held to the reference's on the same inputs;
every comparison is exact."""
import json
import os
import pathlib
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import repro.core.backend as RB
import repro_torch.core.backend as B
from repro_torch.core.integrate import convert_params_to_sme
from repro_torch.obs import MetricsRegistry, write_snapshot
from repro_torch.obs.gate import REQUIRED_FAMILIES, check_snapshot
from repro_torch.obs.gate import main as gate_main
from repro_torch.obs.httpd import start_metrics_server

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE = ["--small", "--device", "cpu", "--sme", "--backend", "v3",
         "--requests", "2", "--max-new", "3", "--slots", "2", "--s-max",
         "32"]


def _serve_like_registry(reference_families=False):
    R = MetricsRegistry()
    eid = dict(engine="0")
    R.counter("serve_requests_total", "", ("engine", "outcome")).labels(
        engine="0", outcome="completed").inc(3)
    R.counter("serve_prefills_total", "", ("engine",)).labels(**eid).inc(2)
    R.counter("serve_decode_steps_total", "",
              ("engine",)).labels(**eid).inc(7)
    R.counter("serve_tokens_total", "", ("engine",)).labels(**eid).inc(12)
    R.histogram("serve_ttft_seconds", "",
                ("engine",)).labels(**eid).observe(0.1)
    R.histogram("serve_inter_token_seconds", "",
                ("engine",)).labels(**eid).observe(0.01)
    if reference_families:
        R.counter("sme_dispatch_total", "", ("backend",)).labels(
            backend="v1").inc(4)
        R.counter("sme_operand_cache_total", "", ("event",)).labels(
            event="prepacked").inc(4)
    return R


def _snap(R):
    return json.loads(json.dumps(R.snapshot()))


# ------------------------------------------------------------ the gate
def test_gate_passes_a_live_launcher_snapshot(tmp_path):
    from repro_torch.launch import serve
    path = str(tmp_path / "m.json")
    stats = serve.main(SERVE + ["--metrics-out", path])
    assert stats["completed"] == 2
    assert gate_main([path]) == 0
    assert set(REQUIRED_FAMILIES) <= set(json.load(open(path))["metrics"])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.gate", path],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0 and "metrics gate OK" in proc.stdout


def test_gate_fails_on_missing_family_or_dead_run(tmp_path):
    snap = _snap(_serve_like_registry())
    assert check_snapshot(snap) == []

    missing = json.loads(json.dumps(snap))
    del missing["metrics"]["serve_ttft_seconds"]
    assert any("serve_ttft_seconds" in f for f in check_snapshot(missing))

    zero = json.loads(json.dumps(snap))
    zero["metrics"]["serve_decode_steps_total"]["values"][0]["value"] = 0
    assert any("decode steps" in f for f in check_snapshot(zero))

    assert check_snapshot({"version": 99, "metrics": {}})
    assert any("my_custom_total" in f
               for f in check_snapshot(snap, require=["my_custom_total"]))

    bad_path = tmp_path / "bad.json"
    bad_path.write_text(json.dumps(missing))
    assert gate_main([str(bad_path)]) == 1


def test_gate_agrees_with_the_reference_gate_on_its_families():
    """On a snapshot with the reference's per-dispatch families both gates
    pass, and both fail a dead operand cache; the port's own snapshots
    lack those families, which only the reference gate requires."""
    from repro.obs.gate import check_snapshot as ref_check
    snap = _snap(_serve_like_registry(reference_families=True))
    assert check_snapshot(snap) == ref_check(snap) == []
    nocache = json.loads(json.dumps(snap))
    nocache["metrics"]["sme_operand_cache_total"]["values"][0][
        "labels"]["event"] = "miss"
    assert check_snapshot(nocache) == ref_check(nocache) != []
    port_only = _snap(_serve_like_registry())
    assert check_snapshot(port_only) == []
    assert check_snapshot(port_only, require=["sme_dispatch_total"]) \
        == [f for f in ref_check(port_only) if "sme_dispatch" in f]


# ------------------------------------------------------ HTTP exposition
def test_metrics_http_endpoint():
    R = MetricsRegistry()
    R.counter("up_total", "liveness").inc()
    server, _thread = start_metrics_server(0, registry=R)
    try:
        port = server.server_port
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "up_total 1" in body
        assert "# TYPE up_total counter" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/nope", timeout=10)
    finally:
        server.shutdown()


def test_launcher_metrics_port_serves_the_registry(monkeypatch, capsys):
    import repro_torch.obs.httpd as httpd
    from repro_torch.launch import serve
    servers, real = [], httpd.start_metrics_server

    def start(port=0, *a, **kw):
        servers.append(real(port, *a, **kw))
        return servers[-1]
    monkeypatch.setattr(httpd, "start_metrics_server", start)
    try:
        serve.main(SERVE + ["--metrics-port", "0"])
        out = capsys.readouterr().out
        url = next(line.split()[1] for line in out.splitlines()
                   if line.startswith("metrics: http://127.0.0.1:"))
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "serve_tokens_total" in body and "serve_ttft_seconds" in body
    finally:
        for server, _ in servers:
            server.shutdown()


# ------------------------------------------------------ backend default
def _packed(seed=0, k=256, n=256):
    w = np.random.default_rng(seed).standard_normal((k, n)) / 16
    return convert_params_to_sme({"w": w.astype(np.float32)}, backend="all",
                                 device="cpu")["w"]


def test_sme_backend_env_seeds_both_packages_default():
    code = ("import repro.core.backend as R, repro_torch.core.backend as P;"
            "print(R.default_backend(), P.default_backend())")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               SME_BACKEND="v3")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["v3", "v3"]


def test_default_backend_scopes_and_resolution():
    p = _packed()
    x = torch.randn(3, 256)
    assert B.default_backend() == "auto"
    assert B.resolve_backend(p).name == "v2"          # auto: v2 > v3 > v1
    with B.use_backend("v3"):
        assert B.default_backend() == "v3"
        assert B.resolve_backend(p).name == "v3"
        assert B.resolved_backends({"w": p}) == ("v3",)
        assert torch.equal(B.sme_apply(x, p), B.sme_apply(x, p, "v3"))
        with B.use_backend(None):
            assert B.default_backend() == "v3"
        assert B.resolve_backend(p, "v1").name == "v1"   # explicit wins
    assert B.default_backend() == "auto"
    try:
        B.set_default_backend("v1")
        assert B.resolve_backend(p).name == "v1"
        with pytest.raises(KeyError):
            B.set_default_backend("nope")
        with pytest.raises(KeyError):
            with B.use_backend("nope"):
                pass
    finally:
        B.set_default_backend("auto")


# --------------------------------------------- decode kernel, block size
@pytest.mark.parametrize("mode", ["auto", "on", "off", "1", "never"])
def test_decode_kernel_rule_matches_reference(monkeypatch, mode):
    monkeypatch.setenv("SME_DECODE_KERNEL", mode)
    for bm in (64, 128, 256):
        for m in (1, 8, 32, 63, 64, 65, 100, 128, 129, 256, 512):
            assert B._use_decode_kernel(m, bm) == RB._use_decode_kernel(m,
                                                                        bm)


def _paths(m, depth=None, bm=None):
    """Which v3 kernel(s) one ``sme_apply`` of M rows takes, and its
    output."""
    import repro_torch.kernels.sme_spmm.sme_spmm_planes as pre
    import repro_torch.kernels.sme_spmm.sme_spmm_planes_decode as dec
    seen = []

    def spy(name, fn):
        def call(*a, **kw):
            seen.append(name)
            return fn(*a, **kw)
        return call
    x = torch.as_tensor(np.random.default_rng(m).standard_normal((m, 256)),
                        dtype=torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dec, "sme_spmm_planes_decode",
                   spy("decode", dec.sme_spmm_planes_decode))
        mp.setattr(pre, "sme_spmm_planes", spy("prefill", pre.sme_spmm_planes))
        with B.use_block(bm), B.use_spec_depth(depth):
            y = B.sme_apply(x, _packed(1), "v3")
    return seen, y


@pytest.mark.parametrize("mode,m,depth,bm,want", [
    ("auto", 8, None, None, "decode"), ("auto", 100, None, None, "prefill"),
    ("on", 100, None, None, "decode"), ("on", 200, None, None, "prefill"),
    ("off", 8, None, None, "prefill"),
    # the draft override: truncation needs the decode kernel, while M fits
    ("auto", 100, 2, None, "decode"), ("off", 8, 2, None, "prefill"),
    ("auto", 200, 2, None, "prefill"),
    # --bm moves the threshold: 2 * 100 <= 256
    ("auto", 100, None, 256, "decode"), ("auto", 40, None, 64, "prefill")])
def test_decode_kernel_dispatch(monkeypatch, mode, m, depth, bm, want):
    monkeypatch.setenv("SME_DECODE_KERNEL", mode)
    seen, y = _paths(m, depth, bm)
    assert seen == [want]
    if want == "prefill" and depth is not None:
        # past the decode kernel a draft is the exact product
        assert torch.equal(y, _paths(m)[1])


def test_resolve_block_m_matches_reference(monkeypatch):
    for env in (None, "64", "x"):
        if env is None:
            monkeypatch.delenv("SME_BM", raising=False)
        else:
            monkeypatch.setenv("SME_BM", env)
        for bm in (None, 256):
            with B.use_block(bm), RB.use_block(bm):
                assert B.resolve_block_m("v3", 8, 256, 256) \
                    == RB.resolve_block_m("v3", 8, 256, 256)
    monkeypatch.delenv("SME_BM", raising=False)
    assert B.resolve_block_m() == 128


def test_launcher_bm_reaches_every_model_call(monkeypatch, capsys):
    """9 requests in 9 slots prefill in one window of M = 9 x 8 = 72 rows:
    the prefill kernel at the default bm (2 * 72 > 128), the decode kernel
    under ``--bm 512``; the tokens are the default's."""
    from repro_torch.launch import serve
    import repro_torch.kernels.sme_spmm.sme_spmm_planes as pre
    calls = []
    real = pre.sme_spmm_planes

    def spy(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)
    monkeypatch.setattr(pre, "sme_spmm_planes", spy)

    def tokens(argv):
        stats = serve.main(argv + ["--requests", "9", "--slots", "9"])
        assert stats["completed"] == 9
        return [line for line in capsys.readouterr().out.splitlines()
                if line.startswith("req ")]
    base = tokens(SERVE)
    assert calls == [128] * 14         # one window: 2 layers x 7 linears
    calls.clear()
    assert tokens(SERVE + ["--bm", "512"]) == base
    assert not calls
