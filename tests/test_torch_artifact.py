"""``.smez`` artifacts across the two packages, and what the port boots from
them: the port's and the reference's ``compile_model`` write the same
manifest (every payload's sha256, the plan, the extras) for the same tree;
a reference-written artifact served by ``ServeEngine.from_artifact`` gives
the reference model-API greedy loop's tokens (the reference engine is red,
ROADMAP R1), a v3 one also with ``spec_depth="auto"`` drafting each layer
at its plan depth; a port-written artifact loads in the reference; the
version and corruption gates; ``validate_operands`` refusing each kind of
malformed list; ``ensure_operands`` and auto's pack-once cache; and the
launchers' ``--artifact`` and ``--spec-depth auto``."""
import copy
import gc
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.compiler import compile_model as ref_compile
from repro.compiler import load_artifact as ref_load
from repro.core.backend import use_backend
from repro_torch.compiler import (compile_model, load_artifact, read_manifest,
                                  save_artifact, verify_artifact)
from repro_torch.convert import to_reference
from repro_torch.core import backend as B
from repro_torch.core.integrate import pack_sme_param, to_torch
from repro_torch.core.sme import sme_compress
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _prompt_bucket

from _torch_small import small_models

ROOT = pathlib.Path(__file__).resolve().parents[1]
LENS, MAX_NEW, S_MAX = (33, 20, 9), 4, 96
EXTRA = {"arch": "qwen1.5-0.5b", "config": "small", "serve_backend": "auto"}


@pytest.fixture(scope="module")
def m():
    return small_models(backend=None)


@pytest.fixture(scope="module")
def smez(m, tmp_path_factory):
    """{backend: (reference artifact, port artifact)} of the small tree."""
    root = tmp_path_factory.mktemp("smez")
    out = {}
    for backend in ("auto", "v3"):
        ref, port = root / f"ref-{backend}.smez", root / f"port-{backend}.smez"
        ref_compile(m.dense, out=ref, backend=backend, error_budget=0.06,
                    extra=EXTRA)
        compile_model(m.dense, out=port, backend=backend, error_budget=0.06,
                      extra=EXTRA)
        out[backend] = ref, port
    return out


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, n) for n in LENS]


def _reference_greedy(m, params, backend):
    """One ragged prefill, then per-row decode steps, on the reference
    model API under ``backend``."""
    toks = np.zeros((len(LENS), _prompt_bucket(max(LENS), S_MAX)), np.int32)
    for i, p in enumerate(_prompts()):
        toks[i, :len(p)] = p
    plen = np.array(LENS, np.int32)
    with use_backend(backend):
        logits, caches = m.api.prefill(params, {"tokens": toks},
                                       s_max=S_MAX, plen=plen)
        out = [np.asarray(logits).argmax(-1)]
        for step in range(MAX_NEW - 1):
            logits, caches = m.api.decode_step(
                params, out[-1][:, None].astype(np.int32), caches,
                plen + step)
            out.append(np.asarray(logits).argmax(-1))
    return np.stack(out, 1).tolist()


def _port_tokens(eng):
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    stats = eng.run(reqs, max_steps=80)
    assert stats["completed"] == len(reqs)
    return [r.out_tokens for r in reqs]


# ------------------------------------------------------------- manifests
@pytest.mark.parametrize("backend", ["auto", "v3"])
def test_port_and_reference_write_the_same_artifact(smez, backend):
    ref, port = (read_manifest(p) for p in smez[backend])
    assert port["arrays"] == ref["arrays"]          # file, shape, dtype, sha
    assert port["plan"] == ref["plan"] and port["extra"] == ref["extra"]
    assert port["tree"] == ref["tree"]
    assert port["format_version"] == ref["format_version"] == 2
    assert (pathlib.Path(smez[backend][1]) / "manifest.json").read_text() \
        == (pathlib.Path(smez[backend][0]) / "manifest.json").read_text()


def test_port_artifact_loads_in_the_reference(m, smez):
    _, port = smez["v3"]
    rp, rplan, _ = ref_load(port, verify=True)
    pp, pplan, _ = load_artifact(port, verify=True)
    assert rplan.to_json() == pplan.to_json()
    flat_r = jax.tree_util.tree_leaves_with_path(rp)
    flat_p = jax.tree_util.tree_leaves_with_path(pp)
    assert len(flat_r) == len(flat_p)
    for (kr, a), (kp, b) in zip(flat_r, flat_p):
        assert kr == kp and a.dtype == b.dtype and np.array_equal(a, b)
    draft = rp["blocks"]["slot0"]["mlp"]["wi"]["w"]["sme_draft_planes"]
    assert draft.shape == (2,) and (draft > 0).all()


# ----------------------------------------------------- serving from a .smez
@pytest.mark.parametrize("backend", ["auto", "v3"])
def test_reference_artifact_serves_reference_tokens(m, smez, backend):
    ref_path, _ = smez[backend]
    params, _, _ = ref_load(ref_path)
    want = _reference_greedy(m, jax.tree.map(np.asarray, params), "auto")
    eng = ServeEngine.from_artifact(m.port_api, ref_path, slots=3,
                                    s_max=S_MAX, device="cpu",
                                    chunk_len=S_MAX)
    assert eng.backend == "auto" and eng.plan is not None
    assert eng.stats["backend"] == ("v2" if backend == "auto" else "v3")
    assert _port_tokens(eng) == want


def test_spec_depth_auto_drafts_at_each_layers_plan_depth(m, smez,
                                                          monkeypatch):
    """F1: a v3 artifact's ``sme_draft_planes`` reach every draft dispatch
    (never ``None``: a full-precision draft), and the tokens stay the
    reference loop's."""
    ref_path, _ = smez["v3"]
    params, plan, _ = ref_load(ref_path)
    want = _reference_greedy(m, jax.tree.map(np.asarray, params), "v3")
    seen, real = [], B.resolve_spec_depth

    def spy(param=None, plane_depth=None):
        got = real(param, plane_depth)
        if B._spec_stack[-1] is not None:
            seen.append((got, int(param["sme_draft_planes"])))
        return got
    monkeypatch.setattr(B, "resolve_spec_depth", spy)
    eng = ServeEngine.from_artifact(m.port_api, ref_path, slots=3,
                                    s_max=S_MAX, device="cpu",
                                    chunk_len=S_MAX, spec_depth="auto")
    assert _port_tokens(eng) == want
    rounds = int(eng._m["spec_rounds"].value)
    assert rounds > 0
    assert len(seen) == rounds * eng.spec_len * 7 * m.cfg.n_layers
    assert all(got == depth and got > 0 for got, depth in seen)
    assert {d for _, d in seen} == {lp.draft_planes
                                    for lp in plan.layers.values()}


def test_from_artifact_packs_a_missing_kernel_backend(m, tmp_path):
    path = tmp_path / "none.smez"
    compile_model(m.dense, out=path, backend=None,
                  extra={"serve_backend": None})
    eng = ServeEngine.from_artifact(m.port_api, path, slots=3, s_max=S_MAX,
                                    device="cpu", chunk_len=S_MAX,
                                    backend="v1")
    w = eng.params["blocks"][1]["mlp"]["wo"]["w"]
    assert B.get_backend("v1").has_operands(w)
    assert eng.stats["backend"] == "v1"
    dense = ServeEngine.from_artifact(m.port_api, path, slots=3, s_max=S_MAX,
                                      device="cpu", chunk_len=S_MAX)
    assert dense.stats["backend"] == "torch"        # auto on the CPU
    assert _port_tokens(eng) == _port_tokens(dense)


# ------------------------------------------------------------------ gates
def test_version_corruption_and_operand_gates(m, tmp_path):
    path = save_artifact(tmp_path / "v.smez", {"w": np.arange(4.0)})
    text = (path / "manifest.json").read_text()
    (path / "manifest.json").write_text(
        text.replace('"format_version": 2', '"format_version": 999'))
    with pytest.raises(ValueError, match="newer"):
        read_manifest(path)
    (path / "manifest.json").write_text(text)
    fname = next(iter(read_manifest(path)["arrays"].values()))["file"]
    raw = bytearray((path / "payload" / fname).read_bytes())
    raw[-1] ^= 0xFF
    (path / "payload" / fname).write_bytes(bytes(raw))
    load_artifact(path)                      # lazy: no hashing
    with pytest.raises(ValueError, match="sha256"):
        load_artifact(path, verify=True)
    with pytest.raises(ValueError, match="sha256"):
        verify_artifact(path)
    # a foreign list (rowid past the row tiles) is refused on load
    packed, _ = compile_model(m.dense, backend="v1")
    bad = copy.deepcopy(packed)
    bad["blocks"]["slot0"]["mix"]["q"]["w"]["sme_v1_rowid"][1, 0, 0] = 7
    save_artifact(tmp_path / "bad.smez", bad)
    with pytest.raises(ValueError, match="rowid"):
        load_artifact(tmp_path / "bad.smez")


def _param(shape=(384, 256), backend="all", squeeze=1):
    rng = np.random.default_rng(8)
    return pack_sme_param(rng.normal(0, 0.05, shape), squeeze=squeeze,
                          backend=backend)


def _bad_v1_groups(p):
    """More slots than row tiles listed in a column (L padded to 5)."""
    smew = sme_compress(np.random.default_rng(8).normal(0, 0.05, (384, 256)))
    ops = smew.pack_csc(pad_to=5)
    ops["rowid"][0, :4] = [0, 1, 2, 0]
    ops["nnz"][0] = 4
    p.update({f"sme_v1_{k}": v for k, v in ops.items()})


def _bad_v2_groups(p):
    """v2's lists with more slots than row tiles in a column (L padded to
    5)."""
    from repro_torch.core.backend import get_backend
    smew = sme_compress(np.random.default_rng(8).normal(0, 0.05, (384, 256)))
    ops = get_backend("v2").pack_weight(smew, pad_to=5)
    ops["rowid"][0, :4] = [0, 1, 2, 0]
    ops["nnz"][0] = 4
    p.update({f"sme_v2_{k}": v for k, v in ops.items()})


def _first_inner(p):
    """A v3 slot inside a group (its predecessor's last == 0)."""
    j, l = np.argwhere(p["sme_v3_last"][:, :-1] == 0)[0]
    return j, l + 1


def _bump_row(p):
    j, l = _first_inner(p)
    p["sme_v3_rowid"][j, l] = (p["sme_v3_rowid"][j, l] + 1) % 3


def _deep_group(p):
    n = p["sme_v3_nnz"][0]
    assert n > 16
    p["sme_v3_rowid"][0, :n] = 0
    p["sme_v3_last"][0, :n] = 0
    p["sme_v3_last"][0, n - 1] = 1


MALFORMED = {
    "v1 nnz > L": ("v1", lambda p: p["sme_v1_nnz"].__setitem__(
        0, p["sme_v1_rowid"].shape[1] + 1), "outside"),
    "v2 nnz < 0": ("v2", lambda p: p["sme_v2_nnz"].__setitem__(0, -1),
                   "outside"),
    "v3 nnz > L": ("v3", lambda p: p["sme_v3_nnz"].__setitem__(
        1, p["sme_v3_rowid"].shape[1] + 1), "outside"),
    "v1 rowid past the row tiles": (
        "v1", lambda p: p["sme_v1_rowid"].__setitem__((0, 0), 3), "rowid"),
    "v2 rowid past the row tiles": (
        "v2", lambda p: p["sme_v2_rowid"].__setitem__((1, 0), 9), "rowid"),
    "v3 rowid negative": (
        "v3", lambda p: p["sme_v3_rowid"].__setitem__((0, 0), -1), "rowid"),
    "v1 more groups than row tiles": ("v1", _bad_v1_groups, "tile groups"),
    "v3 more groups than row tiles": (
        "v3", lambda p: p["sme_v3_last"].__setitem__(
            slice(None), 1), "tile groups"),
    "v3 last flag 2": (
        "v3", lambda p: p["sme_v3_last"].__setitem__((0, 0), 2), "last"),
    "v3 open final group": (
        "v3", lambda p: p["sme_v3_last"].__setitem__(
            (0, p["sme_v3_nnz"][0] - 1), 0), "not closed"),
    "v3 group spans two row tiles": ("v3", _bump_row, "spans"),
    "v3 shift 16": (
        "v3", lambda p: p["sme_v3_shift"].__setitem__((0, 0), 16), "shift"),
    "v3 group deeper than 16 planes": ("v3", _deep_group, "planes"),
    # each condition that reaches a kernel's __trap() for every format
    # that can carry it: nnz out of range (the walks' list scan), a group
    # count past what the launch holds (decode_walk's cluster)
    "v1 nnz < 0": ("v1", lambda p: p["sme_v1_nnz"].__setitem__(1, -2),
                   "outside"),
    "v2 nnz > L": ("v2", lambda p: p["sme_v2_nnz"].__setitem__(
        0, p["sme_v2_rowid"].shape[1] + 1), "outside"),
    "v3 nnz < 0": ("v3", lambda p: p["sme_v3_nnz"].__setitem__(0, -1),
                   "outside"),
    "v2 more groups than row tiles": ("v2", _bad_v2_groups, "tile groups"),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_validate_operands_rejects_malformed_lists(case):
    backend, mutate, match = MALFORMED[case]
    good = _param()
    for name in ("v1", "v2", "v3"):
        B.validate_operands(good, name)
    bad = copy.deepcopy(good)
    mutate(bad)
    with pytest.raises(ValueError, match=match):
        B.validate_operands(bad, backend)
    with pytest.raises(ValueError, match=match):
        B.ensure_operands({"w": to_torch(bad, "cpu")}, backend)


def test_ensure_operands_packs_once_and_checks():
    """Packed at boot from the codes, byte-equal to offline packing, for
    stacked params too; auto takes v2 where minifloat-6 holds the settings
    and v1 where it cannot (squeeze 0)."""
    full = _param()
    bare = {k: v for k, v in full.items()
            if not k.startswith(("sme_v1", "sme_v2", "sme_v3"))}
    for name in ("v1", "v2", "v3"):
        got = B.ensure_operands({"w": to_torch(bare, "cpu")}, name)["w"]
        for k in full:
            if k.startswith(f"sme_{name}_"):
                assert np.array_equal(got[k].numpy(), full[k]), k
    assert B.ensure_operands({"w": bare}, "torch")["w"] is bare
    auto = B.ensure_operands({"a": bare, "b": _param(backend=None,
                                                     squeeze=0)}, "auto")
    assert B.resolve_backend(auto["a"]).name == "v2"
    assert B.resolve_backend(auto["b"]).name == "v1"
    stacked = {k: np.stack([v, v]) for k, v in bare.items()}
    ops = B.pack_param_operands(stacked, B.get_backend("v3"))
    assert ops["planes"].shape[0] == 2
    assert np.array_equal(ops["planes"][1], full["sme_v3_planes"])


def test_auto_operand_cache_packs_once_and_dies_with_the_weight():
    p = to_torch(_param(backend=None), "cpu")
    assert B.resolve_backend(p, "auto").name == "torch"   # the CPU: dense
    v2 = B.get_backend("v2")
    ops = B._cached_operands(p, v2)
    assert B._cached_operands(p, v2) is ops
    assert B._auto_kernel(p).name == "v2"
    n = len(B._OPERAND_CACHE)
    del p
    gc.collect()
    assert len(B._OPERAND_CACHE) == n - 1


def test_to_reference_inverts_from_reference(m):
    back = to_reference(m.port_dense)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(m.dense)
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -------------------------------------------------------------- launchers
def test_compile_then_serve_launchers_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = tmp_path / "cli.smez"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.compile", "--small",
         "--backend", "v3", "--out", str(out), "--verify"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "crossbar_reduction=" in proc.stdout and "verified" in proc.stdout
    from repro_torch.launch import serve
    stats = serve.main(["--small", "--device", "cpu", "--artifact", str(out),
                        "--spec-depth", "auto", "--requests", "2",
                        "--max-new", "4", "--slots", "2", "--s-max", "32"])
    assert stats["completed"] == 2 and stats["backend"] == "v3"
    with pytest.raises(SystemExit, match="dims do not match"):
        serve.main(["--small", "--d-model", "256", "--device", "cpu",
                    "--artifact", str(out)])


def test_spec_depth_auto_plans_v3_and_refuses_the_rest(monkeypatch, capsys):
    from repro_torch.launch import serve
    seen, real = [], B.resolve_spec_depth

    def spy(param=None, plane_depth=None):
        got = real(param, plane_depth)
        if B._spec_stack[-1] == "plan":
            seen.append(got)
        return got
    monkeypatch.setattr(B, "resolve_spec_depth", spy)
    stats = serve.main(["--small", "--device", "cpu", "--sme", "--backend",
                        "v3", "--spec-depth", "auto", "--requests", "2",
                        "--max-new", "5", "--slots", "2", "--s-max", "32"])
    assert stats["completed"] == 2
    assert "draft depths per layer from the plan" in capsys.readouterr().out
    assert seen and all(isinstance(d, int) and d > 0 for d in seen)
    for argv in (["--sme", "--backend", "v2"], ["--sme"], []):
        with pytest.raises(SystemExit, match="spec-depth auto"):
            serve.main(["--small", "--device", "cpu", "--spec-depth", "auto",
                        "--requests", "1", "--max-new", "2", *argv])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_reference_moe_artifact_serves_reference_tokens(arch, tmp_path):
    """A reference-written ``.smez`` of a small MoE tree (stacked expert
    leaves, deepseek's ``first0``) boots through ``from_artifact`` and
    serves the reference model-API loop's greedy tokens (one-shot, as the
    loop; the loop on the reference's ``xla`` backend)."""
    from _torch_small import family_models
    fm = family_models(arch, d_model=128, expert_dff=128, dtype="float32")
    path = tmp_path / "moe.smez"
    ref_compile(fm.dense, out=path, backend="v3", error_budget=0.06,
                extra=dict(EXTRA, arch=arch))
    params, plan, _ = ref_load(path)
    assert any(k.startswith("blocks/slot0/mlp/w") for k in plan.layers)
    want = _reference_greedy(fm, jax.tree.map(np.asarray, params), "xla")
    eng = ServeEngine.from_artifact(fm.port_api, path, slots=3, s_max=S_MAX,
                                    device="cpu", chunk_len=S_MAX)
    assert eng.stats["backend"] == "v3"
    wi = eng.params["blocks"][0]["mlp"]["wi"]
    assert tuple(wi["sme_codes"].shape[:1]) == (4,)
    assert _port_tokens(eng) == want


def test_reference_xlstm_artifact_serves_reference_tokens(tmp_path):
    """A reference-written ``.smez`` of a small xlstm-1.3b tree (no MLP
    half, 3-D q/k/v and r leaves dense, every projection packed) boots
    through ``from_artifact`` and serves the reference model-API loop's
    greedy tokens (one-shot: mLSTM's chunkwise prefill, then its
    recurrent decode)."""
    import types
    from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_sd
    from repro.models import build_model as ref_build
    from repro_torch.configs import ARCHS, scale_down
    from repro_torch.models.model import build_model
    from _torch_small import RECURRENT
    over = RECURRENT["xlstm-1.3b"]
    api = ref_build(ref_sd(REF_ARCHS["xlstm-1.3b"], **over))
    dense = jax.tree.map(np.asarray, api.init_params(jax.random.key(3)))
    dense["embed"]["w"] = dense["embed"]["w"] * np.float32(0.05)
    path = tmp_path / "xlstm.smez"
    ref_compile(dense, out=path, backend="v3", error_budget=0.06,
                extra=dict(EXTRA, arch="xlstm-1.3b"))
    params, plan, _ = ref_load(path)
    assert "blocks/slot0/mix/up/w" in plan.layers
    assert "blocks/slot7/mix/ff_wi/w" in plan.layers
    want = _reference_greedy(types.SimpleNamespace(api=api),
                             jax.tree.map(np.asarray, params), "xla")
    port_api = build_model(scale_down(ARCHS["xlstm-1.3b"], **over),
                           device="cpu")
    eng = ServeEngine.from_artifact(port_api, path, slots=3, s_max=S_MAX,
                                    device="cpu", chunk_len=S_MAX)
    assert eng.stats["backend"] == "v3"
    assert "mlp" not in eng.params["blocks"][0]
    assert _port_tokens(eng) == want
