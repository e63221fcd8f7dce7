"""The port's offline compiler against the reference's: ``plan_model``'s
``CompilePlan.to_json()`` byte-equal on the same numpy tree (every backend,
both measures, both objectives, a measured autotune cache), the row
reordering's permutations and gains at both levels, every quantizer, the
draft depth rule, the format statistics the planner prices with, and the
packed tree ``convert_params_to_sme(plan=...)`` executes."""
import numpy as np
import pytest

from repro.compiler import plan as RPL
from repro.compiler import reorder as RR
from repro.core import integrate as RI
from repro.core import mapping as RM
from repro.core import quant as RQ
from repro.core import sme as RS
from repro.core import sparsity as RSP
from repro.hardware import autotune as RA
from repro.hardware import reram_model as RE
from repro_torch.compiler import plan as PPL
from repro_torch.compiler import reorder as PR
from repro_torch.core import integrate as PI
from repro_torch.core import mapping as PM
from repro_torch.core import quant as PQ
from repro_torch.core import sme as PS
from repro_torch.core import sparsity as PSP
from repro_torch.hardware import autotune as PA
from repro_torch.hardware import reram_model as PE


def structured_sparse(k=512, n=512, seed=7):
    """Rows alternate between two disjoint column supports: every tile is
    occupied as laid out, half empty once rows are clustered."""
    rng = np.random.default_rng(seed)
    w = np.zeros((k, n))
    vals = rng.normal(0, 0.05, (k, n))
    w[0::2, : n // 2] = vals[0::2, : n // 2]
    w[1::2, n // 2:] = vals[1::2, n // 2:]
    return w


def tree():
    """``tests/test_compiler.py``'s 256x256 and 256x384 leaves, a stacked
    [2, 256, 384] leaf (planned on slice 0, never reordered) and the
    structured-sparse matrix (the one reordering frees tiles of)."""
    rng = np.random.default_rng(0)
    return {"l0": {"w": rng.normal(0, 0.05, (256, 256))},
            "l1": {"w": rng.normal(0, 0.05, (256, 384))},
            "moe": {"wi": rng.normal(0, 0.05, (2, 256, 384))},
            "structured": {"w": structured_sparse()},
            "tiny": {"w": rng.normal(0, 0.05, (64, 64))},
            "bias": {"b": rng.normal(0, 0.05, (256,))}}


TREE = tree()


def _caches():
    """One hand-written autotune cache per package, its entries under that
    package's own device kind: v1 measured fastest at 256x256, v3 at
    256x384, v2 slowest, two block sizes each."""
    out = []
    for mod in (RA, PA):
        cache, dev = mod.AutotuneCache(), mod.device_kind()
        for (k, n), us in {(256, 256): {"v1": 9.0, "v2": 30.0, "v3": 14.0},
                           (256, 384): {"v1": 20.0, "v2": 31.0,
                                        "v3": 11.0}}.items():
            for be, t in us.items():
                for bm, f in ((128, 1.0), (64, 1.5)):
                    cache.record(mod.TuneKey(be, 1, k, n, bm, dev), t * f)
        out.append(cache)
    return out


@pytest.mark.parametrize("kw", [
    dict(backend="auto"), dict(backend="v1"), dict(backend="v3"),
    dict(backend=None), dict(backend="auto", measure="analytic"),
    dict(backend="auto", objective="energy"),
    dict(backend="v3", objective="energy", reorder=False),
    dict(backend="auto", autotune="cache")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_plan_json_byte_equal_to_reference(kw):
    kw = dict(kw)
    ref_kw, port_kw = dict(kw), dict(kw)
    if kw.get("autotune") == "cache":
        ref_kw["autotune"], port_kw["autotune"] = _caches()
    ref = RPL.plan_model(TREE, error_budget=0.06, **ref_kw)
    port = PPL.plan_model(TREE, error_budget=0.06, **port_kw)
    assert port.to_json() == ref.to_json()
    assert PPL.CompilePlan.from_json(port.to_json()).to_json() \
        == port.to_json()
    if kw.get("autotune"):
        # the measured times steer the backend and record the best bm
        # where the cache holds the shape; the 512x512 leaf prices by bytes
        got = {k: (lp.backend, lp.bm) for k, lp in port.layers.items()}
        assert got == {"l0/w": ("v1", 128), "l1/w": ("v3", 128),
                       "moe/wi": ("v3", 128), "structured/w": ("v2", 0)}


def test_plan_version_gate_and_budget_floor():
    plan = PPL.plan_model(TREE, error_budget=0.0)
    bumped = plan.to_json().replace('"version": 4', '"version": 999')
    with pytest.raises(ValueError, match="newer"):
        PPL.CompilePlan.from_json(bumped)
    assert set(plan.layers) == {"l0/w", "l1/w", "moe/wi", "structured/w"}
    assert plan.layers["moe/wi"].n_slices == 2
    assert not plan.layers["moe/wi"].reorder
    assert plan.layers["structured/w"].reorder
    assert plan.summary() == RPL.plan_model(TREE, error_budget=0.0).summary()


@pytest.mark.parametrize("level", ["tile", "plane"])
@pytest.mark.parametrize("w", [structured_sparse(), structured_sparse(300, 260),
                               np.random.default_rng(2).normal(0, 0.05,
                                                               (384, 256))],
                         ids=["structured", "ragged", "gaussian"])
def test_reorder_permutations_and_gains_equal(w, level):
    q = RQ.quantize(w, "sme", 8, 3)
    perm_r = RR.permutation_from_codes(q.codes, level=level)
    perm_p = PR.permutation_from_codes(q.codes, level=level)
    assert perm_p.dtype == perm_r.dtype and np.array_equal(perm_p, perm_r)
    assert np.array_equal(
        PR.plan_row_permutation(w, level=level),
        RR.plan_row_permutation(w, level=level))
    assert PR.permutation_gain(q.codes) == RR.permutation_gain(q.codes)
    assert PR.plane_permutation_gain(q.codes) \
        == RR.plane_permutation_gain(q.codes)
    assert np.array_equal(PR.row_block_signature(q.codes),
                          RR.row_block_signature(q.codes))
    assert np.array_equal(PR.row_plane_signature(q.codes),
                          RR.row_plane_signature(q.codes))
    assert PR.occupied_tile_count(q.codes) == RR.occupied_tile_count(q.codes)
    assert PR.occupied_plane_tile_count(q.codes) \
        == RR.occupied_plane_tile_count(q.codes)


@pytest.mark.parametrize("method", ["sme", "int", "po2", "apt"])
@pytest.mark.parametrize("n_bits,window,axis", [(8, 3, None), (6, 2, None),
                                                (8, 4, 1), (10, 3, 0)])
def test_quantize_equals_reference(method, n_bits, window, axis):
    w = np.random.default_rng(3).normal(0, 0.05, (96, 80))
    w[5] = 0.0
    r = RQ.quantize(w, method, n_bits, window, channel_axis=axis)
    p = PQ.quantize(w, method, n_bits, window, channel_axis=axis)
    for name in ("codes", "signs", "scale"):
        a, b = getattr(r, name), getattr(p, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (p.n_bits, p.method, p.window) == (r.n_bits, r.method, r.window)
    assert np.array_equal(p.dequantize(), r.dequantize())
    assert PQ.quant_mse(w, p) == RQ.quant_mse(w, r)
    assert np.array_equal(PQ.code_value(p.codes, n_bits),
                          RQ.code_value(r.codes, n_bits))


@pytest.mark.parametrize("coverage", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("w,kw", [
    (np.random.default_rng(4).normal(0, 0.05, (256, 384)), {}),
    (np.random.default_rng(4).normal(0, 0.05, (256, 384)),
     dict(squeeze=1, squeeze_max=7)),
    (structured_sparse(), dict(n_bits=6, squeeze=2)),
    (np.zeros((128, 128)), {})], ids=["gauss", "deepened", "sparse6", "zero"])
def test_draft_depth_and_format_stats_equal(w, kw, coverage):
    r, p = RS.sme_compress(w, **kw), PS.sme_compress(w, **kw)
    assert PPL.draft_depth_from_occupancy(p, coverage) \
        == RPL.draft_depth_from_occupancy(r, coverage)
    sr, sp = RSP.plane_occupancy_stats(r), PSP.plane_occupancy_stats(p)
    assert sr.keys() == sp.keys()
    for key in sr:
        if key == "bytes_per_weight":
            np.testing.assert_array_equal(list(sp[key].values()),
                                          list(sr[key].values()))
        else:
            np.testing.assert_array_equal(sp[key], sr[key])
    nb = r.n_bits
    assert PM.conventional_crossbar_total(w.shape, nb) \
        == RM.conventional_crossbar_total(w.shape, nb)
    q = RQ.quantize(w, "sme", nb, 3)
    assert PM.sme_crossbar_count(q.codes, nb) \
        == RM.sme_crossbar_count(q.codes, nb)
    assert PM.conventional_crossbar_count(q.codes, nb, cell_bits=2) \
        == RM.conventional_crossbar_count(q.codes, nb, cell_bits=2)
    assert PSP.overall_bit_sparsity(PQ.quantize(w, "sme", nb, 3)) \
        == RSP.overall_bit_sparsity(q)


def test_error_bounds_and_energy_prices_equal():
    for nb, win, sq in ((8, 3, 0), (8, 2, 3), (6, 3, 1)):
        assert PPL.candidate_error_bound(nb, win, sq) \
            == RPL.candidate_error_bound(nb, win, sq)
    plan_r = RPL.plan_model(TREE, error_budget=0.06)
    plan_p = PPL.plan_model(TREE, error_budget=0.06)
    assert PE.summarize_plan(PE.ReRAMConfig(), plan_p) \
        == RE.summarize_plan(RE.ReRAMConfig(), plan_r)


@pytest.mark.parametrize("backend", ["auto", "v3"])
def test_planned_conversion_byte_equal(backend):
    """``convert_params_to_sme(plan=...)``: the plan's settings, backend,
    2-D reordering (``sme_perm``) and ``sme_draft_planes``, byte for byte,
    each weight compressed once."""
    plan = PPL.plan_model(TREE, error_budget=0.06, backend=backend)
    ref = RI.convert_params_to_sme(TREE, plan=plan)
    port = PI._convert(TREE, plan=plan)
    for name in ("l0", "l1", "moe", "structured"):
        key = "wi" if name == "moe" else "w"
        r, p = ref[name][key], port[name][key]
        assert sorted(r) == sorted(p), name
        for leaf in r:
            a = np.asarray(r[leaf])
            assert a.dtype == p[leaf].dtype and np.array_equal(a, p[leaf]), \
                (name, leaf)
    assert "sme_perm" in port["structured"]["w"]
    if backend == "v3":
        assert port["moe"]["wi"]["sme_draft_planes"].shape == (2,)
    assert not isinstance(port["tiny"]["w"], dict)
