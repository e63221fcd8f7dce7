"""The tile-CSC formats of the port (v1 bytecode, v2 minifloat-6) against
the reference: byte-identical operands (``pack_csc``, v2's one-pass
gather, ``convert_params_to_sme(backend="all")``), the plain versions of
``sme_spmm``/``sme_spmm6`` against the reference Pallas kernels in
interpret mode and the f64 oracle, v1 == v2 == v3 bitwise through
``sme_apply``, empty column tiles, ``auto`` resolution, the M padding, the
numpy oracles, the kernel-level ``ops`` wrappers and the storage summary.

Tolerances: the port's plain versions and the reference kernels both sum
in f32, one matmul per tile in the same list order, so they agree to f32
rounding of the per-tile dots (1e-6 of the output's max); both stay
within the DESIGN.md §5 bound of 5e-5 relative to the f64 oracle.  The
formats agree bitwise with each other (their decoded tiles are equal up
to a power of two, and the walk is the same)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as RB
from repro.core import integrate as R
from repro.core.sme import csc_tile_order as ref_tile_order
from repro.core.sme import sme_compress as ref_compress
from repro.kernels.sme_spmm import ops as ref_ops
from repro.kernels.sme_spmm import ref as ref_oracle
from repro.kernels.sme_spmm.sme_spmm import sme_spmm as ref_spmm
from repro.kernels.sme_spmm.sme_spmm6 import sme_spmm6 as ref_spmm6
from repro_torch.core import backend as PB
from repro_torch.core import integrate as P
from repro_torch.core.sme import csc_tile_order, sme_compress
from repro_torch.kernels.sme_spmm import ops, ref
from repro_torch.kernels.sme_spmm.sme_spmm import sme_spmm, sme_spmm_plain
from repro_torch.kernels.sme_spmm.sme_spmm6 import sme_spmm6

GRID = [(8, 3, 0, None), (8, 3, 1, None), (8, 3, 2, None), (8, 2, 1, None),
        (8, 4, 0, None), (6, 3, 1, None), (6, 2, 2, None),
        (8, 3, 1, 7), (8, 2, 1, 6), (6, 3, 1, 5)]
IDS = [f"nb{a}w{b}sq{c}" + (f"max{d}" if d else "") for a, b, c, d in GRID]
V2_GRID = [(g, i) for g, i in zip(GRID, IDS)
           if PB.SpmmV2Backend.supports_settings(*g[:3])]
SETTINGS = [dict(n_bits=8, window=3, squeeze=1),
            dict(n_bits=8, window=3, squeeze=1, squeeze_max=7),
            dict(n_bits=6, window=2, squeeze=2)]
V1 = ("codes", "sign", "rowscale", "rowid", "nnz")
V2 = ("packed", "rowscale", "rowid", "nnz")


def _weight(seed, shape=(384, 256), prune=0.5):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, shape)
    w[np.abs(w) < np.quantile(np.abs(w), prune)] = 0.0
    return w


def _pruned(seed=7):
    """Empty tiles, and column tile 1 empty: nnz = [2, 0, 1]."""
    w = _weight(seed, (384, 384))
    w[:, 128:256] = 0.0
    w[256:, :128] = 0.0
    w[:256, 256:] = 0.0
    return w


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert (a == b).all(), what


def _close(a, b, rel=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30), \
        np.abs(a - b).max()


def _oracle_rel(y, x, smew):
    want = x.astype(np.float64) @ smew.dequant()
    return np.abs(np.asarray(y, np.float64)[:, :want.shape[1]] - want).max() \
        / np.abs(want).max()


def _pad(x, mp, kp):
    out = np.zeros((mp, kp), np.float32)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _t(ops_np, names):
    return [torch.from_numpy(ops_np[k]) for k in names]


# ------------------------------------------------------------- packing
@pytest.mark.parametrize("n_bits,window,squeeze,squeeze_max", GRID, ids=IDS)
def test_pack_csc_byte_identical(n_bits, window, squeeze, squeeze_max):
    kw = dict(n_bits=n_bits, window=window, squeeze=squeeze,
              squeeze_max=squeeze_max)
    w = _weight(3, (300, 260))
    w[:100] = 0.0                          # empty tiles, ragged nnz
    r, p = ref_compress(w, **kw), sme_compress(w, **kw)
    for got, want in zip(csc_tile_order(p.occupancy),
                         ref_tile_order(r.occupancy)):
        _same(want, got, "csc_tile_order")
    for pad_to in (None, 4):
        rops, pops = r.pack_csc(pad_to=pad_to), p.pack_csc(pad_to=pad_to)
        assert set(rops) == set(pops)
        for op in rops:
            _same(rops[op], pops[op], op)
    with pytest.raises(ValueError, match="pad_to"):
        p.pack_csc(pad_to=1)


@pytest.mark.parametrize("setting", [g for g, _ in V2_GRID],
                         ids=[i for _, i in V2_GRID])
def test_v2_pack_weight_byte_identical(setting):
    n_bits, window, squeeze, squeeze_max = setting
    kw = dict(n_bits=n_bits, window=window, squeeze=squeeze,
              squeeze_max=squeeze_max)
    w = _pruned()
    r, p = ref_compress(w, **kw), sme_compress(w, **kw)
    rb, pb = RB.get_backend("v2"), PB.get_backend("v2")
    assert rb.pad_hint(r) == pb.pad_hint(p)
    for pad_to in (None, 3):
        rops, pops = rb.pack_weight(r, pad_to=pad_to), \
            pb.pack_weight(p, pad_to=pad_to)
        assert set(rops) == set(pops)
        for op in rops:
            _same(rops[op], pops[op], op)
    with pytest.raises(ValueError, match="pad_to"):
        pb.pack_weight(p, pad_to=1)


def _layer(seed, d=128, ff=256):
    rng = np.random.default_rng(seed)
    lin = lambda *s: {"w": rng.normal(0, s[-2] ** -0.5, s).astype(np.float32)}
    wo = lin(2, ff, d)
    wo["w"][1, :128] = 0.0                 # stacked slices differ in L
    return {"norm1": {"w": np.ones(d, np.float32)},
            "mix": {"q": lin(d, d), "o": lin(d, d)},
            "mlp": {"wi": lin(d, ff), "wg": lin(d, ff), "wo": wo},
            "embed": {"w": rng.normal(0, 1, (256, d)).astype(np.float32)}}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_convert_all_byte_identical_and_storage_summary():
    tree = _layer(0)
    ref = R.convert_params_to_sme(tree, squeeze=1, backend="all")
    port = P.convert_params_to_sme(tree, squeeze=1, backend="all",
                                   device="cpu")
    ref_l, port_l = dict(_leaves(ref)), dict(_leaves(port))
    assert set(ref_l) == set(port_l)
    for path, leaf in ref_l.items():
        _same(leaf, port_l[path].numpy(), "/".join(path))
    wo = port["mlp"]["wo"]["w"]
    assert wo["sme_v1_codes"].shape[:3] == (2, 1, 2)   # lead, Nt, shared L
    assert {k.split("_")[1] for k in wo if k.count("_") > 1} >= \
        {"v1", "v2", "v3"}
    assert R.sme_storage_summary(ref) == P.sme_storage_summary(port)
    got = P.sme_operand_bytes(port)
    want = {"weights": sum(int(np.prod(l.shape)) for p, l in
                           _leaves(tree) if p[-1] == "w" and p[0] != "embed"
                           and l.ndim >= 2)}
    for be in ("v1", "v2", "v3"):
        want[be] = sum(l.nbytes for p, l in ref_l.items()
                       if p[-1].startswith(f"sme_{be}_"))
    assert got == want
    assert got["v2"] < got["v3"] < got["v1"]


def test_convert_names_what_it_packs():
    tree = {"mlp": {"wi": {"w": _weight(1, (128, 128))}}}
    for backend, names in ((None, set()), ("auto", set()), ("torch", set()),
                           ("v1", {"v1"}), ("v2", {"v2"}),
                           ("all", {"v1", "v2", "v3"})):
        p = P.convert_params_to_sme(tree, backend=backend, device="cpu")
        keys = p["mlp"]["wi"]["w"]
        assert {k.split("_")[1] for k in keys} - {"codes", "rowexp", "sign",
                                                  "scale", "nbits",
                                                  "squeezed", "window",
                                                  "tilesq"} == names
    with pytest.raises(ValueError, match="backend"):
        P.convert_params_to_sme(tree, backend="xla", device="cpu")
    with pytest.raises(ValueError, match="minifloat-6"):
        P.convert_params_to_sme(tree, backend="all", squeeze=0, device="cpu")


# --------------------------------------------------- plain vs reference
@pytest.mark.parametrize("kw", SETTINGS, ids=["sq1", "sqmax7", "nb6"])
def test_plain_v1_matches_reference_kernel(kw):
    smew = sme_compress(_weight(3), **kw)
    pk = smew.pack_csc()
    x = np.random.default_rng(4).normal(0, 1, (100, 384)).astype(np.float32)
    xp = _pad(x, 128, 384)
    want = np.asarray(ref_spmm(jnp.asarray(xp), *(jnp.asarray(pk[k])
                                                  for k in V1),
                               n_bits=0, bm=128, interpret=True))
    got = sme_spmm(torch.from_numpy(xp), *_t(pk, V1)).numpy()
    _close(got, want)
    scale = np.float32(smew.scale.reshape(-1)[0]) \
        * np.float32(2.0 ** -smew.n_bits)
    assert _oracle_rel(got[:100] * scale, x, smew) < 5e-5


@pytest.mark.parametrize("kw", SETTINGS, ids=["sq1", "sqmax7", "nb6"])
def test_plain_v2_matches_reference_kernel(kw):
    smew = sme_compress(_weight(3), **kw)
    pk = PB.get_backend("v2").pack_weight(smew)
    x = np.random.default_rng(4).normal(0, 1, (100, 384)).astype(np.float32)
    xp = _pad(x, 128, 384)
    want = np.asarray(ref_spmm6(jnp.asarray(xp), *(jnp.asarray(pk[k])
                                                   for k in V2),
                                squeezed=0, bm=128, interpret=True))
    got = sme_spmm6(torch.from_numpy(xp), *_t(pk, V2)).numpy()
    _close(got, want)
    scale = np.float32(smew.scale.reshape(-1)[0]) \
        * np.float32(2.0 ** -smew.squeezed)
    assert _oracle_rel(got[:100] * scale, x, smew) < 5e-5


# ------------------------------------------------------------ bitwise
def _all_params(w, **kw):
    names = ("v1", "v2", "v3") if PB.SpmmV2Backend.supports_settings(
        kw.get("n_bits", 8), kw.get("window", 3), kw.get("squeeze", 1)) \
        else ("v1", "v3")
    p = {}
    for name in names:
        p.update(P.pack_sme_param(w, backend=name, **kw))
    return P.to_torch(p, "cpu"), names


@pytest.mark.parametrize("n_bits,window,squeeze,squeeze_max", GRID, ids=IDS)
def test_sme_apply_v1_v2_v3_bitwise(n_bits, window, squeeze, squeeze_max):
    kw = dict(n_bits=n_bits, window=window, squeeze=squeeze,
              squeeze_max=squeeze_max)
    w = _weight(3, (200, 150))
    p, names = _all_params(w, **kw)
    smew = sme_compress(w, **kw)
    for m in (5, 70):
        x = torch.from_numpy(np.random.default_rng(m).normal(
            0, 1, (m, 200)).astype(np.float32))
        ys = {b: PB.sme_apply(x, p, b) for b in names}
        for b, y in ys.items():
            assert torch.equal(y, ys["v1"]), (b, m)
        assert _oracle_rel(ys["v1"].numpy(), x.numpy(), smew) < 5e-5


def test_empty_column_tile_is_exactly_zero():
    w = _pruned()
    smew = sme_compress(w, squeeze=1)
    assert smew.pack_csc()["nnz"].tolist() == [2, 0, 1]
    p, names = _all_params(w, squeeze=1)
    for m in (3, 130):
        x = torch.from_numpy(np.random.default_rng(m).normal(
            0, 1, (m, 384)).astype(np.float32))
        ys = [PB.sme_apply(x, p, b) for b in names]
        for y in ys:
            assert torch.equal(y, ys[0])
            assert (y[:, 128:256] == 0).all()
        assert _oracle_rel(ys[0].numpy(), x.numpy(), smew) < 5e-5


# ---------------------------------------------------- auto, M padding
def test_auto_resolution_matches_reference():
    w = _weight(2, (256, 128))
    full_ref = {k: jnp.asarray(v)
                for k, v in R.pack_sme_param(w, backend="all").items()}
    full_port = P.to_torch(P.pack_sme_param(w, backend="all"), "cpu")
    for r in range(4):
        for subset in itertools.combinations(("v1", "v2", "v3"), r):
            drop = [k for k in full_port if k.split("_")[1] in
                    {"v1", "v2", "v3"} - set(subset)]
            rp = {k: v for k, v in full_ref.items() if k not in drop}
            pp = {k: v for k, v in full_port.items() if k not in drop}
            want = RB.resolve_backend(rp, "auto").name
            for name in (None, "auto"):
                got = PB.resolve_backend(pp, name).name
                assert got == ("torch" if want == "xla" else want), subset
    assert PB.resolve_backend(None).name == "torch"
    assert PB.resolve_backend(full_port, "v1").name == "v1"
    with pytest.raises(KeyError, match="unknown SME backend"):
        PB.resolve_backend(full_port, "xla")


@pytest.mark.parametrize("m", [3, 100])
def test_m_padding_matches_reference(m):
    """The port pads M to a multiple of 8, the reference to 128: rows are
    independent, so both give the same rows."""
    w = _weight(5, (300, 200))
    ref_p = {k: jnp.asarray(v)
             for k, v in R.pack_sme_param(w, backend="all").items()}
    port_p = P.to_torch(P.pack_sme_param(w, backend="all"), "cpu")
    x = np.random.default_rng(m).normal(0, 1, (m, 300)).astype(np.float32)
    for b in ("v1", "v2"):
        want = np.asarray(RB.sme_apply(jnp.asarray(x), ref_p, b))
        _close(PB.sme_apply(torch.from_numpy(x), port_p, b).numpy(), want)
    pk = sme_compress(w).pack_csc()
    y8 = sme_spmm_plain(torch.from_numpy(_pad(x, -(-m // 8) * 8, 384)),
                        *_t(pk, V1))
    y128 = sme_spmm_plain(torch.from_numpy(_pad(x, 128, 384)), *_t(pk, V1))
    assert torch.equal(y8[:m], y128[:m])


# ------------------------------------------------- oracles and wrappers
def test_csc_oracle_matches_reference():
    smew = sme_compress(_pruned(), squeeze=1)
    pk = smew.pack_csc()
    x = np.random.default_rng(1).normal(0, 1, (4, 384))
    # jnp computes in f32 here; the values are exact in f32
    _same(np.asarray(ref_oracle.dequant_csc_jnp(pk, 8, 384), np.float64),
          ref.dequant_csc(pk, 8, 384), "dequant_csc")
    y = ref.sme_spmm_csc_ref(x, pk, 8)
    _close(y * smew.scale.reshape(-1)[0], x @ ref.dequant_ref(smew), 1e-12)
    _close(ref.sme_spmm_ref(x, smew), y, 1e-12)


def test_ops_wrappers_match_reference():
    w = _weight(8, (256, 256))
    smew, rsmew = sme_compress(w, squeeze=1), ref_compress(w, squeeze=1)
    x = np.random.default_rng(2).normal(0, 1, (3, 256)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for mine, theirs in ((ops.sme_linear_from_weight,
                          ref_ops.sme_linear_from_weight),
                         (ops.sme_linear6_from_weight,
                          ref_ops.sme_linear6_from_weight),
                         (ops.sme_linear_planes_from_weight,
                          ref_ops.sme_linear_planes_from_weight)):
        _close(mine(xt, smew).numpy(), np.asarray(theirs(xj, rsmew)))
    packed = ops.pack_operands(smew, device="cpu")
    y = ops.sme_linear(xt[None], packed, n_bits=8, shape=smew.shape,
                       out_dtype=torch.bfloat16)
    assert y.shape == (1, 3, 256) and y.dtype == torch.bfloat16
    assert set(ops.pack_operands6(smew, device="cpu")) == set(V2) | {"scale"}


def test_check_aligned_names_the_unaligned_operands():
    """The cluster and tiled kernels copy 16 bytes at a time: their
    wrappers refuse a tensor that does not start on a 16-byte boundary."""
    from repro_torch.kernels.sme_spmm.csc_grid import check_aligned
    base = torch.zeros(64)
    check_aligned(a=base, b=base[4:])
    with pytest.raises(ValueError, match=r"\['b'\]"):
        check_aligned(a=base, b=base[1:])
