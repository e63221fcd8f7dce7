"""Minifloat-6 (the v2 format) and the byte accounting of the port against
the reference: ``encode6``/``pack6``/``unpack6``/``decode6_value``/
``minifloat_dequant`` byte-equal to ``repro.core.minifloat`` over the
settings grid, the settings v2 refuses, the per-format storage counts, and
the v2 kernel's plain decode against ``decode6_value``.  All comparisons
are exact: every value involved is an integer code or a power-of-two
multiple of one."""
import numpy as np
import pytest
import torch

from repro.core import backend as RB
from repro.core import minifloat as RM
from repro.core.sme import sme_compress as ref_compress
from repro_torch.core import backend as PB
from repro_torch.core import minifloat as PM
from repro_torch.core.sme import sme_compress
from repro_torch.kernels.sme_spmm.sme_spmm6 import decode6_plain

#: the settings grid of the reference's bit-identity test
GRID = [(8, 3, 0, None), (8, 3, 1, None), (8, 3, 2, None), (8, 2, 1, None),
        (8, 4, 0, None), (6, 3, 1, None), (6, 2, 2, None),
        (8, 3, 1, 7), (8, 2, 1, 6), (6, 3, 1, 5)]
IDS = [f"nb{a}w{b}sq{c}" + (f"max{d}" if d else "") for a, b, c, d in GRID]


def _weight(seed, shape=(200, 150)):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, shape)
    w[np.abs(w) < np.quantile(np.abs(w), 0.5)] = 0.0
    return w


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert (a == b).all(), what


@pytest.mark.parametrize("n_bits,window,squeeze,squeeze_max", GRID, ids=IDS)
def test_minifloat_byte_equal_to_reference(n_bits, window, squeeze,
                                           squeeze_max):
    kw = dict(n_bits=n_bits, window=window, squeeze=squeeze,
              squeeze_max=squeeze_max)
    w = _weight(3)
    r, p = ref_compress(w, **kw), sme_compress(w, **kw)
    signs = p.sign_tiled()
    c6 = PM.encode6(p.tiled_codes, signs, n_bits, squeeze)
    _same(RM.encode6(r.tiled_codes, r.sign_tiled(), n_bits, squeeze), c6,
          "encode6")
    _same(RM.decode6_value(c6, n_bits, squeeze),
          PM.decode6_value(c6, n_bits, squeeze), "decode6_value")
    packed = PM.pack6(c6)
    _same(RM.pack6(c6), packed, "pack6")
    _same(RM.unpack6(packed), PM.unpack6(packed), "unpack6")
    _same(PM.unpack6(packed), c6, "round trip")
    if not RB.SpmmV2Backend.supports_settings(n_bits, window, squeeze):
        for mod, smew in ((RM, r), (PM, p)):
            with pytest.raises(ValueError):
                mod.minifloat_from_sme(smew)
        return
    rmf, pmf = RM.minifloat_from_sme(r), PM.minifloat_from_sme(p)
    assert set(rmf) == set(pmf)
    for key in ("packed", "rowscale", "scale"):
        _same(rmf[key], pmf[key], key)
    dense = PM.minifloat_dequant(pmf)
    _same(RM.minifloat_dequant(rmf), dense, "minifloat_dequant")
    # v2 holds the setting: every code decodes to its codeword's value
    val = p.tiled_codes * 2.0 ** -n_bits * (1.0 - 2.0 * signs)
    _same(PM.decode6_value(c6, n_bits, squeeze), val, "lossless")
    assert RM.bits_per_weight6(rmf) == PM.bits_per_weight6(pmf)


@pytest.mark.parametrize("n_bits,window,squeeze,squeeze_max", GRID, ids=IDS)
def test_v2_holds_exactly_the_settings_the_reference_admits(
        n_bits, window, squeeze, squeeze_max):
    kw = dict(n_bits=n_bits, window=window, squeeze=squeeze,
              squeeze_max=squeeze_max)
    ok = PB.SpmmV2Backend.supports_settings(n_bits, window, squeeze)
    assert ok == RB.SpmmV2Backend.supports_settings(n_bits, window, squeeze)
    smew = sme_compress(_weight(4, (256, 256)), **kw)
    assert PB.get_backend("v2").supports(smew) == ok
    if ok:
        PB.get_backend("v2").pack_weight(smew)
    else:
        with pytest.raises(ValueError, match="minifloat-6"):
            PB.get_backend("v2").pack_weight(smew)


def test_v2_rejects_unsqueezed_and_wide_window():
    w = _weight(5, (256, 256))
    for kw in (dict(squeeze=0), dict(window=4, squeeze=1)):
        smew = sme_compress(w, **kw)
        with pytest.raises(ValueError):
            PB.get_backend("v2").pack_weight(smew)
        with pytest.raises(ValueError):
            smew.storage_bits_per_weight("minifloat6")


@pytest.mark.parametrize("n_bits,window,squeeze,squeeze_max", GRID, ids=IDS)
def test_storage_accounting_matches_reference(n_bits, window, squeeze,
                                              squeeze_max):
    kw = dict(n_bits=n_bits, window=window, squeeze=squeeze,
              squeeze_max=squeeze_max)
    w = _weight(6, (300, 260))
    r, p = ref_compress(w, **kw), sme_compress(w, **kw)
    assert (r.live_bits, r.n_weights) == (p.live_bits, p.n_weights)
    _same(r.live_plane_occupancy(), p.live_plane_occupancy(), "live planes")
    assert r.plane_tiles_used() == p.plane_tiles_used()
    assert r.crossbars_used() == p.crossbars_used()
    fmts = ["bytecode", "planes", "plane_csc"]
    if PB.SpmmV2Backend.supports_settings(n_bits, window, squeeze):
        fmts.append("minifloat6")
    for fmt in fmts:
        assert r.storage_bits_per_weight(fmt) == p.storage_bits_per_weight(fmt)
    with pytest.raises(ValueError):
        p.storage_bits_per_weight("nope")


def test_kernel_decode_equals_decode6_value():
    """The v2 plain version's decode (squeezed = 0, as the backend calls
    the kernel) over every 6-bit code, including zero codes whose sign bit
    is set, which must decode to 0."""
    codes = np.arange(64, dtype=np.uint8).reshape(1, 64)
    port = decode6_plain(torch.from_numpy(PM.pack6(codes))).numpy()
    ref = PM.decode6_value(codes, n_bits=8, squeezed=0)
    assert (port.astype(np.float64) == ref).all()
    assert (port[0, [0, 1, 2, 3, 32, 33, 34, 35]] == 0).all()
    assert not np.signbit(port[0, 32:36]).any()
