"""Kernel-level parity of the port: the plain versions of the two plane-CSC
kernels (what the wrappers run for CPU tensors) against the reference
Pallas kernels in interpret mode and the f64 oracle, the shared helpers
against theirs, the backend dispatch against ``repro.core.backend``, and
the no-card rules.  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``; ``chip_smoke.py`` at full width).

Tolerances: the port's plain versions and the reference kernels both sum
in f32, one matmul per tile group in the same list order, so they agree to
f32 rounding of the per-group dots (1e-6 of the output's max); both stay
within the DESIGN.md §5 bound of 5e-5 relative to the f64 oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as RB
from repro.core.integrate import pack_sme_param as ref_pack
from repro.kernels.sme_spmm import csc_grid as ref_grid
from repro.kernels.sme_spmm.sme_spmm_planes import \
    sme_spmm_planes as ref_planes
from repro.kernels.sme_spmm.sme_spmm_planes_decode import (
    plane_group_index as ref_group_index,
    sme_spmm_planes_decode as ref_decode)
from repro_torch.configs import ARCHS, scale_down
from repro_torch.core import backend as PB
from repro_torch.core.integrate import pack_sme_param, to_torch
from repro_torch.core.sme import sme_compress
from repro_torch.device import resolve_device
from repro_torch.kernels.sme_spmm.csc_grid import unpack_row_bits
from repro_torch.kernels.sme_spmm.sme_spmm import sme_spmm
from repro_torch.kernels.sme_spmm.sme_spmm6 import sme_spmm6
from repro_torch.kernels.sme_spmm.sme_spmm_planes import (
    sme_spmm_planes, sme_spmm_planes_plain)
from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import (
    plane_group_index, sme_spmm_planes_decode, sme_spmm_planes_decode_plain)
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine

SETTINGS = [dict(n_bits=8, window=3, squeeze=1),
            dict(n_bits=8, window=3, squeeze=1, squeeze_max=7),
            dict(n_bits=6, window=2, squeeze=2)]
OPS = ("planes", "sign", "rowscale", "rowid", "shift", "last", "nnz")
V1 = ("codes", "sign", "rowscale", "rowid", "nnz")
V2 = ("packed", "rowscale", "rowid", "nnz")


def _weight(seed, shape):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, shape)
    w[np.abs(w) < np.quantile(np.abs(w), 0.5)] = 0.0
    return w


def _case(kw, m, shape=(384, 256), seed=3):
    """(x padded [M_pad, K_pad] f32, numpy operands, SMEWeight, x)."""
    w = _weight(seed, shape)
    smew = sme_compress(w, **kw)
    ops = smew.pack_plane_csc()
    x = np.random.default_rng(seed + 1).normal(0, 1, (m, shape[0])
                                               ).astype(np.float32)
    return x, ops, smew


def _pad(x, mp, kp):
    out = np.zeros((mp, kp), np.float32)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _colscale(smew, nt):
    cs = np.zeros(nt * 128, np.float32)
    cs[:smew.shape[1]] = np.float32(smew.scale.reshape(-1)[0]) \
        * np.float32(2.0 ** -smew.n_bits)
    return cs.reshape(nt, 128)


def _close(a, b, rel=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30), \
        np.abs(a - b).max()


def _oracle_rel(y, x, smew, dense=None):
    ref = x.astype(np.float64) @ (smew.dequant() if dense is None else dense)
    return np.abs(np.asarray(y, np.float64)[:, :ref.shape[1]] - ref).max() \
        / np.abs(ref).max()


# ------------------------------------------------------------- helpers
def test_unpack_row_bits_matches_reference():
    packed = np.random.default_rng(0).integers(0, 256, (16, 128), np.uint8)
    ref = np.asarray(ref_grid.unpack_row_bits(jnp.asarray(packed), 128, 128))
    port = unpack_row_bits(torch.from_numpy(packed), 128, 128).numpy()
    assert (ref == port).all()
    # MSB first: byte r bit 7-i is row 8r+i (an LSB-first decode fails here)
    assert (port == np.unpackbits(packed, axis=0)).all()


def test_plane_group_index_matches_reference():
    w = _weight(11, (384, 256))
    w[np.abs(w) < np.quantile(np.abs(w), 0.7)] = 0.0
    ops = sme_compress(w, squeeze=1, squeeze_max=7).pack_plane_csc()
    L = ops["rowid"].shape[1]
    G = max(int(((ops["last"] == 1) & (np.arange(L)[None, :]
                                       < ops["nnz"][:, None])).sum(1).max()), 1)
    ref = ref_group_index(*(jnp.asarray(ops[k]) for k in
                            ("rowid", "last", "nnz")), G)
    port = plane_group_index(*(torch.from_numpy(ops[k]) for k in
                               ("rowid", "last", "nnz")), G)
    for r, p in zip(ref, port):
        assert (np.asarray(r) == p.numpy()).all()


# --------------------------------------------------- plain vs reference
@pytest.mark.parametrize("kw", SETTINGS, ids=["sq1", "sqmax7", "nb6"])
def test_plain_prefill_matches_reference_kernel(kw):
    x, ops, smew = _case(kw, m=100)
    xp = _pad(x, 128, 384)
    ref = np.asarray(ref_planes(jnp.asarray(xp), *(jnp.asarray(ops[k])
                                                   for k in OPS),
                                bm=128, interpret=True))
    port = sme_spmm_planes(torch.from_numpy(xp),
                           *(torch.from_numpy(ops[k]) for k in OPS))
    _close(port.numpy(), ref)
    scale = np.float32(smew.scale.reshape(-1)[0]) * np.float32(2.0 ** -smew.n_bits)
    assert _oracle_rel(port.numpy()[:100] * scale, x, smew) < 5e-5


@pytest.mark.parametrize("kw", SETTINGS, ids=["sq1", "sqmax7", "nb6"])
def test_plain_decode_matches_reference_kernel(kw):
    x, ops, smew = _case(kw, m=5)
    xp = _pad(x, 8, 384)
    cs = _colscale(smew, ops["planes"].shape[0])
    args = [ops[k] for k in OPS[:3]] + [cs] + [ops[k] for k in OPS[3:]]
    ref = np.asarray(ref_decode(*(jnp.asarray(a) for a in [xp] + args),
                                interpret=True))
    port = sme_spmm_planes_decode(*(torch.from_numpy(a) for a in [xp] + args))
    _close(port.numpy(), ref)
    assert _oracle_rel(port.numpy()[:5], x, smew) < 5e-5


def test_plain_decode_equals_plain_prefill_bitwise():
    x, ops, smew = _case(SETTINGS[1], m=8)
    nt = ops["planes"].shape[0]
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    args = [t[k] for k in OPS]
    cs = torch.from_numpy(_colscale(smew, nt))
    yd = sme_spmm_planes_decode_plain(torch.from_numpy(_pad(x, 8, 384)),
                                      *args[:3], cs, *args[3:])
    yp = sme_spmm_planes_plain(torch.from_numpy(_pad(x, 128, 384)), *args)
    scale = torch.tensor(float(smew.scale.reshape(-1)[0]), dtype=torch.float32)
    assert torch.equal(yd, (yp[:8] * scale * 2.0 ** -8))


def test_plane_depth_truncates_to_top_planes():
    x, ops, smew = _case(SETTINGS[1], m=6)
    xp = torch.from_numpy(_pad(x, 8, 384))
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    cs = torch.from_numpy(_colscale(smew, ops["planes"].shape[0]))
    args = [t["planes"], t["sign"], t["rowscale"], cs, t["rowid"],
            t["shift"], t["last"], t["nnz"]]
    full = sme_spmm_planes_decode(xp, *args)
    assert torch.equal(sme_spmm_planes_decode(xp, *args, plane_depth=8), full)
    for k in (1, 2, 3):
        yk = sme_spmm_planes_decode(xp, *args, plane_depth=k).numpy()[:6]
        assert _oracle_rel(yk, x, smew, smew.dequant_topk_planes(k)) < 5e-5
    # non-positive depth clamps to 1, as the reference kernel does
    assert torch.equal(sme_spmm_planes_decode(xp, *args, plane_depth=0),
                       sme_spmm_planes_decode(xp, *args, plane_depth=1))
    ref = ref_decode(*(jnp.asarray(a.numpy()) for a in [xp] + args),
                     plane_depth=2, interpret=True)
    _close(sme_spmm_planes_decode(xp, *args, plane_depth=2).numpy(),
           np.asarray(ref))


def test_cpu_calls_do_not_count_launches():
    x, ops, smew = _case(SETTINGS[0], m=8)
    wrappers = (sme_spmm_planes, sme_spmm_planes_decode, sme_spmm, sme_spmm6)
    before = [f.launches for f in wrappers]
    sme_spmm_planes(torch.from_numpy(_pad(x, 128, 384)),
                    *(torch.from_numpy(ops[k]) for k in OPS))
    xt = torch.from_numpy(_pad(x, 8, 384))
    v1 = smew.pack_csc()
    sme_spmm(xt, *(torch.from_numpy(v1[k]) for k in V1))
    v2 = PB.get_backend("v2").pack_weight(smew)
    sme_spmm6(xt, *(torch.from_numpy(v2[k]) for k in V2))
    assert [f.launches for f in wrappers] == before


# ------------------------------------------------------------- backend
def _params(w, **kw):
    ref = ref_pack(w, backend="v3", **kw)
    return {k: jnp.asarray(v) for k, v in ref.items()}, to_torch(
        pack_sme_param(w, backend="v3", **kw), "cpu")


@pytest.mark.parametrize("m", [1, 5, 64, 65, 130])
def test_sme_apply_matches_reference(m):
    w = _weight(2, (300, 200))
    ref_p, port_p = _params(w, squeeze_max=7)
    x = np.random.default_rng(m).normal(0, 1, (m, 300)).astype(np.float32)
    ref = np.asarray(RB.sme_apply(jnp.asarray(x), ref_p, "v3"))
    port = PB.sme_apply(torch.from_numpy(x), port_p, "v3").numpy()
    _close(port, ref)
    ref_x = np.asarray(RB.sme_apply(jnp.asarray(x), ref_p, "xla"))
    _close(PB.sme_apply(torch.from_numpy(x), port_p, "torch").numpy(), ref_x)
    assert PB.resolve_backend(port_p).name == "v3"
    assert PB._use_decode_kernel(m, 128) == RB._use_decode_kernel(m, 128)


def test_sme_apply_row_perm_and_stacked_lead_dims():
    w = _weight(4, (256, 128))
    perm = np.random.default_rng(4).permutation(256)
    ref_p, port_p = _params(w, row_perm=perm)
    x = np.random.default_rng(0).normal(0, 1, (3, 4, 256)).astype(np.float32)
    _close(PB.sme_apply(torch.from_numpy(x), port_p, "v3").numpy(),
           np.asarray(RB.sme_apply(jnp.asarray(x), ref_p, "v3")))
    from repro.core.integrate import convert_params_to_sme as ref_convert
    from repro_torch.core.integrate import convert_params_to_sme
    stacked = np.random.default_rng(5).normal(0, 0.3, (2, 256, 128))
    ref_s = ref_convert({"wi": stacked}, backend="v3")["wi"]
    port_s = convert_params_to_sme({"wi": stacked}, backend="v3",
                                   device="cpu")["wi"]
    xs = np.random.default_rng(6).normal(0, 1, (2, 80, 256)).astype(np.float32)
    _close(PB.sme_apply(torch.from_numpy(xs), port_s, "v3").numpy(),
           np.asarray(RB.sme_apply(jnp.asarray(xs), ref_s, "v3")))
    with pytest.raises(ValueError, match="lead dims"):
        PB.sme_apply(torch.from_numpy(xs[:1]), port_s, "v3")


def test_kernel_backend_without_operands_raises():
    port_p = to_torch(pack_sme_param(_weight(1, (128, 128))), "cpu")
    assert PB.resolve_backend(port_p).name == "torch"
    with pytest.raises(ValueError, match="no v3 operands"):
        PB.sme_apply(torch.zeros(2, 128), port_p, "v3")


# ------------------------------------------------------------ no card
def test_cuda_requests_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    cfg = scale_down(ARCHS["qwen1.5-0.5b"])
    for make in (lambda: resolve_device(None), lambda: resolve_device("cuda"),
                 lambda: build_model(cfg),
                 lambda: to_torch({"w": np.zeros(2)}),
                 lambda: ServeEngine(build_model(cfg, device="cpu"), {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_wrappers_never_run_the_plain_version_off_cpu(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises, and
    never reaches the plain version.  The plain versions are replaced, in
    the wrapper modules that call them, by a trap (a CPU call proves the
    trap is live).  A meta tensor (no card to launch on) is refused by the
    operand check; past that check, the wrapper's only way on is the
    kernel loader.  All four wrappers: v3 prefill and decode, v1, v2."""
    import repro_torch.kernels.sme_spmm.sme_spmm as v1mod
    import repro_torch.kernels.sme_spmm.sme_spmm6 as v2mod
    import repro_torch.kernels.sme_spmm.sme_spmm_planes as pmod
    import repro_torch.kernels.sme_spmm.sme_spmm_planes_decode as dmod
    from repro_torch.kernels import build

    class PlainCalled(Exception):
        pass

    class Launch(Exception):
        pass

    def trap(*a, **k):
        raise PlainCalled

    def load(name):
        raise Launch(name)
    for mod in (pmod, dmod):
        monkeypatch.setattr(mod, "splice_dot_plain", trap)
    for mod in (v1mod, v2mod):
        monkeypatch.setattr(mod, "csc_dot_plain", trap)
    monkeypatch.setattr(pmod, "sme_spmm_planes_plain", trap)
    monkeypatch.setattr(dmod, "sme_spmm_planes_decode_plain", trap)
    monkeypatch.setattr(v1mod, "sme_spmm_plain", trap)
    monkeypatch.setattr(v2mod, "sme_spmm6_plain", trap)
    x, ops, smew = _case(SETTINGS[0], m=8)
    cpu = {k: torch.from_numpy(v) for k, v in ops.items()}
    cs_cpu = torch.from_numpy(_colscale(smew, ops["planes"].shape[0]))
    v1 = {k: torch.from_numpy(v) for k, v in smew.pack_csc().items()}
    v2 = {k: torch.from_numpy(v) for k, v in
          PB.get_backend("v2").pack_weight(smew).items()}

    def calls(dev):
        args = [cpu[k].to(dev) for k in OPS]
        cs = cs_cpu.to(dev)
        return (lambda: sme_spmm_planes(torch.zeros(128, 384, device=dev),
                                        *args),
                lambda: sme_spmm_planes_decode(
                    torch.zeros(8, 384, device=dev), *args[:3], cs,
                    *args[3:]),
                lambda: sme_spmm(torch.zeros(8, 384, device=dev),
                                 *(v1[k].to(dev) for k in V1)),
                lambda: sme_spmm6(torch.zeros(8, 384, device=dev),
                                  *(v2[k].to(dev) for k in V2)))
    for call in calls("cpu"):
        with pytest.raises(PlainCalled):
            call()
    for call in calls("meta"):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    monkeypatch.setattr(build, "load", load)
    for mod in (pmod, dmod):
        monkeypatch.setattr(mod, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(v1mod, "check_v1_operands", lambda *a, **k: None)
    monkeypatch.setattr(v2mod, "check_v2_operands", lambda *a, **k: None)
    for call, name in zip(calls("meta"), ("sme_spmm_planes",
                                          "sme_spmm_planes_decode",
                                          "sme_spmm", "sme_spmm6")):
        with pytest.raises(Launch, match=f"^{name}$"):
            call()
