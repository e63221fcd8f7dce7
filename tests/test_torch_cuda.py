"""The CUDA kernels on the card (``gpu`` marker; they skip where no card is
visible).  Imports only ``repro_torch``, torch and numpy, so it runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Each kernel against its plain PyTorch version (relative 5e-5 of the
output's max: both sum in f32, in different orders) and the f64 oracle,
decode ≡ prefill bitwise, ``plane_depth``, v1 ≡ v2 ≡ v3 bitwise (after
each format's power-of-two scaling), empty column tiles, the launch
counters, and the operands each wrapper refuses."""
import numpy as np
import pytest
import torch

from repro_torch.core.backend import get_backend
from repro_torch.core.sme import sme_compress
from repro_torch.kernels.sme_spmm.sme_spmm import sme_spmm, sme_spmm_plain
from repro_torch.kernels.sme_spmm.sme_spmm6 import sme_spmm6, sme_spmm6_plain
from repro_torch.kernels.sme_spmm.sme_spmm_planes import (
    sme_spmm_planes, sme_spmm_planes_plain)
from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import (
    sme_spmm_planes_decode, sme_spmm_planes_decode_plain)

pytestmark = pytest.mark.gpu

OPS = ("planes", "sign", "rowscale", "rowid", "shift", "last", "nnz")
V1 = ("codes", "sign", "rowscale", "rowid", "nnz")
V2 = ("packed", "rowscale", "rowid", "nnz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _operands(dev, shape=(384, 256), seed=3, **kw):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, shape)
    w[np.abs(w) < np.quantile(np.abs(w), 0.5)] = 0.0
    smew = sme_compress(w, squeeze=1, squeeze_max=7, **kw)
    ops = {k: torch.as_tensor(v, device=dev)
           for k, v in smew.pack_plane_csc().items()}
    nt = ops["planes"].shape[0]
    cs = torch.zeros(nt * 128, device=dev)
    cs[:shape[1]] = float(smew.scale.reshape(-1)[0]) * 2.0 ** -smew.n_bits
    return smew, [ops[k] for k in OPS], cs.reshape(nt, 128)


def _x(dev, m, k, rows, seed=4):
    x = torch.zeros((m, k), device=dev)
    x[:rows] = torch.as_tensor(np.random.default_rng(seed).normal(
        0, 1, (rows, k)), dtype=torch.float32, device=dev)
    return x


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("m", [128, 256])
def test_prefill_kernel_matches_plain_and_oracle(cuda, m):
    smew, args, _ = _operands(cuda)
    x = _x(cuda, m, 384, m)
    y = sme_spmm_planes(x, *args)
    assert _rel(y, sme_spmm_planes_plain(x, *args)) <= 5e-5
    scale = float(smew.scale.reshape(-1)[0]) * 2.0 ** -8
    ref = x.double().cpu().numpy() @ smew.dequant()
    got = y[:, :256].double().cpu().numpy() * scale
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 5e-5


def test_decode_kernel_matches_plain_prefill_and_depth(cuda):
    smew, args, cs = _operands(cuda)
    x = _x(cuda, 8, 384, 5)
    y = sme_spmm_planes_decode(x, *args[:3], cs, *args[3:])
    assert _rel(y, sme_spmm_planes_decode_plain(x, *args[:3], cs,
                                                *args[3:])) <= 5e-5
    x128 = torch.zeros((128, 384), device=cuda)
    x128[:8] = x
    assert torch.equal(y, sme_spmm_planes(x128, *args)[:8]
                       * cs.reshape(1, -1))
    assert torch.equal(y, sme_spmm_planes_decode(
        x, *args[:3], cs, *args[3:], plane_depth=8))
    for k in (1, 2):
        yk = sme_spmm_planes_decode(x, *args[:3], cs, *args[3:],
                                    plane_depth=k)
        ref = x.double().cpu().numpy() @ smew.dequant_topk_planes(k)
        got = yk[:, :256].double().cpu().numpy()
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 5e-5


def test_each_launch_counts_once(cuda):
    _, args, cs = _operands(cuda)
    p0, d0 = sme_spmm_planes.launches, sme_spmm_planes_decode.launches
    sme_spmm_planes(_x(cuda, 128, 384, 3), *args)
    sme_spmm_planes_decode(_x(cuda, 8, 384, 3), *args[:3], cs, *args[3:])
    sme_spmm_planes_plain(_x(cuda, 128, 384, 3), *args)
    assert (sme_spmm_planes.launches - p0,
            sme_spmm_planes_decode.launches - d0) == (1, 1)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    _, args, cs = _operands(cuda)
    with pytest.raises(ValueError, match="float32"):
        sme_spmm_planes(_x(cuda, 128, 384, 3).half(), *args)
    with pytest.raises(ValueError, match="multiple of 128"):
        sme_spmm_planes(_x(cuda, 64, 384, 3), *args)
    with pytest.raises(ValueError, match="on cpu"):
        sme_spmm_planes(_x(cuda, 128, 384, 3), args[0].cpu(), *args[1:])


def _tile_csc(dev, w, **kw):
    """(smew, v1 args, v2 args, v3 args) of one weight, on ``dev``."""
    smew = sme_compress(w, **kw)
    on = lambda d, names: [torch.as_tensor(d[k], device=dev) for k in names]
    return (smew, on(smew.pack_csc(), V1),
            on(get_backend("v2").pack_weight(smew), V2),
            on(smew.pack_plane_csc(), OPS))


def _pruned(seed=7):
    """Empty tiles, and column tile 1 empty (nnz = [2, 0, 1])."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, (384, 384))
    w[:, 128:256] = 0.0
    w[256:, :128] = 0.0
    w[:256, 256:] = 0.0
    return w


@pytest.mark.parametrize("m", [8, 256])
@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
def test_v1_v2_kernels_match_plain_oracle_and_v3(cuda, m, pruned):
    w = _pruned() if pruned else np.random.default_rng(3).normal(
        0, 0.3, (384, 256))
    smew, a1, a2, a3 = _tile_csc(cuda, w, squeeze=1)
    n = w.shape[1]
    x = _x(cuda, m, 384, m - 3)
    x128 = torch.zeros((-(-m // 128) * 128, 384), device=cuda)
    x128[:m] = x
    scale = float(smew.scale.reshape(-1)[0])
    y3 = sme_spmm_planes(x128, *a3)[:m] * scale * 2.0 ** -8
    ref = x.double().cpu().numpy() @ smew.dequant()
    for kernel, plain, args, qscale in (
            (sme_spmm, sme_spmm_plain, a1, 2.0 ** -8),
            (sme_spmm6, sme_spmm6_plain, a2, 2.0 ** -1)):
        y = kernel(x, *args)
        assert _rel(y, plain(x, *args)) <= 5e-5
        ys = y * scale * qscale
        assert torch.equal(ys, y3), kernel.__name__
        got = ys[:, :n].double().cpu().numpy()
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 5e-5
        if pruned:
            assert (y[:, 128:256] == 0).all()


def test_v1_holds_settings_v2_cannot(cuda):
    w = np.random.default_rng(5).normal(0, 0.3, (256, 256))
    for kw in (dict(squeeze=0), dict(window=4, squeeze=1)):
        smew = sme_compress(w, **kw)
        args = [torch.as_tensor(v, device=cuda)
                for v in (smew.pack_csc()[k] for k in V1)]
        x = _x(cuda, 16, 256, 16)
        y = sme_spmm(x, *args)[:, :256] * float(smew.scale.reshape(-1)[0]) \
            * 2.0 ** -8
        ref = x.double().cpu().numpy() @ smew.dequant()
        got = y.double().cpu().numpy()
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 5e-5


def test_v1_v2_each_launch_counts_once(cuda):
    _, a1, a2, _ = _tile_csc(cuda, _pruned())
    c1, c2 = sme_spmm.launches, sme_spmm6.launches
    x = _x(cuda, 8, 384, 3)
    sme_spmm(x, *a1)
    sme_spmm6(x, *a2)
    sme_spmm_plain(x, *a1)
    sme_spmm6_plain(x, *a2)
    assert (sme_spmm.launches - c1, sme_spmm6.launches - c2) == (1, 1)


def test_v1_v2_wrappers_reject_what_the_kernels_do_not_take(cuda):
    _, a1, a2, _ = _tile_csc(cuda, _pruned())
    x = _x(cuda, 8, 384, 3)
    for kernel, args in ((sme_spmm, a1), (sme_spmm6, a2)):
        with pytest.raises(ValueError, match="float32"):
            kernel(x.half(), *args)
        with pytest.raises(ValueError, match="multiple of 8"):
            kernel(_x(cuda, 12, 384, 3), *args)
        with pytest.raises(ValueError, match="on cpu"):
            kernel(x, args[0].cpu(), *args[1:])
        with pytest.raises(ValueError, match="want"):
            kernel(x, *args[:-1], args[-1].long())
        with pytest.raises(ValueError, match="non-contiguous"):
            kernel(torch.zeros((384, 8), device=cuda).t(), *args)
    with pytest.raises(ValueError, match="non-contiguous"):
        sme_spmm(x, a1[0].transpose(-1, -2), *a1[1:])
    small = sme_compress(np.random.default_rng(1).normal(0, 0.3, (128, 128)),
                         tile=(64, 64))
    args = [torch.as_tensor(small.pack_csc()[k], device=cuda) for k in V1]
    with pytest.raises(ValueError, match="128x128"):
        sme_spmm(_x(cuda, 8, 128, 3), *args)
