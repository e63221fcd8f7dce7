"""The CUDA kernels on the card (``gpu`` marker; they skip where no card is
visible).  Imports only ``repro_torch``, torch and numpy, so it runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Each kernel against its plain PyTorch version (relative 5e-5 of the
output's max: both sum in f32, in different orders) and the f64 oracle,
decode ≡ prefill bitwise, ``plane_depth``, and the launch counters."""
import numpy as np
import pytest
import torch

from repro_torch.core.sme import sme_compress
from repro_torch.kernels.sme_spmm.sme_spmm_planes import (
    sme_spmm_planes, sme_spmm_planes_plain)
from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import (
    sme_spmm_planes_decode, sme_spmm_planes_decode_plain)

pytestmark = pytest.mark.gpu

OPS = ("planes", "sign", "rowscale", "rowid", "shift", "last", "nnz")


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
