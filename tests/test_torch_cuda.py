"""The CUDA kernels on the card (``gpu`` marker; they skip where no card is
visible).  Imports only ``repro_torch``, torch and numpy, so it runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Each kernel against its plain PyTorch version (relative 5e-5 of the
output's max: both sum in f32, in different orders) and the f64 oracle,
decode ≡ prefill bitwise at every decode M bucket and at a 22-group column,
``plane_depth``, v1 ≡ v2 ≡ v3 bitwise (after each format's power-of-two
scaling) on both of v1's and v2's paths, empty column tiles, the launch
geometry of the four kernels, the launch counters, the operands each
wrapper refuses, and the malformed lists the device refuses."""
import numpy as np
import pytest
import torch

from repro_torch.core.backend import get_backend
from repro_torch.kernels import build
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


#: the oracle bound of DESIGN.md §5
TOL_ORACLE = 5e-5


def _oracle_rel(y, x, dense):
    ref = x.double().cpu().numpy() @ dense
    got = y[:, :dense.shape[1]].double().cpu().numpy()
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("m", [8, 16, 24, 32, 64, 72])
@pytest.mark.parametrize("shape", [(384, 256), (2816, 256)],
                         ids=["k384", "k2816"])
def test_decode_kernel_buckets_equal_prefill_kernel(cuda, m, shape):
    """Every decode M bucket (8/16/32/64; 24 pads its bucket, 72 takes two
    M tiles) and wo's depth (K = 2816: 22 groups per column, spread over a
    cluster of 8) of the v3-decode kernel and of v1 (decode_walk up to
    M = 64, tiled_walk at 72) equal the prefill kernel bitwise."""
    rng = np.random.default_rng(11)
    w = rng.normal(0, 1, shape) / np.sqrt(shape[0])
    smew = sme_compress(w, squeeze=1)
    ops = smew.pack_plane_csc()
    args = [torch.as_tensor(ops[k], device=cuda) for k in OPS]
    a1 = [torch.as_tensor(smew.pack_csc()[k], device=cuda) for k in V1]
    nt = ops["planes"].shape[0]
    if shape[0] == 2816:
        assert (ops["last"].sum(1) == 22).all()
    cs = torch.full((nt, 128), float(smew.scale.reshape(-1)[0]) * 2.0 ** -8,
                    device=cuda)
    x = _x(cuda, m, shape[0], m - 3)
    y = sme_spmm_planes_decode(x, *args[:3], cs, *args[3:])
    x128 = torch.zeros((-(-m // 128) * 128, shape[0]), device=cuda)
    x128[:m] = x
    y_pre = sme_spmm_planes(x128, *args)[:m]
    assert torch.equal(y, y_pre * cs.reshape(1, -1))
    assert torch.equal(sme_spmm(x, *a1), y_pre)
    assert _rel(y, sme_spmm_planes_decode_plain(x, *args[:3], cs,
                                                *args[3:])) <= 5e-5
    assert _oracle_rel(y, x, smew.dequant()) <= TOL_ORACLE


@pytest.mark.parametrize("depth", [None, 1, 2, 8])
def test_decode_kernel_uneven_lists_and_depth(cuda, depth):
    """Column-tile group counts 2 / 0 / 1: the empty column is exactly 0,
    full depth equals the prefill kernel bitwise, depth 8 is a no-op and
    depths 1 and 2 match ``dequant_topk_planes``."""
    smew = sme_compress(_pruned(), squeeze=1)
    ops = smew.pack_plane_csc()
    assert ops["last"].sum(1).tolist() == [2, 0, 1]
    args = [torch.as_tensor(ops[k], device=cuda) for k in OPS]
    cs = torch.full((3, 128), float(smew.scale.reshape(-1)[0]) * 2.0 ** -8,
                    device=cuda)
    x = _x(cuda, 16, 384, 13)
    y = sme_spmm_planes_decode(x, *args[:3], cs, *args[3:], plane_depth=depth)
    assert (y[:, 128:256] == 0).all()
    full = sme_spmm_planes_decode(x, *args[:3], cs, *args[3:])
    if depth is None:
        x128 = torch.zeros((128, 384), device=cuda)
        x128[:16] = x
        assert torch.equal(y, sme_spmm_planes(x128, *args)[:16]
                           * cs.reshape(1, -1))
    elif depth == 8:
        assert torch.equal(y, full)
    else:
        assert _oracle_rel(y, x, smew.dequant_topk_planes(depth)) <= TOL_ORACLE
        assert _rel(y, sme_spmm_planes_decode_plain(
            x, *args[:3], cs, *args[3:], plane_depth=depth)) <= 5e-5


@pytest.mark.parametrize("m", [8, 16, 24, 32, 64, 72, 512])
@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
def test_v2_paths_equal_v1_and_v3_prefill(cuda, m, pruned):
    """Both walks of v2 and of v1 (decode_walk at 2M <= 128, at every M
    bucket; tiled_walk above) equal each other and the v3 prefill kernel
    bitwise after scaling."""
    w = _pruned() if pruned else np.random.default_rng(12).normal(
        0, 1, (1024, 256)) / 32.0
    smew, a1, a2, a3 = _tile_csc(cuda, w, squeeze=1)
    x = _x(cuda, m, w.shape[0], m - 3)
    x128 = torch.zeros((-(-m // 128) * 128, w.shape[0]), device=cuda)
    x128[:m] = x
    scale = float(smew.scale.reshape(-1)[0])
    y3 = sme_spmm_planes(x128, *a3)[:m] * scale * 2.0 ** -8
    y1 = sme_spmm(x, *a1)
    assert _rel(y1, sme_spmm_plain(x, *a1)) <= 5e-5
    y1 = y1 * scale * 2.0 ** -8
    y2 = sme_spmm6(x, *a2)
    assert _rel(y2, sme_spmm6_plain(x, *a2)) <= 5e-5
    y2 = y2 * scale * 2.0 ** -1
    assert torch.equal(y2, y1) and torch.equal(y2, y3)
    assert _oracle_rel(y2, x, smew.dequant()) <= TOL_ORACLE
    if pruned:
        assert (y2[:, 128:256] == 0).all()


def test_cluster_kernels_launch_geometry(cuda):
    """At qwen1.5-0.5b's q/k/v/o shape (8 row and 8 column tiles, 56-slot
    v3 lists) the decode-sized launches (v3-decode, v1 and v2 at M = 8) are
    8 x 4 clusters of 8 blocks, and the M = 512 ones (v1, v2, v3-prefill)
    16 x 8 blocks, all within 227 KB of shared memory; v1's and v2's tiled
    blocks fit two to an SM (228 KB, 1 KB reserved per block)."""
    d = build.geometry("sme_spmm_planes_decode", 8, 1024, 8, 56, 0)
    assert (d["grid_x"], d["grid_y"], d["cluster"]) == (256, 1, 8)
    dec = [build.geometry(k, 8, 1024, 8, 8) for k in ("sme_spmm6", "sme_spmm")]
    for g in dec:
        assert (g["grid_x"], g["grid_y"], g["cluster"]) == (256, 1, 8)
    tiled = [build.geometry(k, 512, 1024, 8, 8)
             for k in ("sme_spmm6", "sme_spmm")]
    tiled.append(build.geometry("sme_spmm_planes", 512, 1024, 8, 56))
    for g in tiled:
        assert (g["grid_x"], g["grid_y"], g["cluster"]) == (16, 8, 1)
    for g in tiled[:2]:
        assert 2 * (g["smem_bytes"] + 1024) <= 233472
    wo = build.geometry("sme_spmm_planes_decode", 64, 2816, 8, 176, 0)
    assert wo["cluster"] == 8
    for g in [d, wo, *dec, *tiled]:
        assert 0 < g["smem_bytes"] <= 232448


def test_redesigned_wrappers_reject_unaligned_operands(cuda):
    _, args, cs = _operands(cuda)
    _, a1, a2, _ = _tile_csc(cuda, _pruned())
    flat = torch.zeros(128 * 384 + 1, device=cuda)
    x = flat[1:8 * 384 + 1].view(8, 384)
    with pytest.raises(ValueError, match="aligned"):
        sme_spmm_planes_decode(x, *args[:3], cs, *args[3:])
    with pytest.raises(ValueError, match="aligned"):
        sme_spmm6(x, *a2)
    with pytest.raises(ValueError, match="aligned"):
        sme_spmm(x, *a1)
    with pytest.raises(ValueError, match="aligned"):
        sme_spmm_planes(flat[1:].view(128, 384), *args)


def test_geometry_refuses_what_a_block_cannot_hold(cuda):
    """A list so long that its group index overflows shared memory: the
    geometry export refuses it, as the launch would, for every kernel and
    both walks of v1 and v2."""
    for args in (("sme_spmm_planes_decode", 64, 1024, 8, 20000, 0),
                 ("sme_spmm_planes", 512, 1024, 8, 20000),
                 ("sme_spmm", 8, 1024, 8, 60000),
                 ("sme_spmm", 512, 1024, 8, 60000),
                 ("sme_spmm6", 8, 1024, 8, 60000),
                 ("sme_spmm6", 512, 1024, 8, 60000)):
        with pytest.raises(RuntimeError, match="cannot launch"):
            build.geometry(*args)


#: a malformed list in a child process (a trapped kernel leaves the CUDA
#: context unusable): ``launched`` once the wrapper returned, ``no error``
#: only if the device finished without trapping
_MALFORMED = """
import sys, torch
from repro_torch.kernels.sme_spmm.sme_spmm import sme_spmm
from repro_torch.kernels.sme_spmm.sme_spmm6 import sme_spmm6
from repro_torch.kernels.sme_spmm.sme_spmm_planes import sme_spmm_planes
from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import \\
    sme_spmm_planes_decode
dev, case = torch.device("cuda", 0), sys.argv[1]
i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
if case.startswith("v3"):          # 17 planes in one group, 16 staged
    L = 17
    v3 = (torch.full((1, L, 16, 128), 1, dtype=torch.uint8, device=dev),
          torch.zeros((1, 1, 16, 128), dtype=torch.uint8, device=dev),
          torch.ones((1, 1, 128), device=dev))
    index = (i32([[0] * L]), i32([[15 - l % 16 for l in range(L)]]),
             i32([[0] * (L - 1) + [1]]), i32([L]))
    if case == "v3_deep_group":
        y = sme_spmm_planes_decode(torch.ones((8, 128), device=dev), *v3,
                                   torch.ones((1, 128), device=dev), *index)
    else:                          # v3_prefill_deep_group
        y = sme_spmm_planes(torch.ones((128, 128), device=dev), *v3, *index)
elif case.startswith("v1"):        # nnz 3 of L = 2, through both walks
    y = sme_spmm(torch.ones((8 if case == "v1_past_l" else 512, 128),
                            device=dev),
                 torch.full((1, 2, 128, 128), 7, dtype=torch.uint8,
                            device=dev),
                 torch.zeros((1, 2, 16, 128), dtype=torch.uint8, device=dev),
                 torch.ones((1, 2, 128), device=dev), i32([[0, 0]]), i32([3]))
else:
    # v2_groups: two slots in the one row tile; v2_past_l: nnz 3 of L = 2
    m, nnz = (8, 2) if case == "v2_groups" else (512, 3)
    y = sme_spmm6(torch.ones((m, 128), device=dev),
                  torch.full((1, 2, 128, 96), 7, dtype=torch.uint8,
                             device=dev),
                  torch.ones((1, 2, 128), device=dev), i32([[0, 0]]),
                  i32([nnz]))
print("launched", flush=True)
torch.cuda.synchronize()
print("no error", flush=True)
"""


@pytest.mark.parametrize("case", ["v3_deep_group", "v3_prefill_deep_group",
                                  "v2_groups", "v2_past_l", "v1_past_l",
                                  "v1_past_l_tiled"])
def test_malformed_lists_raise_not_drop_slots(cuda, case):
    """A list the host did not size the kernel for (a group deeper than the
    staged planes, more groups than row tiles, nnz past the list length)
    traps on the device, so the call raises instead of returning a sum with
    slots left out."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _MALFORMED, case], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=300)
    assert "launched" in proc.stdout, proc.stderr[-2000:]
    assert "no error" not in proc.stdout
    assert proc.returncode != 0


def _small_model(dev, backend="v3"):
    """The launcher's --small config in f32, random weights from a numpy
    seed (embedding scaled to 0.05), every linear packed for ``backend``."""
    import dataclasses
    from repro_torch.configs import ARCHS, scale_down
    from repro_torch.core.integrate import convert_params_to_sme
    from repro_torch.launch.serve import SMALL
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import lm_init
    cfg = dataclasses.replace(scale_down(ARCHS["qwen1.5-0.5b"], **SMALL),
                              dtype="float32")
    params = lm_init(cfg, np.random.default_rng(0))
    params["embed"]["w"] = params["embed"]["w"] * np.float32(0.05)
    return build_model(cfg, device=dev), convert_params_to_sme(
        params, squeeze=1, backend=backend, device=dev)


def test_decode_chunk_equals_sequential_steps_on_the_card(cuda):
    """decode_chunk over v3 operands (the decode kernel at M = 3) is the
    sequential loop of decode steps, bitwise: logits, liveness, caches."""
    import copy
    api, params = _small_model(cuda)
    rng = np.random.default_rng(1)
    plen = np.array([9, 5, 12])
    logits, caches = api.prefill(params, rng.integers(0, 256, (3, 16)),
                                 s_max=32, plen=plen, backend="v3")
    toks = rng.integers(0, 256, (3, 4))
    toks[:, 0] = logits.argmax(-1).cpu().numpy()
    nvalid, gated = np.array([4, 2, 4]), np.array([True, False, False])
    clog, clive, cc = api.decode_chunk(params, toks, copy.deepcopy(caches),
                                       plen, nvalid, None, gated,
                                       backend="v3")
    sc, live, pos = copy.deepcopy(caches), nvalid > 0, plen.copy()
    for s in range(4):
        lg, sc = api.decode_step(params, toks[:, s:s + 1], sc,
                                 np.where(live, pos, 0), live, backend="v3")
        assert clive[s].cpu().tolist() == live.tolist()
        mask = torch.as_tensor(live, device=cuda)
        assert torch.equal(clog[s][mask], lg[mask])
        greedy = lg.argmax(-1).cpu().numpy()
        pos = np.where(live, pos + 1, pos)
        live = live & (s + 1 < nvalid) & (~gated | (greedy == toks[:, (s + 1)
                                                                   % 4]))
    for a, b in zip(cc, sc):
        for name in a:
            assert torch.equal(a[name], b[name])


def test_spec_round_drafts_through_the_decode_kernel(cuda, monkeypatch):
    """With spec on, the engine's draft steps launch the v3 decode kernel
    with ``plane_depth`` set, and the tokens equal those without spec."""
    from repro_torch.kernels.sme_spmm import sme_spmm_planes_decode as mod
    from repro_torch.serve import Request, ServeEngine
    api, params = _small_model(cuda)

    def served(**kw):
        rng = np.random.default_rng(2)
        reqs = [Request(rid=i, prompt=rng.integers(0, 256, n),
                        max_new_tokens=6) for i, n in enumerate((5, 19, 7))]
        eng = ServeEngine(api, params, slots=3, s_max=48, backend="v3",
                          device=cuda, chunk_len=8, **kw)
        eng.run(reqs, max_steps=100)
        assert all(r.done for r in reqs)
        return [r.out_tokens for r in reqs], eng
    base, _ = served()
    depths, real = [], mod.sme_spmm_planes_decode

    def spy(*a, plane_depth=None):
        depths.append(plane_depth)
        return real(*a, plane_depth=plane_depth)
    spy.launches = 0
    monkeypatch.setattr(mod, "sme_spmm_planes_decode", spy)
    spec, eng = served(spec_depth=2, spec_len=3)
    assert spec == base
    rounds = int(eng._m["spec_rounds"].value)
    assert rounds > 0 and eng._m["spec_rolled_back"].value > 0
    # every linear of every draft step: 7 per layer, 3 steps per round
    assert depths.count(2) == rounds * 3 * 7 * api.cfg.n_layers
    # the wrapper counts its launches on the module's name: the spy here
    assert spy.launches == len(depths)


def _count_dense(monkeypatch):
    """Make the ``torch`` backend's dequant raise: a kernel path must never
    reach it."""
    from repro_torch.core import backend as B

    def refuse(*a, **kw):
        raise AssertionError("the dense torch path ran on the card")
    monkeypatch.setattr(B, "sme_dequant", refuse)


def _served(api, eng_or_params, backend=None, **kw):
    from repro_torch.serve import Request, ServeEngine
    eng = eng_or_params if isinstance(eng_or_params, ServeEngine) else \
        ServeEngine(api, eng_or_params, slots=3, s_max=48, backend=backend,
                    device=api.device, chunk_len=48, **kw)
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, n), max_new_tokens=4)
            for i, n in enumerate((5, 19, 7))]
    eng.run(reqs, max_steps=100)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


@pytest.mark.parametrize("backend", ["auto", "v3", None])
def test_from_artifact_on_the_card_serves_kernels_only(cuda, tmp_path,
                                                       monkeypatch, backend):
    """A compiled artifact boots onto the card and every linear runs a
    kernel: the plan's (auto, v3), or v2 packed at boot for an artifact
    compiled without operands and served under auto; its prefill logits
    agree with the same artifact's on the CPU."""
    import dataclasses
    from repro_torch.compiler import compile_model
    from repro_torch.configs import ARCHS, scale_down
    from repro_torch.convert import to_reference
    from repro_torch.launch.serve import SMALL
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import lm_init
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(scale_down(ARCHS["qwen1.5-0.5b"], **SMALL),
                              dtype="float32")
    dense = lm_init(cfg, np.random.default_rng(0))
    dense["embed"]["w"] = dense["embed"]["w"] * np.float32(0.05)
    path = tmp_path / "m.smez"
    compile_model(to_reference(dense), out=path, backend=backend,
                  extra={"serve_backend": "auto"})
    toks = np.random.default_rng(3).integers(0, 256, (2, 16))
    cpu_api = build_model(cfg, device="cpu")
    cpu = ServeEngine.from_artifact(cpu_api, path, slots=3, s_max=48,
                                    device="cpu")
    want = cpu_api.prefill(cpu.params, toks, s_max=48)[0]
    _count_dense(monkeypatch)
    api = build_model(cfg, device=cuda)
    eng = ServeEngine.from_artifact(api, path, slots=3, s_max=48,
                                    chunk_len=48)
    assert set(eng.stats["backend"].split("+")) <= {"v1", "v2", "v3"}
    counts = (sme_spmm6, sme_spmm, sme_spmm_planes, sme_spmm_planes_decode)
    before = sum(k.launches for k in counts)
    got = api.prefill(eng.params, toks, s_max=48)[0]
    assert _rel(got.cpu(), want) < 1e-4
    _served(api, eng)
    assert sum(k.launches for k in counts) > before


def test_auto_without_operands_packs_v2_once_never_torch(cuda, monkeypatch):
    """``auto`` on the card for weights packed without operands resolves to
    v2 and packs each weight's operands once (the call-time cache), never
    the dense ``torch`` path."""
    from repro_torch.core import backend as B
    api, params = _small_model(cuda, backend=None)
    assert B.resolved_backends(params, "auto") == ("v2",)
    packs, real = [], B.pack_param_operands

    def spy(param, backend):
        packs.append(backend.name)
        return real(param, backend)
    monkeypatch.setattr(B, "pack_param_operands", spy)
    _count_dense(monkeypatch)
    l0 = sme_spmm6.launches
    first, eng = _served(api, params, backend="auto")
    assert eng.stats["backend"] == "v2"
    assert packs == ["v2"] * 7 * api.cfg.n_layers
    again, _ = _served(api, params, backend="auto")
    assert len(packs) == 7 * api.cfg.n_layers          # cached: no repack
    assert again == first and sme_spmm6.launches > l0
    _, packed = _small_model(cuda, backend="v2")
    assert _served(api, packed, backend="v2")[0] == first


def test_rejected_malformed_list_leaves_the_context_usable(cuda):
    """``validate_operands`` refuses, on the host, the lists the kernels
    would trap on (rowid past the row tiles, nnz past L, a v3 group deeper
    than 16 planes); the card launches good operands afterwards."""
    import copy
    from repro_torch.core import backend as B
    from repro_torch.core.integrate import pack_sme_param, to_torch
    w = np.random.default_rng(5).normal(0, 0.05, (384, 256))
    good = to_torch(pack_sme_param(w, backend="all"), cuda)
    for name, key, value in (("v3", "sme_v3_rowid", 3),
                             ("v1", "sme_v1_nnz", 99),
                             ("v2", "sme_v2_nnz", -1)):
        bad = copy.copy(good)
        bad[key] = good[key].clone()
        bad[key].view(-1)[0] = value
        with pytest.raises(ValueError):
            B.validate_operands(bad, name)
        with pytest.raises(ValueError):
            B.ensure_operands({"w": bad}, name)
    deep = copy.copy(good)
    n = int(good["sme_v3_nnz"][0])
    assert n > 16
    deep["sme_v3_rowid"] = good["sme_v3_rowid"].clone()
    deep["sme_v3_last"] = good["sme_v3_last"].clone()
    deep["sme_v3_rowid"][0, :n] = 0
    deep["sme_v3_last"][0, :n] = 0
    deep["sme_v3_last"][0, n - 1] = 1
    with pytest.raises(ValueError, match="planes"):
        B.validate_operands(deep, "v3")
    x = torch.as_tensor(np.random.default_rng(6).normal(0, 1, (4, 384)),
                        dtype=torch.float32, device=cuda)
    ys = [B.sme_apply(x, good, be) for be in ("v1", "v2", "v3")]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[0], ys[2])
    assert _oracle_rel(ys[0], x, sme_compress(w).dequant()) <= TOL_ORACLE
