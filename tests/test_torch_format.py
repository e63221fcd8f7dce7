"""Format parity of the port: the same numpy weights through ``repro`` and
``repro_torch`` give equal ``sme_compress`` fields and byte-identical v3
(plane-CSC) operands, per weight and per converted layer, and bitwise
equal dequantized weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integrate as R
from repro.core.sme import sme_compress as ref_compress
from repro_torch.core import integrate as P
from repro_torch.core.sme import sme_compress

GRID = [(8, 3, 0, None), (8, 3, 1, None), (8, 3, 2, None), (8, 2, 1, None),
        (8, 4, 0, None), (6, 3, 1, None), (6, 2, 2, None),
        (8, 3, 1, 7), (8, 2, 1, 6), (6, 3, 1, 5)]


def _weight(seed, shape=(200, 150)):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, shape)
    w[np.abs(w) < np.quantile(np.abs(w), 0.5)] = 0.0
    return w


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert (a == b).all(), what


@pytest.mark.parametrize("n_bits,window,squeeze,squeeze_max", GRID)
def test_compress_and_pack_byte_identical(n_bits, window, squeeze,
                                          squeeze_max):
    w = _weight(3)
    kw = dict(n_bits=n_bits, window=window, squeeze=squeeze,
              squeeze_max=squeeze_max)
    r, p = ref_compress(w, **kw), sme_compress(w, **kw)
    for f in ("shape", "n_bits", "window", "squeezed", "tile", "method"):
        assert getattr(r, f) == getattr(p, f), f
    for f in ("tiled_codes", "row_exp", "sign_packed", "scale", "occupancy"):
        _same(getattr(r, f), getattr(p, f), f)
    _same(r.tile_squeeze(), p.tile_squeeze(), "tile_squeeze")
    _same(r.plane_occupancy(), p.plane_occupancy(), "plane_occupancy")
    _same(r.dequant(), p.dequant(), "dequant")
    for k in (1, 2, 3):
        _same(r.dequant_topk_planes(k), p.dequant_topk_planes(k), f"top{k}")
    ref_ops, ops = r.pack_plane_csc(), p.pack_plane_csc()
    assert set(ref_ops) == set(ops)
    for op in ops:
        _same(ref_ops[op], ops[op], op)
    # the packed param dict, kernel operands included
    rd = R.pack_sme_param(w, backend="v3", **kw)
    pd = P.pack_sme_param(w, backend="v3", **kw)
    assert set(rd) == set(pd)
    for key in rd:
        _same(rd[key], pd[key], key)


@pytest.mark.parametrize("block", [1, 5, 2048])
def test_plane_bitmaps_in_blocks_byte_identical(monkeypatch, block):
    """``pack_plane_csc`` builds its bitmaps ``PLANE_BLOCK`` (plane, tile)
    entries at a time (bounded host memory for a head slab); any block
    gives the reference's operands byte for byte, over 4 x 3 tiles with
    several planes each."""
    import repro_torch.core.sme as sme
    w = _weight(5, (512, 384))
    want = ref_compress(w).pack_plane_csc()
    monkeypatch.setattr(sme, "PLANE_BLOCK", block)
    got = sme_compress(w).pack_plane_csc()
    assert int(got["nnz"].sum()) > 5          # blocks of 1 and 5: several
    for op in want:
        _same(want[op], got[op], op)


def test_row_perm_param_byte_identical():
    w = _weight(5, (256, 128))
    perm = np.random.default_rng(5).permutation(256)
    rd = R.pack_sme_param(w, backend="v3", row_perm=perm)
    pd = P.pack_sme_param(w, backend="v3", row_perm=perm)
    assert set(rd) == set(pd) and "sme_perm" in pd
    for key in rd:
        _same(rd[key], pd[key], key)


def _layer(seed, d=128, ff=256):
    rng = np.random.default_rng(seed)
    lin = lambda k, n: {"w": rng.normal(0, k ** -0.5, (k, n)).astype(
        np.float32)}
    return {"norm1": {"w": np.ones(d, np.float32)},
            "mix": {"q": {**lin(d, d), "b": np.zeros(d, np.float32)},
                    "o": lin(d, d)},
            "mlp": {"wi": lin(d, ff), "wg": lin(d, ff), "wo": lin(ff, d)},
            "embed": {"w": rng.normal(0, 1, (256, d)).astype(np.float32)}}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_convert_layer_byte_identical():
    tree = _layer(0)
    ref = R.convert_params_to_sme(tree, squeeze=1, backend="v3")
    port = P.convert_params_to_sme(tree, squeeze=1, backend="v3",
                                   device="cpu")
    ref_l, port_l = dict(_leaves(ref)), dict(_leaves(port))
    assert set(ref_l) == set(port_l)
    for path, leaf in ref_l.items():
        _same(leaf, port_l[path].numpy(), "/".join(path))
    # the eligibility floor: embed and norms stay dense, the rest packs
    assert "sme_v3_planes" in port["mlp"]["wo"]["w"]
    assert torch.is_tensor(port["embed"]["w"])
    assert torch.is_tensor(port["mix"]["q"]["b"])


def test_stacked_layers_match_reference_slices():
    """The reference stacks layers with one padded list length L; the
    port's own per-layer operands equal each reference slice packed with
    ``pad_to = L``, and its stacked conversion equals the reference's."""
    rng = np.random.default_rng(1)
    stacked = rng.normal(0, 0.3, (3, 256, 128))
    stacked[1, :128] = 0.0                 # layers differ in list length
    ref = R.convert_params_to_sme({"wi": stacked}, backend="v3")["wi"]
    L = ref["sme_v3_planes"].shape[2]          # [E, Nt, L, bk/8, bn]
    for i in range(3):
        ops = sme_compress(stacked[i]).pack_plane_csc(pad_to=L)
        for op, arr in ops.items():
            _same(ref[f"sme_v3_{op}"][i], arr, f"{op}[{i}]")
        own = P.pack_sme_param(stacked[i], backend="v3")["sme_v3_planes"]
        assert own.shape[1] <= L
        _same(np.asarray(ref["sme_v3_planes"][i])[:, :own.shape[1]], own,
              f"own-L planes[{i}]")
    port = P.convert_params_to_sme({"wi": stacked}, backend="v3",
                                   device="cpu")["wi"]
    for key, leaf in ref.items():
        _same(leaf, port[key].numpy(), key)


@pytest.mark.parametrize("perm", [False, True])
def test_dequant_bitwise(perm):
    w = _weight(7, (256, 200))
    kw = {"row_perm": np.random.default_rng(7).permutation(256)} if perm \
        else {}
    packed = R.pack_sme_param(w, squeeze_max=6, **kw)
    ref = np.asarray(R.sme_dequant_jnp(
        {k: jnp.asarray(v) for k, v in packed.items()}, dtype=jnp.float32))
    port = P.sme_dequant(P.to_torch(packed, "cpu")).numpy()
    _same(ref, port, "dequant")


def test_to_torch_copies_read_only_arrays():
    a = jax.numpy.arange(4.0)
    t = P.to_torch({"a": np.asarray(a)}, "cpu")["a"]
    t += 1                                  # the tensor owns its memory
    assert np.asarray(a).tolist() == [0.0, 1.0, 2.0, 3.0]
