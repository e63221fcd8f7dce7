"""SME <-> model integration: pack a model's linear weights and dequantize
them for the operand-free backend.

Checked against ``repro/core/integrate.py``: ``pack_sme_param`` and
``convert_params_to_sme`` emit the same packed dict (same keys, dtypes and
bytes; ``sme_v3_*`` operands for ``backend="v3"``), with the same
eligibility rule, and ``sme_dequant`` is the counterpart of
``sme_dequant_jnp``: the dense weight of the ``torch`` backend and the CPU
oracle of the kernels.  Packing is numpy on the host; the converted tree
holds torch tensors on the requested device.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..device import resolve_device
from .sme import SMEWeight, sme_compress

__all__ = ["pack_sme_param", "convert_params_to_sme", "sme_dequant",
           "to_torch"]

_V3 = ("planes", "sign", "rowscale", "rowid", "shift", "last", "nnz")


def _raw_param(smew: SMEWeight, row_perm=None) -> dict:
    k, n = smew.shape
    out = {
        "sme_codes": smew.tiled_codes,                       # [nr,nc,tr,tc] u8
        "sme_rowexp": smew.row_exp,                          # [nr,nc,tr] u8
        "sme_sign": smew.sign_packed,                        # [K, ceil(N/8)] u8
        "sme_scale": np.broadcast_to(
            smew.scale, (1, n)).astype(np.float32).copy(),   # [1, N]
        "sme_nbits": np.asarray(smew.n_bits, np.int32),
        "sme_squeezed": np.asarray(smew.squeezed, np.int32),
        "sme_window": np.asarray(smew.window, np.int32),
        "sme_tilesq": smew.tile_squeeze(),                   # [nr,nc] u8
    }
    if row_perm is not None:
        out["sme_perm"] = np.asarray(row_perm, np.int32)     # [K]
    return out


def _check_backend(backend) -> bool:
    """True when v3 operands are wanted."""
    if backend not in (None, "torch", "v3"):
        raise ValueError(f"backend {backend!r}: the port packs for 'torch' "
                         f"(no operands) or 'v3'")
    return backend == "v3"


def pack_sme_param(w2d: np.ndarray, n_bits=8, window=3, squeeze=1,
                   backend=None, row_perm=None, squeeze_max=None) -> dict:
    """Compress one 2-D weight (128x128 tiles) to the packed dict (numpy),
    with the v3 kernel operands under ``sme_v3_*`` when ``backend="v3"``."""
    smew = sme_compress(np.asarray(w2d, np.float64), n_bits=n_bits,
                        window=window, squeeze=squeeze,
                        row_perm=row_perm, squeeze_max=squeeze_max)
    out = _raw_param(smew, row_perm)
    if _check_backend(backend):
        for op, arr in smew.pack_plane_csc().items():
            out[f"sme_v3_{op}"] = arr
    return out


def _eligible(path_names: List[str], leaf: np.ndarray) -> bool:
    if leaf.ndim < 2:
        return False
    k, n = leaf.shape[-2], leaf.shape[-1]
    if k < 128 or n < 128:
        return False
    if path_names[-1] not in ("w", "wi", "wg", "wo"):
        return False
    return "embed" not in path_names      # the gather path stays dense


def to_torch(tree, device=None):
    """Every array leaf of a dict/list tree as a torch tensor on
    ``device`` (default cuda).  Tensors already there pass through."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if torch.is_tensor(t):
            return t.to(dev)
        arr = np.asarray(t)
        # read-only arrays (views of another framework's buffers) are
        # copied: a tensor must own memory it may write
        return torch.as_tensor(arr if arr.flags.writeable else arr.copy(),
                               device=dev)
    return walk(tree)


def convert_params_to_sme(params, n_bits=8, window=3, squeeze=1,
                          backend=None, squeeze_max=None, device=None):
    """A new param tree (torch tensors on ``device``) with every eligible
    weight SME-packed.  Stacked ``[..., K, N]`` weights pack per slice and
    share one plane-list length, so their operands stack rectangularly."""
    want_v3 = _check_backend(backend)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {key: walk(sub, path + [key]) for key, sub in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(s, path + [str(i)])
                              for i, s in enumerate(tree))
        leaf = np.asarray(tree.cpu() if torch.is_tensor(tree) else tree)
        if not _eligible(path, leaf):
            return leaf
        lead = leaf.shape[:-2]
        k, n = leaf.shape[-2:]
        smews = [sme_compress(np.asarray(w, np.float64), n_bits=n_bits,
                              window=window, squeeze=squeeze,
                              squeeze_max=squeeze_max)
                 for w in leaf.reshape((-1, k, n))]
        per = [_raw_param(s) for s in smews]
        if want_v3:
            pad_to = max(max(int(s.plane_occupancy().sum(axis=(0, 1)).max()),
                             1) for s in smews)
            for p, s in zip(per, smews):
                p.update({f"sme_v3_{op}": a for op, a in
                          s.pack_plane_csc(pad_to=pad_to).items()})
        return {key: np.stack([p[key] for p in per]).reshape(
            lead + per[0][key].shape) for key in per[0]}

    return to_torch(walk(params, []), device)


def sme_dequant(p: dict, dtype=torch.float32) -> torch.Tensor:
    """Packed dict -> dense [..., K, N] weight in ``dtype``."""
    codes = p["sme_codes"]
    lead = tuple(codes.shape[:-4])
    nr, nc, tr, tc = codes.shape[-4:]
    k = p["sme_sign"].shape[-2]
    n = p["sme_scale"].shape[-1]
    nb = torch.as_tensor(p.get("sme_nbits", 8), dtype=torch.float32,
                         device=codes.device)
    nb = nb.reshape(nb.shape + (1,) * (codes.dim() - nb.dim()))
    val = codes.float() * torch.exp2(-nb)
    val = val * torch.exp2(p["sme_rowexp"].float())[..., None]
    nl = len(lead)
    w = val.permute(*range(nl), nl, nl + 2, nl + 1, nl + 3).reshape(
        lead + (nr * tr, nc * tc))[..., :k, :n]
    sb = p["sme_sign"]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=sb.device)
    bits = (sb[..., None] >> shifts) & 1
    sign = 1.0 - 2.0 * bits.reshape(sb.shape[:-1] + (sb.shape[-1] * 8,)
                                    )[..., :n].float()
    w = w * sign * p["sme_scale"]
    if "sme_perm" in p:
        # codes hold W[perm, :]: restore the row order for dense consumers
        w = w[..., torch.argsort(p["sme_perm"].long()), :]
    return w.to(dtype)
