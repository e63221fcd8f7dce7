"""SME <-> model integration: pack a model's linear weights and dequantize
them for the operand-free backend.

Checked against ``repro/core/integrate.py``: ``pack_sme_param`` and
``convert_params_to_sme`` emit the same packed dict (same keys, dtypes and
bytes; ``sme_<name>_*`` operands of each backend ``backend`` names), with
the same eligibility rule and the same execution of a compiler plan
(per-layer settings, 2-D row reordering, ``sme_draft_planes``), so a
``.smez`` of either package holds the same bytes; ``sme_dequant`` is the
counterpart of ``sme_dequant_jnp``: the dense weight of the ``torch``
backend and the CPU oracle of the kernels; ``sme_storage_summary`` counts
bytes as the reference does.  Packing is numpy on the host and compresses
each weight once, whatever the number of operand sets; the converted tree
holds torch tensors on the requested device.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..device import resolve_device
from .sme import SMEWeight, sme_compress

__all__ = ["pack_sme_param", "convert_params_to_sme", "sme_dequant",
           "sme_storage_summary", "sme_operand_bytes", "to_torch"]


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


def _backend_names(backend) -> tuple:
    """Operand sets to emit: none for ``None``/``"torch"``/``"auto"``
    (auto resolves at call time among what was packed), all three kernel
    formats for ``"all"``, each of a tuple of kernel formats."""
    if backend in (None, "torch", "auto"):
        return ()
    if backend == "all":
        return ("v1", "v2", "v3")
    if backend in ("v1", "v2", "v3"):
        return (backend,)
    if isinstance(backend, tuple) and backend and all(
            b in ("v1", "v2", "v3") for b in backend):
        return backend
    raise ValueError(f"backend {backend!r}: want None, 'torch', 'auto', "
                     f"'v1', 'v2', 'v3', 'all' or a tuple of kernel "
                     f"formats")


def pack_sme_param(w2d: np.ndarray, n_bits=8, window=3, squeeze=1,
                   tile=(128, 128), backend=None, row_perm=None,
                   squeeze_max=None) -> dict:
    """Compress one 2-D weight to the packed dict (numpy), with the kernel
    operands of each backend ``backend`` names under ``sme_<name>_*``."""
    from .backend import get_backend
    names = _backend_names(backend)
    smew = sme_compress(np.asarray(w2d, np.float64), n_bits=n_bits,
                        window=window, squeeze=squeeze, tile=tuple(tile),
                        row_perm=row_perm, squeeze_max=squeeze_max)
    out = _raw_param(smew, row_perm)
    for name in names:
        be = get_backend(name)
        for op, arr in be.pack_weight(smew).items():
            out[be.key(op)] = arr
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
                          tile=(128, 128), predicate=None, backend=None,
                          plan=None, squeeze_max=None, device=None):
    """A new param tree (torch tensors on ``device``) with every eligible
    weight SME-packed, with the operands of each backend ``backend`` names
    (``"all"``: v1, v2 and v3, or a tuple such as ``("v2", "v3")``, from
    one compression per weight).  Stacked
    ``[..., K, N]`` weights pack per slice and share each backend's
    largest list length (``pad_hint``), so their operands stack
    rectangularly.  ``predicate(path, leaf)`` replaces the eligibility
    rule.

    ``plan`` (a :class:`repro_torch.compiler.plan.CompilePlan`) overrides
    the global setting per layer, as the reference does: each planned
    weight takes its ``LayerPlan``'s ``(n_bits, window, squeeze,
    squeeze_max, backend)`` and, where the plan marks it, the row
    reordering at the plan's level (2-D weights only: stacked slices share
    one input gather); a layer with ``draft_planes > 0`` carries them as
    an ``sme_draft_planes`` i32 leaf of shape == lead, read under
    ``use_spec_depth("plan")``."""
    return to_torch(_convert(params, n_bits, window, squeeze, tile,
                             predicate, backend, plan, squeeze_max), device)


def _convert(params, n_bits=8, window=3, squeeze=1, tile=(128, 128),
             predicate=None, backend=None, plan=None, squeeze_max=None):
    """:func:`convert_params_to_sme` on the host: the packed tree as
    numpy arrays (what ``compiler.compile_model`` persists)."""
    from .backend import get_backend
    predicate = predicate or _eligible
    tile = tuple(tile)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {key: walk(sub, path + [key]) for key, sub in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(s, path + [str(i)])
                              for i, s in enumerate(tree))
        leaf = np.asarray(tree.cpu() if torch.is_tensor(tree) else tree)
        if not predicate(path, leaf):
            return leaf
        lp = plan.for_path(path) if plan is not None else None
        nb, win, sq = (lp.n_bits, lp.window, lp.squeeze) if lp \
            else (n_bits, window, squeeze)
        sq_max = (lp.squeeze_max or None) if lp else squeeze_max
        names = _backend_names(lp.backend if lp else backend)
        lead = leaf.shape[:-2]
        k, n = leaf.shape[-2:]
        flat = leaf.reshape((-1, k, n))
        perm = None
        if lp is not None and lp.reorder and not lead:
            from ..compiler.reorder import plan_row_permutation
            perm = plan_row_permutation(flat[0], n_bits=nb, window=win,
                                        tile=tile,
                                        level=lp.reorder_level or "tile")
        smews = [sme_compress(np.asarray(w, np.float64), n_bits=nb,
                              window=win, squeeze=sq, tile=tile,
                              row_perm=perm, squeeze_max=sq_max)
                 for w in flat]
        per = [_raw_param(s, perm) for s in smews]
        for be in map(get_backend, names):
            pad_to = max(be.pad_hint(s) for s in smews)
            for p, s in zip(per, smews):
                p.update({be.key(op): a for op, a in
                          be.pack_weight(s, pad_to=pad_to).items()})
        out = {key: np.stack([p[key] for p in per]).reshape(
            lead + per[0][key].shape) for key in per[0]}
        if lp is not None and lp.draft_planes > 0:
            out["sme_draft_planes"] = np.full(lead, lp.draft_planes,
                                              np.int32)
        return out

    return walk(params, [])


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


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _nbytes(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def sme_storage_summary(params) -> dict:
    """Bytes of the packed tree vs what bf16/f32 dense storage would need
    (the reference's count: a packed weight's dense size is its padded
    code array's)."""
    packed = dense16 = dense32 = 0
    for names, leaf in _leaves(params):
        nb = _nbytes(leaf)
        packed += nb
        if "sme_codes" in names:
            n_w = int(np.prod(tuple(leaf.shape)))
            dense16 += 2 * n_w
            dense32 += 4 * n_w
        elif not any(s.startswith("sme_") for s in names):
            dense16 += nb
            dense32 += nb
    return {"packed_bytes": packed, "dense_bf16_bytes": dense16,
            "dense_f32_bytes": dense32,
            "ratio_vs_bf16": dense16 / max(packed, 1)}


def _packed(tree):
    """Every packed weight dict of a param tree."""
    if isinstance(tree, dict):
        if "sme_codes" in tree:
            yield tree
            return
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for sub in tree:
            yield from _packed(sub)


def sme_operand_bytes(params) -> dict:
    """What each kernel backend stores for the packed weights of a tree:
    the bytes of its ``sme_<name>_*`` operands, and ``"weights"``, the
    number of weights they encode (K * N per slice)."""
    out = {"weights": 0}
    for p in _packed(params):
        out["weights"] += int(np.prod(tuple(p["sme_sign"].shape[:-1]))) \
            * int(p["sme_scale"].shape[-1])
        for key, leaf in p.items():
            name = key.split("_")[1]
            if name in ("v1", "v2", "v3"):
                out[name] = out.get(name, 0) + _nbytes(leaf)
    return out
