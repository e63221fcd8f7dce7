"""SME execution backends and the one dispatch entry point, ``sme_apply``.

Checked against ``repro/core/backend.py``.  Four backends are registered:

  * ``torch`` — dequantize the packed codes to a dense weight and
    ``torch.matmul`` (the counterpart of the reference's ``xla``; operand
    free, correct on any device);
  * ``v1``    — the tile-CSC bytecode kernel ``sme_spmm`` (``_tile_csc_call``);
  * ``v2``    — the tile-CSC minifloat-6 kernel ``sme_spmm6``
    (``_tile_csc_call``), for the settings :meth:`SpmmV2Backend.supports_settings`
    admits;
  * ``v3``    — the plane-CSC kernels: ``sme_spmm_planes_decode`` when the
    batch is decode-sized (``2*M <= 128``), ``sme_spmm_planes`` otherwise
    (``_v3_call`` and ``_v3_decode_impl``).

Each backend packs its operands from one :class:`SMEWeight`
(``pack_weight``; ``pad_hint`` is the list length one slice needs, so
stacked slices share the largest).  The kernel backends keep the
reference wrappers' epilogue ``y[:m, :n] * scale * qscale`` (qscale
``2^-n_bits`` for v1/v3, ``2^-squeezed`` for v2); the v1/v2 kernels and
the v3 decode kernel take M padded to a multiple of 8 only (rows are
independent, so the results equal the reference's 128-row padding).

``sme_apply`` resolves a backend (:func:`resolve_backend`), gathers the
input by ``sme_perm`` for reordered weights, and loops over stacked lead
dims.  Operands are packed offline (``integrate.convert_params_to_sme``);
a kernel backend asked to serve a param without them raises.

``plane_depth`` (the self-speculative draft, DESIGN.md §11) resolves
through :func:`resolve_spec_depth` (explicit argument > the
:func:`use_spec_depth` context > ``None``).  Only v3 truncates: its draft
runs the decode kernel on each tile group's top planes.  v1, v2 and
``torch`` have no per-plane payload, so their draft is the exact product.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .integrate import sme_dequant
from .minifloat import encode6, pack6
from .sme import csc_tile_order

__all__ = ["SMEBackend", "SpmmV2Backend", "get_backend", "resolve_backend",
           "resolved_backends", "sme_apply", "AUTO_ORDER", "use_spec_depth",
           "resolve_spec_depth"]

_META = ("sme_nbits", "sme_squeezed", "sme_window")
#: M tile of the prefill kernel's padding contract (the reference's bm)
BM = 128


class SMEBackend:
    """One execution strategy for an SME-packed linear layer."""

    name: str = ""
    #: operand names; stored in param dicts as ``sme_<name>_<op>`` (packed
    #: offline by ``integrate.convert_params_to_sme``)
    OPERANDS: Tuple[str, ...] = ()

    def pack_weight(self, smew, pad_to: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
        """This backend's operands of one weight (numpy), lists padded to
        ``pad_to`` entries."""
        return {}

    def pad_hint(self, smew) -> int:
        """List length one slice needs: occupied tiles per column (the
        plane-CSC backend counts (plane, tile) pairs)."""
        return max(int(smew.occupancy.sum(axis=0).max()), 1)

    def supports(self, smew) -> bool:
        return True

    def matmul2d(self, x2d: torch.Tensor, ops: Dict[str, torch.Tensor],
                 param: dict, plane_depth=None) -> torch.Tensor:
        """[M, K] @ packed -> [M, N] float32.  ``plane_depth`` asks for
        the truncated draft product; backends without per-plane payload
        ignore it (their draft is exact)."""
        raise NotImplementedError(f"backend {self.name!r} has no operands")

    def key(self, op: str) -> str:
        return f"sme_{self.name}_{op}"

    def has_operands(self, param: dict) -> bool:
        return all(self.key(op) in param for op in self.OPERANDS)


class TorchBackend(SMEBackend):
    """Dequantize to a dense weight, then ``torch.matmul``."""

    name = "torch"


def _qscale(param: dict, like: torch.Tensor, key: str = "sme_nbits",
            default: int = 8) -> torch.Tensor:
    """2^-param[key] (n_bits, or v2's squeezed) as an f32 tensor (exact)."""
    v = torch.as_tensor(param.get(key, default), dtype=torch.float32,
                        device=like.device)
    return torch.exp2(-v)


def _m8(m: int) -> int:
    """Rows padded to a multiple of 8 (at least 8): what the v1/v2 kernels
    and the v3 decode kernel take."""
    return -(-max(m, 8) // 8) * 8


def _padded_x(x2d: torch.Tensor, mp: int, kp: int) -> torch.Tensor:
    """x zero-padded to [mp, kp] in f32 (exact for bf16 inputs: the kernels
    compute in f32 as the reference kernels' ``astype`` does)."""
    m, k = x2d.shape
    xp = torch.zeros((mp, kp), dtype=torch.float32, device=x2d.device)
    xp[:m, :k] = x2d
    return xp


def _use_decode_kernel(m: int, bm: int) -> bool:
    """Decode kernel iff M is at most half an M tile, i.e. when the matmul
    grid would waste most of its padded rows."""
    return 2 * m <= bm


def _tile_csc_call(kernel, x2d, args, bk: int, scale, qscale, *,
                   n: int) -> torch.Tensor:
    """v1/v2: the kernel output is the unscaled product; n_bits (v1) or
    squeezed (v2) is folded into qscale, exactly."""
    m, k = x2d.shape
    xp = _padded_x(x2d, _m8(m), -(-k // bk) * bk)
    return kernel(xp, *args)[:m, :n] * scale * qscale


class SpmmV1Backend(SMEBackend):
    """``sme_spmm``: uint8 codewords + per-slot sign bitmap, tile skip."""

    name = "v1"
    OPERANDS = ("codes", "sign", "rowscale", "rowid", "nnz")

    def pack_weight(self, smew, pad_to=None):
        return smew.pack_csc(pad_to=pad_to)

    def matmul2d(self, x2d, ops, param, plane_depth=None):
        from ..kernels.sme_spmm.sme_spmm import sme_spmm
        return _tile_csc_call(
            sme_spmm, x2d, [ops[o] for o in self.OPERANDS],
            ops["codes"].shape[-2], param["sme_scale"].reshape(1, -1).float(),
            _qscale(param, x2d), n=param["sme_scale"].shape[-1])


class SpmmV2Backend(SMEBackend):
    """``sme_spmm6``: minifloat-6 payload (0.75 B/weight), tile skip."""

    name = "v2"
    OPERANDS = ("packed", "rowscale", "rowid", "nnz")

    @staticmethod
    def supports_settings(n_bits: int, window: int, squeeze: int) -> bool:
        """The minifloat-6 format constraint (lossless re-encoding)."""
        return squeeze >= 1 and window <= 3 and (n_bits - squeeze) <= 7

    def supports(self, smew):
        return self.supports_settings(smew.n_bits, smew.window, smew.squeezed)

    def pack_weight(self, smew, pad_to=None):
        """One CSC gather pass over the occupied tiles (not through
        ``pack_csc``, whose codes and signs v2 would discard)."""
        if not self.supports(smew):
            raise ValueError(
                "backend v2 (minifloat-6) needs squeeze >= 1, window <= 3 "
                f"and live_bits <= 7; got squeeze={smew.squeezed}, "
                f"window={smew.window}, live_bits={smew.live_bits}")
        occ = smew.occupancy
        nc = smew.grid[1]
        tr, tc = smew.tile
        nnz = occ.sum(axis=0).astype(np.int32)
        L = int(pad_to if pad_to is not None else max(int(nnz.max()), 1))
        if int(nnz.max()) > L:
            raise ValueError(
                f"pad_to={L} < max nnz per column {int(nnz.max())}")
        packed = np.zeros((nc, L, tr, 3 * tc // 4), np.uint8)
        rowscale = np.ones((nc, L, tr), dtype=np.float32)
        rowid = np.zeros((nc, L), dtype=np.int32)
        col, row, slot = csc_tile_order(occ)
        if col.size:
            c6 = encode6(smew.tiled_codes[row, col],
                         smew.sign_tiled()[row, col],
                         smew.n_bits, smew.squeezed)
            packed[col, slot] = pack6(c6)
            rowscale[col, slot] = (2.0 ** smew.row_exp[row, col]
                                   ).astype(np.float32)
            rowid[col, slot] = row
        return {"packed": packed, "rowscale": rowscale, "rowid": rowid,
                "nnz": nnz}

    def matmul2d(self, x2d, ops, param, plane_depth=None):
        from ..kernels.sme_spmm.sme_spmm6 import sme_spmm6
        # the kernel decodes with squeezed = 0
        return _tile_csc_call(
            sme_spmm6, x2d, [ops[o] for o in self.OPERANDS],
            ops["packed"].shape[-2], param["sme_scale"].reshape(1, -1).float(),
            _qscale(param, x2d, "sme_squeezed", 1),
            n=param["sme_scale"].shape[-1])


def _v3_call(x2d, ops, scale, qscale, *, n: int) -> torch.Tensor:
    from ..kernels.sme_spmm.sme_spmm_planes import sme_spmm_planes
    m, k = x2d.shape
    bk = ops["planes"].shape[-2] * 8
    nr = -(-k // bk)
    xp = _padded_x(x2d, -(-m // BM) * BM, nr * bk)
    y = sme_spmm_planes(xp, ops["planes"], ops["sign"], ops["rowscale"],
                        ops["rowid"], ops["shift"], ops["last"], ops["nnz"])
    # the kernel output is the unscaled codeword product
    return y[:m, :n] * scale * qscale


def _v3_decode_impl(x2d, ops, scale, qscale, *, n: int,
                    plane_depth: Optional[int] = None) -> torch.Tensor:
    from ..kernels.sme_spmm.sme_spmm_planes_decode import \
        sme_spmm_planes_decode
    m, k = x2d.shape
    nt, _, bk8, bn = ops["planes"].shape
    nr = -(-k // (bk8 * 8))
    xp = _padded_x(x2d, _m8(m), nr * bk8 * 8)
    # scale * 2^-n_bits fused into the kernel's store: bitwise equal to the
    # prefill path's (y * scale) * qscale, since qscale is a power of two
    colscale = torch.zeros(nt * bn, dtype=torch.float32, device=x2d.device)
    colscale[:n] = scale.reshape(-1) * qscale
    y = sme_spmm_planes_decode(xp, ops["planes"], ops["sign"],
                               ops["rowscale"], colscale.reshape(nt, bn),
                               ops["rowid"], ops["shift"], ops["last"],
                               ops["nnz"], plane_depth=plane_depth)
    return y[:m, :n]


class SpmmV3Backend(SMEBackend):
    """The plane-CSC kernels: 1-bit bitmaps per occupied (plane, tile)."""

    name = "v3"
    OPERANDS = ("planes", "sign", "rowscale", "rowid", "shift", "last",
                "nnz")

    def pad_hint(self, smew):
        return max(int(smew.plane_occupancy().sum(axis=(0, 1)).max()), 1)

    def pack_weight(self, smew, pad_to=None):
        return smew.pack_plane_csc(pad_to=pad_to)

    def matmul2d(self, x2d, ops, param, plane_depth=None):
        n = param["sme_scale"].shape[-1]
        scale = param["sme_scale"].reshape(1, -1).float()
        qscale = _qscale(param, x2d)
        m = x2d.shape[0]
        # truncation lives in the decode kernel's tile-group walk, so a
        # draft takes it whenever the batch fits one M tile; past that the
        # draft is the exact product (a correct draft, not a shortcut)
        if _use_decode_kernel(m, BM) or (plane_depth is not None
                                         and m <= BM):
            return _v3_decode_impl(x2d, ops, scale, qscale, n=n,
                                   plane_depth=plane_depth)
        return _v3_call(x2d, ops, scale, qscale, n=n)


_REGISTRY: Dict[str, SMEBackend] = {
    b.name: b for b in (TorchBackend(), SpmmV1Backend(), SpmmV2Backend(),
                        SpmmV3Backend())}
#: ``auto`` serves the first of these whose operands a param carries: the
#: smallest guaranteed payload first (a weight packed for v3 alone, as a
#: compiler plan may choose, serves through v3), as the reference does
AUTO_ORDER = ("v2", "v3", "v1")


def get_backend(name: str) -> SMEBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown SME backend {name!r}; registered: "
                       f"{tuple(_REGISTRY)}") from None


def resolve_backend(param: Optional[dict] = None,
                    name: Optional[str] = None) -> SMEBackend:
    """An explicit name, else (``None`` or ``"auto"``) the first backend of
    :data:`AUTO_ORDER` whose operands ``param`` carries, else ``torch``."""
    if name not in (None, "auto"):
        return get_backend(name)
    if param is not None:
        for cand in AUTO_ORDER:
            if _REGISTRY[cand].has_operands(param):
                return _REGISTRY[cand]
    return _REGISTRY["torch"]


def resolved_backends(params, name: Optional[str] = None) -> Tuple[str, ...]:
    """Sorted names of the backends the packed weights of a param tree
    resolve to under ``name`` (empty for a dense tree)."""
    found = set()

    def walk(t):
        if isinstance(t, dict):
            if "sme_codes" in t:
                found.add(resolve_backend(t, name).name)
                return
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(params)
    return tuple(sorted(found))


#: scoped draft plane-depth (use_spec_depth); None = full precision
_spec_stack: list = [None]


@contextlib.contextmanager
def use_spec_depth(depth):
    """Scoped draft plane-depth for every ``sme_apply`` underneath: the
    draft pass runs its whole forward inside ``with use_spec_depth(...)``.
    Takes an int (uniform depth), ``"plan"`` (each layer's
    ``sme_draft_planes``, full precision where absent) or ``None`` (no-op,
    so call sites thread an optional knob without branching)."""
    if depth is None:
        yield
        return
    _spec_stack.append(depth)
    try:
        yield
    finally:
        _spec_stack.pop()


def resolve_spec_depth(param: Optional[dict] = None, plane_depth=None):
    """Draft plane-depth of one dispatch: explicit argument >
    :func:`use_spec_depth` context > ``None`` (full precision).  ``"plan"``
    reads the param's ``sme_draft_planes`` (absent or not positive: full
    precision); any other string raises.  Returns ``None``, an int, or a
    stacked integer array (one depth per lead index)."""
    depth = plane_depth if plane_depth is not None else _spec_stack[-1]
    if depth is None:
        return None
    if isinstance(depth, str):
        if depth != "plan":
            raise ValueError(f"plane_depth must be an int, 'plan', or None; "
                             f"got {depth!r}")
        if param is None or "sme_draft_planes" not in param:
            return None
        depth = param["sme_draft_planes"]
    arr = np.asarray(depth.cpu() if torch.is_tensor(depth) else depth)
    if arr.size == 0 or int(arr.max()) <= 0:
        return None
    return int(arr) if arr.ndim == 0 else arr


def sme_apply(x: torch.Tensor, param: dict, backend: Optional[str] = None,
              *, out_dtype=None, plane_depth=None) -> torch.Tensor:
    """y = x @ W_eff for an SME-packed param dict; x: [..., K] -> [..., N].

    A param with lead dims ``E`` (stacked weights) takes x [*E, ..., K] and
    runs one kernel call per slice.  ``plane_depth`` (default through
    :func:`resolve_spec_depth`) asks for the truncated top-planes draft
    product; it is resolved for v3 only, and a stacked depth is sliced per
    lead index."""
    be = resolve_backend(param, backend)
    pd = resolve_spec_depth(param, plane_depth) if be.name == "v3" else None
    out_dtype = out_dtype or x.dtype
    lead = tuple(param["sme_codes"].shape[:-4])
    k, n = param["sme_sign"].shape[-2], param["sme_scale"].shape[-1]
    if not be.OPERANDS:
        w = sme_dequant(param, dtype=x.dtype)
        return torch.matmul(x, w).to(out_dtype)
    if not be.has_operands(param):
        raise ValueError(f"param has no {be.name} operands: convert it with "
                         f"convert_params_to_sme(..., backend={be.name!r})")
    ops = {op: param[be.key(op)] for op in be.OPERANDS}
    if "sme_perm" in param:
        # reordered weight: operands hold W[perm, :], so gather the input
        # to match (x[..., p] @ W[p, :] == x @ W)
        x = x[..., param["sme_perm"].long()]
    if not lead:
        y = be.matmul2d(x.reshape(-1, k), ops, param, plane_depth=pd)
        return y.reshape(*x.shape[:-1], n).to(out_dtype)
    nl = len(lead)
    if tuple(x.shape[:nl]) != lead:
        raise ValueError(f"stacked SME param lead dims {lead} do not match "
                         f"x leading shape {tuple(x.shape[:nl])}")
    ys = []
    for idx in np.ndindex(*lead):
        ops_i = {op: v[idx] for op, v in ops.items()}
        meta_i = {mk: param[mk][idx] if param[mk].dim() == nl else param[mk]
                  for mk in _META if mk in param}
        param_i = {"sme_scale": param["sme_scale"][idx],
                   "sme_sign": param["sme_sign"][idx], **meta_i}
        pd_i = pd[idx] if getattr(pd, "ndim", 0) == nl else pd
        pd_i = None if pd_i is None or int(pd_i) <= 0 else int(pd_i)
        ys.append(be.matmul2d(x[idx].reshape(-1, k), ops_i, param_i,
                              plane_depth=pd_i))
    return torch.stack(ys).reshape(lead + tuple(x.shape[nl:-1]) + (n,)
                                   ).to(out_dtype)
