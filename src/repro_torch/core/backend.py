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
dims.  Operands are packed offline (``integrate.convert_params_to_sme``,
or the compiler's ``.smez`` artifact) or once at boot
(:func:`ensure_operands`); a kernel backend named explicitly for a param
without them raises.  ``auto`` on the card, for a param without any
operands, resolves to v2 (v1 where minifloat-6 cannot hold the settings),
as the reference's ``auto`` does on its chip, and packs them once into a
cache keyed by a weakref on the param's ``sme_codes`` (the reference's
``_cached_operands``); on the CPU it resolves to ``torch``.
:func:`cached_dequant` keeps a packed weight's dense matrix the same way,
for a model path that needs the weight itself (MLA's absorbed decode).

:func:`validate_operands` checks an operand list on the host for
everything the kernels would trap on or misread (``nnz`` past the list,
``rowid`` past the row tiles, more tile groups per column than a launch
holds, a v3 group deeper than the 16 planes a launch stages, groups left
open); :func:`ensure_operands` and ``compiler.load_artifact`` call it, so
a malformed list raises ``ValueError`` before any launch.

The backend of a call is its explicit name, else the process default
(:func:`default_backend`: the :func:`use_backend` context, else
:func:`set_default_backend`, else ``SME_BACKEND``, else ``auto``).  v3
takes its decode kernel by the ``SME_DECODE_KERNEL`` rule
(:func:`_use_decode_kernel`: ``auto`` when ``2*M <= bm``, ``on`` when ``M
<= bm``, ``off`` never) with ``bm`` from :func:`resolve_block_m`
(:func:`use_block` > the autotune cache > ``SME_BM`` > 128).  The kernels
fix their own 128x128 tiles, so ``bm`` moves only that threshold; v1 and
v2 pick their walk by M inside the kernel.

``plane_depth`` (the self-speculative draft, DESIGN.md §11) resolves
through :func:`resolve_spec_depth` (explicit argument > the
:func:`use_spec_depth` context > ``None``).  Only v3 truncates: its draft
runs the decode kernel on each tile group's top planes.  v1, v2 and
``torch`` have no per-plane payload, so their draft is the exact product.
"""
from __future__ import annotations

import contextlib
import math
import os
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .integrate import sme_dequant
from .minifloat import encode6, pack6
from .sme import SMEWeight, csc_tile_order

__all__ = ["SMEBackend", "SpmmV2Backend", "get_backend", "resolve_backend",
           "resolved_backends", "sme_apply", "AUTO_ORDER", "use_spec_depth",
           "resolve_spec_depth", "smeweight_from_param",
           "pack_param_operands", "ensure_operands", "validate_operands",
           "default_backend", "set_default_backend", "use_backend",
           "use_block", "resolve_block_m", "cached_dequant"]

_META = ("sme_nbits", "sme_squeezed", "sme_window")
_META_DEFAULTS = {"sme_nbits": 8, "sme_squeezed": 1, "sme_window": 3}
#: planes of one tile group the v3 kernels stage (``kMaxPlanes`` of
#: ``kernels/csrc/ordered_partials.cuh``: codes have at most 16 bits)
MAX_GROUP_PLANES = 16
#: M tile of the prefill kernel's padding contract, and the default ``bm``
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
                 param: dict, plane_depth=None, bm: int = BM
                 ) -> torch.Tensor:
        """[M, K] @ packed -> [M, N] float32.  ``plane_depth`` asks for
        the truncated draft product; backends without per-plane payload
        ignore it (their draft is exact).  ``bm`` is the decode
        threshold's M block (v3 only)."""
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


#: ``SME_DECODE_KERNEL`` values that turn the v3 decode kernel off
_DECODE_OFF = ("off", "0", "never")


def _decode_mode() -> str:
    return os.environ.get("SME_DECODE_KERNEL", "auto").lower()


def _use_decode_kernel(m: int, bm: int) -> bool:
    """The v3 decode-kernel rule (``SME_DECODE_KERNEL``, read per call):
    ``off``/``0`` never, ``on``/``1`` whenever M fits one M block, ``auto``
    (default) when M is at most half a block, i.e. when the matmul grid
    would waste most of its padded rows."""
    mode = _decode_mode()
    if mode in _DECODE_OFF:
        return False
    if mode in ("on", "1", "always"):
        return m <= bm
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

    def matmul2d(self, x2d, ops, param, plane_depth=None, bm=BM):
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

    def matmul2d(self, x2d, ops, param, plane_depth=None, bm=BM):
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
    y = y[:m, :n]
    # on the CPU a strided view of a ragged N takes other elementwise loops
    # downstream (silu's vectorized exp against its scalar one), which
    # round differently from the other paths' contiguous outputs; a CUDA
    # elementwise kernel computes the same either way, so no copy there
    return y.contiguous() if y.device.type == "cpu" else y


class SpmmV3Backend(SMEBackend):
    """The plane-CSC kernels: 1-bit bitmaps per occupied (plane, tile)."""

    name = "v3"
    OPERANDS = ("planes", "sign", "rowscale", "rowid", "shift", "last",
                "nnz")

    def pad_hint(self, smew):
        return max(int(smew.plane_occupancy().sum(axis=(0, 1)).max()), 1)

    def pack_weight(self, smew, pad_to=None):
        return smew.pack_plane_csc(pad_to=pad_to)

    def matmul2d(self, x2d, ops, param, plane_depth=None, bm=BM):
        n = param["sme_scale"].shape[-1]
        scale = param["sme_scale"].reshape(1, -1).float()
        qscale = _qscale(param, x2d)
        m = x2d.shape[0]
        use_decode = _use_decode_kernel(m, bm)
        if plane_depth is not None and not use_decode:
            # truncation lives in the decode kernel's tile-group walk, so a
            # draft takes it whenever the batch fits one M block (unless
            # SME_DECODE_KERNEL is off); otherwise the draft is the exact
            # product (a correct draft, not a shortcut)
            use_decode = m <= bm and _decode_mode() not in _DECODE_OFF
        if use_decode:
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


# ------------------------------------------------ default, block size
#: the process default backend, seeded from ``SME_BACKEND`` (reference
#: ``core/backend.py``'s ``_backend_stack``)
_backend_stack = [os.environ.get("SME_BACKEND", "auto")]


def default_backend() -> str:
    return _backend_stack[-1]


def set_default_backend(name: str) -> None:
    if name != "auto":
        get_backend(name)                     # validate eagerly
    _backend_stack[0] = name


@contextlib.contextmanager
def use_backend(name: Optional[str]):
    """Scoped default backend for every call that names none; ``None`` is
    a no-op, so call sites thread an optional choice without branching."""
    if name is None:
        yield
        return
    if name != "auto":
        get_backend(name)
    _backend_stack.append(name)
    try:
        yield
    finally:
        _backend_stack.pop()


#: scoped ``bm`` (use_block); None = unset
_block_stack: list = [None]


@contextlib.contextmanager
def use_block(bm: Optional[int]):
    """Scoped M block for every ``sme_apply`` underneath; ``None`` is a
    no-op.  It sets v3's decode threshold only (:func:`_use_decode_kernel`):
    the port's kernels fix their own 128x128 tiles."""
    if bm is None:
        yield
        return
    _block_stack.append(int(bm))
    try:
        yield
    finally:
        _block_stack.pop()


def resolve_block_m(backend_name: Optional[str] = None,
                    m: Optional[int] = None, k: Optional[int] = None,
                    n: Optional[int] = None) -> int:
    """The ``bm`` of one dispatch: :func:`use_block` > the active autotune
    cache's best for this backend and shape > ``SME_BM`` > 128."""
    if _block_stack[-1] is not None:
        return _block_stack[-1]
    if backend_name and m and k and n:
        from ..hardware.autotune import get_cache
        cache = get_cache()
        if cache is not None:
            best = cache.best(backend_name, m, k, n)
            if best is not None:
                return best[0]
    env = os.environ.get("SME_BM", "")
    if env.isdigit() and int(env) > 0:
        return int(env)
    return BM


def resolve_backend(param: Optional[dict] = None,
                    name: Optional[str] = None) -> SMEBackend:
    """An explicit name, else the default (:func:`default_backend`); under
    ``"auto"`` the first backend of :data:`AUTO_ORDER` whose operands
    ``param`` carries; for a param without any, on the card v2 (v1 where
    minifloat-6 cannot hold the settings; :func:`sme_apply` packs them
    once), elsewhere ``torch``."""
    name = name or default_backend()
    if name != "auto":
        return get_backend(name)
    if param is not None:
        for cand in AUTO_ORDER:
            if _REGISTRY[cand].has_operands(param):
                return _REGISTRY[cand]
        codes = param.get("sme_codes")
        if torch.is_tensor(codes) and codes.device.type == "cuda":
            return _auto_kernel(param)
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


# ----------------------------------------------------- packing and checking
def _np(a) -> np.ndarray:
    """A host numpy view of a tensor or array leaf."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _meta_int(param: dict, key: str) -> int:
    """A meta value of a packed param (stacked meta: its first slice)."""
    return int(_np(param.get(key, _META_DEFAULTS[key])).reshape(-1)[0])


def _v2_eligible(param: dict) -> bool:
    return SpmmV2Backend.supports_settings(
        _meta_int(param, "sme_nbits"), _meta_int(param, "sme_window"),
        _meta_int(param, "sme_squeezed"))


def smeweight_from_param(param: dict, index: Tuple[int, ...] = ()
                         ) -> SMEWeight:
    """An :class:`SMEWeight` view of one 2-D slice of a packed param
    (``index`` selects into stacked lead dims), rebuilt on the host."""
    codes = _np(param["sme_codes"])[index]
    sign = _np(param["sme_sign"])[index]
    scale = _np(param["sme_scale"])[index]
    return SMEWeight(
        shape=(sign.shape[-2], scale.shape[-1]),
        n_bits=_meta_int(param, "sme_nbits"),
        window=_meta_int(param, "sme_window"),
        squeezed=_meta_int(param, "sme_squeezed"),
        tile=(codes.shape[-2], codes.shape[-1]), method="sme",
        tiled_codes=codes, row_exp=_np(param["sme_rowexp"])[index],
        sign_packed=sign, scale=scale.astype(np.float64),
        occupancy=codes.any(axis=(-1, -2)),
        tile_sq=(_np(param["sme_tilesq"])[index] if "sme_tilesq" in param
                 else None))


def pack_param_operands(param: dict, backend: SMEBackend) -> dict:
    """``backend``'s operands of a packed param, packed on the host from
    its codes (stacked slices share one list length) and returned where
    the param's ``sme_codes`` lives (a tensor's device, else numpy)."""
    host = {k: _np(v) for k, v in param.items()
            if not k.startswith(("sme_v1_", "sme_v2_", "sme_v3_"))}
    lead = tuple(host["sme_codes"].shape[:-4])
    smews = [smeweight_from_param(host, i) for i in np.ndindex(*lead)]
    pad_to = max(backend.pad_hint(s) for s in smews)
    per = [backend.pack_weight(s, pad_to=pad_to) for s in smews]
    ops = {k: np.stack([p[k] for p in per]).reshape(lead + per[0][k].shape)
           for k in per[0]}
    anchor = param["sme_codes"]
    if torch.is_tensor(anchor):
        return {k: torch.as_tensor(v, device=anchor.device)
                for k, v in ops.items()}
    return ops


def ensure_operands(params, backend_name: str):
    """``params`` with ``backend_name``'s operands on every packed weight:
    packed once here where missing (an artifact compiled without them),
    and every list checked by :func:`validate_operands`.  ``"auto"`` takes
    per weight the first operand set of :data:`AUTO_ORDER` it carries,
    else v2 (v1 where minifloat-6 cannot hold its settings): what auto
    serves on the card."""
    if backend_name != "auto" and not get_backend(backend_name).OPERANDS:
        return params

    def walk(tree, path):
        if isinstance(tree, dict):
            if "sme_codes" in tree:
                be = get_backend(backend_name) if backend_name != "auto" \
                    else next((_REGISTRY[c] for c in AUTO_ORDER
                               if _REGISTRY[c].has_operands(tree)),
                              _REGISTRY["v2" if _v2_eligible(tree)
                                        else "v1"])
                out = tree
                if not be.has_operands(tree):
                    out = dict(tree)
                    out.update((be.key(op), arr) for op, arr in
                               pack_param_operands(tree, be).items())
                validate_operands(out, be.name, "/".join(path))
                return out
            return {k: walk(v, path + [str(k)]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(s, path + [str(i)])
                              for i, s in enumerate(tree))
        return tree

    return walk(params, [])


def validate_operands(param: dict, backend: str, where: str = "") -> None:
    """Raise ``ValueError`` unless ``param``'s ``backend`` operand lists
    are ones the kernels take: ``0 <= nnz <= L``; every listed ``rowid``
    a row tile of the weight; at most ``min(row tiles, L)`` tile groups
    per column (what ``decode_walk``'s cluster is sized for; ``tiled_walk``
    holds ``L``); and for v3, ``last`` flags of 0/1 that close every
    group, one row tile per group, shifts below 16 and at most 16 planes
    per group (what a launch stages).  Checks every stacked slice, on the
    host, reading only the index arrays."""
    be = get_backend(backend)
    if not be.OPERANDS:
        return
    what = f"{backend} operands" + (f" of {where}" if where else "")
    if not be.has_operands(param):
        raise ValueError(f"{what}: missing")
    nr = int(param["sme_codes"].shape[-4])
    rowid = _np(param[be.key("rowid")]).astype(np.int64)
    nnz = _np(param[be.key("nnz")]).astype(np.int64)
    L = rowid.shape[-1]
    if nnz.shape != rowid.shape[:-1]:
        raise ValueError(f"{what}: nnz {nnz.shape} does not match rowid "
                         f"{rowid.shape}")
    if nnz.size and (nnz.min() < 0 or nnz.max() > L):
        raise ValueError(f"{what}: nnz in [{nnz.min()}, {nnz.max()}] "
                         f"outside [0, L={L}]")
    valid = np.arange(L) < nnz[..., None]
    if ((rowid < 0) | (rowid >= nr))[valid].any():
        raise ValueError(f"{what}: rowid outside the {nr} row tiles")
    if be.name != "v3":
        groups = nnz
    else:
        last = _np(param[be.key("last")]).astype(np.int64)
        shift = _np(param[be.key("shift")]).astype(np.int64)
        if ((last != 0) & (last != 1))[valid].any():
            raise ValueError(f"{what}: last flags other than 0 and 1")
        if ((shift < 0) | (shift >= MAX_GROUP_PLANES))[valid].any():
            raise ValueError(f"{what}: shift outside [0, "
                             f"{MAX_GROUP_PLANES})")
        nxt = np.zeros_like(valid)
        nxt[..., :-1] = valid[..., 1:]
        if (valid & ~nxt & (last != 1)).any():
            raise ValueError(f"{what}: a column's final group is not "
                             f"closed (last != 1 on its last slot)")
        if (nxt[..., :-1] & (last[..., :-1] == 0)
                & (rowid[..., 1:] != rowid[..., :-1])).any():
            raise ValueError(f"{what}: a group spans two row tiles (rowid "
                             f"changes without last == 1)")
        start = valid.copy()
        start[..., 1:] &= last[..., :-1] == 1
        groups = start.sum(axis=-1)
        # slots per group: bincount of (column, group number) over valid
        col = np.arange(valid[..., 0].size).reshape(valid.shape[:-1])
        gid = (col[..., None] * (L + 1) + np.cumsum(start, axis=-1))[valid]
        depth = int(np.bincount(gid).max()) if gid.size else 0
        if depth > MAX_GROUP_PLANES:
            raise ValueError(f"{what}: a tile group of {depth} planes, more "
                             f"than the {MAX_GROUP_PLANES} a launch stages")
    cap = max(min(nr, L), 1)
    if groups.size and int(groups.max()) > cap:
        raise ValueError(f"{what}: {int(groups.max())} tile groups in a "
                         f"column, more than the {cap} a launch holds "
                         f"(min(row tiles, L))")


#: weight identity -> (weakref to its ``sme_codes``, backend name,
#: operands): auto's call-time packing on the card, once per weight.  The
#: weakref validates an id() hit and its callback evicts the entry when
#: the weight dies, so operands never outlive their weight.
_OPERAND_CACHE: Dict[int, tuple] = {}


def _auto_kernel(param: dict) -> SMEBackend:
    """auto's kernel for a param on the card without operands: the one
    already packed for it, else v2 where minifloat-6 holds the settings,
    else v1."""
    hit = _OPERAND_CACHE.get(id(param["sme_codes"]))
    if hit is not None and hit[0]() is param["sme_codes"]:
        return _REGISTRY[hit[1]]
    return _REGISTRY["v2" if _v2_eligible(param) else "v1"]


def _cached_operands(param: dict, be: SMEBackend) -> dict:
    anchor = param["sme_codes"]
    key = id(anchor)
    hit = _OPERAND_CACHE.get(key)
    if hit is not None and hit[0]() is anchor and hit[1] == be.name:
        return hit[2]
    ops = pack_param_operands(param, be)
    try:
        ref = weakref.ref(anchor, lambda _, k=key: _OPERAND_CACHE.pop(k, None))
    except TypeError:
        return ops              # not weakref-able: do not risk pinning it
    _OPERAND_CACHE[key] = (ref, be.name, ops)
    return ops


#: weight identity -> (weakref to its ``sme_codes``, dense f32 weight):
#: :func:`cached_dequant`'s matrices, evicted with their weight
_DENSE_CACHE: Dict[int, tuple] = {}


def cached_dequant(param: dict) -> torch.Tensor:
    """The dense f32 weight of a packed param (``sme_dequant``: row order
    restored, bitwise the tiles the kernels splice), built once per weight
    and kept while its ``sme_codes`` lives, keyed as auto's operand cache.
    For a model path that needs the weight as a matrix, not a product
    (MLA's absorbed decode of a packed ``kv_up``).  ``cached_dequant.builds``
    counts the matrices built."""
    anchor = param["sme_codes"]
    key = id(anchor)
    hit = _DENSE_CACHE.get(key)
    if hit is not None and hit[0]() is anchor:
        return hit[1]
    w = sme_dequant(param, torch.float32)
    cached_dequant.builds += 1
    try:
        ref = weakref.ref(anchor, lambda _, k=key: _DENSE_CACHE.pop(k, None))
    except TypeError:
        return w
    _DENSE_CACHE[key] = (ref, w)
    return w


cached_dequant.builds = 0


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
    backend = backend or default_backend()
    be = resolve_backend(param, backend)
    pd = resolve_spec_depth(param, plane_depth) if be.name == "v3" else None
    out_dtype = out_dtype or x.dtype
    lead = tuple(param["sme_codes"].shape[:-4])
    k, n = param["sme_sign"].shape[-2], param["sme_scale"].shape[-1]
    if not be.OPERANDS:
        w = sme_dequant(param, dtype=x.dtype)
        return torch.matmul(x, w).to(out_dtype)
    if be.has_operands(param):
        ops = {op: param[be.key(op)] for op in be.OPERANDS}
    elif backend == "auto":
        ops = _cached_operands(param, be)     # auto on the card: pack once
    else:
        raise ValueError(f"param has no {be.name} operands: convert it with "
                         f"convert_params_to_sme(..., backend={be.name!r}) "
                         f"or ensure_operands(params, {be.name!r})")
    if "sme_perm" in param:
        # reordered weight: operands hold W[perm, :], so gather the input
        # to match (x[..., p] @ W[p, :] == x @ W)
        x = x[..., param["sme_perm"].long()]
    bm = resolve_block_m(be.name, x.numel() // (k * math.prod(lead)), k, n)
    if not lead:
        y = be.matmul2d(x.reshape(-1, k), ops, param, plane_depth=pd, bm=bm)
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
                              plane_depth=pd_i, bm=bm))
    return torch.stack(ys).reshape(lead + tuple(x.shape[nl:-1]) + (n,)
                                   ).to(out_dtype)
