"""SME execution backends and the one dispatch entry point, ``sme_apply``.

Checked against ``repro/core/backend.py``.  Two backends are registered:

  * ``torch`` — dequantize the packed codes to a dense weight and
    ``torch.matmul`` (the counterpart of the reference's ``xla``; operand
    free, correct on any device);
  * ``v3``    — the plane-CSC kernels: ``sme_spmm_planes_decode`` when the
    batch is decode-sized (``2*M <= 128``), ``sme_spmm_planes`` otherwise,
    with the reference wrappers' padding and scaling exactly (``_v3_call``
    and ``_v3_decode_impl``).

``sme_apply`` resolves a backend (explicit name, else ``v3`` when the
param carries ``sme_v3_*`` operands, else ``torch``), gathers the input by
``sme_perm`` for reordered weights, and loops over stacked lead dims.
Operands are packed offline (``integrate.convert_params_to_sme``); a kernel
backend asked to serve a param without them raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .integrate import sme_dequant

__all__ = ["SMEBackend", "get_backend", "resolve_backend", "sme_apply"]

_META = ("sme_nbits", "sme_squeezed", "sme_window")
#: M tile of the prefill kernel's padding contract (the reference's bm)
BM = 128


class SMEBackend:
    """One execution strategy for an SME-packed linear layer."""

    name: str = ""
    #: operand names; stored in param dicts as ``sme_<name>_<op>`` (packed
    #: offline by ``integrate.convert_params_to_sme``)
    OPERANDS: Tuple[str, ...] = ()

    def matmul2d(self, x2d: torch.Tensor, ops: Dict[str, torch.Tensor],
                 param: dict) -> torch.Tensor:
        """[M, K] @ packed -> [M, N] float32."""
        raise NotImplementedError(f"backend {self.name!r} has no operands")

    def key(self, op: str) -> str:
        return f"sme_{self.name}_{op}"

    def has_operands(self, param: dict) -> bool:
        return all(self.key(op) in param for op in self.OPERANDS)


class TorchBackend(SMEBackend):
    """Dequantize to a dense weight, then ``torch.matmul``."""

    name = "torch"


def _qscale(param: dict, like: torch.Tensor) -> torch.Tensor:
    """2^-n_bits as an f32 tensor (exact)."""
    nb = torch.as_tensor(param.get("sme_nbits", 8), dtype=torch.float32,
                         device=like.device)
    return torch.exp2(-nb)


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


def _v3_decode_impl(x2d, ops, scale, qscale, *, n: int) -> torch.Tensor:
    from ..kernels.sme_spmm.sme_spmm_planes_decode import \
        sme_spmm_planes_decode
    m, k = x2d.shape
    nt, _, bk8, bn = ops["planes"].shape
    nr = -(-k // (bk8 * 8))
    xp = _padded_x(x2d, -(-max(m, 8) // 8) * 8, nr * bk8 * 8)
    # scale * 2^-n_bits fused into the kernel's store: bitwise equal to the
    # prefill path's (y * scale) * qscale, since qscale is a power of two
    colscale = torch.zeros(nt * bn, dtype=torch.float32, device=x2d.device)
    colscale[:n] = scale.reshape(-1) * qscale
    y = sme_spmm_planes_decode(xp, ops["planes"], ops["sign"],
                               ops["rowscale"], colscale.reshape(nt, bn),
                               ops["rowid"], ops["shift"], ops["last"],
                               ops["nnz"])
    return y[:m, :n]


class SpmmV3Backend(SMEBackend):
    """The plane-CSC kernels: 1-bit bitmaps per occupied (plane, tile)."""

    name = "v3"
    OPERANDS = ("planes", "sign", "rowscale", "rowid", "shift", "last",
                "nnz")

    def matmul2d(self, x2d, ops, param):
        n = param["sme_scale"].shape[-1]
        scale = param["sme_scale"].reshape(1, -1).float()
        qscale = _qscale(param, x2d)
        if _use_decode_kernel(x2d.shape[0], BM):
            return _v3_decode_impl(x2d, ops, scale, qscale, n=n)
        return _v3_call(x2d, ops, scale, qscale, n=n)


_REGISTRY: Dict[str, SMEBackend] = {b.name: b for b in
                                    (TorchBackend(), SpmmV3Backend())}


def get_backend(name: str) -> SMEBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown SME backend {name!r}; registered: "
                       f"{tuple(_REGISTRY)}") from None


def resolve_backend(param: dict, name: Optional[str] = None) -> SMEBackend:
    """Explicit name, else v3 when its operands are packed, else torch."""
    if name is not None:
        return get_backend(name)
    v3 = _REGISTRY["v3"]
    return v3 if v3.has_operands(param) else _REGISTRY["torch"]


def sme_apply(x: torch.Tensor, param: dict, backend: Optional[str] = None,
              *, out_dtype=None) -> torch.Tensor:
    """y = x @ W_eff for an SME-packed param dict; x: [..., K] -> [..., N].

    A param with lead dims ``E`` (stacked weights) takes x [*E, ..., K] and
    runs one kernel call per slice."""
    be = resolve_backend(param, backend)
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
        y = be.matmul2d(x.reshape(-1, k), ops, param)
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
        ys.append(be.matmul2d(x[idx].reshape(-1, k), ops_i, param_i))
    return torch.stack(ys).reshape(lead + tuple(x.shape[nl:-1]) + (n,)
                                   ).to(out_dtype)
