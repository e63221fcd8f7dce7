"""v3-decode: plane-CSC dequant-GEMV for decode-sized batches.

Checked against ``repro/kernels/sme_spmm/sme_spmm_planes_decode.py``
(``sme_spmm_planes_decode`` and ``plane_group_index``).  The CUDA kernel is
``kernels/csrc/sme_spmm_planes_decode.cu``; its source note gives the bound
on the card and what the design does about it.

``y = (x @ W_codes) * colscale`` with ``colscale = scale * 2^-n_bits`` per
output column, fused into the store.  ``plane_depth`` keeps each tile
group's ``max(plane_depth, 1)`` most significant planes: groups are sorted
MSB first, so that is a prefix of the same list (the truncated draft).

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version :func:`sme_spmm_planes_decode_plain` only for CPU tensors.
``sme_spmm_planes_decode.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import build
from .csc_grid import (check_aligned, check_operands, plane_group_index,
                       splice_dot_plain)

__all__ = ["sme_spmm_planes_decode", "sme_spmm_planes_decode_plain",
           "plane_group_index"]


def sme_spmm_planes_decode_plain(x, planes, sign, rowscale, colscale, rowid,
                                 shift, last, nnz,
                                 plane_depth: Optional[int] = None):
    """Plain PyTorch version of the kernel: the same function in tensor
    ops (per-group splice, one matmul per group, list-order sum)."""
    y = splice_dot_plain(x, planes, sign, rowscale, rowid, shift, last, nnz,
                         plane_depth)
    return y * colscale.reshape(1, -1)


def sme_spmm_planes_decode(x: torch.Tensor, planes: torch.Tensor,
                           sign: torch.Tensor, rowscale: torch.Tensor,
                           colscale: torch.Tensor, rowid: torch.Tensor,
                           shift: torch.Tensor, last: torch.Tensor,
                           nnz: torch.Tensor, *,
                           plane_depth: Optional[int] = None) -> torch.Tensor:
    """y [M, Nt*bn] f32, fully scaled.  x: f32 [M, K_pad], M a multiple of
    8; colscale: f32 [Nt, bn]; the rest as ``SMEWeight.pack_plane_csc``.

    Trust boundary: the operand lists must come from packing
    (``SMEWeight.pack_*``, ``convert_params_to_sme``), from loading an
    artifact, or through ``core.backend.validate_operands``.  The wrapper
    checks only dtypes, shapes, devices and alignment (no host pass over
    the lists on the hot path); a list it did not get that way (an
    ``nnz`` outside ``[0, L]``, a tile group deeper than the planes a
    launch stages, more groups in a column than the launch holds) may
    ``__trap()`` on the card (``ordered_partials.cuh``), which leaves the
    CUDA context unusable."""
    check_operands(x, planes, sign, rowscale, rowid, shift, last, nnz,
                   m_multiple=8)
    nt, L, _, bn = planes.shape
    if colscale.dtype != torch.float32 or tuple(colscale.shape) != (nt, bn) \
            or colscale.device != x.device:
        raise ValueError(f"colscale: {colscale.dtype} {tuple(colscale.shape)} "
                         f"on {colscale.device}, want float32 {(nt, bn)}")
    if x.device.type == "cpu":
        return sme_spmm_planes_decode_plain(x, planes, sign, rowscale,
                                            colscale, rowid, shift, last,
                                            nnz, plane_depth)
    if not colscale.is_contiguous():
        raise ValueError("colscale is not contiguous")
    check_aligned(x=x, planes=planes, sign=sign, rowscale=rowscale)
    m, k_pad = x.shape
    y = torch.empty((m, nt * bn), dtype=torch.float32, device=x.device)
    depth = 0 if plane_depth is None else max(int(plane_depth), 1)
    err = build.load("sme_spmm_planes_decode").sme_spmm_planes_decode(
        x.data_ptr(), m, k_pad, planes.data_ptr(), sign.data_ptr(),
        rowscale.data_ptr(), colscale.data_ptr(), rowid.data_ptr(),
        shift.data_ptr(), last.data_ptr(), nnz.data_ptr(), nt, L, depth,
        y.data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sme_spmm_planes_decode launch failed: CUDA "
                           f"error {err}")
    sme_spmm_planes_decode.launches += 1
    return y


sme_spmm_planes_decode.launches = 0
