"""v3: plane-CSC dequant-matmul for prefill-sized batches.

Checked against ``repro/kernels/sme_spmm/sme_spmm_planes.py``
(``sme_spmm_planes``).  The CUDA kernel is ``kernels/csrc/sme_spmm_planes.cu``;
its source note gives the bound on the card and what the design does about
it.

``y = x @ W_codes``, **unscaled**: the caller applies
``(y * scale) * 2^-n_bits``.  One block per 64x64 output tile walks a
column's plane list in order with the decode kernel's splice, one f32
chain per tile group, so the two agree bitwise.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version :func:`sme_spmm_planes_plain` only for CPU tensors.
``sme_spmm_planes.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import build
from .csc_grid import check_aligned, check_operands, splice_dot_plain

__all__ = ["sme_spmm_planes", "sme_spmm_planes_plain"]


def sme_spmm_planes_plain(x, planes, sign, rowscale, rowid, shift, last, nnz):
    """Plain PyTorch version of the kernel (unscaled)."""
    return splice_dot_plain(x, planes, sign, rowscale, rowid, shift, last, nnz)


def sme_spmm_planes(x: torch.Tensor, planes: torch.Tensor, sign: torch.Tensor,
                    rowscale: torch.Tensor, rowid: torch.Tensor,
                    shift: torch.Tensor, last: torch.Tensor, nnz: torch.Tensor
                    ) -> torch.Tensor:
    """y [M, Nt*bn] f32, unscaled.  x: f32 [M, K_pad], M a multiple of 128
    (the reference's M tile); the rest as ``SMEWeight.pack_plane_csc``.

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
                   m_multiple=128)
    if x.device.type == "cpu":
        return sme_spmm_planes_plain(x, planes, sign, rowscale, rowid, shift,
                                     last, nnz)
    check_aligned(x=x, planes=planes, sign=sign, rowscale=rowscale)
    nt, L, _, bn = planes.shape
    m, k_pad = x.shape
    y = torch.empty((m, nt * bn), dtype=torch.float32, device=x.device)
    err = build.load("sme_spmm_planes").sme_spmm_planes(
        x.data_ptr(), m, k_pad, planes.data_ptr(), sign.data_ptr(),
        rowscale.data_ptr(), rowid.data_ptr(), shift.data_ptr(),
        last.data_ptr(), nnz.data_ptr(), nt, L, y.data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sme_spmm_planes launch failed: CUDA error {err}")
    sme_spmm_planes.launches += 1
    return y


sme_spmm_planes.launches = 0
