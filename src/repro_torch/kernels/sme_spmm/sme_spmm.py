"""v1: tile-CSC bytecode dequant-matmul, for decode and prefill batches.

Checked against ``repro/kernels/sme_spmm/sme_spmm.py`` (``sme_spmm``, with
``n_bits = 0`` as the reference backend calls it).  The CUDA kernel is
``kernels/csrc/sme_spmm.cu``; its source note gives the bound on the card
and what the design does about it.

``y = x @ W_codes``, **unscaled**: per occupied tile ``w = code * (1 -
2*signbit) * 2^row_exp``; the caller applies ``(y * scale) * 2^-n_bits``.
The signs and ``rowscale`` are per list slot (``SMEWeight.pack_csc``), not
dense per tile as in v3.  One entry point serves decode-sized M (a cluster
per column strip splits the tiles over its blocks) and larger M (one block
per 64x64 output tile); both add one f32 chain per tile in list order, so
the output equals v2's and the v3 kernels' bitwise.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version :func:`sme_spmm_plain` only for CPU tensors.
``sme_spmm.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import build
from .csc_grid import (check_aligned, check_v1_operands, csc_dot_plain,
                       unpack_row_bits)

__all__ = ["sme_spmm", "sme_spmm_plain"]


def sme_spmm_plain(x, codes, sign, rowscale, rowid, nnz):
    """Plain PyTorch version of the kernel (unscaled): decode each slot's
    tile, one matmul per slot, summed in list order."""
    bk, bn = codes.shape[-2:]

    def tiles(G):
        sgn = 1.0 - 2.0 * unpack_row_bits(sign[:, :G], bk, bn).float()
        return codes[:, :G].float() * sgn * rowscale[:, :G, :, None]
    return csc_dot_plain(x, tiles, rowid, nnz)


def sme_spmm(x: torch.Tensor, codes: torch.Tensor, sign: torch.Tensor,
             rowscale: torch.Tensor, rowid: torch.Tensor, nnz: torch.Tensor
             ) -> torch.Tensor:
    """y [M, Nt*bn] f32, unscaled.  x: f32 [M, K_pad], M a multiple of 8;
    the rest as ``SMEWeight.pack_csc``.

    Trust boundary: the operand lists must come from packing
    (``SMEWeight.pack_*``, ``convert_params_to_sme``), from loading an
    artifact, or through ``core.backend.validate_operands``.  The wrapper
    checks only dtypes, shapes, devices and alignment (no host pass over
    the lists on the hot path); a list it did not get that way (an
    ``nnz`` outside ``[0, L]``, a tile group deeper than the planes a
    launch stages, more groups in a column than the launch holds) may
    ``__trap()`` on the card (``ordered_partials.cuh``), which leaves the
    CUDA context unusable."""
    check_v1_operands(x, codes, sign, rowscale, rowid, nnz)
    if x.device.type == "cpu":
        return sme_spmm_plain(x, codes, sign, rowscale, rowid, nnz)
    check_aligned(x=x, codes=codes, sign=sign, rowscale=rowscale)
    nt, L, _, bn = codes.shape
    m, k_pad = x.shape
    y = torch.empty((m, nt * bn), dtype=torch.float32, device=x.device)
    err = build.load("sme_spmm").sme_spmm(
        x.data_ptr(), m, k_pad, codes.data_ptr(), sign.data_ptr(),
        rowscale.data_ptr(), rowid.data_ptr(), nnz.data_ptr(), nt, L,
        y.data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sme_spmm launch failed: CUDA error {err}")
    sme_spmm.launches += 1
    return y


sme_spmm.launches = 0
