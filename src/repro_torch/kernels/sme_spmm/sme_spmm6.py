"""v2: tile-CSC minifloat-6 dequant-matmul, for decode and prefill batches.

Checked against ``repro/kernels/sme_spmm/sme_spmm6.py`` (``sme_spmm6``, with
``squeezed = 0`` as the reference backend calls it).  The CUDA kernel is
``kernels/csrc/sme_spmm6.cu``; its source note gives the bound on the card
and what the design does about it.

``y = x @ W``, **unscaled**: each tile row holds 4 six-bit codes (sign,
3-bit exponent, 2-bit mantissa) per 3 bytes, decoded as ``(e > 0) * s *
(4 + m) * 2^-(e + 2) * 2^row_exp``; the caller applies ``(y * scale) *
2^-squeezed``.  The decoded tile is the v1 tile times
``2^-(n_bits - squeezed)``, and the kernel sums each output as v1 does
(one f32 chain per tile, tiles added in list order), so after scaling it
equals v1 and v3 bitwise.  One entry point serves decode-sized M (a
cluster per column strip splits the tiles over its blocks) and larger M
(one block per 64x64 output tile).

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version :func:`sme_spmm6_plain` only for CPU tensors.
``sme_spmm6.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import build
from .csc_grid import check_aligned, check_v2_operands, csc_dot_plain

__all__ = ["sme_spmm6", "sme_spmm6_plain", "decode6_plain"]


def decode6_plain(packed: torch.Tensor) -> torch.Tensor:
    """u8 [..., bk, 3*bn/4] -> f32 [..., bk, bn] signed values with
    ``squeezed = 0`` (before ``2^row_exp``).  Shifts in int16, as the
    reference kernel's uint16 (a byte shifted left must not wrap)."""
    t = packed.reshape(*packed.shape[:-1], -1, 3).to(torch.int16)
    b0, b1, b2 = t.unbind(-1)
    c = torch.stack([b0 & 63, ((b0 >> 6) | (b1 << 2)) & 63,
                     ((b1 >> 4) | (b2 << 4)) & 63, (b2 >> 2) & 63], dim=-1
                    ).reshape(*packed.shape[:-1], -1)
    e = (c >> 2) & 7
    s = 1.0 - 2.0 * ((c >> 5) & 1).float()
    mag = (4.0 + (c & 3).float()) * torch.exp2(-(e.float() + 2.0))
    return torch.where(e > 0, s * mag, torch.zeros_like(mag))


def sme_spmm6_plain(x, packed, rowscale, rowid, nnz):
    """Plain PyTorch version of the kernel (unscaled, squeezed = 0)."""
    def tiles(G):
        return decode6_plain(packed[:, :G]) * rowscale[:, :G, :, None]
    return csc_dot_plain(x, tiles, rowid, nnz)


def sme_spmm6(x: torch.Tensor, packed: torch.Tensor, rowscale: torch.Tensor,
              rowid: torch.Tensor, nnz: torch.Tensor) -> torch.Tensor:
    """y [M, Nt*bn] f32, unscaled.  x: f32 [M, K_pad], M a multiple of 8;
    the rest as ``SpmmV2Backend.pack_weight``.

    Trust boundary: the operand lists must come from packing
    (``SMEWeight.pack_*``, ``convert_params_to_sme``), from loading an
    artifact, or through ``core.backend.validate_operands``.  The wrapper
    checks only dtypes, shapes, devices and alignment (no host pass over
    the lists on the hot path); a list it did not get that way (an
    ``nnz`` outside ``[0, L]``, a tile group deeper than the planes a
    launch stages, more groups in a column than the launch holds) may
    ``__trap()`` on the card (``ordered_partials.cuh``), which leaves the
    CUDA context unusable."""
    check_v2_operands(x, packed, rowscale, rowid, nnz)
    if x.device.type == "cpu":
        return sme_spmm6_plain(x, packed, rowscale, rowid, nnz)
    check_aligned(x=x, packed=packed, rowscale=rowscale)
    nt, L, _, nbytes = packed.shape
    m, k_pad = x.shape
    y = torch.empty((m, nt * (nbytes // 3 * 4)), dtype=torch.float32,
                    device=x.device)
    err = build.load("sme_spmm6").sme_spmm6(
        x.data_ptr(), m, k_pad, packed.data_ptr(), rowscale.data_ptr(),
        rowid.data_ptr(), nnz.data_ptr(), nt, L, y.data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sme_spmm6 launch failed: CUDA error {err}")
    sme_spmm6.launches += 1
    return y


sme_spmm6.launches = 0
