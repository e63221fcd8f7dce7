"""Shared scaffolding of the CSC-of-tiles kernels (v1, v2, v3): bitmap
decode, the tile-group view of a v3 plane list, operand checks per
format, and the plain PyTorch walk every plain version runs
(:func:`tile_dot_plain`: one matmul per tile group, summed in list order
up to ``nnz[j]``).

Checked against ``repro/kernels/sme_spmm/csc_grid.py`` (``unpack_row_bits``
and the ``csc_step`` walk) and ``sme_spmm_planes_decode.py``
(``plane_group_index``).  The CUDA kernels' device walks and tile decoders
are in ``kernels/csrc/ordered_partials.cuh``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["unpack_row_bits", "plane_group_index", "tile_dot_plain",
           "csc_dot_plain", "splice_dot_plain", "check_operands",
           "check_v1_operands", "check_v2_operands", "check_aligned"]


def unpack_row_bits(packed: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """u8 [..., bk//8, bn] row-packed bitmap (np.packbits along rows, MSB
    first: byte ``r`` bit ``7-i`` is row ``8r+i``) -> u8 0/1 [..., bk, bn]."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                          device=packed.device).view(8, 1)
    bits = (packed.unsqueeze(-2) >> shifts) & 1
    return bits.reshape(*packed.shape[:-2], bk, bn)


def _slot_groups(last: torch.Tensor, nnz: torch.Tensor, G: int):
    """Per slot: valid (``l < nnz[j]``), group start flag, group index
    (``G`` on padding slots)."""
    nt, L = last.shape
    iota = torch.arange(L, device=last.device).expand(nt, L)
    valid = iota < nnz[:, None]
    prev_last = torch.cat([torch.ones_like(last[:, :1]), last[:, :-1]], 1)
    is_start = (prev_last == 1) & valid
    gidx = torch.where(valid, torch.cumsum(is_start, 1) - 1,
                       torch.full_like(iota, G)).clamp(max=G)
    return iota, valid, is_start, gidx


def plane_group_index(rowid: torch.Tensor, last: torch.Tensor,
                      nnz: torch.Tensor, G: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Tile-group view of a v3 plane-CSC list: a group is the run of planes
    of one (row, col) tile, ending at a ``last == 1`` slot.  Returns
    ``(g_rowid, g_start, g_count)`` each i64 [Nt, G] and ``g_nnz`` [Nt];
    unused groups have count 0 and start 0."""
    nt, L = rowid.shape
    iota, valid, is_start, gidx = _slot_groups(last, nnz, G)
    # one spare column takes the padding slots' scatters and is dropped
    g_start = torch.full((nt, G + 1), L, dtype=torch.int64,
                         device=rowid.device).scatter_reduce(
        1, gidx, iota, "amin")[:, :G]
    g_start = torch.where(g_start == L, torch.zeros_like(g_start), g_start)
    g_count = torch.zeros((nt, G + 1), dtype=torch.int64,
                          device=rowid.device).scatter_add(
        1, gidx, valid.long())[:, :G]
    g_rowid = torch.zeros((nt, G + 1), dtype=torch.int64,
                          device=rowid.device).scatter_reduce(
        1, gidx, torch.where(valid, rowid.long(), 0), "amax")[:, :G]
    return g_rowid, g_start, g_count, is_start.sum(1)


def tile_dot_plain(x: torch.Tensor, w: torch.Tensor, rowid: torch.Tensor,
                   count: torch.Tensor) -> torch.Tensor:
    """``sum_g x[:, rowid[j, g]] @ w[j, g]`` per column tile ``j`` over its
    first ``count[j]`` groups, in group order: [M, Nt*bn] f32.

    ``w``: f32 [Nt, G, bk, bn] signed, row-scaled weight tiles; ``rowid``:
    [Nt, G] row tile of each.  One batched matmul computes every group's
    product, then the products are summed one group after another, as the
    kernels do, so formats whose tiles agree agree bitwise here too."""
    nt, G, bk, bn = w.shape
    m = x.shape[0]
    xt = x.float().view(m, -1, bk)[:, rowid.long()]        # [M, Nt, G, bk]
    t = torch.matmul(xt.permute(1, 2, 0, 3), w.contiguous())  # [Nt, G, M, bn]
    t = t * (torch.arange(G, device=x.device) < count[:, None])[..., None, None]
    acc = torch.zeros((nt, m, bn), dtype=torch.float32, device=x.device)
    for g in range(G):
        acc += t[:, g]
    return acc.permute(1, 0, 2).reshape(m, nt * bn)


def csc_dot_plain(x: torch.Tensor, tiles, rowid: torch.Tensor,
                  nnz: torch.Tensor) -> torch.Tensor:
    """The tile-CSC (v1/v2) walk: ``tiles(G)`` gives the signed, row-scaled
    f32 weight tiles [Nt, G, bk, bn] of the first ``G`` list slots, one
    group per slot; slots past ``nnz[j]`` are skipped."""
    G = min(max(int(nnz.max()), 1), rowid.shape[1])
    return tile_dot_plain(x, tiles(G), rowid[:, :G], nnz)


def splice_dot_plain(x: torch.Tensor, planes: torch.Tensor,
                     sign: torch.Tensor, rowscale: torch.Tensor,
                     rowid: torch.Tensor, shift: torch.Tensor,
                     last: torch.Tensor, nnz: torch.Tensor,
                     plane_depth: Optional[int] = None) -> torch.Tensor:
    """Unscaled ``x @ W_codes`` [M, Nt*bn] f32, in plain tensor ops.

    Every column's plane list is spliced per group (``bits * 2^shift``,
    exact in f32), the group's tile is signed and row-scaled, one matmul
    runs per group, and the group products are summed in list order, as
    the kernels do.  ``plane_depth`` keeps only each group's first
    ``max(plane_depth, 1)`` planes."""
    nt, L, bk8, bn = planes.shape
    bk = bk8 * 8
    m = x.shape[0]
    iota, valid, is_start, gidx = _slot_groups(last, nnz, L)
    G = max(int(is_start.sum(1).max()), 1)
    g_rowid, g_start, _, g_nnz = plane_group_index(rowid, last, nnz, G)
    gi = gidx.clamp(max=G - 1)
    keep = valid
    if plane_depth is not None:
        rank = iota - g_start.gather(1, gi)
        keep = keep & (rank < max(int(plane_depth), 1))
    bits = unpack_row_bits(planes, bk, bn).float()
    bits = bits * (torch.exp2(shift.float()) * keep)[..., None, None]
    # sums of distinct powers of two: exact in any order
    wg = torch.zeros((nt * G, bk, bn), dtype=torch.float32, device=x.device)
    flat = (torch.arange(nt, device=x.device)[:, None] * G + gi).reshape(-1)
    wg.index_add_(0, flat, bits.reshape(nt * L, bk, bn))
    cols = torch.arange(nt, device=x.device)[:, None]
    sgn = 1.0 - 2.0 * unpack_row_bits(sign[g_rowid, cols], bk, bn).float()
    w = wg.view(nt, G, bk, bn) * sgn * rowscale[g_rowid, cols][..., None]
    return tile_dot_plain(x, w, g_rowid, g_nnz)


def _check(x, want: dict, bk: int, bn: int, m_multiple: int) -> None:
    """Raise on operands the kernels (and their plain versions) do not
    take: wrong dtype, shape, device or layout."""
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, want "
                             f"{dtype} {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.device.type == "cuda":
        if x.dtype != torch.float32:
            raise ValueError(f"x: {x.dtype}, the CUDA kernels take float32")
        if (bk, bn) != (128, 128):
            raise ValueError(f"tile {(bk, bn)}: the CUDA kernels take 128x128")
        bad = [n for n, (t, _, _) in want.items() if not t.is_contiguous()]
        if bad or not x.is_contiguous():
            raise ValueError(f"non-contiguous operands: {bad or ['x']}")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")


def check_aligned(**tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: the
    kernels that copy with cp.async read 16 bytes at a time."""
    bad = [n for n, t in tensors.items() if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"operands not 16-byte aligned: {bad}")


def _check_x(x, bk: int, m_multiple: int) -> int:
    """Check x's shape; return the number of row tiles."""
    if x.dim() != 2 or x.shape[0] % m_multiple or x.shape[1] % bk:
        raise ValueError(f"x {tuple(x.shape)}: want [M, K_pad] with M a "
                         f"multiple of {m_multiple} and K_pad of {bk}")
    return x.shape[1] // bk


def check_operands(x, planes, sign, rowscale, rowid, shift, last, nnz,
                   m_multiple: int) -> None:
    """The v3 (plane-CSC) operand check."""
    nt, L, bk8, bn = planes.shape
    bk = bk8 * 8
    nr = _check_x(x, bk, m_multiple)
    _check(x, {"planes": (planes, torch.uint8, (nt, L, bk8, bn)),
               "sign": (sign, torch.uint8, (nr, nt, bk8, bn)),
               "rowscale": (rowscale, torch.float32, (nr, nt, bk)),
               "rowid": (rowid, torch.int32, (nt, L)),
               "shift": (shift, torch.int32, (nt, L)),
               "last": (last, torch.int32, (nt, L)),
               "nnz": (nnz, torch.int32, (nt,))}, bk, bn, m_multiple)


def check_v1_operands(x, codes, sign, rowscale, rowid, nnz,
                      m_multiple: int = 8) -> None:
    """The v1 (tile-CSC bytecode) operand check: signs and rowscale per
    list slot."""
    nt, L, bk, bn = codes.shape
    _check_x(x, bk, m_multiple)
    _check(x, {"codes": (codes, torch.uint8, (nt, L, bk, bn)),
               "sign": (sign, torch.uint8, (nt, L, bk // 8, bn)),
               "rowscale": (rowscale, torch.float32, (nt, L, bk)),
               "rowid": (rowid, torch.int32, (nt, L)),
               "nnz": (nnz, torch.int32, (nt,))}, bk, bn, m_multiple)


def check_v2_operands(x, packed, rowscale, rowid, nnz,
                      m_multiple: int = 8) -> None:
    """The v2 (tile-CSC minifloat-6) operand check: 3 bytes per 4 codes."""
    nt, L, bk, nbytes = packed.shape
    if nbytes % 3:
        raise ValueError(f"packed rows of {nbytes} bytes: want 3 per 4 codes")
    _check_x(x, bk, m_multiple)
    _check(x, {"packed": (packed, torch.uint8, (nt, L, bk, nbytes)),
               "rowscale": (rowscale, torch.float32, (nt, L, bk)),
               "rowid": (rowid, torch.int32, (nt, L)),
               "nnz": (nnz, torch.int32, (nt,))}, bk, nbytes // 3 * 4,
           m_multiple)
