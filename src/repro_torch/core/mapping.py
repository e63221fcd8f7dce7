"""Crossbar mapping & resource counting (paper §III-B/C, Figs. 8/11/12),
numpy only.

A copy of ``repro/core/mapping.py``; the compiler prices a layer's
conventional crossbars with ``conventional_crossbar_total``.

Two mapping disciplines are modeled:

* **conventional (ISAAC-style, intra-crossbar slicing)** — each weight's
  ``Nq`` bits occupy ``ceil(Nq / cell_bits)`` *adjacent cells of the same
  crossbar row*; shift-and-add combines adjacent columns.  A crossbar can
  only be dropped if its whole 128x128 cell region is zero (rare): the
  structural-coupling problem.

* **SME (inter-crossbar bit-slicing)** — each bit(-group) plane tile is its
  own crossbar; any all-zero (tile, plane-group) is dropped, and the
  squeeze-out scheme (``core.squeeze``) empties the MSB planes first.

``cell_bits`` models SLC (1) vs MLC (2/3) cells — Fig. 12.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from .bitslice import bit_planes, tile_codes
from .squeeze import SqueezeResult

__all__ = [
    "cells_per_weight",
    "conventional_cell_matrix",
    "conventional_crossbar_count",
    "conventional_crossbar_total",
    "sme_crossbar_count",
    "squeezed_crossbar_count",
    "sparse_cell_count",
]


def cells_per_weight(n_bits: int, cell_bits: int = 1) -> int:
    return math.ceil(n_bits / cell_bits)


def _plane_groups(planes: np.ndarray, cell_bits: int) -> np.ndarray:
    """planes[Nq, ...] -> cell values [ceil(Nq/cb), ...] (MSB group first)."""
    n_bits = planes.shape[0]
    cpw = cells_per_weight(n_bits, cell_bits)
    groups = []
    for g in range(cpw):
        val = np.zeros(planes.shape[1:], dtype=np.uint8)
        for b in range(cell_bits):
            p = g * cell_bits + b
            if p < n_bits:
                val = (val << 1) | planes[p]
        groups.append(val)
    return np.stack(groups)


def conventional_cell_matrix(
    codes: np.ndarray, n_bits: int, cell_bits: int = 1
) -> np.ndarray:
    """[K, N] codewords -> [K, N * cpw] cell values in the interleaved layout."""
    planes = bit_planes(codes, n_bits)               # [Nq, K, N]
    groups = _plane_groups(planes, cell_bits)        # [cpw, K, N]
    cpw, k, n = groups.shape
    return groups.transpose(1, 2, 0).reshape(k, n * cpw)


def conventional_crossbar_total(
    shape: Tuple[int, int], n_bits: int, tile=(128, 128), cell_bits: int = 1
) -> int:
    """Crossbars allocated by the conventional mapping (no dropping)."""
    k, n = shape
    cpw = cells_per_weight(n_bits, cell_bits)
    return math.ceil(k / tile[0]) * math.ceil(n * cpw / tile[1])


def conventional_crossbar_count(
    codes: np.ndarray, n_bits: int, tile=(128, 128), cell_bits: int = 1,
    drop_empty: bool = True,
) -> int:
    """Conventional mapping with (optionally) fully-empty crossbars dropped."""
    if not drop_empty:
        return conventional_crossbar_total(codes.shape, n_bits, tile, cell_bits)
    cells = conventional_cell_matrix(codes, n_bits, cell_bits)
    tiled = tile_codes(cells, tile)
    return int(tiled.any(axis=(-1, -2)).sum())


def sme_crossbar_count(
    codes: np.ndarray, n_bits: int, tile=(128, 128), cell_bits: int = 1
) -> int:
    """SME bit-sliced mapping: one crossbar per non-empty (tile, plane-group)."""
    planes = bit_planes(codes, n_bits)
    groups = _plane_groups(planes, cell_bits)        # [cpw, K, N]
    used = 0
    for g in groups:
        tiled = tile_codes(g, tile)
        used += int(tiled.any(axis=(-1, -2)).sum())
    return used


def squeezed_crossbar_count(sq: SqueezeResult, cell_bits: int = 1) -> int:
    """SME + squeeze-out: non-empty surviving (tile, plane-group) count.

    For MLC, squeezing is only useful in whole-cell units (paper §V-C-2):
    ``sq.squeezed`` bits release ``floor(squeezed / cell_bits)`` cell planes.
    """
    # Live (post-squeeze) planes of the shifted codewords:
    live = []
    for p in range(sq.squeezed + 1, sq.n_bits + 1):
        live.append(((sq.tiled_codes >> (sq.n_bits - p)) & 1).astype(np.uint8))
    live = np.stack(live)                            # [Nq-x, nr, nc, tr, tc]
    cpw = cells_per_weight(live.shape[0], cell_bits)
    used = 0
    for g in range(cpw):
        sl = live[g * cell_bits: (g + 1) * cell_bits]
        occ = sl.any(axis=(0, -1, -2))               # [nr, nc]
        used += int(occ.sum())
    return used


def sparse_cell_count(
    codes: np.ndarray, n_bits: int, cell_bits: int = 1,
    only_allocated: Optional[str] = None, tile=(128, 128),
) -> Tuple[int, int]:
    """(zero_cells, total_cells) under a mapping — the paper's "sparse cell"
    metric (Fig. 12).  ``only_allocated`` in {None, 'conventional', 'sme'}
    restricts counting to cells inside allocated (non-dropped) crossbars."""
    planes = bit_planes(codes, n_bits)
    groups = _plane_groups(planes, cell_bits)
    if only_allocated is None:
        total = groups.size
        zero = int((groups == 0).sum())
        return zero, total
    zero = total = 0
    for g in groups:
        tiled = tile_codes(g, tile)                  # [nr, nc, tr, tc]
        occ = tiled.any(axis=(-1, -2))
        alive = tiled[occ]
        total += alive.size
        zero += int((alive == 0).sum())
    return zero, total
