"""Tiling of codeword matrices and per-(plane, tile) occupancy (paper
§III-B), numpy only.

A copy of the parts of ``repro/core/bitslice.py`` that ``sme_compress``,
the plane-CSC packer and the compiler need.  Tile ``(i, j)`` of bit-plane ``q`` is the
unit of storage and skipping: an all-zero (plane, tile) is neither stored
nor moved.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["bit_planes", "pad_to_tiles", "tile_codes", "untile_codes",
           "tiled_plane_occupancy", "nonempty_rows_per_tile"]


def bit_planes(codes: np.ndarray, n_bits: int) -> np.ndarray:
    """codes[...] -> planes[Nq, ...] 0/1 uint8; plane p (0-indexed) is
    weight bit p+1 (MSB first)."""
    shifts = np.arange(n_bits - 1, -1, -1, dtype=codes.dtype)
    shifts = shifts.reshape((n_bits,) + (1,) * codes.ndim)
    return ((codes[None, ...] >> shifts) & 1).astype(np.uint8)


def pad_to_tiles(m: np.ndarray, tile: Tuple[int, int]) -> np.ndarray:
    """Zero-pad the trailing 2 dims of ``m`` up to multiples of ``tile``."""
    tr, tc = tile
    k, n = m.shape[-2:]
    pk, pn = (-k) % tr, (-n) % tc
    if pk == 0 and pn == 0:
        return m
    return np.pad(m, [(0, 0)] * (m.ndim - 2) + [(0, pk), (0, pn)])


def tile_codes(codes: np.ndarray, tile: Tuple[int, int] = (128, 128)) -> np.ndarray:
    """codes[K, N] -> tiled[nr, nc, tr, tc] (zero-padded)."""
    tr, tc = tile
    p = pad_to_tiles(codes, tile)
    kk, nn = p.shape
    return p.reshape(kk // tr, tr, nn // tc, tc).transpose(0, 2, 1, 3)


def untile_codes(tiled: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Inverse of :func:`tile_codes` (crops padding back to ``shape``)."""
    nr, nc, tr, tc = tiled.shape
    full = tiled.transpose(0, 2, 1, 3).reshape(nr * tr, nc * tc)
    return full[: shape[0], : shape[1]]


def tiled_plane_occupancy(tiled_codes: np.ndarray, n_bits: int) -> np.ndarray:
    """bool [Nq, ..., nr, nc]: which (plane, tile) pairs hold a '1'.  Plane
    ``q`` (0-indexed, MSB first) is byte bit ``Nq - 1 - q``."""
    return np.stack([((tiled_codes >> (n_bits - 1 - q)) & 1).any(axis=(-1, -2))
                     for q in range(n_bits)])


def nonempty_rows_per_tile(codes: np.ndarray, n_bits: int, plane: int = 1,
                           tile=(128, 128)) -> np.ndarray:
    """Count of non-empty crossbar rows per tile of bit-plane ``plane``
    (1-indexed; plane=1 is paper Fig. 5's MSB crossbars): int [nr, nc]."""
    t = tile_codes(bit_planes(codes, n_bits)[plane - 1], tile)
    return t.any(axis=-1).sum(axis=-1)
