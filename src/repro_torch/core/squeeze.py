"""Bit-wise squeeze-out (paper §III-C), numpy only.

A copy of ``squeeze_out`` and ``squeeze_error_bound`` from
``repro/core/squeeze.py``.  Per 128x128
tile, rows whose current MSB plane is non-empty shift right by one bit and
double their input instead (``I * W == (I * 2) * (W / 2)``); after ``x``
rounds the first ``x`` planes of every tile are empty.  ``x_max > x``
keeps squeezing each tile while the round drops no set LSB (exact), giving
per-tile depths ``tile_sq``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .bitslice import tile_codes

__all__ = ["SqueezeResult", "squeeze_out", "squeeze_error_bound"]


@dataclasses.dataclass
class SqueezeResult:
    """Post-squeeze weights of one matrix, in the tiled view."""

    tiled_codes: np.ndarray    # [nr, nc, tr, tc] shifted codewords
    row_exp: np.ndarray        # uint8 [nr, nc, tr] per-tile-row input exponent
    n_bits: int
    squeezed: int              # mandatory depth x
    shape: Tuple[int, int]
    tile: Tuple[int, int]
    tile_sq: Optional[np.ndarray] = None   # uint8 [nr, nc] (None = uniform x)


def squeeze_out(codes: np.ndarray, n_bits: int, x: int,
                tile: Tuple[int, int] = (128, 128),
                x_max: Optional[int] = None) -> SqueezeResult:
    """Apply ``x`` rounds of squeeze-out to ``codes[K, N]`` (per tile), then
    free-deepen each tile up to ``x_max``."""
    if not 0 <= x < n_bits:
        raise ValueError(f"squeeze depth x={x} must be in [0, Nq)")
    if x_max is None:
        x_max = x
    if not x <= x_max < n_bits:
        raise ValueError(f"x_max={x_max} must be in [x={x}, Nq)")
    tiled = tile_codes(codes, tile).astype(codes.dtype)
    nr, nc, tr, tc = tiled.shape
    row_exp = np.zeros((nr, nc, tr), dtype=np.uint8)
    alive = np.ones((nr, nc), dtype=bool)
    tile_sq = np.zeros((nr, nc), dtype=np.uint8)
    for t in range(x_max):
        msb = (tiled >> (n_bits - (t + 1))) & 1
        hit = msb.any(axis=-1)                             # [nr, nc, tr]
        if t >= x:
            # an optional round is free iff no shifting row drops a set LSB
            lossy = (hit & ((tiled & 1) != 0).any(axis=-1)).any(axis=-1)
            alive &= ~lossy
        shift = hit & alive[..., None]
        tiled = np.where(shift[..., None], tiled >> 1, tiled)
        row_exp += shift.astype(np.uint8)
        tile_sq += alive.astype(np.uint8)
    return SqueezeResult(tiled_codes=tiled, row_exp=row_exp, n_bits=n_bits,
                         squeezed=x, shape=codes.shape, tile=tile,
                         tile_sq=tile_sq if x_max > x else None)


def squeeze_error_bound(n_bits: int, x: int) -> float:
    """Worst-case per-weight magnitude error of x-bit squeeze (value
    domain): the dropped LSBs, ``(2^x - 1) * 2^-Nq``."""
    return (2.0 ** x - 1.0) * 2.0 ** -n_bits
