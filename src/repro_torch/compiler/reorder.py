"""Tile-densifying row reordering (compiler stage 2, DESIGN.md §4).

A numpy copy of ``repro/compiler/reorder.py``; ``tests/test_torch_compiler.py``
holds its permutations and gains equal to that file's.

Bit-slice sparsity is only worth crossbars/DMA when it aligns into whole
empty 128x128 tiles — a matrix whose zeros are scattered across tiles
occupies every tile even at 90% weight sparsity.  Permuting the K rows of
``w`` so that rows with the same *column-block* sparsity pattern become
contiguous packs the zeros into full tiles, which the CSC-of-tiles format
(`core.sme.SMEWeight.pack_csc`) and the CUDA kernels then skip outright.
The same idea drives crossbar-side row clustering in the reordering
literature (Yang et al., arXiv:2511.14202; Zhang et al., arXiv:1909.08496
for the per-layer bit-slice variance it exploits).

Correctness: for a permutation ``p``, ``x[..., p] @ w[p, :] == x @ w``
exactly, so the compiled param carries ``sme_perm = p`` and
``core.backend.sme_apply`` gathers the input once before dispatch — model
outputs are unchanged to the last bit (per-tensor quantization scales are
permutation-invariant, so even the quantized codes commute with ``p``).

The heuristic is occupancy clustering: per row, the boolean signature of
which column tiles it touches; rows sort lexicographically by signature
(identical patterns become contiguous, near-identical adjacent).  It never
helps less than the identity ordering by more than tie-breaking noise, and
``permutation_gain`` reports the occupied-tile delta so the planner only
keeps permutations that actually free tiles.

Two signature levels share the machinery (``level=``):

  * ``"tile"``  — per (row, column-block): any non-zero *codeword* — the
    unit the tile-CSC (v1/v2) formats skip;
  * ``"plane"`` — per (row, column-block, bit-plane): any set *bit* — the
    unit the plane-CSC (v3) format skips.  Bit-level clustering densifies
    individual planes far beyond codeword clustering (arXiv:2511.14202):
    rows whose magnitudes live in the same band share plane support, so
    sorting by plane signature empties whole (plane, tile) pairs that
    codeword-level sorting leaves half-full.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.quant import quantize

__all__ = [
    "row_block_signature", "row_plane_signature", "permutation_from_codes",
    "plan_row_permutation", "occupied_tile_count",
    "occupied_plane_tile_count", "permutation_gain",
    "plane_permutation_gain",
]


def row_block_signature(codes: np.ndarray,
                        tile: Tuple[int, int] = (128, 128)) -> np.ndarray:
    """bool [K, nc]: does row k have any non-zero code in column block j?"""
    k, n = codes.shape
    tc = tile[1]
    nc = -(-n // tc)
    padded = np.zeros((k, nc * tc), dtype=bool)
    padded[:, :n] = codes != 0
    return padded.reshape(k, nc, tc).any(axis=-1)


def row_plane_signature(codes: np.ndarray, n_bits: int = 8,
                        tile: Tuple[int, int] = (128, 128)) -> np.ndarray:
    """bool [K, nc * Nq]: per row and column block, which bit-planes the
    row touches (MSB plane first within each block) — the plane-CSC
    occupancy signature.  Refines :func:`row_block_signature`: a block's
    plane bits are all-false exactly when its codeword bit is false."""
    from ..core.bitslice import bit_planes
    k, n = codes.shape
    tc = tile[1]
    nc = -(-n // tc)
    planes = bit_planes(codes, n_bits)               # [Nq, K, N] 0/1
    padded = np.zeros((n_bits, k, nc * tc), dtype=bool)
    padded[..., :n] = planes != 0
    blocks = padded.reshape(n_bits, k, nc, tc).any(axis=-1)   # [Nq, K, nc]
    return blocks.transpose(1, 2, 0).reshape(k, nc * n_bits)


def permutation_from_codes(codes: np.ndarray,
                           tile: Tuple[int, int] = (128, 128),
                           level: str = "tile",
                           n_bits: int = 8) -> np.ndarray:
    """Row permutation that clusters rows by column-block sparsity pattern.

    Lexicographic sort over the per-row signature (primary key = leftmost
    block, final tiebreak = occupied-block count) — rows sharing a pattern
    land contiguously, so blocks none of them touch become whole empty
    units.  ``level="tile"`` keys on codeword-block occupancy (frees
    whole tiles for the tile-CSC formats); ``level="plane"`` keys on
    per-plane block occupancy (frees (plane, tile) pairs for plane-CSC).
    Deterministic; stable within equal signatures.
    """
    if level == "plane":
        sig = row_plane_signature(codes, n_bits, tile)
    elif level == "tile":
        sig = row_block_signature(codes, tile)
    else:
        raise ValueError(f"level must be 'tile'|'plane', got {level!r}")
    # np.lexsort sorts by the LAST key first: put block 0 last (primary),
    # and the popcount first (least-significant tiebreak).
    keys = (sig.sum(axis=1),) + tuple(sig[:, j] for j in range(sig.shape[1] - 1, -1, -1))
    return np.lexsort(keys).astype(np.int32)


def plan_row_permutation(w: np.ndarray, n_bits: int = 8, window: int = 3,
                         tile: Tuple[int, int] = (128, 128),
                         method: str = "sme",
                         level: str = "tile") -> np.ndarray:
    """Permutation for a *real* weight matrix: quantize, then cluster codes.

    Quantization happens before signature extraction because the squeeze /
    tile-skip machinery sees codes, not floats — a float zero and a
    below-threshold float are the same empty cell.
    """
    q = quantize(np.asarray(w, np.float64), method=method, n_bits=n_bits,
                 window=window)
    return permutation_from_codes(q.codes, tile, level=level, n_bits=n_bits)


def occupied_tile_count(codes: np.ndarray,
                        tile: Tuple[int, int] = (128, 128)) -> int:
    """Number of non-empty (tile_row, tile_col) tiles = CSC entries."""
    from ..core.bitslice import tile_codes
    return int(tile_codes(codes, tile).any(axis=(-1, -2)).sum())


def permutation_gain(codes: np.ndarray, perm: Optional[np.ndarray] = None,
                     tile: Tuple[int, int] = (128, 128)) -> Tuple[int, int]:
    """(occupied tiles before, after) applying ``perm`` (computed if None)."""
    if perm is None:
        perm = permutation_from_codes(codes, tile)
    return (occupied_tile_count(codes, tile),
            occupied_tile_count(codes[perm], tile))


def occupied_plane_tile_count(codes: np.ndarray, n_bits: int = 8,
                              tile: Tuple[int, int] = (128, 128)) -> int:
    """Occupied (plane, tile) pairs = plane-CSC entries (v3 DMA units)."""
    from ..core.bitslice import tile_codes, tiled_plane_occupancy
    return int(tiled_plane_occupancy(tile_codes(codes, tile), n_bits).sum())


def plane_permutation_gain(codes: np.ndarray,
                           perm: Optional[np.ndarray] = None,
                           n_bits: int = 8,
                           tile: Tuple[int, int] = (128, 128)
                           ) -> Tuple[int, int]:
    """(occupied plane-tiles before, after) applying ``perm`` (a
    plane-level clustering is computed when None)."""
    if perm is None:
        perm = permutation_from_codes(codes, tile, level="plane",
                                      n_bits=n_bits)
    return (occupied_plane_tile_count(codes, n_bits, tile),
            occupied_plane_tile_count(codes[perm], n_bits, tile))
