"""Bit-level sparsity statistics (paper Figs. 2, 4, 5), numpy only.

A copy of ``repro/core/sparsity.py``.

Besides the per-*bit* densities of the paper figures, this module exposes
per-plane *tile occupancy* — occupied (plane, tile) pairs, the storage/DMA
unit of the plane-CSC (v3) format — which the compiler's planner prices
candidates with.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from .bitslice import bit_planes, nonempty_rows_per_tile, tile_codes, \
    tiled_plane_occupancy
from .quant import QuantizedTensor

__all__ = [
    "per_plane_sparsity",
    "overall_bit_sparsity",
    "nonempty_row_histogram",
    "weight_sparsity",
    "plane_tile_counts",
    "plane_occupancy_stats",
]


def per_plane_sparsity(q: QuantizedTensor) -> np.ndarray:
    """Fraction of 0-bits per bit plane, MSB first (paper Fig. 2 bars)."""
    planes = bit_planes(q.codes, q.n_bits).reshape(q.n_bits, -1)
    return 1.0 - planes.mean(axis=1)


def overall_bit_sparsity(q: QuantizedTensor) -> float:
    """Fraction of 0-bits over all planes (paper Fig. 9 sparsity metric)."""
    return float(per_plane_sparsity(q).mean())


def weight_sparsity(w: np.ndarray, tol: float = 0.0) -> float:
    w = np.asarray(w)
    return float((np.abs(w) <= tol).mean())


def plane_tile_counts(codes: np.ndarray, n_bits: int,
                      tile: Tuple[int, int] = (128, 128)) -> np.ndarray:
    """int [Nq]: occupied tiles per bit plane (MSB first) of a codeword
    matrix — the per-plane count of plane-CSC storage units.  Accepts raw
    ``[K, N]`` codes (tiled internally) or already-tiled
    ``[nr, nc, tr, tc]`` codes."""
    tiled = codes if codes.ndim == 4 else tile_codes(codes, tile)
    return tiled_plane_occupancy(tiled, n_bits).sum(axis=(-1, -2))


def plane_occupancy_stats(smew) -> Dict[str, object]:
    """Per-plane occupancy summary of an :class:`~repro_torch.core.sme.SMEWeight`
    — what the planner prices v3 candidates with.

    Returns total/occupied counts at both skip granularities, the
    per-plane occupied-tile vector, per-plane bit density, and the exact
    bytes/weight of every packed format.
    """
    occp = smew.plane_occupancy()                       # [Nq, nr, nc]
    nr, nc = smew.grid
    per_plane = occp.sum(axis=(-1, -2)).astype(int)
    planes = bit_planes(smew.tiled_codes, smew.n_bits)  # [Nq, nr, nc, tr, tc]
    density = planes.reshape(smew.n_bits, -1).mean(axis=1)
    # NaN when minifloat-6 cannot hold this setting (squeeze=0 / window>3
    # / live_bits>7); all three formats price through the one accounting
    # in SMEWeight.storage_bits_per_weight, like the planner
    try:
        v2 = smew.storage_bits_per_weight("minifloat6") / 8
    except ValueError:
        v2 = float("nan")
    return {
        "tiles": nr * nc,
        "occupied_tiles": int(smew.occupancy.sum()),
        "plane_tiles": smew.n_bits * nr * nc,
        "occupied_plane_tiles": int(occp.sum()),
        "per_plane_tiles": per_plane,
        "per_plane_density": density,
        "tile_squeeze_min": int(smew.tile_squeeze().min()),
        "tile_squeeze_max": int(smew.tile_squeeze().max()),
        "bytes_per_weight": {
            "v1": smew.storage_bits_per_weight("bytecode") / 8,
            "v2": v2,
            "v3": smew.storage_bits_per_weight("plane_csc") / 8,
        },
    }


def nonempty_row_histogram(
    q: QuantizedTensor, plane: int = 1, tile=(128, 128),
    bins: Sequence[float] = (0, 1, 4, 8, 16, 32, 64, 128),
) -> Dict[str, np.ndarray]:
    """Distribution of non-empty rows per MSB crossbar (paper Fig. 5)."""
    counts = nonempty_rows_per_tile(q.codes, q.n_bits, plane, tile).ravel()
    hist, edges = np.histogram(counts, bins=list(bins) + [tile[0] + 1])
    return {
        "counts": counts,
        "hist": hist,
        "edges": edges,
        "mean_fraction": counts.mean() / tile[0] if counts.size else 0.0,
    }
