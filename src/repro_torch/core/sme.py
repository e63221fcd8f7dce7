"""End-to-end SME weight pipeline and the plane-CSC (v3) packer, numpy only.

A copy of the parts of ``repro/core/sme.py`` the serving path needs:
``sme_compress`` (quantize -> bit-slice -> squeeze-out), the
:class:`SMEWeight` numerics (``dequant``, ``dequant_topk_planes``), the
resource counts and the one byte accounting every format is priced by
(``storage_bits_per_weight``), and the two CSC packers: ``pack_csc``
(tile-CSC, the v1 operands) and ``pack_plane_csc`` (plane-CSC, v3).  The
tests hold their operands byte-identical to the reference's, so the two
packages read each other's packed weights unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .bitslice import tile_codes, tiled_plane_occupancy, untile_codes
from .quant import quantize
from .squeeze import squeeze_out

#: (plane, tile) entries whose bitmaps :meth:`SMEWeight.pack_plane_csc`
#: builds at once (its temporaries: 8 bytes per weight of each entry)
PLANE_BLOCK = 2048

__all__ = ["SMEWeight", "sme_compress", "sme_matmul_ref_np", "csc_tile_order",
           "plane_csc_order"]


@dataclasses.dataclass
class SMEWeight:
    """A weight matrix compressed with the full SME pipeline."""

    shape: Tuple[int, int]          # (K, N) = (in_features, out_features)
    n_bits: int
    window: int
    squeezed: int
    tile: Tuple[int, int]
    method: str
    tiled_codes: np.ndarray         # uint8 [nr, nc, tr, tc] shifted codewords
    row_exp: np.ndarray             # uint8 [nr, nc, tr]
    sign_packed: np.ndarray         # uint8 [K, ceil(N/8)] (1 = negative)
    scale: np.ndarray               # float64, broadcastable to [K, N]
    occupancy: np.ndarray           # bool [nr, nc]
    tile_sq: Optional[np.ndarray] = None   # uint8 [nr, nc] per-tile depth

    @property
    def grid(self) -> Tuple[int, int]:
        return self.tiled_codes.shape[0], self.tiled_codes.shape[1]

    @property
    def live_bits(self) -> int:
        return self.n_bits - self.squeezed

    @property
    def n_weights(self) -> int:
        return int(np.prod(self.shape))

    def dequant(self) -> np.ndarray:
        """Effective real weight matrix [K, N] (float64)."""
        val = self.tiled_codes.astype(np.float64) * 2.0 ** -self.n_bits
        val = val * (2.0 ** self.row_exp.astype(np.float64))[..., None]
        return untile_codes(val, self.shape) * self.sign_dense() * self.scale

    def dequant_topk_planes(self, k: int) -> np.ndarray:
        """Effective weight [K, N] (float64) with every tile truncated to its
        ``k`` most significant occupied planes: the oracle of the decode
        kernel's ``plane_depth``.  Non-positive ``k`` clamps to 1, as the
        kernel does."""
        occp = self.plane_occupancy()
        rank = np.cumsum(occp, axis=0) - occp       # occupied planes before q
        keep = occp & (rank < max(int(k), 1))
        val = np.zeros(self.tiled_codes.shape, dtype=np.float64)
        for q in range(self.n_bits):
            bit = (self.tiled_codes >> (self.n_bits - 1 - q)) & 1
            val += bit * np.where(keep[q], 2.0 ** (self.n_bits - 1 - q),
                                  0.0)[..., None, None]
        val *= 2.0 ** -self.n_bits
        val = val * (2.0 ** self.row_exp.astype(np.float64))[..., None]
        return untile_codes(val, self.shape) * self.sign_dense() * self.scale

    def sign_dense(self) -> np.ndarray:
        """+-1 sign matrix [K, N] from the packed bits."""
        bits = np.unpackbits(self.sign_packed, axis=1)[:, :self.shape[1]]
        return (1.0 - 2.0 * bits).astype(np.float64)

    def tile_squeeze(self) -> np.ndarray:
        """uint8 [nr, nc] per-tile squeeze depth."""
        if self.tile_sq is not None:
            return self.tile_sq
        return np.full(self.grid, self.squeezed, dtype=np.uint8)

    def plane_occupancy(self) -> np.ndarray:
        """bool [Nq, nr, nc] over absolute planes of the shifted codes,
        memoized (``tiled_codes`` is frozen after construction)."""
        cached = self.__dict__.get("_plane_occ")
        if cached is None:
            cached = tiled_plane_occupancy(self.tiled_codes, self.n_bits)
            self.__dict__["_plane_occ"] = cached
        return cached

    def live_plane_occupancy(self) -> np.ndarray:
        """bool [live_bits, nr, nc]."""
        occ = []
        for p in range(self.squeezed + 1, self.n_bits + 1):
            bit = (self.tiled_codes >> (self.n_bits - p)) & 1
            occ.append(bit.any(axis=(-1, -2)))
        return np.stack(occ) if occ else np.zeros((0,) + self.grid, bool)

    def plane_tiles_used(self) -> int:
        """Occupied (plane, tile) pairs: the plane-CSC storage units."""
        return int(self.plane_occupancy().sum())

    def crossbars_used(self) -> int:
        return int(self.live_plane_occupancy().sum())

    def storage_bits_per_weight(self, fmt: str = "planes") -> float:
        """Weight-storage bits per weight under a packed format.

        * ``bytecode``   -- occupied tiles as whole uint8 codewords (v1);
        * ``planes``     -- non-empty live (tile, plane) bitmaps, coupled
          per tile;
        * ``minifloat6`` -- 6 bits per code on occupied tiles, sign inside
          the code (v2; raises where the format cannot hold the setting);
        * ``plane_csc``  -- the v3 format exactly: one bitmap per occupied
          (plane, tile), dense ``2^row_exp`` f32, and the per-entry index.

        ``bytecode``/``planes``/``plane_csc`` add one sign bit per weight;
        the tile-CSC formats add ``tr`` bytes of row exponent and 4 bytes
        of index per occupied tile."""
        tr, tc = self.tile
        nr, nc = self.grid
        occ_tiles = int(self.occupancy.sum())
        sign_bits = self.n_weights
        if fmt == "bytecode":
            payload = occ_tiles * tr * tc * 8
            meta_bits = occ_tiles * (tr * 8 + 32)
        elif fmt == "planes":
            payload = int(self.live_plane_occupancy().sum()) * tr * tc
            meta_bits = occ_tiles * (tr * 8 + 32)
        elif fmt == "minifloat6":
            if not (self.squeezed >= 1 and self.window <= 3
                    and self.live_bits <= 7):
                raise ValueError(
                    "minifloat-6 needs squeeze >= 1, window <= 3, "
                    "live_bits <= 7")
            payload = occ_tiles * tr * tc * 6
            meta_bits = occ_tiles * (tr * 8 + 32)
            sign_bits = 0
        elif fmt == "plane_csc":
            ents = self.plane_tiles_used()
            payload = ents * tr * tc
            meta_bits = ents * 96 + nc * 32 + nr * nc * tr * 32
        else:
            raise ValueError(f"unknown fmt {fmt!r}")
        return (payload + meta_bits + sign_bits) / self.n_weights

    def pack_csc(self, pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Tile-CSC operands of the v1 kernel.

        Per output-column tile ``j`` the occupied row tiles are listed in
        row order, padded to ``L = max_j nnz(j)`` (or ``pad_to``); padding
        slots hold zero codes, rowscale 1 and rowid 0, guarded by ``nnz``.

        Returns:
          codes    u8  [Nt, L, tr, tc]    shifted codewords
          sign     u8  [Nt, L, tr//8, tc] per-slot signs, rows packed MSB
                                          first (1 = negative)
          rowscale f32 [Nt, L, tr]        ``2^row_exp``
          rowid    i32 [Nt, L]            source row tile
          nnz      i32 [Nt]               occupied tiles per column
        """
        nr, nc = self.grid
        tr, tc = self.tile
        occ = self.occupancy
        nnz = occ.sum(axis=0).astype(np.int32)
        L = int(pad_to if pad_to is not None else max(int(nnz.max()), 1))
        if int(nnz.max()) > L:
            raise ValueError(f"pad_to={L} < max nnz per column {int(nnz.max())}")
        codes = np.zeros((nc, L, tr, tc), dtype=self.tiled_codes.dtype)
        sign = np.zeros((nc, L, tr // 8, tc), dtype=np.uint8)
        rowscale = np.ones((nc, L, tr), dtype=np.float32)
        rowid = np.zeros((nc, L), dtype=np.int32)
        col, row, slot = csc_tile_order(occ)
        if col.size:
            codes[col, slot] = self.tiled_codes[row, col]
            sign[col, slot] = np.packbits(
                self.sign_tiled()[row, col].astype(np.uint8), axis=1)
            rowscale[col, slot] = (2.0 ** self.row_exp[row, col]
                                   ).astype(np.float32)
            rowid[col, slot] = row
        return {"codes": codes, "sign": sign, "rowscale": rowscale,
                "rowid": rowid, "nnz": nnz}

    def sign_tiled(self) -> np.ndarray:
        """Dense 0/1 sign bits in the tiled view: uint8 [nr, nc, tr, tc]."""
        bits = np.unpackbits(self.sign_packed, axis=1)[:, :self.shape[1]]
        return tile_codes(bits, self.tile)

    def pack_plane_csc(self, pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Plane-CSC operands of the v3 kernels.

        Per output-column tile ``j`` the occupied (plane, tile) pairs are
        listed sorted by ``(row_tile, plane)``, so the planes of one (row,
        col) tile (a *group*) are adjacent and most significant first.
        Lists are padded to ``L = max_j nnz(j)`` (or ``pad_to``); padding
        slots are zero and guarded by ``nnz``.

        Returns:
          planes   u8  [Nt, L, tr//8, tc]  plane bitmaps, rows packed MSB first
          shift    i32 [Nt, L]             bit value exponent ``Nq-1-q``
          last     i32 [Nt, L]             1 on the final plane of a group
          rowid    i32 [Nt, L]             source row tile
          nnz      i32 [Nt]                occupied plane-tiles per column
          sign     u8  [nr, nc, tr//8, tc] dense packed signs (1 = negative)
          rowscale f32 [nr, nc, tr]        dense ``2^row_exp``
        """
        nr, nc = self.grid
        tr, tc = self.tile
        occp = self.plane_occupancy()
        nnz = occp.transpose(2, 1, 0).reshape(nc, -1).sum(axis=1).astype(np.int32)
        L = int(pad_to if pad_to is not None else max(int(nnz.max()), 1))
        if int(nnz.max()) > L:
            raise ValueError(f"pad_to={L} < max plane-nnz per column "
                             f"{int(nnz.max())}")
        planes = np.zeros((nc, L, tr // 8, tc), dtype=np.uint8)
        shift = np.zeros((nc, L), dtype=np.int32)
        last = np.zeros((nc, L), dtype=np.int32)
        rowid = np.zeros((nc, L), dtype=np.int32)
        col, row, q, slot = plane_csc_order(occp)
        if col.size:
            sh = (self.n_bits - 1 - q).astype(np.int64)
            # the bitmaps of PLANE_BLOCK entries at a time: the int64 shift
            # of all E tiles at once would hold 8 bytes per weight and plane
            # (gigabytes for a head slab)
            for e0 in range(0, col.size, PLANE_BLOCK):
                e = slice(e0, e0 + PLANE_BLOCK)
                bits = ((self.tiled_codes[row[e], col[e]]
                         >> sh[e, None, None]) & 1).astype(np.uint8)
                planes[col[e], slot[e]] = np.packbits(bits, axis=1)
            shift[col, slot] = sh.astype(np.int32)
            rowid[col, slot] = row
            grp_end = np.ones(col.size, dtype=bool)
            grp_end[:-1] = (col[1:] != col[:-1]) | (row[1:] != row[:-1])
            last[col, slot] = grp_end.astype(np.int32)
        return {
            "planes": planes, "shift": shift, "last": last,
            "rowid": rowid, "nnz": nnz,
            "sign": np.packbits(self.sign_tiled(), axis=-2),
            "rowscale": np.exp2(self.row_exp.astype(np.float32)),
        }


def csc_tile_order(occ: np.ndarray):
    """Occupied tiles of a [nr, nc] occupancy map in CSC order: (col, row,
    slot) vectors sorted by ``(col, row)``; tile ``(row[t], col[t])`` lands
    in list slot ``slot[t]`` of its column."""
    col, row = np.nonzero(occ.T)
    nnz = occ.sum(axis=0).astype(np.int64)
    offsets = np.cumsum(nnz) - nnz
    slot = np.arange(col.size) - np.repeat(offsets, nnz)
    return col, row, slot


def plane_csc_order(occp: np.ndarray):
    """Occupied (plane, tile) pairs of a [Nq, nr, nc] occupancy map in
    plane-CSC order: (col, row, plane, slot) vectors sorted by
    ``(col, row, plane)``; pair ``t`` lands in list slot ``slot[t]`` of its
    column."""
    co = occp.transpose(2, 1, 0)                  # [nc, nr, Nq]
    col, row, plane = np.nonzero(co)
    nnz = co.reshape(co.shape[0], -1).sum(axis=1).astype(np.int64)
    offsets = np.cumsum(nnz) - nnz
    slot = np.arange(col.size) - np.repeat(offsets, nnz)
    return col, row, plane, slot


def sme_compress(w: np.ndarray, n_bits: int = 8, window: int = 3,
                 squeeze: int = 1, tile: Tuple[int, int] = (128, 128),
                 row_perm: Optional[np.ndarray] = None,
                 squeeze_max: Optional[int] = None) -> SMEWeight:
    """Run the SME pipeline on a real weight matrix ``w[K, N]``.

    ``row_perm`` compresses ``w[row_perm, :]`` (the caller then gathers the
    input with the same permutation); ``squeeze_max`` enables exact
    per-tile squeeze depth."""
    if w.ndim != 2:
        raise ValueError("sme_compress expects a 2-D weight matrix")
    if row_perm is not None:
        w = np.asarray(w)[np.asarray(row_perm)]
    q = quantize(w, n_bits=n_bits, window=window)
    sq = squeeze_out(q.codes, n_bits, squeeze, tile, x_max=squeeze_max)
    return SMEWeight(
        shape=tuple(w.shape), n_bits=n_bits, window=window, squeezed=squeeze,
        tile=tile, method=q.method,
        tiled_codes=sq.tiled_codes, row_exp=sq.row_exp,
        sign_packed=np.packbits((q.signs < 0).astype(np.uint8), axis=1),
        scale=np.asarray(q.scale, dtype=np.float64),
        occupancy=(sq.tiled_codes != 0).any(axis=(-1, -2)),
        tile_sq=sq.tile_sq,
    )


def sme_matmul_ref_np(x: np.ndarray, smew: SMEWeight) -> np.ndarray:
    """Oracle: x[B, K] @ dequant(W)[K, N] in float64."""
    return np.asarray(x, np.float64) @ smew.dequant()
