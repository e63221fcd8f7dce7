"""Minifloat-6 re-encoding of squeezed SME codes: the v2 kernel's format.

A copy of ``repro/core/minifloat.py`` (numpy only).  The S-window
property means a squeezed SME codeword has at most S significant bits
anchored at its leading one, i.e. it is a tiny float.  With Nq - x <= 7
live bits and S <= 3 the re-encoding

    code6 = sign(1b) | exponent(3b) | mantissa(2b)

is lossless: the leading-bit positions x+1..Nq fit 3 bits with 0 kept for
zero, and the window leaves at most 2 bits below the leading one.  Four
codes pack into 3 bytes, 6 bits per weight with the sign included.
"""
from __future__ import annotations

import numpy as np

from .bitslice import tile_codes
from .sme import SMEWeight

__all__ = ["encode6", "decode6_value", "pack6", "unpack6",
           "minifloat_from_sme", "minifloat_dequant", "bits_per_weight6"]


def encode6(codes: np.ndarray, signs_neg: np.ndarray, n_bits: int = 8,
            squeezed: int = 1) -> np.ndarray:
    """codes: uint8 shifted codewords (top ``squeezed`` bits zero);
    signs_neg: 0/1 (1 = negative).  Returns uint8 6-bit codes.  A zero code
    keeps its sign bit; its exponent 0 decodes it to 0."""
    c = codes.astype(np.int64)
    nz = c > 0
    lead_pow = np.zeros_like(c)
    lead_pow[nz] = np.floor(np.log2(c[nz])).astype(np.int64)
    # leading position p (1-indexed from the MSB): bit (n_bits - p)
    p = n_bits - lead_pow
    e = np.where(nz, p - squeezed, 0)          # 1..(n_bits - squeezed); 0 = zero
    # mantissa: the two bits below the leading one
    cshift = (c << (p - 1)) & ((1 << n_bits) - 1)
    m = (cshift >> (n_bits - 3)) & 3
    code6 = (signs_neg.astype(np.int64) << 5) | (e << 2) | np.where(nz, m, 0)
    return code6.astype(np.uint8)


def decode6_value(code6: np.ndarray, n_bits: int = 8,
                  squeezed: int = 1) -> np.ndarray:
    """Signed magnitude in the value domain (before row_exp and scale)."""
    c = code6.astype(np.int64)
    m = c & 3
    e = (c >> 2) & 7
    s = 1.0 - 2.0 * ((c >> 5) & 1)
    p = e + squeezed
    mag = (4.0 + m) * np.exp2(-(p + 2.0))
    return np.where(e > 0, s * mag, 0.0)


def pack6(code6: np.ndarray) -> np.ndarray:
    """[..., N] uint8 6-bit codes -> [..., 3N/4] bytes (N % 4 == 0), the
    first code in the low bits of the first byte."""
    if code6.shape[-1] % 4:
        raise ValueError(f"pack6 needs a multiple of 4 codes, got "
                         f"{code6.shape[-1]}")
    g = code6.reshape(code6.shape[:-1] + (-1, 4)).astype(np.uint16)
    b0 = (g[..., 0] | (g[..., 1] << 6)) & 0xFF
    b1 = ((g[..., 1] >> 2) | (g[..., 2] << 4)) & 0xFF
    b2 = ((g[..., 2] >> 4) | (g[..., 3] << 2)) & 0xFF
    return np.stack([b0, b1, b2], axis=-1).reshape(
        code6.shape[:-1] + (-1,)).astype(np.uint8)


def unpack6(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack6`."""
    if packed.shape[-1] % 3:
        raise ValueError(f"unpack6 needs a multiple of 3 bytes, got "
                         f"{packed.shape[-1]}")
    t = packed.reshape(packed.shape[:-1] + (-1, 3)).astype(np.uint16)
    b0, b1, b2 = t[..., 0], t[..., 1], t[..., 2]
    c0 = b0 & 63
    c1 = ((b0 >> 6) | (b1 << 2)) & 63
    c2 = ((b1 >> 4) | (b2 << 4)) & 63
    c3 = (b2 >> 2) & 63
    return np.stack([c0, c1, c2, c3], axis=-1).reshape(
        packed.shape[:-1] + (-1,)).astype(np.uint8)


def minifloat_from_sme(smew: SMEWeight) -> dict:
    """SMEWeight -> packed minifloat-6 arrays in the per-tile layout:
    {packed u8 [nr, nc, tr, 3*tc/4], rowscale f32 [nr, nc, tr], scale f32
    [1, N], and the meta}."""
    if smew.live_bits > 7:
        raise ValueError("minifloat-6 requires squeeze >= 1 (3-bit exponent)")
    if smew.window > 3:
        raise ValueError("minifloat-6 requires S <= 3 (2-bit mantissa)")
    nr, nc = smew.grid
    tr, tc = smew.tile
    k, n = smew.shape
    signs = np.unpackbits(smew.sign_packed, axis=1)[:, :n].astype(np.uint8)
    code6 = encode6(smew.tiled_codes, tile_codes(signs, smew.tile),
                    smew.n_bits, smew.squeezed)
    return {
        "packed": pack6(code6.reshape(nr, nc, tr, tc)),
        "rowscale": np.exp2(smew.row_exp.astype(np.float32)),
        "scale": np.broadcast_to(smew.scale, (1, n)).astype(np.float32),
        "n_bits": smew.n_bits, "squeezed": smew.squeezed,
        "shape": smew.shape, "tile": smew.tile,
    }


def minifloat_dequant(mf: dict) -> np.ndarray:
    """Packed minifloat-6 -> dense effective weights [K, N] (numpy oracle)."""
    code6 = unpack6(mf["packed"])                   # [nr, nc, tr, tc]
    val = decode6_value(code6, mf["n_bits"], mf["squeezed"])
    val = val * mf["rowscale"][..., None]
    nr, nc, tr, tc = code6.shape
    k, n = mf["shape"]
    dense = val.transpose(0, 2, 1, 3).reshape(nr * tr, nc * tc)[:k, :n]
    return dense * mf["scale"]


def bits_per_weight6(mf: dict) -> float:
    k, n = mf["shape"]
    payload = mf["packed"].size * 8 + mf["rowscale"].size * 32 \
        + mf["scale"].size * 32
    return payload / (k * n)
