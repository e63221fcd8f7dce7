"""Numpy oracles of the v1 kernel.

Checked against ``repro/kernels/sme_spmm/ref.py`` (numpy in place of jnp):
the f64 product with the dequantized weight, and a second oracle rebuilt
from the packed tile-CSC arrays themselves.
"""
from __future__ import annotations

import numpy as np

from ...core.sme import SMEWeight

__all__ = ["dequant_ref", "sme_spmm_ref", "dequant_csc", "sme_spmm_csc_ref"]


def dequant_ref(smew: SMEWeight) -> np.ndarray:
    """Effective dense weight (float64, sign, scale and row_exp included)."""
    return smew.dequant()


def sme_spmm_ref(x: np.ndarray, smew: SMEWeight) -> np.ndarray:
    """Unscaled oracle of the kernel output (``scale`` left to the
    caller, as ``ops.sme_linear`` applies it)."""
    return np.asarray(x, np.float64) @ (smew.dequant() / smew.scale)


def dequant_csc(csc: dict, n_bits: int, k_pad: int) -> np.ndarray:
    """Dense unscaled effective weight [k_pad, Nt*bn] (float64) rebuilt
    from the ``pack_csc`` arrays: an oracle of the packed layout."""
    codes = np.asarray(csc["codes"])        # [Nt, L, bk, bn]
    sign = np.asarray(csc["sign"])          # [Nt, L, bk//8, bn]
    rowscale = np.asarray(csc["rowscale"])  # [Nt, L, bk]
    rowid = np.asarray(csc["rowid"])
    nnz = np.asarray(csc["nnz"])
    nt, L, bk, bn = codes.shape
    w = np.zeros((k_pad, nt * bn), dtype=np.float64)
    for j in range(nt):
        for l in range(int(nnz[j])):
            mag = codes[j, l].astype(np.float64) * 2.0 ** -n_bits
            bits = np.unpackbits(sign[j, l], axis=0, count=bk)
            tilew = mag * (1.0 - 2.0 * bits) * rowscale[j, l][:, None]
            i = int(rowid[j, l])
            w[i * bk:(i + 1) * bk, j * bn:(j + 1) * bn] = tilew
    return w


def sme_spmm_csc_ref(x, csc: dict, n_bits: int) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return x @ dequant_csc(csc, n_bits, x.shape[-1])
