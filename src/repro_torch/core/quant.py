"""Quantizers used by the SME pipeline (paper §III-A), numpy only.

A copy of the SME method of ``repro/core/quant.py`` with its per-tensor
scale (the int / po2 / apt baselines of the paper's tables and per-channel
scales are not ported); ``tests/test_torch_format.py`` holds it byte-equal
to that file's output.  The codeword convention is the reference's:

  * a weight magnitude is an ``Nq``-bit integer codeword ``c``; bit ``i``
    (1-indexed, MSB first, worth ``2^-i``) lives at byte bit ``Nq - i``;
  * the encoded magnitude is ``c * 2^-Nq`` in [0, 1);
  * the sign is kept separately and the dequantized weight is
    ``sign * value(c) * scale``.

The SME quantizer constrains each codeword's '1' bits to a window of
``S`` consecutive bits starting at its leading one (paper Eq. 2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["QuantizedTensor", "quantize", "sme_quantize_mag"]


@dataclasses.dataclass
class QuantizedTensor:
    """A quantized weight tensor in the shared codeword format."""

    codes: np.ndarray          # uint8 (Nq <= 8) or uint16 codewords
    signs: np.ndarray          # int8 in {-1, +1}
    scale: np.ndarray          # broadcastable float scale
    n_bits: int
    method: str
    window: Optional[int] = None


def _code_dtype(n_bits: int):
    return np.uint8 if n_bits <= 8 else np.uint16


def sme_quantize_mag(v: np.ndarray, n_bits: int = 8, window: int = 3) -> np.ndarray:
    """Round ``v`` in [0, 1) to ``S`` significant binary digits anchored at
    the leading one, truncated at bit ``Nq`` (paper Eq. 2)."""
    v = np.asarray(v, dtype=np.float64)
    if np.any(v < 0) or np.any(v >= 1.0):
        raise ValueError("sme_quantize_mag expects magnitudes in [0, 1)")
    _, exp = np.frexp(v)
    k = np.clip(1 - exp, 1, n_bits)              # leading-one index
    w_end = np.minimum(n_bits, k + window - 1)
    m_int = np.round(np.ldexp(v, w_end))
    # a round-up can carry into bit k-1 (0.249.. -> 0.25): re-anchor once
    over = m_int >= (1 << 1) ** (w_end - k + 1).astype(np.int64)
    k = np.where(over, np.maximum(k - 1, 1), k)
    w_end = np.minimum(n_bits, k + window - 1)
    m_int = np.round(np.ldexp(v, w_end)).astype(np.int64)
    return (m_int << (n_bits - w_end)).astype(_code_dtype(n_bits))


def quantize(w: np.ndarray, n_bits: int = 8, window: int = 3
             ) -> QuantizedTensor:
    """SME-quantize a real weight tensor into the shared codeword format
    with one per-tensor scale; magnitudes are scaled into [0, 1 - 2^-S]
    (paper §III-A)."""
    w = np.asarray(w, dtype=np.float64)
    signs = np.where(w < 0, -1, 1).astype(np.int8)
    peak = np.max(np.abs(w))
    raw_scale = np.asarray(peak if peak > 0 else 1.0,
                           dtype=np.float64).reshape((1,) * w.ndim)
    code_max = 1.0 - 2.0 ** (-window)
    v = np.clip(np.abs(w) / raw_scale * code_max, 0.0, np.nextafter(1.0, 0.0))
    return QuantizedTensor(codes=sme_quantize_mag(v, n_bits, window),
                           signs=signs, scale=raw_scale / code_max,
                           n_bits=n_bits, method="sme", window=window)
