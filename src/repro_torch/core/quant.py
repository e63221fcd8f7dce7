"""Quantizers used by the SME pipeline (paper §III-A, Fig. 2/4/9), numpy only.

A copy of ``repro/core/quant.py``: the SME quantizer (modified APT, paper
Eq. 2) the serving path packs with, and the int / po2 / apt baselines and
per-channel scales the compiler's planner and the paper's tables use.
``tests/test_torch_compiler.py`` holds every method byte-equal to that
file's output.  All quantizers share one codeword convention:

  * a weight magnitude is encoded as an ``Nq``-bit integer codeword ``c``;
  * bit ``i`` (1-indexed, i=1 is the MSB, worth ``2^-i``) of the weight lives
    at *byte* bit ``Nq - i`` of ``c``, i.e. ``b_i = (c >> (Nq - i)) & 1``;
  * the encoded magnitude is ``value(c) = c * 2^-Nq`` in [0, 1);
  * the sign is kept separately;
  * the dequantized weight is ``sign * value(c) * scale``.

The SME quantizer constrains the '1' bits of each codeword to a window of
``S`` consecutive bits starting at the leading one: a binary floating-point
format with an ``S``-bit mantissa, exponents limited to ``1..Nq`` and
subnormal truncation at ``2^-Nq``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "QuantizedTensor",
    "sme_quantize_mag",
    "int_quantize_mag",
    "po2_quantize_mag",
    "apt_quantize_mag",
    "quantize",
    "dequantize",
    "code_value",
    "quant_mse",
    "SUPPORTED_METHODS",
]

SUPPORTED_METHODS = ("sme", "int", "po2", "apt")


@dataclasses.dataclass
class QuantizedTensor:
    """A quantized weight tensor in the shared codeword convention."""

    codes: np.ndarray          # uint16 (uint8 when Nq <= 8) codewords, same shape as w
    signs: np.ndarray          # int8 in {-1, +1}
    scale: np.ndarray          # broadcastable float scale (codeword value -> weight)
    n_bits: int                # Nq
    method: str                # one of SUPPORTED_METHODS
    window: Optional[int] = None   # S for method == "sme"

    @property
    def shape(self):
        return self.codes.shape

    def dequantize(self) -> np.ndarray:
        return dequantize(self)

    def bit(self, i: int) -> np.ndarray:
        """Bit-plane ``i`` (1-indexed, MSB=1) as a 0/1 uint8 array."""
        if not 1 <= i <= self.n_bits:
            raise ValueError(f"bit index {i} out of range 1..{self.n_bits}")
        return ((self.codes >> (self.n_bits - i)) & 1).astype(np.uint8)


def _code_dtype(n_bits: int):
    return np.uint8 if n_bits <= 8 else np.uint16


def code_value(codes: np.ndarray, n_bits: int) -> np.ndarray:
    """Magnitude encoded by ``codes``: ``c * 2^-Nq`` in [0, 1)."""
    return codes.astype(np.float64) * (2.0 ** -n_bits)


# ---------------------------------------------------------------------------
# magnitude quantizers: v in [0, 1) -> integer codeword
# ---------------------------------------------------------------------------

def sme_quantize_mag(v: np.ndarray, n_bits: int = 8, window: int = 3) -> np.ndarray:
    """SME / modified-APT quantization (paper Eq. 2).

    Rounds ``v`` to the nearest value of the form
    ``sum_{i=k}^{min(Nq, k+S-1)} b_i 2^-i`` — S significant binary digits
    anchored at the leading one, truncated at bit Nq.
    """
    v = np.asarray(v, dtype=np.float64)
    if np.any(v < 0) or np.any(v >= 1.0):
        raise ValueError("sme_quantize_mag expects magnitudes in [0, 1)")
    mant, exp = np.frexp(v)                      # v = mant * 2^exp, mant in [0.5, 1)
    lead = 1 - exp                               # leading-one index; v in [2^-lead, 2^-(lead-1))
    k = np.clip(lead, 1, n_bits)
    w_end = np.minimum(n_bits, k + window - 1)
    m_int = np.round(np.ldexp(v, w_end))         # v / 2^-w_end
    # A round-up can carry into bit k-1 (e.g. 0.249.. -> 0.25); re-anchor once.
    over = m_int >= (1 << 1) ** (w_end - k + 1).astype(np.int64)  # 2^(w_end-k+1)
    k = np.where(over, np.maximum(k - 1, 1), k)
    w_end = np.minimum(n_bits, k + window - 1)
    m_int = np.round(np.ldexp(v, w_end)).astype(np.int64)
    codes = (m_int << (n_bits - w_end)).astype(_code_dtype(n_bits))
    return codes


def int_quantize_mag(v: np.ndarray, n_bits: int = 8) -> np.ndarray:
    """Plain fixed-point (INT-Nq) magnitude quantization (codes 0..2^Nq-1).

    Codes decode as ``c * 2^-Nq`` (shared convention), so rounding uses the
    2^Nq grid with the top code clipped."""
    v = np.asarray(v, dtype=np.float64)
    maxc = (1 << n_bits) - 1
    return np.clip(np.round(np.ldexp(v, n_bits)), 0, maxc).astype(
        _code_dtype(n_bits))


def po2_quantize_mag(v: np.ndarray, n_bits: int = 8) -> np.ndarray:
    """Power-of-two quantization: a single '1' bit per codeword."""
    v = np.asarray(v, dtype=np.float64)
    tiny = 2.0 ** (-n_bits - 1)
    safe = np.maximum(v, tiny / 4)
    e = np.clip(np.round(-np.log2(safe)), 1, n_bits).astype(np.int64)
    codes = (1 << (n_bits - e)).astype(np.int64)
    codes = np.where(v < tiny * np.sqrt(2.0) / 2, 0, codes)
    return codes.astype(_code_dtype(n_bits))


def apt_quantize_mag(v: np.ndarray, n_bits: int = 8, terms: int = 2) -> np.ndarray:
    """Additive powers-of-two (APT [12]): greedy sum of ``terms`` PoT terms.

    Bits may land anywhere in 1..Nq (no window constraint) — the baseline
    SME modifies.
    """
    v = np.asarray(v, dtype=np.float64)
    full = int_quantize_mag(v, n_bits).astype(np.int64)   # round-to-nearest Nq-bit code
    kept = np.zeros_like(full)
    resid = full.copy()
    for _ in range(terms):
        # highest set bit of the residual code
        nz = resid > 0
        msb = np.zeros_like(resid)
        msb[nz] = np.int64(1) << np.floor(np.log2(resid[nz])).astype(np.int64)
        kept |= msb
        resid &= ~msb
    # round-to-nearest on the last kept term: carry if the residual is more
    # than half of the least-kept bit (keeps <= `terms` PoT terms afterwards
    # in the common case; exact APT uses the same rounding).
    lsb = kept & (-kept)
    carry = (resid * 2 > lsb) & (lsb > 0)
    kept = np.where(carry, kept + lsb, kept)
    maxc = (1 << n_bits) - 1
    return np.clip(kept, 0, maxc).astype(_code_dtype(n_bits))


# ---------------------------------------------------------------------------
# full tensor quantization
# ---------------------------------------------------------------------------

def _per_channel_scale(w: np.ndarray, axis: Optional[int]) -> np.ndarray:
    a = np.abs(w)
    if axis is None:
        s = np.max(a)
        s = np.asarray(s if s > 0 else 1.0, dtype=np.float64)
        return s.reshape((1,) * w.ndim)
    axes = tuple(d for d in range(w.ndim) if d != axis % w.ndim)
    s = np.max(a, axis=axes, keepdims=True)
    return np.where(s > 0, s, 1.0)


def quantize(
    w: np.ndarray,
    method: str = "sme",
    n_bits: int = 8,
    window: int = 3,
    channel_axis: Optional[int] = None,
    apt_terms: int = 2,
) -> QuantizedTensor:
    """Quantize a real weight tensor into the shared codeword format.

    ``channel_axis=None`` -> per-tensor scale (crossbar-realistic default);
    an integer selects per-channel scales along that axis.
    """
    if method not in SUPPORTED_METHODS:
        raise ValueError(f"unknown method {method!r}; pick from {SUPPORTED_METHODS}")
    w = np.asarray(w, dtype=np.float64)
    signs = np.where(w < 0, -1, 1).astype(np.int8)
    raw_scale = _per_channel_scale(w, channel_axis)

    if method == "sme":
        # scale magnitudes into [0, 1 - 2^-S] (paper §III-A scaling shift)
        code_max = 1.0 - 2.0 ** (-window)
    elif method == "int":
        code_max = (2.0 ** n_bits - 1) / 2.0 ** n_bits
    else:  # po2 / apt encode magnitudes in [0, 1) directly; keep headroom
        code_max = 1.0 - 2.0 ** (-n_bits)

    v = np.abs(w) / raw_scale * code_max
    v = np.clip(v, 0.0, np.nextafter(1.0, 0.0))

    if method == "sme":
        codes = sme_quantize_mag(v, n_bits, window)
    elif method == "int":
        codes = int_quantize_mag(v, n_bits)
    elif method == "po2":
        codes = po2_quantize_mag(v, n_bits)
    else:
        codes = apt_quantize_mag(v, n_bits, terms=apt_terms)

    scale = raw_scale / code_max  # dequant: value(code) * scale
    return QuantizedTensor(
        codes=codes, signs=signs, scale=scale, n_bits=n_bits,
        method=method, window=window if method == "sme" else None,
    )


def dequantize(q: QuantizedTensor) -> np.ndarray:
    return code_value(q.codes, q.n_bits) * q.signs.astype(np.float64) * q.scale


def quant_mse(w: np.ndarray, q: QuantizedTensor) -> float:
    """Mean squared quantization error (paper Fig. 9 metric)."""
    d = np.asarray(w, dtype=np.float64) - q.dequantize()
    return float(np.mean(d * d))
