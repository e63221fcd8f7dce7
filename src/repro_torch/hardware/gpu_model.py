"""The card's roofline constants: the counterpart of
``repro/hardware/tpu_model.py`` for the port.

The compiler's planner prices a candidate under ``objective="bytes"`` as
the HBM bytes one decoded token reads over the memory rate: seconds per
token on the roofline (``compiler/plan.py::_candidate_cost``).  The
reference divides by ``V5E.hbm_bw``; the port divides by
``H100.hbm_bw``.  A constant divisor scales every candidate's price by
the same factor, so every greedy ratio (cost saved per unit of added
error) keeps its order and every comparison its sign: with no autotune
cache, the port's plan equals the reference's exactly
(``tests/test_torch_compiler.py``).  What changes the plan on the card is
a *measured* price (``hardware/autotune.py``), never this constant.
"""
from __future__ import annotations

import dataclasses

__all__ = ["GPUSpec", "H100"]


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str = "h100-sxm"
    #: HBM3 bytes/s, the H100 SXM data sheet's 3.35 TB/s
    hbm_bw: float = 3.35e12


H100 = GPUSpec()
