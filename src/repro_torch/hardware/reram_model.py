"""ISAAC-configured analytical ReRAM cost model (paper §V setup, Table I).

The paper evaluates SME on a GEM5-based simulator configured like ISAAC [5]
(128x128 SLC crossbars, 100ns cycle, 8 crossbars/CU, 8 CUs/bank, eDRAM
buffer) with CACTI-derived memory costs at 32nm.  We reproduce the *relative*
energy/area efficiency comparisons (paper Fig. 7/10) with an analytical
model: absolute constants below are order-of-magnitude values assembled from
the ISAAC paper and CACTI-class estimates; every paper figure normalizes to
a baseline, so only ratios matter.

A copy of ``repro/hardware/reram_model.py`` (pure Python): the paper's
own currency (crossbars, ADC energy, index SRAM), which the compiler's
``objective="energy"`` prices candidates in.  The card's roofline lives
in ``gpu_model.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

__all__ = ["ReRAMConfig", "LayerMapping", "energy_nj", "area_mm2", "cycles",
           "summarize", "mapping_from_plan", "summarize_plan"]


@dataclasses.dataclass(frozen=True)
class ReRAMConfig:
    xbar_rows: int = 128
    xbar_cols: int = 128
    cell_bits: int = 1                 # SLC (paper default); 2 = MLC
    cycle_ns: float = 100.0            # Table I: 100ns/cycle
    xbars_per_cu: int = 8              # Table I
    cus_per_bank: int = 8

    # --- energy per crossbar per input-bit cycle (nJ), ISAAC-class 32nm ---
    e_xbar_cycle_nj: float = 0.30      # array read (128x128 cells)
    e_adc_cycle_nj: float = 0.20       # 8-bit ADC, 128 samples muxed
    e_dac_cycle_nj: float = 0.05       # 128 1-bit DACs
    e_shift_add_cycle_nj: float = 0.02 # shift&add + accumulate
    e_edram_per_byte_nj: float = 0.0008
    e_index_per_access_nj: float = 0.001

    # --- area (mm^2), ISAAC-class 32nm ---
    a_xbar_mm2: float = 0.0002         # 128x128 1T1R array
    a_adc_mm2: float = 0.0012
    a_dac_mm2: float = 0.00017
    a_periph_mm2: float = 0.0005       # S&H, mux, shift-add share
    a_sram_per_kb_mm2: float = 0.002   # index/register storage

    @property
    def a_per_xbar_mm2(self) -> float:
        return self.a_xbar_mm2 + self.a_adc_mm2 + self.a_dac_mm2 + self.a_periph_mm2


@dataclasses.dataclass
class LayerMapping:
    """Resource usage of one layer under one mapping scheme."""

    name: str
    crossbars: int                 # allocated crossbars (after dropping/squeeze)
    input_bits: int                # bit-serial input cycles (8 + squeeze x)
    activations: int               # number of input vectors (VMM invocations)
    index_bytes: int = 0           # per-scheme index/register storage
    edram_bytes: int = 0           # activation traffic per invocation


def cycles(cfg: ReRAMConfig, layers: Iterable[LayerMapping]) -> float:
    """Total bit-serial cycles (each crossbar works every input-bit cycle)."""
    total = 0.0
    for l in layers:
        cu_waves = max(1, -(-l.crossbars // cfg.xbars_per_cu))
        total += l.input_bits * l.activations * cu_waves
    return total


def energy_nj(cfg: ReRAMConfig, layers: Iterable[LayerMapping]) -> float:
    e = 0.0
    per_xbar_cycle = (
        cfg.e_xbar_cycle_nj + cfg.e_adc_cycle_nj + cfg.e_dac_cycle_nj
        + cfg.e_shift_add_cycle_nj
    )
    for l in layers:
        xbar_cycles = l.crossbars * l.input_bits * l.activations
        e += xbar_cycles * per_xbar_cycle
        e += l.edram_bytes * l.activations * cfg.e_edram_per_byte_nj
        e += l.index_bytes * l.activations * cfg.e_index_per_access_nj
    return e


def area_mm2(cfg: ReRAMConfig, layers: Iterable[LayerMapping]) -> float:
    a = 0.0
    for l in layers:
        a += l.crossbars * cfg.a_per_xbar_mm2
        a += (l.index_bytes / 1024.0) * cfg.a_sram_per_kb_mm2
    return a


def summarize(cfg: ReRAMConfig, layers: Iterable[LayerMapping]) -> Dict[str, float]:
    layers = list(layers)
    return {
        "crossbars": float(sum(l.crossbars for l in layers)),
        "cycles": cycles(cfg, layers),
        "energy_nj": energy_nj(cfg, layers),
        "area_mm2": area_mm2(cfg, layers),
        "index_bytes": float(sum(l.index_bytes for l in layers)),
    }


def mapping_from_plan(layer_plan,
                      cfg: Optional[ReRAMConfig] = None) -> LayerMapping:
    """One compiler ``LayerPlan`` -> the resource mapping it implies.

    The compiler (``repro_torch.compiler.plan``) measures per-layer crossbars
    under each layer's *own* ``(n_bits, squeeze)``; this translates that
    into the cost model's currency: squeezed layers pay ``Nq + x``
    bit-serial input cycles (the paper's input-doubling compensation) and
    the occupancy-bitmap + RCM-register index storage of §III-C.
    """
    cfg = cfg or ReRAMConfig()
    k, n = layer_plan.shape
    nt = -(-k // cfg.xbar_rows) * -(-n // cfg.xbar_cols)
    index = (nt * layer_plan.n_bits) // 8 + 1           # occupancy bitmap
    if layer_plan.squeeze:
        index += nt * cfg.xbar_rows * 2 // 8            # 2-bit RCM regs
    return LayerMapping(
        name=layer_plan.path,
        crossbars=max(layer_plan.crossbars, 1) * layer_plan.n_slices,
        input_bits=layer_plan.n_bits + layer_plan.squeeze,
        activations=1,
        index_bytes=index * layer_plan.n_slices,
        edram_bytes=k * layer_plan.n_slices,
    )


def summarize_plan(cfg: ReRAMConfig, plan) -> Dict[str, float]:
    """Aggregate resources of a whole ``CompilePlan`` — per-layer settings,
    not one global one, which is what the paper's Fig. 8/11 tables need."""
    return summarize(cfg, [mapping_from_plan(lp, cfg)
                           for _, lp in sorted(plan.layers.items())])
