"""Offline SME model compiler (DESIGN.md §4), the port's copy of
``repro/compiler``.

Three stages between a float param tree and a serveable model:

  1. **plan** (`compiler.plan`) — per-layer search over
     ``(n_bits, window, squeeze, backend)`` under a global accuracy
     budget, priced by the ReRAM model and the card's roofline (or its
     measured times, ``hardware.autotune``);
  2. **reorder** (`compiler.reorder`) — row permutations that pack
     bit-plane non-zeros into fewer 128x128 tiles before slicing;
  3. **pack + persist** (`compiler.artifact`) — execute the plan through
     ``core.integrate.convert_params_to_sme`` and store the result as a
     versioned ``.smez`` artifact that ``ServeEngine.from_artifact``
     boots with zero per-boot packing.

Plans and artifacts are the reference's byte for byte, so a ``.smez``
written by either package serves in the other.  CLI:
``python -m repro_torch.launch.compile``.
"""
from .plan import (
    Candidate, LayerPlan, CompilePlan, plan_model, DEFAULT_CANDIDATES,
    candidate_error_bound,
)
from .reorder import (
    plan_row_permutation, permutation_from_codes, permutation_gain,
    occupied_tile_count, row_block_signature,
    row_plane_signature, plane_permutation_gain, occupied_plane_tile_count,
)
from .artifact import (
    FORMAT_VERSION, save_artifact, load_artifact, read_manifest,
    verify_artifact, compile_model,
)

__all__ = [
    "Candidate", "LayerPlan", "CompilePlan", "plan_model",
    "DEFAULT_CANDIDATES", "candidate_error_bound",
    "plan_row_permutation", "permutation_from_codes", "permutation_gain",
    "occupied_tile_count", "row_block_signature",
    "row_plane_signature", "plane_permutation_gain",
    "occupied_plane_tile_count",
    "FORMAT_VERSION", "save_artifact", "load_artifact", "read_manifest",
    "verify_artifact", "compile_model",
]
