"""Carry a reference param tree across into the port.

``from_reference`` takes the reference decoder-only LM's params as numpy
arrays (``jax.tree.map(np.asarray, params)``), dense or already SME-packed
with ``sme_*`` / ``sme_v3_*`` leaves, and returns the port's params:
the stacked ``blocks["slot0"]`` arrays split into one dict per layer,
every leaf a torch tensor on ``device``.  Packed leaves are carried byte
for byte (their padded plane-list length included), so both packages then
compute the same function; a compiler's per-layer draft depth
(``sme_draft_planes``, read under ``use_spec_depth("plan")``) comes across
as each layer's scalar.
"""
from __future__ import annotations

import numpy as np

from .core.integrate import to_torch

__all__ = ["from_reference"]


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def from_reference(tree: dict, device=None) -> dict:
    extra = set(tree) - {"embed", "final_norm", "blocks"}
    if extra or set(tree["blocks"]) != {"slot0"}:
        raise NotImplementedError(
            f"only single-slot decoder-only trees with tied heads carry "
            f"across so far; got extra keys {sorted(extra)} and block slots "
            f"{sorted(tree['blocks'])}")
    slot = tree["blocks"]["slot0"]
    n_layers = np.asarray(slot["norm1"]["w"]).shape[0]
    return to_torch({"embed": tree["embed"], "final_norm": tree["final_norm"],
                     "blocks": [_index(slot, i) for i in range(n_layers)]},
                    device)
