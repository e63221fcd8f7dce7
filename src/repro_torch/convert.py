"""Carry param trees between the reference's layout and the port's.

``from_reference`` takes the reference decoder-only LM's params as numpy
arrays (``jax.tree.map(np.asarray, params)``), dense or already SME-packed
with ``sme_*`` / ``sme_v3_*`` leaves, and returns the port's params:
the stacked ``blocks["slot0"]`` arrays split into one dict per layer,
every leaf a torch tensor on ``device``.  Packed leaves are carried byte
for byte (their padded plane-list length included), so both packages then
compute the same function; a compiler's per-layer draft depth
(``sme_draft_planes``, read under ``use_spec_depth("plan")``) comes across
as each layer's scalar.  ``to_reference`` is the inverse: the layout the
compiler plans, packs and persists.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.integrate import to_torch

__all__ = ["from_reference", "to_reference"]


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


def to_reference(params: dict) -> dict:
    """The inverse of :func:`from_reference`: the port's per-layer params
    (torch tensors or numpy arrays) as the reference's tree of numpy
    arrays, every ``blocks[i]`` leaf stacked into ``blocks["slot0"]``.
    The compiler plans and packs this layout (one plan per stacked leaf,
    as the reference does), so a ``.smez`` of either package serves in
    the other."""
    def host(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) \
            else np.asarray(t)

    def stack(*layers):
        if isinstance(layers[0], dict):
            return {k: stack(*(d[k] for d in layers)) for k in layers[0]}
        return np.stack([host(t) for t in layers])

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return host(t)
    return {"embed": walk(params["embed"]),
            "final_norm": walk(params["final_norm"]),
            "blocks": {"slot0": stack(*params["blocks"])}}
