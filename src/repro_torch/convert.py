"""Carry param trees between the reference's layout and the port's.

``from_reference`` takes the reference's params as numpy arrays
(``jax.tree.map(np.asarray, params)``), dense or already SME-packed with
``sme_*`` / ``sme_v3_*`` leaves, and returns the port's params.  A
decoder-only LM's: the
stacked superblock arrays ``blocks["slot{j}"]`` split into one dict per
layer (layer ``s * n_slots + j`` is slot ``j`` of superblock ``s``, as the
reference's scan runs them), the top-level leaves (``embed``,
``final_norm``, an untied ``lm_head``, a vision model's ``patch_proj``,
deepseek's leading dense layers ``first{i}``) as they are, every leaf a
torch tensor on ``device``.  Stacked expert leaves ``[n_super, E, D,
F]`` become each layer's ``[E, D, F]``, dense or packed; so do the
recurrent mixers' leaves (q/k/v ``[n_super, NH, dh, dh]``, sLSTM's r
``[n_super, 4, NH, dh, dh]``, ``A_log``, ``conv_w``, ``D``, the packed
projections).  Packed leaves
are carried byte for byte (their padded plane-list length included), so
both packages then compute the same function; a compiler's per-layer
draft depth (``sme_draft_planes``, read under ``use_spec_depth("plan")``)
comes across as each layer's scalar (one per expert for stacked
experts).  An encoder-decoder model's (whisper): the stacked ``enc``
and ``dec`` layers split into per-layer lists, ``embed``, ``enc_norm``,
``dec_norm`` and ``lm_head`` as they are.  Any other top-level key is
refused.  ``to_reference`` is the inverse: the layout the compiler plans,
packs and persists.  A CNN's tree (``models/cnn.py``) has the reference's
layout in both packages: ``cnn_from_reference`` and ``cnn_to_reference``
map its arrays to tensors on a device and back.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .core.integrate import to_torch

__all__ = ["from_reference", "split_reference", "to_reference",
           "cnn_from_reference", "cnn_to_reference"]


def _top(key: str) -> bool:
    """A top-level key that carries across as it is."""
    return key in ("embed", "final_norm", "lm_head", "patch_proj") or \
        re.fullmatch(r"first\d+", key) is not None


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


#: the top-level leaves of an encoder-decoder tree besides ``enc``/``dec``
_ENCDEC_TOP = ("embed", "enc_norm", "dec_norm", "lm_head")


def _encdec(tree) -> bool:
    return "enc" in tree or "dec" in tree


def _layers(stacked) -> list:
    n = np.asarray(stacked["norm1"]["w"]).shape[0]
    return [_index(stacked, i) for i in range(n)]


def from_reference(tree: dict, device=None) -> dict:
    return to_torch(split_reference(tree), device)


def split_reference(tree: dict) -> dict:
    """:func:`from_reference`'s tree with every leaf a numpy array (a view
    of the stacked leaf where it is one: a memory-mapped artifact stays
    mapped), for a caller that places the leaves itself."""
    if _encdec(tree):
        extra = set(tree) - set(_ENCDEC_TOP) - {"enc", "dec"}
        if extra or "enc" not in tree or "dec" not in tree:
            raise NotImplementedError(
                f"an encoder-decoder tree has enc, dec and "
                f"{', '.join(_ENCDEC_TOP)}; got {sorted(tree)}")
        out = {k: v for k, v in tree.items() if k in _ENCDEC_TOP}
        out["enc"], out["dec"] = _layers(tree["enc"]), _layers(tree["dec"])
        return out
    n_slots = len(tree["blocks"])
    extra = {k for k in tree if k != "blocks" and not _top(k)}
    if extra or set(tree["blocks"]) != {f"slot{j}" for j in range(n_slots)}:
        raise NotImplementedError(
            f"only decoder-only trees of superblock slots carry across; got "
            f"extra keys {sorted(extra)} and block slots "
            f"{sorted(tree['blocks'])}")
    slots = [tree["blocks"][f"slot{j}"] for j in range(n_slots)]
    n_super = np.asarray(slots[0]["norm1"]["w"]).shape[0]
    out = {k: v for k, v in tree.items() if _top(k)}
    out["blocks"] = [_index(slot, s) for s in range(n_super)
                     for slot in slots]
    return out


def cnn_from_reference(tree: dict, device=None) -> dict:
    """A CNN's reference params (numpy arrays) as the port's: the same
    tree, every leaf a torch tensor on ``device``."""
    return to_torch(tree, device)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _walk(t):
    """A dict tree with every leaf a numpy array."""
    if isinstance(t, dict):
        return {k: _walk(v) for k, v in t.items()}
    return _host(t)


def cnn_to_reference(params: dict) -> dict:
    """The inverse of :func:`cnn_from_reference`: the same tree of numpy
    arrays."""
    return _walk(params)


def to_reference(params: dict, n_slots: int = 1) -> dict:
    """The inverse of :func:`from_reference`: the port's per-layer params
    (torch tensors or numpy arrays) as the reference's tree of numpy
    arrays, layers ``j, j + n_slots, ...`` stacked into
    ``blocks["slot{j}"]`` (``n_slots = len(cfg.pattern)``), or an
    encoder-decoder model's ``enc`` and ``dec`` layers each stacked.  The
    compiler plans and packs this layout (one plan per stacked leaf, as
    the reference does), so a ``.smez`` of either package serves in the
    other."""
    def stack(*layers):
        if isinstance(layers[0], dict):
            return {k: stack(*(d[k] for d in layers)) for k in layers[0]}
        return np.stack([_host(t) for t in layers])

    if _encdec(params):
        out = {k: _walk(v) for k, v in params.items() if k in _ENCDEC_TOP}
        out["enc"], out["dec"] = stack(*params["enc"]), stack(*params["dec"])
        return out
    blocks = params["blocks"]
    if len(blocks) % n_slots:
        raise ValueError(f"{len(blocks)} layers are not whole superblocks of "
                         f"{n_slots} slots")
    out = {k: _walk(v) for k, v in params.items() if _top(k)}
    out["blocks"] = {f"slot{j}": stack(*blocks[j::n_slots])
                     for j in range(n_slots)}
    return out
