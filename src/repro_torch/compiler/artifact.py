"""The ``.smez`` artifact store (compiler stage 3, DESIGN.md §4).

The port's copy of ``repro/compiler/artifact.py``: the same directory
layout, payload names, manifest keys, sha256 and format version, so a
``.smez`` written by either package loads in the other
(``tests/test_torch_artifact.py``).  What differs: leaves may be torch
tensors when saved (they are written as numpy), and ``load_artifact``
checks every kernel operand list on the host
(``core.backend.validate_operands``) before any leaf reaches a device.

A ``.smez`` artifact is a directory holding a compiled model — the packed
SME param tree (uint8 codes, sign bitmaps, scales, per-backend CSC kernel
operands, permutations) plus the
:class:`~repro_torch.compiler.plan.CompilePlan` that produced it — so serving boots with **zero per-boot packing**:

    model.smez/
      manifest.json          format/plan versions, tree skeleton, per-array
                             shape/dtype/sha256, the serialized plan, extras
      payload/NNNN__key.npy  one raw .npy per leaf (mmap-able)

Payloads are individual ``.npy`` files rather than one ``.npz`` so
``load_artifact`` can hand back ``np.load(..., mmap_mode="r")`` views —
the kernel-ready CSC operands map straight from disk and are only paged
in when first touched (``ServeEngine.from_artifact`` copies them to the
card one leaf at a time).

Versioning rules: ``FORMAT_VERSION`` bumps on any layout change to the
manifest or payload naming; readers refuse artifacts *newer* than they
understand and accept equal-or-older versions.  Array content hashes
(sha256) are always recorded; ``load_artifact(verify=True)`` /
``verify_artifact`` check them (reads every byte — off by default so the
mmap load stays lazy).

``compile_model`` is the one-call pipeline (plan -> reorder -> pack ->
persist); ``launch/compile.py`` is its CLI and ``ServeEngine.from_artifact``
its consumer.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .plan import CompilePlan, plan_model

__all__ = ["FORMAT_VERSION", "save_artifact", "load_artifact",
           "read_manifest", "verify_artifact", "compile_model"]

#: 1 — tile-CSC only: sme_codes/rowexp/sign/scale/meta (+ sme_v1_*/v2_*
#:     operands, sme_perm).
#: 2 — plane-CSC leaves: ``sme_tilesq`` per-tile squeeze depths and the
#:     ``sme_v3_*`` operand set; plan version 2 (squeeze_max /
#:     reorder_level / occupied_plane_tiles per layer).
#: Readers refuse artifacts *newer* than they understand and accept
#: equal-or-older ones: a version-1 artifact loads as tile-CSC only
#: (``smeweight_from_param`` defaults the absent per-tile depths to the
#: global ``sme_squeezed``).
FORMAT_VERSION = 2


# --------------------------------------------------------------- tree codec
def _flatten_tree(tree) -> Tuple[Dict[str, Any], Any]:
    """(flat {key: leaf}, JSON skeleton with leaf keys at the leaves)."""
    flat: Dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            return {"kind": "dict",
                    "items": {k: walk(v, path + [str(k)])
                              for k, v in node.items()}}
        if isinstance(node, (list, tuple)):
            return {"kind": "list" if isinstance(node, list) else "tuple",
                    "items": [walk(v, path + [str(i)])
                              for i, v in enumerate(node)]}
        key = "/".join(path)
        flat[key] = node
        return {"kind": "leaf", "key": key}

    skeleton = walk(tree, [])
    return flat, skeleton


def _unflatten_tree(skeleton, flat: Dict[str, Any]):
    kind = skeleton["kind"]
    if kind == "dict":
        return {k: _unflatten_tree(v, flat)
                for k, v in skeleton["items"].items()}
    if kind in ("list", "tuple"):
        vals = [_unflatten_tree(v, flat) for v in skeleton["items"]]
        return vals if kind == "list" else tuple(vals)
    return flat[skeleton["key"]]


def _payload_name(idx: int, key: str) -> str:
    return f"{idx:04d}__{re.sub(r'[^A-Za-z0-9_.-]', '_', key)[:80]}.npy"


# ------------------------------------------------------------------ save/load
def save_artifact(path, params, plan: Optional[CompilePlan] = None,
                  extra: Optional[Dict] = None) -> pathlib.Path:
    """Persist a packed param tree (+ plan) as a ``.smez`` directory.

    Atomic: writes to ``<path>.tmp`` then renames, so a crash mid-save
    never leaves a half-readable artifact.
    """
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        import shutil
        shutil.rmtree(tmp)
    (tmp / "payload").mkdir(parents=True)

    flat, skeleton = _flatten_tree(params)
    arrays: Dict[str, Dict] = {}
    for idx, (key, leaf) in enumerate(sorted(flat.items())):
        arr = leaf.cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        fname = _payload_name(idx, key)
        np.save(tmp / "payload" / fname, arr)
        arrays[key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()
                                     ).hexdigest(),
        }
    manifest = {
        "format": "smez",
        "format_version": FORMAT_VERSION,
        "tree": skeleton,
        "arrays": arrays,
        "plan": json.loads(plan.to_json()) if plan is not None else None,
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1,
                                                  sort_keys=True))
    if path.exists():
        import shutil
        shutil.rmtree(path)
    tmp.rename(path)
    return path


def read_manifest(path) -> Dict:
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest.get("format") != "smez":
        raise ValueError(f"{path} is not a .smez artifact")
    ver = manifest.get("format_version", 0)
    if ver > FORMAT_VERSION:
        raise ValueError(
            f"artifact format version {ver} is newer than supported "
            f"{FORMAT_VERSION}; rebuild with launch/compile or upgrade")
    return manifest


def load_artifact(path, mmap: bool = True, verify: bool = False,
                  place=None):
    """Load a ``.smez`` artifact -> (params, plan | None, manifest).

    Leaves come back as numpy arrays — memory-mapped when ``mmap`` (the
    zero-copy path: CSC operands page in on first touch) — in the exact
    tree structure ``save_artifact`` saw (the reference's layout for a
    compiled model: ``convert.from_reference`` splits it per layer).

    Every packed weight's kernel operand lists are checked first
    (``core.backend.validate_operands``, reading the index arrays only),
    so a corrupt or foreign list raises ``ValueError`` here, before any
    launch.  Then ``place(key, arr) -> arr`` is applied per leaf (``key``
    is the '/'-joined tree path).
    """
    path = pathlib.Path(path)
    manifest = read_manifest(path)
    flat: Dict[str, Any] = {}
    for key, info in manifest["arrays"].items():
        arr = np.load(path / "payload" / info["file"],
                      mmap_mode="r" if mmap else None)
        if list(arr.shape) != info["shape"] or str(arr.dtype) != info["dtype"]:
            raise ValueError(
                f"artifact leaf {key}: payload {arr.shape}/{arr.dtype} != "
                f"manifest {info['shape']}/{info['dtype']}")
        if verify:
            digest = hashlib.sha256(
                np.ascontiguousarray(arr).tobytes()).hexdigest()
            if digest != info["sha256"]:
                raise ValueError(f"artifact leaf {key}: sha256 mismatch "
                                 f"(corrupt payload {info['file']})")
        flat[key] = arr
    _validate_tree(_unflatten_tree(manifest["tree"], flat))
    if place is not None:
        flat = {key: place(key, arr) for key, arr in flat.items()}
    params = _unflatten_tree(manifest["tree"], flat)
    plan = (CompilePlan.from_json(json.dumps(manifest["plan"]))
            if manifest.get("plan") else None)
    return params, plan, manifest


def _validate_tree(tree, path=()) -> None:
    """validate_operands on every kernel operand set of every packed
    weight of a tree."""
    from ..core.backend import validate_operands
    if isinstance(tree, dict):
        if "sme_codes" in tree:
            for name in ("v1", "v2", "v3"):
                if any(k.startswith(f"sme_{name}_") for k in tree):
                    validate_operands(tree, name, "/".join(path))
            return
        tree = tree.items()
    elif isinstance(tree, (list, tuple)):
        tree = enumerate(tree)
    else:
        return
    for key, sub in tree:
        _validate_tree(sub, path + (str(key),))


def verify_artifact(path) -> int:
    """Re-hash every payload against the manifest; returns #arrays checked."""
    _, _, manifest = load_artifact(path, mmap=False, verify=True)
    return len(manifest["arrays"])


# ----------------------------------------------------------------- pipeline
def compile_model(params, plan: Optional[CompilePlan] = None,
                  out: Optional[str] = None, error_budget: float = 0.05,
                  backend: Optional[str] = "auto", reorder: bool = True,
                  tile: Tuple[int, int] = (128, 128), predicate=None,
                  extra: Optional[Dict] = None, **plan_kw):
    """Plan -> reorder -> pack -> (optionally) persist, in one call.

    Returns ``(packed_params, plan)`` and writes ``out`` (a ``.smez``
    directory) when given.  ``plan=None`` runs ``plan_model`` with the
    remaining arguments; a caller-supplied plan is executed as-is, which
    is how inline conversion and offline compilation share one code path
    (both end in ``convert_params_to_sme(plan=...)``).

    The pack step compresses exactly the layers the plan covers — the
    plan itself is the eligibility predicate — so the ``.smez`` manifest
    never disagrees with the payload about what was compressed.  Each
    weight is compressed once, whatever the operand sets.  The packed
    tree comes back as numpy arrays in the input's layout: for a model,
    the reference's stacked one (``convert.to_reference``), which
    ``convert.from_reference`` splits per layer onto a device.
    """
    from ..core.integrate import _convert
    params_np = _to_numpy(params)
    if plan is None:
        plan = plan_model(params_np, error_budget=error_budget,
                          backend=backend, reorder=reorder, tile=tile,
                          predicate=predicate, **plan_kw)
    packed = _convert(params_np, tile=tile, plan=plan,
                      predicate=lambda path, leaf:
                      plan.for_path(path) is not None)
    if out is not None:
        save_artifact(out, packed, plan, extra=extra)
    return packed, plan


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree.cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)
