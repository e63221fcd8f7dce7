"""Per-layer squeeze planning (compiler stage 1, DESIGN.md §4).

The port's copy of ``repro/compiler/plan.py``: the same candidate grid,
evaluation, frontier and greedy allocation, and the same
:class:`CompilePlan` JSON (``PLAN_VERSION`` 4), byte-equal to the
reference's on the same numpy tree (``tests/test_torch_compiler.py``).
Two prices differ by design: bytes per token are divided by the card's
``hardware.gpu_model.H100.hbm_bw`` instead of the TPU's (a constant
factor, so the plan does not change), and an autotune cache's measured
times are looked up under the card's device kind
(``hardware.autotune.device_kind``).

One global ``(n_bits, window, squeeze)`` setting leaves savings on the
table: bit-slice sparsity varies wildly across layers (Zhang et al.,
arXiv:1909.08496), so the layer that tolerates ``squeeze=2`` at no
accuracy cost subsidizes the one that cannot.  ``plan_model`` searches a
candidate grid per eligible weight and allocates a *global* accuracy
budget across layers greedily over the error/bytes frontier:

  1. every layer starts at its most accurate candidate;
  2. candidate "upgrades" (fewer bytes, more error) are applied in order
     of bytes-saved per unit of added weighted error, while the
     weight-count-weighted mean error bound stays within ``error_budget``.

Per-candidate error is the analytic ``core.squeeze.squeeze_error_bound``
plus the S-window truncation term (``measure="analytic"``), or the
measured relative dequant error of a trial compression
(``measure="trial"``, the default — it also yields exact occupied-tile /
crossbar counts).  Costs come from the existing hardware models:
``hardware.reram_model`` prices crossbars/energy (the paper's currency),
``hardware.gpu_model`` turns bytes/weight into decode seconds (the
card's currency); ``objective`` picks which one the greedy minimizes.

The result is a serializable :class:`CompilePlan` that
``core.integrate.convert_params_to_sme(plan=...)`` executes — one code
path for inline conversion and the offline ``.smez`` artifact
(`compiler.artifact`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.squeeze import squeeze_error_bound

__all__ = ["Candidate", "LayerPlan", "CompilePlan", "plan_model",
           "DEFAULT_CANDIDATES", "candidate_error_bound",
           "draft_depth_from_occupancy"]

PLAN_VERSION = 4

#: (n_bits, window, squeeze[, squeeze_max]) grid searched per layer.  All
#: stay within the uint8 code dtype; squeeze>=1 / window<=3 rows are
#: minifloat-6 (v2) eligible, the rest serve through v1/xla.  4-tuples add
#: per-tile squeeze depth (free deepening up to squeeze_max — exact, so
#: the candidate's error equals its 3-tuple sibling's; it is a distinct
#: candidate because the plane-CSC byte count differs).
DEFAULT_CANDIDATES: Tuple[Tuple[int, ...], ...] = (
    (8, 3, 0), (8, 3, 1), (8, 3, 2), (8, 2, 1), (8, 2, 2), (8, 2, 3),
    (6, 3, 1), (6, 2, 2),
    (8, 3, 1, 7), (8, 2, 1, 7), (6, 3, 1, 5),
)


def _norm_candidate(c) -> Tuple[int, int, int, int]:
    """(n_bits, window, squeeze[, squeeze_max]) -> 4-tuple (0 = global)."""
    nb, win, sq = c[0], c[1], c[2]
    sq_max = c[3] if len(c) > 3 else 0
    if sq_max and not sq <= sq_max < nb:
        raise ValueError(f"candidate {c}: squeeze_max must be in "
                         f"[squeeze, n_bits)")
    return nb, win, sq, sq_max


def candidate_error_bound(n_bits: int, window: int, squeeze: int) -> float:
    """Analytic per-weight value-domain error bound of one setting.

    S-window truncation drops bits below the window anchored at the
    leading one (worst case ~2^-(window+1) relative, taken at magnitude
    1 for an absolute bound in [0, 1)); squeeze-out adds the dropped-LSB
    bound from ``core.squeeze.squeeze_error_bound``.
    """
    return 2.0 ** -(window + 1) + squeeze_error_bound(n_bits, squeeze)


@dataclasses.dataclass
class Candidate:
    """One evaluated (n_bits, window, squeeze) setting for one layer."""

    n_bits: int
    window: int
    squeeze: int
    error: float                   # bound (analytic) or measured rel err
    bytes_per_weight: float
    crossbars: int
    backend: Optional[str]         # operand set this setting serves through
    tiles: int = 0                 # occupied 128x128 tiles (CSC entries)
    reorder_gain: int = 0          # occupied tiles freed by row reordering
    squeeze_max: int = 0           # per-tile free-deepening cap (0 = global)
    plane_tiles: int = 0           # occupied (plane, tile) pairs (v3 units)
    plane_reorder_gain: int = 0    # plane-tiles freed by plane-level reorder
    draft_planes: int = 0          # speculative draft depth (0 = no draft)


@dataclasses.dataclass
class LayerPlan:
    """Chosen compression setting + predicted stats for one weight."""

    path: str                      # "/"-joined tree path of the weight leaf
    shape: Tuple[int, int]         # (K, N) of one 2-D slice
    n_slices: int = 1              # leading stacked dims flattened (MoE [E])
    n_bits: int = 8
    window: int = 3
    squeeze: int = 1
    backend: Optional[str] = None  # "v1" | "v2" | "v3" | None (no operands)
    reorder: bool = False
    # stats of the chosen candidate (per 2-D slice)
    error_bound: float = 0.0
    bytes_per_weight: float = 0.0
    crossbars: int = 0
    crossbars_dense: int = 0       # conventional mapping baseline
    occupied_tiles: int = 0        # CSC entries before reordering
    occupied_tiles_reordered: int = 0   # after (== occupied_tiles if not)
    total_tiles: int = 0
    squeeze_max: int = 0           # per-tile squeeze cap (0 = global only)
    reorder_level: str = "tile"    # signature the permutation clusters on
    occupied_plane_tiles: int = 0  # plane-CSC entries (v3 DMA units)
    bm: int = 0                    # measured-best M block size (0 = default;
    #                                carried for the reference, unused: the
    #                                port's kernels fix their own geometry)
    draft_planes: int = 0          # per-tile plane depth of the speculative
    #                                draft pass (DESIGN.md §11); 0 = this
    #                                layer drafts at full precision

    @property
    def n_weights(self) -> int:
        return self.n_slices * self.shape[0] * self.shape[1]

    @property
    def crossbar_reduction(self) -> float:
        return self.crossbars_dense / max(self.crossbars, 1)


@dataclasses.dataclass
class CompilePlan:
    """Serializable output of ``plan_model``; executed by
    ``convert_params_to_sme(plan=...)`` and stored in ``.smez`` manifests."""

    layers: Dict[str, LayerPlan]
    tile: Tuple[int, int] = (128, 128)
    error_budget: float = 0.0
    objective: str = "bytes"
    version: int = PLAN_VERSION

    # ------------------------------------------------------------- queries
    def for_path(self, path) -> Optional[LayerPlan]:
        """Plan for a tree path (sequence of keys or pre-joined string)."""
        key = path if isinstance(path, str) else "/".join(map(str, path))
        return self.layers.get(key)

    def weighted_error(self) -> float:
        """Weight-count-weighted mean of the per-layer error bounds."""
        tot = sum(lp.n_weights for lp in self.layers.values())
        if not tot:
            return 0.0
        return sum(lp.error_bound * lp.n_weights
                   for lp in self.layers.values()) / tot

    def total_bytes(self) -> float:
        return sum(lp.bytes_per_weight * lp.n_weights
                   for lp in self.layers.values())

    def summary(self) -> Dict[str, float]:
        xb = sum(lp.crossbars * lp.n_slices for lp in self.layers.values())
        xbd = sum(lp.crossbars_dense * lp.n_slices
                  for lp in self.layers.values())
        return {
            "layers": len(self.layers),
            "weighted_error": self.weighted_error(),
            "total_bytes": self.total_bytes(),
            "crossbars": xb,
            "crossbars_dense": xbd,
            "crossbar_reduction": xbd / max(xb, 1),
            "reordered_layers": sum(lp.reorder for lp in self.layers.values()),
            "tiles_freed_by_reorder": sum(
                lp.occupied_tiles - lp.occupied_tiles_reordered
                for lp in self.layers.values()),
        }

    # ------------------------------------------------------- serialization
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["tile"] = list(self.tile)
        for lp in d["layers"].values():
            lp["shape"] = list(lp["shape"])
        return json.dumps(d, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CompilePlan":
        d = json.loads(s)
        if d.get("version", 0) > PLAN_VERSION:
            raise ValueError(
                f"plan version {d.get('version')} is newer than supported "
                f"{PLAN_VERSION}")
        layers = {
            k: LayerPlan(**{**v, "shape": tuple(v["shape"])})
            for k, v in d["layers"].items()
        }
        return cls(layers=layers, tile=tuple(d.get("tile", (128, 128))),
                   error_budget=d.get("error_budget", 0.0),
                   objective=d.get("objective", "bytes"),
                   version=d.get("version", PLAN_VERSION))


# --------------------------------------------------------------------------
# candidate evaluation
# --------------------------------------------------------------------------
def _pick_backend(backend: Optional[str], n_bits: int, window: int,
                  squeeze: int, smew=None, shape=None,
                  autotune=None) -> Optional[str]:
    """Which operand set a setting serves through.

    ``auto`` with a trial-compressed ``smew`` prices the actual occupancy:
    v3 (plane-CSC) wins whenever its measured bytes/weight undercut the
    eligible tile-CSC formats — per-plane occupancy is exactly what the
    trial knows and the analytic path cannot.  When an autotune cache
    holds *measured* decode throughput for this shape, observed tokens/s
    overrides the byte ranking entirely — bytes are a prior, the
    measurement is the fact (DESIGN.md §8).
    """
    if backend in (None, "xla"):
        return None
    from ..core.backend import SpmmV2Backend
    v2_ok = SpmmV2Backend.supports_settings(n_bits, window, squeeze)
    if backend == "auto":
        best = "v2" if v2_ok else "v1"
        if smew is not None:
            by_bytes = {"v1": _storage_bytes_per_weight(smew, "v1"),
                        "v3": _storage_bytes_per_weight(smew, "v3")}
            if v2_ok:
                by_bytes["v2"] = _storage_bytes_per_weight(smew, "v2")
            best = min(by_bytes, key=by_bytes.get)
        if autotune is not None and shape is not None:
            cands = ("v1", "v2", "v3") if v2_ok else ("v1", "v3")
            measured = {b: t for b in cands
                        if (t := autotune.measured_tokens_per_s(
                            b, 1, shape[0], shape[1])) is not None}
            if measured:
                best = max(measured, key=measured.get)
        return best
    if backend == "v2" and not v2_ok:
        return "v1"
    return backend


def _storage_bytes_per_weight(smew, backend: Optional[str]) -> float:
    fmt = {"v1": "bytecode", "v2": "minifloat6", "v3": "plane_csc"}.get(
        backend, "planes")
    return smew.storage_bits_per_weight(fmt) / 8


def draft_depth_from_occupancy(smew, coverage: float = 0.90) -> int:
    """Per-layer draft plane-depth for self-speculative decode (§11).

    The draft pass truncates every tile group to its first ``k`` entries —
    the ``k`` most significant occupied planes — so the right ``k`` is the
    smallest one whose kept planes carry at least ``coverage`` of the
    layer's total *magnitude mass* (set-bit count of each occupied
    (plane, tile) pair weighted by its splice value ``2^(Nq-1-q)``, the
    exact quantity the truncation deletes) **and** that strictly reduces
    the streamed plane-entry count.  Returns 0 — draft at full precision —
    when no depth does both, e.g. uniformly deep dense layers, where a
    truncated draft would mispredict without saving bytes.

    The 0.90 default is empirical: squeeze packs pruned layers into a
    handful of occupied planes whose last one or two still hold 5-10% of
    the mass, so a tight bar (0.95+) degenerates to "no useful depth"
    exactly on the layers speculation targets; at 0.90 the dropped tail
    stays small enough that greedy drafts overwhelmingly match the
    full-precision verify pass (gated >= 0.5 acceptance in
    ``benchmarks/spec_decode_bench.py``).
    """
    occp = smew.plane_occupancy()                       # [Nq, nr, nc]
    if not occp.any():
        return 0
    nq = smew.n_bits
    mass = np.stack([
        ((smew.tiled_codes >> (nq - 1 - q)) & 1).sum(axis=(-1, -2))
        * 2.0 ** (nq - 1 - q)
        for q in range(nq)])                            # [Nq, nr, nc]
    total_mass = float(mass.sum())
    if total_mass <= 0.0:
        return 0
    rank = np.cumsum(occp, axis=0) - occp      # occupied planes before q
    sizes = occp.sum(axis=0)                   # group depth per tile
    total_entries = int(sizes.sum())
    for k in range(1, int(sizes.max()) + 1):
        if int(np.minimum(sizes, k).sum()) >= total_entries:
            return 0                           # k covers every group: no
            #                                    byte saving at any depth
        if float(mass[rank < k].sum()) / total_mass >= coverage:
            return k
    return 0


def _evaluate_trial(w2d: np.ndarray, n_bits: int, window: int, squeeze: int,
                    tile, backend: Optional[str], reorder_gain: int = 0,
                    squeeze_max: int = 0, plane_reorder_gain: int = 0,
                    autotune=None) -> Candidate:
    from ..core.sme import sme_compress
    smew = sme_compress(w2d, n_bits=n_bits, window=window, squeeze=squeeze,
                        tile=tile, squeeze_max=squeeze_max or None)
    # relative Frobenius dequant error: an accuracy proxy on the same scale
    # across layers regardless of their magnitude
    err = float(np.linalg.norm(smew.dequant() - w2d)
                / max(np.linalg.norm(w2d), 1e-12))
    be = _pick_backend(backend, n_bits, window, squeeze, smew=smew,
                       shape=w2d.shape, autotune=autotune)
    return Candidate(
        n_bits=n_bits, window=window, squeeze=squeeze, error=err,
        bytes_per_weight=_storage_bytes_per_weight(smew, be),
        crossbars=smew.crossbars_used(), backend=be,
        tiles=int(smew.occupancy.sum()), reorder_gain=reorder_gain,
        squeeze_max=squeeze_max, plane_tiles=smew.plane_tiles_used(),
        plane_reorder_gain=plane_reorder_gain,
        # only plane-CSC can truncate a dispatch; measured occupancy is
        # exactly what prices the draft depth (trial mode only)
        draft_planes=draft_depth_from_occupancy(smew) if be == "v3" else 0)


def _evaluate_analytic(shape, n_bits: int, window: int, squeeze: int,
                       tile, backend: Optional[str], squeeze_max: int = 0,
                       autotune=None) -> Candidate:
    """Shape-only evaluation (dry-run / abstract trees): occupancy unknown,
    assume all live planes occupied — a pessimistic crossbar count and an
    exact byte count for the dense-tile worst case.  The all-planes-dense
    assumption means v3 never wins analytically; plane-CSC pricing needs
    the trial measure (or a measured autotune entry)."""
    k, n = shape
    nr, nc = -(-k // tile[0]), -(-n // tile[1])
    live = n_bits - squeeze
    be = _pick_backend(backend, n_bits, window, squeeze, shape=shape,
                       autotune=autotune)
    tiles = nr * nc
    if be == "v2":
        bits = (tiles * tile[0] * tile[1] * 6 + tiles * (tile[0] * 8 + 32)) \
            / (k * n)
    elif be == "v1":
        bits = (tiles * tile[0] * tile[1] * 8 + tiles * (tile[0] * 8 + 32)
                + k * n) / (k * n)
    else:
        bits = (tiles * tile[0] * tile[1] * live + tiles * (tile[0] * 8 + 32)
                + k * n) / (k * n)
    return Candidate(
        n_bits=n_bits, window=window, squeeze=squeeze,
        error=candidate_error_bound(n_bits, window, squeeze),
        bytes_per_weight=bits / 8, crossbars=tiles * live, backend=be,
        tiles=tiles, squeeze_max=squeeze_max,
        plane_tiles=tiles * live)


def _candidate_cost(c: Candidate, n_weights: int, objective: str,
                    shape=None, autotune=None) -> float:
    """Scalar cost the greedy minimizes, via the hardware models.

    Under ``objective="bytes"`` the analytic price is HBM traffic per
    decoded token over the card's HBM bandwidth — seconds/token.  When an
    autotune cache holds a *measured* decode entry for this candidate's
    (backend, shape), the measured seconds/token replaces the analytic
    price (same unit, observed instead of modeled).  Measured prices are
    per (backend, shape): candidates sharing a backend tie, and ties
    never upgrade — the cache steers the backend/block-size choice while
    the analytic model keeps ordering squeeze depths within one backend.
    """
    if objective == "energy":
        from ..hardware.reram_model import (LayerMapping, ReRAMConfig,
                                            energy_nj)
        m = LayerMapping(name="", crossbars=max(c.crossbars, 1),
                         input_bits=c.n_bits + c.squeeze, activations=1)
        return energy_nj(ReRAMConfig(), [m])
    if autotune is not None and shape is not None and c.backend:
        tps = autotune.measured_tokens_per_s(c.backend, 1, shape[0], shape[1])
        if tps:
            return 1.0 / tps
    # "bytes": HBM traffic per decoded token -> seconds on the card's
    # roofline (a constant divisor: the greedy's order is the reference's)
    from ..hardware.gpu_model import H100
    return c.bytes_per_weight * n_weights / H100.hbm_bw


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------
def _default_eligible(path_names, leaf) -> bool:
    from ..core.integrate import _eligible
    return _eligible(path_names, leaf)


def _collect_layers(params, predicate):
    """[(path_key, leaf)] of eligible weight leaves (numpy arrays, or any
    object with a ``shape`` for the analytic measure)."""
    found = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                walk(sub, path + [key])
            return
        if isinstance(tree, (list, tuple)):
            for i, sub in enumerate(tree):
                walk(sub, path + [str(i)])
            return
        if hasattr(tree, "shape") and predicate(path, tree):
            found.append(("/".join(path), tree))

    walk(params, [])
    return found


def plan_model(params, error_budget: float = 0.05,
               candidates: Sequence[Tuple[int, int, int]] = DEFAULT_CANDIDATES,
               tile: Tuple[int, int] = (128, 128), measure: str = "trial",
               predicate=None, backend: Optional[str] = "auto",
               reorder: bool = True, objective: str = "bytes",
               autotune=None) -> CompilePlan:
    """Search per-layer settings under a global accuracy budget.

    ``error_budget`` caps the weight-count-weighted mean per-layer error
    (measured relative Frobenius dequant error in ``measure="trial"``,
    analytic bound in ``measure="analytic"``).  Every layer starts at its
    most accurate candidate unconditionally — the budget gates *upgrades*
    (cheaper, lossier settings), so a budget below the floor of the
    candidate grid degrades gracefully to the most accurate plan instead
    of refusing to compress.  Candidates are ``(n_bits, window, squeeze)``
    3-tuples or ``(..., squeeze_max)`` 4-tuples (per-tile free-deepening:
    identical error, different plane-CSC bytes).  ``backend="auto"``
    records the operand set each chosen setting serves through, priced by
    *measured* bytes in trial mode — v3 (plane-CSC) wherever per-plane
    occupancy undercuts the tile-CSC formats, else v2 when minifloat-6
    eligible, else v1; ``reorder=True`` marks 2-D layers whose trial
    permutation strictly frees occupied units, clustered at the chosen
    backend's skip granularity (``reorder_level``: codeword tiles, or
    bit-planes for v3).  Returns a :class:`CompilePlan`.

    Stacked weights (MoE ``[E, D, F]``) are trial-measured on slice 0
    only — one setting per leaf keeps the operand arrays rectangular,
    and expert slices share an init/training distribution, but a leaf
    whose slice 0 is atypically compressible can understate the leaf's
    true error; tighten ``error_budget`` if experts are known to diverge.

    ``autotune`` (an :class:`repro_torch.hardware.autotune.AutotuneCache`, or
    the process-wide active cache when ``None``) supplies *measured*
    decode throughput: candidates whose (backend, shape) was swept price
    by observed seconds/token instead of the analytic byte model, and the
    chosen layer records the best-measured ``bm`` so serving dispatches
    with it (DESIGN.md §8).
    """
    if measure not in ("trial", "analytic"):
        raise ValueError(f"measure must be 'trial'|'analytic', got {measure!r}")
    if autotune is None:
        from ..hardware.autotune import get_cache
        autotune = get_cache()
    predicate = predicate or _default_eligible
    from ..core.mapping import conventional_crossbar_total

    leaves = _collect_layers(params, predicate)
    per_layer: Dict[str, List[Candidate]] = {}
    meta: Dict[str, Tuple[Tuple[int, int], int]] = {}
    for key, leaf in leaves:
        shape2d = tuple(int(s) for s in leaf.shape[-2:])
        n_slices = int(np.prod(leaf.shape[:-2], dtype=np.int64)) \
            if len(leaf.shape) > 2 else 1
        stacked = n_slices > 1
        w = np.asarray(leaf, np.float64).reshape((-1,) + shape2d)[0] \
            if measure == "trial" else None
        gains = {}            # reorder gain depends only on (n_bits, window)
        pgains = {}           # plane-level gain, same key
        cands = []
        for cand in candidates:
            nb, win, sq, sq_max = _norm_candidate(cand)
            if measure == "trial":
                if reorder and not stacked and (nb, win) not in gains:
                    from .reorder import (permutation_gain,
                                          plane_permutation_gain)
                    from ..core.quant import quantize
                    q = quantize(w, method="sme", n_bits=nb, window=win)
                    before, after = permutation_gain(q.codes, tile=tile)
                    gains[nb, win] = before - after
                    pb, pa = plane_permutation_gain(q.codes, n_bits=nb,
                                                    tile=tile)
                    pgains[nb, win] = pb - pa
                c = _evaluate_trial(w, nb, win, sq, tile, backend,
                                    reorder_gain=gains.get((nb, win), 0),
                                    squeeze_max=sq_max,
                                    plane_reorder_gain=pgains.get(
                                        (nb, win), 0),
                                    autotune=autotune)
            else:
                c = _evaluate_analytic(shape2d, nb, win, sq, tile, backend,
                                       squeeze_max=sq_max, autotune=autotune)
            cands.append(c)
        # error/bytes frontier: drop candidates dominated on both axes
        cands.sort(key=lambda c: (c.error, c.bytes_per_weight))
        frontier: List[Candidate] = []
        for c in cands:
            if not frontier or c.bytes_per_weight < \
                    frontier[-1].bytes_per_weight - 1e-12:
                frontier.append(c)
        per_layer[key] = frontier
        meta[key] = (shape2d, n_slices)

    # greedy allocation over the frontier
    choice = {key: 0 for key in per_layer}          # start: most accurate
    total_w = sum(meta[k][0][0] * meta[k][0][1] * meta[k][1] for k in per_layer)

    def werr() -> float:
        if not total_w:
            return 0.0
        return sum(per_layer[k][choice[k]].error
                   * meta[k][0][0] * meta[k][0][1] * meta[k][1]
                   for k in per_layer) / total_w

    blocked = set()                # (key, j) upgrades that bust the budget
    while True:
        best = None
        for key, frontier in per_layer.items():
            i = choice[key]
            nw = meta[key][0][0] * meta[key][0][1] * meta[key][1]
            cur_cost = _candidate_cost(frontier[i], nw, objective,
                                       shape=meta[key][0], autotune=autotune)
            # scan the whole remaining frontier, not just i+1: under the
            # "energy" objective cost is not monotone along the
            # bytes-sorted frontier, so a cheaper candidate may sit past
            # a more expensive one
            for j in range(i + 1, len(frontier)):
                if (key, j) in blocked:
                    continue
                nxt = frontier[j]
                d_cost = cur_cost - _candidate_cost(
                    nxt, nw, objective, shape=meta[key][0], autotune=autotune)
                if d_cost <= 0:
                    continue
                d_err = max((nxt.error - frontier[i].error) * nw
                            / max(total_w, 1), 1e-18)
                gain = d_cost / d_err
                if best is None or gain > best[0]:
                    best = (gain, key, j)
        if best is None:
            break
        _, key, j = best
        prev = choice[key]
        choice[key] = j
        if werr() > error_budget:
            # undo; total error only grows, so this jump never fits later
            choice[key] = prev
            blocked.add((key, j))

    layers: Dict[str, LayerPlan] = {}
    for key, frontier in per_layer.items():
        c = frontier[choice[key]]
        shape2d, n_slices = meta[key]
        nr, nc = -(-shape2d[0] // tile[0]), -(-shape2d[1] // tile[1])
        # a layer serving through plane-CSC reorders on the plane-level
        # signature (its skip unit); tile-CSC layers on the codeword one
        if c.backend == "v3":
            level, gain = "plane", c.plane_reorder_gain
        else:
            level, gain = "tile", c.reorder_gain
        bm = 0
        if autotune is not None and c.backend:
            hit = autotune.best(c.backend, 1, shape2d[0], shape2d[1])
            if hit is not None:
                bm = hit[0]
        layers[key] = LayerPlan(
            path=key, shape=shape2d, n_slices=n_slices,
            n_bits=c.n_bits, window=c.window, squeeze=c.squeeze,
            backend=c.backend, reorder=bool(gain > 0),
            error_bound=c.error, bytes_per_weight=c.bytes_per_weight,
            crossbars=c.crossbars,
            crossbars_dense=conventional_crossbar_total(shape2d, c.n_bits,
                                                        tile=tile),
            occupied_tiles=c.tiles,
            # only the permutation that actually ships may claim its gain:
            # tile-level stats for tile-level reorders; a plane-level
            # permutation's codeword-tile effect is unmeasured, so v3
            # layers keep the as-laid-out tile count and report their
            # gain in occupied_plane_tiles instead
            occupied_tiles_reordered=c.tiles - (
                max(c.reorder_gain, 0) if level == "tile" and gain > 0
                else 0),
            total_tiles=nr * nc,
            squeeze_max=c.squeeze_max,
            reorder_level=level,
            occupied_plane_tiles=c.plane_tiles
            - (max(c.plane_reorder_gain, 0) if (level == "plane"
                                                and gain > 0) else 0),
            bm=bm,
            draft_planes=c.draft_planes if c.backend == "v3" else 0,
        )
    return CompilePlan(layers=layers, tile=tile, error_budget=error_budget,
                       objective=objective)
