"""Sharding rules: map param/cache/batch trees -> partition specs, and
place a param tree's shards on this rank.

Checked against ``repro/parallel/sharding.py``.  A spec is a tuple with
one entry per dim: None, an axis name, or a tuple of axis names (the
port's ``PartitionSpec``, normalized as jax normalizes one: a one-axis
tuple is the axis name).  ``_param_spec`` and ``_cache_spec`` are the
reference's rules as pure functions of (mesh shape, '/'-joined path,
shape, ...), both postures included, ``EXACT_MIN_SHARD`` and the rule that
an axis which does not divide its dim is dropped; a mesh is anything with
``shape`` ({axis: size}) and ``axis_names``.  The rules read the
reference's leaf paths and shapes (its layout: layers stacked per
superblock slot, ``blocks/slot{j}/...``), so ``param_sharding`` and
``cache_sharding`` of a port tree give each per-layer leaf the reference
spec of its stacked leaf without the stacked dim.

Axes:
  * ``pod``   — data parallelism across pods;
  * ``data``  — data parallelism + FSDP (ZeRO-3 weight sharding) + SP;
  * ``model`` — tensor/expert parallelism (heads, d_ff, experts, vocab).

Two numerics postures share these rules (DESIGN.md §7):

  * **throughput** (default, for training): FSDP shards contraction dims,
    decode caches sequence-shard over 'model';
  * **exact** (``exact=True``, the serving engine): only output-feature /
    head / channel / batch dims are ever sharded, so no float reduction
    crosses a rank and any mesh shape is bit-identical to the 1x1 mesh.
    A shard owns whole output features, so the splice of an output
    column's bit-slice partial products never crosses shards.

:func:`place_tree` puts this rank's shard of every leaf on its device
under the exact posture, slicing host (numpy or memory-mapped) leaves
straight into the shard: no rank holds a replicated copy of a sharded
leaf on the card.  It decides per weight, not per leaf (ROADMAP R10): a
packed weight splits into whole output-column tiles where its operands'
column-tile axis ``nc`` shards, and every per-column leaf of it (codes,
row exponents, sign bytes, scale, the linear's bias) is cut to the same
tiles; a dense weight splits where its spec splits its output dim (the
experts of an expert-parallel stack, the embedding's vocab rows) and its
bias follows it.  Every other leaf (norm weights, the router, row
permutations, meta) stays replicated: the model reads them whole.  Each
split leaf carries its :class:`Split`, which ``parallel.policy`` reads
to gather the product.

:func:`place_throughput` is its counterpart for training under the
throughput posture: every dense leaf is cut by its whole throughput spec
(``_param_spec(fsdp=True, exact=False)``, a layer's leaf asked as its
stacked leaf's, as :func:`param_sharding` asks it) over both axes, FSDP
over 'data' included: q/k/v/wi/wg ``[d, "model"]``, o/wo row-parallel
``["model", d]``, the tied embedding ``["model", d]``, biases
``["model"]``, a layer's norm weights ``["model"]`` (the stacked rule's
``[d, "model"]`` without its layer dim), the final norm and a leading
dense layer's norms whole, expert stacks expert-parallel (wi/wg
``["model", d, None]``, wo ``["model", None, d]``) where the experts
divide 'model', else expert-TP (``[None, d, "model"]``, wo ``[None,
"model", d]``), the router whole.  Each shard carries its :class:`Cut`
(the leaf's whole shape and spec).  A leaf's spec is read from its path
in its param tree, so a tree that holds param trees (a checkpoint's
``{"params", "opt": {"m", "v"}}``) places each leaf as its param's.
:func:`gather_throughput` joins such shards back into whole leaves;
:func:`local_rows` is this rank's rows of a global batch under
:func:`batch_sharding`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map

__all__ = ["param_sharding", "cache_sharding", "batch_sharding",
           "dp_axes", "axis_size", "tree_shardings", "replicated",
           "leaf_sharding", "place_tree", "Split", "split_of",
           "shard_shape", "state_spec", "EXACT_MIN_SHARD", "Cut",
           "cut_of", "throughput_shard", "place_throughput",
           "gather_shard", "gather_throughput", "carry_cuts",
           "local_rows"]


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


#: exact-posture shard floor: never split a dim into shards smaller than
#: this many elements (the reference's XLA:CPU vector-width reason); the
#: port keeps it so its specs stay the reference's
EXACT_MIN_SHARD = 64


def _fits(dim: int, mesh, axes, min_shard: int = 1) -> bool:
    if axes is None:
        return True
    if isinstance(axes, str):
        axes = (axes,)
    n = int(np.prod([axis_size(mesh, a) for a in axes]))
    if n > 1 and dim // n < min_shard:
        return False
    return dim % n == 0


def _norm(ax):
    """An axis entry as jax's PartitionSpec holds it."""
    if isinstance(ax, (tuple, list)):
        ax = tuple(ax)
        return ax[0] if len(ax) == 1 else (ax or None)
    return ax


def P(*axes) -> tuple:
    return tuple(_norm(a) for a in axes)


def _spec(mesh, shape, *axes, min_shard_last: int = 1) -> tuple:
    """A spec, dropping axes that don't divide the dim; ``min_shard_last``
    additionally drops a split of the LAST dim below that many elements."""
    clean = []
    last = len(shape) - 1
    for i, (dim, ax) in enumerate(zip(shape, axes)):
        ms = min_shard_last if i == last else 1
        clean.append(ax if (ax and _fits(dim, mesh, ax, ms)) else None)
    return P(*clean)


# ---------------------------------------------------------------- params

#: kernel-operand base ranks (no stacked lead dims); the leading operand
#: dim is always the output-column-tile axis ``nc`` (CSC-of-tiles layout)
_SME_OPERAND_RANK = {"codes": 4, "sign": 4, "packed": 4,
                     "rowscale": 3, "rowid": 2, "nnz": 1}

#: v3 (plane-CSC) operands: (base rank, spec axes); the dense
#: ``sign``/``rowscale`` side arrays are [nr, nc, ...]: their ``nc`` is
#: axis 1
_SME_V3_OPERAND_SPEC = {
    "planes":   (4, ("model", None, None, None)),   # [nc, L, tr//8, tc]
    "shift":    (2, ("model", None)),               # [nc, L]
    "last":     (2, ("model", None)),               # [nc, L]
    "rowid":    (2, ("model", None)),               # [nc, L]
    "nnz":      (1, ("model",)),                    # [nc]
    "sign":     (4, (None, "model", None, None)),   # [nr, nc, tr//8, tc]
    "rowscale": (3, (None, "model", None)),         # [nr, nc, tr]
}


def _param_spec(mesh, path: str, shape, fsdp: bool,
                exact: bool = False) -> tuple:
    nd = len(shape)
    d = "data" if fsdp else None
    ms = EXACT_MIN_SHARD if exact else 1

    def pad(spec_axes):
        """prepend Nones for stacked superblock leading dims."""
        extra = nd - len(spec_axes)
        return _spec(mesh, shape, *([None] * extra + list(spec_axes)),
                     min_shard_last=ms)

    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    # SME packed leaves: the only 'model'-sharded dims are output-feature
    # dims; row / contraction dims at most FSDP-shard over 'data'
    if name == "sme_codes":                 # [..., nr, nc, tr, tc]
        return pad([None, d, None, "model"])
    if name == "sme_rowexp":                # [..., nr, nc, tr]
        return pad([None, d, None])
    if name == "sme_sign":                  # [..., K, ceil(N/8)]
        return pad([d, "model"])
    if name == "sme_scale":                 # [..., 1, N]
        return pad([None, "model"])
    if name == "sme_perm":                  # [..., K] row permutation
        return P(*([None] * nd))
    if name == "sme_tilesq":                # [..., nr, nc] per-tile depths
        return P(*([None] * nd))
    if name.startswith("sme_v3_"):
        op = name.split("_", 2)[2]
        entry = _SME_V3_OPERAND_SPEC.get(op)
        if entry is None or nd < entry[0]:
            return P(*([None] * nd))
        return pad(list(entry[1]))
    if name.startswith("sme_v1_") or name.startswith("sme_v2_"):
        op = name.split("_", 2)[2]
        base = _SME_OPERAND_RANK.get(op)
        if base is None or nd < base:
            return P(*([None] * nd))
        return pad(["model"] + [None] * (base - 1))
    if "embed" in path:
        return pad(["model", d])
    if "lm_head" in path or "patch_proj" in path:
        return pad([d, "model"])
    if parent in ("router",):
        return pad([None, None])
    # MoE experts [E, D, F] / [E, F, D]: expert-parallel when E divides,
    # else expert-TP over the feature dim
    if name in ("wi", "wg") and nd >= 3 and "shared" not in path:
        e = shape[-3]
        if e % axis_size(mesh, "model") == 0:
            return pad(["model", d, None])
        return pad([None, d, "model"])
    if name == "wo" and nd >= 3 and "shared" not in path:
        e = shape[-3]
        if e % axis_size(mesh, "model") == 0:
            return pad(["model", None, d])
        if exact:                                      # D = output features
            return pad([None, None, "model"])
        return pad([None, "model", d])
    # attention / mlp 2-D mats
    if name == "w" or name in ("wi", "wg", "wo"):
        if parent in ("o", "wo", "out_proj", "down", "dt_w", "ff_wo") or name == "wo":
            # throughput: row-parallel (a partial-sum all-reduce); exact:
            # column-parallel like every other weight
            return pad([None, "model"]) if exact else pad(["model", d])
        if parent in ("x_proj",):
            return pad([None, "model"]) if exact else pad(["model", None])
        if nd >= 2:
            return pad([d, "model"])
    if name == "b" and parent in ("q", "k", "v", "o", "wi", "wo", "up", "wx"):
        return pad(["model"])
    if name in ("A_log",):
        return pad(["model", None])
    if name in ("conv_w",):
        return pad([None, "model"])
    if name in ("conv_b", "dt_bias", "D", "norm_w"):
        return pad(["model"])
    if parent in ("ig", "fg"):
        if exact:                                      # NH = output features
            return pad([None, "model"]) if nd >= 2 else pad([None])
        return pad(["model", None]) if nd >= 2 else pad([None])
    if name in ("q", "k", "v") and nd >= 3:            # mlstm block-diag [NH,dh,dh]
        return pad([None] * nd) if exact else pad([None, None, "model"])
    if name == "r":                                    # slstm recurrence
        return pad([None] * nd)
    return P(*([None] * nd))                           # norms & misc: replicate


def _walk(tree, fn, path=()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _stacked(path: Tuple[str, ...]):
    """A port leaf path as the reference's, and whether the reference
    stacks it: a decoder layer ``blocks/i/...`` is a slot of a stacked
    superblock (``blocks/slot/...``), an enc-dec layer ``enc|dec/i/...``
    a slice of its stack; top-level leaves are as they are."""
    if len(path) > 1 and path[0] in ("blocks", "enc", "dec") and \
            path[1].isdigit():
        head = ("blocks", "slot") if path[0] == "blocks" else (path[0],)
        return "/".join(head + path[2:]), True
    return "/".join(path), False


def _port_spec(rule, path, shape) -> tuple:
    """The reference rule's spec of a port leaf: a stacked leaf is asked
    with a superblock dim of 1 in front, which is then dropped."""
    ref_path, stacked = _stacked(path)
    if stacked:
        return rule(ref_path, (1,) + tuple(shape))[1:]
    return rule(ref_path, tuple(shape))


def _drop_model(spec: tuple) -> tuple:
    return P(*[None if ax == "model" else
               (tuple(a for a in ax if a != "model") or None)
               if isinstance(ax, tuple) else ax for ax in spec])


def param_sharding(mesh, params, fsdp: bool = True, tp: bool = True,
                   exact: bool = False, port: bool = True):
    """Tree of specs matching a param tree (the port's per-layer layout
    with ``port``, else the reference's stacked one).

    ``tp=False`` drops the 'model' axis from every spec; ``exact=True`` is
    the serving posture (FSDP off, only output-feature dims shard)."""
    if exact:
        fsdp = False

    def one(path, leaf):
        def rule(p, shape):
            return _param_spec(mesh, p, shape, fsdp, exact=exact)
        spec = _port_spec(rule, path, leaf.shape) if port else \
            rule("/".join(path), tuple(leaf.shape))
        return spec if tp else _drop_model(spec)
    return _walk(params, one)


# ---------------------------------------------------------------- caches

def _batch_axis(mesh, batch: int) -> Any:
    dp = dp_axes(mesh)
    dpn = int(np.prod([axis_size(mesh, a) for a in dp]))
    return dp if (batch % max(dpn, 1) == 0 and dpn > 1) else (
        "data" if batch % axis_size(mesh, "data") == 0 else None)


def _cache_spec(mesh, path: str, shape, batch: int,
                exact: bool = False) -> tuple:
    nd = len(shape)
    batch_ax = _batch_axis(mesh, batch)
    # SP-decode: the sequence dim of attention caches shards over 'model'
    # (+ 'data' when batch == 1); exact never sequence-shards: attention
    # softmax-sums over the sequence, so heads/channels shard instead
    sp: Any = None if exact else (
        ("model",) if batch_ax is not None else (
            ("data", "model") if batch == 1 else ("model",)))
    name = path.split("/")[-1]
    ms = EXACT_MIN_SHARD if exact else 1

    def pad(axes_from_right):
        extra = nd - len(axes_from_right)
        return _spec(mesh, shape, *([None] * extra + list(axes_from_right)),
                     min_shard_last=ms)

    if name in ("k", "v") and nd >= 4:                  # [..., B, S|W, KV, hd]
        return pad([batch_ax, sp, "model" if exact else None, None])
    if name in ("c", "k_pe"):                           # MLA [..., B, S, lora]
        return pad([batch_ax, sp, None])
    if name == "conv":                                  # mamba [..., B, k-1, d_in]
        return pad([batch_ax, None, "model"])
    if name == "h":                                     # mamba [..., B, d_in, n]
        return pad([batch_ax, "model", None])
    # tuple states (mlstm C/n/m, slstm c/n/h/m) — shape-based
    if nd >= 4 and shape[-1] == shape[-2]:              # mlstm C [..,B,NH,dh,dv]
        dh_ax = ("data" if batch_ax is None and not exact
                 else None)
        return pad([batch_ax, None, dh_ax, "model"])
    if nd >= 3:                                         # mlstm n [..,B,NH,dh]
        return pad([batch_ax, "model", None] if exact
                   else [batch_ax, None, "model"])
    if nd == 2:                                         # slstm [B, D] or m [B,NH]
        return pad([batch_ax, None] if exact else [batch_ax, "model"])
    return P(*([None] * nd))


#: the port's named recurrent states: a layer's leaf names -> its kind
_STATE_KINDS = {frozenset(("conv", "h")): "mamba",
               frozenset(("C", "n", "m")): "mlstm",
               frozenset(("c", "n", "h", "m")): "slstm"}
#: the states whose channel or head split is the reference rule's
_SPLIT_STATES = {("mamba", "conv"), ("mamba", "h"), ("mlstm", "C"),
                 ("mlstm", "n")}


def state_spec(mesh, kind: str, name: str, shape, batch: int,
               exact: bool = False) -> tuple:
    """The spec of one recurrent state leaf of a port layer (slot rows on
    dim 0), keyed on the layer's kind: Mamba's ``conv`` (d_in) and ``h``
    (d_in), mLSTM's ``C`` (dv) and ``n`` (heads) take the reference's
    stacked spec without the superblock dim; mLSTM's ``m`` and sLSTM's
    ``c``/``n``/``h``/``m`` are whole apart from their slot rows (ROADMAP
    R11: the reference's rule reads a stacked [L, B, NH] or [L, B, D]
    state as unstacked, so it puts the superblock dim over 'data' and the
    slot rows over 'model', and sLSTM's ``c`` and ``h`` take MLA's and
    Mamba's rules by name)."""
    shape = tuple(shape)
    if (kind, name) in _SPLIT_STATES:
        return _cache_spec(mesh, "blocks/slot/" + name, (1,) + shape, batch,
                           exact=exact)[1:]
    return _spec(mesh, shape, _batch_axis(mesh, batch),
                 *([None] * (len(shape) - 1)))


def cache_sharding(mesh, caches, batch: int, exact: bool = False,
                   port: bool = True):
    """Tree of specs matching a cache tree (the port's list of per-layer
    dicts with ``port``, each leaf asked as a stacked superblock slot's,
    a recurrent layer's states by :func:`state_spec`; else the
    reference's tree)."""
    if not port:
        return _walk(caches, lambda path, leaf: _cache_spec(
            mesh, "/".join(path), tuple(leaf.shape), batch, exact=exact))

    def layer(cache):
        kind = _STATE_KINDS.get(frozenset(cache)) \
            if isinstance(cache, dict) else None

        def one(path, leaf):
            if kind is not None:
                return state_spec(mesh, kind, path[-1], leaf.shape, batch,
                                  exact=exact)
            return _cache_spec(mesh, "blocks/slot/" + "/".join(path),
                               (1,) + tuple(leaf.shape), batch,
                               exact=exact)[1:]
        return _walk(cache, one)
    return [layer(c) for c in caches]


# ---------------------------------------------------------------- batches

def batch_sharding(mesh, batch, include_model: bool = False):
    """Shard dim0 (global batch) over (pod, data[, model])."""
    dp = dp_axes(mesh)
    if include_model:
        full = dp + ("model",)
        fn = int(np.prod([axis_size(mesh, a) for a in full]))
    dpn = int(np.prod([axis_size(mesh, a) for a in dp]))

    def one(_, leaf):
        b = leaf.shape[0]
        ax: Any = None
        if include_model and b % fn == 0:
            ax = full
        elif b % max(dpn, 1) == 0:
            ax = dp
        elif b % axis_size(mesh, "data") == 0:
            ax = "data"
        return P(ax, *([None] * (len(leaf.shape) - 1)))
    return _walk(batch, one)


def replicated(mesh, tree):
    return _walk(tree, lambda _, leaf: P(*([None] * len(leaf.shape))))


def leaf_sharding(mesh, path: str, shape, *, fsdp: bool = False,
                  exact: bool = True) -> tuple:
    """The spec of one param leaf addressed by its '/'-joined reference
    path (a ``.smez`` manifest key)."""
    return _param_spec(mesh, path, tuple(shape), fsdp, exact=exact)


def tree_shardings(mesh, *, params=None, cache=None, batch=None,
                   batch_size: Optional[int] = None, fsdp: bool = True):
    out = {}
    if params is not None:
        out["params"] = param_sharding(mesh, params, fsdp)
    if cache is not None:
        out["cache"] = cache_sharding(mesh, cache, batch_size or 1)
    if batch is not None:
        out["batch"] = batch_sharding(mesh, batch)
    return out


def _parts(mesh, ax) -> Tuple[int, int]:
    """(this rank's index, number of shards) of a dim split over ``ax``
    (axes in order, the first major, as jax lays out a multi-axis dim)."""
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    idx, n = 0, 1
    for a in axes:
        size = axis_size(mesh, a)
        idx = idx * size + (mesh.index(a) if size > 1 else 0)
        n *= size
    return idx, n


def shard_shape(mesh, spec: tuple, shape) -> tuple:
    """The shape of one shard of a leaf of ``shape`` under ``spec``."""
    return tuple(dim if ax is None else dim // _parts(mesh, ax)[1]
                 for dim, ax in zip(shape, spec))


# ---------------------------------------------------------------- placing

@dataclasses.dataclass(frozen=True)
class Split:
    """How a placed weight is cut over the 'model' axis: along its ``dim``
    (0: the experts of a stack or the embedding's rows; 1: an expert-TP
    ``wo`` stack's F rows, under the throughput posture; -1: output
    columns), ``full`` entries in all, ``step`` per rank (the last rank
    may hold fewer: a packed weight's ragged last column tile)."""
    dim: int
    full: int
    step: int
    start: int


def split_of(w) -> Optional[Split]:
    """The :class:`Split` a placed weight (a tensor, or a packed dict's
    ``sme_scale``) carries; None for a whole one."""
    anchor = w.get("sme_scale") if isinstance(w, dict) else w
    return getattr(anchor, "mesh_split", None)


def _to(mesh, leaf, index=None, split: Optional[Split] = None):
    """``leaf[index]`` as a tensor on the mesh's device that owns its
    memory (no view keeps a whole leaf alive); a tensor already there,
    whole, passes through untouched."""
    if torch.is_tensor(leaf):
        if index is None and leaf.device == mesh.device:
            return leaf
        t = leaf if index is None else leaf[index]
        t = t.clone() if t.device == mesh.device else t.to(mesh.device)
        t = t.contiguous()
    else:
        arr = np.asarray(leaf)
        arr = np.ascontiguousarray(arr if index is None else arr[index])
        t = torch.as_tensor(arr if arr.flags.writeable else arr.copy(),
                            device=mesh.device)
    if split is not None:
        t.mesh_split = split
    return t


def _cut(nd: int, dim: int, lo: int, hi: int) -> tuple:
    idx = [slice(None)] * nd
    idx[dim] = slice(lo, hi)
    return tuple(idx)


def _model_split(mesh, spec: tuple, shape, dim: int) -> Optional[Split]:
    """A Split of ``dim`` when ``spec`` shards it over 'model' alone."""
    if spec[dim] != "model" or axis_size(mesh, "model") == 1:
        return None
    full = shape[dim]
    step = full // axis_size(mesh, "model")
    return Split(dim, full, step, mesh.index("model") * step)


#: a packed weight's leaves indexed by column tile: leaf -> the axis of
#: ``nc``, from the end
_PACKED_COLS = {"sme_codes": -3, "sme_rowexp": -2, "sme_tilesq": -1}


def _place_packed(mesh, path, p: dict):
    """A packed weight: whole output-column tiles over 'model' where its
    operands' ``nc`` shards (ROADMAP R10), every per-column leaf cut to
    those tiles; returns (placed dict, Split or None)."""
    codes = p["sme_codes"]
    lead = tuple(codes.shape[:-4])
    nc, tc = codes.shape[-3], codes.shape[-1]
    n = p["sme_scale"].shape[-1]
    nl = len(lead)
    # the payload operand's spec (its nc is not the last dim, so the
    # exact floor does not apply; the small index operands' may, R10)
    spec = _port_spec(lambda q, s: _param_spec(mesh, q, s, False, True),
                      path + ("sme_v3_planes",), lead + (nc, 1, 1, 1))
    if spec[nl] != "model" or axis_size(mesh, "model") == 1:
        return _same(p, {k: _to(mesh, v) for k, v in p.items()}), None
    per = nc // axis_size(mesh, "model")
    t0 = mesh.index("model") * per
    c0, c1 = t0 * tc, min((t0 + per) * tc, n)
    split = Split(-1, n, per * tc, c0)
    out = {}
    for k, v in p.items():
        nd = len(v.shape)
        if k in _PACKED_COLS:
            idx = _cut(nd, _PACKED_COLS[k], t0, t0 + per)
        elif k == "sme_scale":
            idx = _cut(nd, -1, c0, c1)
        elif k == "sme_sign":
            idx = _cut(nd, -1, c0 // 8, -(-c1 // 8))
        elif k.startswith(("sme_v1_", "sme_v2_")):
            idx = _cut(nd, nl, t0, t0 + per)
        elif k.startswith("sme_v3_"):
            axis = nl + 1 if k in ("sme_v3_sign", "sme_v3_rowscale") else nl
            idx = _cut(nd, axis, t0, t0 + per)
        else:                       # sme_perm, meta, draft depths
            idx = None
        out[k] = _to(mesh, v, idx, split if k == "sme_scale" else None)
    return out, split


def _same(old, new):
    """``old`` itself where every child came back untouched (a placed
    tree passes through as it is), else ``new``."""
    pairs = zip(old.values(), new.values()) if isinstance(old, dict) \
        else zip(old, new)
    return old if all(a is b for a, b in pairs) else new


def place_tree(tree, mesh):
    """This rank's shard of every leaf of a port param tree on the mesh's
    device, under the exact posture (see the module note); on the 1x1
    mesh every leaf whole, and a tree already on the device untouched (the
same objects)."""
    def rule(q, s):
        return _param_spec(mesh, q, s, False, exact=True)

    def dense(path, w):
        """A dense leaf: a linear's matrix splits its output columns, an
        expert stack its experts (or columns), the embedding its vocab
        rows, where the spec shards them over 'model'; any other leaf
        stays whole (the model reads it whole)."""
        name, nd = path[-1], len(w.shape)
        stack = name in ("wi", "wg", "wo") and nd >= 3
        if axis_size(mesh, "model") == 1 or not (
                stack or (name == "w" and nd == 2)):
            return _to(mesh, w), None
        spec = _port_spec(rule, path, w.shape)
        dim = 0 if "embed" in path or (stack and spec[0] == "model") else -1
        split = _model_split(mesh, spec, w.shape, dim)
        if split is None:
            return _to(mesh, w), None
        idx = _cut(nd, dim, split.start, split.start + split.step)
        return _to(mesh, w, idx, split), split

    def weight(path, w):
        if isinstance(w, dict) and "sme_codes" in w:
            return _place_packed(mesh, path, w)
        if isinstance(w, dict) or isinstance(w, (list, tuple)):
            return walk(w, path), None
        return dense(path, w)

    def walk(t, path):
        if isinstance(t, (list, tuple)):
            return _same(t, type(t)(walk(v, path + (str(i),))
                                    for i, v in enumerate(t)))
        if not isinstance(t, dict):
            return weight(path, t)[0]
        if "sme_codes" in t:
            return _place_packed(mesh, path, t)[0]
        placed = {k: weight(path + (k,), v) for k, v in t.items()
                  if not (k == "b" and "w" in t)}
        split = placed["w"][1] if "w" in placed else None
        out = {}
        for k, v in t.items():
            if k in placed:
                out[k] = placed[k][0]
            elif split is None:
                out[k] = _to(mesh, v)
            else:
                # the bias follows its weight's output columns
                out[k] = _to(mesh, v, _cut(len(v.shape), -1, split.start,
                                           min(split.start + split.step,
                                               split.full)))
        return _same(t, out)

    return walk(tree, ())


# ------------------------------------------------- the throughput posture

@dataclasses.dataclass(frozen=True)
class Cut:
    """How a leaf placed by :func:`place_throughput` is cut: its whole
    ``shape`` and its throughput ``spec`` (None, "data" or "model" per
    dim) on ``mesh``."""
    shape: Tuple[int, ...]
    spec: tuple
    mesh: Any = dataclasses.field(compare=False, repr=False)

    def dim(self, axis: str) -> Optional[int]:
        """The dim split over ``axis`` (None when no dim is, or the axis
        has one rank)."""
        if axis_size(self.mesh, axis) == 1 or axis not in self.spec:
            return None
        return self.spec.index(axis)

    def counted(self) -> bool:
        """Whether this rank's part counts in a sum over every rank's
        parts: on each axis the leaf is not split over, only the rank at
        coordinate 0 counts (a replicated part is counted once)."""
        return all(self.dim(a) is not None or axis_size(self.mesh, a) == 1
                   or self.mesh.index(a) == 0 for a in ("data", "model"))


def cut_of(t) -> Optional[Cut]:
    """The :class:`Cut` a throughput shard carries; None for any other
    tensor."""
    return getattr(t, "mesh_cut", None)


#: the top-level keys of a port param tree (``first{i}`` besides)
_TOP_KEYS = ("embed", "final_norm", "lm_head", "patch_proj", "blocks",
             "enc", "dec", "enc_norm", "dec_norm")


def _tree_path(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """A leaf's path from its param tree's root: a prefix naming the tree
    (a checkpoint's ``params`` or ``opt/m``) dropped, up to the first
    top-level key of a param tree."""
    for i, k in enumerate(path):
        if k in _TOP_KEYS or re.fullmatch(r"first\d+", k):
            return path[i:]
    return path


def _throughput_spec(mesh, path, shape) -> tuple:
    spec = _port_spec(lambda q, s: _param_spec(mesh, q, s, True,
                                               exact=False),
                      _tree_path(tuple(path)), shape)
    for ax in spec:
        if ax not in (None, "data", "model"):
            raise ValueError(f"{'/'.join(path)}: spec {spec} splits a dim "
                             f"over several axes")
    return spec


def throughput_shard(mesh, path, leaf) -> torch.Tensor:
    """This rank's shard of one dense ``leaf`` (a tensor or a host array)
    at ``path`` (its keys, from the root of a param tree or of a tree
    holding param trees: a checkpoint's ``params``, ``opt/m``...) on the
    mesh's device, cut by its throughput spec, carrying its
    :class:`Cut`."""
    shape = tuple(leaf.shape)
    spec = _throughput_spec(mesh, path, shape)
    idx = []
    for dim, ax in zip(shape, spec):
        i, n = _parts(mesh, ax) if ax else (0, 1)
        idx.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
    t = _to(mesh, leaf, tuple(idx))
    t.mesh_cut = Cut(shape, spec, mesh)
    return t


def place_throughput(tree, mesh):
    """This rank's shard of every leaf of a dense port param tree (or of
    an optimizer state tree shaped like one, or of a tree holding such
    trees) on the mesh's device, cut by its throughput spec over 'data'
    and 'model' (:func:`throughput_shard`); each shard carries its
    :class:`Cut`.  A packed weight is refused: training takes dense
    weights."""
    def one(path, leaf):
        if isinstance(leaf, dict) and "sme_codes" in leaf:
            raise ValueError(f"{'/'.join(path)} is SME-packed: the "
                             f"throughput posture places dense weights")
        if isinstance(leaf, dict):
            return {k: one(path + (str(k),), v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(one(path + (str(i),), v)
                              for i, v in enumerate(leaf))
        return throughput_shard(mesh, path, leaf)
    return one((), tree)


def gather_shard(t, mesh) -> torch.Tensor:
    """The whole leaf of throughput shard ``t`` (carrying its
    :class:`Cut`), every rank's part joined over 'model' and then over
    'data': a collective on every rank of ``mesh``."""
    cut = cut_of(t)
    if cut is None:
        raise ValueError("a leaf carries no Cut: place the tree with "
                         "place_throughput")
    t = t.detach()              # a whole leaf carries no Cut
    for axis in ("model", "data"):
        d = cut.dim(axis)
        if d is not None:
            t = mesh.gather(t, axis, d)
    return t


def gather_throughput(tree, mesh):
    """The whole leaves of a tree of throughput shards (each carrying its
    :class:`Cut`: placed, or returned by a mesh step), in leaf order
    (:func:`gather_shard`)."""
    return tree_map(lambda t: gather_shard(t, mesh), tree)


def carry_cuts(tree, like):
    """``tree`` with each leaf carrying the :class:`Cut` of the leaf at
    the same place in ``like`` (a step's new params or optimizer state
    from its inputs); returns ``tree``."""
    for t, src in zip(tree_leaves(tree), tree_leaves(like)):
        cut = cut_of(src)
        if cut is not None:
            t.mesh_cut = cut
    return tree


def local_rows(mesh, batch):
    """This rank's rows of every leaf of a global ``batch`` (dim 0 split
    as :func:`batch_sharding` splits it; all rows where it is not)."""
    specs = batch_sharding(mesh, batch)
    out = {}
    for k, leaf in batch.items():
        ax = specs[k][0]
        if ax is None:
            out[k] = leaf
            continue
        i, n = _parts(mesh, ax)
        rows = leaf.shape[0] // n
        out[k] = leaf[i * rows:(i + 1) * rows]
    return out
