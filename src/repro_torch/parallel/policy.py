"""Activation-sharding policy, and the one place a collective runs in the
model: :func:`constrain`.

Checked against ``repro/parallel/policy.py``: ``ShardPolicy``,
``policy_for``, ``use_policy`` and ``current_policy`` are the
reference's, and the model calls :func:`constrain` at the reference's
sites.  In the reference ``constrain`` pins a layout for GSPMD; here it
does the work GSPMD would: the port's activations are replicated on every
rank at every op boundary, so

  * ``"lhs"`` and ``"act"`` need nothing (the left operand of a matmul is
    always whole: no contraction is ever split across ranks);
  * ``"features"`` gathers a column-split weight's product over 'model'
    (the weight's :class:`~repro_torch.parallel.sharding.Split` says how it
    was cut; a whole weight gathers nothing); ``"experts"`` gathers an
    expert-parallel stack's outputs on the expert dim;
  * ``"kv"`` takes this rank's KV heads of a K or V [B, S, KV, hd], the
    ones its cache shard holds (KV heads split over 'model' where their
    count divides it, as the cache rule splits them; whole GQA groups),
    and ``"block"`` gathers an output computed in the 1x1 shape
    (:func:`whole_state`) whose valid part is the block of a shard of
    shape ``part``: slot rows (dim 0) over 'data', a channel or head dim
    over 'model' (an attention output's heads, MLA's rows, a recurrent
    layer's rows and channels).

:func:`whole_state` gives a cache or state shard the whole leaf's shape,
zero where other ranks hold it, and :func:`state_part` cuts a state
computed in that shape back to this rank's shard; :func:`state_shape` is
the shard shape of a recurrent state the engine keeps (the cache rule's
split, slot rows left whole).  :func:`whole_weight` gives a
column-split weight's whole matrix, gathered once per weight (MLA's
absorbed ``kv_up``).  :func:`embed_rows` looks tokens up in a
vocab-split embedding: each rank reads the rows it owns, and the owner's
row is **selected** from the gathered parts, never summed.  Every
collective is a gather or a select, so the tokens and f32 logits equal
the 1x1 mesh's bitwise.  Outside a policy, and on a 1x1 mesh, nothing
is split and every kind is a no-op.  That is the **exact** posture
(``exact=True``, the serving engine's).

Training runs under the **throughput** posture (``exact=False``, the
reference's ``policy_for(mesh, cfg, "train")``; DESIGN.md §7): its
leaves are cut by ``sharding.place_throughput``, and its collectives sum,
so its results equal the 1x1 step's only up to the reassociation of
float sums.  Four autograd functions carry them, each backward following
from the rule that activations are whole and replicated at every op
boundary:

  * :func:`enter_model` (forward the identity, backward an all-reduce
    over 'model'): a replicated activation feeding a column- or
    row-split weight gets only a partial gradient on each rank;
  * :func:`gather_model` (forward an all-gather over 'model', backward
    this rank's slice of the replicated gradient);
  * :func:`reduce_model` (forward an all-reduce of a row-split product's
    partial sums over 'model', backward the identity);
  * :func:`gather_data` (forward an all-gather of an FSDP shard into the
    whole leaf over 'data', backward a reduce-scatter: the gradient's
    data-parallel sum; a leaf whole over 'data' enters instead, its
    gradient all-reduced over 'data').

None of them runs under the exact posture.  Under the throughput posture
a layer's norm weight is read whole (:func:`whole_param`),
``common.linear`` sends a split weight to :func:`throughput_linear` (a
column split's product gathered; a row split's partial products reduced,
then the bias added once), :func:`embed_rows` gathers its parts with a
backward (still a select), and ``transformer.chunked_ce_loss`` computes
the loss vocab-parallel over a vocab-split head (per-chunk max, sum of
exponentials and gold logit, each reduced over 'model': no [B, chunk, V]
logits are gathered), its token count summed over 'data'
(:func:`data_total`).  An MoE layer's expert stacks follow the same
rule per expert (:func:`expert_rows`, ``constrain(..., "experts")``): an
expert-parallel stack computes this rank's experts of the entered
buffer and gathers them on the expert dim; an expert-TP ``wi``/``wg``
its F columns, gathered; an expert-TP ``wo`` (split on F, dim 1) its F
slice of the entered hidden buffer, the partial products reduced.  The
router is whole, so routing runs alike on every rank.  Attention
computes every head whole (q, k, v are gathered), as in serving, so
``heads_tp`` and the SP ``seq_axis`` change nothing in the port.  The
decoder-only text families train this way, dense and MoE, GQA or MLA
(``models.model.check_mesh_training``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import weakref
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from .sharding import Split, shard_shape, split_of, state_spec

__all__ = ["ShardPolicy", "use_policy", "constrain", "current_policy",
           "policy_for", "embed_rows", "expert_rows", "local_heads",
           "row_start", "whole_state", "state_part", "state_shape",
           "whole_weight", "throughput", "enter_model", "gather_model",
           "reduce_model", "max_model", "data_total", "gather_data",
           "model_split", "throughput_linear", "whole_param"]

_POLICY: contextvars.ContextVar = contextvars.ContextVar(
    "shard_policy", default=None)


@dataclasses.dataclass(frozen=True)
class ShardPolicy:
    dp: Tuple[str, ...] = ("data",)     # batch axes
    dp_size: int = 1
    model_size: int = 1
    heads_tp: bool = True               # TP attention heads over 'model'
    seq_axis: Optional[str] = None      # SP axis for activations (train/prefill)
    full_dp: bool = False               # small-model mode: batch over model too
    remat_policy: str = "full"          # full | dots (save dot outputs)
    loss_chunk: int = 0                 # 0 = model default (128)
    exact: bool = False                 # serving posture (DESIGN.md §7)
    #: the port's mesh (``launch.mesh.Mesh``) the collectives run over: in
    #: the reference the mesh is the ambient ``with mesh`` context
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    def batch_axes(self, b: int):
        if self.dp_size > 1 and b % self.dp_size == 0:
            return self.dp
        if b % max(self.model_size, 1) == 0 and len(self.dp) == 1:
            return self.dp  # single axis case
        return None


def policy_for(mesh, cfg, kind: str, full_dp: bool = False) -> ShardPolicy:
    import numpy as np
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if full_dp:
        dp = dp + ("model",)
    dpn = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1
    msz = mesh.shape.get("model", 1)
    heads_tp = (cfg.n_heads % msz == 0) and kind != "decode" and not full_dp
    seq_axis = None
    if kind in ("train", "prefill") and not heads_tp and not full_dp:
        seq_axis = "model"
    return ShardPolicy(dp=dp, dp_size=dpn, model_size=msz,
                       heads_tp=heads_tp, seq_axis=seq_axis, full_dp=full_dp,
                       mesh=mesh)


@contextlib.contextmanager
def use_policy(policy: Optional[ShardPolicy]):
    tok = _POLICY.set(policy)
    try:
        yield
    finally:
        _POLICY.reset(tok)


def current_policy() -> Optional[ShardPolicy]:
    return _POLICY.get()


def _mesh():
    pol = current_policy()
    if pol is None or pol.mesh is None:
        raise RuntimeError("a weight placed on a mesh is used outside its "
                           "engine's ShardPolicy (use_policy)")
    return pol.mesh


def _gather_split(x: torch.Tensor, split, dim: int) -> torch.Tensor:
    """The whole of ``x``, split like ``split`` on ``dim``: every rank's
    part padded to ``split.step`` (a ragged last column tile), gathered
    over 'model' (with a backward under the throughput posture), cut to
    ``split.full``."""
    mesh = _mesh()
    dim = dim % x.dim()
    short = split.step - x.shape[dim]
    if short:
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, short]
        x = F.pad(x, pad)
    y = mesh.gather(x, "model", dim) if throughput() is None else \
        gather_model(x, dim)
    return y.narrow(dim, 0, split.full) if y.shape[dim] != split.full else y


def local_heads(n_kv: int) -> Tuple[int, int]:
    """(first, count) of this rank's KV heads: a share of ``n_kv`` over
    'model' where it divides (the cache rule's split), else all of them."""
    pol = current_policy()
    m = pol.model_size if pol is not None and pol.mesh is not None else 1
    if m == 1 or n_kv % m:
        return 0, n_kv
    per = n_kv // m
    return pol.mesh.index("model") * per, per


def row_start(local: int, total: int) -> int:
    """The first of this rank's ``local`` rows of ``total`` slot rows
    split over 'data' (0 when they are not split)."""
    if local == total:
        return 0
    return current_policy().mesh.index("data") * local


def _block(part, shape) -> tuple:
    """The index of this rank's ``part`` of a leaf of whole ``shape``: slot
    rows (dim 0) at this rank's row start over 'data', any other dim that
    differs at this rank's share of it over 'model'."""
    idx = []
    for d, (p, n) in enumerate(zip(part, shape)):
        if p == n:
            idx.append(slice(None))
            continue
        o = row_start(p, n) if d == 0 else \
            current_policy().mesh.index("model") * p
        idx.append(slice(o, o + p))
    return tuple(idx)


def whole_state(t: torch.Tensor, shape) -> torch.Tensor:
    """A cache or state shard in the whole leaf's ``shape``, zero where
    other ranks hold it (``t`` itself when it is whole): its slot rows over
    'data', a KV-head, head or channel dim over 'model'.  The model then
    computes in the 1x1 shape, and this rank's block of the result is the
    1x1 mesh's bitwise."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    out = t.new_zeros(shape)
    out[_block(t.shape, shape)] = t
    return out


def state_part(t: torch.Tensor, part) -> torch.Tensor:
    """This rank's shard, of shape ``part``, of a state ``t`` computed in
    the whole shape (all of ``t`` when ``part`` is whole), contiguous on
    every mesh: the next step's contractions read it."""
    part = tuple(part)
    if tuple(t.shape) == part:
        return t.contiguous()
    return t[_block(part, t.shape)].clone(
        memory_format=torch.contiguous_format)


def state_shape(kind: str, name: str, shape) -> tuple:
    """The shard shape of recurrent state ``name`` of a ``kind`` layer
    (``mamba``, ``mlstm``, ``slstm``) of whole ``shape`` under the engine's
    cache rule (``sharding.state_spec``, exact), its slot rows whole: a
    prefill's state, every row of which the engine writes to the rank that
    holds the slot.  ``shape`` itself outside a mesh."""
    pol = current_policy()
    shape = tuple(shape)
    if pol is None or pol.mesh is None or pol.mesh.size == 1:
        return shape
    spec = state_spec(pol.mesh, kind, name, shape, shape[0], exact=True)
    return (shape[0],) + shard_shape(pol.mesh, spec, shape)[1:]


#: id(a split weight's anchor) -> (weakref to it, its whole matrix)
_WHOLE: dict = {}


def whole_weight(w, part: torch.Tensor) -> torch.Tensor:
    """The whole [K, N] matrix of weight ``w`` given this rank's ``part``
    of it as a matrix (its dense shard, or a packed shard dequantized):
    ``part`` itself where ``w`` is whole, else every rank's columns
    gathered over 'model', once per weight and kept while ``w`` lives.
    The gather concatenates, so the matrix is bitwise the whole
    weight's."""
    sp = split_of(w)
    if sp is None:
        return part
    anchor = w["sme_scale"] if isinstance(w, dict) else w
    key = id(anchor)
    hit = _WHOLE.get(key)
    if hit is not None and hit[0]() is anchor:
        return hit[1]
    whole = _gather_split(part, sp, -1)
    _WHOLE[key] = (weakref.ref(anchor, lambda _, k=key: _WHOLE.pop(k, None)),
                   whole)
    return whole


def constrain(x: torch.Tensor, kind: str, w=None, *, n_kv: int = 0,
              part=None) -> torch.Tensor:
    """kind: 'act' [B,S,D] | 'lhs' (a matmul's left operand): nothing to
    do | 'features' [..., N]: the product of weight ``w`` gathered over
    'model' when ``w`` is column-split | 'experts' [E, ..., N]: an
    expert-parallel ``w``'s outputs gathered on dim 0, a column-split
    stack's on the last dim, a row-split stack's (dim 1, the throughput
    posture's expert-TP ``wo``) partial products reduced | 'kv'
    [B,S,KV,hd]: this rank's heads of ``n_kv`` KV heads | 'block': an
    output computed in the 1x1 shape whose valid part is this rank's
    block of shape ``part`` (:func:`whole_state`'s placement), every
    rank's block gathered, a dim over 'model' first, then the rows over
    'data'."""
    if kind in ("act", "lhs"):
        return x
    if kind in ("features", "experts"):
        sp = split_of(w)
        if sp is None:
            return x
        if kind == "experts" and sp.dim == 0:
            return _gather_split(x, sp, 0)
        if kind == "experts" and sp.dim == 1:
            # a row split's partial products (throughput posture only:
            # the exact posture never splits a contraction)
            return reduce_model(x)
        return _gather_split(x, sp, -1)
    pol = current_policy()
    if kind == "block":
        # contiguous on every mesh: a gathered block is, and the next
        # contraction's bits follow its operand's layout
        whole = tuple(x.shape)
        part = tuple(part)
        if part == whole:
            return x.contiguous()
        x = x[_block(part, whole)]
        for d in range(1, x.dim()):
            if part[d] != whole[d]:
                x = pol.mesh.gather(x, "model", d)
        if part[0] != whole[0]:
            x = pol.mesh.gather(x, "data", 0)
        return x.contiguous()
    if pol is None or pol.mesh is None or pol.mesh.size == 1:
        return x
    if kind == "kv":
        first, count = local_heads(n_kv)
        return x if count == n_kv else x[:, :, first:first + count]
    raise ValueError(f"unknown constrain kind {kind!r}")


def expert_rows(h: torch.Tensor, w) -> torch.Tensor:
    """This rank's part of ``h`` [E, M, K], the left operand of expert
    stack ``w``: its experts for an expert-parallel ``w`` (split on dim
    0), its K columns for a row-split one (dim 1: the throughput
    posture's expert-TP ``wo``, split on F), all of ``h`` otherwise.
    Under the throughput posture a split ``w``'s ``h`` enters the 'model'
    axis first (:func:`enter_model`): each rank's gradient of it is
    partial."""
    sp = split_of(w)
    if sp is None:
        return h
    if throughput() is not None:
        h = enter_model(h)
    if sp.dim == 0:
        return h[sp.start:sp.start + sp.step]
    if sp.dim == 1:
        return h.narrow(-1, sp.start, sp.step)
    return h


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a table whose vocab rows may be split over
    'model': each rank looks up the rows it owns (a clamped index
    elsewhere), the parts are gathered (with a backward under the
    throughput posture), and each id's owner's row is selected from them,
    never summed."""
    sp = split_of(table)
    if sp is None:
        return table[ids]
    mesh = _mesh()
    local = table[(ids - sp.start).clamp(0, table.shape[0] - 1)]
    # [model, *ids, D]
    parts = mesh.gather(local[None], "model", 0) if throughput() is None \
        else gather_model(local[None], 0)
    owner = (ids // sp.step).clamp(max=parts.shape[0] - 1)
    idx = owner[None, ..., None].expand((1,) + local.shape)
    return torch.gather(parts, 0, idx)[0]


# ------------------------------------------------- the throughput posture

def throughput():
    """The mesh of the current throughput policy; None without a policy
    or a mesh, and under the exact posture."""
    pol = current_policy()
    if pol is None or pol.exact or pol.mesh is None:
        return None
    return pol.mesh


def _tp_mesh():
    mesh = throughput()
    if mesh is None:
        raise RuntimeError("a summing collective outside a throughput "
                           "ShardPolicy: the exact posture never sums")
    return mesh


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.start = mesh.index(axis) * ctx.n
        return mesh.gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None,
                None, None)


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim), None, None,
                None)


def enter_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` entering a model-split op: the identity, whose backward sums
    the ranks' partial gradients over 'model'.  ``mesh``: the throughput
    policy's by default (pass it where the call may run in the backward,
    a recomputed checkpoint, whose thread does not see the policy)."""
    mesh = mesh or _tp_mesh()
    return x if mesh.model == 1 else _Enter.apply(x, mesh, "model")


def gather_model(x: torch.Tensor, dim: int, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` over 'model' joined on ``dim``; the backward
    takes this rank's slice of the (replicated) gradient."""
    mesh = mesh or _tp_mesh()
    return x if mesh.model == 1 else _GatherSlice.apply(
        x, mesh, "model", dim % x.dim())


def reduce_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of every rank's partial ``x`` over 'model'; the backward
    is the identity."""
    mesh = mesh or _tp_mesh()
    return x if mesh.model == 1 else _Reduce.apply(x, mesh, "model")


def max_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The maximum of every rank's ``x`` over 'model', without a
    gradient (a softmax's shift)."""
    return (mesh or _tp_mesh()).all_reduce(x.detach(), "model", op="max")


def data_total(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over 'data' under a throughput policy (a loss's
    token count over every data rank's rows), ``x`` otherwise; without a
    gradient."""
    mesh = throughput()
    return x if mesh is None else mesh.all_reduce(x.detach(), "data")


def gather_data(shard: torch.Tensor, cut) -> torch.Tensor:
    """The leaf of throughput shard ``shard`` (its ``sharding.Cut``
    ``cut``) whole over 'data', as the model reads it: its FSDP parts
    gathered (the backward reduce-scatters the gradient over 'data'), or,
    whole already, entered (the backward all-reduces the gradient over
    'data'); ``shard`` itself on a 'data' axis of one rank."""
    mesh = _tp_mesh()
    d = cut.dim("data")
    if d is not None:
        return _GatherScatter.apply(shard, mesh, "data", d)
    return shard if mesh.data == 1 else _Enter.apply(shard, mesh, "data")


def model_split(t: torch.Tensor, cut) -> torch.Tensor:
    """``t``, a leaf whole over 'data', marked with the :class:`Split` of
    its 'model' cut (dim 0: a row-parallel weight's rows, the embedding's
    vocab rows or an expert-parallel stack's experts; 1: an expert-TP
    ``wo`` stack's F rows; -1: output columns); returns ``t``."""
    m = cut.dim("model")
    if m is not None:
        full = cut.shape[m]
        step = full // cut.mesh.model
        t.mesh_split = Split(m if m < len(cut.shape) - 1 else -1, full,
                             step, cut.mesh.index("model") * step)
    return t


def throughput_linear(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)`` for a weight split over 'model' under the throughput
    posture.  A column split (q/k/v/wi/wg) computes its columns and
    gathers them; a row split (o/wo, row-parallel) takes its rows' slice
    of the whole input, reduces the partial products over 'model', then
    adds the bias once (gathered whole where it is split)."""
    sp = split_of(w)
    x = enter_model(x)
    if sp.dim == 0:
        y = reduce_model(x.narrow(-1, sp.start, sp.step) @ w.to(x.dtype))
        if b is not None:
            if b.shape[-1] != y.shape[-1]:
                b = gather_model(b, -1)
            y = y + b.to(x.dtype)
        return y
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return gather_model(y, -1)


def whole_param(w: torch.Tensor) -> torch.Tensor:
    """A leaf the model reads whole (a layer's norm weight, which the
    throughput rule splits over 'model'): every rank's part gathered, the
    backward taking this rank's slice; ``w`` itself when it is whole."""
    sp = split_of(w)
    return w if sp is None else gather_model(w, sp.dim)
