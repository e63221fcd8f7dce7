"""Mixture-of-Experts MLP: a top-k router and capacity-bounded dispatch.

Checked against ``repro/models/moe.py`` (``moe_capacity``,
``_group_dispatch``, ``moe_apply``).  Dispatch is per *group*, a sequence
segment of at most ``group_size`` tokens of one batch row, with the
static capacity ``C = int(S * top_k / E * capacity_factor + 0.999)``;
tokens past an expert's capacity are dropped (their combine weight is
zero, the residual carries them).  ``plen`` (a ragged prefill's valid
length per row) sets each group's drop threshold from its valid tokens,
so padding never changes which tokens overflow.

Routing is exact: the router stays a dense matmul in the activation dtype
with an f32 softmax, and top-k is a stable descending sort (ties go to
the lower expert index, as ``jax.lax.top_k`` breaks them).  Slots come
from a cumulative count over the flattened ``(token, k)`` order; an
overflowing entry goes to a scratch slot that reads zero.

The reference maps a per-group dispatch over the groups, so each expert
matmul sees one group's ``[E, C, D]``.  Here every group's buffer is
gathered into ``[E, G * C, D]`` and each projection (``wg``, ``wi``,
``wo``) is one ``sme_apply`` over the stacked ``[E, D, F]`` weight: one
launch per expert per projection, M = G * C (a dense stack: one matmul
per expert).  Output rows do not depend
on one another (one chain per output element), so this equals the
per-group loop.  Empty experts compute too, as in the reference.
Routing runs on the replicated activations, so on a mesh every rank
routes, drops and combines alike, in the 1x1 order; only the expert
matmuls split (``_expert_mm``).  Under the throughput posture (mesh
training) the buffer a split stack reads enters the 'model' axis
(``parallel.policy.expert_rows``), so its gradient, partial on each rank,
is summed; an expert-TP ``wo``'s partial products are reduced.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.backend import sme_apply
from ..parallel.policy import constrain, expert_rows
from .common import linear

__all__ = ["moe_capacity", "moe_apply", "moe_drops"]


def moe_capacity(seq: int, cfg) -> int:
    cap = int(seq * cfg.top_k / cfg.n_experts * cfg.capacity_factor + 0.999)
    return max(cap, 1)


#: routing drops of every ``moe_apply`` call since callers last set them
#: to 0: valid (token, k) entries past their expert's threshold, and the
#: valid entries routed (device tensors once a call has run: reading them
#: is the only sync).  Padded tokens count only where ``plen`` is None.
moe_drops = {"dropped": 0, "routed": 0}


def _group_dispatch(xg, idx, n_experts: int, capacity: int, threshold):
    """xg [G, S, D], idx [G, S, k], threshold [G] -> (buf [G, E, C, D],
    flat_e [G, S*k], slot [G, S*k], keep [G, S*k])."""
    g, s, d = xg.shape
    k = idx.shape[-1]
    flat_e = idx.reshape(g, s * k)
    oh = F.one_hot(flat_e, n_experts)
    pos = torch.cumsum(oh, dim=1) - 1
    pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos < threshold[:, None]
    slot = torch.where(keep, pos, torch.full_like(pos, capacity))
    tok = torch.arange(s * k, device=xg.device) // k
    rows = torch.arange(g, device=xg.device)[:, None]
    buf = xg.new_zeros((g, n_experts, capacity + 1, d))
    buf[rows, flat_e, slot] = xg[:, tok]
    return buf[:, :, :capacity], flat_e, slot, keep


def _expert_mm(w, h, backend, dtype):
    """h [E, M, D] @ w [E, D, F] -> [E, M, F]: packed experts through
    ``sme_apply`` (one launch per expert), dense ones one matmul per
    expert (the same call on any mesh: the card's batched matmul picks its
    algorithm by batch count).  On a mesh (reference ``moe.py:124``) an
    expert-parallel stack computes this rank's experts and gathers them
    over 'model'; a column-split one its output features; a row-split one
    (throughput expert-TP ``wo``) its F slice, the partial products
    reduced."""
    h = expert_rows(constrain(h, "lhs"), w)
    if isinstance(w, dict):
        y = sme_apply(h, w, backend, out_dtype=dtype)
    else:
        y = torch.stack([he @ we.to(dtype) for he, we in zip(h, w)])
    return constrain(y, "experts", w)


def moe_apply(p, x, cfg, group_size: int = 2048, plen=None,
              backend: Optional[str] = None) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]; ``plen`` [B] is each row's valid prefix
    of a right-padded prefill batch (None: every token is valid)."""
    b0, s0, d = x.shape
    dt = x.dtype
    g = min(group_size, s0)
    pad = (-s0) % g
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    x = x.reshape(b0 * (x.shape[1] // g), g, d)
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(s, cfg)
    if plen is None:
        thr = torch.full((b,), cap, dtype=torch.long, device=x.device)
        valid = torch.full((b,), s, dtype=torch.long, device=x.device)
    else:
        gpr = b // b0                     # groups per row
        grp = torch.arange(b, device=x.device)
        row, seg = grp // gpr, grp % gpr
        valid = (torch.as_tensor(plen, device=x.device).long()[row]
                 - seg * s).clamp(0, s)
        # moe_capacity's formula on the valid count, in f32 in the
        # reference's order, clamped to the static buffer bound
        thr = (valid.float() * k / e * cfg.capacity_factor + 0.999).long()
        thr = thr.clamp(1, cap)

    router = p["router"]["w"]
    logits = x @ router.to(dt)
    probs = torch.softmax(logits.float(), dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    wgt, idx = srt[..., :k], order[..., :k]                  # [B, S, k]
    wgt = wgt / torch.clamp(wgt.sum(-1, keepdim=True), min=1e-9)

    buf, flat_e, slot, keep = _group_dispatch(x, idx, e, cap, thr)
    inside = (torch.arange(s * k, device=x.device) // k)[None] < valid[:, None]
    moe_drops["dropped"] = moe_drops["dropped"] + (~keep & inside).sum()
    moe_drops["routed"] = moe_drops["routed"] + inside.sum()
    # every group's buffer as one [E, G * C, D] batch per expert
    h = buf.transpose(0, 1).reshape(e, b * cap, d)
    hid = F.silu(_expert_mm(p["wg"], h, backend, dt)) \
        * _expert_mm(p["wi"], h, backend, dt)
    out = _expert_mm(p["wo"], hid, backend, dt)
    out = out.reshape(e, b, cap, d).transpose(0, 1)
    out = F.pad(out, (0, 0, 0, 1))        # the scratch slot reads 0
    rows = torch.arange(b, device=x.device)[:, None]
    y_tok = out[rows, flat_e, slot]                           # [B, S*k, D]
    y_tok = y_tok * (keep * wgt.reshape(b, s * k))[..., None].to(dt)
    y = y_tok.reshape(b, s, k, d).sum(dim=2)
    y = y.reshape(b0, -1, d)[:, :s0]
    x = x.reshape(b0, -1, d)[:, :s0]
    if "shared" in p:
        sh = p["shared"]
        hs = F.silu(linear(x, sh["wg"], backend)) * linear(x, sh["wi"],
                                                           backend)
        y = y + linear(hs, sh["wo"], backend)
    return y
