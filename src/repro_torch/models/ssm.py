"""Recurrent blocks: Mamba (Jamba) and xLSTM's mLSTM and sLSTM.

Checked against ``repro/models/ssm.py``: each block has a full-sequence
``*_apply`` (prefill, with a ragged batch's per-row ``plen``) and a
one-token ``*_decode`` whose ``active`` [B] mask keeps an inactive row's
state bit for bit.  Projections run in the compute dtype (SME-packed ones
through ``sme_apply``); every recurrence runs in f32.

* Mamba: the selective scan is a loop over time (the reference's
  ``lax.scan``; its chunking only bounds training memory, so the steps
  and their order are the same).  State ``{"conv": [B, K-1, d_in]`` in the
  compute dtype, ``"h": [B, d_in, N]`` f32``}``.
* mLSTM: the chunkwise-parallel form for prefill (chunks of 1024; the
  tail chunk padded with input gate -30) and the recurrent form for
  decode, each in the reference's op order: the two forms compute the
  same function with different rounding.  State ``{"C": [B, NH, dh, dh],
  "n": [B, NH, dh], "m": [B, NH]}``, f32.
* sLSTM: a loop over time with block-diagonal recurrence and a gated FFN
  after it.  State ``{"c", "n", "h", "m"}``, each [B, D] f32, ``m``
  starting at -10.

The reference keeps mLSTM's and sLSTM's states as tuples in that order;
the port names them, so every layer's cache is one ``{name: tensor}`` with
batch on dim 0 (the engine's contract).

On a serving mesh (``parallel.policy``) a state shard holds this rank's
slot rows (over 'data') and, for Mamba's ``conv``/``h`` and mLSTM's
``C``/``n``, its share of d_in, dv or heads (over 'model';
``sharding.state_spec``).  A prefill starts from zero and computes every
row and channel in the 1x1 shape, then keeps this rank's channels.  A
decode step takes the shards in the whole state's shape
(``whole_state``: zero where other ranks hold it), so every einsum, scan
and reduction runs in the 1x1 shape and this rank's block of each result
is the 1x1 mesh's bitwise; what a contraction reads whole (Mamba's conv
output and scan output, mLSTM's ``den`` and ``h``, sLSTM's ``h``) is
gathered from every rank's block (``constrain(..., "block")``), and the
new state is cut back to the shard (``state_part``).  No float sum
crosses a rank.  ``jax.nn.softplus`` is
``logaddexp(x, 0)``, here ``torch.logaddexp`` (``F.softplus`` switches to
``x`` above 20).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.policy import (constrain, row_start, state_part,
                               state_shape, whole_state)
from .common import linear

__all__ = ["mamba_dims", "mamba_apply", "mamba_decode", "mamba_state_init",
           "mlstm_dims", "mlstm_apply", "mlstm_decode", "mlstm_state_init",
           "slstm_apply", "slstm_decode", "slstm_state_init"]

#: the chunkwise mLSTM's chunk (the reference's default)
MLSTM_CHUNK = 1024


def _mask_state(active, new: dict, old: dict) -> dict:
    """The new state cut to the old one's shard (the whole state outside a
    mesh); rows with ``active[i]`` false keep their old state bit for
    bit."""
    new = {k: state_part(n, old[k].shape) for k, n in new.items()}
    if active is None:
        return new
    rows = next(iter(old.values())).shape[0]
    r0 = row_start(rows, active.shape[0])
    active = active[r0:r0 + rows]
    out = {}
    for k, n in new.items():
        a = active.reshape((active.shape[0],) + (1,) * (n.dim() - 1))
        out[k] = torch.where(a, n, old[k])
    return out


def _shards(kind: str, state: dict) -> dict:
    """A prefill's whole state cut to the channels this rank keeps (every
    slot row: the engine writes each to the rank that holds its slot)."""
    return {k: state_part(t, state_shape(kind, k, t.shape))
            for k, t in state.items()}


def _wholes(state: dict, shapes: dict) -> dict:
    """Each state shard in its whole shape (``shapes``)."""
    return {k: whole_state(t, shapes[k]) for k, t in state.items()}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _valid(plen, s: int, device) -> torch.Tensor:
    """[B, S] bool: step ``t`` of row ``i`` is before ``plen[i]``."""
    return torch.arange(s, device=device)[None] < \
        torch.as_tensor(plen, device=device).long()[:, None]


# ---------------------------------------------------------------- Mamba

def _causal_conv(x, w, b):
    """x [B, S, C], w [K, C] -> silu(causal depthwise conv + b)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = 0
    for i in range(k):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    return F.silu(y + b.to(x.dtype))


def _causal_conv_step(x1, conv_state, w, b):
    """x1 [B, 1, C]; conv_state [B, K-1, C], the previous inputs."""
    window = torch.cat([conv_state, x1], dim=1)               # [B, K, C]
    y = torch.einsum("bkc,kc->bc", window, w.to(x1.dtype))[:, None]
    return F.silu(y + b.to(x1.dtype)), window[:, 1:]


def mamba_dims(cfg):
    """(d_in, dt_rank, state size) of a Mamba block."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, max(1, math.ceil(cfg.d_model / 16)), cfg.ssm_state


def _selective_scan(u, dt, bmat, cmat, a, h, tmask=None):
    """The f32 time loop: u, dt [B, S, d_in], bmat, cmat [B, S, N], a
    [d_in, N], h [B, d_in, N] -> (y [B, S, d_in], final h).  ``tmask`` [B,
    S] freezes a row's state at masked steps."""
    ys = []
    for t in range(u.shape[1]):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * a[None])              # [B, d_in, N]
        h_new = da * h + (dt_t * u[:, t])[..., None] * bmat[:, t, None, :]
        h = h_new if tmask is None else \
            torch.where(tmask[:, t, None, None], h_new, h)
        ys.append((h_new * cmat[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h


def _mamba_core(p, xc, z, cfg, h0, tmask=None, backend=None):
    """xc (after the conv) [B, S, d_in] -> (y [B, S, d_in], final h).
    ``tmask`` [B, S] freezes a row's state at masked steps."""
    _, dt_rank, n = mamba_dims(cfg)
    proj = linear(xc, p["x_proj"], backend)
    dt_r, bmat, cmat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = _softplus(linear(dt_r, p["dt_w"], backend)
                   + p["dt_bias"].to(xc.dtype))
    a = -torch.exp(p["A_log"].float())                        # [d_in, N]
    y, h = _selective_scan(xc.float(), dt.float(), bmat.float(),
                           cmat.float(), a, h0, tmask)
    y = y.to(xc.dtype) + xc * p["D"].to(xc.dtype)
    return y * F.silu(z), h


def _tail_window(xr, plen, k: int):
    """Per row the last ``k - 1`` inputs before ``plen`` (zeros where the
    row is shorter): a ragged batch's decode conv state."""
    s = xr.shape[1]
    idx = torch.as_tensor(plen, device=xr.device).long()[:, None] \
        - (k - 1) + torch.arange(k - 1, device=xr.device)       # [B, k-1]
    got = torch.gather(xr, 1, idx.clamp(0, s - 1)[..., None].expand(
        -1, -1, xr.shape[2]))
    return torch.where((idx >= 0)[..., None], got, torch.zeros(
        (), dtype=xr.dtype, device=xr.device))


def mamba_state_init(cfg, batch: int, dtype, device) -> dict:
    """Zero state: the conv window in the cache ``dtype``, ``h`` f32."""
    d_in, _, n = mamba_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, d_in, n), dtype=torch.float32,
                             device=device)}


def mamba_apply(p, x, cfg, plen=None, backend: Optional[str] = None):
    """x [B, S, D] -> (y, state after each row's ``plen`` steps)."""
    b, s, _ = x.shape
    xr, z = torch.chunk(linear(x, p["in_proj"], backend), 2, dim=-1)
    xc = _causal_conv(xr, p["conv_w"], p["conv_b"])
    h0 = mamba_state_init(cfg, b, x.dtype, x.device)["h"]
    tmask = None if plen is None else _valid(plen, s, x.device)
    y, h = _mamba_core(p, xc, z, cfg, h0, tmask, backend)
    rows = torch.full((b,), s, device=x.device) if plen is None else plen
    return linear(y, p["out_proj"], backend), _shards("mamba", {
        "conv": _tail_window(xr, rows, cfg.ssm_conv), "h": h})


def mamba_decode(p, x1, state, cfg, active=None,
                 backend: Optional[str] = None):
    """x1 [B, 1, D]: one step; ``active`` [B] freezes the other rows."""
    d_in, _, n = mamba_dims(cfg)
    b = x1.shape[0]
    cs, hs = state["conv"].shape, state["h"].shape
    whole = _wholes(state, {"conv": (b, cfg.ssm_conv - 1, d_in),
                            "h": (b, d_in, n)})
    xr, z = torch.chunk(linear(x1, p["in_proj"], backend), 2, dim=-1)
    xc, conv = _causal_conv_step(xr, whole["conv"], p["conv_w"], p["conv_b"])
    # x_proj contracts over d_in: every rank's rows and channels of xc
    xc = constrain(xc, "block", part=(cs[0], 1, cs[2]))
    y, h = _mamba_core(p, xc, z, cfg, whole["h"], backend=backend)
    y = constrain(y, "block", part=(hs[0], 1, hs[1]))
    return linear(y, p["out_proj"], backend), \
        _mask_state(active, {"conv": conv, "h": h}, state)


# ---------------------------------------------------------------- mLSTM

def mlstm_dims(cfg):
    """(d_in, heads, head width) of an mLSTM block."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def _mlstm_qkv(p, xr, nh: int, dh: int, backend=None):
    """Block-diagonal per-head q, k (scaled by 1/sqrt(dh)), v [B, S, NH,
    dh] in the compute dtype; log-space input and forget gates [B, S, NH]
    in f32."""
    b, s, _ = xr.shape
    xh = xr.reshape(b, s, nh, dh)
    q = torch.einsum("bsnd,nde->bsne", xh, p["q"].to(xr.dtype))
    k = torch.einsum("bsnd,nde->bsne", xh, p["k"].to(xr.dtype)) / (dh ** 0.5)
    v = torch.einsum("bsnd,nde->bsne", xh, p["v"].to(xr.dtype))
    ig = linear(xr, p["ig"], backend).float()
    fg = F.logsigmoid(linear(xr, p["fg"], backend).float())
    return q, k, v, ig, fg


def _mlstm_chunk_scan(q, k, v, ig, fg, chunk: int, state0: dict):
    """The stabilized chunkwise mLSTM.  q, k, v [B, S, NH, dh] (k
    scaled), ig/fg [B, S, NH] log gates, S a multiple of ``chunk``.
    Returns (h [B, S, NH, dh] f32, final state)."""
    b, s, nh, dh = q.shape
    nc = s // chunk
    c_st, n_st, m_st = state0["C"], state0["n"], state0["m"]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    neg = ig.new_full((), -math.inf)
    hs = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        a_i, f_i = ig[:, sl], fg[:, sl]                       # [B, L, NH]
        bcum = torch.cumsum(f_i, dim=1)
        a_min_b = a_i - bcum
        run_max = torch.cummax(a_min_b, dim=1).values
        m_t = bcum + torch.maximum(m_st[:, None], run_max)    # [B, L, NH]
        logits = torch.einsum("btnd,bsnd->bnts", qf, kf)
        dec = bcum[:, :, None, :] - bcum[:, None, :, :] + a_i[:, None, :, :]
        dec = dec.permute(0, 3, 1, 2)                         # [B, NH, L, L]
        dgate = torch.where(mask[None, None],
                            dec - m_t.permute(0, 2, 1)[..., None], neg)
        s_intra = logits * torch.exp(dgate)
        num_intra = torch.einsum("bnts,bsnd->btnd", s_intra, vf)
        den_intra = s_intra.sum(-1).permute(0, 2, 1)          # [B, L, NH]
        w_inter = torch.exp(bcum + m_st[:, None] - m_t)
        num_inter = torch.einsum("btnd,bnde->btne", qf, c_st) \
            * w_inter[..., None]
        den_inter = torch.einsum("btnd,bnd->btn", qf, n_st) * w_inter
        num = num_intra + num_inter
        den = den_intra + den_inter
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])
        b_l = bcum[:, -1]                                     # [B, NH]
        m_new = torch.maximum(m_st + b_l,
                              (a_min_b + b_l[:, None]).amax(dim=1))
        w_old = torch.exp(m_st + b_l - m_new)
        w_tok = torch.exp(a_min_b + b_l[:, None] - m_new[:, None])
        # sum_s w_tok[s] k_s v_s^T, as one contraction over s
        c_st = c_st * w_old[..., None, None] + torch.einsum(
            "bsnd,bsne->bnde", kf * w_tok[..., None], vf)
        n_st = n_st * w_old[..., None] + torch.einsum("bsnd,bsn->bnd", kf,
                                                       w_tok)
        m_st = m_new
    return torch.cat(hs, dim=1), {"C": c_st, "n": n_st, "m": m_st}


def mlstm_state_init(cfg, batch: int, dtype, device) -> dict:
    """Zero f32 state (``dtype``, the cache dtype, is not used)."""
    _, nh, dh = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, nh, dh, dh), **f32),
            "n": torch.zeros((batch, nh, dh), **f32),
            "m": torch.zeros((batch, nh), **f32)}


def mlstm_apply(p, x, cfg, plen=None, backend: Optional[str] = None,
                chunk: int = MLSTM_CHUNK):
    """x [B, S, D] -> (y, state).  A ragged ``plen`` gives padded steps
    input gate -inf and log forget gate 0, which freezes the recurrence
    exactly."""
    d_in, nh, dh = mlstm_dims(cfg)
    b, s, _ = x.shape
    xr, z = torch.chunk(linear(x, p["up"], backend), 2, dim=-1)
    q, k, v, ig, fg = _mlstm_qkv(p, xr, nh, dh, backend)
    if plen is not None:
        keep = _valid(plen, s, x.device)[..., None]            # [B, S, 1]
        ig = torch.where(keep, ig, ig.new_full((), -math.inf))
        fg = torch.where(keep, fg, fg.new_zeros(()))
    chunk = min(chunk, s)
    pad = -s % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, 0, 0, pad), value=-30.0)
        fg = F.pad(fg, (0, 0, 0, pad))
    h, state = _mlstm_chunk_scan(q, k, v, ig, fg, chunk,
                                 mlstm_state_init(cfg, b, None, x.device))
    h = h[:, :s].reshape(b, s, d_in).to(x.dtype) * p["norm_w"].to(x.dtype)
    return linear(h * F.silu(z), p["down"], backend), _shards("mlstm", state)


def mlstm_decode(p, x1, state, cfg, active=None,
                 backend: Optional[str] = None):
    """The exact recurrent step; ``active`` [B] freezes the other rows."""
    d_in, nh, dh = mlstm_dims(cfg)
    b = x1.shape[0]
    xr, z = torch.chunk(linear(x1, p["up"], backend), 2, dim=-1)
    q, k, v, ig, fg = _mlstm_qkv(p, xr, nh, dh, backend)
    qf, kf, vf = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    a_t, f_t = ig[:, 0], fg[:, 0]                             # [B, NH]
    whole = _wholes(state, {"C": (b, nh, dh, dh), "n": (b, nh, dh),
                            "m": (b, nh)})
    c_st, n_st, m_st = whole["C"], whole["n"], whole["m"]
    m_new = torch.maximum(f_t + m_st, a_t)
    wf = torch.exp(f_t + m_st - m_new)
    wi = torch.exp(a_t - m_new)
    c_new = c_st * wf[..., None, None] + torch.einsum(
        "bnd,bne->bnde", kf, vf) * wi[..., None, None]
    n_new = n_st * wf[..., None] + kf * wi[..., None]
    num = torch.einsum("bnd,bnde->bne", qf, c_new)
    den = torch.einsum("bnd,bnd->bn", qf, n_new)
    # every head's den beside this rank's dv columns of num; then every
    # rank's rows and columns of h for the down projection
    den = constrain(den, "block", part=state["n"].shape[:2])
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    cs = state["C"].shape
    h = constrain(h, "block", part=(cs[0], nh, cs[3]))
    h = h.reshape(b, 1, d_in).to(x1.dtype) * p["norm_w"].to(x1.dtype)
    return linear(h * F.silu(z), p["down"], backend), \
        _mask_state(active, {"C": c_new, "n": n_new, "m": m_new}, state)


# ---------------------------------------------------------------- sLSTM

def slstm_state_init(cfg, batch: int, dtype, device) -> dict:
    """f32 state, ``m`` at -10 (``dtype``, the cache dtype, is not
    used)."""
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(), "m": z - 10.0}


def _slstm_scan(p, wx, cfg, state0: dict, tmask=None):
    """wx [B, S, 4D] (the i, f, z, o input projections) -> (h [B, S, D]
    f32, final state); ``tmask`` [B, S] freezes a row at masked steps."""
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    b, s = wx.shape[:2]
    r = p["r"].float()                                        # [4, NH, dh, dh]
    bias = p["b"].float().reshape(4, d)
    raw_x = wx.float().reshape(b, s, 4, d).permute(2, 0, 1, 3)  # [4, B, S, D]
    c0, n0, h0, m0 = (state0[k] for k in ("c", "n", "h", "m"))
    hs = []
    for t in range(s):
        rec = torch.einsum("bnd,gnde->gbne", h0.reshape(b, nh, dh),
                           r).reshape(4, b, d)
        i_r, f_r, z_r, o_r = raw_x[:, :, t] + rec + bias[:, None]
        m_new = torch.maximum(f_r + m0, i_r)
        i_g = torch.exp(i_r - m_new)
        f_g = torch.exp(f_r + m0 - m_new)
        c = f_g * c0 + i_g * torch.tanh(z_r)
        n = f_g * n0 + i_g
        h = torch.sigmoid(o_r) * c / torch.clamp(n, min=1e-6)
        if tmask is not None:
            sel = tmask[:, t, None]
            c, n, h, m_new = (torch.where(sel, a, o) for a, o in
                              ((c, c0), (n, n0), (h, h0), (m_new, m0)))
        c0, n0, h0, m0 = c, n, h, m_new
        hs.append(h)
    return torch.stack(hs, dim=1), {"c": c0, "n": n0, "h": h0, "m": m0}


def _slstm_ffn(p, y, backend):
    ff = F.silu(linear(y, p["ff_wg"], backend)) * linear(y, p["ff_wi"],
                                                          backend)
    return linear(ff, p["ff_wo"], backend)


def slstm_apply(p, x, cfg, plen=None, backend: Optional[str] = None):
    b, s, _ = x.shape
    wx = linear(x, p["wx"], backend)
    tmask = None if plen is None else _valid(plen, s, x.device)
    hs, state = _slstm_scan(p, wx, cfg,
                            slstm_state_init(cfg, b, None, x.device), tmask)
    return _slstm_ffn(p, hs.to(x.dtype), backend), _shards("slstm", state)


def slstm_decode(p, x1, state, cfg, active=None,
                 backend: Optional[str] = None):
    b = x1.shape[0]
    whole = _wholes(state, {k: (b, cfg.d_model) for k in state})
    hs, new = _slstm_scan(p, linear(x1, p["wx"], backend), cfg, whole)
    # the FFN's rows: every rank's
    hs = constrain(hs, "block", part=(state["h"].shape[0],) + hs.shape[1:])
    return _slstm_ffn(p, hs.to(x1.dtype), backend), \
        _mask_state(active, new, state)
