"""Self-attention: GQA prefill over the whole prompt (causal, or
bidirectional for an encoder) and decode of one token against a per-slot
KV cache, with full or sliding-window (local) layers; MLA (deepseek),
whose cache holds the compressed ``c`` and the shared rope key ``k_pe``;
and the enc-dec decoder's cross-attention over the encoder states.

Checked against ``repro/models/attention.py`` (``gqa_prefill``,
``gqa_decode``, ``blockwise_attention``, ``_decode_attend``,
``_ring_gather``, ``_masked_row_scatter``, ``_mla_q``, ``mla_prefill``,
``mla_decode``, ``cross_kv``, ``cross_apply``, ``cross_decode``).  As in
the reference, GQA applies RoPE whatever else gives positions (whisper's
self-attention adds it to the sinusoidal embeddings); the cross
projections do not.  ``cross_decode`` takes each row's source length, so
that a cross cache longer than the source (the engine's, ``s_max`` long
per slot) attends only its own keys; without it every key is attended,
as in the reference, which has no such length (ROADMAP R6).  The
reference has no attention kernel, so this stays plain tensor code with
the reference's math: flash-style online softmax over KV blocks in f32,
and for a window ``W`` shorter than the keys, one softmax per query
block over the K/V slice ``[start - W + 1, start + block_q)`` it can
see.  A windowed layer's cache
is a ring of ``min(W, cache_len)`` slots; slot ``j`` at next position
``pos`` holds position ``pos - ((pos - j) mod ring)``.

MLA prefill expands ``c`` through ``kv_up`` into per-head keys (nope part
plus the shared rope part, 192 wide at deepseek's widths) and values (128
wide), so ``blockwise_attention`` takes a value head dim other than the
query/key one; its scale is ``1/sqrt(nope + rope)``.  MLA decode is the
absorbed form: the query folds through ``W_uk`` and the context through
``W_uv``, both read from ``kv_up`` as a matrix; a packed ``kv_up`` gives
them as its dequantized weight, built once per weight
(``core.backend.cached_dequant``; the reference cannot decode a packed
``kv_up``, ROADMAP R4).

On a serving mesh (``parallel.policy``) a rank's cache shard holds its
own KV heads (whole GQA groups, where their count divides the 'model'
axis) of its own slot rows, and only those are written.  Attention runs
in the 1x1 shape on every mesh: the card's batched matmuls pick their
algorithm by batch count (a slice of heads and rows gives other bits,
``tests/test_torch_cuda.py``), so a prefill attends every head, and a
decode step attends a whole cache whose other ranks' parts are zero, the
ranks' own rows and heads then gathered before ``o``.  The sequence dim
never splits.  MLA's cache has no head dim: a rank holds whole ``c`` and
``k_pe`` rows of its own slots (over 'data'), and a decode step computes
every head of the whole cache in the 1x1 shape (its other ranks' rows
zero), then gathers its rows.  The absorbed form needs ``kv_up`` as one
matrix: a column-split ``kv_up`` (its whole tiles over 'model', R10)
gives this rank's columns (a packed one dequantized), gathered over
'model' once per weight (``parallel.policy.whole_weight``).  A prefill
computes as on the 1x1 mesh (q, k, v are whole after ``linear``'s
gathers) and returns every row of its window, of which the engine keeps
the slots this rank holds, as it does a GQA prefill's K/V.  The
cross-attention follows GQA's pattern: a prefill attends every head of
the whole cross K/V (the caller keeps this rank's heads for the cache),
and ``cross_decode`` attends the whole cross cache in the 1x1 shape
(other ranks' rows and heads zero, each row masked past its source
length) and gathers its rows and heads before ``o``.

Decode positions are per batch row (``pos`` [B]) and ``active`` [B] masks
which rows may write their cache slot.  Unlike the reference, decode
updates the cache tensors in place (the engine owns them), which saves a
copy of every layer's cache per step.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.backend import cached_dequant
from ..parallel.policy import constrain, row_start, whole_state, whole_weight
from .common import apply_rope, linear, norm_pos_active

__all__ = ["gqa_prefill", "gqa_decode", "mla_prefill", "mla_decode",
           "cross_kv", "cross_apply", "cross_decode", "blockwise_attention",
           "NEG_INF"]

NEG_INF = -1e30


def _attend_block(q, k, qpos, kpos, scale, window: int = 0,
                  causal: bool = True):
    """Causal (bidirectional without ``causal``; local with ``window``)
    scores of one (q-block, k-block) tile: [B, KV, G, Bq, Bk]."""
    b, bq, h, hd = q.shape
    kv = k.shape[2]
    qh = q.reshape(b, bq, kv, h // kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), k.float()) * scale
    mask = kpos[None, :] >= 0
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def _online_update(m, l, acc, s, v):
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return m_new, l, acc * corr[..., None] + pv


def _window_block(qi, k, v, qpos, start: int, span: int, window: int,
                  scale, causal: bool = True):
    """One query block of a windowed layer against the K/V slice
    ``[start, start + span)`` it can see: one softmax, no online update
    (the reference's ``q_block`` of its windowed branch)."""
    ki, vi = k[:, start:start + span], v[:, start:start + span]
    kpos = start + torch.arange(span, device=qi.device)
    s = _attend_block(qi, ki, qpos, kpos, scale, window, causal)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, vi.float())
    return acc / torch.clamp(p.sum(dim=-1)[..., None], min=1e-30)


def blockwise_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        window: int = 0, block_q: int = 512,
                        block_k: int = 512) -> torch.Tensor:
    """Causal attention (every key without ``causal``), local to the last
    ``window`` positions when ``window`` > 0.  q/k: [B, Sq|Sk, H|KV, hd],
    v: [B, Sk, KV, hd_v] -> [B, Sq, H, hd_v], scaled by 1/sqrt(hd);
    ``q_offset`` is the absolute position of q[0].  A window shorter than
    the keys slices K/V per query block instead of scanning them."""
    b, sq, h, hd = q.shape
    hd_v = v.shape[-1]
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / (hd ** 0.5)
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    nq, nk = -(-sq // block_q), -(-sk // block_k)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * block_q - sq))
    dev = q.device
    outs = []
    if window and window < sk:
        span = min(window - 1 + block_q, sk)
        for i in range(nq):
            q0 = q_offset + i * block_q
            qpos = q0 + torch.arange(block_q, device=dev)
            start = min(max(q0 - (window - 1), 0), sk - span)
            outs.append(_window_block(q[:, i * block_q:(i + 1) * block_q],
                                      k, v, qpos, start, span, window, scale,
                                      causal))
    else:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * block_k - sk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * block_k - sk))
        for i in range(nq):
            qi = q[:, i * block_q:(i + 1) * block_q]
            qpos = q_offset + i * block_q + torch.arange(block_q, device=dev)
            m = torch.full((b, kvh, g, block_q), NEG_INF, device=dev)
            l = torch.zeros((b, kvh, g, block_q), device=dev)
            acc = torch.zeros((b, kvh, g, block_q, hd_v), device=dev)
            for j in range(nk):
                idx = j * block_k + torch.arange(block_k, device=dev)
                kpos = torch.where(idx < sk, idx, torch.full_like(idx, -1))
                s = _attend_block(qi, k[:, j * block_k:(j + 1) * block_k],
                                  qpos, kpos, scale, window, causal)
                m, l, acc = _online_update(
                    m, l, acc, s, v[:, j * block_k:(j + 1) * block_k])
            outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, dim=3).reshape(b, h, nq * block_q, hd_v)[:, :, :sq]
    return out.transpose(1, 2).to(q.dtype)


def _decode_attend(q, k, v, kpos, pos, window, scale):
    """Single-step attention. q: [B, 1, H, hd]; k/v: [B, W, KV, hd];
    kpos: [B, W]; pos: [B]; ``window`` > 0 keeps ``pos - kpos < window``."""
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    qh = q.reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), k.float()) * scale
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    if window:
        valid &= pos[:, None] - kpos < window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)


def _masked_row_scatter(cache, new, slot, active):
    """cache[i, slot[i]] <- new[i] where active[i], in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    keep = cache[rows, slot]
    upd = active.reshape((-1,) + (1,) * (new.dim() - 1))
    cache[rows, slot] = torch.where(upd, new.to(cache.dtype), keep)
    return cache


def _ring_gather(kv, plen, w: int):
    """kv [B, S, ...] -> ring cache [B, w, ...] of a ragged prefill: slot j
    of row i holds the largest position p < plen[i] with p % w == j, zeros
    where there is none."""
    b, s = kv.shape[:2]
    j = torch.arange(w, device=kv.device)
    pm1 = plen[:, None] - 1
    p = pm1 - ((pm1 - j[None]) % w)                        # [B, w]
    tail = (1,) * (kv.dim() - 2)
    valid = (p >= 0).reshape((b, w) + tail)
    idx = p.clamp(0, s - 1).reshape((b, w) + tail).expand((b, w) + kv.shape[2:])
    out = torch.gather(kv, 1, idx)
    return torch.where(valid, out, torch.zeros((), dtype=kv.dtype,
                                               device=kv.device))


def _qkv(p, x, cfg, positions, backend):
    b, s, _ = x.shape
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = linear(x, p["q"], backend).reshape(b, s, h, hd)
    k = linear(x, p["k"], backend).reshape(b, s, kv, hd)
    v = linear(x, p["v"], backend).reshape(b, s, kv, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def gqa_prefill(p, x, cfg, cache_len: int = 0, plen=None,
                backend: Optional[str] = None, window: int = 0,
                causal: bool = True, block_q: int = 512, block_k: int = 512):
    """Full-sequence causal self-attention (bidirectional without
    ``causal``; local to ``window`` positions when it is > 0).  Returns
    (y, cache) with the cache holding, per row, the last positions ``<
    plen[i]`` in ring order over ``min(window, cache_len)`` slots
    (``cache_len`` without a window; None when ``cache_len`` is 0)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions, backend)
    g = cfg.n_heads // cfg.n_kv_heads
    kr, vr = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    # every head, in the 1x1 shape on any mesh (q, k, v are whole)
    y = blockwise_attention(q, kr, vr, causal=causal, window=window,
                            block_q=block_q, block_k=block_k)
    y = linear(y.reshape(b, s, -1), p["o"], backend)
    if not cache_len:
        return y, None
    # on a mesh the cache keeps this rank's KV heads
    k = constrain(k, "kv", n_kv=cfg.n_kv_heads)
    v = constrain(v, "kv", n_kv=cfg.n_kv_heads)
    w = min(window, cache_len) if window else cache_len
    rows = (torch.full((b,), s, device=x.device) if plen is None
            else torch.as_tensor(plen, device=x.device).long())
    return y, {"k": _ring_gather(k, rows, w), "v": _ring_gather(v, rows, w)}


def gqa_decode(p, x, cache, pos, cfg, active=None,
               backend: Optional[str] = None, window: int = 0):
    """One-step decode. x: [B, 1, D]; cache k/v: [B, W, KV, hd] (a ring
    of W slots), updated in place; pos: [B] per-row next position; active:
    [B] write mask; ``window`` > 0 attends the last ``window`` positions."""
    b = x.shape[0]
    pos, active = norm_pos_active(pos, active, b, x.device)
    q, k, v = _qkv(p, x, cfg, pos[:, None], backend)
    nkv = cfg.n_kv_heads
    w = cache["k"].shape[1]
    slot = pos % w
    # on a mesh the cache shard holds this rank's KV heads of its slot
    # rows: the new position's K/V go there
    kc = _masked_row_scatter(cache["k"], *_mine(k, slot, active, cache, nkv))
    vc = _masked_row_scatter(cache["v"], *_mine(v, slot, active, cache, nkv))
    j = torch.arange(w, device=x.device)
    kpos = pos[:, None] - ((pos[:, None] - j[None]) % w)
    # attention in the 1x1 shape (a whole cache, zero where another rank
    # holds it): the library picks its algorithm by shape, so a rank's rows
    # and heads compute as on the 1x1 mesh; the ranks' parts are gathered
    whole = (b,) + tuple(kc.shape[1:2]) + (nkv,) + tuple(kc.shape[3:])
    y = _decode_attend(q, whole_state(kc, whole), whole_state(vc, whole),
                       kpos, pos, window, 1.0 / (cfg.hd ** 0.5))
    # this rank's rows and the query heads of its KV heads
    g = cfg.n_heads // nkv
    y = constrain(y, "block", part=(kc.shape[0], 1, kc.shape[2] * g,
                                    y.shape[3]))
    return linear(y.reshape(b, 1, -1), p["o"], backend), {"k": kc, "v": vc}


def _mine(new, slot, active, cache, n_kv):
    """(this rank's part of the new K or V row [B, 1, KV, hd], its slots,
    its write mask), for a cache shard of some slot rows and KV heads."""
    new = constrain(new, "kv", n_kv=n_kv)[:, 0]
    return _my_rows(cache["k"].shape[0], new, slot, active)


def _my_rows(rows: int, *ts):
    """This rank's ``rows`` slot rows of each [B, ...] tensor of ``ts``
    (all of them where the rows are whole)."""
    b = ts[0].shape[0]
    if rows == b:
        return ts
    r0 = row_start(rows, b)
    return tuple(t[r0:r0 + rows] for t in ts)


def _mla_q(p, x, cfg, positions, backend):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    if "q_down" in p:
        q = linear(linear(x, p["q_down"], backend), p["q_up"], backend)
    else:
        q = linear(x, p["q"], backend)
    q = q.reshape(b, s, h, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def mla_prefill(p, x, cfg, cache_len: int = 0, plen=None,
                backend: Optional[str] = None, block_q: int = 512,
                block_k: int = 512):
    """Full-sequence causal MLA.  Returns (y, cache) with the cache {"c":
    [B, cache_len, kv_lora], "k_pe": [B, cache_len, rope]} holding, per
    row, positions ``< plen[i]`` (zeros past them; None when
    ``cache_len`` is 0)."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_pe = _mla_q(p, x, cfg, positions, backend)
    ckv = linear(x, p["kv_down"], backend)
    c, k_pe_raw = ckv[..., :cfg.kv_lora], ckv[..., cfg.kv_lora:]
    k_pe = apply_rope(k_pe_raw[:, :, None, :], positions, cfg.rope_theta)
    kv = linear(c, p["kv_up"], backend).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, s, h, dr)], dim=-1)
    y = blockwise_attention(q, k, v, block_q=block_q, block_k=block_k)
    y = linear(y.reshape(b, s, -1), p["o"], backend)
    if not cache_len:
        return y, None
    cc = c.new_zeros((b, cache_len, cfg.kv_lora))
    pc = c.new_zeros((b, cache_len, dr))
    take = min(cache_len, s)
    c_w, pe_w = c, k_pe[:, :, 0]
    if plen is not None:
        keep = (torch.arange(s, device=x.device)[None]
                < torch.as_tensor(plen, device=x.device).long()[:, None]
                )[..., None]
        c_w = torch.where(keep, c_w, torch.zeros((), dtype=c.dtype,
                                                 device=c.device))
        pe_w = torch.where(keep, pe_w, torch.zeros((), dtype=c.dtype,
                                                   device=c.device))
    cc[:, :take] = c_w[:, s - take:]
    pc[:, :take] = pe_w[:, s - take:]
    return y, {"c": cc, "k_pe": pc}


def _kv_up_matrix(p) -> torch.Tensor:
    """``kv_up``'s weight [kv_lora, H * (nope + v)] as a matrix: the dense
    one, or a packed one dequantized once (R4); on a mesh that splits its
    columns, every rank's gathered once (``whole_weight``)."""
    we = p["kv_up"]["w"]
    return whole_weight(we, cached_dequant(we) if isinstance(we, dict)
                        else we)


def mla_decode(p, x, cache, pos, cfg, active=None,
               backend: Optional[str] = None):
    """Absorbed-form decode over the compressed cache, updated in place.
    x: [B, 1, D]; pos: [B] per-row next position; active: [B] write
    mask.  On a mesh the cache holds this rank's slot rows."""
    b = x.shape[0]
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    pos, active = norm_pos_active(pos, active, b, x.device)
    positions = pos[:, None]
    q_nope, q_pe = _mla_q(p, x, cfg, positions, backend)
    ckv = linear(x, p["kv_down"], backend)
    c_t, k_pe_raw = ckv[..., :cfg.kv_lora], ckv[..., cfg.kv_lora:]
    k_pe_t = apply_rope(k_pe_raw[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    # the new position's row goes to the rank that holds its slot
    rows = cache["c"].shape[0]
    c_r, pe_r, pos_r, act_r = _my_rows(rows, c_t[:, 0], k_pe_t[:, 0], pos,
                                       active)
    cc = _masked_row_scatter(cache["c"], c_r, pos_r, act_r)
    pc = _masked_row_scatter(cache["k_pe"], pe_r, pos_r, act_r)
    w_up = _kv_up_matrix(p).reshape(cfg.kv_lora, h, dn + dv).float()
    w_uk, w_uv = w_up[..., :dn], w_up[..., dn:]
    # every einsum in the 1x1 shape (the whole batch, other ranks' rows
    # zero): the card's batched matmuls pick their algorithm, and so their
    # bits, by batch count; this rank's rows are gathered after w_uv
    c_all = whole_state(cc, (b,) + tuple(cc.shape[1:])).float()
    pe_all = whole_state(pc, (b,) + tuple(pc.shape[1:])).float()
    q_c = torch.einsum("bthn,khn->bthk", q_nope.float(), w_uk)
    s_c = torch.einsum("bthk,bsk->bhs", q_c, c_all)
    s_pe = torch.einsum("bthr,bsr->bhs", q_pe.float(), pe_all)
    s = (s_c + s_pe) * (1.0 / ((dn + dr) ** 0.5))
    kpos = torch.arange(cc.shape[1], device=x.device)[None]
    s = torch.where((kpos <= pos[:, None])[:, None, :], s,
                    torch.full_like(s, NEG_INF))
    prob = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsk->bhk", prob, c_all)
    y = torch.einsum("bhk,khv->bhv", ctx, w_uv)
    y = constrain(y, "block", part=(rows,) + tuple(y.shape[1:]))
    y = linear(y.reshape(b, 1, h * dv).to(x.dtype), p["o"], backend)
    return y, {"c": cc, "k_pe": pc}


def cross_kv(p, enc, cfg, backend: Optional[str] = None) -> dict:
    """The decoder's cross K/V over encoder states enc [B, T, D]: {"k",
    "v"} [B, T, H, hd], no RoPE."""
    b, t, _ = enc.shape
    k = linear(enc, p["k"], backend).reshape(b, t, cfg.n_heads, cfg.hd)
    v = linear(enc, p["v"], backend).reshape(b, t, cfg.n_heads, cfg.hd)
    return {"k": k, "v": v}


def cross_apply(p, x, kv, cfg, backend: Optional[str] = None,
                block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Cross-attention of x [B, S, D] over every key of ``kv``."""
    b, s, _ = x.shape
    q = linear(x, p["q"], backend).reshape(b, s, cfg.n_heads, cfg.hd)
    y = blockwise_attention(q, kv["k"], kv["v"], causal=False,
                            block_q=block_q, block_k=block_k)
    return linear(y.reshape(b, s, -1), p["o"], backend)


def cross_decode(p, x, kv, cfg, src_len=None,
                 backend: Optional[str] = None) -> torch.Tensor:
    """One step's cross-attention. x: [B, 1, D]; kv k/v: [B, T, H, hd]
    (on a mesh this rank's shard: its slot rows and heads); ``src_len``
    [B]: row ``i`` attends its first ``src_len[i]`` keys (None: all
    ``T``)."""
    b = x.shape[0]
    h = cfg.n_heads
    q = linear(x, p["q"], backend).reshape(b, 1, h, cfg.hd)
    kc, vc = kv["k"], kv["v"]
    t = kc.shape[1]
    kpos = torch.arange(t, device=x.device).expand(b, t)
    last = torch.full((b,), t, device=x.device) if src_len is None else \
        torch.as_tensor(src_len, device=x.device).long().expand(b) - 1
    # attention in the 1x1 shape (every row and head, zero where another
    # rank holds them), then this rank's block gathered, as gqa_decode's
    whole = (b, t, h) + tuple(kc.shape[3:])
    y = _decode_attend(q, whole_state(kc, whole), whole_state(vc, whole),
                       kpos, last, 0, 1.0 / (cfg.hd ** 0.5))
    y = constrain(y, "block", part=(kc.shape[0], 1, kc.shape[2],
                                    y.shape[3]))
    return linear(y.reshape(b, 1, -1), p["o"], backend)
