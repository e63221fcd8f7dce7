"""Encoder-decoder transformer (the whisper-medium backbone).

Checked against ``repro/models/encdec.py`` (``encdec_encode``,
``_dec_embed``, ``encdec_init_cache``, ``encdec_prefill``,
``encdec_decode_step``, ``encdec_train_loss`` and ``encdec_init``'s
distributions).  The audio frontend is a stub: ``frames`` [B, S_src, D]
are precomputed frame embeddings.  A bidirectional encoder (sinusoidal
positions, then
LayerNorm -> self-attention -> LayerNorm -> GELU MLP per layer, then a
final norm) gives the states the causal decoder's cross-attention reads;
the decoder adds sinusoidal positions to its token embeddings and runs
self-attention, cross-attention and the MLP, each behind its own norm.
Self-attention applies RoPE too, as the reference's does.

Layers are Python lists of per-layer param dicts (``params["enc"][i]``,
``params["dec"][i]``) instead of the reference's stacked scan arrays,
and the cache is one dict per decoder layer, ``{"self": {"k", "v"}
[B, s_max, KV, hd], "cross": {"k", "v"} [B, src_len, H, hd]}``; decode
writes the self K/V in place and only reads the cross K/V.  The compute
dtype is ``cfg.dtype`` throughout, as the reference's enc-dec reads it
(ROADMAP R2 does not reach this family).  The head: a packed ``lm_head``
goes through ``sme_apply`` with f32 output (the reference's ``x @ w``
cannot take a packed head, ROADMAP R7), a dense one is ``x @ w`` in the
compute dtype, then f32.  Decode takes each row's source length
(``src_len``), so that a cross cache longer than the row's source is
attended only over its own keys (ROADMAP R6).  On a mesh the decoder's
embedding goes through ``parallel.policy.embed_rows`` (vocab rows split
over 'model' where they divide), and the prefill's self and cross K/V
keep this rank's heads (``constrain(..., "kv")``), the cache shard's; the
encoder and the positions are whole on every rank.  Training
(``encdec_train_loss``) runs the prefill's decoder layers without caches
and scores them through ``transformer.chunked_ce_loss`` on the dense
``lm_head``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel.policy import constrain, embed_rows
from . import attention as att
from .common import apply_norm, mlp_apply, norm_pos_active, sinusoidal_pos
from .transformer import (_head_logits, _lin, chunked_ce_loss,
                          compute_dtype, dense_only)

__all__ = ["encdec_init", "encdec_encode", "encdec_init_cache",
           "encdec_prefill", "encdec_decode_step", "encdec_train_loss"]


def _norm(cfg) -> dict:
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"w": np.ones(d, np.float32)}
    return {"w": np.ones(d, np.float32), "b": np.zeros(d, np.float32)}


def _attn(cfg, rng, cross: bool = False) -> dict:
    """Self-attention q/k/v/o (q/k/v biased with ``qkv_bias``), or the
    cross-attention's (only q biased)."""
    d, hd = cfg.d_model, cfg.hd
    h, kv = cfg.n_heads, (cfg.n_heads if cross else cfg.n_kv_heads)
    return {"q": _lin(rng, d, h * hd, cfg.qkv_bias),
            "k": _lin(rng, d, kv * hd, cfg.qkv_bias and not cross),
            "v": _lin(rng, d, kv * hd, cfg.qkv_bias and not cross),
            "o": _lin(rng, h * hd, d)}


def _mlp(cfg, rng) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"wi": _lin(rng, d, ff), "wg": _lin(rng, d, ff),
                "wo": _lin(rng, ff, d)}
    return {"wi": _lin(rng, d, ff, True), "wo": _lin(rng, ff, d, True)}


def encdec_init(cfg, rng: np.random.Generator) -> dict:
    """Whole-model f32 numpy params with the reference's distributions:
    embed ~ N(0, 1), linears N(0, 1/fan_in) with zero biases, norms of
    ones (and zero biases), ``lm_head`` [D, V] ~ N(0, 0.02^2)."""
    params = {
        "embed": {"w": rng.standard_normal((cfg.vocab, cfg.d_model),
                                           dtype=np.float32)},
        "enc_norm": _norm(cfg), "dec_norm": _norm(cfg),
        "lm_head": {"w": rng.standard_normal(
            (cfg.d_model, cfg.vocab), dtype=np.float32) * np.float32(0.02)},
    }
    params["enc"] = [{"norm1": _norm(cfg), "attn": _attn(cfg, rng),
                      "norm2": _norm(cfg), "mlp": _mlp(cfg, rng)}
                     for _ in range(cfg.n_enc_layers)]
    params["dec"] = [{"norm1": _norm(cfg), "self": _attn(cfg, rng),
                      "norm2": _norm(cfg), "cross": _attn(cfg, rng, True),
                      "norm3": _norm(cfg), "mlp": _mlp(cfg, rng)}
                     for _ in range(cfg.n_layers)]
    return params


def encdec_encode(params, frames: torch.Tensor, cfg,
                  backend: Optional[str] = None, block_q: int = 512,
                  block_k: int = 512) -> torch.Tensor:
    """frames [B, S_src, D] -> encoder states [B, S_src, D]."""
    dt = compute_dtype(cfg)
    s = frames.shape[1]
    x = frames.to(dt) + sinusoidal_pos(s, cfg.d_model,
                                       frames.device).to(dt)[None]
    for p in params["enc"]:
        a = apply_norm(x, p["norm1"], cfg.norm)
        y, _ = att.gqa_prefill(p["attn"], a, cfg, causal=False,
                               backend=backend, block_q=block_q,
                               block_k=block_k)
        x = x + y
        m = apply_norm(x, p["norm2"], cfg.norm)
        x = x + mlp_apply(m, p["mlp"], backend, cfg.act)
    return apply_norm(x, params["enc_norm"], cfg.norm)


def _dec_embed(params, tokens: torch.Tensor, cfg, pos0: int = 0
               ) -> torch.Tensor:
    """Token embeddings (rows gathered, then cast) plus the sinusoidal
    positions ``pos0 ..``."""
    dt = compute_dtype(cfg)
    x = embed_rows(params["embed"]["w"], tokens).to(dt)
    s = tokens.shape[1]
    pos = sinusoidal_pos(pos0 + s, cfg.d_model, tokens.device)
    return x + pos[pos0:].to(dt)[None]


def encdec_init_cache(cfg, batch: int, s_max: int, src_len: int,
                      device) -> list:
    """Zero caches, one ``{"self", "cross"}`` dict per decoder layer, in
    the compute dtype."""
    dt = compute_dtype(cfg)

    def zeros(n, heads):
        return torch.zeros((batch, n, heads, cfg.hd), dtype=dt,
                           device=device)
    return [{"self": {"k": zeros(s_max, cfg.n_kv_heads),
                      "v": zeros(s_max, cfg.n_kv_heads)},
             "cross": {"k": zeros(src_len, cfg.n_heads),
                       "v": zeros(src_len, cfg.n_heads)}}
            for _ in range(cfg.n_layers)]


def _decoder(params, x, enc, cfg, cache_len: int, backend, block_q: int,
             block_k: int):
    """The decoder layers over x [B, S, D] and the encoder states: (the
    final-normed states, per-layer caches, self K/V over ``cache_len``
    slots, None without one)."""
    caches = []
    for p in params["dec"]:
        a = apply_norm(x, p["norm1"], cfg.norm)
        y, self_c = att.gqa_prefill(p["self"], a, cfg, cache_len=cache_len,
                                    backend=backend, block_q=block_q,
                                    block_k=block_k)
        x = x + y
        ckv = att.cross_kv(p["cross"], enc, cfg, backend)
        c = apply_norm(x, p["norm2"], cfg.norm)
        x = x + att.cross_apply(p["cross"], c, ckv, cfg, backend, block_q,
                                block_k)
        m = apply_norm(x, p["norm3"], cfg.norm)
        x = x + mlp_apply(m, p["mlp"], backend, cfg.act)
        # on a mesh the cache keeps this rank's heads (the cache rule's)
        caches.append({"self": self_c, "cross": {
            k: constrain(t, "kv", n_kv=cfg.n_heads) for k, t in ckv.items()}})
    return apply_norm(x, params["dec_norm"], cfg.norm), caches


def encdec_prefill(params, tokens: torch.Tensor, frames: torch.Tensor, cfg,
                   s_max: int, backend: Optional[str] = None,
                   block_q: int = 512, block_k: int = 512):
    """Encode ``frames``, then prefill the decoder on tokens [B, S] (not
    ragged: every row is S long).  Returns (f32 logits [B, V] at the last
    position, per-layer caches: self K/V over ``s_max`` slots, cross K/V
    over the S_src encoder states)."""
    enc = encdec_encode(params, frames, cfg, backend, block_q, block_k)
    x, caches = _decoder(params, _dec_embed(params, tokens, cfg), enc, cfg,
                         s_max, backend, block_q, block_k)
    return _head_logits(params, cfg, x[:, -1], backend), caches


def encdec_train_loss(params, tokens: torch.Tensor, frames: torch.Tensor,
                      labels: torch.Tensor, cfg,
                      mask: Optional[torch.Tensor] = None,
                      loss_chunk: int = 128) -> torch.Tensor:
    """Mean cross-entropy of the decoder's next tokens over ``frames``."""
    dense_only(params)
    enc = encdec_encode(params, frames, cfg)
    x, _ = _decoder(params, _dec_embed(params, tokens, cfg), enc, cfg, 0,
                    None, 512, 512)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    return chunked_ce_loss(x, params["lm_head"]["w"], labels, mask,
                           loss_chunk)


def encdec_decode_step(params, token: torch.Tensor, caches: list, pos, cfg,
                       active=None, backend: Optional[str] = None,
                       src_len=None):
    """token [B, 1]; pos [B] per-row decoder position; active [B] rows
    that may write their self K/V slot; ``src_len`` [B] each row's source
    length (None: every cross key).  Self K/V are updated in place."""
    b = token.shape[0]
    pos, active = norm_pos_active(pos, active, b, token.device)
    dt = compute_dtype(cfg)
    s_max = caches[0]["self"]["k"].shape[1]
    table = sinusoidal_pos(s_max, cfg.d_model, token.device)
    x = embed_rows(params["embed"]["w"], token).to(dt) \
        + table[pos.clamp(0, s_max - 1)].to(dt)[:, None]
    new = []
    for p, c in zip(params["dec"], caches):
        a = apply_norm(x, p["norm1"], cfg.norm)
        y, self_c = att.gqa_decode(p["self"], a, c["self"], pos, cfg,
                                   active=active, backend=backend)
        x = x + y
        h = apply_norm(x, p["norm2"], cfg.norm)
        x = x + att.cross_decode(p["cross"], h, c["cross"], cfg, src_len,
                                 backend)
        m = apply_norm(x, p["norm3"], cfg.norm)
        x = x + mlp_apply(m, p["mlp"], backend, cfg.act)
        new.append({"self": self_c, "cross": c["cross"]})
    x = apply_norm(x, params["dec_norm"], cfg.norm)
    return _head_logits(params, cfg, x[:, -1], backend), new
