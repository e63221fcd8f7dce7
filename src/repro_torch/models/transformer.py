"""Decoder-only LM: embed -> layers -> final norm -> tied or untied head.

Checked against ``repro/models/transformer.py`` (``lm_prefill`` with
per-row ``plen``, ``lm_decode_step`` with per-row ``pos``/``active``,
``lm_init_cache``, ``_head_logits`` and ``lm_init``'s distributions).
Layers are a Python list of per-layer param dicts (``params["blocks"][i]``)
instead of the reference's stacked scan arrays; layer ``i`` is of kind
``cfg.pattern[i % len(cfg.pattern)]`` (slot ``i % len(pattern)`` of
superblock ``i // len(pattern)`` in the reference's layout).

Compute dtype follows ``cfg.dtype`` (bf16 or f32); params stay f32 and are
cast at use, as in the reference, except the tied head, which runs in f32
on the f32 table.  An untied ``lm_head`` that is SME-packed goes through
``sme_apply`` with f32 output (the decode pass's largest matmul); a dense
one is ``xl @ head`` in the compute dtype, then f32.  Only a tied head is
rescaled by 1/sqrt(D).  Two reference quirks are not copied (ROADMAP R2):
the reference computes in f32 whenever its params are numpy arrays,
whatever ``cfg.dtype`` says, and its caches are always bf16.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.backend import sme_apply
from .blocks import block_decode, block_prefill, init_block_cache
from .common import rmsnorm

__all__ = ["compute_dtype", "layer_kinds", "init_layer", "lm_init",
           "lm_init_cache", "lm_prefill", "lm_decode_step"]


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_kinds(cfg) -> list:
    """Slot kind of every layer: ``pattern[i % len(pattern)]``."""
    pat = cfg.pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def init_layer(cfg, rng: np.random.Generator) -> dict:
    """One layer's f32 numpy params, with the reference init's
    distributions: N(0, 1/fan_in) weights, zero biases, unit norms; a GELU
    MLP has biased ``wi``/``wo`` and no ``wg``."""
    d, hd, h, kv, ff = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def lin(d_in, d_out, bias=False):
        w = rng.standard_normal((d_in, d_out), dtype=np.float32)
        p = {"w": w * np.float32(1.0 / np.sqrt(d_in))}
        if bias:
            p["b"] = np.zeros(d_out, np.float32)
        return p

    return {
        "norm1": {"w": np.ones(d, np.float32)},
        "mix": {"q": lin(d, h * hd, cfg.qkv_bias),
                "k": lin(d, kv * hd, cfg.qkv_bias),
                "v": lin(d, kv * hd, cfg.qkv_bias),
                "o": lin(h * hd, d)},
        "norm2": {"w": np.ones(d, np.float32)},
        "mlp": ({"wi": lin(d, ff), "wg": lin(d, ff), "wo": lin(ff, d)}
                if cfg.act == "swiglu" else
                {"wi": lin(d, ff, True), "wo": lin(ff, d, True)}),
    }


def lm_init(cfg, rng: np.random.Generator) -> dict:
    """Whole-model f32 numpy params (embed ~ N(0, 1); an untied
    ``lm_head`` [D, V] ~ N(0, 0.02^2), drawn after the layers)."""
    params = {
        "embed": {"w": rng.standard_normal((cfg.vocab, cfg.d_model),
                                           dtype=np.float32)},
        "final_norm": {"w": np.ones(cfg.d_model, np.float32)},
        "blocks": [init_layer(cfg, rng) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": rng.standard_normal(
            (cfg.d_model, cfg.vocab), dtype=np.float32) * np.float32(0.02)}
    return params


def lm_init_cache(cfg, batch: int, s_max: int, device) -> list:
    return [init_block_cache(cfg, kind, batch, s_max, compute_dtype(cfg),
                             device) for kind in layer_kinds(cfg)]


def _embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Gather the rows first, then cast: only B x S rows, never the whole
    [V, D] table, go to the compute dtype."""
    x = params["embed"]["w"][tokens].to(compute_dtype(cfg))
    return x * (cfg.d_model ** 0.5)


def _head_logits(params, cfg, xl: torch.Tensor,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Final projection xl [B, D] -> f32 logits [B, V].  A tied head is
    rescaled by 1/sqrt(D) to undo the input scaling: one dense f32 matmul
    on the f32 table, with the scale applied to ``xl`` (no copy of the
    [V, D] table per pass; the reference scales and casts the whole table
    instead, in f32 for numpy params, ROADMAP R2).  An untied head is not
    rescaled: packed, it dispatches through ``sme_apply``; dense, it is
    ``xl @ head`` in the compute dtype."""
    if cfg.tie_embeddings:
        return (xl.float() * (cfg.d_model ** -0.5)) @ params["embed"]["w"].T
    we = params["lm_head"]["w"]
    if isinstance(we, dict):
        return sme_apply(xl, we, backend, out_dtype=torch.float32)
    return (xl @ we.to(xl.dtype)).float()


def lm_prefill(params, tokens: torch.Tensor, cfg, s_max: int, plen=None,
               backend: Optional[str] = None):
    """tokens [B, S] -> (logits [B, V] at each row's last valid position,
    per-layer caches over ``s_max`` slots).  ``plen`` [B] marks each row's
    valid prefix of a right-padded batch."""
    x = _embed_tokens(params, cfg, tokens)
    caches = []
    for p, kind in zip(params["blocks"], layer_kinds(cfg)):
        x, c = block_prefill(p, x, cfg, kind, s_max, plen=plen,
                             backend=backend)
        caches.append(c)
    x = rmsnorm(x, params["final_norm"])
    if plen is None:
        xl = x[:, -1]
    else:
        last = (torch.as_tensor(plen, device=x.device).long() - 1
                ).clamp(0, x.shape[1] - 1)
        xl = x[torch.arange(x.shape[0], device=x.device), last]
    return _head_logits(params, cfg, xl, backend), caches


def lm_decode_step(params, token: torch.Tensor, caches: list, pos, cfg,
                   active=None, backend: Optional[str] = None):
    """token [B, 1]; pos [B] per-row next position; active [B] rows that
    may write their cache slot.  Caches are updated in place."""
    x = _embed_tokens(params, cfg, token)
    new = []
    for p, c, kind in zip(params["blocks"], caches, layer_kinds(cfg)):
        x, c = block_decode(p, x, c, pos, cfg, kind, active=active,
                            backend=backend)
        new.append(c)
    x = rmsnorm(x, params["final_norm"])
    return _head_logits(params, cfg, x[:, -1], backend), new
