"""One decoder layer: norm -> attention -> residual -> norm -> MLP ->
residual, of one slot kind.

Checked against ``repro/models/blocks.py`` for the attention slot kinds
(``block_prefill``, ``block_decode``, ``init_block_cache``): ``attn`` and
``attn_global`` attend every earlier position, ``attn_local`` the last
``cfg.swa_window`` (its cache a ring of ``min(swa_window, s_max)``
slots); MLA replaces GQA when ``cfg.attn_type == "mla"`` (its cache the
compressed ``c`` [B, s_max, kv_lora] and ``k_pe`` [B, s_max, rope]).  The
MLP is ``cfg.act`` (SwiGLU or GELU), or an MoE MLP where ``use_moe``
(``cfg.moe_for_slot``), which a ragged prefill's ``plen`` reaches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import attention as att
from .common import mlp_apply, rmsnorm
from .moe import moe_apply

__all__ = ["ATTN_KINDS", "block_prefill", "block_decode", "init_block_cache"]

ATTN_KINDS = ("attn", "attn_global", "attn_local")


def _window(cfg, kind: str) -> int:
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    return cfg.swa_window if kind == "attn_local" else 0


def _mlp_half(p, x, cfg, use_moe, backend, plen=None):
    h = rmsnorm(x, p["norm2"])
    if use_moe:
        return x + moe_apply(p["mlp"], h, cfg, plen=plen, backend=backend)
    return x + mlp_apply(h, p["mlp"], backend, cfg.act)


def block_prefill(p, x, cfg, kind: str, cache_len: int, plen=None,
                  backend: Optional[str] = None, use_moe: bool = False):
    h = rmsnorm(x, p["norm1"])
    window = _window(cfg, kind)
    if cfg.attn_type == "mla":
        y, cache = att.mla_prefill(p["mix"], h, cfg, cache_len=cache_len,
                                   plen=plen, backend=backend)
    else:
        y, cache = att.gqa_prefill(p["mix"], h, cfg, cache_len=cache_len,
                                   plen=plen, backend=backend, window=window)
    return _mlp_half(p, x + y, cfg, use_moe, backend, plen), cache


def block_decode(p, x, cache, pos, cfg, kind: str, active=None,
                 backend: Optional[str] = None, use_moe: bool = False):
    h = rmsnorm(x, p["norm1"])
    window = _window(cfg, kind)
    if cfg.attn_type == "mla":
        y, cache = att.mla_decode(p["mix"], h, cache, pos, cfg,
                                  active=active, backend=backend)
    else:
        y, cache = att.gqa_decode(p["mix"], h, cache, pos, cfg,
                                  active=active, backend=backend,
                                  window=window)
    return _mlp_half(p, x + y, cfg, use_moe, backend), cache


def init_block_cache(cfg, kind: str, batch: int, s_max: int, dtype, device):
    window = _window(cfg, kind)
    if cfg.attn_type == "mla":
        return {"c": torch.zeros((batch, s_max, cfg.kv_lora), dtype=dtype,
                                 device=device),
                "k_pe": torch.zeros((batch, s_max, cfg.rope_head_dim),
                                    dtype=dtype, device=device)}
    w = min(window, s_max) or s_max
    shape = (batch, w, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
