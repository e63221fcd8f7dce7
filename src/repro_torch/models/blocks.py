"""One decoder layer: norm -> GQA attention -> residual -> norm -> MLP ->
residual, of one slot kind.

Checked against ``repro/models/blocks.py`` for the attention slot kinds
with a dense MLP (``block_prefill``, ``block_decode``,
``init_block_cache``): ``attn`` and ``attn_global`` attend every earlier
position, ``attn_local`` the last ``cfg.swa_window`` (its cache a ring of
``min(swa_window, s_max)`` slots); the MLP is ``cfg.act`` (SwiGLU or
GELU).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import attention as att
from .common import mlp_apply, rmsnorm

__all__ = ["ATTN_KINDS", "block_prefill", "block_decode", "init_block_cache"]

ATTN_KINDS = ("attn", "attn_global", "attn_local")


def _window(cfg, kind: str) -> int:
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    return cfg.swa_window if kind == "attn_local" else 0


def _mlp_half(p, x, cfg, backend):
    return x + mlp_apply(rmsnorm(x, p["norm2"]), p["mlp"], backend, cfg.act)


def block_prefill(p, x, cfg, kind: str, cache_len: int, plen=None,
                  backend: Optional[str] = None):
    y, cache = att.gqa_prefill(p["mix"], rmsnorm(x, p["norm1"]), cfg,
                               cache_len=cache_len, plen=plen,
                               backend=backend, window=_window(cfg, kind))
    return _mlp_half(p, x + y, cfg, backend), cache


def block_decode(p, x, cache, pos, cfg, kind: str, active=None,
                 backend: Optional[str] = None):
    y, cache = att.gqa_decode(p["mix"], rmsnorm(x, p["norm1"]), cache, pos,
                              cfg, active=active, backend=backend,
                              window=_window(cfg, kind))
    return _mlp_half(p, x + y, cfg, backend), cache


def init_block_cache(cfg, kind: str, batch: int, s_max: int, dtype, device):
    w = min(_window(cfg, kind), s_max) or s_max
    shape = (batch, w, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
