"""One decoder layer: RMSNorm -> GQA attention -> residual -> RMSNorm ->
SwiGLU MLP -> residual.

Checked against ``repro/models/blocks.py`` for the ``attn`` slot kind with
a dense MLP (``block_prefill``, ``block_decode``, ``init_block_cache``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import attention as att
from .common import mlp_apply, rmsnorm

__all__ = ["block_prefill", "block_decode", "init_block_cache"]


def _mlp_half(p, x, backend):
    return x + mlp_apply(rmsnorm(x, p["norm2"]), p["mlp"], backend)


def block_prefill(p, x, cfg, cache_len: int, plen=None,
                  backend: Optional[str] = None):
    y, cache = att.gqa_prefill(p["mix"], rmsnorm(x, p["norm1"]), cfg,
                               cache_len=cache_len, plen=plen,
                               backend=backend)
    return _mlp_half(p, x + y, backend), cache


def block_decode(p, x, cache, pos, cfg, active=None,
                 backend: Optional[str] = None):
    y, cache = att.gqa_decode(p["mix"], rmsnorm(x, p["norm1"]), cache, pos,
                              cfg, active=active, backend=backend)
    return _mlp_half(p, x + y, backend), cache


def init_block_cache(cfg, batch: int, s_max: int, dtype, device):
    shape = (batch, s_max, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
