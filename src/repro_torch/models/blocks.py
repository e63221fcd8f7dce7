"""One decoder layer: norm -> mixer -> residual -> norm -> MLP ->
residual, of one slot kind.

Checked against ``repro/models/blocks.py`` (``block_train``,
``block_prefill``, ``block_decode``, ``init_block_cache``): the mixer is
attention or one of the recurrent blocks of ``models/ssm.py`` (``mamba``,
``mlstm``, ``slstm``, whose caches are their f32 states, Mamba's conv
window in the cache dtype); a layer without ``mlp`` (xLSTM, ``d_ff`` 0)
has no MLP half.
Of the attention kinds, ``attn`` and
``attn_global`` attend every earlier position, ``attn_local`` the last
``cfg.swa_window`` (its cache a ring of ``min(swa_window, s_max)``
slots); MLA replaces GQA when ``cfg.attn_type == "mla"`` (its cache the
compressed ``c`` [B, s_max, kv_lora] and ``k_pe`` [B, s_max, rope]).  The
MLP is ``cfg.act`` (SwiGLU or GELU), or an MoE MLP where ``use_moe``
(``cfg.moe_for_slot``), which a ragged prefill's ``plen`` reaches.
``block_train`` is the prefill of every kind without a cache (a
recurrent block's final state is dropped): the same function the
reference's training block computes, differentiable by autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import attention as att
from . import ssm
from .common import mlp_apply, rmsnorm
from .moe import moe_apply

__all__ = ["ATTN_KINDS", "SSM_KINDS", "block_train", "block_prefill",
           "block_decode", "init_block_cache"]

ATTN_KINDS = ("attn", "attn_global", "attn_local")
#: recurrent kind -> (prefill, decode, zero state)
SSM_KINDS = {"mamba": (ssm.mamba_apply, ssm.mamba_decode,
                       ssm.mamba_state_init),
             "mlstm": (ssm.mlstm_apply, ssm.mlstm_decode,
                       ssm.mlstm_state_init),
             "slstm": (ssm.slstm_apply, ssm.slstm_decode,
                       ssm.slstm_state_init)}


def _window(cfg, kind: str) -> int:
    if kind not in ATTN_KINDS and kind not in SSM_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    return cfg.swa_window if kind == "attn_local" else 0


def _mlp_half(p, x, cfg, use_moe, backend, plen=None):
    if "mlp" not in p:
        return x
    h = rmsnorm(x, p["norm2"])
    if use_moe:
        return x + moe_apply(p["mlp"], h, cfg, plen=plen, backend=backend)
    return x + mlp_apply(h, p["mlp"], backend, cfg.act)


def block_prefill(p, x, cfg, kind: str, cache_len: int, plen=None,
                  backend: Optional[str] = None, use_moe: bool = False):
    h = rmsnorm(x, p["norm1"])
    window = _window(cfg, kind)
    if kind in SSM_KINDS:
        y, cache = SSM_KINDS[kind][0](p["mix"], h, cfg, plen=plen,
                                      backend=backend)
    elif cfg.attn_type == "mla":
        y, cache = att.mla_prefill(p["mix"], h, cfg, cache_len=cache_len,
                                   plen=plen, backend=backend)
    else:
        y, cache = att.gqa_prefill(p["mix"], h, cfg, cache_len=cache_len,
                                   plen=plen, backend=backend, window=window)
    return _mlp_half(p, x + y, cfg, use_moe, backend, plen), cache


def block_train(p, x, cfg, kind: str, use_moe: bool = False
                ) -> torch.Tensor:
    """One layer over the whole sequence, no cache: the training block."""
    return block_prefill(p, x, cfg, kind, 0, use_moe=use_moe)[0]


def block_decode(p, x, cache, pos, cfg, kind: str, active=None,
                 backend: Optional[str] = None, use_moe: bool = False):
    h = rmsnorm(x, p["norm1"])
    window = _window(cfg, kind)
    if kind in SSM_KINDS:
        y, cache = SSM_KINDS[kind][1](p["mix"], h, cache, cfg,
                                      active=active, backend=backend)
    elif cfg.attn_type == "mla":
        y, cache = att.mla_decode(p["mix"], h, cache, pos, cfg,
                                  active=active, backend=backend)
    else:
        y, cache = att.gqa_decode(p["mix"], h, cache, pos, cfg,
                                  active=active, backend=backend,
                                  window=window)
    return _mlp_half(p, x + y, cfg, use_moe, backend), cache


def init_block_cache(cfg, kind: str, batch: int, s_max: int, dtype, device):
    window = _window(cfg, kind)
    if kind in SSM_KINDS:
        return SSM_KINDS[kind][2](cfg, batch, dtype, device)
    if cfg.attn_type == "mla":
        return {"c": torch.zeros((batch, s_max, cfg.kv_lora), dtype=dtype,
                                 device=device),
                "k_pe": torch.zeros((batch, s_max, cfg.rope_head_dim),
                                    dtype=dtype, device=device)}
    w = min(window, s_max) or s_max
    shape = (batch, w, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
