"""Shared model building blocks on torch tensors.

Checked against ``repro/models/common.py``: ``rmsnorm``, ``layernorm``
(with its bias, eps 1e-5), ``apply_norm``, ``linear``, ``mlp_apply``
(SwiGLU, or GELU with biased ``wi``/``wo`` and no ``wg``), ``apply_rope``,
``sinusoidal_pos`` (built in float64 numpy, then f32) and
``norm_pos_active`` compute the same functions in the same dtypes.  GELU is the tanh approximation, ``jax.nn.gelu``'s default.  SME-packed weights dispatch through
``core.backend.sme_apply``; ``backend`` is passed down explicitly.  On a
serving mesh ``linear`` gathers a column-split weight's output
(``parallel.policy.constrain``); under the throughput posture (mesh
training) a split weight goes to ``parallel.policy.throughput_linear``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.backend import sme_apply
from ..parallel.policy import (constrain, throughput, throughput_linear,
                               whole_param)
from ..parallel.sharding import split_of

__all__ = ["rmsnorm", "layernorm", "apply_norm", "linear", "mlp_apply",
           "rope_freqs", "apply_rope", "sinusoidal_pos", "norm_pos_active"]


def norm_pos_active(pos, active, b: int, device):
    """``pos`` as a [B] int64 per-row position vector (a scalar
    broadcasts), ``active`` as a [B] bool mask (default all true)."""
    pos = torch.as_tensor(pos, device=device).long().expand(b)
    if active is None:
        return pos, torch.ones(b, dtype=torch.bool, device=device)
    return pos, torch.as_tensor(active, device=device).bool().expand(b)


def rmsnorm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * whole_param(p["w"]).float()).to(dt)


def layernorm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * w (+ b), in f32, cast back."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * p["w"].float()
    if "b" in p:
        y = y + p["b"].float()
    return y.to(dt)


def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    return rmsnorm(x, p) if kind == "rmsnorm" else layernorm(x, p)


def linear(x: torch.Tensor, p: dict, backend: Optional[str] = None
           ) -> torch.Tensor:
    """x @ w (+ b); SME-packed weights go through ``sme_apply``.  On a
    mesh the left operand is always whole (``constrain(x, "lhs")``, the
    reference's ``common.py:85-88``) and a column-split weight's output
    features (its bias cut the same way) are gathered over 'model'; under
    the throughput posture a column- or row-split weight computes as
    ``throughput_linear`` says."""
    we = p["w"]
    if throughput() is not None and split_of(we) is not None:
        return throughput_linear(x, we, p.get("b"))
    x = constrain(x, "lhs")
    if isinstance(we, dict):
        y = sme_apply(x, we, backend, out_dtype=x.dtype)
    else:
        y = x @ we.to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return constrain(y, "features", we)


def mlp_apply(x: torch.Tensor, p: dict, backend: Optional[str] = None,
              act: str = "swiglu") -> torch.Tensor:
    """SwiGLU MLP wo(silu(wg x) * wi x), or GELU MLP wo(gelu(wi x))."""
    if act == "swiglu":
        h = F.silu(linear(x, p["wg"], backend)) * linear(x, p["wi"], backend)
    else:
        h = F.gelu(linear(x, p["wi"], backend), approximate="tanh")
    return linear(h, p["wo"], backend)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = (positions[..., None].float() * freqs)[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def sinusoidal_pos(seq: int, d: int, device=None) -> torch.Tensor:
    """[seq, d] f32 table: sin of pos / 10000^(2i/d) in the first half,
    cos in the second, computed in float64 as the reference does; kept
    per (seq, d, device), as every decode step reads the ``s_max`` one.
    Callers must not write into it."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(emb.astype(np.float32), device=device)
