"""Optimizers (AdamW, SGD with momentum, Lion), LR schedules, gradient
clipping.

Checked against ``repro/optim/optim.py``: functional updates over the
port's param trees (nested dicts and lists of tensors),
``update(grads, state, params, step) -> (params, state)``, with the
reference's state trees (AdamW ``{"m", "v"}``, SGD ``{"mu"}``, Lion
``{"m"}``, each of f32 tensors shaped like the params), its update order
(clip, then the moments, then the bias-corrected step) and its f32
arithmetic, so a state written by either package resumes in the other.
Not ``torch.optim``: its update order and state layout are its own.
Updates run under ``torch.no_grad`` and return new tensors; the schedules
are numpy f32 scalars of a Python step.

On a mesh (a tree of throughput shards, each carrying its
``parallel.sharding.Cut``) the updates are elementwise on the shards and
``global_norm`` is the whole tree's: each leaf's sum of squares counts
once over the ranks that hold the same part of it, and the parts' sums
are added over every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..parallel.sharding import cut_of
from ..tree import tree_leaves, tree_map

__all__ = ["adamw", "sgd", "lion", "cosine_schedule", "linear_warmup",
           "clip_by_global_norm", "global_norm", "Optimizer"]

_F = np.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple]
    """update(grads, state, params, step) -> (new_params, new_state)"""


def global_norm(grads) -> torch.Tensor:
    """The L2 norm of every leaf of ``grads`` as an f32 0-d tensor; of the
    whole tree for throughput shards (each part counted once, the sums
    added over every rank)."""
    with torch.no_grad():
        leaves = tree_leaves(grads)
        cuts = [cut_of(g) for g in leaves]
        if all(c is None for c in cuts):
            return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                  for g in leaves))
        if any(c is None for c in cuts):
            raise ValueError("a tree of throughput shards holds a leaf "
                             "without its Cut")
        # from a 0-d zero: a rank may hold no counted part
        sq = sum((torch.sum(torch.square(g.float())) for g, c in
                  zip(leaves, cuts) if c.counted()),
                 torch.zeros((), device=leaves[0].device))
        return torch.sqrt(cuts[0].mesh.all_reduce(sq, "world"))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before clipping as an f32 0-d tensor; :func:`global_norm`)."""
    with torch.no_grad():
        gn = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        return tree_map(lambda g: (g.float() * scale).to(g.dtype),
                        grads), gn


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    def lr(step):
        step = _F(step)
        warm = _F(base_lr) * min(step / _F(max(warmup, 1)), _F(1.0))
        frac = np.clip((step - _F(warmup)) / _F(max(total - warmup, 1)),
                       _F(0), _F(1))
        cos = _F(min_frac) + _F(1 - min_frac) * _F(0.5) * (
            _F(1) + np.cos(_F(np.pi) * frac))
        return warm if step < warmup else _F(base_lr) * cos
    return lr


def linear_warmup(base_lr: float, warmup: int) -> Callable:
    return lambda step: _F(base_lr) * min(_F(step) / _F(max(warmup, 1)),
                                          _F(1.0))


def _lr_fn(lr) -> Callable:
    return lr if callable(lr) else (lambda _: lr)


def _zeros(params):
    """f32 zeros shaped like each leaf, carrying a throughput shard's
    :class:`~repro_torch.parallel.sharding.Cut`."""
    def zero(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cut_of(p) is not None:
            z.mesh_cut = cut_of(p)
        return z
    return tree_map(zero, params)


def adamw(lr: Callable | float, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.0, clip_norm: Optional[float] = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        stepf = _F(step) + _F(1)
        bc1 = float(_F(1) - _F(b1) ** stepf)
        bc2 = float(_F(1) - _F(b2) ** stepf)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                     * torch.square(g.float()), state["v"], grads)
        lr_t = float(lr_fn(step))

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)


def sgd(lr: Callable | float, momentum=0.9, clip_norm=None) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"],
                      grads)
        lr_t = float(lr_fn(step))
        new = tree_map(lambda p, m: (p.float() - lr_t * m).to(p.dtype),
                       params, mu)
        return new, {"mu": mu}

    return Optimizer(init, update)


def lion(lr: Callable | float, b1=0.9, b2=0.99, weight_decay=0.0,
         clip_norm=None) -> Optimizer:
    """Lion: sign momentum, one f32 state tree (half of Adam's)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"m": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        lr_t = float(lr_fn(step))

        def upd(p, m, g):
            u = torch.sign(b1 * m + (1 - b1) * g.float())
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype)

        new = tree_map(upd, params, state["m"], grads)
        m = tree_map(lambda m_, g: b2 * m_ + (1 - b2) * g.float(),
                     state["m"], grads)
        return new, {"m": m}

    return Optimizer(init, update)
