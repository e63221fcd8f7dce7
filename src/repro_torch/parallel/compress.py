"""Gradient compression with error feedback: int8 codes for a gradient
all-reduce.

Checked against ``repro/parallel/compress.py``: symmetric per-tensor int8
(``quantize_int8``: scale ``max(|g|, 1e-12) / 127``, codes rounded half
to even as ``jnp.round`` rounds, clipped to +-127), its inverse, the
error-feedback tree pair (``compress_tree`` quantizes ``g + resid`` and
keeps what the codes missed as the next residual) and ``ef_allreduce``,
which sums every rank's codes as int32 over one mesh axis, averages the
scales and divides by the axis size.  Trees are the port's (nested dicts
and lists of tensors); every result is f32 apart from the int8 codes.

``ef_allreduce`` runs over the group of :class:`~repro_torch.launch.mesh.Mesh`
``mesh`` on ``axis`` (the reference's ``axis_name`` inside ``shard_map``);
its residual is this rank's own, from its own codes.  As in the
reference, no train step calls it: the mesh step's gradient reduction
is the f32 one of its 'data' gather (``parallel.policy.gather_data``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..tree import tree_leaves, tree_map, unflatten_like

__all__ = ["quantize_int8", "dequantize_int8", "compress_tree",
           "decompress_tree", "zeros_like_resid", "ef_allreduce"]


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once: a Python divisor on a CUDA tensor is
    multiplied as its reciprocal, which may round differently."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (codes, f32 0-d scale)."""
    g32 = g.float()
    scale = _div(torch.clamp(torch.max(torch.abs(g32)), min=1e-12), 127.0)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _ef_one(g, r):
    """(codes, scale, residual) of ``g + r``."""
    corrected = g.float() + r
    q, s = quantize_int8(corrected)
    return q, s, corrected - dequantize_int8(q, s)


def compress_tree(grads, resid):
    """Error-feedback compress: q(g + resid); residual = input - deq(q).
    Returns ({"q": int8 tree, "scale": f32 tree}, new_resid)."""
    out = [_ef_one(g, r) for g, r in zip(tree_leaves(grads),
                                         tree_leaves(resid))]
    return ({"q": unflatten_like(grads, [o[0] for o in out]),
             "scale": unflatten_like(grads, [o[1] for o in out])},
            unflatten_like(grads, [o[2] for o in out]))


def decompress_tree(packed):
    return tree_map(dequantize_int8, packed["q"], packed["scale"])


def zeros_like_resid(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_allreduce(grads, resid, axis: str, mesh):
    """Error-feedback int8 all-reduce over ``mesh``'s ``axis``: (every
    rank's codes summed as int32, times the mean of the scales, over the
    axis size; this rank's new residual)."""
    n = mesh.shape[axis]

    def one(g, r):
        q, s, new_r = _ef_one(g, r)
        summed = mesh.all_reduce(q.to(torch.int32), axis)
        scale = _div(mesh.all_reduce(s, axis), n)
        return _div(summed.float() * scale, n), new_r

    out = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(resid))]
    return (unflatten_like(grads, [o[0] for o in out]),
            unflatten_like(grads, [o[1] for o in out]))
