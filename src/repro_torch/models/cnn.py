"""The paper's own evaluation networks: ResNet-style and MobileNet-v2-style
CNNs with im2col convolutions, so every conv is a plain [k*k*Cin, Cout]
matmul, exactly the tensors the paper compresses.

Checked against ``repro/models/cnn.py`` (``_im2col``, here ``im2col``,
``conv2d``,
``_depthwise``, ``_bn_apply``, ``resnet_init``/``resnet_apply``,
``mobilenet_init``/``mobilenet_apply``, ``conv_weight_matrices``,
``cnn_loss``).  Images are NHWC.  The param tree has the reference's
layout (``stem``, ``stem_bn``, ``s{s}b{i}`` or ``ir{s}``, ``fc``), so a
tree carries across by mapping its arrays (``convert.cnn_from_reference``,
``cnn_to_reference``).  The init functions draw from a numpy generator
with the reference's distributions (N(0, 1/fan_in) matrices, depthwise
taps N(0, 0.2^2), unit scales, zero shifts and biases) and return f32
numpy arrays.  A conv stays ``cols @ w`` on dense weights, as in the
reference, which scores SME weights only dequantized; the kernels run the
conv matrices through ``core.backend.sme_apply`` beside it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..tree import flatten

__all__ = ["resnet_init", "resnet_apply", "mobilenet_init",
           "mobilenet_apply", "conv_weight_matrices", "cnn_loss", "im2col",
           "conv2d"]


def im2col(x: torch.Tensor, k: int, stride: int = 1, pad: int = 1
           ) -> torch.Tensor:
    """x [B, H, W, C] -> patches [B, Ho, Wo, k*k*C] (taps row-major, the
    channels of one tap together)."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    cols = [xp[:, di:di + (ho - 1) * stride + 1:stride,
               dj:dj + (wo - 1) * stride + 1:stride]
            for di in range(k) for dj in range(k)]
    return torch.cat(cols, dim=-1)


def conv2d(x, w, k: int, stride: int = 1, pad: int = 1):
    """im2col conv: ``w`` is [k*k*Cin, Cout], an SME-compressible matrix."""
    return im2col(x, k, stride, pad) @ w.to(x.dtype)


def _bn_apply(x, p):
    # a trainable scale and shift (batch-independent, "norm-free" style)
    return x * p["g"].to(x.dtype) + p["b"].to(x.dtype)


def _bn_init(c):
    return {"g": np.ones(c, np.float32), "b": np.zeros(c, np.float32)}


def _normal(rng: np.random.Generator, shape, std=None) -> np.ndarray:
    if std is None:
        std = 1.0 / np.sqrt(max(shape[-2] if len(shape) >= 2 else shape[-1],
                                1))
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)


def _head(rng, widths, in_ch, n_classes) -> Dict[str, Any]:
    return {"stem": {"w": _normal(rng, (3 * 3 * in_ch, widths[0]))},
            "stem_bn": _bn_init(widths[0]),
            "fc": {"w": _normal(rng, (widths[-1], n_classes)),
                   "b": np.zeros(n_classes, np.float32)}}


# --------------------------------------------------------------- ResNet-18
def resnet_init(rng: np.random.Generator, widths=(32, 64, 128, 256),
                blocks=(2, 2, 2, 2), in_ch=3, n_classes=10) -> Dict[str, Any]:
    p = _head(rng, widths, in_ch, n_classes)
    c_in = widths[0]
    for s, (c, n) in enumerate(zip(widths, blocks)):
        for i in range(n):
            stride = 2 if (i == 0 and s > 0) else 1
            blk = {"conv1": {"w": _normal(rng, (3 * 3 * c_in, c))},
                   "bn1": _bn_init(c),
                   "conv2": {"w": _normal(rng, (3 * 3 * c, c))},
                   "bn2": _bn_init(c)}
            if stride != 1 or c_in != c:
                blk["proj"] = {"w": _normal(rng, (c_in, c))}
            p[f"s{s}b{i}"] = blk
            c_in = c
    return p


def resnet_apply(p, x, widths=(32, 64, 128, 256), blocks=(2, 2, 2, 2)):
    x = F.relu(_bn_apply(conv2d(x, p["stem"]["w"], 3), p["stem_bn"]))
    for s, (c, n) in enumerate(zip(widths, blocks)):
        for i in range(n):
            stride = 2 if (i == 0 and s > 0) else 1
            blk = p[f"s{s}b{i}"]
            h = F.relu(_bn_apply(conv2d(x, blk["conv1"]["w"], 3, stride),
                                 blk["bn1"]))
            h = _bn_apply(conv2d(h, blk["conv2"]["w"], 3), blk["bn2"])
            sc = x
            if "proj" in blk:
                sc = x[:, ::stride, ::stride] @ blk["proj"]["w"].to(x.dtype)
            x = F.relu(h + sc)
    x = x.mean(dim=(1, 2))
    return x @ p["fc"]["w"].to(x.dtype) + p["fc"]["b"].to(x.dtype)


# ----------------------------------------------------------- MobileNet-v2
def mobilenet_init(rng: np.random.Generator, widths=(16, 24, 40, 80),
                   expand=4, in_ch=3, n_classes=10) -> Dict[str, Any]:
    p = _head(rng, widths, in_ch, n_classes)
    c_in = widths[0]
    for s, c in enumerate(widths):
        e = c_in * expand
        p[f"ir{s}"] = {"pw1": {"w": _normal(rng, (c_in, e))},     # expand
                       "dw": {"w": _normal(rng, (3 * 3, e), 0.2)},  # taps
                       "bn": _bn_init(e),
                       "pw2": {"w": _normal(rng, (e, c))}}      # project
        c_in = c
    return p


def _depthwise(x, w, k=3, stride=1, pad=1):
    """w: [k*k, C] depthwise taps."""
    b, _, _, c = x.shape
    cols = im2col(x, k, stride, pad)                          # [B,Ho,Wo,k*k*C]
    cols = cols.reshape(b, cols.shape[1], cols.shape[2], k * k, c)
    return (cols * w.to(x.dtype)[None, None, None]).sum(3)


def mobilenet_apply(p, x, widths=(16, 24, 40, 80), expand=4):
    x = F.relu(_bn_apply(conv2d(x, p["stem"]["w"], 3), p["stem_bn"]))
    c_in = widths[0]
    for s, c in enumerate(widths):
        blk = p[f"ir{s}"]
        stride = 2 if s > 0 else 1
        h = F.relu6(x @ blk["pw1"]["w"].to(x.dtype))
        h = F.relu6(_bn_apply(_depthwise(h, blk["dw"]["w"], 3, stride),
                             blk["bn"]))
        h = h @ blk["pw2"]["w"].to(x.dtype)
        x = h if (stride != 1 or c_in != c) else x + h
        c_in = c
    x = x.mean(dim=(1, 2))
    return x @ p["fc"]["w"].to(x.dtype) + p["fc"]["b"].to(x.dtype)


def conv_weight_matrices(params) -> List[Tuple[str, np.ndarray]]:
    """Every SME-compressible 2-D weight matrix of a CNN param tree (all
    but ``fc``), named by its path, in the reference's order."""
    out = []
    for name, leaf in flatten(params).items():
        if getattr(leaf, "ndim", 0) == 2 and "fc" not in name:
            out.append((name, leaf.detach().cpu().numpy()
                        if torch.is_tensor(leaf) else np.asarray(leaf)))
    return out


def cnn_loss(apply_fn, params, images, labels):
    """Mean softmax cross-entropy of ``apply_fn(params, images)``."""
    logits = apply_fn(params, images).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return (lse - gold).mean()
