"""Kernel-level wrappers: pack one :class:`SMEWeight` for a backend and run
it, without a param tree.

Checked against ``repro/kernels/sme_spmm/ops.py``.  Packing is numpy on the
host (as ``integrate``); the operands land on ``device`` (default cuda) and
the product runs through the backend's ``matmul2d``, i.e. the kernels on
the card and their plain versions on the CPU.  New code should call
``core.backend.sme_apply`` on a packed param dict instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.integrate import to_torch
from ...core.sme import SMEWeight

__all__ = ["pack_operands", "sme_linear", "sme_linear_from_weight",
           "pack_operands6", "sme_linear6_from_weight",
           "pack_operands_planes", "sme_linear_planes_from_weight"]


def _pack(name: str, smew: SMEWeight, pad_to: Optional[int], device) -> dict:
    from ...core.backend import get_backend
    ops = get_backend(name).pack_weight(smew, pad_to=pad_to)
    ops["scale"] = np.broadcast_to(smew.scale, (1, smew.shape[1])
                                   ).astype(np.float32)
    return to_torch(ops, device)


def pack_operands(smew: SMEWeight, pad_to: Optional[int] = None,
                  device=None) -> dict:
    """Tile-CSC bytecode operands (v1) and the scale row, on ``device``."""
    return _pack("v1", smew, pad_to, device)


def pack_operands6(smew: SMEWeight, pad_to: Optional[int] = None,
                   device=None) -> dict:
    """Minifloat-6 tile-CSC operands (v2: 0.75 B/weight payload)."""
    return _pack("v2", smew, pad_to, device)


def pack_operands_planes(smew: SMEWeight, pad_to: Optional[int] = None,
                         device=None) -> dict:
    """Plane-CSC operands (v3: one 1-bit bitmap per occupied plane-tile)."""
    return _pack("v3", smew, pad_to, device)


def _run(name: str, x: torch.Tensor, ops: dict, meta: dict, n: int,
         out_dtype) -> torch.Tensor:
    from ...core.backend import get_backend
    param = {"sme_scale": ops["scale"], **{k: torch.as_tensor(v)
                                          for k, v in meta.items()}}
    y = get_backend(name).matmul2d(x.reshape(-1, x.shape[-1]), ops, param)
    return y.reshape(*x.shape[:-1], n).to(out_dtype)


def sme_linear(x: torch.Tensor, ops: dict, *, n_bits: int, shape,
               out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ W_eff through the v1 backend; x: [..., K] -> [..., N]."""
    return _run("v1", x, ops, {"sme_nbits": n_bits}, shape[1], out_dtype)


def sme_linear_from_weight(x: torch.Tensor, smew: SMEWeight,
                           out_dtype=torch.float32) -> torch.Tensor:
    """Pack for v1 on x's device, then run (tests, one-shot use)."""
    return sme_linear(x, pack_operands(smew, device=x.device),
                      n_bits=smew.n_bits, shape=smew.shape,
                      out_dtype=out_dtype)


def sme_linear6_from_weight(x: torch.Tensor, smew: SMEWeight,
                            out_dtype=torch.float32) -> torch.Tensor:
    """v2 end to end: pack minifloat-6 on x's device, then run."""
    return _run("v2", x, pack_operands6(smew, device=x.device),
                {"sme_squeezed": smew.squeezed}, smew.shape[1], out_dtype)


def sme_linear_planes_from_weight(x: torch.Tensor, smew: SMEWeight,
                                  out_dtype=torch.float32) -> torch.Tensor:
    """v3 end to end: pack plane-CSC on x's device, then run."""
    return _run("v3", x, pack_operands_planes(smew, device=x.device),
                {"sme_nbits": smew.n_bits}, smew.shape[1], out_dtype)
