"""Training loop: the microbatched (gradient-accumulation) train step.

Checked against ``repro/train/loop.py`` (``pick_microbatches``,
``make_train_step``, ``train_loop``).  The gradient is autograd's
(``torch.autograd.grad`` of ``loss_fn``) over every param leaf; with
``microbatches`` > 1 the batch is split along dim 0 into that many
consecutive chunks, their gradients summed in f32 and divided, and their
losses averaged, as the reference's scan does.  The optimizer update is
functional (``repro_torch.optim``), so each step returns new params and
state.  Batches may stay numpy: the loss function moves them to its
device.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from ..optim.optim import Optimizer
from ..tree import tree_leaves, tree_map, unflatten_like

__all__ = ["pick_microbatches", "make_train_step", "train_loop"]


def pick_microbatches(cfg, shape, dp_size: int,
                      budget_bytes: float = 160e6) -> int:
    """Largest power-of-2 split keeping per-microbatch activations under
    ``budget_bytes`` per device (bf16 [tokens, d_model], MoE-inflated)."""
    b_loc = max(shape.global_batch // max(dp_size, 1), 1)
    moe_f = 1.0 + (cfg.top_k / 2.0 if cfg.n_experts else 0.0)
    # recurrent-state families carry O(B * dh^2) chunk states for backward
    if any(k in ("mlstm", "slstm") for k in cfg.pattern):
        moe_f *= 2.0
    footprint = b_loc * shape.seq_len * cfg.d_model * 2.0 * moe_f
    micro = 1
    while footprint / micro > budget_bytes and micro < b_loc:
        micro *= 2
    return micro


def _value_and_grad(loss_fn, params, batch):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(unflatten_like(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (a vision model's patch_proj on a
    # text batch) has gradient 0, as under jax.grad
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), unflatten_like(params, grads)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    microbatches: int = 1) -> Callable:
    """loss_fn(params, batch) -> scalar tensor.  Returns
    train_step(params, opt_state, step, batch) -> (params, opt_state,
    loss)."""

    def train_step(params, opt_state, step, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            grads, loss = None, 0.0
            for i in range(microbatches):
                mb = {k: v[i * (v.shape[0] // microbatches):
                           (i + 1) * (v.shape[0] // microbatches)]
                      for k, v in batch.items()}
                l, g = _value_and_grad(loss_fn, params, mb)
                g = tree_map(lambda x: x.float(), g)
                grads = g if grads is None else tree_map(
                    torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
        new_params, new_state = optimizer.update(grads, opt_state, params,
                                                 step)
        return new_params, new_state, loss

    return train_step


def train_loop(api, params, optimizer: Optimizer, data_iter, n_steps: int,
               *, microbatches: int = 1, log_every: int = 10,
               hooks: Optional[list] = None) -> Dict[str, Any]:
    """Single-process training loop over ``api.train_loss``; returns
    {params, opt_state, history: [(step, loss)]}."""
    step_fn = make_train_step(api.train_loss, optimizer, microbatches)
    opt_state = optimizer.init(params)
    history = []
    t0 = time.time()
    for i in range(n_steps):
        params, opt_state, loss = step_fn(params, opt_state, i,
                                          next(data_iter))
        if i % log_every == 0 or i == n_steps - 1:
            l = float(loss)
            history.append((i, l))
            print(f"step {i:5d} loss {l:.4f} ({time.time() - t0:.1f}s)")
        for h in (hooks or []):
            h(i, params, opt_state, loss)
    return {"params": params, "opt_state": opt_state, "history": history}
