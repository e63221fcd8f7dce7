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

With ``mesh`` (a ``launch.mesh.Mesh``) the step trains under the
throughput posture (``parallel.policy``), as the reference's step jitted
over ``param_sharding``/``batch_sharding`` does: the params and the
optimizer state are this rank's shards (``sharding.place_throughput``;
``optimizer.init`` on the shards cuts its state the same way), and each
rank takes its 'data' rows of the global batch
(``sharding.local_rows``).  At the step's start every shard is gathered
whole over 'data' with a backward (``policy.gather_data``; one gather per
leaf and step, not per layer), and each microbatch (a split of the local
rows: microbatch ``i`` is every data rank's ``i``-th chunk) differentiates
the model on those leaves, its loss this rank's masked sum over the
token count of every data rank's rows.  The summed gradients then run
the gathers' backward once, which reduce-scatters them over 'data'; the
optimizer updates only the local shards (its clip takes the whole tree's
norm, ``optim.global_norm``), and the returned loss, summed over 'data',
is identical on every rank.  The model on a mesh of more than one rank
is a decoder-only text family without a recurrence: dense or MoE (its
expert stacks expert-parallel, or expert-TP where the experts do not
divide 'model'), GQA or MLA (``models.model.check_mesh_training``); a
packed tree is refused (``transformer.dense_only``).  On the 1x1 mesh
every collective is the identity and the step is ``mesh=None``'s
bitwise.  The optimizer's ``update`` gets this rank's gradient shards,
each with its cut.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from ..models.transformer import dense_only
from ..optim.optim import Optimizer
from ..parallel.policy import (ShardPolicy, gather_data, model_split,
                               use_policy)
from ..parallel.sharding import carry_cuts, cut_of, local_rows
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


def _leaf(p: torch.Tensor) -> torch.Tensor:
    """``p`` as a new leaf that requires its gradient, carrying the 'model'
    ``Split`` of a throughput leaf."""
    t = p.detach().requires_grad_()
    if hasattr(p, "mesh_split"):
        t.mesh_split = p.mesh_split
    return t


def _value_and_grad(loss_fn, params, batch):
    leaves = [_leaf(p) for p in tree_leaves(params)]
    loss = loss_fn(unflatten_like(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (a vision model's patch_proj on a
    # text batch) has gradient 0, as under jax.grad
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), unflatten_like(params, grads)


def _accumulate(loss_fn, params, batch, microbatches: int):
    """(loss, grads) of ``loss_fn`` on ``params`` over ``batch`` split
    along dim 0 into ``microbatches`` consecutive chunks: their gradients
    summed in f32 and divided, their losses averaged (the whole batch at
    once for one)."""
    if microbatches == 1:
        return _value_and_grad(loss_fn, params, batch)
    grads, loss = None, 0.0
    for i in range(microbatches):
        mb = {k: v[i * (v.shape[0] // microbatches):
                   (i + 1) * (v.shape[0] // microbatches)]
              for k, v in batch.items()}
        l, g = _value_and_grad(loss_fn, params, mb)
        g = tree_map(lambda x: x.float(), g)
        grads = g if grads is None else tree_map(torch.add, grads, g)
        loss = loss + l
    return loss / microbatches, tree_map(lambda g: g / microbatches, grads)


def _mesh_value_and_grad(loss_fn, params, batch, microbatches, mesh):
    """(the loss summed over 'data', this rank's gradient shards) of a
    tree of throughput shards on ``mesh`` (see the module note)."""
    leaves = tree_leaves(params)
    cuts = [cut_of(p) for p in leaves]
    if mesh.size > 1 and any(c is None for c in cuts):
        raise ValueError("a mesh step takes this rank's throughput shards: "
                         "place the params with "
                         "parallel.sharding.place_throughput")
    shards = [p.detach().requires_grad_() for p in leaves]
    whole = [s if c is None else gather_data(s, c)
             for s, c in zip(shards, cuts)]
    model = [w.detach() if c is None else model_split(w.detach(), c)
             for w, c in zip(whole, cuts)]
    loss, gw = _accumulate(loss_fn, unflatten_like(params, model),
                           local_rows(mesh, batch), microbatches)
    grads = []
    # each gather's backward in leaf order: the same collectives in the
    # same order on every rank
    for s, w, g in zip(shards, whole, tree_leaves(gw)):
        grads.append(g if w is s else
                     torch.autograd.grad(w, s, g.to(w.dtype))[0])
    grads = carry_cuts(unflatten_like(params, grads), params)
    return mesh.all_reduce(loss, "data"), grads


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    microbatches: int = 1, mesh=None) -> Callable:
    """loss_fn(params, batch) -> scalar tensor.  Returns
    train_step(params, opt_state, step, batch) -> (params, opt_state,
    loss); on ``mesh`` under the throughput posture, over this rank's
    shards (see the module note)."""
    policy = None if mesh is None else ShardPolicy(
        dp=("data",), dp_size=mesh.data, model_size=mesh.model, mesh=mesh)

    def train_step(params, opt_state, step, batch):
        if mesh is None:
            loss, grads = _accumulate(loss_fn, params, batch, microbatches)
        else:
            dense_only(params)
            with use_policy(policy):
                loss, grads = _mesh_value_and_grad(loss_fn, params, batch,
                                                   microbatches, mesh)
        new_params, new_state = optimizer.update(grads, opt_state, params,
                                                 step)
        if mesh is not None:
            carry_cuts(new_params, params)
            for sub in new_state.values():
                carry_cuts(sub, params)
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
