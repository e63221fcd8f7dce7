"""Decoder-only LM: embed (with a vision prefix) -> leading dense layers ->
layers -> final norm -> tied or untied head.

Checked against ``repro/models/transformer.py`` (``lm_prefill`` with
per-row ``plen``, ``lm_decode_step`` with per-row ``pos``/``active``,
``lm_init_cache``, ``_head_logits``, ``_embed_tokens``, ``_run_first``,
``lm_init``'s distributions, and for training ``_lm_head``,
``chunked_ce_loss`` and ``lm_train_loss``).  Layers are a Python list
of per-layer param dicts (``params["blocks"][i]``) instead of the
reference's stacked scan arrays; block layer ``i`` is of kind ``cfg.pattern[i %
len(cfg.pattern)]`` (slot ``i % len(pattern)`` of superblock ``i //
len(pattern)`` in the reference's layout) and has an MoE MLP where
``cfg.moe_for_slot`` says so.  deepseek's leading dense layers keep the
reference's top-level keys ``first{i}`` and run first, each with its own
cache: the cache list is the ``first`` layers' caches, then the blocks'.
A vision model's ``patches`` [B, n_frontend_tokens, D] go through
``patch_proj`` and are prepended to the token embeddings; a packed
``patch_proj`` dispatches through ``sme_apply`` (the reference cannot
prefill one, ROADMAP R5).

Compute dtype follows ``cfg.dtype`` (bf16 or f32); params stay f32 and are
cast at use, as in the reference, except the tied head, which runs in f32
on the f32 table.  An untied ``lm_head`` that is SME-packed goes through
``sme_apply`` with f32 output (the decode pass's largest matmul); a dense
one is ``xl @ head`` in the compute dtype, then f32.  Only a tied head is
rescaled by 1/sqrt(D).  Two reference quirks are not copied (ROADMAP R2):
the reference computes in f32 whenever its params are numpy arrays,
whatever ``cfg.dtype`` says, and its caches are always bf16.

On a serving mesh (``parallel.policy``) the embedding's vocab rows may
be split over 'model': ``_embed_tokens`` selects each token's row from
its owner's part, and a split head's logits are gathered.

Training (``lm_train_loss``) runs every layer as ``blocks.block_train``
(the prefill without caches) and scores the final states through the
chunked cross-entropy: the head's logits are built one sequence chunk at
a time, each chunk under ``torch.utils.checkpoint``, so autograd keeps
no [B, S, V] logits (the reference's reason for chunking).  Training is
over dense weights: a packed (``sme_*``) leaf is refused.  Under the
throughput posture (mesh training, ``parallel.policy``) a vocab-split
head's loss is vocab-parallel: each chunk's max, sum of exponentials and
gold logit are reduced over 'model', and the loss is this rank's rows'
masked sum over the token count of every 'data' rank's rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.backend import sme_apply
from ..parallel.policy import (constrain, data_total, embed_rows,
                               enter_model, max_model, reduce_model,
                               throughput)
from ..parallel.sharding import split_of
from .blocks import (SSM_KINDS, block_decode, block_prefill, block_train,
                     init_block_cache)
from .common import linear, rmsnorm
from .ssm import mamba_dims, mlstm_dims

__all__ = ["compute_dtype", "layer_slots", "ssm_mix_spec", "ssm_leaf",
           "init_layer", "lm_init", "lm_init_cache", "lm_prefill",
           "lm_decode_step", "model_layers", "chunked_ce_loss",
           "lm_train_loss", "dense_only"]


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_slots(cfg) -> list:
    """(kind, use_moe) of every layer in cache order: the
    ``first_dense_layers`` (``attn``, dense MLP), then block layer ``i``
    of kind ``pattern[i % len(pattern)]``."""
    pat = cfg.pattern
    body = cfg.n_layers - cfg.first_dense_layers
    return [("attn", False)] * cfg.first_dense_layers + [
        (pat[i % len(pat)], cfg.moe_for_slot(i % len(pat)))
        for i in range(body)]


def model_layers(params, cfg) -> list:
    """Every layer's params in cache order: ``first{i}``, then blocks."""
    return [params[f"first{i}"] for i in range(cfg.first_dense_layers)] \
        + list(params["blocks"])


def _lin(rng, d_in, d_out, bias=False, std=None):
    w = rng.standard_normal((d_in, d_out), dtype=np.float32)
    p = {"w": w * np.float32(std if std is not None else 1.0 / np.sqrt(d_in))}
    if bias:
        p["b"] = np.zeros(d_out, np.float32)
    return p


def _normal(rng, shape, std) -> np.ndarray:
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)


def ssm_mix_spec(cfg, kind: str) -> list:
    """(leaf, shape, init, std) of a recurrent mixer's params in draw
    order, with the reference's ``mamba_init``/``mlstm_init``/
    ``slstm_init`` distributions: ``init`` is ``linear`` (a ``{"w"}``
    leaf, std 1/sqrt(fan_in) where ``std`` is None), ``normal``,
    ``zeros`` or ``ones``."""
    d = cfg.d_model
    if kind == "mamba":
        d_in, dt_rank, n = mamba_dims(cfg)
        return [("in_proj", (d, 2 * d_in), "linear", None),
                ("conv_w", (cfg.ssm_conv, d_in), "normal", 0.2),
                ("conv_b", (d_in,), "zeros", None),
                ("x_proj", (d_in, dt_rank + 2 * n), "linear", None),
                ("dt_w", (dt_rank, d_in), "linear", None),
                ("dt_bias", (d_in,), "normal", 0.1),
                ("A_log", (d_in, n), "normal", 0.5),
                ("D", (d_in,), "ones", None),
                ("out_proj", (d_in, d), "linear", None)]
    if kind == "mlstm":
        d_in, nh, dh = mlstm_dims(cfg)
        return [("up", (d, 2 * d_in), "linear", None),
                *((k, (nh, dh, dh), "normal", dh ** -0.5) for k in "qkv"),
                ("ig", (d_in, nh), "linear", 0.02),
                ("fg", (d_in, nh), "linear", 0.02),
                ("norm_w", (d_in,), "ones", None),
                ("down", (d_in, d), "linear", None)]
    nh = cfg.n_heads
    dh, f = d // nh, (4 * d) // 3
    return [("wx", (d, 4 * d), "linear", None),
            ("r", (4, nh, dh, dh), "normal", 0.5 / dh ** 0.5),
            ("b", (4, d), "zeros", None),
            ("ff_wi", (d, f), "linear", None),
            ("ff_wg", (d, f), "linear", None),
            ("ff_wo", (f, d), "linear", None)]


def ssm_leaf(rng: np.random.Generator, shape, init: str, std):
    """One leaf of :func:`ssm_mix_spec`, drawn from ``rng``."""
    if init == "linear":
        return _lin(rng, *shape, std=std)
    if init == "normal":
        return _normal(rng, shape, std)
    return (np.zeros if init == "zeros" else np.ones)(shape, np.float32)


def _ssm_mix(cfg, rng: np.random.Generator, kind: str) -> dict:
    """A recurrent mixer's f32 numpy params (:func:`ssm_mix_spec`)."""
    return {name: ssm_leaf(rng, shape, init, std)
            for name, shape, init, std in ssm_mix_spec(cfg, kind)}


def init_layer(cfg, rng: np.random.Generator, use_moe: bool = False,
               kind: str = "attn") -> dict:
    """One layer's f32 numpy params, with the reference init's
    distributions: N(0, 1/fan_in) weights (the router's std 0.02), zero
    biases, unit norms; a GELU MLP has biased ``wi``/``wo`` and no
    ``wg``; MoE experts are stacked [E, D, F] (``wo`` [E, F, D]); a
    recurrent ``kind`` takes :func:`_ssm_mix`'s mixer; no ``norm2``/``mlp``
    without an MoE or a ``d_ff``."""
    d, hd, h, kv, ff = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    if kind in SSM_KINDS:
        mix = _ssm_mix(cfg, rng, kind)
    elif cfg.attn_type == "mla":
        dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        mix = {"kv_down": _lin(rng, d, cfg.kv_lora + dr),
               "kv_up": _lin(rng, cfg.kv_lora, h * (dn + dv)),
               "o": _lin(rng, h * dv, d)}
        if cfg.q_lora:
            mix["q_down"] = _lin(rng, d, cfg.q_lora)
            mix["q_up"] = _lin(rng, cfg.q_lora, h * (dn + dr))
        else:
            mix["q"] = _lin(rng, d, h * (dn + dr))
    else:
        mix = {"q": _lin(rng, d, h * hd, cfg.qkv_bias),
               "k": _lin(rng, d, kv * hd, cfg.qkv_bias),
               "v": _lin(rng, d, kv * hd, cfg.qkv_bias),
               "o": _lin(rng, h * hd, d)}
    layer = {"norm1": {"w": np.ones(d, np.float32)}, "mix": mix}
    if use_moe:
        e, f = cfg.n_experts, cfg.expert_dff

        def stack(k, n):
            w = rng.standard_normal((e, k, n), dtype=np.float32)
            return w * np.float32(1.0 / np.sqrt(k))
        mlp = {"router": _lin(rng, d, e, std=0.02), "wi": stack(d, f),
               "wg": stack(d, f), "wo": stack(f, d)}
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            mlp["shared"] = {"wi": _lin(rng, d, fs), "wg": _lin(rng, d, fs),
                             "wo": _lin(rng, fs, d)}
    elif not ff:
        return layer
    elif cfg.act == "swiglu":
        mlp = {"wi": _lin(rng, d, ff), "wg": _lin(rng, d, ff),
               "wo": _lin(rng, ff, d)}
    else:
        mlp = {"wi": _lin(rng, d, ff, True), "wo": _lin(rng, ff, d, True)}
    return {**layer, "norm2": {"w": np.ones(d, np.float32)}, "mlp": mlp}


def lm_init(cfg, rng: np.random.Generator) -> dict:
    """Whole-model f32 numpy params (embed ~ N(0, 1); the leading dense
    layers, the block layers, then an untied ``lm_head`` [D, V] ~ N(0,
    0.02^2) and a vision model's ``patch_proj`` [D, D])."""
    params = {
        "embed": {"w": rng.standard_normal((cfg.vocab, cfg.d_model),
                                           dtype=np.float32)},
        "final_norm": {"w": np.ones(cfg.d_model, np.float32)},
    }
    slots = layer_slots(cfg)
    nf = cfg.first_dense_layers
    for i in range(nf):
        params[f"first{i}"] = init_layer(cfg, rng)
    params["blocks"] = [init_layer(cfg, rng, moe, kind)
                        for kind, moe in slots[nf:]]
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": rng.standard_normal(
            (cfg.d_model, cfg.vocab), dtype=np.float32) * np.float32(0.02)}
    if cfg.frontend == "vision_stub":
        params["patch_proj"] = _lin(rng, cfg.d_model, cfg.d_model)
    return params


def lm_init_cache(cfg, batch: int, s_max: int, device) -> list:
    return [init_block_cache(cfg, kind, batch, s_max, compute_dtype(cfg),
                             device) for kind, _ in layer_slots(cfg)]


def _embed_tokens(params, cfg, tokens: torch.Tensor,
                  patches: Optional[torch.Tensor] = None,
                  backend: Optional[str] = None) -> torch.Tensor:
    """Gather the rows first, then cast: only B x S rows, never the whole
    [V, D] table, go to the compute dtype.  ``patches`` [B, F, D] (a
    vision model's) go through ``patch_proj`` and come first."""
    dt = compute_dtype(cfg)
    x = embed_rows(params["embed"]["w"], tokens).to(dt)
    if cfg.frontend == "vision_stub" and patches is not None:
        x = torch.cat([linear(patches.to(dt), params["patch_proj"],
                              backend), x], dim=1)
    return x * (cfg.d_model ** 0.5)


def _head_logits(params, cfg, xl: torch.Tensor,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Final projection xl [B, D] -> f32 logits [B, V].  A tied head is
    rescaled by 1/sqrt(D) to undo the input scaling: one dense f32 matmul
    on the f32 table, with the scale applied to ``xl`` (no copy of the
    [V, D] table per pass; the reference scales and casts the whole table
    instead, in f32 for numpy params, ROADMAP R2).  An untied head is not
    rescaled: packed, it dispatches through ``sme_apply``; dense, it is
    ``xl @ head`` in the compute dtype.  On a mesh a vocab-split table or
    head gives this rank's logits, gathered over 'model'."""
    if cfg.tie_embeddings:
        table = params["embed"]["w"]
        return constrain((xl.float() * (cfg.d_model ** -0.5)) @ table.T,
                         "features", table)
    we = params["lm_head"]["w"]
    if isinstance(we, dict):
        y = sme_apply(xl, we, backend, out_dtype=torch.float32)
    else:
        y = (xl @ we.to(xl.dtype)).float()
    return constrain(y, "features", we)


def lm_prefill(params, tokens: torch.Tensor, cfg, s_max: int, plen=None,
               backend: Optional[str] = None,
               patches: Optional[torch.Tensor] = None):
    """tokens [B, S] (after ``patches`` [B, F, D] for a vision model) ->
    (logits [B, V] at each row's last valid position, per-layer caches
    over ``s_max`` slots).  ``plen`` [B] marks each row's valid prefix of
    a right-padded batch, frontend tokens included."""
    x = constrain(_embed_tokens(params, cfg, tokens, patches, backend), "act")
    caches = []
    for p, (kind, moe) in zip(model_layers(params, cfg), layer_slots(cfg)):
        x, c = block_prefill(p, x, cfg, kind, s_max, plen=plen,
                             backend=backend, use_moe=moe)
        x = constrain(x, "act")
        caches.append(c)
    x = rmsnorm(x, params["final_norm"])
    if plen is None:
        xl = x[:, -1]
    else:
        last = (torch.as_tensor(plen, device=x.device).long() - 1
                ).clamp(0, x.shape[1] - 1)
        xl = x[torch.arange(x.shape[0], device=x.device), last]
    return _head_logits(params, cfg, xl, backend), caches


def lm_decode_step(params, token: torch.Tensor, caches: list, pos, cfg,
                   active=None, backend: Optional[str] = None):
    """token [B, 1]; pos [B] per-row next position; active [B] rows that
    may write their cache slot.  Caches are updated in place."""
    x = constrain(_embed_tokens(params, cfg, token), "act")
    new = []
    for p, c, (kind, moe) in zip(model_layers(params, cfg), caches,
                                 layer_slots(cfg)):
        x, c = block_decode(p, x, c, pos, cfg, kind, active=active,
                            backend=backend, use_moe=moe)
        x = constrain(x, "act")
        new.append(c)
    x = rmsnorm(x, params["final_norm"])
    return _head_logits(params, cfg, x[:, -1], backend), new


def dense_only(params, path: str = "") -> None:
    """Raise ``ValueError`` at the first SME-packed leaf of ``params``:
    training differentiates dense weights, as in the reference."""
    if isinstance(params, dict):
        if "sme_codes" in params:
            raise ValueError(
                f"train_loss takes dense weights; {path or 'the tree'} is "
                f"SME-packed (train on the dense tree, then compile it)")
        for k, v in params.items():
            dense_only(v, f"{path}/{k}" if path else str(k))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            dense_only(v, f"{path}/{i}")


def _lm_head(params, cfg):
    """(The training head [D, V]: the tied table's transpose rescaled by
    1/sqrt(D) (in f32, as the reference does), or the untied head; the
    first vocab column this rank holds, or None when the vocab is
    whole)."""
    w = params["embed"]["w"] if cfg.tie_embeddings else \
        params["lm_head"]["w"]
    sp = split_of(w)
    start = None if sp is None else sp.start
    if cfg.tie_embeddings:
        return w.T * (cfg.d_model ** -0.5), start
    return w, start


def _ce_chunk(hx, head_w, lx, mx):
    logits = (hx @ head_w.to(hx.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lx[..., None])[..., 0]
    return ((lse - gold) * mx).sum()


def _ce_chunk_split(hx, head_w, lx, mx, start: int, mesh):
    """``_ce_chunk`` over this rank's vocab columns [start, start + n) of
    a vocab-split head: the max, the sum of exponentials and the gold
    logit reduced over ``mesh``'s 'model' axis (named here: a recomputed
    chunk runs in the backward's thread, which sees no policy)."""
    logits = (hx @ head_w.to(hx.dtype)).float()
    n = logits.shape[-1]
    top = max_model(logits.amax(dim=-1), mesh)
    lse = top + torch.log(reduce_model(
        torch.exp(logits - top[..., None]).sum(dim=-1), mesh))
    own = (lx >= start) & (lx < start + n)
    gold = torch.gather(logits, -1, (lx - start).clamp(0, n - 1)[..., None]
                        )[..., 0]
    gold = reduce_model(torch.where(own, gold, torch.zeros_like(gold)),
                        mesh)
    return ((lse - gold) * mx).sum()


def chunked_ce_loss(h, head_w, labels, mask, chunk: int = 128,
                    vocab_start: Optional[int] = None):
    """h [B, S, D] -> the mean cross-entropy over ``mask``, the logits of
    one ``chunk`` of positions at a time (recomputed in the backward).
    ``vocab_start``: the first vocab column of a vocab-split ``head_w``
    (throughput posture), whose loss is vocab-parallel.  Under the
    throughput posture the count is every 'data' rank's."""
    s = h.shape[1]
    chunk = min(chunk, s)
    remat = torch.is_grad_enabled() and (h.requires_grad
                                         or head_w.requires_grad)
    fn, extra = _ce_chunk, ()
    if vocab_start is not None:
        h, fn = enter_model(h), _ce_chunk_split
        extra = (vocab_start, throughput())
    tot = cnt = 0
    for c0 in range(0, s, chunk):
        args = (h[:, c0:c0 + chunk], head_w, labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk]) + extra
        tot = tot + (checkpoint(fn, *args, use_reentrant=False)
                     if remat else fn(*args))
        cnt = cnt + args[3].sum()
    return tot / torch.clamp(data_total(cnt), min=1.0)


def lm_train_loss(params, tokens: torch.Tensor, labels: torch.Tensor, cfg,
                  mask: Optional[torch.Tensor] = None,
                  patches: Optional[torch.Tensor] = None,
                  loss_chunk: int = 128) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens [B, S] (after ``patches``
    [B, F, D] for a vision model) against ``labels`` [B, L]; where the
    states outnumber the labels (a vision prefix), the last L score."""
    dense_only(params)
    x = _embed_tokens(params, cfg, tokens, patches)
    for p, (kind, moe) in zip(model_layers(params, cfg), layer_slots(cfg)):
        x = block_train(p, x, cfg, kind, use_moe=moe)
    x = rmsnorm(x, params["final_norm"])
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    if x.shape[1] != labels.shape[1]:
        x = x[:, x.shape[1] - labels.shape[1]:]
    head_w, start = _lm_head(params, cfg)
    return chunked_ce_loss(x, head_w, labels, mask, loss_chunk,
                           start if throughput() is not None else None)
