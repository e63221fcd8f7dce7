"""Model API of the port: ``build_model(cfg, device)`` -> :class:`ModelAPI`.

Checked against ``repro/models/model.py`` for every family of the
reference: the decoder-only dense, MoE, SSM and hybrid families
(RMSNorm, SwiGLU or GELU MLPs, MoE MLPs with shared experts, full or
sliding-window GQA or MLA layers, Mamba, mLSTM and sLSTM layers, leading
dense layers, a tied or untied head, the vision stub's patch prefix) and
the encoder-decoder family (whisper: a bidirectional encoder over the
audio stub's frames, a decoder with cross-attention, LayerNorm,
sinusoidal positions; ``build_model`` dispatches on ``n_enc_layers``, as
the reference does):
``prefill(params, tokens, s_max, plen, patches=None, frames=None)`` ->
(last logits, caches) (an enc-dec model needs ``frames`` and takes no
``plen``: its prefill is not ragged),
``decode_step(params, token, caches, pos, active, src_len=None)`` ->
(logits, caches) with per-row ``pos``/``active`` (and, enc-dec only, each
row's source length, ROADMAP R6), ``decode_chunk(params, tokens, caches,
pos, nvalid, active, gated)`` (``make_decode_chunk``) and
``init_cache(batch, s_max, src_len=None)`` and ``train_loss(params,
batch)``, the scalar training loss of a batch dict (``tokens``,
``labels``, optional ``mask``, ``patches`` or ``frames``, numpy or
torch) on dense params, differentiable by autograd (on a mesh under
the throughput posture, the decoder-only text families without a
recurrence, dense and MoE: :func:`check_mesh_training`).  Token and
position inputs may be numpy arrays; they are moved to the model's
device.  ``backend``
picks the SME backend for packed weights (None: the first of v2, v3, v1
whose operands the weights carry, else torch).  Still refused: MLP
activations other than SwiGLU and GELU, LayerNorm or the audio stub in a
decoder-only model, and families the reference does not have.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..device import resolve_device
from ..parallel.policy import throughput
from . import encdec as ed
from . import transformer as tf
from .blocks import ATTN_KINDS

__all__ = ["ModelAPI", "build_model", "init_params", "make_decode_chunk",
           "check_mesh_training"]


def check_mesh_training(cfg) -> None:
    """Raise ``ValueError`` unless ``cfg`` is of a family that trains on
    a mesh of more than one rank: the decoder-only text transformers
    without a recurrence (dense and MoE, GQA or MLA, leading dense
    layers).  The recurrent family, the encoder-decoder family and the
    vision frontend wait for ROADMAP §1, open item 1."""
    recurrent = cfg.family in ("ssm", "hybrid") or any(
        kind not in ATTN_KINDS for kind in cfg.pattern)
    what = ("the encoder-decoder family" if cfg.n_enc_layers else
            "the vision frontend" if cfg.frontend else
            "the recurrent family" if recurrent else None)
    if what is not None:
        raise ValueError(
            f"{cfg.name}: mesh training covers the decoder-only text "
            f"families (dense and MoE, GQA or MLA); {what} waits for "
            f"ROADMAP §1, open item 1 (mesh training of the recurrent, "
            f"encoder-decoder and vision families)")


def make_decode_chunk(decode_step: Callable) -> Callable:
    """Generalize a single-token ``decode_step`` to score ``k >= 1``
    positions per row in one call (DESIGN.md §12).

    ``tokens`` is ``[B, K]``; row ``i`` consumes its first ``nvalid[i]``
    tokens as consecutive decode steps from ``pos[i]`` and is an inactive
    row (no cache writes) for every later step.  ``gated`` rows also stop
    once a step's greedy argmax differs from the next input token (the
    speculative-verify rule).  Returns per-step logits ``[K, B, V]``, the
    liveness ``[K, B]`` (``live[s, i]``: step ``s`` ran for row ``i``) and
    the caches.  Each step is one ``decode_step`` over ``[B, 1]``, with dead
    rows parked at position 0, so every per-row value equals the sequential
    loop of single steps and does not depend on ``K``.  Liveness and the
    argmax stay on the device: the loop reads nothing back."""
    def decode_chunk(params, tokens, caches, pos, nvalid, active=None,
                     gated=None):
        toks = torch.as_tensor(tokens).long()
        b, k = toks.shape
        dev = toks.device
        ps = torch.as_tensor(pos, device=dev).long().expand(b)
        nv = torch.as_tensor(nvalid, device=dev).long().expand(b)
        act = torch.ones(b, dtype=torch.bool, device=dev) if active is None \
            else torch.as_tensor(active, device=dev).bool().expand(b)
        gat = torch.zeros(b, dtype=torch.bool, device=dev) if gated is None \
            else torch.as_tensor(gated, device=dev).bool().expand(b)
        live = act & (nv > 0)
        logits, lives = [], []
        for s in range(k):
            lg, caches = decode_step(params, toks[:, s:s + 1], caches,
                                     torch.where(live, ps, 0), live)
            logits.append(lg)
            lives.append(live)
            greedy = lg.argmax(dim=-1)
            ps = torch.where(live, ps + 1, ps)
            live = live & (s + 1 < nv) & (~gat | (greedy == toks[:, (s + 1)
                                                                  % k]))
        return torch.stack(logits), torch.stack(lives), caches

    return decode_chunk


#: (what a config asks for, what of it the port lacks)
_MISSING = (
    (lambda c: not c.n_enc_layers and c.norm != "rmsnorm",
     "LayerNorm in decoder-only models"),
    (lambda c: not c.n_enc_layers and c.frontend == "audio_stub",
     "the audio frontend without an encoder"),
    (lambda c: c.act not in ("swiglu", "gelu"), "MLP activations other "
     "than SwiGLU and GELU"),
)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


class ModelAPI:
    def __init__(self, cfg, device=None):
        missing = [what for test, what in _MISSING if test(cfg)]
        if missing or cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the port serves the dense, MoE, SSM and hybrid "
                f"decoder-only families (RMSNorm, SwiGLU or GELU, full or "
                f"sliding-window GQA or MLA, Mamba, mLSTM and sLSTM blocks, "
                f"tied or untied head, vision patches) and the "
                f"encoder-decoder family (audio frames, cross-attention, "
                f"LayerNorm, sinusoidal positions); not ported: "
                f"{', '.join(missing) or 'family ' + repr(cfg.family)}")
        self.cfg = cfg
        self.encdec = bool(cfg.n_enc_layers)
        self.device = resolve_device(device)

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).long()

    def train_loss(self, params, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` (the reference's
        ``train_loss``): ``tokens`` [B, S] and ``labels``, and ``mask``,
        a vision model's ``patches`` or an enc-dec model's ``frames``
        where given.  Dense params only."""
        mesh = throughput()
        if mesh is not None and mesh.size > 1:
            check_mesh_training(self.cfg)
        tokens, labels = self._ids(batch["tokens"]), self._ids(
            batch["labels"])
        opt = {k: torch.as_tensor(batch[k], device=self.device).float()
               for k in ("mask", "patches", "frames") if k in batch}
        if self.encdec:
            return ed.encdec_train_loss(params, tokens, opt["frames"],
                                        labels, self.cfg,
                                        mask=opt.get("mask"))
        return tf.lm_train_loss(params, tokens, labels, self.cfg,
                                mask=opt.get("mask"),
                                patches=opt.get("patches"))

    def init_cache(self, batch: int, s_max: int, device=None,
                   src_len: Optional[int] = None) -> list:
        """Zero caches, one dict per layer; ``device="meta"`` gives their
        shapes without memory (the engine's leaf probe).  An enc-dec
        model's cross K/V hold ``src_len`` positions (default ``s_max``,
        as in the reference)."""
        device = self.device if device is None else device
        if self.encdec:
            return ed.encdec_init_cache(self.cfg, batch, s_max,
                                        src_len or s_max, device)
        if src_len is not None:
            raise ValueError("src_len is an encoder-decoder cache size")
        return tf.lm_init_cache(self.cfg, batch, s_max, device)

    def prefill(self, params, tokens, s_max: Optional[int] = None, plen=None,
                backend: Optional[str] = None, patches=None, frames=None):
        """``patches`` [B, n_frontend_tokens, D]: a vision model's patch
        embeddings, prepended (``plen`` and ``s_max`` count them).
        ``frames`` [B, S_src, D]: an enc-dec model's audio frames (needed
        there, refused elsewhere; no ``plen``: every row is prefilled
        whole)."""
        tokens = self._ids(tokens)
        s_max = s_max or tokens.shape[1]
        if self.encdec:
            if frames is None or plen is not None or patches is not None:
                raise ValueError(
                    f"{self.cfg.name}: an encoder-decoder prefill takes "
                    f"frames, and no plen or patches (it is not ragged)")
            return ed.encdec_prefill(
                params, tokens, torch.as_tensor(frames, device=self.device),
                self.cfg, s_max, backend=backend)
        if frames is not None:
            raise ValueError(f"{self.cfg.name}: frames need an encoder")
        if patches is not None:
            patches = torch.as_tensor(patches, device=self.device)
        return tf.lm_prefill(params, tokens, self.cfg, s_max,
                             plen=None if plen is None else self._ids(plen),
                             backend=backend, patches=patches)

    def decode_step(self, params, token, caches, pos, active=None,
                    backend: Optional[str] = None, src_len=None):
        """``src_len`` [B] (enc-dec only): each row's source length; its
        cross-attention reads its first ``src_len[i]`` keys (None: all)."""
        if active is not None:
            active = torch.as_tensor(active, device=self.device).bool()
        if self.encdec:
            if src_len is not None:
                src_len = self._ids(src_len)
            return ed.encdec_decode_step(params, self._ids(token), caches,
                                         self._ids(pos), self.cfg,
                                         active=active, backend=backend,
                                         src_len=src_len)
        if src_len is not None:
            raise ValueError(f"{self.cfg.name}: src_len needs an encoder")
        return tf.lm_decode_step(params, self._ids(token), caches,
                                 self._ids(pos), self.cfg, active=active,
                                 backend=backend)

    def decode_chunk(self, params, tokens, caches, pos, nvalid, active=None,
                     gated=None, backend: Optional[str] = None,
                     src_len=None):
        """``make_decode_chunk`` over :meth:`decode_step`; caches are
        updated in place."""
        def step(p, tok, c, ps, act):
            return self.decode_step(p, tok, c, ps, act, backend=backend,
                                    src_len=src_len)
        return make_decode_chunk(step)(params, self._ids(tokens), caches,
                                       pos, nvalid, active, gated)


def build_model(cfg, device=None) -> ModelAPI:
    return ModelAPI(cfg, device)


def init_params(cfg, rng) -> dict:
    """Whole-model f32 numpy params from a ``numpy.random.Generator``, with
    the reference init's distributions (``encdec_init`` or ``lm_init``,
    by ``n_enc_layers``)."""
    return ed.encdec_init(cfg, rng) if cfg.n_enc_layers \
        else tf.lm_init(cfg, rng)
