"""Model API of the port: ``build_model(cfg, device)`` -> :class:`ModelAPI`.

Checked against ``repro/models/model.py`` for the decoder-only dense,
MoE, SSM and hybrid families (RMSNorm, SwiGLU or GELU MLPs, MoE MLPs with
shared experts, full or sliding-window GQA or MLA layers, Mamba, mLSTM
and sLSTM layers, leading dense layers, a tied or untied head, the vision
stub's patch prefix):
``prefill(params, tokens, s_max, plen, patches=None)`` -> (last logits,
caches),
``decode_step(params, token, caches, pos, active)`` -> (logits, caches)
with per-row ``pos``/``active``, ``decode_chunk(params, tokens, caches,
pos, nvalid, active, gated)`` (``make_decode_chunk``) and
``init_cache(batch, s_max)``.  Token and position inputs may be numpy
arrays; they are moved to the model's device.  ``backend`` picks the SME
backend for packed weights (None: the first of v2, v3, v1 whose operands
the weights carry, else torch).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..device import resolve_device
from . import transformer as tf

__all__ = ["ModelAPI", "build_model", "make_decode_chunk"]


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


#: (what a config asks for, the reference module the port lacks for it)
_MISSING = (
    (lambda c: c.family == "encdec" or getattr(c, "n_enc_layers", 0),
     "the encoder-decoder family (repro/models/encdec.py)"),
    (lambda c: getattr(c, "frontend", "") not in ("", "vision_stub"),
     "the audio frontend (repro/models/encdec.py)"),
    (lambda c: c.norm != "rmsnorm", "layernorm models"),
    (lambda c: c.act not in ("swiglu", "gelu"), "MLP activations other "
     "than SwiGLU and GELU"),
)


class ModelAPI:
    def __init__(self, cfg, device=None):
        missing = [what for test, what in _MISSING if test(cfg)]
        if missing or cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise NotImplementedError(
                f"{cfg.name}: the port serves dense, MoE, SSM and hybrid "
                f"decoder-only models (RMSNorm, SwiGLU or GELU, full or "
                f"sliding-window GQA or MLA, Mamba, mLSTM and sLSTM blocks, "
                f"tied or untied head, vision patches); not yet ported: "
                f"{', '.join(missing) or 'family ' + repr(cfg.family)}")
        self.cfg = cfg
        self.device = resolve_device(device)

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).long()

    def init_cache(self, batch: int, s_max: int, device=None) -> list:
        """Zero caches, one dict per layer; ``device="meta"`` gives their
        shapes without memory (the engine's leaf probe)."""
        return tf.lm_init_cache(self.cfg, batch, s_max,
                                self.device if device is None else device)

    def prefill(self, params, tokens, s_max: Optional[int] = None, plen=None,
                backend: Optional[str] = None, patches=None):
        """``patches`` [B, n_frontend_tokens, D]: a vision model's patch
        embeddings, prepended (``plen`` and ``s_max`` count them)."""
        tokens = self._ids(tokens)
        if patches is not None:
            patches = torch.as_tensor(patches, device=self.device)
        return tf.lm_prefill(params, tokens, self.cfg,
                             s_max or tokens.shape[1],
                             plen=None if plen is None else self._ids(plen),
                             backend=backend, patches=patches)

    def decode_step(self, params, token, caches, pos, active=None,
                    backend: Optional[str] = None):
        if active is not None:
            active = torch.as_tensor(active, device=self.device).bool()
        return tf.lm_decode_step(params, self._ids(token), caches,
                                 self._ids(pos), self.cfg, active=active,
                                 backend=backend)

    def decode_chunk(self, params, tokens, caches, pos, nvalid, active=None,
                     gated=None, backend: Optional[str] = None):
        """``make_decode_chunk`` over :meth:`decode_step`; caches are
        updated in place."""
        def step(p, tok, c, ps, act):
            return self.decode_step(p, tok, c, ps, act, backend=backend)
        return make_decode_chunk(step)(params, self._ids(tokens), caches,
                                       pos, nvalid, active, gated)


def build_model(cfg, device=None) -> ModelAPI:
    return ModelAPI(cfg, device)
