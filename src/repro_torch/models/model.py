"""Model API of the port: ``build_model(cfg, device)`` -> :class:`ModelAPI`.

Checked against ``repro/models/model.py`` for the decoder-only family:
``prefill(params, tokens, s_max, plen)`` -> (last logits, caches),
``decode_step(params, token, caches, pos, active)`` -> (logits, caches)
with per-row ``pos``/``active``, and ``init_cache(batch, s_max)``.  Token
and position inputs may be numpy arrays; they are moved to the model's
device.  ``backend`` picks the SME backend for packed weights (None: v3
where the weights carry v3 operands, else torch).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from . import transformer as tf

__all__ = ["ModelAPI", "build_model"]


class ModelAPI:
    def __init__(self, cfg, device=None):
        if cfg.family != "dense" or cfg.norm != "rmsnorm" \
                or cfg.act != "swiglu" or not cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: the port serves dense RMSNorm/SwiGLU models "
                f"with tied embeddings so far")
        self.cfg = cfg
        self.device = resolve_device(device)

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).long()

    def init_cache(self, batch: int, s_max: int) -> list:
        return tf.lm_init_cache(self.cfg, batch, s_max, self.device)

    def prefill(self, params, tokens, s_max: Optional[int] = None, plen=None,
                backend: Optional[str] = None):
        tokens = self._ids(tokens)
        return tf.lm_prefill(params, tokens, self.cfg,
                             s_max or tokens.shape[1],
                             plen=None if plen is None else self._ids(plen),
                             backend=backend)

    def decode_step(self, params, token, caches, pos, active=None,
                    backend: Optional[str] = None):
        if active is not None:
            active = torch.as_tensor(active, device=self.device).bool()
        return tf.lm_decode_step(params, self._ids(token), caches,
                                 self._ids(pos), self.cfg, active=active,
                                 backend=backend)


def build_model(cfg, device=None) -> ModelAPI:
    return ModelAPI(cfg, device)
