"""Batched greedy serving over a fixed set of cache slots.

Checked against ``repro/serve/engine.py``, a subset of it: ``Request`` and
``ServeEngine(api, params, slots, s_max, backend, device)``.

* ``slots`` sequences decode together, each with its own cache row; a
  request joins by writing its prefill cache into a free row and leaves by
  being marked free.
* **Prefill is batched per admission window**: every request admitted at
  once shares one right-padded prefill call; prompt lengths are bucketed
  to powers of two (>= 8, at most ``s_max``) and the per-row ``plen`` keeps
  each row equal to a prefill of that request alone.
* Each engine step is one ``decode_step`` over all slots with per-row
  ``pos`` and an ``active`` mask; free rows are parked at position 0 and
  never write their cache.
* Sampling is greedy.  A prompt must be shorter than ``s_max`` (the first
  decoded token needs a cache slot); longer ones are rejected.
* ``backend`` (None, ``"auto"``, ``"torch"``, ``"v1"``, ``"v2"``, ``"v3"``)
  reaches every ``sme_apply`` unchanged; ``stats["backend"]`` names what
  the packed weights resolve to under it (``"dense"`` for a dense tree,
  names joined by ``+`` where layers differ).

Not ported yet (ROADMAP): chunked prefill, prefix cache, speculative
decode, streaming submit/poll, preemption, telemetry, mesh, artifacts.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.backend import get_backend, resolved_backends
from ..device import resolve_device

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [len] int
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: "completed" | "rejected" | "evicted" | "unserved"
    outcome: Optional[str] = None


def _prompt_bucket(n: int, s_max: int) -> int:
    """Padded prefill length: the next power of two (>= 8), clamped to
    ``s_max``.  Results key off ``plen``, never the padded length."""
    return min(1 << max(3, (max(n, 1) - 1).bit_length()), s_max)


class ServeEngine:
    def __init__(self, api, params, *, slots: int = 4, s_max: int = 128,
                 backend: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        if backend not in (None, "auto"):
            get_backend(backend)                # unknown names raise here
        if api.device != self.device:
            raise ValueError(f"model on {api.device}, engine on {self.device}")
        self.api = api
        self.params = params
        self.slots = slots
        self.s_max = s_max
        self.backend = backend
        self.caches = api.init_cache(slots, s_max)
        self.pos = np.zeros(slots, np.int64)       # next position per slot
        self.active: List[Optional[Request]] = [None] * slots
        self.last_token = np.zeros((slots, 1), np.int64)
        self.stats = {"backend": "+".join(resolved_backends(params, backend))
                      or "dense", "prefills": 0, "decode_steps": 0,
                      "tokens": 0, "prefill_s": 0.0, "decode_s": 0.0}

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def _finish(self, req: Request, slot: Optional[int]) -> None:
        req.done = True
        req.outcome = "completed"
        if slot is not None:
            self.active[slot] = None
            self.pos[slot] = 0

    def _satisfied(self, req: Request, tok: int) -> bool:
        return (req.eos_id is not None and tok == req.eos_id) or \
            len(req.out_tokens) >= req.max_new_tokens

    def _admit(self, reqs: List[Request]) -> None:
        """One admission window: a single padded prefill call, greedy first
        tokens, and a cache-row write for every request still running."""
        plens = np.array([len(r.prompt) for r in reqs], np.int64)
        toks = np.zeros((len(reqs), _prompt_bucket(int(plens.max()),
                                                   self.s_max)), np.int64)
        for i, r in enumerate(reqs):
            toks[i, :plens[i]] = r.prompt
        t0 = time.perf_counter()
        logits, pre = self.api.prefill(self.params, toks, s_max=self.s_max,
                                       plen=plens, backend=self.backend)
        first = logits.argmax(dim=-1).cpu().numpy()
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefills"] += 1
        for i, req in enumerate(reqs):
            tok = int(first[i])
            req.out_tokens.append(tok)
            if self._satisfied(req, tok):
                self._finish(req, None)
                continue
            slot = self._free_slots()[0]
            for full, row in zip(self.caches, pre):
                for name in full:
                    full[name][slot] = row[name][i]
            self.pos[slot] = plens[i]
            self.last_token[slot, 0] = tok
            self.active[slot] = req

    def step(self) -> None:
        """One decode step for all slots: one ``decode_step`` call."""
        act = np.array([r is not None for r in self.active])
        if not act.any():
            return
        t0 = time.perf_counter()
        logits, self.caches = self.api.decode_step(
            self.params, self.last_token, self.caches,
            np.where(act, self.pos, 0), act, backend=self.backend)
        toks = logits.argmax(dim=-1).cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        for i in np.flatnonzero(act):
            req, tok = self.active[i], int(toks[i])
            req.out_tokens.append(tok)
            self.stats["tokens"] += 1
            self.pos[i] += 1
            self.last_token[i, 0] = tok
            # pos is the next write index: retire past the last cache slot
            if self._satisfied(req, tok) or self.pos[i] >= self.s_max:
                self._finish(req, i)

    def run(self, requests: List[Request], max_steps: int = 1000) -> Dict:
        """Serve ``requests`` to completion or ``max_steps`` engine steps.
        Returns the outcome counts (completed / rejected / evicted /
        unserved, summing to ``len(requests)``) and the engine stats."""
        t0 = time.perf_counter()
        queue = collections.deque(requests)
        steps = 0
        while (queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            while queue:
                free = len(self._free_slots())
                window = []
                while queue and len(window) < free:
                    req = queue.popleft()
                    if len(req.prompt) >= self.s_max:
                        req.outcome = "rejected"
                    else:
                        window.append(req)
                if not window:
                    break
                self._admit(window)
            self.step()
            steps += 1
        for r in requests:
            if r.outcome is None:
                r.outcome = "evicted" if r.out_tokens else "unserved"
        counts = collections.Counter(r.outcome for r in requests)
        return {**{o: counts[o] for o in
                   ("completed", "rejected", "evicted", "unserved")},
                **self.stats, "wall_s": time.perf_counter() - t0}
