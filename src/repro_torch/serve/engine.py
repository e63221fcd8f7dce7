"""Continuous batching over an open request stream.

Checked against ``repro/serve/engine.py`` (DESIGN.md §6, §11, §12) without
its mesh, ``bm`` override and encoder-decoder/frontend branches: the port
serves the dense decoder-only family on one device, from a param tree or
from a compiled ``.smez`` artifact (:meth:`ServeEngine.from_artifact`).

* ``slots`` sequences decode together, each with its own cache row; a
  request joins by writing its prefill cache into a free row and leaves by
  being marked free (its row parked at position 0).
* **Open stream**: :meth:`ServeEngine.submit` queues a request,
  :meth:`pump` admits queued requests into free slots (one batched,
  right-padded prefill per admission window, prompt lengths bucketed to
  powers of two, per-row ``plen``), :meth:`step` runs one engine step and
  :meth:`poll` drains the token/finish/reject/preempt events.
* **Chunked prefill**: a prompt longer than ``chunk_len`` prefills its
  first ``chunk_len`` tokens in the admission window; the rest are scored
  ``chunk_len`` per engine step inside the same ``decode_chunk`` call that
  decodes the running rows, so a long prompt never stalls decode.
* **One ``decode_chunk`` call per engine step** however mixed the batch:
  each row brings a quota (1 to decode, up to ``chunk_len`` prompt tokens,
  ``spec_len + 1`` gated positions to verify a draft) and rows past their
  quota are inactive (§6), so per-row results do not depend on the other
  rows or the scan length.  Sampling runs on the device (greedy where the
  temperature is 0, else a draw from the engine's seeded
  ``torch.Generator``); a step reads ``[K, B]`` ids and liveness back once.
* **Self-speculative decode** (``spec_depth``): greedy rows draft
  ``spec_len`` tokens with each tile group truncated to its top planes
  (``use_spec_depth``: the v3 decode kernel's ``plane_depth``), then the
  step verifies them at full precision.  Every emitted token comes from a
  full-precision step over verified context, so tokens equal the
  non-speculative run.  The draft writes its K/V in place, only at
  positions >= each row's ``pos``; attention reads positions ``<= pos``
  and every step writes its position before reading it, so no draft value
  is ever read (the reference drafts on a throwaway copy instead).
* **Prefix cache** (``prefix_cache``): at every ``chunk_len`` boundary a
  prefilling row's cache is snapshotted into refcounted device page pools
  (``serve/paged.py`` keeps the books), and a later prompt with the same
  token ids restores it instead of recomputing.
* **Preemption** of a still-prefilling row, per-request temperature,
  ``max_new_tokens`` and eos, streaming callbacks (``Request.on_token``).
* Counters, gauges and histograms live in the process registry
  (``repro_torch.obs``) under a per-engine label; :attr:`stats` and
  :meth:`run`'s dict derive from them.  The prefill and step timing
  histograms back ``stats`` and record unconditionally; the other timing
  hooks and the trace check ``obs.enabled()``.

``backend`` (None, ``"auto"``, ``"torch"``, ``"v1"``, ``"v2"``, ``"v3"``)
reaches every ``sme_apply``; ``stats["backend"]`` names what the packed
weights resolve to under it (``"dense"`` for a dense tree).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..core.backend import get_backend, resolved_backends, use_spec_depth
from ..device import resolve_device
from .paged import PageAllocator, PrefixIndex

__all__ = ["Request", "ServeEngine", "PromptTooLong"]

#: engine label values in the process registry: one per engine instance
_ENGINE_IDS = itertools.count()
#: 0..1 deciles for occupancy/fraction histograms
_FRACTION_BUCKETS = tuple(round(i / 10, 1) for i in range(1, 11))
#: kinds of engine step in ``serve_step_seconds``: a step with a
#: prefilling row, else one with a speculating row, else plain decode
STEP_KINDS = ("chunked", "spec", "decode")


class PromptTooLong(ValueError):
    """Prompt cannot fit the engine's cache ring."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [len] int
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    #: per-request opt-out of self-speculative decode; only greedy
    #: (temperature 0) rows ever speculate either way
    spec: bool = True
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: streaming hook, called as ``on_token(req, tok)`` for every token
    on_token: Optional[Callable] = None
    #: "completed" | "evicted" | "rejected" | "unserved", set when the
    #: matching ``serve_requests_total`` child is incremented
    outcome: Optional[str] = None


def _prompt_bucket(n: int, s_max: int) -> int:
    """Padded prefill length: the next power of two (>= 8), clamped to
    ``s_max``.  Results key off ``plen``, never the padded length."""
    return min(1 << max(3, (max(n, 1) - 1).bit_length()), s_max)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "0").lower() in ("1", "on", "true", "yes")


class ServeEngine:
    def __init__(self, api, params, *, slots: int = 4, s_max: int = 128,
                 seed: int = 0, backend: Optional[str] = None, device=None,
                 trace_capacity: int = 4096, spec_len: int = 0,
                 spec_depth=None, chunk_len: Optional[int] = None,
                 page_tokens: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_pages: Optional[int] = None,
                 prefix_entries: int = 8):
        """``chunk_len`` (``SME_CHUNK_LEN``, default 32) bounds the prompt
        tokens a prefilling row scores per step; ``page_tokens``
        (``SME_PAGE_TOKENS``, default 16) is the prefix-cache page size and
        ``prefix_cache`` (``SME_PREFIX_CACHE``, default off) turns the
        cache on, with ``prefix_pages`` pool pages (default ``4 *
        s_max // page_tokens``) and ``prefix_entries`` snapshots.

        ``spec_depth`` turns on self-speculative decode: an int drafts at
        that uniform plane depth, ``"plan"``/``"auto"`` at each layer's
        ``sme_draft_planes`` (full precision where absent), ``None``
        (default) disables it.  ``spec_len`` tokens are drafted per round
        (4 once a depth is set).  ``seed`` seeds the sampling generator."""
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
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.caches = api.init_cache(slots, s_max)
        self.pos = np.zeros(slots, np.int64)       # next position per slot
        self.active: List[Optional[Request]] = [None] * slots
        self.last_token = np.zeros((slots, 1), np.int64)
        self._backend_name = "+".join(resolved_backends(params, backend)) \
            or "dense"
        #: the compiler plan of an artifact boot (:meth:`from_artifact`)
        self.plan = None

        # -- continuous scheduler ---------------------------------------
        if chunk_len is None:
            chunk_len = int(os.environ.get("SME_CHUNK_LEN", "32"))
        if page_tokens is None:
            page_tokens = int(os.environ.get("SME_PAGE_TOKENS", "16"))
        if prefix_cache is None:
            prefix_cache = _env_flag("SME_PREFIX_CACHE")
        chunk_len, page_tokens = int(chunk_len), int(page_tokens)
        if chunk_len < 1:
            raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.chunk_len = chunk_len
        self.page_tokens = page_tokens
        #: per-admission one-shot prefill budget
        self._c = min(chunk_len, s_max)
        #: per-slot prompt tokens already scored (a slot is *prefilling*
        #: while this is < len(prompt): no output yet)
        self._pf_next = np.zeros(slots, np.int64)
        self._queue: collections.deque = collections.deque()
        #: bounded stream of {"kind": ...} events for :meth:`poll`
        self.events: collections.deque = collections.deque(maxlen=4096)
        self._max_pages = max(s_max // page_tokens, 1)
        self._prefix = None

        # -- self-speculative decode ------------------------------------
        if spec_depth == "auto":
            spec_depth = "plan"
        if isinstance(spec_depth, str):
            if spec_depth != "plan":
                raise ValueError(f"spec_depth must be an int >= 1, 'plan' or "
                                 f"'auto'; got {spec_depth!r}")
        elif spec_depth is not None:
            spec_depth = int(spec_depth)
            if spec_depth < 1:
                raise ValueError(f"spec_depth must be >= 1, got {spec_depth}")
        self.spec_depth = spec_depth
        self.spec_len = int(spec_len)
        if spec_depth is not None and self.spec_len <= 0:
            self.spec_len = 4

        # -- telemetry ----------------------------------------------------
        # lifetime counters double as the engine's stats, so they count
        # unconditionally; so do the prefill/step timing histograms that
        # back stats["prefill_s"/"decode_s"]
        self._eid = str(next(_ENGINE_IDS))
        R = obs.get_registry()
        eid = dict(engine=self._eid)

        def counter(name, help_):
            return R.counter(name, help_, ("engine",)).labels(**eid)

        def hist(name, help_, buckets=None):
            return R.histogram(name, help_, ("engine",),
                               buckets=buckets).labels(**eid)
        self._m_requests = R.counter(
            "serve_requests_total", "terminal request outcomes per engine",
            ("engine", "outcome"))
        self._m = {
            "prefills": counter("serve_prefills_total",
                                "batched prefill calls"),
            "prefill_reqs": counter(
                "serve_prefill_requests_total",
                "requests admitted through batched prefill"),
            "decode_steps": counter(
                "serve_decode_steps_total",
                "engine steps (one decode_chunk call each)"),
            "tokens": counter("serve_tokens_total", "decode tokens emitted"),
            "ttft": hist("serve_ttft_seconds",
                         "enqueue to first token (the prefill-sampled one)"),
            "itl": hist("serve_inter_token_seconds",
                        "per-request gap between consecutive decode tokens"),
            "qwait": hist("serve_queue_wait_seconds",
                          "enqueue to the start of the admitting prefill"),
            "occupancy": hist(
                "serve_batch_occupancy",
                "active slots / total slots, observed per decode step",
                _FRACTION_BUCKETS),
            "padded": hist(
                "serve_padded_slot_fraction",
                "free (padded) slots / total slots per decode step",
                _FRACTION_BUCKETS),
            "pad_frac": hist("serve_prefill_pad_fraction",
                             "padding fraction of each batched prefill call",
                             _FRACTION_BUCKETS),
            "prefill_s": hist("serve_prefill_seconds",
                              "wall-clock of each batched prefill call, "
                              "first tokens read back"),
            "preemptions": counter(
                "serve_preemptions_total",
                "prefilling rows bumped back to the queue"),
            "prefix_hits": counter(
                "serve_prefix_hits_total",
                "admissions served from a prefix-cache snapshot"),
            "prefix_misses": counter(
                "serve_prefix_misses_total",
                "admissions with no reusable prefix snapshot"),
            "prefix_snapshots": counter(
                "serve_prefix_snapshots_total",
                "prefix snapshots taken at chunk boundaries"),
            "prefix_evictions": counter(
                "serve_prefix_evictions_total",
                "prefix entries evicted (LRU) to free pages or slots"),
            "spec_rounds": counter("serve_spec_rounds_total",
                                   "speculative draft/verify rounds"),
            "spec_draft_tokens": counter(
                "serve_spec_draft_tokens_total",
                "tokens proposed by truncated-plane draft passes"),
            "spec_accepted": counter(
                "serve_spec_accepted_total",
                "draft tokens confirmed by full-precision verify"),
            "spec_rolled_back": counter(
                "serve_spec_rolled_back_total",
                "draft tokens discarded after verify (host bookkeeping "
                "only: a draft K/V is never read, so nothing is rewound)"),
            "spec_verify_steps": counter(
                "serve_spec_verify_steps_total",
                "full-precision verify positions scored inside spec rounds "
                "(scan steps with a live gated row)"),
            "spec_accept_frac": hist(
                "serve_spec_acceptance",
                "accepted / drafted fraction per spec row-round",
                _FRACTION_BUCKETS),
            "spec_draft_s": hist(
                "serve_spec_draft_seconds",
                "wall-clock of each draft pass (spec_len truncated steps)"),
            "spec_verify_s": hist(
                "serve_spec_verify_seconds",
                "wall-clock of the decode_chunk call of a step with spec "
                "rows"),
        }
        self._m_step_s = R.histogram(
            "serve_step_seconds",
            "wall-clock of each engine step, by kind (chunked: a prefilling "
            "row; spec: a speculating row; decode: neither)",
            ("engine", "kind"))
        self._g_queue = R.gauge("serve_queue_depth",
                                "requests waiting for admission",
                                ("engine",)).labels(**eid)
        self._g_pages = R.gauge(
            "serve_slot_pages_in_use",
            "page-granular cache working set across active slots",
            ("engine",)).labels(**eid)
        self._g_pool = R.gauge("serve_prefix_pool_pages_in_use",
                               "prefix-cache pool pages currently referenced",
                               ("engine",)).labels(**eid)
        self._g_entries = R.gauge("serve_prefix_entries",
                                  "live prefix-cache snapshots",
                                  ("engine",)).labels(**eid)
        self.tracer = obs.Tracer(capacity=trace_capacity)
        self._t_enq: Dict[int, float] = {}     # id(req) -> enqueue ts
        self._last_tok_t = np.zeros(slots)     # last token ts per slot

        if prefix_cache:
            if self._c % page_tokens:
                raise ValueError(
                    f"prefix caching needs the chunk boundary ({self._c}) "
                    f"to be a multiple of page_tokens ({page_tokens}) so "
                    f"snapshots are page-aligned")
            n_pages = int(prefix_pages) if prefix_pages \
                else 4 * self._max_pages
            # one pool of n_pages pages per k/v cache tensor (the dense
            # family's caches are all paged: [B, s_max, ...])
            self._pool = [{name: torch.zeros(
                (n_pages, page_tokens) + tuple(t.shape[2:]), dtype=t.dtype,
                device=self.device) for name, t in layer.items()}
                for layer in self.caches]
            self._prefix = PrefixIndex(PageAllocator(n_pages),
                                       int(prefix_entries), page_tokens)

    @classmethod
    def from_artifact(cls, api, path, *, verify: bool = False, **kw):
        """Boot from a compiled ``.smez`` artifact (reference
        ``ServeEngine.from_artifact``, without a mesh or ``bm``).

        ``compiler.load_artifact`` maps the payloads and checks every
        kernel operand list on the host; ``convert.from_reference`` splits
        the stacked layers and copies each leaf from the mapping to the
        engine's device, one leaf at a time (no second copy of the tree on
        the host).  ``backend`` defaults to the manifest's
        ``extra.serve_backend``.  A kernel backend the artifact holds no
        operands for is packed here, once, as is what ``auto`` takes on
        the card (v2, v1 where minifloat-6 cannot hold a layer's
        settings); each list is checked (``core.backend.ensure_operands``).
        The plan is kept as :attr:`plan`."""
        from ..compiler.artifact import load_artifact
        from ..convert import from_reference
        from ..core.backend import ensure_operands
        tree, plan, manifest = load_artifact(path, verify=verify)
        kw.setdefault("backend",
                      manifest.get("extra", {}).get("serve_backend"))
        kw.setdefault("device", api.device)
        device = resolve_device(kw["device"])
        params = from_reference(tree, device=device)
        del tree
        backend = kw["backend"]
        if backend in ("v1", "v2", "v3"):
            params = ensure_operands(params, backend)
        elif backend in (None, "auto") and device.type == "cuda":
            params = ensure_operands(params, "auto")
        eng = cls(api, params, **kw)
        eng.plan = plan
        return eng

    # ------------------------------------------------------------ telemetry
    @property
    def stats(self) -> Dict:
        """Engine-lifetime stats, derived from the registry."""
        out = {"backend": self._backend_name}
        out.update({k: int(self._m[k].value)
                    for k in ("prefills", "prefill_reqs", "decode_steps",
                              "tokens")})
        out["prefill_s"] = self._m["prefill_s"].sum
        out["decode_s"] = sum(self._step_hist(k).sum for k in STEP_KINDS)
        return out

    def _step_hist(self, kind: str):
        return self._m_step_s.labels(engine=self._eid, kind=kind)

    def step_ms(self) -> Dict[str, tuple]:
        """{kind: (steps, mean ms per step)} from ``serve_step_seconds``."""
        out = {}
        for k in STEP_KINDS:
            h = self._step_hist(k)
            out[k] = (h.count, 1e3 * h.sum / h.count if h.count else 0.0)
        return out

    def _outcome(self, req: Request, outcome: str) -> None:
        req.outcome = outcome
        self._m_requests.labels(engine=self._eid, outcome=outcome).inc()

    def _mark_enqueue(self, req: Request) -> None:
        if obs.enabled() and id(req) not in self._t_enq:
            self._t_enq[id(req)] = self.tracer.now()
            self.tracer.event("enqueue", rid=req.rid,
                              prompt_len=len(req.prompt))

    def _reject(self, req: Request) -> None:
        self._outcome(req, "rejected")
        self.tracer.event("reject", rid=req.rid, prompt_len=len(req.prompt))
        self.events.append({"kind": "reject", "rid": req.rid})
        self._t_enq.pop(id(req), None)

    def _emit(self, req: Request, slot: int, tok: int, t_tok: float,
              first: bool = False) -> None:
        """One emitted token: output list, counters (a first token observes
        ttft instead of tokens/itl), streaming callback and event."""
        req.out_tokens.append(tok)
        if not first:
            self._m["tokens"].inc()
        if req.on_token is not None:
            req.on_token(req, tok)
        self.events.append({"kind": "token", "rid": req.rid, "token": tok})
        if obs.enabled():
            if first:
                tq = self._t_enq.get(id(req))
                if tq is not None:
                    self._m["ttft"].observe(t_tok - tq)
            else:
                self._m["itl"].observe(t_tok - self._last_tok_t[slot])
            self._last_tok_t[slot] = t_tok
            self.tracer.event("token", rid=req.rid, slot=int(slot),
                              pos=int(self.pos[slot]))

    def _complete(self, req: Request) -> None:
        req.done = True
        self._outcome(req, "completed")
        self.tracer.event("finish", rid=req.rid, n_tokens=len(req.out_tokens))
        self.events.append({"kind": "finish", "rid": req.rid,
                            "outcome": "completed"})
        self._t_enq.pop(id(req), None)

    def _finish(self, req: Request, slot: int) -> None:
        self._complete(req)
        self.active[slot] = None
        # park the freed row at 0: inactive rows stay in bounds
        self.pos[slot] = 0
        self._pf_next[slot] = 0

    @staticmethod
    def _satisfied(req: Request, tok: int) -> bool:
        return (req.eos_id is not None and tok == req.eos_id) or \
            len(req.out_tokens) >= req.max_new_tokens

    # ---------------------------------------------------------------- slots
    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def _prefilling(self, i: int) -> bool:
        r = self.active[i]
        return r is not None and int(self._pf_next[i]) < len(r.prompt)

    def _check_len(self, req: Request) -> None:
        """Raise PromptTooLong when the first decoded token could not fit
        the cache ring."""
        if len(req.prompt) >= self.s_max:
            raise PromptTooLong(
                f"request {req.rid}: prompt length {len(req.prompt)} must be "
                f"< s_max={self.s_max}: the first decoded token would "
                f"overflow the cache ring")

    def add_request(self, req: Request) -> bool:
        """Admit ``req`` now.  False when no slot is free; PromptTooLong
        when the prompt cannot fit the cache ring."""
        self._mark_enqueue(req)
        try:
            self._check_len(req)
        except PromptTooLong:
            self._reject(req)
            raise
        if not self._free_slots():
            return False
        self._admit([req])
        return True

    # ---------------------------------------------------- streaming API
    def submit(self, req: Request) -> Request:
        """Enqueue on the open stream; :meth:`pump` admits it."""
        self._mark_enqueue(req)
        self._queue.append(req)
        self._g_queue.set(len(self._queue))
        return req

    def pump(self) -> int:
        """Admit every queued request the free slots allow, one admission
        window per drain; unfittable prompts are rejected.  Returns the
        number admitted."""
        admitted = 0
        while self._queue:
            free = len(self._free_slots())
            window = []
            while self._queue and len(window) < free:
                req = self._queue.popleft()
                try:
                    self._check_len(req)
                except PromptTooLong:
                    self._reject(req)
                    continue
                window.append(req)
            if not window:
                break
            self._admit(window)
            admitted += len(window)
        self._g_queue.set(len(self._queue))
        return admitted

    def poll(self) -> List[Dict]:
        """Drain the pending stream events, oldest first."""
        out = list(self.events)
        self.events.clear()
        return out

    def preempt(self, slot: int) -> bool:
        """Bump a still-prefilling row with no output back to the queue
        head; its re-prefill is deterministic, so its tokens do not change.
        False for free, decoding or already-emitting slots."""
        req = self.active[slot]
        if req is None or not self._prefilling(slot) or req.out_tokens:
            return False
        self.active[slot] = None
        self.pos[slot] = 0
        self._pf_next[slot] = 0
        self._queue.appendleft(req)
        self._m["preemptions"].inc()
        self._g_queue.set(len(self._queue))
        self.tracer.event("preempt", rid=req.rid, slot=int(slot))
        self.events.append({"kind": "preempt", "rid": req.rid})
        return True

    # ------------------------------------------------------------ admission
    def _admit(self, reqs: List[Request]) -> None:
        """One admission window: prefix-cache hits restore their snapshot;
        the rest share one padded prefill over ``min(len, chunk_len)``
        tokens each (``plen`` clamped to that).  Prompts fed whole sample
        their first token here (and may complete without a slot); longer
        ones keep their slot in the prefilling state for :meth:`step`."""
        if self._prefix is not None:
            cold = []
            for r in reqs:
                ent = self._prefix_lookup(r)
                if ent is not None:
                    self._restore_entry(r, ent)
                else:
                    cold.append(r)
            reqs = cold
            if not reqs:
                return
        tok_lens = [len(r.prompt) for r in reqs]
        feed = [min(n, self._c) for n in tok_lens]
        b = len(reqs)
        pad_to = _prompt_bucket(max(feed), self.s_max)
        toks = np.zeros((b, pad_to), np.int64)
        for i, r in enumerate(reqs):
            toks[i, :feed[i]] = r.prompt[:feed[i]]
        tr = obs.enabled()
        t_pf = self.tracer.now()
        if tr:
            for r in reqs:
                tq = self._t_enq.get(id(r))
                if tq is not None:
                    self._m["qwait"].observe(t_pf - tq)
        logits, pre = self.api.prefill(self.params, toks, s_max=self.s_max,
                                       plen=np.array(feed, np.int64),
                                       backend=self.backend)
        temps = np.array([r.temperature for r in reqs], np.float32)
        first = self._sample(logits, temps).cpu().numpy()
        t_first = self.tracer.now()
        self._m["prefill_s"].observe(t_first - t_pf)
        self._m["prefills"].inc()
        self._m["prefill_reqs"].inc(b)
        if tr:
            pad_frac = 1.0 - sum(feed) / float(b * pad_to)
            self._m["pad_frac"].observe(pad_frac)
            self.tracer.span("prefill", t_pf, n_reqs=b, pad_to=pad_to,
                             pad_fraction=round(pad_frac, 4),
                             rids=[r.rid for r in reqs])
        for i, req in enumerate(reqs):
            full_fed = feed[i] == tok_lens[i]
            if tr:
                self.tracer.event("admit", rid=req.rid, plen=feed[i],
                                  chunked=not full_fed)
            if full_fed:
                tok = int(first[i])
                req.out_tokens.append(tok)
                if req.on_token is not None:
                    req.on_token(req, tok)
                self.events.append({"kind": "token", "rid": req.rid,
                                    "token": tok})
                if tr:
                    tq = self._t_enq.get(id(req))
                    if tq is not None:
                        self._m["ttft"].observe(t_first - tq)
                if self._satisfied(req, tok):
                    self._complete(req)
                    continue
            slot = self._free_slots()[0]
            for full, row in zip(self.caches, pre):
                for name in full:
                    full[name][slot] = row[name][i]
            self.pos[slot] = feed[i]
            self._pf_next[slot] = feed[i]
            self.active[slot] = req
            self._last_tok_t[slot] = t_first
            if full_fed:
                self.last_token[slot, 0] = tok
            self._maybe_snapshot(slot, req)

    # --------------------------------------------------------------- decode
    def _dev(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray
                ) -> torch.Tensor:
        """Token ids on the device for logits ``[..., B, V]``: greedy where
        ``temps[i] == 0``, else a draw from softmax(logits / temps[i])
        with the engine's generator."""
        out = logits.argmax(dim=-1)
        hot = np.flatnonzero(temps > 0)
        if hot.size:
            idx = self._dev(hot)
            t = self._dev(temps[hot], torch.float32)[:, None]
            probs = torch.softmax(logits[..., idx, :].float() / t, dim=-1)
            drawn = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                      generator=self.gen)
            out[..., idx] = drawn.reshape(probs.shape[:-1])
        return out

    def _draft(self, spec_rows: np.ndarray) -> np.ndarray:
        """``spec_len`` greedy steps at the draft depth for ``spec_rows``
        (the other rows are inactive): ``[spec_len, B]`` ids.  Writes K/V
        in place only at positions >= each spec row's ``pos`` (never read,
        see the module note)."""
        tok = self._dev(self.last_token)
        pos = self._dev(self.pos)
        act = self._dev(spec_rows, torch.bool)
        out = []
        with use_spec_depth(self.spec_depth):
            for _ in range(self.spec_len):
                logits, self.caches = self.api.decode_step(
                    self.params, tok, self.caches, pos, act,
                    backend=self.backend)
                nxt = logits.argmax(dim=-1)
                out.append(nxt)
                tok, pos = nxt[:, None], pos + 1
        return torch.stack(out).cpu().numpy()

    def step(self) -> None:
        """One engine step for all active slots: an optional draft pass,
        then exactly **one** ``decode_chunk`` call with a per-row quota
        (1 to decode, up to ``chunk_len`` prompt tokens, ``spec_len + 1``
        gated positions to verify a draft), sampling on the device, and the
        emit/accept/retire bookkeeping."""
        act = np.array([r is not None for r in self.active])
        if not act.any():
            return
        tr = obs.enabled()
        t_step = self.tracer.now()
        d = self.spec_len
        spec_rows = np.zeros(self.slots, bool)
        dtoks = None
        if self.spec_depth is not None:
            spec_rows = self._spec_rows()
            if spec_rows.any():
                t0 = self.tracer.now()
                dtoks = self._draft(spec_rows)
                if tr:
                    self._m["spec_draft_s"].observe(self.tracer.now() - t0)
                self._m["spec_rounds"].inc()
                self._m["spec_draft_tokens"].inc(d * int(spec_rows.sum()))
        # per-row work plan, fixed before any bookkeeping mutates
        quota = np.zeros(self.slots, np.int64)
        gated = np.zeros(self.slots, bool)
        prefilling = np.zeros(self.slots, bool)
        for i, r in enumerate(self.active):
            if r is None:
                continue
            if self._prefilling(i):
                prefilling[i] = True
                quota[i] = min(len(r.prompt) - int(self._pf_next[i]),
                               self._c)
            elif spec_rows[i]:
                quota[i] = d + 1
                gated[i] = True
            else:
                quota[i] = 1
        # the scan runs max(quota) steps: results do not depend on it (§6)
        k = int(quota.max())
        toks = np.zeros((self.slots, k), np.int64)
        for i in np.flatnonzero(act):
            if prefilling[i]:
                pf = int(self._pf_next[i])
                toks[i, :quota[i]] = \
                    self.active[i].prompt[pf:pf + int(quota[i])]
            else:
                toks[i, 0] = self.last_token[i, 0]
                if gated[i]:
                    toks[i, 1:d + 1] = dtoks[:, i]
        temps = np.array([r.temperature if r is not None else 0.0
                          for r in self.active], np.float32)
        t_call = self.tracer.now()
        logits, live, self.caches = self.api.decode_chunk(
            self.params, toks, self.caches, self.pos, quota, act, gated,
            backend=self.backend)
        emitted = self._sample(logits, temps).cpu().numpy()     # [K, B]
        live = live.cpu().numpy()                               # [K, B]
        del logits
        self._m["decode_steps"].inc()
        if spec_rows.any():
            self._m["spec_verify_steps"].inc(
                int(live[:, spec_rows].any(axis=1).sum()))
            if tr:
                self._m["spec_verify_s"].observe(self.tracer.now() - t_call)
        if tr:
            occ = float(act.mean())
            self._m["occupancy"].observe(occ)
            self._m["padded"].observe(1.0 - occ)
            self._g_pages.set(int(np.sum(
                -(-self.pos[act] // self.page_tokens))))
        t_tok = self.tracer.now()
        accepted = np.zeros(self.slots, np.int64)
        for i in np.flatnonzero(act):
            req = self.active[i]
            q = int(quota[i])
            if prefilling[i]:
                self._pf_next[i] += q
                self.pos[i] += q
                self._maybe_snapshot(i, req)
                if int(self._pf_next[i]) >= len(req.prompt):
                    # the last chunk step's logits are the first-token
                    # logits: the position the one-shot path samples
                    tok = int(emitted[q - 1, i])
                    self._emit(req, i, tok, t_tok, first=True)
                    if self._satisfied(req, tok):
                        self._finish(req, i)
                    else:
                        self.last_token[i, 0] = tok
                continue
            for v in range(q):
                if not live[v, i]:
                    break
                tok = int(emitted[v, i])
                self._emit(req, i, tok, t_tok)
                self.pos[i] += 1
                self.last_token[i, 0] = tok
                matched = bool(gated[i]) and v < d and tok == int(dtoks[v, i])
                if matched:
                    accepted[i] += 1
                # pos is the next write index: retire once it passes the
                # last cache slot (the admission bound is len < s_max)
                if self._satisfied(req, tok) or self.pos[i] >= self.s_max:
                    self._finish(req, i)
                    break
                if gated[i] and not matched:
                    # the correction token is emitted; nothing to rewind
                    break
        for i in np.flatnonzero(spec_rows):
            self._m["spec_accepted"].inc(int(accepted[i]))
            self._m["spec_rolled_back"].inc(d - int(accepted[i]))
            if tr:
                self._m["spec_accept_frac"].observe(accepted[i] / d)
        kind = "chunked" if prefilling.any() else \
            "spec" if spec_rows.any() else "decode"
        self._step_hist(kind).observe(self.tracer.now() - t_step)
        if tr:
            self.tracer.span("decode_step", t_step, active=int(act.sum()),
                             slots=self.slots, chunk=k, kind=kind,
                             prefilling=int(prefilling.sum()))

    # ------------------------------------------------- speculative decode
    def _spec_rows(self) -> np.ndarray:
        """Rows that draft this round: active, fully prefilled, opted in,
        greedy, at least 2 tokens still wanted, and enough cache ring left
        for full acceptance."""
        ok = np.zeros(self.slots, bool)
        for i, r in enumerate(self.active):
            if r is None or not r.spec or r.temperature != 0.0:
                continue
            if self._prefilling(i):
                continue
            if r.max_new_tokens - len(r.out_tokens) < 2:
                continue
            if self.pos[i] + self.spec_len >= self.s_max:
                continue
            ok[i] = True
        return ok

    # ------------------------------------------------------- prefix cache
    def _prefix_lookup(self, req: Request):
        """Longest token-id-exact snapshot usable for this prompt (one
        prompt token is always left to score, for the first-token
        logits)."""
        ent = self._prefix.lookup(np.asarray(req.prompt, np.int32),
                                  len(req.prompt) - 1)
        self._m["prefix_hits" if ent is not None else
                "prefix_misses"].inc()
        return ent

    def _restore_entry(self, req: Request, ent) -> None:
        """Admit a prefix-cache hit: copy the snapshot's pages into a free
        slot and resume prefilling at ``ent.length``.  The snapshot is the
        deterministic chunk-schedule state of exactly these token ids, so
        the tokens equal a cold admission's."""
        slot = self._free_slots()[0]
        tr = obs.enabled()
        if tr:
            tq = self._t_enq.get(id(req))
            if tq is not None:
                self._m["qwait"].observe(self.tracer.now() - tq)
        n = len(ent.page_ids)
        ids = self._dev(ent.page_ids)
        P_ = self.page_tokens
        for layer, pool in zip(self.caches, self._pool):
            for name, full in layer.items():
                full[slot, :n * P_] = pool[name][ids].reshape(
                    (n * P_,) + tuple(full.shape[2:]))
        self.pos[slot] = ent.length
        self._pf_next[slot] = ent.length
        self.active[slot] = req
        self._last_tok_t[slot] = self.tracer.now()
        self.tracer.event("restore", rid=req.rid, plen=int(ent.length),
                          pages=n)

    def _maybe_snapshot(self, slot: int, req: Request) -> None:
        """Snapshot the slot's cache row at a chunk boundary (``pf_next``
        a positive multiple of the one-shot budget, page-aligned by the
        constructor check)."""
        if self._prefix is None:
            return
        L = int(self._pf_next[slot])
        if L <= 0 or L % self._c or L % self.page_tokens:
            return
        toks = np.asarray(req.prompt[:L], np.int32)
        if self._prefix.has(toks):
            return
        ev0 = self._prefix.evictions
        plan = self._prefix.prepare(toks)
        self._m["prefix_evictions"].inc(self._prefix.evictions - ev0)
        if plan is None:
            return
        n, f = len(plan.entry.page_ids), plan.first_new
        ids = self._dev(plan.entry.page_ids[f:])
        P_ = self.page_tokens
        for layer, pool in zip(self.caches, self._pool):
            for name, full in layer.items():
                pool[name][ids] = full[slot, f * P_:n * P_].reshape(
                    (n - f, P_) + tuple(full.shape[2:]))
        self._prefix.commit(plan)
        self._m["prefix_snapshots"].inc()
        self._g_pool.set(self._prefix.alloc.in_use)
        self._g_entries.set(len(self._prefix))
        self.tracer.event("snapshot", rid=req.rid, plen=L, new_pages=n - f)

    # ------------------------------------------------------------------ run
    def run(self, requests: List[Request], max_steps: int = 1000) -> Dict:
        """Drive ``requests`` to completion (or ``max_steps`` engine steps)
        through the open stream: submit all, then pump and step.  Returns
        this call's outcome split (completed / evicted / rejected /
        unserved, summing to ``len(requests)``), ``wall_s`` and
        :attr:`stats`.  Requests others queued stay queued."""
        t0 = time.perf_counter()
        mine = {id(r) for r in requests}
        for r in requests:
            self.submit(r)
        steps = 0
        while (self._queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            self.pump()
            self.step()
            steps += 1
        for r in requests:
            if r.done or r.outcome is not None:
                continue
            if r.out_tokens:
                self._outcome(r, "evicted")
                self.tracer.event("evict", rid=r.rid,
                                  n_tokens=len(r.out_tokens))
            else:
                self._outcome(r, "unserved")
            self._t_enq.pop(id(r), None)
        if self._queue:
            # drop this run's leftovers; foreign requests stay
            self._queue = collections.deque(
                q for q in self._queue if id(q) not in mine)
            self._g_queue.set(len(self._queue))
        counts = {o: 0 for o in ("completed", "evicted", "rejected",
                                 "unserved")}
        for r in requests:
            if r.outcome in counts:
                counts[r.outcome] += 1
        return {**counts, "wall_s": time.perf_counter() - t0, **self.stats}
