"""Measured-timing autotune cache (DESIGN.md §8), the port's copy.

Checked against ``repro/hardware/autotune.py``: the same ``TuneKey``
encoding, JSON format and version, ``AutotuneCache`` lookups and the
process-wide active cache (``set_cache``, ``load_cache``, ``get_cache``
from ``SME_AUTOTUNE_CACHE``).  The compiler's planner reads it
(``compiler/plan.py``: ``_pick_backend`` ranks backends by measured
tokens/s, ``_candidate_cost`` prices a candidate by measured seconds per
token), so a plan made on the card ranks the kernels by their times on
the card instead of by bytes.

The device kind in every key is the card's name from
``torch.cuda.get_device_name()``, normalised as the reference normalises
its device kind (spaces to dashes, lower case), and ``"cpu"`` where no
card is visible: entries measured on a TPU, in interpret mode or on a
CPU never price a plan made for the card.  Nothing touches disk unless
``set_cache``/``load_cache`` is called or ``SME_AUTOTUNE_CACHE`` names a
path.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, Optional, Tuple

from .. import obs

__all__ = ["TuneKey", "AutotuneCache", "device_kind", "get_cache",
           "set_cache", "load_cache", "CACHE_VERSION"]

CACHE_VERSION = 1


def _obs_event(event: str) -> None:
    """Telemetry (DESIGN.md §9): cache consultation outcomes (hit/miss of
    ``best`` lookups; ``stale`` when a version-mismatched cache file is
    rejected at load)."""
    if not obs.enabled():
        return
    obs.get_registry().counter(
        "autotune_cache_total",
        "autotune cache outcomes: hit/miss on best lookups, stale on "
        "version-rejected cache files",
        ("event",)).labels(event=event).inc()


def device_kind() -> str:
    """Stable device identifier for cache keys: the card's name, spaces
    to dashes and lower case (``nvidia-h100-80gb-hbm3``), or ``"cpu"``
    where no card is visible."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name().replace(" ", "-").lower()


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """One measured configuration: backend x shape x block size x device.

    ``plane_depth`` distinguishes truncated-plane draft dispatches
    (DESIGN.md §11) from full-precision ones — a depth-k call DMAs fewer
    plane bitmaps, so its timing must never be confused with the exact
    kernel's.  0 means full precision; old cache files (no ``pd=``
    field) decode to 0, so CACHE_VERSION stays unchanged."""

    backend: str
    m: int
    k: int
    n: int
    bm: int
    device: str
    plane_depth: int = 0

    def encode(self) -> str:
        s = (f"{self.backend}|m={self.m}|k={self.k}|n={self.n}"
             f"|bm={self.bm}|dev={self.device}")
        if self.plane_depth:
            s += f"|pd={self.plane_depth}"
        return s

    @staticmethod
    def decode(s: str) -> "TuneKey":
        parts = s.split("|")
        kv = dict(p.split("=", 1) for p in parts[1:])
        return TuneKey(backend=parts[0], m=int(kv["m"]), k=int(kv["k"]),
                       n=int(kv["n"]), bm=int(kv["bm"]), device=kv["dev"],
                       plane_depth=int(kv.get("pd", 0)))


class AutotuneCache:
    """In-memory view of the measured-timing store, JSON on disk.

    ``entries`` maps ``TuneKey.encode()`` -> ``{"us_per_call": float,
    "tokens_per_s": float}``.  tokens/s is the decode currency: M rows
    per call over the measured wall time.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: Dict[str, Dict[str, float]] = {}

    # -- persistence -------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "AutotuneCache":
        cache = cls(path)
        if os.path.exists(path):
            with open(path) as f:
                doc = json.load(f)
            if doc.get("version") != CACHE_VERSION:
                _obs_event("stale")
                raise ValueError(
                    f"autotune cache {path} has version "
                    f"{doc.get('version')!r}, expected {CACHE_VERSION}")
            cache.entries = dict(doc.get("entries", {}))
        return cache

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("no path bound to this cache; pass one")
        doc = {"version": CACHE_VERSION, "entries": self.entries}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)       # atomic: readers never see a torn file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.path = path
        return path

    # -- recording / lookup ------------------------------------------------
    def record(self, key: TuneKey, us_per_call: float) -> None:
        self.entries[key.encode()] = {
            "us_per_call": float(us_per_call),
            "tokens_per_s": key.m / (float(us_per_call) * 1e-6),
        }

    def lookup(self, key: TuneKey) -> Optional[Dict[str, float]]:
        return self.entries.get(key.encode())

    def best(self, backend: str, m: int, k: int, n: int,
             device: Optional[str] = None, plane_depth: int = 0
             ) -> Optional[Tuple[int, Dict[str, float]]]:
        """Best-measured ``(bm, entry)`` for a (backend, shape) on this
        device, by max tokens/s; ``None`` when nothing was measured.
        Full-precision lookups (``plane_depth=0``, the default) never see
        truncated-draft timings and vice versa."""
        device = device or device_kind()
        hits = []
        for s, e in self.entries.items():
            key = TuneKey.decode(s)
            if (key.backend, key.m, key.k, key.n, key.device,
                    key.plane_depth) == \
                    (backend, m, k, n, device, plane_depth):
                hits.append((key.bm, e))
        if not hits:
            _obs_event("miss")
            return None
        _obs_event("hit")
        return max(hits, key=lambda h: h[1]["tokens_per_s"])

    def measured_tokens_per_s(self, backend: str, m: int, k: int, n: int,
                              device: Optional[str] = None
                              ) -> Optional[float]:
        hit = self.best(backend, m, k, n, device)
        return None if hit is None else hit[1]["tokens_per_s"]


# ------------------------------------------------------------ active cache
_ACTIVE: Optional[AutotuneCache] = None
_ENV_CHECKED = False


def set_cache(cache: Optional[AutotuneCache]) -> None:
    """Install (or clear, with ``None``) the process-wide active cache."""
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = cache
    _ENV_CHECKED = True        # explicit choice wins over the env default


def load_cache(path: str) -> AutotuneCache:
    """Load + install a cache from ``path`` in one step."""
    cache = AutotuneCache.load(path)
    set_cache(cache)
    return cache


def get_cache() -> Optional[AutotuneCache]:
    """The active cache, lazily loaded from ``SME_AUTOTUNE_CACHE`` the
    first time; ``None`` when neither is set (no surprise disk IO)."""
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        path = os.environ.get("SME_AUTOTUNE_CACHE")
        if path:
            _ACTIVE = AutotuneCache.load(path)
    return _ACTIVE
