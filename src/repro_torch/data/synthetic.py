"""Deterministic synthetic data: token streams for LM training and a
procedural 10-class image task for the paper's CNN experiments.

The LM stream is a learnable Markov-ish source (not uniform noise): each
batch's next-token distribution depends on the previous token through a
fixed random transition table, so cross-entropy has real signal and the
end-to-end examples show a decreasing loss.

A copy of ``repro/data/synthetic.py`` (numpy only);
``tests/test_torch_data.py`` holds its arrays bitwise to the reference's
for the same seeds.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["lm_batches", "markov_table", "image_task", "token_stats"]


def markov_table(vocab: int, branch: int = 16, seed: int = 0) -> np.ndarray:
    """[vocab, branch] allowed successors per token."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branch), dtype=np.int32)


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               table: Optional[np.ndarray] = None,
               frontend: Optional[Dict] = None) -> Iterator[Dict]:
    """Infinite iterator of {tokens, labels} (+ stub frontend inputs)."""
    table = table if table is not None else markov_table(vocab, seed=seed)
    branch = table.shape[1]
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = np.empty((batch, seq + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=batch)
        choice = rng.integers(0, branch, size=(batch, seq))
        for t in range(seq):
            toks[:, t + 1] = table[toks[:, t], choice[:, t]]
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if frontend:
            kind = frontend["kind"]
            if kind == "vision_stub":
                out["patches"] = rng.standard_normal(
                    (batch, frontend["n"], frontend["d"])).astype(np.float32)
                # text tokens exclude the patch positions; labels cover all
                n = frontend["n"]
                out["tokens"] = out["tokens"][:, : seq - n]
            elif kind == "audio_stub":
                out["frames"] = rng.standard_normal(
                    (batch, frontend["src"], frontend["d"])).astype(np.float32)
        yield out


def image_task(n: int, size: int = 16, n_classes: int = 10,
               seed: int = 0, template_seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural 10-class images: class templates + noise (learnable to
    ~100% by a small CNN; stands in for ImageNet in the paper tables).

    Templates are seeded separately so train/test splits (different
    ``seed``) share the same classes."""
    t_rng = np.random.default_rng(template_seed)
    templates = t_rng.standard_normal((n_classes, size, size, 3)) * 1.5
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, n_classes, size=n)
    imgs = templates[labels] + rng.standard_normal((n, size, size, 3))
    return imgs.astype(np.float32), labels.astype(np.int32)


def token_stats(it: Iterator[Dict], batches: int = 2) -> Dict[str, float]:
    seen = []
    for _ in range(batches):
        seen.append(next(it)["tokens"])
    t = np.concatenate([s.ravel() for s in seen])
    return {"mean": float(t.mean()), "unique_frac": len(np.unique(t)) / t.size}
