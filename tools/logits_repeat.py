#!/usr/bin/env python3
"""Repeat mixtral-8x7b's f32 prefill logits under v2 and v3 and report
every call that is not bitwise what it must be:

    python3 tools/logits_repeat.py [--budget-s 240]

The model is ``chip_smoke.py``'s (the same seeded weights, packed by its
pool; the pool goes on packing deepseek's meanwhile, as in that script)
and so is the prefill window (4 rows, 1,024 tokens).  Up to
:data:`ITERS` iterations, within the budget, each run the prefill under
v2 and then v3; the logits must be
equal between the two and equal to the same backend's first iteration.
Every linear's input and output is kept for the first iteration and the
current one, so a mismatch names the first call that parts and whether
its input already differed.  Prints one line per 25 iterations and per
mismatch, then the counts and the card's name and power limit.  Needs
one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ITERS = 400


def first_parting(a, b) -> str:
    """The first of two traces' calls whose input or output differs."""
    for i, ((xa, ya), (xb, yb)) in enumerate(zip(a, b)):
        if not torch.equal(xa, xb):
            return f"call {i} {tuple(xa.shape)}: input differs"
        if not torch.equal(ya, yb):
            import chip_smoke
            return (f"call {i} {tuple(xa.shape)}: output differs on an "
                    f"equal input ({chip_smoke.mismatch(ya, yb)})")
    return "no call differs"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget-s", type=float, default=240.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("logits_repeat: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core import backend as B
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    build.build_all()
    trace = {"on": False, "calls": []}
    for cls in (B.SpmmV2Backend, B.SpmmV3Backend):
        def traced(self, x2d, ops, param, plane_depth=None, bm=B.BM,
                   _orig=cls.matmul2d):
            y = _orig(self, x2d, ops, param, plane_depth=plane_depth, bm=bm)
            if trace["on"]:
                trace["calls"].append((x2d.clone(), y.clone()))
            return y
        cls.matmul2d = traced

    # the task seeds of chip_smoke's main
    packer = cs.Packer({key: cs.slice_tasks(key, 100000 * (i + 1))
                        for i, key in enumerate(cs.SLICE)
                        if key in ("mixtral", "deepseek")})
    try:
        cfg, params, _, _, _ = cs.slice_setup(dev, "mixtral",
                                              packer.wait("mixtral"), card)
        prompts, _ = cs.slice_workload("mixtral", cfg.vocab)
        toks, plen = cs.prefill_window(prompts, cs.SLICE_ONE_SHOT["s_max"])
        api32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                            device=dev)

        def prefill(be):
            trace["calls"], trace["on"] = [], True
            lg = api32.prefill(params, toks, s_max=cs.SLICE_ONE_SHOT["s_max"],
                               plen=plen, backend=be)[0]
            torch.cuda.synchronize()
            trace["on"] = False
            return lg, trace["calls"]
        first, bad = {}, {"v2 != v3": 0, "v2 != first": 0, "v3 != first": 0}
        t0 = time.perf_counter()
        it = 0
        for it in range(ITERS):
            now = {be: prefill(be) for be in ("v2", "v3")}
            first = first or now
            notes = []
            if not torch.equal(now["v2"][0], now["v3"][0]):
                bad["v2 != v3"] += 1
                notes.append("v2 != v3: " + first_parting(now["v2"][1],
                                                          now["v3"][1]))
            for be in ("v2", "v3"):
                if not torch.equal(now[be][0], first[be][0]):
                    bad[f"{be} != first"] += 1
                    notes.append(f"{be} != its first: " + first_parting(
                        first[be][1], now[be][1]))
            if notes or it % 25 == 0:
                print(f"iteration {it} ({time.perf_counter() - t0:.0f}s): "
                      + ("; ".join(notes) or "all equal"), flush=True)
            if time.perf_counter() - t0 > args.budget_s:
                break
    finally:
        packer.close()
    print(f"{cfg.name}: {it + 1} iterations ({2 * (it + 1)} prefills), "
          f"{sum(bad.values())} mismatches {bad} | {card}", flush=True)
    return 1 if any(bad.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
