#!/usr/bin/env python3
"""Launch the v1, v2 and v3 prefill kernels (``tiled_walk``) once each at
mixtral-8x7b's expert K, for ``compute-sanitizer`` to check:

    compute-sanitizer --tool racecheck --error-exitcode 1 \\
        python3 tools/sanitize_prefill.py
    compute-sanitizer --tool initcheck --error-exitcode 1 \\
        python3 tools/sanitize_prefill.py

The weights are seeded Gaussians of K = 4096 (the experts' ``wi``/``wg``)
and K = 14336 (their ``wo``), cut to 256 columns (two column tiles: a
column tile's work does not depend on the others, and the sanitizers run
each launch many times slower); M = 512 rows, as a prefill window of
mixtral's smoke.  Each format's output must equal the others bitwise
after its power-of-two scaling; prints one line per shape, then the
card's name and power limit.  Needs one card.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ((4096, 256), (14336, 256))
M = 512


def main() -> int:
    if not torch.cuda.is_available():
        print("sanitize_prefill: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core.backend import get_backend
    from repro_torch.core.sme import sme_compress
    from repro_torch.kernels import build
    from repro_torch.kernels.sme_spmm.sme_spmm import sme_spmm
    from repro_torch.kernels.sme_spmm.sme_spmm6 import sme_spmm6
    from repro_torch.kernels.sme_spmm.sme_spmm_planes import sme_spmm_planes
    dev = torch.device("cuda", 0)
    build.build_all()
    bad = 0
    for k, n in SHAPES:
        rng = np.random.default_rng(k)
        smew = sme_compress(rng.standard_normal((k, n)) / np.sqrt(k))

        def on(d, names):
            return [torch.as_tensor(d[o], device=dev) for o in names]
        a1 = on(smew.pack_csc(), cs.V1_OPS)
        a2 = on(get_backend("v2").pack_weight(smew), cs.V2_OPS)
        a3 = on(smew.pack_plane_csc(), cs.V3_OPS)
        x = torch.as_tensor(rng.standard_normal((M, k)), dtype=torch.float32,
                            device=dev)
        y3 = sme_spmm_planes(x, *a3) * 2.0 ** -8
        y1 = sme_spmm(x, *a1) * 2.0 ** -8
        y2 = sme_spmm6(x, *a2) * 2.0 ** -1
        torch.cuda.synchronize()
        same = bool(torch.equal(y1, y3)) and bool(torch.equal(y2, y3))
        bad += not same
        print(f"{k}x{n} M={M}: v1, v2, v3 prefill kernels launched, "
              f"bitwise equal: {same}, finite: "
              f"{bool(torch.isfinite(y3).all())}", flush=True)
    print(cs.card_line(), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
