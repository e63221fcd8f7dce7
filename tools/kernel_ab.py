#!/usr/bin/env python3
"""Time the port's four CUDA kernels in two or more checkouts on one card,
the same way for each, so that two commits can be compared:

    python3 tools/kernel_ab.py OLD/src src src OLD/src

Each argument is a checkout's ``src`` directory.  Each runs in a child
process of its own (the two ``repro_torch`` packages cannot share one), in
the order given, so "old, new, new, old" spreads drift over both.  A child
builds that checkout's kernels into the checkout's own ``build/kernels``,
then, at qwen1.5-0.5b's three linear shapes (as ``chip_smoke.py``), times
every kernel through its wrapper with ``chip_smoke.time_ms`` (CUDA events,
L2 flushed before each launch): the launch alone and, for the kernels
whose output the backend still scales (v1, v2, v3-prefill), with that
two-launch epilogue, plus ``torch.matmul`` on the dequantized weight.  Per
model layer (4 q/k/v/o + 2 wi/wg + 1 wo calls), one JSON line per child.
The last lines give each checkout's median over its runs, the ratio of
the first checkout's to each other one's, and the card's name and power
limit.  Needs one card.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: (kernel, M) pairs timed: decode M 8 and 64, prefill 512, as chip_smoke
RUNS = (("sme_spmm_planes_decode", 8), ("sme_spmm_planes_decode", 64),
        ("sme_spmm_planes", 512), ("sme_spmm6", 8), ("sme_spmm6", 64),
        ("sme_spmm6", 512), ("sme_spmm", 8), ("sme_spmm", 64),
        ("sme_spmm", 512), ("torch.matmul", 8), ("torch.matmul", 64),
        ("torch.matmul", 512))


def child(src: str) -> dict:
    """Per-layer ms of every (kernel, M) of ``RUNS`` in checkout ``src``."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from chip_smoke import FLUSH_BYTES, SEED, SHAPES, time_ms
    from repro_torch.core.backend import get_backend
    from repro_torch.core.sme import sme_compress
    from repro_torch.kernels import build
    from repro_torch.kernels.sme_spmm.sme_spmm import sme_spmm
    from repro_torch.kernels.sme_spmm.sme_spmm6 import sme_spmm6
    from repro_torch.kernels.sme_spmm.sme_spmm_planes import sme_spmm_planes
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import \
        sme_spmm_planes_decode
    import repro_torch
    assert pathlib.Path(repro_torch.__file__).resolve().is_relative_to(
        pathlib.Path(src).resolve()), repro_torch.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(SEED)
    out = {f"{k} M={m}": {"ms": 0.0, "epi_ms": 0.0} for k, m in RUNS}
    on = lambda d, keys: [torch.as_tensor(d[k], device=dev) for k in keys]
    for _, K, N, calls in SHAPES:
        w = rng.standard_normal((K, N)) / np.sqrt(K)
        smew = sme_compress(w, n_bits=8, window=3, squeeze=1)
        a3 = on(smew.pack_plane_csc(), ("planes", "sign", "rowscale", "rowid",
                                        "shift", "last", "nnz"))
        a1 = on(smew.pack_csc(), ("codes", "sign", "rowscale", "rowid", "nnz"))
        a2 = on(get_backend("v2").pack_weight(smew),
                ("packed", "rowscale", "rowid", "nnz"))
        nt = a3[0].shape[0]
        scale = torch.full((nt * 128,), float(smew.scale.reshape(-1)[0]),
                           device=dev)
        colscale = (scale * 2.0 ** -8).reshape(nt, 128)
        w_dense = torch.as_tensor(smew.dequant(), dtype=torch.float32,
                                  device=dev)
        for kernel, m in RUNS:
            x = torch.as_tensor(rng.standard_normal((m, K)),
                                dtype=torch.float32, device=dev)
            if kernel == "sme_spmm_planes_decode":
                fn = lambda: sme_spmm_planes_decode(x, *a3[:3], colscale,
                                                    *a3[3:])
                epi = fn
            elif kernel == "torch.matmul":
                fn = epi = lambda: torch.matmul(x, w_dense)
            else:
                kern, args, qscale = {
                    "sme_spmm_planes": (sme_spmm_planes, a3, 2.0 ** -8),
                    "sme_spmm6": (sme_spmm6, a2, 2.0 ** -1),
                    "sme_spmm": (sme_spmm, a1, 2.0 ** -8)}[kernel]
                fn = lambda: kern(x, *args)
                epi = lambda: (fn() * scale * qscale)[:, :N]
            row = out[f"{kernel} M={m}"]
            row["ms"] += calls * time_ms(fn, flush, iters=20)
            row["epi_ms"] += calls * time_ms(epi, flush, iters=20)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    runs = {}
    for src in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--child", src],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(f"run {src}: {line}", flush=True)
        runs.setdefault(src, []).append(json.loads(line))
    med = {src: {key: {f: statistics.median(r[key][f] for r in rs)
                       for f in ("ms", "epi_ms")} for key in rs[0]}
           for src, rs in runs.items()}
    base, *others = list(med)
    for key in med[base]:
        cells = [f"{src}: {med[src][key]['ms']:.4f} (epi "
                 f"{med[src][key]['epi_ms']:.4f})" for src in med]
        ratios = [f"{med[base][key]['ms'] / med[o][key]['ms']:.2f}x (epi "
                  f"{med[base][key]['epi_ms'] / med[o][key]['epi_ms']:.2f}x)"
                  for o in others]
        print(f"{key:30s} ms/layer " + " | ".join(cells)
              + f" | {base} over others: " + ", ".join(ratios))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
