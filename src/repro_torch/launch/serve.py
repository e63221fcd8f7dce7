"""Serving driver of the port: random-weight requests through ServeEngine.

Checked against ``repro/launch/serve.py`` (a subset of its flags).  Weights
come from a numpy generator seeded by ``--seed`` (the reference init's
distributions); ``--sme`` packs every eligible weight at ``--squeeze`` and
emits the kernel operands ``--backend`` serves from: ``v1``/``v2``/``v3``
their own; ``auto`` on the card v2 when ``--squeeze >= 1`` and v1 when it
is 0 (the reference's choice on its chip), on ``--device cpu`` none, so
auto serves the dense dequant (``torch``) as the reference does off its
chip; ``torch`` none.  Runs on the card unless ``--device cpu``.  Full
width by default; ``--small`` is the 2-layer, 128-wide config the CPU
tests use.

    PYTHONPATH=src python -m repro_torch.launch.serve --sme
    PYTHONPATH=src python -m repro_torch.launch.serve --small --device cpu \\
        --sme --backend v2 --requests 3 --max-new 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHS, scale_down
from repro_torch.core.integrate import (convert_params_to_sme,
                                        sme_storage_summary, to_torch)
from repro_torch.models.model import build_model
from repro_torch.models.transformer import lm_init
from repro_torch.serve import Request, ServeEngine

#: the reduced config of the CPU tests: every linear passes the 128 floor
SMALL = dict(n_layers=2, d_model=128, d_ff=256, head_dim=32, n_heads=4,
             n_kv_heads=4, vocab=256)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--small", action="store_true",
                    help="2 layers, 128 wide, vocab 256 (CPU test size)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--s-max", type=int, default=96)
    ap.add_argument("--sme", action="store_true",
                    help="serve SME-packed weights")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "v1", "v2", "v3"])
    ap.add_argument("--squeeze", type=int, default=1,
                    help="bits squeezed out of every SME codeword")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.small:
        cfg = scale_down(cfg, **SMALL)
    api = build_model(cfg, device=args.device)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    params = lm_init(cfg, rng)
    if args.sme:
        emit = args.backend if args.backend in ("v1", "v2", "v3") else None
        if args.backend == "auto" and api.device.type == "cuda":
            # auto on the card serves through the kernels, whose operands
            # are packed offline
            emit = "v2" if args.squeeze >= 1 else "v1"
        params = convert_params_to_sme(params, squeeze=args.squeeze,
                                       backend=emit, device=args.device)
        print("SME storage:", sme_storage_summary(params))
    else:
        params = to_torch(params, args.device)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"params ready in {time.perf_counter() - t0:.1f}s on {api.device}"
          + (f", SME backend {args.backend}" if args.sme else ", dense"))
    eng = ServeEngine(api, params, slots=args.slots, s_max=args.s_max,
                      backend=args.backend if args.sme else None,
                      device=args.device)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=5 + i % 4),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    stats = eng.run(reqs, max_steps=500)
    print(f"stats: {stats}")
    for r in reqs[:4]:
        print(f"req {r.rid}: prompt={list(map(int, r.prompt))} -> "
              f"{r.out_tokens}")
    print(f"throughput: {stats['tokens'] / stats['wall_s']:.1f} tok/s on "
          f"{api.device}")
    return stats


if __name__ == "__main__":
    main()
