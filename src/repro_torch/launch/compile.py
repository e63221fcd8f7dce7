"""Offline model compiler CLI: plan -> reorder -> pack -> ``.smez``.

Checked against ``repro/launch/compile.py`` (its flags but ``--ckpt``:
restoring a training checkpoint waits for the port's training).  The
weights are the port's ``lm_init`` from a numpy generator seeded by
``--seed``, put into the reference's layout (``convert.to_reference``:
every layer's leaf stacked), which the planner plans one leaf at a time,
as the reference does.  Full width by default; ``--small`` is the
2-layer, 128-wide config of the CPU tests; ``--d-model``/``--d-ff``/
``--head-dim``/``--vocab`` scale the config down as the reference's
flags do.  Compiling runs on the host (numpy); no card is needed.

    PYTHONPATH=src python -m repro_torch.launch.compile --small \\
        --out build/small.smez [--budget 0.06] \\
        [--backend auto|v1|v2|v3|none] [--no-reorder] [--verify]

The artifact then boots serving with zero per-boot packing:

    PYTHONPATH=src python -m repro_torch.launch.serve --small \\
        --device cpu --artifact build/small.smez
"""
from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np

from repro_torch.configs import ARCHS, scale_down

#: the reduced config of the CPU tests: every linear passes the 128 floor
SMALL = dict(n_layers=2, d_model=128, d_ff=256, head_dim=32, n_heads=4,
             n_kv_heads=4, vocab=256)


def add_scale_args(ap: argparse.ArgumentParser) -> None:
    """Size flags shared by compile and serve, so artifacts match the
    model."""
    ap.add_argument("--small", action="store_true",
                    help="2 layers, 128 wide, vocab 256 (CPU test size)")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--d-ff", type=int, default=None)
    ap.add_argument("--head-dim", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)


def scaled_config(args):
    """``--arch`` at full width, or scaled down: ``--small``, or any dim
    override (the reference's ``scale_down`` with those dims)."""
    over = {k: getattr(args, k) for k in ("d_model", "d_ff", "head_dim",
                                          "vocab")
            if getattr(args, k) is not None}
    cfg = ARCHS[args.arch]
    if args.small or over:
        cfg = scale_down(cfg, **{**(SMALL if args.small else {}), **over})
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    add_scale_args(ap)
    ap.add_argument("--out", default=None,
                    help="artifact directory (default <arch>.smez)")
    ap.add_argument("--budget", type=float, default=0.06,
                    help="global weighted relative-error budget")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "v1", "v2", "v3", "none"],
                    help="kernel operand set to emit per layer (auto "
                         "prices v3 plane-CSC vs v2/v1 per layer by "
                         "measured bytes, or by the autotune cache's "
                         "measured times)")
    ap.add_argument("--measure", default="trial",
                    choices=["trial", "analytic"])
    ap.add_argument("--objective", default="bytes",
                    choices=["bytes", "energy"])
    ap.add_argument("--no-reorder", action="store_true",
                    help="skip the tile-densifying row reordering")
    ap.add_argument("--verify", action="store_true",
                    help="re-hash the written artifact payloads")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.compiler import compile_model, verify_artifact
    from repro_torch.convert import to_reference
    from repro_torch.core.integrate import sme_storage_summary
    from repro_torch.models.transformer import lm_init

    cfg = scaled_config(args)
    params = to_reference(lm_init(cfg, np.random.default_rng(args.seed)))
    out = args.out or f"{args.arch}.smez"
    backend = None if args.backend == "none" else args.backend
    t0 = time.perf_counter()
    packed, plan = compile_model(
        params, out=out, error_budget=args.budget, backend=backend,
        reorder=not args.no_reorder, measure=args.measure,
        objective=args.objective,
        extra={"arch": args.arch, "config": cfg.name,
               "dims": {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
                        "vocab": cfg.vocab, "n_layers": cfg.n_layers,
                        "head_dim": cfg.hd},
               "serve_backend": None if backend is None else "auto"})
    dt = time.perf_counter() - t0

    print(f"{'layer':42s} {'shape':14s} {'Nq':>3s} {'S':>2s} {'x':>2s} "
          f"{'be':>4s} {'perm':>4s} {'B/w':>6s} {'xbar red':>9s} "
          f"{'draft':>5s}")
    for key, lp in sorted(plan.layers.items()):
        print(f"{key:42s} {str(lp.shape):14s} {lp.n_bits:3d} {lp.window:2d} "
              f"{lp.squeeze:2d} {str(lp.backend):>4s} "
              f"{'yes' if lp.reorder else '-':>4s} "
              f"{lp.bytes_per_weight:6.3f} {lp.crossbar_reduction:8.2f}x "
              f"{lp.draft_planes:5d}")
    s = plan.summary()
    print(f"plan: {s['layers']} layers, weighted_err={s['weighted_error']:.4f} "
          f"(budget {args.budget}), crossbar_reduction="
          f"{s['crossbar_reduction']:.2f}x ({s['crossbars_dense']} -> "
          f"{s['crossbars']}), reordered={s['reordered_layers']}")
    print("storage:", sme_storage_summary(packed))
    n_payload = sum(1 for _ in pathlib.Path(out, "payload").iterdir())
    disk = sum(f.stat().st_size
               for f in pathlib.Path(out).rglob("*") if f.is_file())
    print(f"wrote {out}: {n_payload} payloads, {disk / 1e6:.2f} MB, "
          f"compiled in {dt:.1f}s")
    if args.verify:
        print(f"verified {verify_artifact(out)} payload hashes")
    return plan


if __name__ == "__main__":
    main()
