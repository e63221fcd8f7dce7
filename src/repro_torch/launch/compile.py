"""Offline model compiler CLI: plan -> reorder -> pack -> ``.smez``.

Checked against ``repro/launch/compile.py`` (its flags, ``--ckpt``
included).  The weights are the port's ``init_params`` from a numpy
generator seeded by ``--seed``, put into the reference's layout
(``convert.to_reference``: every layer's leaf stacked, an enc-dec
model's ``enc`` and ``dec``), which the planner plans one leaf at a time,
as the reference does; ``--ckpt DIR`` restores DIR's latest checkpoint
into that tree first (``train.checkpoint.restore``, leaves named by the
reference's rule: ``embed/w``, ``blocks/slot0/mix/q/w``, ...), so a
params checkpoint written by either package compiles.  A checkpoint of
``launch/train.py`` holds ``params/...`` and ``opt/...`` and is refused
by both compilers (ROADMAP R9): save the params alone to compile them.
Full width by default; ``--small`` is the 2-layer, 128-wide config of the
CPU tests; ``--d-model``/``--d-ff``/
``--head-dim``/``--vocab`` scale the config down as the reference's
flags do (``--small`` rounds its 2 layers up to whole superblocks: 6
for gemma3-12b's 5:1 local/global pattern, 8 for xlstm-1.3b's and
jamba-v0.1-52b's; an MoE model's experts are 128 wide, so they pack;
xLSTM keeps ``d_ff`` 0); ``--n-layers`` cuts the depth alone, at any
width (whole superblocks).  ``--arch`` takes any of the port's ``ARCHS``
(the MoE, vision, recurrent and encoder-decoder models included); an
untied ``lm_head``, stacked experts, deepseek's ``first0``, a vision
``patch_proj``, the recurrent blocks' projections and whisper's encoder,
cross-attention and head are planned and packed like every other
linear.  Compiling runs on the host (numpy); no card is needed.

    PYTHONPATH=src python -m repro_torch.launch.compile --small \\
        --out build/small.smez [--budget 0.06] [--ckpt DIR] \\
        [--backend auto|v1|v2|v3|none] [--no-reorder] [--verify]

The artifact then boots serving with zero per-boot packing:

    PYTHONPATH=src python -m repro_torch.launch.serve --small \\
        --device cpu --artifact build/small.smez
"""
from __future__ import annotations

import argparse
import dataclasses
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
    ap.add_argument("--n-layers", type=int, default=None,
                    help="depth (at any width): the leading dense layers "
                         "and whole superblocks")


def scaled_config(args):
    """``--arch`` at full width, or scaled down: ``--small``, or any dim
    override (the reference's ``scale_down`` with those dims); then
    ``--n-layers``."""
    over = {k: getattr(args, k) for k in ("d_model", "d_ff", "head_dim",
                                          "vocab")
            if getattr(args, k) is not None}
    cfg = ARCHS[args.arch]
    if args.small or over:
        small = {}
        if args.small:
            p = len(cfg.pattern)
            small = dict(SMALL, n_layers=-(-SMALL["n_layers"] // p) * p)
            if not cfg.d_ff:
                small["d_ff"] = 0        # xLSTM: no MLP half
            if cfg.n_experts:
                # experts past the 128 floor, so they pack
                small["expert_dff"] = 128
        cfg = scale_down(cfg, **{**small, **over})
    if args.n_layers is not None:
        body = args.n_layers - cfg.first_dense_layers
        if body <= 0 or body % len(cfg.pattern):
            raise SystemExit(f"--n-layers {args.n_layers}: {cfg.name} takes "
                             f"{cfg.first_dense_layers} leading layers and "
                             f"whole superblocks of {len(cfg.pattern)}")
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def model_dims(cfg) -> dict:
    """The dims an artifact records and a server checks (the reference's
    five, and the window, layer pattern, MLP and head of the dense
    family, the experts, MLA cache, frontend tokens, SSM state and
    encoder depth)."""
    return {"d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "n_layers": cfg.n_layers, "head_dim": cfg.hd,
            "swa_window": cfg.swa_window,
            "block_pattern": list(cfg.pattern), "act": cfg.act,
            "tie_embeddings": cfg.tie_embeddings,
            "n_experts": cfg.n_experts, "expert_dff": cfg.expert_dff,
            "kv_lora": cfg.kv_lora,
            "n_frontend_tokens": cfg.n_frontend_tokens,
            "ssm_state": cfg.ssm_state, "ssm_expand": cfg.ssm_expand,
            "n_enc_layers": cfg.n_enc_layers}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    add_scale_args(ap)
    ap.add_argument("--out", default=None,
                    help="artifact directory (default <arch>.smez)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir to compile (default: fresh init)")
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
    from repro_torch.models.model import init_params

    cfg = scaled_config(args)
    params = to_reference(init_params(cfg, np.random.default_rng(args.seed)),
                          n_slots=len(cfg.pattern))
    if args.ckpt:
        from repro_torch.train.checkpoint import restore
        params = restore(args.ckpt, None, params)
    out = args.out or f"{args.arch}.smez"
    backend = None if args.backend == "none" else args.backend
    t0 = time.perf_counter()
    packed, plan = compile_model(
        params, out=out, error_budget=args.budget, backend=backend,
        reorder=not args.no_reorder, measure=args.measure,
        objective=args.objective,
        extra={"arch": args.arch, "config": cfg.name,
               "dims": model_dims(cfg),
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
