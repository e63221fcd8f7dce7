"""Serving driver of the port: random-weight requests through ServeEngine.

Checked against ``repro/launch/serve.py`` (its flags but ``--mesh``,
``--bm``, ``--host-devices`` and ``--metrics-port``).  Weights come from a
numpy generator seeded by ``--seed`` (the reference init's
distributions), or from a compiled ``.smez`` (``--artifact``, made by
``repro_torch.launch.compile`` or the reference's compiler; its arch and
dims must match the size flags).  ``--sme`` packs every eligible weight at
``--squeeze`` and
emits the kernel operands ``--backend`` serves from: ``v1``/``v2``/``v3``
their own; ``auto`` on the card v2 when ``--squeeze >= 1`` and v1 when it
is 0 (the reference's choice on its chip), on ``--device cpu`` none, so
auto serves the dense dequant (``torch``) as the reference does off its
chip; ``torch`` none.  Runs on the card unless ``--device cpu``.  Full
width by default; ``--small`` is the 2-layer, 128-wide config the CPU
tests use.

The engine is the continuous scheduler: ``--chunk-len`` prompt tokens per
step per prefilling row, ``--prefix-cache`` (pages of ``--page-tokens``),
``--spec-depth K|auto`` self-speculative decode with ``--spec-len`` draft
tokens per round (v3 drafts through the decode kernel's ``plane_depth``;
``auto`` drafts each layer at the compiler plan's depth: ``--sme
--backend v3`` plans the weights first, as the reference does, an
artifact brings its plan, and anything else is refused),
``--stream`` drives ``submit``/``pump``/``step``/``poll`` instead of
``run()``.  ``--metrics-out`` writes the metrics snapshot, ``--trace-out``
the request trace (``*.json``: Chrome/Perfetto; else JSONL).

    PYTHONPATH=src python -m repro_torch.launch.serve --sme
    PYTHONPATH=src python -m repro_torch.launch.serve --small --device cpu \\
        --sme --backend v2 --requests 3 --max-new 4
    PYTHONPATH=src python -m repro_torch.launch.serve --small --device cpu \\
        --sme --backend v3 --spec-depth 2 --chunk-len 8 --page-tokens 8 \\
        --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --small --device cpu \\
        --artifact build/small.smez
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.core.integrate import (convert_params_to_sme,
                                        sme_storage_summary, to_torch)
from repro_torch.launch.compile import SMALL, add_scale_args, scaled_config
from repro_torch.models.model import build_model
from repro_torch.models.transformer import lm_init
from repro_torch.serve import Request, ServeEngine

__all__ = ["main", "SMALL"]

_NO_PLAN_DEPTH = ("--spec-depth auto drafts each layer at its compiler plan "
                  "depth, and these weights have none: serve --sme --backend "
                  "v3 (planned here) or a v3 artifact, or pass --spec-depth K")


def check_artifact(path, arch: str, cfg) -> None:
    """Refuse an artifact compiled for another arch or other dims (the
    reference launcher's checks)."""
    from repro_torch.compiler import read_manifest
    extra = read_manifest(path).get("extra", {})
    if extra.get("arch") and extra["arch"] != arch:
        raise SystemExit(f"artifact {path} was compiled for --arch "
                         f"{extra['arch']}, not {arch}")
    mine = {"d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "n_layers": cfg.n_layers, "head_dim": cfg.hd}
    bad = {k: (v, mine[k]) for k, v in (extra.get("dims") or {}).items()
           if k in mine and v != mine[k]}
    if bad:
        raise SystemExit(
            f"artifact {path} dims do not match this model (artifact vs "
            f"flags): {bad}; pass the same --small/--d-model/--d-ff/... the "
            f"artifact was compiled with")


def planned_params(params, device):
    """``--spec-depth auto`` on v3: plan the weights in the reference's
    layout (each layer's draft depth from its plane occupancy) and pack
    them through the plan, as the reference launcher does."""
    from repro_torch.compiler import compile_model, plan_model
    from repro_torch.convert import from_reference, to_reference
    ref = to_reference(params)
    plan = plan_model(ref, backend="v3")
    packed, _ = compile_model(ref, plan=plan)
    return from_reference(packed, device=device), plan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    add_scale_args(ap)
    ap.add_argument("--artifact", default=None, metavar="PATH",
                    help="boot from a compiled .smez (launch.compile); "
                         "--backend auto serves its recorded backend")
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
    ap.add_argument("--spec-depth",
                    default=os.environ.get("SME_SPEC_DEPTH") or None,
                    metavar="K|auto",
                    help="self-speculative decode: draft greedy tokens over "
                         "the K most significant planes per tile group "
                         "(auto: each layer's sme_draft_planes), verify at "
                         "full precision; default SME_SPEC_DEPTH, unset = "
                         "off")
    ap.add_argument("--spec-len", type=int,
                    default=int(os.environ.get("SME_SPEC_LEN") or 0),
                    help="tokens drafted per round (4 when --spec-depth is "
                         "set; SME_SPEC_LEN)")
    ap.add_argument("--chunk-len", type=int, default=None,
                    help="prompt tokens a prefilling row scores per engine "
                         "step (default SME_CHUNK_LEN or 32)")
    ap.add_argument("--page-tokens", type=int, default=None,
                    help="prefix-cache page size in tokens (default "
                         "SME_PAGE_TOKENS or 16)")
    ap.add_argument("--prefix-cache", action="store_true", default=None,
                    help="snapshot chunk-aligned prompt prefixes and reuse "
                         "them for token-id-exact matches (default "
                         "SME_PREFIX_CACHE)")
    ap.add_argument("--stream", action="store_true",
                    help="drive submit/pump/step/poll instead of run()")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot (JSON) here on exit")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the request trace here on exit: *.json = "
                         "Chrome/Perfetto trace_event, else JSONL")
    ap.add_argument("--trace-capacity", type=int, default=4096,
                    help="trace ring capacity (oldest spans evict)")
    args = ap.parse_args(argv)
    spec_depth = args.spec_depth
    if spec_depth is not None and spec_depth != "auto":
        if not str(spec_depth).isdigit() or int(spec_depth) < 1:
            ap.error(f"--spec-depth must be a positive int or 'auto', got "
                     f"{spec_depth!r}")
        spec_depth = int(spec_depth)

    cfg = scaled_config(args)
    api = build_model(cfg, device=args.device)
    rng = np.random.default_rng(args.seed)
    engine_kw = dict(slots=args.slots, s_max=args.s_max, device=args.device,
                     seed=args.seed, trace_capacity=args.trace_capacity,
                     spec_depth=spec_depth, spec_len=args.spec_len,
                     chunk_len=args.chunk_len, page_tokens=args.page_tokens,
                     prefix_cache=args.prefix_cache)
    t0 = time.perf_counter()
    plan = None
    if args.artifact:
        check_artifact(args.artifact, args.arch, cfg)
        if args.backend != "auto":
            engine_kw["backend"] = args.backend
        eng = ServeEngine.from_artifact(api, args.artifact, **engine_kw)
        plan = eng.plan
        print(f"booted from {args.artifact} in "
              f"{time.perf_counter() - t0:.2f}s (plan: "
              f"{len(plan.layers) if plan else 0} layers, backend "
              f"{eng.backend}) on {api.device}")
    else:
        params = lm_init(cfg, rng)
        if args.sme:
            emit = args.backend if args.backend in ("v1", "v2", "v3") \
                else None
            if args.backend == "auto" and api.device.type == "cuda":
                # auto on the card serves through the kernels, whose
                # operands are packed offline
                emit = "v2" if args.squeeze >= 1 else "v1"
            if spec_depth == "auto" and emit != "v3":
                raise SystemExit(_NO_PLAN_DEPTH)
            if spec_depth == "auto":
                params, plan = planned_params(params, args.device)
            else:
                params = convert_params_to_sme(params, squeeze=args.squeeze,
                                               backend=emit,
                                               device=args.device)
            print("SME storage:", sme_storage_summary(params))
        else:
            params = to_torch(params, args.device)
        print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"params ready in {time.perf_counter() - t0:.1f}s on "
              f"{api.device}" + (f", SME backend {args.backend}"
                                 if args.sme else ", dense"))
        eng = ServeEngine(api, params,
                          backend=args.backend if args.sme else None,
                          **engine_kw)
    if spec_depth == "auto":
        depths = sorted({lp.draft_planes for lp in plan.layers.values()}) \
            if plan is not None else []
        if not any(depths):
            raise SystemExit(_NO_PLAN_DEPTH)
        print(f"spec: draft depths per layer from the plan: {depths}")
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=5 + i % 4),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    if args.stream:
        # requests arrive two at a time between engine steps; poll()
        # drains token/finish/reject events as they happen
        pending, n_events = list(reqs), 0
        for steps in range(500):
            for r in pending[:2]:
                eng.submit(r)
            pending = pending[2:]
            eng.pump()
            eng.step()
            for ev in eng.poll():
                n_events += 1
                if ev["kind"] != "token":
                    print(f"  [{steps:3d}] req {ev['rid']}: {ev['kind']}")
            if not pending and all(r.done or r.outcome for r in reqs):
                break
        done = sum(r.outcome == "completed" for r in reqs)
        stats = {**eng.stats, "completed": done,
                 "wall_s": time.perf_counter() - t0}
        print(f"stream: {done}/{len(reqs)} completed, {stats['tokens']} "
              f"tokens, {n_events} events in {steps + 1} steps")
    else:
        stats = eng.run(reqs, max_steps=500)
    print(f"stats: {stats}")
    for r in reqs[:4]:
        print(f"req {r.rid}: prompt={list(map(int, r.prompt))} -> "
              f"{r.out_tokens}")
    print(f"throughput: {stats['tokens'] / stats['wall_s']:.1f} tok/s on "
          f"{api.device}")
    if args.metrics_out:
        from repro_torch.obs import write_snapshot
        write_snapshot(args.metrics_out)
        print(f"metrics snapshot: {args.metrics_out}")
    if args.trace_out:
        from repro_torch.obs import export_jsonl, export_trace_event
        export = export_trace_event if args.trace_out.endswith(".json") \
            else export_jsonl
        export(eng.tracer.buffer, args.trace_out)
        print(f"trace ({len(eng.tracer.buffer)} spans, "
              f"{eng.tracer.buffer.dropped} dropped): {args.trace_out}")
    return stats


if __name__ == "__main__":
    main()
