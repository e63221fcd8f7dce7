"""Serving driver of the port: random-weight requests through ServeEngine.

Checked against ``repro/launch/serve.py`` (its flags but
``--host-devices``, an XLA flag with no counterpart here: the ranks of a
mesh are processes).  ``--arch`` takes any of the port's ``ARCHS`` (the
dense, MoE, vision, recurrent and encoder-decoder families; whisper's
requests go in behind the audio stub's zero frames, which the engine
builds).
Weights come from a numpy generator seeded by ``--seed`` (the reference
init's distributions), or from a compiled ``.smez`` (``--artifact``, made
by ``repro_torch.launch.compile`` or the reference's compiler; its arch and
dims must match the size flags).  ``--bm`` sets the M block of v3's
decode-kernel threshold (``core.backend.use_block``; the kernels fix
their own 128x128 tiles); ``--backend`` defaults to ``SME_BACKEND``.
``--sme`` packs every eligible weight at ``--squeeze`` and emits the
kernel operands ``--backend`` serves from: ``v1``/``v2``/``v3``
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
``run()``.  ``--metrics-out`` writes the metrics snapshot (which
``python -m repro_torch.obs.gate`` checks), ``--trace-out`` the request
trace (``*.json``: Chrome/Perfetto; else JSONL), and ``--metrics-port N``
serves the Prometheus text at ``/metrics`` on 127.0.0.1 for the process
lifetime (0: an ephemeral port).

``--mesh data,model`` (default ``1,1``) serves on a mesh of ``data *
model`` ranks (``launch.mesh``; the dense, MoE and recurrent families,
MLA and the vision frontend): the launcher spawns them (``torch.multiprocessing``, a
file store in a temporary directory for the rendezvous), or joins an
existing group when ``RANK``/``WORLD_SIZE`` are set
(``init_method="env://"``).
``--dist-backend`` defaults to ``nccl`` on the card and ``gloo`` on the
CPU; NCCL takes one card per rank, so more ranks than cards under
``nccl`` are refused with a message; ``gloo`` on the card carries CUDA
tensors through host memory (said on start: correctness, not speed).
Every rank builds the same weights from ``--seed`` on the host and
places only its shard on its device; only rank 0 prints.

    PYTHONPATH=src python -m repro_torch.launch.serve --sme
    PYTHONPATH=src python -m repro_torch.launch.serve --small --device cpu \\
        --sme --backend v2 --requests 3 --max-new 4
    PYTHONPATH=src python -m repro_torch.launch.serve --small --device cpu \\
        --sme --backend v3 --spec-depth 2 --chunk-len 8 --page-tokens 8 \\
        --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --small --device cpu \\
        --artifact build/small.smez
    PYTHONPATH=src python -m repro_torch.launch.serve --small --device cpu \\
        --sme --backend v2 --mesh 2,2
    PYTHONPATH=src python -m repro_torch.launch.serve --small --device cpu \\
        --arch deepseek-v2-lite-16b --sme --backend v2 --mesh 2,2
    PYTHONPATH=src python -m repro_torch.launch.serve --small --device cpu \\
        --arch jamba-v0.1-52b --sme --backend v2 --mesh 2,2
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.core.integrate import (convert_params_to_sme,
                                        sme_storage_summary, to_torch)
from repro_torch.launch.compile import (SMALL, add_scale_args, model_dims,
                                        scaled_config)
from repro_torch.launch.mesh import make_local_mesh, parse_mesh
from repro_torch.models.model import build_model, init_params
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
    mine = model_dims(cfg)
    bad = {k: (v, mine[k]) for k, v in (extra.get("dims") or {}).items()
           if k in mine and v != mine[k]}
    if bad:
        raise SystemExit(
            f"artifact {path} dims do not match this model (artifact vs "
            f"flags): {bad}; pass the same --small/--d-model/--d-ff/... the "
            f"artifact was compiled with")


def planned_params(params, device, n_slots: int = 1):
    """``--spec-depth auto`` on v3: plan the weights in the reference's
    layout (each layer's draft depth from its plane occupancy) and pack
    them through the plan, as the reference launcher does."""
    from repro_torch.compiler import compile_model, plan_model
    from repro_torch.convert import from_reference, to_reference
    ref = to_reference(params, n_slots)
    plan = plan_model(ref, backend="v3")
    packed, _ = compile_model(ref, plan=plan)
    return from_reference(packed, device=device), plan


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--backend",
                    default=os.environ.get("SME_BACKEND", "auto"),
                    choices=["auto", "torch", "v1", "v2", "v3"])
    ap.add_argument("--bm", type=int, default=None,
                    help="M block of v3's decode-kernel threshold "
                         "(core.backend.use_block; default: the autotune "
                         "cache, SME_BM or 128); the kernels fix their own "
                         "128x128 tiles")
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
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the Prometheus text at /metrics on this "
                         "port for the process lifetime (0: ephemeral)")
    ap.add_argument("--mesh", default="1,1", metavar="DATA,MODEL",
                    help="serve on a (data, model) mesh of DATA*MODEL ranks, "
                         "spawned here or joined through RANK/WORLD_SIZE "
                         "(the reference's --host-devices, an XLA flag, has "
                         "no counterpart: the ranks are processes)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend of a mesh (default nccl on "
                         "the card, gloo on the CPU); nccl takes one card "
                         "per rank, gloo carries CUDA tensors through host "
                         "memory")
    return ap


def dist_backend(args, world: int) -> str:
    """The mesh's process-group backend: ``--dist-backend``, else nccl on
    the card and gloo on the CPU; refuses nccl with more ranks than
    cards (NCCL rejects two ranks on one card)."""
    be = args.dist_backend or ("nccl" if args.device == "cuda" else "gloo")
    if be == "nccl":
        if args.device != "cuda":
            raise SystemExit("--dist-backend nccl needs --device cuda")
        cards = torch.cuda.device_count()
        if world > cards:
            raise SystemExit(
                f"--mesh {args.mesh} under nccl needs {world} cards, one per "
                f"rank (NCCL refuses two ranks on one card); {cards} visible."
                f" Pass --dist-backend gloo to run them on shared cards "
                f"(correctness only: gloo carries CUDA tensors through host "
                f"memory)")
    return be


def main(argv=None):
    """Serve one run; on a mesh of more than one rank, spawn the ranks (or
    join the group ``RANK``/``WORLD_SIZE`` describe) and return rank 0's
    stats."""
    ap = _parser()
    args = ap.parse_args(argv)
    try:
        data, model = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    sd = args.spec_depth
    if sd is not None and sd != "auto" and (not str(sd).isdigit()
                                            or int(sd) < 1):
        ap.error(f"--spec-depth must be a positive int or 'auto', got "
                 f"{sd!r}")
    world = data * model
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        _init_rank(args, rank, dist_backend(args, size), "env://", size)
        try:
            return serve(args, rank)
        finally:
            dist.destroy_process_group()
    if world == 1:
        return serve(args, 0)
    be = dist_backend(args, world)
    print(f"mesh {data}x{model}: spawning {world} ranks over {be}"
          + (" (CUDA tensors through host memory: correctness, not speed)"
             if be == "gloo" and args.device == "cuda" else ""),
          flush=True)
    tmp = tempfile.mkdtemp(prefix="mesh-")
    out = torch.multiprocessing.get_context("spawn").SimpleQueue()
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(argv, world, be, f"file://{tmp}/store", out),
            nprocs=world, start_method="spawn")
        return out.get()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _init_rank(args, rank: int, backend: str, init_method: str,
               world: int) -> None:
    if args.device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def _rank_main(rank, argv, world, backend, init_method, out):
    """One spawned rank: join the group, serve, hand rank 0's stats back."""
    args = _parser().parse_args(argv)
    _init_rank(args, rank, backend, init_method, world)
    try:
        stats = serve(args, rank)
        if rank == 0:
            out.put(stats)
    finally:
        dist.destroy_process_group()


def serve(args, rank: int = 0):
    """The launcher's run on this rank (the whole run on the 1x1 mesh)."""
    def say(*a, **k):
        if rank == 0:
            print(*a, **k)
    data, model = parse_mesh(args.mesh)
    device = args.device
    if device == "cuda" and dist.is_initialized():
        device = f"cuda:{torch.cuda.current_device()}"
    mesh = make_local_mesh(data, model, device=device) \
        if dist.is_initialized() else None
    if mesh is not None:
        say(f"mesh {mesh.data}x{mesh.model} over {mesh.backend}: "
            f"{mesh.size} ranks; rank 0 on {mesh.device}")
    # a mesh's ranks build the weights on the host; each places its shard
    host = "cpu" if mesh is not None and mesh.size > 1 else device
    spec_depth = args.spec_depth
    if spec_depth not in (None, "auto"):
        spec_depth = int(spec_depth)

    if args.metrics_port is not None and rank == 0:
        from repro_torch.obs.httpd import start_metrics_server
        server, _ = start_metrics_server(args.metrics_port)
        print(f"metrics: http://127.0.0.1:{server.server_port}/metrics")
    cfg = scaled_config(args)
    api = build_model(cfg, device=device)
    rng = np.random.default_rng(args.seed)
    engine_kw = dict(slots=args.slots, s_max=args.s_max, device=device,
                     mesh=mesh,
                     seed=args.seed, trace_capacity=args.trace_capacity,
                     spec_depth=spec_depth, spec_len=args.spec_len,
                     chunk_len=args.chunk_len, page_tokens=args.page_tokens,
                     prefix_cache=args.prefix_cache, bm=args.bm)
    t0 = time.perf_counter()
    plan = None
    if args.artifact:
        check_artifact(args.artifact, args.arch, cfg)
        if args.backend != "auto":
            engine_kw["backend"] = args.backend
        eng = ServeEngine.from_artifact(api, args.artifact, **engine_kw)
        plan = eng.plan
        say(f"booted from {args.artifact} in "
            f"{time.perf_counter() - t0:.2f}s (plan: "
            f"{len(plan.layers) if plan else 0} layers, backend "
            f"{eng.backend}) on {api.device}")
    else:
        params = init_params(cfg, rng)
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
                params, plan = planned_params(params, host,
                                              len(cfg.pattern))
            else:
                params = convert_params_to_sme(params, squeeze=args.squeeze,
                                               backend=emit, device=host)
            say("SME storage:", sme_storage_summary(params))
        else:
            params = to_torch(params, host)
        say(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
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
        say(f"spec: draft depths per layer from the plan: {depths}")
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
                    say(f"  [{steps:3d}] req {ev['rid']}: {ev['kind']}")
            if not pending and all(r.done or r.outcome for r in reqs):
                break
        done = sum(r.outcome == "completed" for r in reqs)
        stats = {**eng.stats, "completed": done,
                 "wall_s": time.perf_counter() - t0}
        say(f"stream: {done}/{len(reqs)} completed, {stats['tokens']} "
            f"tokens, {n_events} events in {steps + 1} steps")
    else:
        stats = eng.run(reqs, max_steps=500)
    say(f"stats: {stats}")
    for r in reqs[:4]:
        say(f"req {r.rid}: prompt={list(map(int, r.prompt))} -> "
            f"{r.out_tokens}")
    say(f"throughput: {stats['tokens'] / stats['wall_s']:.1f} tok/s on "
        f"{api.device}")
    if rank:
        return stats
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
