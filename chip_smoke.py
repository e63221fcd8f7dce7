#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py            # needs one card; builds the kernels

1. Card: name, count, ``nvidia-smi`` name and power limit; build every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
   in parallel) and print the build seconds and ptxas reports.
2. Kernels: at the three linear shapes of qwen1.5-0.5b (1024x1024 q/k/v/o,
   1024x2816 wi/wg, 2816x1024 wo), on ``sme_compress`` output of seeded
   Gaussian weights, the decode kernel at M = 8 and the prefill kernel at
   M = 512 are each held against their plain PyTorch version on the card
   and against the f64 oracle ``sme_matmul_ref_np`` (relative error
   <= 5e-5); the decode kernel must equal the prefill kernel bitwise at
   M = 8, ``plane_depth`` >= the deepest group must be a bitwise no-op and
   ``plane_depth = 2`` must match ``dequant_topk_planes(2)``.  Times from
   CUDA events with the L2 cache flushed before every launch.
3. Serving: full-width qwen1.5-0.5b (24 layers, random weights from a
   numpy seed, every attention/MLP weight packed to v3) serves 8 requests
   through ``ServeEngine(slots=4, s_max=256, backend="v3")``; both kernels'
   launch counters must cover every layer of every prefill and decode
   step; one prefill's logits are held against the same model run through
   the plain versions.
4. Prints the kernels JSON line, the card line and, last,
   ``{"ok": true, "device": {...}}``.  Any failed check raises first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
TOL_ORACLE = 5e-5          # DESIGN.md §5 relative bound
#: kernel vs plain version, relative to max |plain|: both sum in f32, in
#: different orders (sequential fmaf vs cuBLAS), over K <= 2816 terms
TOL_PLAIN = 5e-5
#: prefill logits through the kernels vs the plain versions, relative to
#: max |logit|.  f32: the per-linear difference above compounded through 24
#: layers, with 100x room.  bf16 (the served dtype): each linear's output is
#: rounded to bf16 (2^-8 relative), so an f32-level difference can flip one
#: rounding by one bf16 ulp; such flips compound over 24 layers, 10x room
TOL_LOGITS = {"float32": 1e-3, "bfloat16": 5e-2}
#: qwen1.5-0.5b linears per layer: (name, K, N, calls per layer)
SHAPES = (("qkvo", 1024, 1024, 4), ("wi_wg", 1024, 2816, 2),
          ("wo", 2816, 1024, 1))
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
#: embedding std of the random serving model: small enough that the layers,
#: not just the tied head's echo of the last prompt token, set the tokens
EMBED_STD = 0.05


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, flush, iters: int = 10) -> float:
    """Median device ms of ``fn`` over ``iters`` launches, each after the
    L2 cache was flushed (the main path finds its weights cold)."""
    fn()
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def plain_kernels():
    """Route the v3 backend through the kernels' plain versions (the
    backend resolves the wrappers from their modules at call time)."""
    import repro_torch.kernels.sme_spmm.sme_spmm_planes as pmod
    import repro_torch.kernels.sme_spmm.sme_spmm_planes_decode as dmod
    saved = pmod.sme_spmm_planes, dmod.sme_spmm_planes_decode
    pmod.sme_spmm_planes = pmod.sme_spmm_planes_plain
    dmod.sme_spmm_planes_decode = dmod.sme_spmm_planes_decode_plain
    try:
        yield
    finally:
        pmod.sme_spmm_planes, dmod.sme_spmm_planes_decode = saved


def kernel_phase(dev, flush):
    from repro_torch.core.sme import sme_compress, sme_matmul_ref_np
    from repro_torch.kernels.sme_spmm.sme_spmm_planes import (
        sme_spmm_planes, sme_spmm_planes_plain)
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import (
        sme_spmm_planes_decode, sme_spmm_planes_decode_plain)
    rng = np.random.default_rng(SEED)
    agg = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   max_abs_err=0.0, bytes=0.0, flops=0.0)
           for k in ("decode", "prefill")}
    for name, K, N, calls in SHAPES:
        w = rng.standard_normal((K, N)) / np.sqrt(K)
        smew = sme_compress(w, n_bits=8, window=3, squeeze=1)
        packed = smew.pack_plane_csc()
        ops = {k: torch.as_tensor(v, device=dev) for k, v in packed.items()}
        args = [ops[k] for k in ("planes", "sign", "rowscale")]
        idx = [ops[k] for k in ("rowid", "shift", "last", "nnz")]
        nt = ops["planes"].shape[0]
        scale = torch.full((nt * 128,), float(smew.scale.reshape(-1)[0]),
                           dtype=torch.float32, device=dev)
        colscale = (scale * 2.0 ** -8).reshape(nt, 128)
        last, nnz = packed["last"], packed["nnz"]
        valid = np.arange(last.shape[1])[None, :] < nnz[:, None]
        groups = int(((last == 1) & valid).sum())
        deepest = 8
        w_dense = torch.as_tensor(smew.dequant(), dtype=torch.float32,
                                  device=dev)
        for kind, m in (("decode", 8), ("prefill", 512)):
            x = rng.standard_normal((m, K)).astype(np.float32)
            xp = torch.as_tensor(x, device=dev)
            ref = sme_matmul_ref_np(x, smew)
            if kind == "decode":
                def run(depth=None):
                    return sme_spmm_planes_decode(xp, *args, colscale, *idx,
                                                  plane_depth=depth)[:, :N]

                def plain():
                    return sme_spmm_planes_decode_plain(
                        xp, *args, colscale, *idx)[:, :N]
            else:
                def run():
                    return (sme_spmm_planes(xp, *args, *idx)
                            * scale * 2.0 ** -8)[:, :N]

                def plain():
                    return (sme_spmm_planes_plain(xp, *args, *idx)
                            * scale * 2.0 ** -8)[:, :N]
            y, yp = run(), plain()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y).all()) and y.shape == (m, N),
                  f"{kind} {name}: non-finite or misshapen output")
            err = float((y - yp).abs().max())
            tol = TOL_PLAIN * float(yp.abs().max())
            check(err <= tol, f"{kind} {name}: |kernel - plain| {err} > {tol}")
            rel = float(np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max())
            check(rel <= TOL_ORACLE, f"{kind} {name}: oracle rel {rel}")
            extra = ""
            if kind == "decode":
                # decode kernel == prefill kernel (M padded to one 128 tile)
                x128 = torch.zeros((128, K), device=dev)
                x128[:m] = xp
                y_pre = (sme_spmm_planes(x128, *args, *idx)[:m]
                         * scale * 2.0 ** -8)[:, :N]
                check(bool(torch.equal(y, y_pre)),
                      f"{name}: decode kernel != prefill kernel bitwise")
                check(bool(torch.equal(run(deepest), y)),
                      f"{name}: plane_depth {deepest} is not a no-op")
                ref2 = np.asarray(x, np.float64) @ smew.dequant_topk_planes(2)
                rel2 = float(np.abs(run(2).cpu().numpy() - ref2).max()
                             / np.abs(ref2).max())
                check(rel2 <= TOL_ORACLE, f"{name}: plane_depth 2 rel {rel2}")
                extra = f" depth2_rel={rel2:.2e} decode==prefill"
            ms = time_ms(run, flush)
            plain_ms = time_ms(plain, flush)
            lib_ms = time_ms(lambda: torch.matmul(xp, w_dense), flush)
            # bytes: x, every stored plane bitmap, sign + 2^row_exp of every
            # occupied tile, colscale, y; FLOPs: one 128x128 dot per group
            nbytes = (m * K * 4 + int(nnz.sum()) * 2048 + groups * (2048 + 512)
                      + nt * 128 * 4 + m * N * 4)
            flops = 2.0 * m * 128 * 128 * groups
            bound = max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3
            by = "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_F32 \
                else "operations"
            print(f"kernel {kind:7s} {name:6s} M={m:3d} K={K} N={N} "
                  f"planes={int(nnz.sum())} groups={groups}: "
                  f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
                  f"torch.matmul {lib_ms * 1e3:.1f} us, bound "
                  f"{bound * 1e3:.2f} us ({by}: {nbytes} B, {flops:.3g} FLOP)"
                  f" | max|k-p|={err:.2e} oracle_rel={rel:.2e}{extra}",
                  flush=True)
            a = agg[kind]
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("bound_ms", bound),
                             ("bytes", nbytes), ("flops", flops)):
                a[key] += calls * val
            a["max_abs_err"] = max(a["max_abs_err"], err)
    for a in agg.values():
        a["bound_by"] = ("bytes" if a.pop("bytes") / PEAK_BYTES
                         >= a.pop("flops") / PEAK_F32 else "operations")
    return agg


def build_model_params(dev, cfg):
    """Full-width random weights, generated and packed layer by layer."""
    from repro_torch.core.integrate import convert_params_to_sme, to_torch
    from repro_torch.models.transformer import init_layer
    rng = np.random.default_rng(SEED)
    embed = rng.standard_normal((cfg.vocab, cfg.d_model), dtype=np.float32)
    params = to_torch({"embed": {"w": embed * np.float32(EMBED_STD)},
                       "final_norm": {"w": np.ones(cfg.d_model, np.float32)}},
                      dev)
    params["blocks"] = []
    t0 = time.perf_counter()
    for _ in range(cfg.n_layers):
        params["blocks"].append(convert_params_to_sme(
            init_layer(cfg, rng), backend="v3", device=dev))
    return params, time.perf_counter() - t0


def serve_phase(dev, card):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.sme_spmm.sme_spmm_planes import sme_spmm_planes
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import \
        sme_spmm_planes_decode
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg = ARCHS["qwen1.5-0.5b"]
    params, pack_s = build_model_params(dev, cfg)
    print(f"serve: packed {cfg.n_layers} layers x 7 linears to v3 in "
          f"{pack_s:.1f}s", flush=True)
    api = build_model(cfg, device=dev)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(40, 121, size=8)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    eng = ServeEngine(api, params, slots=4, s_max=256, backend="v3",
                      device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sme_spmm_planes.launches = sme_spmm_planes_decode.launches = 0
    stats = eng.run(reqs, max_steps=200)
    torch.cuda.synchronize()
    launches = {"prefill": sme_spmm_planes.launches,
                "decode": sme_spmm_planes_decode.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_pass = cfg.n_layers * 7
    print(f"serve: {stats}", flush=True)
    print(f"serve: launches {launches}, per model pass {per_pass}")
    check(stats["completed"] == 8, f"completed {stats['completed']} of 8")
    check(all(len(r.out_tokens) == 16 for r in reqs), "short outputs")
    check(launches["prefill"] >= per_pass * stats["prefills"],
          f"prefill kernel launches {launches['prefill']} < "
          f"{per_pass} x {stats['prefills']} prefills")
    check(launches["decode"] >= per_pass * stats["decode_steps"],
          f"decode kernel launches {launches['decode']} < "
          f"{per_pass} x {stats['decode_steps']} decode steps")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"serve: {n_tok / stats['wall_s']:.1f} tokens/s end to end, "
          f"{stats['decode_s'] / stats['decode_steps'] * 1e3:.2f} ms per "
          f"decode step (4 slots), {stats['prefill_s'] / stats['prefills'] * 1e3:.1f}"
          f" ms per prefill, peak memory {peak_gb:.2f} GiB | {card}",
          flush=True)

    # one prefill window (the engine's first: 4 rows, bucket 128), kernels
    # vs plain versions, in f32 (the algorithm) and bf16 (as served)
    window = prompts[:4]
    toks = np.zeros((4, 128), np.int64)
    for i, p in enumerate(window):
        toks[i, :len(p)] = p
    plen = [len(p) for p in window]
    for dtype in ("float32", "bfloat16"):
        api_d = build_model(dataclasses.replace(cfg, dtype=dtype), device=dev)
        lk, _ = api_d.prefill(params, toks, s_max=256, plen=plen,
                              backend="v3")
        with plain_kernels():
            lp, _ = api_d.prefill(params, toks, s_max=256, plen=plen,
                                  backend="v3")
        check(bool(torch.isfinite(lk).all()) and lk.shape == (4, cfg.vocab),
              f"{dtype} logits non-finite or misshapen")
        diff = float((lk - lp).abs().max() / lp.abs().max())
        agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
        print(f"serve: {dtype} prefill logits kernels vs plain: max rel "
              f"diff {diff:.2e} (tolerance {TOL_LOGITS[dtype]:.0e}), greedy "
              f"agreement {agree}/4", flush=True)
        check(diff <= TOL_LOGITS[dtype], f"{dtype} logits rel diff {diff}")
    profile_window(api, params, prompts[4:], card)
    return launches


def profile_window(api, params, prompts, card):
    """Where a serving window's time goes: torch.profiler over one prefill
    and 5 decode steps of 4 requests (after the counted run)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(api, params, slots=4, s_max=256, backend="v3",
                      device=api.device)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile: 1 prefill + {stats['decode_steps']} decode steps, wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% | {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile:   {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d} calls  {e.key[:90]}")
    n_ops = sum(e.count for e in prof.key_averages()
                if e.device_type.name == "CPU" and e.key.startswith("aten::"))
    print(f"profile: {n_ops} aten op calls on the host (nested included)",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"{card}", flush=True)
    t0 = time.perf_counter()
    reports = build.build_all()
    for name in build.SIGNATURES:
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f}s for "
          f"{len(build.SIGNATURES)} kernels", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    agg = kernel_phase(dev, flush)
    launches = serve_phase(dev, card)
    rows = []
    for kind, name, src, pallas in (
            ("decode", "sme_spmm_planes_decode",
             "src/repro_torch/kernels/csrc/sme_spmm_planes_decode.cu",
             "src/repro/kernels/sme_spmm/sme_spmm_planes_decode.py:157"),
            ("prefill", "sme_spmm_planes",
             "src/repro_torch/kernels/csrc/sme_spmm_planes.cu",
             "src/repro/kernels/sme_spmm/sme_spmm_planes.py:77")):
        a = agg[kind]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": pallas, "launches": launches[kind],
                     "max_abs_err": a["max_abs_err"], "ms": a["ms"],
                     "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                     "bound_by": a["bound_by"],
                     "library_ms": a["library_ms"]})
    # times are per model layer: 4 q/k/v/o + 2 wi/wg + 1 wo calls
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
