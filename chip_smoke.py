#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py            # needs one card; builds the kernels

1. Card: name, count, ``nvidia-smi`` name and power limit; build every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
   all four in parallel) and print the build seconds and ptxas reports.
2. Kernels: at the three linear shapes of qwen1.5-0.5b (1024x1024 q/k/v/o,
   1024x2816 wi/wg, 2816x1024 wo), on ``sme_compress`` output of seeded
   Gaussian weights, each kernel is held against its plain PyTorch version
   on the card and against the f64 oracle ``sme_matmul_ref_np`` (relative
   error <= 5e-5): v3's decode kernel at M = 8 and 64 (the smallest and
   largest decode bucket) and prefill kernel at M = 512, v1's ``sme_spmm``
   and v2's ``sme_spmm6`` (one entry point each for decode and prefill) at
   all three.  The decode kernel must equal the prefill kernel bitwise,
   ``plane_depth`` >= the deepest group must be a bitwise no-op and
   ``plane_depth = 2`` must match ``dequant_topk_planes(2)``; v1 and v2,
   after their power-of-two scaling, must equal the v3 prefill kernel
   bitwise, also on a pruned weight with empty tiles and an empty column
   tile (whose output must be exactly 0), where the decode kernel must
   also equal the prefill kernel and hold ``plane_depth`` 1, 2 and 8; v1
   must hold settings v2 cannot (squeeze 0, window 4) against the oracle.
   The launch geometry (blocks, cluster size, dynamic shared memory) of
   all four kernels is printed per shape and M.  Times from CUDA
   events with the L2 cache flushed before every launch: the kernel's
   launch alone (the unscaled product for v1, v2 and v3-prefill; the log
   line adds the time with the backend's scaling epilogue, two elementwise
   launches), beside the plain version's, ``torch.matmul`` on the
   dequantized weight and the bound.
   Then the card tests (``pytest -m gpu tests/test_torch_cuda.py``, in a
   child process on the same build) must all pass.
3. Serving: full-width qwen1.5-0.5b (24 layers, random weights from a
   numpy seed, every attention/MLP weight packed once to v1, v2 and v3)
   serves the same 8 requests three times through ``ServeEngine(slots=4,
   s_max=256)`` with every prompt prefilled in one piece (``chunk_len =
   s_max``, no speculation, no prefix cache: comparable with the one-shot
   engine of earlier revisions): with ``backend="auto"`` (which must
   resolve to v2, as the reference's auto does), ``"v1"`` and ``"v3"``.
   Each run's launch counters, set to 0 just before it, must cover every
   linear of every prefill and decode step with its own kernels and no
   other; the three runs' tokens must be identical; one prefill window's logits through
   v1, v2 and v3 must be bitwise equal (f32 and bf16) and within
   tolerance of the same model run through the plain versions.  A
   torch.profiler window profiles each backend's path (v2, v1, v3).
4. Engine: the same packed model through the continuous engine (4
   slots, s_max 256, ``chunk_len`` 32, ``page_tokens`` 16, prefix cache
   on, ``spec_len`` 4, a draft depth chosen from the weights' plane
   occupancy below the deepest tile group): 8 requests of 16 new tokens
   (3 prompts of 40-120 tokens, 2 pairs sharing a 64-token prefix, 1 at
   temperature 0.8) driven through ``submit``/``pump``/``step``/``poll``,
   four times: v3 with spec, chunking and the prefix cache; spec off;
   prefix cache off; ``auto`` (v2).  Each run must complete every
   request, stream token events equal to ``out_tokens``, launch only its
   backend's kernels, 168 per model pass, and add up its spec counters;
   v3's draft passes must launch the decode kernel (168 per draft step);
   the greedy tokens of the four runs must be identical.  Prints ms per
   engine step by kind (chunked, spec, decode), draft and verify ms per
   round, acceptance, tokens/s, TTFT per request, prefix hits and
   snapshots, and the decode kernel's ms per layer at the draft depth.
5. Compile: the offline compiler on the same full-width weights, dense,
   in the reference's layout (24 layers stacked per leaf): ``plan_model``
   at budget 0.06 and ``compile_model`` into a ``.smez`` in a temporary
   directory under ``auto`` (the plan's per-leaf settings, backends,
   crossbar reduction, seconds and megabytes are printed), booted by
   ``ServeEngine.from_artifact`` (its seconds beside the serving phase's
   inline packing) and serving the serving phase's 8 requests: only the
   plan's kernels, 168 launches per pass; one prefill window's logits
   within tolerance of the ``torch`` backend (f32) and of the plain
   versions (bf16); where every leaf is planned (8, 3, 1) the tokens must
   equal the serving phase's auto run bitwise.  Then the same under
   ``v3`` and the engine workload twice, with ``spec_depth="auto"`` and
   without: every draft pass launches the decode kernel 168 times, every
   draft dispatch resolves its layer's plan depth (never full
   precision), and the greedy tokens of the two runs are identical.
   Last, malformed operand lists (``rowid`` past the row tiles, ``nnz``
   past the list) must raise ``ValueError`` on the host, and a launch on
   good operands must still succeed.
6. Prints the compile readings as JSON, the kernels JSON line (times per
   model layer: 4 q/k/v/o + 2 wi/wg + 1 wo calls; decode M = 8 in the
   top-level keys, every M a kernel ran at under ``at_m``; v3-decode adds
   ``draft_depth``, the draft passes' ``draft_launches`` and ``draft_ms``
   / ``draft_full_ms`` per layer on the model's own operands;
   ``artifact_launches`` counts the compile phase's runs; every number
   measured in this run but ``bound_ms``), the card line and, last,
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
#: bytes written to flush the 50 MB L2 before each timed launch: ~0.3 ms on
#: the device, longer than the host takes to issue a wrapper's launches
FLUSH_BYTES = 2 ** 30
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


def ptxas_summary(reports) -> list:
    """One line per compiled kernel of nvcc's ``-Xptxas -v`` reports:
    library, demangled entry function, registers and spills."""
    import re
    import shutil
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    lines = []
    for lib, rep in reports.items():
        entry, spill = "?", ""
        for line in rep.splitlines():
            found = re.search(r"entry function '(\w+)'", line)
            if found:
                entry = found.group(1)
                if filt:
                    entry = subprocess.run(
                        [filt, entry], capture_output=True,
                        text=True).stdout.strip().split("(")[0]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                lines.append(f"{lib}: {entry}: {line.split(':', 1)[1].strip()}"
                             f"; {spill}")
    return lines


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, flush, iters: int = 10) -> float:
    """Median device ms of ``fn`` over ``iters`` launches, each after the
    L2 cache was flushed (the main path finds its weights cold).  The flush
    (:data:`FLUSH_BYTES`) keeps the device busy while the host issues the
    start event and ``fn``'s launches, so the events time device work, not
    the host's Python in front of it."""
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


#: kernel -> the Pallas kernel it replaces.  Each kernel's wrapper is the
#: function of that name in ``repro_torch/kernels/sme_spmm/<name>.py``,
#: its plain version ``<name>_plain`` there, its CUDA source
#: ``kernels/csrc/<name>.cu``
KERNELS = {
    "sme_spmm_planes_decode":
        "src/repro/kernels/sme_spmm/sme_spmm_planes_decode.py:157",
    "sme_spmm_planes": "src/repro/kernels/sme_spmm/sme_spmm_planes.py:77",
    "sme_spmm6": "src/repro/kernels/sme_spmm/sme_spmm6.py:54",
    "sme_spmm": "src/repro/kernels/sme_spmm/sme_spmm.py:54",
}


def _modules():
    import importlib
    return {name: importlib.import_module(
        f"repro_torch.kernels.sme_spmm.{name}") for name in KERNELS}


def wrappers():
    """{kernel name: its wrapper}, resolved from the modules."""
    return {name: getattr(mod, name) for name, mod in _modules().items()}


def zero_counts():
    for fn in wrappers().values():
        fn.launches = 0


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel backend through the kernels' plain versions (the
    backends resolve the wrappers from their modules at call time)."""
    mods = _modules()
    saved = {name: getattr(m, name) for name, m in mods.items()}
    for name, m in mods.items():
        setattr(m, name, getattr(m, f"{name}_plain"))
    try:
        yield
    finally:
        for name, m in mods.items():
            setattr(m, name, saved[name])


def bound_of(nbytes: float, flops: float):
    """(bound ms, what bounds it): bytes over the HBM rate or f32 FLOPs
    over the non-tensor peak, whichever takes longer."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _agg():
    return dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                max_abs_err=0.0, bytes=0.0, flops=0.0)


def _finish(agg):
    for a in agg.values():
        a["bound_by"] = bound_of(a.pop("bytes"), a.pop("flops"))[1]
    return agg


def check_close(kind, y, yp, ref, what):
    """Finite, kernel vs plain (TOL_PLAIN of max |plain|) and vs the f64
    oracle (TOL_ORACLE); returns (max |kernel - plain|, oracle rel)."""
    check(bool(torch.isfinite(y).all()), f"{kind} {what}: non-finite output")
    err = float((y - yp).abs().max())
    tol = TOL_PLAIN * float(yp.abs().max())
    check(err <= tol, f"{kind} {what}: |kernel - plain| {err} > {tol}")
    got = y[:, :ref.shape[1]].cpu().numpy()
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(rel <= TOL_ORACLE, f"{kind} {what}: oracle rel {rel}")
    return err, rel


def kernel_phase(dev, flush):
    from repro_torch.core.backend import get_backend
    from repro_torch.core.sme import sme_compress, sme_matmul_ref_np
    from repro_torch.kernels.sme_spmm.sme_spmm import (sme_spmm,
                                                        sme_spmm_plain)
    from repro_torch.kernels.sme_spmm.sme_spmm6 import (sme_spmm6,
                                                         sme_spmm6_plain)
    from repro_torch.kernels.sme_spmm.sme_spmm_planes import (
        sme_spmm_planes, sme_spmm_planes_plain)
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import (
        sme_spmm_planes_decode, sme_spmm_planes_decode_plain)
    from repro_torch.kernels import build
    rng = np.random.default_rng(SEED)
    agg = {k: _agg() for k in RUN_M}
    tile_agg = {(k, m): _agg() for k in ("sme_spmm", "sme_spmm6")
                for _, m in RUN_M}
    for name, K, N, calls in SHAPES:
        w = rng.standard_normal((K, N)) / np.sqrt(K)
        smew = sme_compress(w, n_bits=8, window=3, squeeze=1)
        packed = smew.pack_plane_csc()
        ops = {k: torch.as_tensor(v, device=dev) for k, v in packed.items()}
        args = [ops[k] for k in ("planes", "sign", "rowscale")]
        idx = [ops[k] for k in ("rowid", "shift", "last", "nnz")]
        on = lambda d, keys: [torch.as_tensor(d[k], device=dev) for k in keys]
        csc1 = smew.pack_csc()
        a1 = on(csc1, ("codes", "sign", "rowscale", "rowid", "nnz"))
        a2 = on(get_backend("v2").pack_weight(smew),
                ("packed", "rowscale", "rowid", "nnz"))
        occ = int(csc1["nnz"].sum())
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
        print_geometry(build, name, K, nt, ops["rowid"].shape[1],
                       a1[0].shape[1])
        for kind, m in RUN_M:
            x = rng.standard_normal((m, K)).astype(np.float32)
            xp = torch.as_tensor(x, device=dev)
            ref = sme_matmul_ref_np(x, smew)
            x128 = torch.zeros((-(-m // 128) * 128, K), device=dev)
            x128[:m] = xp
            # the v3 prefill kernel's scaled rows: what v1 and v2 must equal
            y_pre = (sme_spmm_planes(x128, *args, *idx)[:m]
                     * scale * 2.0 ** -8)[:, :N]
            if kind == "decode":
                def run(depth=None):
                    return sme_spmm_planes_decode(xp, *args, colscale, *idx,
                                                  plane_depth=depth)[:, :N]

                def plain():
                    return sme_spmm_planes_decode_plain(
                        xp, *args, colscale, *idx)[:, :N]
                kernel_only, plain_only = run, plain
            else:
                def kernel_only():
                    return sme_spmm_planes(xp, *args, *idx)

                def plain_only():
                    return sme_spmm_planes_plain(xp, *args, *idx)

                def run():
                    return (kernel_only() * scale * 2.0 ** -8)[:, :N]

                def plain():
                    return (plain_only() * scale * 2.0 ** -8)[:, :N]
            y, yp = run(), plain()
            torch.cuda.synchronize()
            check(y.shape == (m, N), f"{kind} {name}: misshapen output")
            err, rel = check_close(kind, y, yp, ref, name)
            extra = ""
            if kind == "decode":
                # decode kernel == prefill kernel (M padded to one 128 tile)
                check(bool(torch.equal(y, y_pre)),
                      f"{name} M={m}: decode kernel != prefill kernel bitwise")
                check(bool(torch.equal(run(deepest), y)),
                      f"{name}: plane_depth {deepest} is not a no-op")
                ref2 = np.asarray(x, np.float64) @ smew.dequant_topk_planes(2)
                rel2 = float(np.abs(run(2).cpu().numpy() - ref2).max()
                             / np.abs(ref2).max())
                check(rel2 <= TOL_ORACLE, f"{name}: plane_depth 2 rel {rel2}")
                extra = f" depth2_rel={rel2:.2e} decode==prefill"
            else:
                extra = f" (with epilogue {time_ms(run, flush) * 1e3:.1f} us)"
            ms = time_ms(kernel_only, flush)
            plain_ms = time_ms(plain_only, flush)
            lib_ms = time_ms(lambda: torch.matmul(xp, w_dense), flush)
            # bytes: x, every stored plane bitmap, sign + 2^row_exp of every
            # occupied tile, colscale, y; FLOPs: one 128x128 dot per group
            nbytes = (m * K * 4 + int(nnz.sum()) * 2048 + groups * (2048 + 512)
                      + nt * 128 * 4 + m * N * 4)
            flops = 2.0 * m * 128 * 128 * groups
            bound, by = bound_of(nbytes, flops)
            print(f"kernel {kind:7s} {name:6s} M={m:3d} K={K} N={N} "
                  f"planes={int(nnz.sum())} groups={groups}: "
                  f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
                  f"torch.matmul {lib_ms * 1e3:.1f} us, bound "
                  f"{bound * 1e3:.2f} us ({by}: {nbytes} B, {flops:.3g} FLOP)"
                  f" | max|k-p|={err:.2e} oracle_rel={rel:.2e}{extra}",
                  flush=True)
            a = agg[(kind, m)]
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("bound_ms", bound),
                             ("bytes", nbytes), ("flops", flops)):
                a[key] += calls * val
            a["max_abs_err"] = max(a["max_abs_err"], err)

            # v1 and v2: one kernel for decode and prefill, unscaled output
            for kname, kern, kplain, kargs, qscale, tile_bytes in (
                    ("sme_spmm", sme_spmm, sme_spmm_plain, a1, 2.0 ** -8,
                     16384 + 2048 + 512),
                    ("sme_spmm6", sme_spmm6, sme_spmm6_plain, a2, 2.0 ** -1,
                     12288 + 512)):
                def krun():
                    return (kern(xp, *kargs) * scale * qscale)[:, :N]

                def kplainrun():
                    return (kplain(xp, *kargs) * scale * qscale)[:, :N]
                y, yp = krun(), kplainrun()
                torch.cuda.synchronize()
                err, rel = check_close(kname, y, yp, ref, f"{name} M={m}")
                check(bool(torch.equal(y, y_pre)),
                      f"{kname} {name} M={m}: != v3 prefill kernel bitwise")
                ms = time_ms(lambda: kern(xp, *kargs), flush)
                plain_ms = time_ms(lambda: kplain(xp, *kargs), flush)
                epi_ms = time_ms(krun, flush)
                # bytes: x, each occupied tile's payload, the index (rowid
                # per occupied slot, nnz), y; FLOPs: one dot per tile
                nbytes = (m * K * 4 + occ * tile_bytes + occ * 4 + nt * 4
                          + m * N * 4)
                flops = 2.0 * m * 128 * 128 * occ
                bound, by = bound_of(nbytes, flops)
                print(f"kernel {kname:9s} {name:6s} M={m:3d} K={K} N={N} "
                      f"tiles={occ}: {ms * 1e3:.1f} us (with epilogue "
                      f"{epi_ms * 1e3:.1f} us), plain "
                      f"{plain_ms * 1e3:.1f} us, torch.matmul "
                      f"{lib_ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
                      f"({by}: {nbytes} B, {flops:.3g} FLOP) | max|k-p|="
                      f"{err:.2e} oracle_rel={rel:.2e} == v3", flush=True)
                a = tile_agg[(kname, m)]
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms), ("bound_ms", bound),
                                 ("bytes", nbytes), ("flops", flops)):
                    a[key] += calls * val
                a["max_abs_err"] = max(a["max_abs_err"], err)
    tile_csc_edges(dev, sme_compress, sme_matmul_ref_np)
    return _finish(agg), _finish(tile_agg)


#: (kind, M) the kernel phase runs: the smallest and largest decode bucket
#: and a prefill window
RUN_M = (("decode", 8), ("decode", 64), ("prefill", 512))


def print_geometry(build, name, K, nt, L3, L1):
    """Launch shape of the four kernels at one linear shape (L3: the v3
    list length, L1: the v1 and v2 one)."""
    parts = []
    for kernel, ms, extra in (("sme_spmm_planes_decode", (8, 64), (L3, 0)),
                              ("sme_spmm_planes", (512,), (L3,)),
                              ("sme_spmm6", (8, 64, 512), (L1,)),
                              ("sme_spmm", (8, 64, 512), (L1,))):
        for m in ms:
            g = build.geometry(kernel, m, K, nt, *extra)
            parts.append(f"{kernel} M={m}: {g['grid_x']}x{g['grid_y']} "
                         f"blocks, cluster {g['cluster']}, "
                         f"{g['smem_bytes']} B shared")
    print(f"geometry {name}: " + "; ".join(parts), flush=True)


def tile_csc_edges(dev, sme_compress, oracle):
    """v1, v2 and the v3 decode kernel on a pruned weight (empty tiles,
    column tile 1 empty: its output must be exactly 0) bitwise against the
    v3 prefill kernel, the decode kernel's ``plane_depth`` 1, 2 and 8 on
    those uneven lists, and v1 at settings v2 cannot hold, against the
    oracle."""
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels.sme_spmm.sme_spmm import sme_spmm
    from repro_torch.kernels.sme_spmm.sme_spmm6 import sme_spmm6
    from repro_torch.kernels.sme_spmm.sme_spmm_planes import sme_spmm_planes
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import \
        sme_spmm_planes_decode
    rng = np.random.default_rng(SEED + 2)
    w = rng.standard_normal((384, 384)) / np.sqrt(384)
    w[:, 128:256] = 0.0
    w[256:, :128] = 0.0
    w[:256, 256:] = 0.0
    on = lambda d, keys: [torch.as_tensor(d[k], device=dev) for k in keys]
    smew = sme_compress(w, squeeze=1)
    csc1 = smew.pack_csc()
    check(csc1["nnz"].tolist() == [2, 0, 1], f"pruned nnz {csc1['nnz']}")
    a1 = on(csc1, ("codes", "sign", "rowscale", "rowid", "nnz"))
    a2 = on(get_backend("v2").pack_weight(smew),
            ("packed", "rowscale", "rowid", "nnz"))
    a3 = on(smew.pack_plane_csc(), ("planes", "sign", "rowscale", "rowid",
                                    "shift", "last", "nnz"))
    scale = float(smew.scale.reshape(-1)[0])
    colscale = torch.full((3, 128), scale * 2.0 ** -8, device=dev)
    depth_rel = {}
    for m in (8, 64, 512):
        x = torch.as_tensor(rng.standard_normal((m, 384)), dtype=torch.float32,
                            device=dev)
        x128 = torch.zeros((-(-m // 128) * 128, 384), device=dev)
        x128[:m] = x
        y3 = sme_spmm_planes(x128, *a3)[:m] * scale * 2.0 ** -8
        y1 = sme_spmm(x, *a1) * scale * 2.0 ** -8
        y2 = sme_spmm6(x, *a2) * scale * 2.0 ** -1
        check(bool(torch.equal(y1, y3)) and bool(torch.equal(y2, y3)),
              f"pruned M={m}: v1/v2 != v3 bitwise")
        check(bool((y1[:, 128:256] == 0).all()), "empty column tile not 0")
        ref = oracle(x.cpu().numpy(), smew)
        rel = float(np.abs(y1.cpu().numpy() - ref).max() / np.abs(ref).max())
        check(rel <= TOL_ORACLE, f"pruned M={m}: oracle rel {rel}")
        if 2 * m > 128:
            continue

        def dec(depth=None):
            return sme_spmm_planes_decode(x, *a3[:3], colscale, *a3[3:],
                                          plane_depth=depth)
        yd = dec()
        check(bool(torch.equal(yd, y3)) and bool(torch.equal(dec(8), yd)),
              f"pruned M={m}: decode kernel != prefill kernel, or depth 8 "
              "is not a no-op")
        check(bool((yd[:, 128:256] == 0).all()), "decode: empty column not 0")
        for k in (1, 2):
            ref_k = np.asarray(x.cpu().numpy(), np.float64) \
                @ smew.dequant_topk_planes(k)
            rel_k = float(np.abs(dec(k).cpu().numpy() - ref_k).max()
                          / np.abs(ref_k).max())
            check(rel_k <= TOL_ORACLE, f"pruned M={m} depth {k}: rel {rel_k}")
            depth_rel[(m, k)] = rel_k
    rels = []
    for kw in (dict(squeeze=0), dict(window=4, squeeze=1)):
        wv = rng.standard_normal((1024, 1024)) / 32.0
        sv = sme_compress(wv, **kw)
        check(not get_backend("v2").supports(sv), f"v2 holds {kw}?")
        x = torch.as_tensor(rng.standard_normal((64, 1024)),
                            dtype=torch.float32, device=dev)
        y = sme_spmm(x, *on(sv.pack_csc(), ("codes", "sign", "rowscale",
                                             "rowid", "nnz")))
        y = y * float(sv.scale.reshape(-1)[0]) * 2.0 ** -8
        ref = oracle(x.cpu().numpy(), sv)
        rels.append(float(np.abs(y.cpu().numpy() - ref).max()
                          / np.abs(ref).max()))
        check(rels[-1] <= TOL_ORACLE, f"v1 at {kw}: oracle rel {rels[-1]}")
    torch.cuda.synchronize()
    print(f"kernel edges: pruned weight (tiles per column 2/0/1) v1 == v2 == "
          f"v3 == v3-decode bitwise at M = 8, 64 (and v1 == v2 == v3 at 512), "
          f"empty column exactly 0, decode plane_depth 8 a no-op, depth 1/2 "
          f"oracle rel <= {max(depth_rel.values()):.2e}; v1 at squeeze 0 / "
          f"window 4 oracle rel {rels[0]:.2e} / {rels[1]:.2e}", flush=True)


def card_tests() -> None:
    """The ``gpu``-marked tests, in a child process (it reuses the build)."""
    import os
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
    print(f"card tests: {tail[0]} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    check(proc.returncode == 0,
          f"card tests failed:\n{proc.stdout[-4000:]}{proc.stderr[-2000:]}")


def build_model_params(dev, cfg):
    """Full-width random weights, generated and packed layer by layer,
    each weight compressed once and packed for v1, v2 and v3."""
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
            init_layer(cfg, rng), backend="all", device=dev))
    return params, time.perf_counter() - t0


#: the serving phase's engine: every prompt prefilled in one piece (chunk
#: length s_max), no speculation, no prefix cache, so its readings compare
#: with the one-shot engine of earlier revisions
ONE_SHOT = dict(slots=4, s_max=256, chunk_len=256, prefix_cache=False)
#: serving runs: backend asked -> (what it must resolve to, its kernels)
RUNS = {"auto": ("v2", ("sme_spmm6",)), "v1": ("v1", ("sme_spmm",)),
        "v3": ("v3", ("sme_spmm_planes", "sme_spmm_planes_decode"))}


def serve_run(api, params, prompts, backend, card, route=None, label=None):
    """Serve the 8 requests once under ``backend``; returns (tokens,
    launches per kernel).  Counts are set to 0 just before.  ``route``:
    (what the weights must resolve to, the kernels they launch), by
    default :data:`RUNS`' entry for ``backend``."""
    from repro_torch.serve import Request, ServeEngine
    cfg = api.cfg
    want, mine = route or RUNS[backend]
    label = label or backend
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    eng = ServeEngine(api, params, backend=backend, device=api.device,
                      **ONE_SHOT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stats = eng.run(reqs, max_steps=200)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_pass = cfg.n_layers * 7
    passes = stats["prefills"] + stats["decode_steps"]
    print(f"serve[{label}]: {stats}", flush=True)
    print(f"serve[{label}]: launches {launches}, per model pass {per_pass}")
    check(stats["backend"] == want,
          f"{label}: backend {backend!r} resolved to {stats['backend']}, "
          f"not {want}")
    check(stats["completed"] == 8, f"completed {stats['completed']} of 8")
    check(all(len(r.out_tokens) == 16 for r in reqs), "short outputs")
    check(all(launches[k] == 0 for k in launches if k not in mine),
          f"{label}: kernels of another backend launched: {launches}")
    check(sum(launches[k] for k in mine) == per_pass * passes,
          f"{label}: {sum(launches[k] for k in mine)} launches of "
          f"{mine} != {per_pass} x {passes} model passes")
    check(all(launches[k] > 0 for k in mine),
          f"{label}: a kernel of the path never launched: {launches}")
    if "sme_spmm_planes_decode" in mine:
        n3 = len(_v3_params(params["blocks"]))     # v3 linears per pass
        check(launches["sme_spmm_planes_decode"]
              >= n3 * stats["decode_steps"],
              "v3 decode kernel does not cover every decode step")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"serve[{label}]: {n_tok / stats['wall_s']:.1f} tokens/s end to "
          f"end, {stats['decode_s'] / stats['decode_steps'] * 1e3:.2f} ms per "
          f"decode step (4 slots), "
          f"{stats['prefill_s'] / stats['prefills'] * 1e3:.1f} ms per "
          f"prefill, peak memory {peak_gb:.2f} GiB | {card}", flush=True)
    return [r.out_tokens for r in reqs], launches


def serve_phase(dev, card):
    from repro_torch.configs import ARCHS
    from repro_torch.core.integrate import sme_operand_bytes
    from repro_torch.models.model import build_model
    cfg = ARCHS["qwen1.5-0.5b"]
    params, pack_s = build_model_params(dev, cfg)
    print(f"serve: packed {cfg.n_layers} layers x 7 linears to v1, v2 and "
          f"v3 in {pack_s:.1f}s", flush=True)
    ob = sme_operand_bytes(params["blocks"])
    print("serve: operand bytes per weight over "
          f"{ob['weights']} weights: " + ", ".join(
              f"{be} {ob[be] / 1e6:.1f} MB = {ob[be] / ob['weights']:.4f} B"
              for be in ("v1", "v2", "v3"))
          + f"; dense bf16 {2 * ob['weights'] / 1e6:.1f} MB = 2 B",
          flush=True)
    api = build_model(cfg, device=dev)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(40, 121, size=8)]
    tokens, launches = {}, {}
    for backend in RUNS:
        tokens[backend], counts = serve_run(api, params, prompts, backend,
                                            card)
        for name in RUNS[backend][1]:
            launches[name] = counts[name]
    check(tokens["auto"] == tokens["v1"] == tokens["v3"],
          "v2 (auto), v1 and v3 served different tokens")
    print("serve: v2 (auto), v1 and v3 tokens identical", flush=True)

    # one prefill window (the engine's first: 4 rows, bucket 128): v1, v2
    # and v3 bitwise equal, and each within tolerance of the plain
    # versions, in f32 (the algorithm) and bf16 (as served)
    toks, plen = prefill_window(prompts)
    for dtype in ("float32", "bfloat16"):
        api_d = build_model(dataclasses.replace(cfg, dtype=dtype), device=dev)
        lk = {be: api_d.prefill(params, toks, s_max=256, plen=plen,
                                backend=be)[0] for be in ("v1", "v2", "v3")}
        check(bool(torch.equal(lk["v1"], lk["v2"]))
              and bool(torch.equal(lk["v1"], lk["v3"])),
              f"{dtype} prefill logits differ between v1, v2 and v3")
        for be, logits in lk.items():
            with plain_kernels():
                lp, _ = api_d.prefill(params, toks, s_max=256, plen=plen,
                                      backend=be)
            check(bool(torch.isfinite(logits).all())
                  and logits.shape == (4, cfg.vocab),
                  f"{dtype} {be} logits non-finite or misshapen")
            diff = float((logits - lp).abs().max() / lp.abs().max())
            agree = int((logits.argmax(-1) == lp.argmax(-1)).sum())
            print(f"serve: {dtype} {be} prefill logits kernels vs plain: max "
                  f"rel diff {diff:.2e} (tolerance {TOL_LOGITS[dtype]:.0e}), "
                  f"greedy agreement {agree}/4", flush=True)
            check(diff <= TOL_LOGITS[dtype],
                  f"{dtype} {be} logits rel diff {diff}")
        print(f"serve: {dtype} prefill logits v1 == v2 == v3 bitwise",
              flush=True)
    for backend in RUNS:
        profile_window(api, params, prompts[4:], card, backend)
    return launches, params, dict(pack_s=pack_s, prompts=prompts,
                                  auto_tokens=tokens["auto"])


def prefill_window(prompts):
    """The engine's first prefill window of ``prompts``: 4 rows right-padded
    to the bucket of 128, and their lengths."""
    toks = np.zeros((4, 128), np.int64)
    for i, p in enumerate(prompts[:4]):
        toks[i, :len(p)] = p
    return toks, [len(p) for p in prompts[:4]]


def profile_window(api, params, prompts, card, backend):
    """Where a serving window's time goes: torch.profiler over one prefill
    and 5 decode steps of 4 requests (after the counted runs)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(api, params, backend=backend, device=api.device,
                      **ONE_SHOT)
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
    print(f"profile[{stats['backend']}]: 1 prefill + "
          f"{stats['decode_steps']} decode steps, wall "
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


#: the engine phase: the reference's continuous engine settings
ENGINE = dict(slots=4, s_max=256, chunk_len=32, page_tokens=16, spec_len=4)
#: share of the weights' magnitude mass the draft depth keeps (the rule of
#: the reference compiler's ``draft_depth_from_occupancy``)
DRAFT_COVERAGE = 0.90
#: engine steps after which the second half of the workload is submitted:
#: by then the first pair members have scored their 64-token prefix
SECOND_WAVE_AT = 2


def _v3_params(tree):
    """Every packed linear (dict with v3 operands) of a param tree."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            if "sme_v3_planes" in t:
                out.append(t)
                return
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(tree)
    return out


def choose_spec_depth(params, coverage=DRAFT_COVERAGE):
    """One draft depth for the whole model from its plane occupancy: the
    smallest k whose top k planes per tile group keep ``coverage`` of the
    magnitude mass (set bits x 2^shift, what truncation drops), capped
    below the deepest group so the draft always truncates.  Returns (k,
    deepest, kept mass share, kept plane share)."""
    dev = params["blocks"][0]["mlp"]["wi"]["w"]["sme_v3_planes"].device
    lut = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.float64, device=dev)
    mass = torch.zeros(64, dtype=torch.float64, device=dev)
    count = torch.zeros(64, dtype=torch.float64, device=dev)
    for p in _v3_params(params["blocks"]):
        planes, shift = p["sme_v3_planes"], p["sme_v3_shift"]
        last, nnz = p["sme_v3_last"], p["sme_v3_nnz"]
        nt, L = shift.shape
        slot = torch.arange(L, device=dev).expand(nt, L)
        start = torch.ones_like(last, dtype=torch.bool)
        start[:, 1:] = last[:, :-1] == 1
        rank = slot - torch.cummax(torch.where(start, slot, 0), dim=1).values
        valid = slot < nnz[:, None].long()
        pop = lut[planes.long()].sum(dim=(-1, -2))
        m = pop * torch.exp2(shift.double())
        mass += torch.bincount(rank[valid], weights=m[valid], minlength=64)
        count += torch.bincount(rank[valid], minlength=64).double()
    deepest = int(torch.nonzero(count).max()) + 1
    share = (mass.cumsum(0) / mass.sum()).cpu().numpy()
    kept = (count.cumsum(0) / count.sum()).cpu().numpy()
    k = next((k for k in range(1, deepest) if share[k - 1] >= coverage),
             deepest - 1)
    return k, deepest, float(share[k - 1]), float(kept[k - 1])


def engine_workload(vocab):
    """8 requests of 16 new tokens: 3 with 40-120-token prompts, 2 pairs
    sharing a 64-token prefix (72-88 tokens each), 1 sampled at
    temperature 0.8.  The first wave holds one member of each pair."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 2)
    longs = [rng.integers(0, vocab, int(n)) for n in rng.integers(40, 121, 3)]
    pairs = []
    for _ in range(2):
        prefix = rng.integers(0, vocab, 64)
        pairs.append([np.concatenate([prefix, rng.integers(
            0, vocab, int(rng.integers(8, 25)))]) for _ in range(2)])
    hot = rng.integers(0, vocab, 24)
    first = [pairs[0][0], longs[0], pairs[1][0], longs[1]]
    second = [pairs[0][1], pairs[1][1], longs[2], hot]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(first + second)]
    reqs[-1].temperature = 0.8
    return reqs[:4], reqs[4:]


def engine_run(api, params, backend, spec_depth, prefix_cache):
    """Drive the workload once through submit/pump/step/poll.  Returns the
    requests, the engine, per-request token events and TTFT, wall seconds,
    model passes (prefill + decode_step calls, counted on the API) and the
    v3 decode kernel's launches inside draft passes."""
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import \
        sme_spmm_planes_decode as dec
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(api, params, backend=backend, device=api.device,
                      spec_depth=spec_depth, prefix_cache=prefix_cache,
                      **ENGINE)
    passes, draft_launches = [0], [0]

    def counted(fn):
        def call(*a, **kw):
            passes[0] += 1
            return fn(*a, **kw)
        return call
    api.prefill, api.decode_step = counted(api.prefill), \
        counted(api.decode_step)
    draft = eng._draft

    def counted_draft(rows):
        n0 = dec.launches
        out = draft(rows)
        draft_launches[0] += dec.launches - n0
        return out
    eng._draft = counted_draft
    first, second = engine_workload(api.cfg.vocab)
    events, t_sub, ttft = {}, {}, {}
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for r in first:
        eng.submit(r)
        t_sub[r.rid] = time.perf_counter()
    steps = 0
    while not all(r.done for r in first + second):
        check(steps < 400, f"engine[{backend}]: not done in 400 steps")
        if steps == SECOND_WAVE_AT:
            for r in second:
                eng.submit(r)
                t_sub[r.rid] = time.perf_counter()
        eng.pump()
        eng.step()
        steps += 1
        now = time.perf_counter()
        for ev in eng.poll():
            if ev["kind"] == "token":
                events.setdefault(ev["rid"], []).append(ev["token"])
                ttft.setdefault(ev["rid"], now - t_sub[ev["rid"]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers().items()}
    del api.prefill, api.decode_step
    return dict(reqs=first + second, eng=eng, events=events, ttft=ttft,
                wall=wall, steps=steps, passes=passes[0],
                launches=launches, draft_launches=draft_launches[0])


def draft_layer_ms(params, depth, flush):
    """Device ms of one model layer's 7 decode-kernel launches at M = 8
    (the engine's 4 slots, padded), full precision and at ``depth`` (an
    int, or ``"plan"``: each linear's ``sme_draft_planes``), on layer 0's
    packed operands."""
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import \
        sme_spmm_planes_decode as dec
    ops = ("planes", "sign", "rowscale", "rowid", "shift", "last", "nnz")
    calls = []
    for p in _v3_params(params["blocks"][0]):
        a = {o: p[f"sme_v3_{o}"] for o in ops}
        nt, _, bk8, bn = a["planes"].shape
        nr = -(-p["sme_sign"].shape[-2] // (bk8 * 8))
        x = torch.randn((8, nr * bk8 * 8), device=a["planes"].device)
        cs = torch.full((nt, bn), 1e-3, device=x.device)
        d = int(p["sme_draft_planes"]) if depth == "plan" else depth
        calls.append((x, [a["planes"], a["sign"], a["rowscale"], cs,
                          a["rowid"], a["shift"], a["last"], a["nnz"]], d))

    def layer(truncate):
        for x, args, d in calls:
            dec(x, *args, plane_depth=d if truncate else None)
    return time_ms(lambda: layer(False), flush), \
        time_ms(lambda: layer(True), flush)


def engine_phase(dev, card, params):
    """The continuous engine on the serving phase's packed model: v3 with
    chunked prefill, the prefix cache and self-speculative decode, then the
    same workload with spec off, with the prefix cache off, and under auto
    (v2).  Returns the v3-decode row's draft keys for the JSON line."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    api = build_model(ARCHS["qwen1.5-0.5b"], device=dev)
    depth, deepest, share, kept = choose_spec_depth(params)
    check(1 <= depth < deepest, f"draft depth {depth} of {deepest}")
    print(f"engine: draft depth {depth} of the deepest group's {deepest} "
          f"planes: keeps {100 * share:.2f}% of the weights' magnitude mass "
          f"and {100 * kept:.2f}% of the plane entries ({ENGINE}, prefix "
          f"cache on, spec_len {ENGINE['spec_len']})", flush=True)
    runs = {}
    for name, backend, spec, prefix in (
            ("v3 spec+chunk+prefix", "v3", depth, True),
            ("v3 spec off", "v3", None, True),
            ("v3 prefix off", "v3", depth, False),
            ("auto (v2) spec+chunk+prefix", "auto", depth, True)):
        r = runs[name] = engine_run(api, params, backend, spec, prefix)
        eng, reqs, m = r["eng"], r["reqs"], r["eng"]._m
        stats = eng.stats
        check(all(q.outcome == "completed" and len(q.out_tokens) == 16
                  for q in reqs), f"engine[{name}]: incomplete requests")
        check(all(r["events"].get(q.rid) == q.out_tokens for q in reqs),
              f"engine[{name}]: poll's token events != out_tokens")
        mine = ("sme_spmm6",) if backend == "auto" else \
            ("sme_spmm_planes", "sme_spmm_planes_decode")
        got = sum(r["launches"][k] for k in mine)
        check(all(r["launches"][k] == 0 for k in r["launches"]
                  if k not in mine), f"engine[{name}]: other kernels launched")
        check(got == api.cfg.n_layers * 7 * r["passes"],
              f"engine[{name}]: {got} launches of {mine} != 168 x "
              f"{r['passes']} model passes")
        check(all(r["launches"][k] > 0 for k in mine),
              f"engine[{name}]: a kernel of the path never launched: "
              f"{r['launches']}")
        drafted = m["spec_draft_tokens"].value
        check(m["spec_accepted"].value + m["spec_rolled_back"].value
              == drafted, f"engine[{name}]: spec counters do not add up")
        if spec is not None:
            check(m["spec_rounds"].value > 0, f"engine[{name}]: no spec round")
            if backend == "v3":
                check(r["draft_launches"] == api.cfg.n_layers * 7 * ENGINE[
                    "spec_len"] * m["spec_rounds"].value,
                      f"engine[{name}]: draft passes launched "
                      f"{r['draft_launches']} decode kernels")
        if prefix:
            check(m["prefix_hits"].value >= 1, f"engine[{name}]: no hit")
        n_tok = sum(len(q.out_tokens) for q in reqs)
        split = ", ".join(f"{k} {n} x {ms:.1f} ms"
                          for k, (n, ms) in eng.step_ms().items())
        ds, vs = m["spec_draft_s"], m["spec_verify_s"]
        pf_ms = 1e3 * stats["prefill_s"] / max(stats["prefills"], 1)
        print(f"engine[{name}]: {r['steps']} steps ({split}); prefills "
              f"{stats['prefills']} x {pf_ms:.1f} ms; "
              f"{r['passes']} model passes; {n_tok} tokens in "
              f"{r['wall']:.2f} s = {n_tok / r['wall']:.2f} tokens/s | "
              f"{card}", flush=True)
        print(f"engine[{name}]: spec rounds {int(m['spec_rounds'].value)}, "
              f"draft {1e3 * ds.sum / max(ds.count, 1):.1f} ms and verify "
              f"{1e3 * vs.sum / max(vs.count, 1):.1f} ms per round, "
              f"accepted {int(m['spec_accepted'].value)} of "
              f"{int(drafted)} drafted "
              f"({100 * m['spec_accepted'].value / max(drafted, 1):.1f}%), "
              f"rolled back {int(m['spec_rolled_back'].value)}; prefix hits "
              f"{int(m['prefix_hits'].value)}, misses "
              f"{int(m['prefix_misses'].value)}, snapshots "
              f"{int(m['prefix_snapshots'].value)}; draft-pass decode "
              f"launches {r['draft_launches']}; launches {r['launches']}",
              flush=True)
        print(f"engine[{name}]: TTFT ms per request " + ", ".join(
            f"{q.rid}:{1e3 * r['ttft'][q.rid]:.0f}" for q in reqs),
              flush=True)
    greedy = {name: [q.out_tokens for q in r["reqs"] if q.temperature == 0]
              for name, r in runs.items()}
    base = greedy["v3 spec+chunk+prefix"]
    check(all(g == base for g in greedy.values()),
          "engine: greedy tokens differ between spec on/off, prefix cache "
          "on/off and v3/v2")
    print("engine: greedy tokens identical across the four runs; "
          "distinct tokens per request: " + ", ".join(
              f"{q.rid}:{len(set(q.out_tokens))}"
              for q in runs["v3 spec+chunk+prefix"]["reqs"]), flush=True)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    full_ms, draft_ms = draft_layer_ms(params, depth, flush)
    del flush
    print(f"engine: decode kernel per model layer at M = 8: full "
          f"{full_ms:.4f} ms, draft (depth {depth}) {draft_ms:.4f} ms "
          f"({draft_ms / full_ms:.3f}x) | {card}", flush=True)
    print(f"engine: phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return {"draft_depth": depth,
            "draft_launches": runs["v3 spec+chunk+prefix"]["draft_launches"],
            "draft_ms": draft_ms, "draft_full_ms": full_ms}


#: the compile phase: the reference compiler CLI's default error budget
BUDGET = 0.06
#: plan backend -> the kernels its weights launch
KERNELS_OF = {"v1": ("sme_spmm",), "v2": ("sme_spmm6",),
              "v3": ("sme_spmm_planes", "sme_spmm_planes_decode")}


def dense_reference_tree(cfg):
    """``build_model_params``' weights before packing (the same numpy seed
    and draws), in the reference's layout: every layer's leaf stacked."""
    from repro_torch.convert import to_reference
    from repro_torch.models.transformer import init_layer
    rng = np.random.default_rng(SEED)
    embed = rng.standard_normal((cfg.vocab, cfg.d_model), dtype=np.float32)
    return to_reference({
        "embed": {"w": embed * np.float32(EMBED_STD)},
        "final_norm": {"w": np.ones(cfg.d_model, np.float32)},
        "blocks": [init_layer(cfg, rng) for _ in range(cfg.n_layers)]})


def compile_artifact(tree, backend, out, cfg, card):
    """Plan and pack ``tree`` under ``backend`` into ``out``; print the
    per-leaf plan, its summary and the seconds and megabytes.  Returns
    the plan and the readings."""
    from repro_torch.compiler import compile_model, plan_model
    t0 = time.perf_counter()
    plan = plan_model(tree, error_budget=BUDGET, backend=backend)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compile_model(tree, plan=plan, out=out, extra={
        "arch": "qwen1.5-0.5b", "config": cfg.name,
        "dims": {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
                 "vocab": cfg.vocab, "n_layers": cfg.n_layers,
                 "head_dim": cfg.hd}, "serve_backend": "auto"})
    pack_s = time.perf_counter() - t0
    files = [f for f in out.rglob("*") if f.is_file()]
    mb = sum(f.stat().st_size for f in files) / 1e6
    for key, lp in sorted(plan.layers.items()):
        print(f"compile[{backend}]: {key} {lp.shape} x {lp.n_slices}: "
              f"(n_bits, window, squeeze, squeeze_max) = ({lp.n_bits}, "
              f"{lp.window}, {lp.squeeze}, {lp.squeeze_max}) -> {lp.backend}, "
              f"{lp.bytes_per_weight:.4f} B/weight, rel err "
              f"{lp.error_bound:.4f}, crossbars {lp.crossbars} of "
              f"{lp.crossbars_dense} ({lp.crossbar_reduction:.2f}x), draft "
              f"depth {lp.draft_planes}", flush=True)
    print(f"compile[{backend}]: summary {plan.summary()}", flush=True)
    print(f"compile[{backend}]: plan {plan_s:.1f}s, pack and save "
          f"{pack_s:.1f}s, {mb:.1f} MB on disk in {len(files)} files "
          f"(budget {BUDGET}) | {card}", flush=True)
    return plan, dict(plan_s=plan_s, pack_s=pack_s, mb=mb)


@contextlib.contextmanager
def spec_depth_spy():
    """Record ``(id(param), resolved depth)`` of every v3 dispatch made
    under a draft's ``use_spec_depth`` (sme_apply resolves through the
    module's name)."""
    import repro_torch.core.backend as B
    real, seen = B.resolve_spec_depth, []

    def spy(param=None, plane_depth=None):
        got = real(param, plane_depth)
        if B._spec_stack[-1] is not None:
            seen.append((id(param), got))
        return got
    B.resolve_spec_depth = spy
    try:
        yield seen
    finally:
        B.resolve_spec_depth = real


def boot(api, path, card, inline_s):
    """``ServeEngine.from_artifact`` onto the card, timed to the last leaf
    on the device."""
    from repro_torch.serve import ServeEngine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine.from_artifact(api, path, **ONE_SHOT)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    print(f"compile: booted {path.name} in {boot_s:.2f}s (from_artifact: "
          f"map, check every operand list, copy to the card), against "
          f"{inline_s:.1f}s for the inline convert_params_to_sme of the "
          f"serving phase | {card}", flush=True)
    return eng, boot_s


def measured_replan(dev, tree, plan_bytes, tmp, card):
    """The planner on the card's own times: each backend's decode kernel
    at M = 1 (padded to the kernels' 8 rows; the launch alone, L2
    flushed, as in the kernel phase) at the three linear shapes, recorded
    in an autotune cache, then ``plan_model`` under ``auto`` once more
    with it.  Prints each leaf's choice by bytes against its choice by
    measured time."""
    from repro_torch.compiler import plan_model
    from repro_torch.core.backend import get_backend
    from repro_torch.core.sme import sme_compress
    from repro_torch.hardware.autotune import (AutotuneCache, TuneKey,
                                               device_kind)
    kernels = wrappers()
    cache = AutotuneCache(str(tmp / "autotune.json"))
    rng = np.random.default_rng(SEED + 3)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def on(d, keys):
        return [torch.as_tensor(d[k], device=dev) for k in keys]
    for _, K, N, _ in SHAPES:
        smew = sme_compress(rng.standard_normal((K, N)) / np.sqrt(K))
        v3 = on(smew.pack_plane_csc(), ("planes", "sign", "rowscale",
                                        "rowid", "shift", "last", "nnz"))
        cs = torch.ones((v3[0].shape[0], 128), device=dev)
        calls = {
            "v1": (kernels["sme_spmm"], on(smew.pack_csc(), (
                "codes", "sign", "rowscale", "rowid", "nnz"))),
            "v2": (kernels["sme_spmm6"], on(get_backend("v2").pack_weight(
                smew), ("packed", "rowscale", "rowid", "nnz"))),
            "v3": (kernels["sme_spmm_planes_decode"], v3[:3] + [cs] + v3[3:])}
        x = torch.zeros((8, K), device=dev)
        x[0] = torch.randn(K, device=dev)
        us = {}
        for be, (fn, args) in calls.items():
            us[be] = 1e3 * time_ms(lambda: fn(x, *args), flush)
            cache.record(TuneKey(be, 1, K, N, 128, device_kind()), us[be])
        print(f"compile: M = 1 decode kernels at {K}x{N} ({device_kind()}): "
              + ", ".join(f"{be} {t:.1f} us" for be, t in us.items())
              + f" | {card}", flush=True)
    del flush
    cache.save()
    t0 = time.perf_counter()
    measured = plan_model(tree, error_budget=BUDGET, backend="auto",
                          autotune=cache)
    plan_s = time.perf_counter() - t0
    moved = 0
    for key, lp in sorted(plan_bytes.layers.items()):
        mp = measured.layers[key]
        moved += lp.backend != mp.backend
        print(f"compile: {key}: by bytes ({lp.n_bits}, {lp.window}, "
              f"{lp.squeeze}) {lp.backend}, by measured time ({mp.n_bits}, "
              f"{mp.window}, {mp.squeeze}) {mp.backend}", flush=True)
    print(f"compile: the measured plan ({plan_s:.1f}s) moved {moved} of "
          f"{len(plan_bytes.layers)} leaves to another backend; summary "
          f"{measured.summary()}", flush=True)
    return {key: lp.backend for key, lp in sorted(measured.layers.items())}


def compile_phase(dev, card, served):
    """The offline compiler on full-width qwen1.5-0.5b (the serving phase's
    weights, dense): plan, pack and persist a ``.smez`` under ``auto``,
    boot it with ``from_artifact`` and serve the serving phase's 8
    requests through the plan's kernels; then the same under ``v3`` and
    the engine workload with ``spec_depth="auto"`` (each layer's plan
    depth) and without; then malformed operand lists refused on the host
    with the context left usable.  Returns the readings and the launches
    per kernel of the artifact runs."""
    import shutil
    import tempfile
    import repro_torch.core.backend as B
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    cfg = ARCHS["qwen1.5-0.5b"]
    api = build_model(cfg, device=dev)
    tree = dense_reference_tree(cfg)
    out, launches = {}, {name: 0 for name in KERNELS}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="smez-"))
    try:
        # -- auto: the plan's backends, one-shot serving
        path = tmp / "auto.smez"
        plan, out["auto"] = compile_artifact(tree, "auto", path, cfg, card)
        eng, out["auto"]["boot_s"] = boot(api, path, card, served["pack_s"])
        params = eng.params
        del eng
        bes = sorted({lp.backend for lp in plan.layers.values()})
        mine = tuple(k for be in bes for k in KERNELS_OF[be])
        tokens, counts = serve_run(api, params, served["prompts"], "auto",
                                   card, route=("+".join(bes), mine),
                                   label="artifact auto")
        for k in launches:
            launches[k] += counts[k]
        toks, plen = prefill_window(served["prompts"])
        for dtype, plain in (("float32", "torch"), ("bfloat16", "plain")):
            api_d = build_model(dataclasses.replace(cfg, dtype=dtype),
                                device=dev)
            lk = api_d.prefill(params, toks, s_max=256, plen=plen)[0]
            if plain == "torch":
                lp = api_d.prefill(params, toks, s_max=256, plen=plen,
                                   backend="torch")[0]
            else:
                with plain_kernels():
                    lp = api_d.prefill(params, toks, s_max=256, plen=plen)[0]
            check(bool(torch.isfinite(lk).all())
                  and lk.shape == (4, cfg.vocab), f"{dtype} logits")
            diff = float((lk - lp).abs().max() / lp.abs().max())
            print(f"compile: {dtype} prefill logits of the auto artifact, "
                  f"kernels vs {plain}: max rel diff {diff:.2e} (tolerance "
                  f"{TOL_LOGITS[dtype]:.0e})", flush=True)
            check(diff <= TOL_LOGITS[dtype], f"{dtype} artifact logits {diff}")
        uniform = all((lp.n_bits, lp.window, lp.squeeze, lp.squeeze_max,
                       lp.reorder) == (8, 3, 1, 0, False)
                      for lp in plan.layers.values())
        same = tokens == served["auto_tokens"]
        print(f"compile: every leaf planned (8, 3, 1): {uniform}; tokens "
              f"equal the serving phase's auto run bitwise: {same}",
              flush=True)
        if uniform:
            check(same, "a (8, 3, 1) plan served other tokens than the "
                        "inline (8, 3, 1) weights")
        del params
        shutil.rmtree(path)
        torch.cuda.empty_cache()

        plan_auto = plan

        # -- v3: the engine with spec at each layer's plan depth, and without
        path = tmp / "v3.smez"
        plan, out["v3"] = compile_artifact(tree, "v3", path, cfg, card)
        eng, out["v3"]["boot_s"] = boot(api, path, card, served["pack_s"])
        params = eng.params
        del eng
        layers = [p for blk in params["blocks"] for p in _v3_params(blk)]
        check(len(layers) == 7 * cfg.n_layers, "v3 artifact: packed linears")
        expect = {id(p): int(p["sme_draft_planes"]) for p in layers}
        depths = {k: lp.draft_planes for k, lp in sorted(plan.layers.items())}
        print(f"compile: v3 draft depths per leaf {depths}", flush=True)
        runs = {}
        for name, spec in (("spec auto", "auto"), ("spec off", None)):
            with spec_depth_spy() as seen:
                r = runs[name] = engine_run(api, params, "v3", spec, True)
            m = r["eng"]._m
            per_pass = 7 * cfg.n_layers
            check(all(q.outcome == "completed" for q in r["reqs"]),
                  f"artifact v3 {name}: incomplete requests")
            check(sum(r["launches"][k] for k in KERNELS_OF["v3"])
                  == per_pass * r["passes"]
                  and all(r["launches"][k] == 0 for k in r["launches"]
                          if k not in KERNELS_OF["v3"]),
                  f"artifact v3 {name}: launches {r['launches']} for "
                  f"{r['passes']} passes")
            for k in launches:
                launches[k] += r["launches"][k]
            rounds = int(m["spec_rounds"].value)
            drafted = m["spec_draft_tokens"].value
            if spec is not None:
                check(rounds > 0, "artifact v3: no spec round")
                check(r["draft_launches"]
                      == per_pass * ENGINE["spec_len"] * rounds,
                      f"artifact v3: draft passes launched "
                      f"{r['draft_launches']} decode kernels over {rounds} "
                      f"rounds")
                check(len(seen) == r["draft_launches"]
                      and all(d is not None and d == expect[i]
                              for i, d in seen),
                      "artifact v3: a draft dispatch did not resolve its "
                      "layer's plan depth")
            n_tok = sum(len(q.out_tokens) for q in r["reqs"])
            print(f"compile: engine[v3 artifact, {name}]: {r['steps']} "
                  f"steps, {r['passes']} passes, {n_tok} tokens in "
                  f"{r['wall']:.2f}s = {n_tok / r['wall']:.2f} tokens/s; "
                  f"spec rounds {rounds}, accepted "
                  f"{int(m['spec_accepted'].value)} of {int(drafted)}; "
                  f"draft-pass decode launches {r['draft_launches']}, "
                  f"dispatches at plan depth {len(seen)}; launches "
                  f"{r['launches']} | {card}", flush=True)
        greedy = [[q.out_tokens for q in r["reqs"] if q.temperature == 0]
                  for r in runs.values()]
        check(greedy[0] == greedy[1],
              "artifact v3: greedy tokens differ with and without spec")
        print("compile: v3 artifact greedy tokens identical with spec at "
              "the plan depths and without", flush=True)
        out["v3"]["draft_launches"] = runs["spec auto"]["draft_launches"]
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
        full_ms, plan_ms = draft_layer_ms(params, "plan", flush)
        del flush
        out["v3"].update(layer_full_ms=full_ms, layer_draft_ms=plan_ms)
        print(f"compile: v3 artifact decode kernel per model layer at M = 8: "
              f"full {full_ms:.4f} ms, at the plan depths {plan_ms:.4f} ms "
              f"({plan_ms / full_ms:.3f}x) | {card}", flush=True)

        # -- malformed lists are refused on the host; the card goes on
        p = params["blocks"][0]["mlp"]["wi"]["w"]
        nr, L = p["sme_codes"].shape[0], p["sme_v3_rowid"].shape[1]
        for key, value, what in (("sme_v3_rowid", nr, "rowid"),
                                 ("sme_v3_nnz", L + 1, "nnz")):
            bad = dict(p)
            bad[key] = p[key].clone()
            bad[key].view(-1)[0] = value
            try:
                B.validate_operands(bad, "v3")
            except ValueError as err:
                print(f"compile: malformed {what} refused: {err}", flush=True)
            else:
                raise AssertionError(f"malformed {what} was not refused")
        x = torch.randn((4, p["sme_sign"].shape[-2]), device=dev)
        y = B.sme_apply(x, p, "v3")
        torch.cuda.synchronize()
        with plain_kernels():
            yp = B.sme_apply(x, p, "v3")
        err = float((y - yp).abs().max())
        check(bool(torch.isfinite(y).all())
              and err <= TOL_PLAIN * float(yp.abs().max()),
              f"launch after a refused list: |kernel - plain| {err}")
        print(f"compile: a launch on good operands after the refusals: "
              f"|kernel - plain| {err:.2e}", flush=True)
        del params
        torch.cuda.empty_cache()
        out["measured_plan"] = measured_replan(dev, tree, plan_auto, tmp,
                                               card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"compile: phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return out, launches


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
    for line in ptxas_summary(reports):
        print(f"  ptxas {line}")

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    agg, tile_agg = kernel_phase(dev, flush)
    del flush                    # not part of the serving peak memory
    card_tests()
    launches, params, served = serve_phase(dev, card)
    draft = engine_phase(dev, card, params)
    del params
    torch.cuda.empty_cache()
    compiled, artifact_launches = compile_phase(dev, card, served)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    rows = []
    for name, pallas in KERNELS.items():
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": pallas, "launches": launches[name]}
        if name == "sme_spmm_planes":
            at = {"512": agg[("prefill", 512)]}
        elif name == "sme_spmm_planes_decode":
            at = {str(m): agg[(kind, m)] for kind, m in RUN_M
                  if kind == "decode"}
        else:
            at = {str(m): tile_agg[(name, m)] for _, m in RUN_M}
        at = {m: {k: a[k] for k in keys} for m, a in at.items()}
        row.update(at["512" if name == "sme_spmm_planes" else "8"])
        row["at_m"] = at
        if name == "sme_spmm_planes_decode":
            row.update(draft)
        # the compile phase's runs from the two artifacts
        row["artifact_launches"] = artifact_launches[name]
        rows.append(row)
    # times are per model layer: 4 q/k/v/o + 2 wi/wg + 1 wo calls
    print(json.dumps({"compile": compiled}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
