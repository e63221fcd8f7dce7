#!/usr/bin/env python3
"""Pack the weights F4 parted on (ROADMAP §3) several times in a spawned
pool, paused again and again, and compare every operand's bytes with
one in-process pack of the same task:

    python3 tools/f4_repack.py [--pause] [--rounds 3] [--period-s 0.05]
                               [--small] [--repeat 1]

The tasks are ``chip_smoke.py``'s own (the same names, seeds, shapes and
formats): Jamba's first two head slabs (4096 x 16384) and llava's
7168 x 7168 ``patch_proj``; ``--small`` cuts each to its first 512 rows
and columns (a quick check of the tool itself).  With ``--pause`` the
pool is ``chip_smoke.Packer`` itself (its units, its shared flag): a
thread holds ``Packer.paused`` for ``--period-s`` seconds, then lets the
pool run as long, as the script's ``quiet`` pauses it for its readings
(no signal reaches the pool), and the line after the packs gives the
pauses and how long they waited for the units in flight.  Without it
(the reproducer of F4) the pool is ``PACK_WORKERS`` spawned processes
at nice 19 packing whole tasks, which a thread stops and continues with
SIGSTOP/SIGCONT every ``--period-s`` seconds, as the script did up to
its F4 repair.  Either way this process packs each task ``--repeat``
times meanwhile (the first pack is the reference, the others must
equal it); ``--period-s 0`` never pauses or stops.  Before the packs,
``np.packbits`` (v3's plane bitmaps) is held against a plain shift-and-
add on one input at 64 byte offsets.  Prints the host's CPU and numpy's
SIMD dispatch, one line per task and round (equal, or the leaves that
differ and, for the planes, how many column tiles), and exits 1 if any
differs.  Needs no card: run it on the card host to test that host's
CPU.
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import pathlib
import signal
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def small_task(task):
    """A task cut to its first 512 rows and columns."""
    name, seed, (k, n), std, backend = task
    return name, seed, (min(k, 512), min(n, 512)), std, backend


def tasks(small: bool):
    import chip_smoke as cs
    # the offsets chip_smoke.main gives the models' seeds
    jamba = [t for t in cs.recurrent_tasks("jamba", 100000 * 5)
             if t[0] in ("head/0", "head/1")]
    llava = [t for t in cs.slice_tasks("llava", 100000 * 3)
             if t[0] == "patch_proj"]
    out = jamba + llava
    return [small_task(t) for t in out] if small else out


def packbits_offsets() -> int:
    """Byte offsets (of 64) at which ``np.packbits(axis=1)`` of a [300,
    128, 128] bit array differs from a plain shift-and-add."""
    import numpy as np
    bits = (np.random.default_rng(0).random((300, 128, 128)) < 0.5
            ).astype(np.uint8)
    w = (1 << np.arange(7, -1, -1)).astype(np.uint8)
    want = (bits.reshape(300, 16, 8, 128) * w[None, None, :, None]).sum(
        axis=2, dtype=np.uint8)
    bad = 0
    for off in range(64):
        buf = np.zeros(bits.nbytes + 64, np.uint8)
        a = buf[off:off + bits.nbytes].reshape(bits.shape)
        a[...] = bits
        bad += not np.array_equal(np.packbits(a, axis=1), want)
    return bad


def tiles_differing(a, b) -> int:
    """Column tiles whose planes differ ([nc, L, ...] operands)."""
    import numpy as np
    if a.shape != b.shape:
        return -1
    return int((a != b).reshape(a.shape[0], -1).any(axis=1).sum())


def report(got: dict, ref: dict, diff: list) -> str:
    if not diff:
        return "equal"
    planes = [k for k in diff if k.endswith("_planes")]
    return (f"differs in {diff}" + "".join(
        f"; {k}: {tiles_differing(got[k], ref[k])} of {ref[k].shape[0]} "
        f"column tiles" for k in planes))


def differs(a: dict, b: dict) -> list:
    import numpy as np
    if sorted(a) != sorted(b):
        return ["keys"]
    return [k for k in a
            if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not np.array_equal(np.ascontiguousarray(a[k]).reshape(-1)
                                  .view(np.uint8),
                                  np.ascontiguousarray(b[k]).reshape(-1)
                                  .view(np.uint8))]


def stop_pool(todo, rounds, period_s):
    """The reproducer's pool: whole tasks in ``PACK_WORKERS`` processes,
    stopped and continued every ``period_s`` by a thread.  Returns
    ([(round, name, a call that waits for its (name, pack))], a call
    that ends the pool and says how often it was stopped)."""
    import chip_smoke as cs
    pool = multiprocessing.get_context("spawn").Pool(
        cs.PACK_WORKERS, initializer=cs._low_priority)
    pending = [(r, t[0], pool.apply_async(cs.pack_task, (t,)))
               for r in range(rounds) for t in todo]
    done = threading.Event()
    cycles = [0]

    def signal_all(sig):
        for proc in pool._pool:
            try:
                os.kill(proc.pid, sig)
            except (ProcessLookupError, TypeError):
                pass

    def cycle():
        while period_s > 0 and not done.is_set():
            for sig in (signal.SIGSTOP, signal.SIGCONT):
                signal_all(sig)
                time.sleep(period_s)
            cycles[0] += 1
    th = threading.Thread(target=cycle, daemon=True)
    th.start()

    def end():
        done.set()
        th.join()
        signal_all(signal.SIGCONT)
        pool.terminate()
        pool.join()
        return f"{cycles[0]} stop/continue cycles"
    return [(r, n, res.get) for r, n, res in pending], end


def pause_pool(todo, rounds, period_s):
    """``chip_smoke.Packer`` on every round's tasks (each named
    ``<name>@<round>``: the same values), paused for ``period_s`` every
    ``period_s`` by a thread.  Returns the same as :func:`stop_pool`."""
    import chip_smoke as cs
    named = {f"{t[0]}@{r}": (r, t[0]) for r in range(rounds) for t in todo}
    packer = cs.Packer({"f4": [(f"{t[0]}@{r}",) + tuple(t[1:])
                               for r in range(rounds) for t in todo]})
    done = threading.Event()

    def cycle():
        while period_s > 0 and not done.is_set():
            with packer.paused():
                time.sleep(period_s)
            time.sleep(period_s)
    th = threading.Thread(target=cycle, daemon=True)
    th.start()
    got = {}

    def result(key):
        def get():
            if not got:
                got.update(packer.wait("f4")[0])
            return key, got[key]
        return get

    def end():
        done.set()
        th.join()
        pauses = packer.pauses
        packer.close()
        return f"{pauses} pauses, no signal"
    return [(r, name, result(key)) for key, (r, name) in named.items()], end


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pause", action="store_true",
                    help="pause chip_smoke's pool as its quiet does (no "
                    "signals) instead of stopping and continuing it")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--period-s", type=float, default=0.05)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    todo = tasks(args.small)
    how = "paused as the script's quiet does" if args.pause else \
        "stopped and continued"
    print(f"f4_repack: {cs.host_cpu()}; {len(todo)} tasks "
          f"{[(t[0], t[2]) for t in todo]}, {args.rounds} rounds in a pool "
          f"of {cs.PACK_WORKERS} at nice 19, {how} every {args.period_s}s",
          flush=True)
    print(f"f4_repack: np.packbits against shift-and-add: "
          f"{packbits_offsets()} of 64 byte offsets differ", flush=True)
    t0 = time.perf_counter()
    pending, end = (pause_pool if args.pause else stop_pool)(
        todo, args.rounds, args.period_s)
    try:
        ref, bad = {}, 0
        for t in todo:
            for i in range(args.repeat):
                t1 = time.perf_counter()
                got = cs.pack_task(t)[1]
                diff = differs(got, ref.setdefault(t[0], got))
                bad += bool(diff)
                print(f"f4_repack: {t[0]} {t[2]} packed in-process in "
                      f"{time.perf_counter() - t1:.1f}s"
                      + (f", again: {report(got, ref[t[0]], diff)}" if i
                         else ""), flush=True)
        for r, name, get in pending:
            got = get()[1]
            diff = differs(got, ref[name])
            bad += bool(diff)
            print(f"f4_repack: round {r} {name}: "
                  f"{report(got, ref[name], diff)} ({len(got)} leaves)",
                  flush=True)
    finally:
        cycles = end()
    print(f"f4_repack: {bad} of {len(pending) + len(todo) * (args.repeat - 1)}"
          f" packs differ from the first in-process pack; {cycles}; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
