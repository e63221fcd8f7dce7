"""Fault tolerance: retries, heartbeats, straggler detection, resume.

Checked against ``repro/train/fault.py`` (standard library only; a copy
with ``TransientError`` exported).

At thousands of nodes the failure model is: (a) transient device/RPC errors
-> bounded retry; (b) node loss -> checkpoint/restart
(``checkpoint.restore`` onto the new device); (c) stragglers -> detect
via step-time EMA and surface to the scheduler (here: callback) so the slow
host can be cordoned before it stalls the collective.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Callable, Optional

__all__ = ["TransientError", "retry_transient", "Heartbeat",
           "StragglerDetector", "run_resumable"]


class TransientError(RuntimeError):
    pass


def retry_transient(fn: Callable, attempts: int = 3, backoff: float = 0.5,
                    retry_on=(TransientError, OSError)):
    """Bounded retry with exponential backoff for transient failures."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:
            last = e
            time.sleep(backoff * (2 ** i))
    raise last  # type: ignore[misc]


class Heartbeat:
    """Writes a per-host liveness file each step; an external watchdog (or
    another host) treats a stale heartbeat as node failure."""

    def __init__(self, path, host_id: int = 0):
        self.path = pathlib.Path(path)
        self.host_id = host_id
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int):
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"host": self.host_id, "step": step, "t": time.time()}))
        os.replace(tmp, self.path)

    def age(self) -> Optional[float]:
        try:
            data = json.loads(self.path.read_text())
            return time.time() - data["t"]
        except (OSError, ValueError, KeyError):
            return None


class StragglerDetector:
    """Step-time EMA; flags steps slower than ``threshold`` x the EMA.

    On a real pod the flagged host is reported to the control plane; the
    mitigation hook defaults to logging (tests inject their own).
    """

    def __init__(self, threshold: float = 2.5, decay: float = 0.9,
                 warmup: int = 3, on_straggler: Optional[Callable] = None):
        self.threshold = threshold
        self.decay = decay
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0
        self.flags = 0
        self.on_straggler = on_straggler or (
            lambda step, dt, ema: print(
                f"[straggler] step {step}: {dt:.3f}s vs EMA {ema:.3f}s"))

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.ema is None:
            self.ema = dt
            return False
        flagged = self.n > self.warmup and dt > self.threshold * self.ema
        if flagged:
            self.flags += 1
            self.on_straggler(step, dt, self.ema)
        else:
            # only fold non-outlier steps into the EMA
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        return flagged


def run_resumable(step_fn: Callable, state, start_step: int, n_steps: int,
                  ckpt_manager=None, heartbeat: Optional[Heartbeat] = None,
                  detector: Optional[StragglerDetector] = None,
                  fail_injector: Optional[Callable] = None):
    """Drive ``state = step_fn(step, state)`` with checkpoint/heartbeat/
    straggler hooks; raises through after checkpointing current progress.

    ``fail_injector(step)`` (tests) may raise TransientError to exercise
    the retry path.
    """
    step = start_step
    while step < n_steps:
        t0 = time.time()

        def attempt():
            if fail_injector is not None:
                fail_injector(step)
            return step_fn(step, state)

        state = retry_transient(attempt)
        dt = time.time() - t0
        if heartbeat:
            heartbeat.beat(step)
        if detector:
            detector.observe(step, dt)
        if ckpt_manager:
            ckpt_manager.maybe_save(step, state)
        step += 1
    return state
