"""Checkpoints: atomic, asynchronous, restored onto any device.

Checked against ``repro/train/checkpoint.py`` (``save``, ``save_async``,
``wait_for_async``, ``restore``, ``latest_step``, ``CheckpointManager``),
with its on-disk format, so a checkpoint written by either package
restores in the other: ``<dir>/step_XXXXXXXX/`` written as ``.tmp`` and
renamed (a crash mid-save never leaves a partial step), holding
``arrays.npz`` (one array per leaf, named by its path with ``/`` written
as ``%``) and ``manifest.json`` (step, keys, shapes, dtypes, extra).
Leaves are named by the reference's rule (``tree.flatten``), so a tree in
the reference's layout (``convert.to_reference``: per-layer leaves
stacked) names its leaves as the reference's does.  ``save_async``
copies every leaf to host memory before it returns, then writes in a
background thread.  The reference's ``shardings`` (an elastic re-mesh)
has no counterpart on one card: ``restore`` takes a target ``device``
instead (None: numpy arrays on the host).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..tree import flatten, unflatten_like

__all__ = ["save", "save_async", "wait_for_async", "restore", "latest_step",
           "CheckpointManager"]


def _retry(fn: Callable, attempts: int = 3, backoff: float = 0.25):
    last = None
    for i in range(attempts):
        try:
            return fn()
        except OSError as e:  # pragma: no cover - FS hiccups
            last = e
            time.sleep(backoff * (2 ** i))
    raise last  # type: ignore[misc]


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array the caller cannot change afterwards."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        return t.cpu().numpy() if t.device.type != "cpu" \
            else t.numpy().copy()
    return np.array(leaf)


def save(ckpt_dir, step: int, tree, extra: Optional[Dict] = None
         ) -> pathlib.Path:
    """Atomic synchronous save of a tree of tensors or arrays."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays = {k: _host(v) for k, v in flatten(tree).items()}

    def write():
        np.savez(tmp / "arrays.npz", **{k.replace("/", "%"): v
                                        for k, v in arrays.items()})
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))

    _retry(write)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class _AsyncWriter:
    def __init__(self):
        self._t: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def submit(self, fn):
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # smelint: disable=EXC001 — writer thread: stored and re-raised on wait()
                self._err = e

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def wait(self):
        if self._t is not None:
            self._t.join()
            self._t = None
        if self._err:
            err, self._err = self._err, None
            raise err


_WRITER = _AsyncWriter()


def save_async(ckpt_dir, step: int, tree, extra: Optional[Dict] = None):
    """Non-blocking save: copies to host memory now, writes in the
    background (one write in flight; the next waits for it)."""
    flat = {k: _host(v) for k, v in flatten(tree).items()}

    def write():
        # a flat one-level tree of the same leaf names
        save(ckpt_dir, step, flat, extra)

    _WRITER.submit(write)


def wait_for_async():
    _WRITER.wait()


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_????????")
             if p.is_dir()]
    return max(steps) if steps else None


def restore(ckpt_dir, step: Optional[int], like, device=None) -> Any:
    """The checkpoint at ``step`` (None: the latest) in the structure of
    ``like``: every leaf named as ``like``'s, of its shape (a mismatch
    raises ``ValueError``, a missing name ``KeyError``), as numpy arrays,
    or as tensors on ``device``."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}"
    data = _retry(lambda: np.load(path / "arrays.npz"))
    out = []
    for k, leaf in flatten(like).items():
        name = k.replace("/", "%")
        if name not in data.files:
            raise KeyError(f"checkpoint {path} has no leaf {k!r} (it holds "
                           f"{sorted(data.files)[:3]}...)")
        arr = data[name]
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"ckpt leaf {k}: shape {arr.shape} != {expect}")
        out.append(arr if device is None
                   else torch.as_tensor(arr, device=device))
    return unflatten_like(like, out)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints, saves every ``every`` steps."""

    def __init__(self, ckpt_dir, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.dir = pathlib.Path(ckpt_dir)
        self.every = every
        self.keep = keep
        self.async_save = async_save

    def maybe_save(self, step: int, tree, extra=None):
        if step % self.every:
            return False
        if self.async_save:
            save_async(self.dir, step, tree, extra)
        else:
            save(self.dir, step, tree, extra)
        self._gc()
        return True

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_????????"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    def restore_latest(self, like, device=None):
        wait_for_async()
        return restore(self.dir, None, like, device)
