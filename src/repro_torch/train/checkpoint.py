"""Checkpoints: atomic, asynchronous, elastic-reshardable.

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
background thread.  ``restore`` takes a target ``device`` (None: numpy
arrays on the host).

As in the reference, a checkpoint holds **logical** (whole) arrays, so
it restores onto any mesh (the reference's ``restore(shardings=)``, an
elastic re-mesh).  On a mesh (``mesh=``, a ``launch.mesh.Mesh``) the
tree may hold this rank's throughput shards, each carrying its
``parallel.sharding.Cut``: ``save``, ``save_async`` and
``CheckpointManager.maybe_save`` gather every leaf whole, in leaf order,
as a collective on every rank (a leaf without a Cut is taken as it is:
replicated), and rank 0 alone writes the files, the same arrays bitwise
as a one-process save of the gathered tree; ``save`` returns on every
rank after the rename, and ``save_async`` hands only rank 0's write to
the background thread.  ``restore(mesh=)`` reads the logical arrays on
every rank and returns this rank's throughput shards, each cut by its
spec on that mesh (``sharding.throughput_shard``: a leaf's spec is its
param's, so AdamW's ``m`` and ``v`` are cut like the params they
follow), whatever mesh, card or package wrote them.
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

from ..parallel.sharding import cut_of, gather_shard, throughput_shard
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


def _logical(tree, mesh) -> Optional[Dict[str, np.ndarray]]:
    """{name: host array} of every leaf of ``tree``; with ``mesh`` each
    throughput shard's leaf gathered whole first (a collective on every
    rank, in leaf order), the arrays kept on rank 0 alone (None
    elsewhere)."""
    flat = flatten(tree)
    if mesh is None:
        if any(cut_of(v) is not None and cut_of(v).mesh.size > 1
               for v in flat.values()):
            raise ValueError("the tree holds throughput shards of a mesh "
                             "of several ranks: save it with mesh=")
        return {k: _host(v) for k, v in flat.items()}
    mine = mesh.rank == 0
    out = {}
    for k, v in flat.items():
        whole = v if cut_of(v) is None else gather_shard(v, mesh)
        if mine:
            out[k] = _host(whole)
        del whole
    return out if mine else None


def _write(ckpt_dir, step: int, arrays: Dict[str, np.ndarray],
           extra: Optional[Dict]) -> pathlib.Path:
    """``arrays`` written as step ``step`` under ``ckpt_dir``: into the
    ``.tmp`` directory, then renamed."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

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


def save(ckpt_dir, step: int, tree, extra: Optional[Dict] = None,
         mesh=None) -> pathlib.Path:
    """Atomic synchronous save of a tree of tensors or arrays; on
    ``mesh`` of this rank's throughput shards, gathered and written by
    rank 0, every rank returning after the rename (see the module
    note)."""
    arrays = _logical(tree, mesh)
    final = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    if arrays is not None:
        final = _write(ckpt_dir, step, arrays, extra)
    if mesh is not None:
        mesh.barrier()
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


def save_async(ckpt_dir, step: int, tree, extra: Optional[Dict] = None,
               mesh=None):
    """Non-blocking save: copies to host memory now (on ``mesh``, every
    rank gathers its shards now), writes in the background (rank 0's
    write alone on a mesh; one write in flight, the next waits for
    it)."""
    arrays = _logical(tree, mesh)
    if arrays is not None:
        _WRITER.submit(lambda: _write(ckpt_dir, step, arrays, extra))


def wait_for_async():
    _WRITER.wait()


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_????????")
             if p.is_dir()]
    return max(steps) if steps else None


def restore(ckpt_dir, step: Optional[int], like, device=None,
            mesh=None) -> Any:
    """The checkpoint at ``step`` (None: the latest) in the structure of
    ``like``: every leaf named as ``like``'s, of its shape (a throughput
    shard's whole shape, read from its Cut; a mismatch raises
    ``ValueError``, a missing name ``KeyError``), as numpy arrays, as
    tensors on ``device``, or, with ``mesh``, as this rank's throughput
    shards on the mesh's device, one leaf read and cut at a time."""
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
        cut = cut_of(leaf)
        expect = cut.shape if cut is not None else \
            tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"ckpt leaf {k}: shape {arr.shape} != {expect}")
        if mesh is not None:
            arr = throughput_shard(mesh, tuple(k.split("/")), arr)
        elif device is not None:
            arr = torch.as_tensor(arr, device=device)
        out.append(arr)
    return unflatten_like(like, out)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints, saves every ``every`` steps."""

    def __init__(self, ckpt_dir, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.dir = pathlib.Path(ckpt_dir)
        self.every = every
        self.keep = keep
        self.async_save = async_save

    def maybe_save(self, step: int, tree, extra=None, mesh=None):
        """On ``mesh``: every rank gathers, rank 0 writes and collects."""
        if step % self.every:
            return False
        if self.async_save:
            save_async(self.dir, step, tree, extra, mesh)
        else:
            save(self.dir, step, tree, extra, mesh)
        if mesh is None or mesh.rank == 0:
            self._gc()
        return True

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_????????"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    def restore_latest(self, like, device=None, mesh=None):
        """On ``mesh``, after rank 0's write in flight has landed."""
        wait_for_async()
        if mesh is not None:
            mesh.barrier()
        return restore(self.dir, None, like, device, mesh)
