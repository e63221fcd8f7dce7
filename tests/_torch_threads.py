"""Ranks as threads of the test process: a stand-in ``Mesh`` whose
collectives exchange tensors between the threads of one mesh, so that
placement and the collectives' users run on every coordinate without a
process group (``test_torch_sharding.py``, ``test_torch_optim.py``)."""
import threading

import torch

from repro_torch.launch.mesh import Mesh


class Hub:
    """Every thread-rank's tensor of one collective, in rank order."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n, timeout=120)
        self.slots = [None] * n

    def exchange(self, rank, x):
        self.barrier.wait()
        self.slots[rank] = x
        self.barrier.wait()
        return list(self.slots)


class ThreadMesh(Mesh):
    """A stand-in Mesh for one thread of this process: its gather
    concatenates the tensors of the threads on its axis group, in
    coordinate order, as ``Mesh.gather`` does over a process group; its
    all-reduce adds (or takes the maximum of) them in that order."""

    def __init__(self, data, model, rank, hub):
        super().__init__(data, model, rank=rank, device="cpu",
                         groups={"world": None})
        self.hub = hub

    def _group(self, axis):
        d, m = self.coords
        if axis == "world":
            return list(range(self.size))
        return ([self.global_rank(d, j) for j in range(self.model)]
                if axis == "model" else
                [self.global_rank(j, m) for j in range(self.data)])

    def gather(self, x, axis, dim):
        if self.shape[axis] == 1:
            return x
        got = self.hub.exchange(self.rank, x)
        return torch.cat([got[r] for r in self._group(axis)], dim=dim)

    def all_reduce(self, x, axis, op="sum"):
        if (self.size if axis == "world" else self.shape[axis]) == 1:
            return x
        got = self.hub.exchange(self.rank, x)
        parts = [got[r] for r in self._group(axis)]
        out = parts[0].clone()
        for p in parts[1:]:
            out = torch.maximum(out, p) if op == "max" else out + p
        return out


def on_threads(shape, fn):
    """``fn(mesh)`` on one thread per rank of a ``shape`` mesh of
    :class:`ThreadMesh` es; every rank's result, in rank order."""
    n = shape[0] * shape[1]
    hub, out = Hub(n), [None] * n

    def rank_main(rank):
        try:
            out[rank] = fn(ThreadMesh(*shape, rank, hub))
        except BaseException as e:                  # noqa: BLE001
            hub.barrier.abort()
            out[rank] = e
    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for res in out:
        if isinstance(res, BaseException):
            raise res
    return out
