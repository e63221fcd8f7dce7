"""The serving mesh: a ``(data, model)`` grid of ``torch.distributed`` ranks.

Checked against ``repro/launch/mesh.py``.  ``parse_mesh`` is the
reference's, with its error messages; ``make_serve_mesh`` validates a spec
against the world size of the default process group the way the reference
validates against ``jax.device_count()``.

In place of jax's ``Mesh`` the port has :class:`Mesh`: the shape, this
rank's coordinates (rank ``d * model + m``, row-major as ``jax.make_mesh``
orders devices), its device and one process group per axis.  Its two
collectives are every collective the port runs while serving:
:meth:`Mesh.gather` (an all-gather, then a concatenation) and
:meth:`Mesh.broadcast` (a select of one rank's tensor).  Neither sums, so
no float reduction ever crosses a rank (DESIGN.md §7).  Training under
the throughput posture also sums: :meth:`Mesh.all_reduce` (a sum, or a
max) and :meth:`Mesh.reduce_scatter` (this rank's part of a sum); the
exact posture never calls them.  :meth:`Mesh.barrier` waits for every
rank (a checkpoint written by rank 0 alone).  ``gloo`` takes
CUDA tensors too (on the card host's torch 2.11; it copies them through
host memory itself, so ranks sharing one card over ``gloo`` check
correctness, not speed).

The 1x1 mesh needs no process group and its collectives are the
identity, so ``ServeEngine(mesh=None)`` serves the 1x1 mesh through the
same code.  A one-rank world (``make_local_mesh`` after
``init_process_group`` with world size 1) keeps its group: its broadcast
then runs through the backend, NCCL on the card.

``make_production_mesh`` (the reference's 16x16 and 2x16x16 pod meshes)
serves only ``launch/dryrun.py``, which is not ported yet; it waits for
that slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "make_local_mesh", "parse_mesh", "make_serve_mesh"]


class Mesh:
    """A ``(data, model)`` mesh as seen from one rank."""

    axis_names = ("data", "model")

    def __init__(self, data: int = 1, model: int = 1, *, rank: int = 0,
                 device=None, groups: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None):
        if data * model > 1 and not groups:
            raise ValueError(f"a {data}x{model} mesh needs its process "
                             f"groups (make_local_mesh)")
        self.data, self.model = int(data), int(model)
        self.rank = int(rank)
        self.coords: Tuple[int, int] = divmod(self.rank, self.model)
        self.device = resolve_device(device)
        #: axis name ("data", "model", "world") -> this rank's group
        self.groups = dict(groups or {})
        self.backend = backend

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def global_rank(self, d: int, m: int) -> int:
        return d * self.model + m

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank="
                f"{self.rank}, device={self.device}, backend={self.backend})")

    def gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` concatenated on ``dim``, in
        coordinate order (the identity on an axis of one rank)."""
        n = self.shape[axis]
        if n == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.groups[axis])
        return torch.cat(parts, dim=dim)

    def all_reduce(self, x: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of every rank's ``x`` along
        ``axis`` (``"world"``: every rank), a new tensor; ``x`` itself on
        an axis of one rank."""
        if (self.size if axis == "world" else self.shape[axis]) == 1:
            return x
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.groups[axis])
        return x

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        """This rank's part along ``dim`` of the sum of every rank's ``x``
        along ``axis`` (the parts in coordinate order, as :meth:`gather`
        joins them): an all-reduce, then a slice, so that any backend
        that all-reduces a tensor on its device serves it."""
        n = self.shape[axis]
        if n == 1:
            return x
        step = x.shape[dim] // n
        return self.all_reduce(x, axis).narrow(
            dim, self.index(axis) * step, step).contiguous()

    def barrier(self) -> None:
        """Return once every rank of the mesh has come here (an
        all-reduce of one element over every rank); nothing on a mesh of
        one rank."""
        if self.size > 1:
            self.all_reduce(torch.zeros(1, device=self.device), "world")

    def broadcast(self, x: torch.Tensor, axis: str = "world",
                  src: int = 0) -> torch.Tensor:
        """The ``x`` of the rank at coordinate ``src`` on ``axis`` (global
        rank ``src`` for ``"world"``), on every rank of this rank's group
        along ``axis``; the identity without a group."""
        group = self.groups.get(axis)
        if group is None or (axis != "world" and self.shape[axis] == 1):
            return x
        if axis != "world":
            coords = list(self.coords)
            coords[self.axis_names.index(axis)] = src
            src = self.global_rank(*coords)
        x = x.contiguous()
        dist.broadcast(x, src=src, group=group)
        return x


def make_local_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """The port's :class:`Mesh` over the initialised default process group
    (every rank of the world, which must be ``data * model``), with one
    group per axis; without a process group only the 1x1 mesh, which
    needs none."""
    if not dist.is_available() or not dist.is_initialized():
        if data * model != 1:
            raise ValueError(
                f"a {data}x{model} mesh needs {data * model} ranks: "
                f"initialise torch.distributed first (launch/serve.py "
                f"--mesh {data},{model} spawns them)")
        return Mesh(1, 1, device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != data * model:
        raise ValueError(f"mesh {data},{model} needs a world of "
                         f"{data * model} ranks; this one has {world}")
    groups = {"world": dist.group.WORLD}
    # every rank creates every group, in the same order
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if d == rank // model:
            groups["model"] = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if m == rank % model:
            groups["data"] = g
    return Mesh(data, model, rank=rank, device=device, groups=groups,
                backend=str(dist.get_backend()))


def parse_mesh(spec: str) -> Tuple[int, int]:
    """'data,model' string -> (data, model), e.g. '2,2' -> (2, 2)."""
    parts = spec.split(",")
    if len(parts) != 2:
        raise ValueError(
            f"--mesh expects 'data,model' (e.g. 2,2), got {spec!r}")
    data, model = (int(p) for p in parts)
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return data, model


def make_serve_mesh(spec: str, *, device=None) -> Mesh:
    """('data,model' string) -> Mesh, validated against the ranks of the
    default process group (one without a group)."""
    data, model = parse_mesh(spec)
    need = data * model
    have = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    if need > have:
        raise ValueError(
            f"mesh {spec} needs {need} ranks but only {have} are "
            f"running; launch/serve.py --mesh {spec} spawns them (or start "
            f"{need} ranks with RANK and WORLD_SIZE set)")
    return make_local_mesh(data, model, device=device)
