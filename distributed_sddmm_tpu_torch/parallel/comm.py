"""The communication layer: the counterpart of ``shard_map`` and of the
``lax`` collectives the JAX strategies call (``ppermute``, ``all_gather``,
``psum_scatter``, ``pmax``/``psum``).

A *world* is the set of ranks a run has, as a device list is in the JAX
package; binding it to a grid (``world.comm(grid, device)``) gives a
*comm*, whose methods take and return a list of per-rank tensors, one for
each rank this process holds, in row-major grid order (``comm.coords``,
``comm.ranks``):

* ``ppermute(xs, axis, perm)`` -- each rank sends to the axis position
  ``perm`` maps it to (pairs ``(src, dst)``); a rank that nobody sends to
  gets zeros;
* ``all_gather(xs, axis)`` -- concatenated on dim 0 in axis order;
* ``reduce_scatter(xs, axis)`` -- summed, then split on dim 0: the rank at
  axis position ``a`` gets part ``a``;
* ``all_reduce(xs, axis, op)`` with ``op`` ``"sum"`` or ``"max"``.

``axis`` is ``"rows"``, ``"cols"``, ``"layers"`` or a tuple of them
(ordered row-major in the order given). Two worlds:

* :class:`LocalWorld` -- ``p`` logical ranks in this process, on one
  device. Every collective is a list operation: a hop is a rotation of
  the list and moves no bytes; a gather is ``torch.cat``; a reduction adds
  (or takes the max of) the blocks in axis order. These are torch ops, so
  autograd differentiates through them.
* :class:`DistWorld` -- one rank per process over ``torch.distributed``:
  NCCL for CUDA tensors, gloo for CPU tensors, never one in place of the
  other. Each process builds one process group per grid row, column,
  layer and axis pair, all in the same order, when it binds a grid.
  ``torch.distributed``'s sends, receives and collectives are not
  differentiable, so given a tensor that requires grad under grad mode
  each collective runs inside a ``torch.autograd.Function`` whose backward
  is its adjoint over the same group, as ``jax.grad`` differentiates
  ``ppermute``, ``all_gather``, ``psum_scatter`` and ``psum``: a hop's is
  the hop with the pairs reversed (a rank that sends to nobody gets a zero
  grad), an all-gather's a reduce-scatter and the reverse, a sum's a sum.
  Every process builds the same graph, so autograd issues the backward
  collectives in the same order on each. ``all_reduce("max")`` (the
  attention stats merge, which no path differentiates) refuses a grad.

:func:`world_from_env` picks the world as the benchmark does: over an
initialised default group (the pod runner's, ``dist/run.py``) or under
``torchrun`` (``WORLD_SIZE`` set) a ``DistWorld``, otherwise a
``LocalWorld`` of ``SDDMM_TORCH_LOCAL_RANKS`` ranks (default 1).

Besides ``counts`` (collective calls by kind) each comm keeps
``axis_counts``: by axis label (``rows``, ``cols``, ``layers`` or names
joined by ``+``) and kind, the calls and how many of them ran over a group
whose ranks sit on more than one host (``cross_host``; hosts as
``parallel/mesh.py::rank_hosts`` numbers them). Counting changes no result.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
import torch.distributed as dist

from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.parallel.mesh import AXES, GridSpec, rank_hosts

#: Environment variable: the number of ranks of a ``LocalWorld``.
LOCAL_RANKS_ENV = "SDDMM_TORCH_LOCAL_RANKS"

_REDUCE = {"sum": torch.add, "max": torch.maximum}
_AXIS_SETS = ((0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2))


def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _axis_ids(axis) -> tuple:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    unknown = [n for n in names if n not in AXES]
    if unknown or not names:
        raise ValueError(f"unknown grid axis {axis!r}; expected names from {AXES}")
    return tuple(AXES.index(n) for n in names)


def _axis_label(axis) -> str:
    """The ``axis_counts`` key of ``axis``: its names in grid order."""
    return "+".join(AXES[i] for i in sorted(_axis_ids(axis)))


def _outside(coord: tuple, ids: tuple) -> tuple:
    """The coordinates that name a rank's group over the axes ``ids``."""
    return tuple(c for a, c in enumerate(coord) if a not in ids)


def _axis_pos(coord: tuple, ids: tuple, dims: tuple) -> int:
    """A rank's position within its group: row-major over ``ids``."""
    pos = 0
    for a in ids:
        pos = pos * dims[a] + coord[a]
    return pos


class _Comm:
    """What both comms share: the grid, the ranks held and the per-call
    collective counts (one a call, whatever the number of ranks held)."""

    #: True when every rank is in this process (hops move no bytes).
    in_process = False

    def __init__(self, grid: GridSpec, coords: list, device: torch.device):
        self.grid, self.device = grid, device
        self.coords = list(coords)
        self.ranks = [grid.flat_rank(*c) for c in self.coords]
        self.counts = dict.fromkeys(
            ("ppermute", "all_gather", "reduce_scatter", "all_reduce"), 0)
        self.axis_counts: dict = {}

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0
        self.axis_counts.clear()

    def _spans_hosts(self, axis) -> bool:
        """Whether this process's group over ``axis`` holds ranks of more
        than one host (never, for ranks that all live in this process)."""
        return False

    def _count(self, kind: str, axis) -> None:
        """One collective call of ``kind`` over ``axis``."""
        self.counts[kind] += 1
        row = self.axis_counts.setdefault(_axis_label(axis), {}).setdefault(
            kind, {"count": 0, "cross_host": 0})
        row["count"] += 1
        row["cross_host"] += self._spans_hosts(axis)

    def ppermute(self, xs: list, axis, perm) -> list:
        return self.ppermute_start(xs, axis, perm)()


class LocalComm(_Comm):
    """A :class:`LocalWorld` bound to a grid: every rank, as list entries."""

    in_process = True

    def __init__(self, grid: GridSpec, device: torch.device):
        super().__init__(grid, grid.coords(), device)

    def _groups(self, axis) -> list:
        """The groups over ``axis``: lists of held indices in axis order."""
        ids = _axis_ids(axis)
        groups: dict = {}
        for h, coord in enumerate(self.coords):
            groups.setdefault(_outside(coord, ids), []).append(h)
        dims = self.grid.dims
        for members in groups.values():
            members.sort(key=lambda h: _axis_pos(self.coords[h], ids, dims))
        return list(groups.values())

    def ppermute_start(self, xs: list, axis, perm) -> Callable:
        """A rotation of the list: no tensor is copied."""
        self._count("ppermute", axis)
        groups = self._groups(axis)
        ys = [None] * len(xs)
        for members in groups:
            for src, dst in perm:
                ys[members[dst]] = xs[members[src]]
        ys = [torch.zeros_like(x) if y is None else y for x, y in zip(xs, ys)]
        return lambda: ys

    def all_gather(self, xs: list, axis) -> list:
        self._count("all_gather", axis)
        groups = self._groups(axis)
        ys = [None] * len(xs)
        for members in groups:
            g = torch.cat([xs[h] for h in members])
            for h in members:
                ys[h] = g
        return ys

    def reduce_scatter(self, xs: list, axis) -> list:
        self._count("reduce_scatter", axis)
        groups = self._groups(axis)
        ys = [None] * len(xs)
        for members in groups:
            total = xs[members[0]]
            for h in members[1:]:
                total = total + xs[h]
            parts = _split(total, len(members))
            for a, h in enumerate(members):
                ys[h] = parts[a]
        return ys

    def all_reduce(self, xs: list, axis, op: str = "sum") -> list:
        self._count("all_reduce", axis)
        fold = _REDUCE[op]
        groups = self._groups(axis)
        ys = [None] * len(xs)
        for members in groups:
            total = xs[members[0]]
            for h in members[1:]:
                total = fold(total, xs[h])
            for h in members:
                ys[h] = total
        return ys


def _split(x: torch.Tensor, n: int) -> tuple:
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split into {n} parts")
    return x.split(x.shape[0] // n)


def backend_for(device: torch.device) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors. NCCL without CUDA
    raises: nothing falls back to gloo."""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs CUDA, and torch.cuda.is_available() is False")
        return "nccl"
    return "gloo"


class DistComm(_Comm):
    """A :class:`DistWorld` bound to a grid: this process's one rank."""

    def __init__(self, grid: GridSpec, device: torch.device):
        if not dist.is_initialized():
            raise RuntimeError("DistWorld needs torch.distributed.init_process_group first")
        if dist.get_world_size() != grid.p:
            raise ValueError(f"grid {grid.nr}x{grid.nc}x{grid.nh} needs {grid.p} "
                             f"processes, the world has {dist.get_world_size()}")
        backend = backend_for(device)
        super().__init__(grid, [grid.grid_coords(dist.get_rank())], device)
        coord, dims = self.coords[0], grid.dims
        # ids -> (group, member ranks in axis order); every process makes
        # every group, in the same order, or the collectives hang.
        self._groups: dict = {}
        self._hosts = rank_hosts(grid.p)
        for ids in _AXIS_SETS:
            by_key: dict = {}
            for c in grid.coords():
                by_key.setdefault(_outside(c, ids), []).append(c)
            for key in sorted(by_key):
                members = sorted(by_key[key], key=lambda c: _axis_pos(c, ids, dims))
                ranks = [grid.flat_rank(*c) for c in members]
                pg = dist.new_group(sorted(ranks), backend=backend)
                if key == _outside(coord, ids):
                    self._groups[ids] = (pg, ranks)

    def _spans_hosts(self, axis) -> bool:
        _, ranks = self._groups[tuple(sorted(_axis_ids(axis)))]
        return len({self._hosts[r] for r in ranks}) > 1

    def _group(self, axis) -> tuple:
        """``(group, member ranks in axis order, order)``: ``order[g]`` is
        the axis position of group rank ``g`` (group ranks ascend with the
        global rank)."""
        ids = tuple(sorted(_axis_ids(axis)))
        pg, ranks = self._groups[ids]
        if ids != _axis_ids(axis):  # the axes given in another order
            dims = self.grid.dims
            coords = sorted((self.grid.grid_coords(r) for r in ranks),
                            key=lambda c: _axis_pos(c, _axis_ids(axis), dims))
            ranks = [self.grid.flat_rank(*c) for c in coords]
        order = [ranks.index(r) for r in sorted(ranks)]
        return pg, ranks, order

    def ppermute_start(self, xs: list, axis, perm) -> Callable:
        """``batch_isend_irecv`` within the axis group, into a new buffer;
        the wait returns ``[received]``. Under grad the hop completes
        inside its autograd node before this returns, so an overlapped
        ring that asks for grads waits on each hop before the next."""
        self._count("ppermute", axis)
        (x,) = xs
        if _wants_grad(x):
            y = _Hop.apply(x, self, axis, tuple(perm))
            return lambda: [y]
        return self._hop(x, axis, perm)

    def _hop(self, x, axis, perm) -> Callable:
        pg, ranks, _ = self._group(axis)
        me = ranks.index(self.ranks[0])
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if dst == [me] and src == [me]:
            return lambda: [x]
        recv = torch.empty_like(x)
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[dst[0]], pg))
        if src:
            ops.append(dist.P2POp(dist.irecv, recv, ranks[src[0]], pg))
        reqs = dist.batch_isend_irecv(ops) if ops else []

        def wait():
            for r in reqs:
                r.wait()
            return [recv if src else torch.zeros_like(x)]
        return wait

    def all_gather(self, xs: list, axis) -> list:
        self._count("all_gather", axis)
        (x,) = xs
        return [_Gather.apply(x, self, axis) if _wants_grad(x) else self._gather(x, axis)]

    def _gather(self, x, axis):
        pg, ranks, order = self._group(axis)
        n = len(ranks)
        y = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        _all_gather_single()(y, x.contiguous(), group=pg)
        if order != sorted(order):  # group-rank order -> axis order
            parts = y.split(x.shape[0])
            y = torch.cat([parts[order.index(a)] for a in range(n)])
        return y

    def reduce_scatter(self, xs: list, axis) -> list:
        self._count("reduce_scatter", axis)
        (x,) = xs
        return [_Scatter.apply(x, self, axis) if _wants_grad(x) else self._scatter(x, axis)]

    def _scatter(self, x, axis):
        pg, ranks, order = self._group(axis)
        parts = _split(x, len(ranks))
        x = torch.cat([parts[a] for a in order])  # axis order -> group-rank order
        y = torch.empty_like(parts[0])
        _reduce_scatter_single()(y, x, op=dist.ReduceOp.SUM, group=pg)
        return y

    def all_reduce(self, xs: list, axis, op: str = "sum") -> list:
        self._count("all_reduce", axis)
        (x,) = xs
        if _wants_grad(x):
            if op != "sum":
                raise NotImplementedError(
                    f"all_reduce({op!r}) through a DistWorld has no gradient: only the "
                    "attention stats merge reaches it, and no path differentiates that")
            return [_Sum.apply(x, self, axis)]
        return [self._reduce(x, axis, op)]

    def _reduce(self, x, axis, op: str = "sum"):
        pg, _, _ = self._group(axis)
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=pg)
        return y


class _Hop(torch.autograd.Function):
    """A hop between processes; its adjoint is the hop with the pairs
    reversed (each rank sends its grad back to the rank it received from;
    a rank that sent to nobody receives zeros)."""

    @staticmethod
    def forward(ctx, x, comm, axis, perm):
        ctx.comm, ctx.axis, ctx.perm = comm, axis, perm
        y = comm._hop(x, axis, perm)()[0]
        return y.clone() if y is x else y  # a rank that keeps its own block

    @staticmethod
    def backward(ctx, g):
        ctx.comm._count("ppermute", ctx.axis)
        back = tuple((d, s) for s, d in ctx.perm)
        return ctx.comm._hop(g.contiguous(), ctx.axis, back)()[0], None, None, None


class _Gather(torch.autograd.Function):
    """An all-gather in axis order; its adjoint sums the grads of every
    rank's copy and hands each rank its own block: a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return comm._gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        ctx.comm._count("reduce_scatter", ctx.axis)
        return ctx.comm._scatter(g.contiguous(), ctx.axis), None, None


class _Scatter(torch.autograd.Function):
    """A reduce-scatter in axis order; its adjoint gives every rank's
    block of the input the grad of the rank that received it: an
    all-gather."""

    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return comm._scatter(x, axis)

    @staticmethod
    def backward(ctx, g):
        ctx.comm._count("all_gather", ctx.axis)
        return ctx.comm._gather(g.contiguous(), ctx.axis), None, None


class _Sum(torch.autograd.Function):
    """An all-reduce sum; its adjoint is the all-reduce sum of the grads."""

    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return comm._reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        ctx.comm._count("all_reduce", ctx.axis)
        return ctx.comm._reduce(g, ctx.axis), None, None


def _all_gather_single():
    """``all_gather_single`` where torch has it (it deprecates
    ``all_gather_into_tensor``)."""
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _reduce_scatter_single():
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class LocalWorld:
    """``p`` logical ranks in this process, on one device: the port's
    counterpart of the JAX tests' forced multi-device CPU mesh, and the way
    ``p > 1`` runs on one card. A hop moves no bytes (a list rotation)."""

    num_processes = 1
    process_index = 0

    def __init__(self, p: int = 1):
        if p < 1:
            raise ValueError(f"a world needs at least one rank, got {p}")
        self.p = p

    def comm(self, grid: GridSpec, device) -> LocalComm:
        if grid.p != self.p:
            raise ValueError(f"grid of {grid.p} ranks on a LocalWorld of {self.p}")
        return LocalComm(grid, resolve_device(device))


class DistWorld:
    """One rank per process over an initialised ``torch.distributed``
    default group (``init_process_group`` is the caller's, or
    :func:`world_from_env`'s)."""

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError("DistWorld needs torch.distributed.init_process_group first")
        self.p = dist.get_world_size()
        self.num_processes = self.p
        self.process_index = dist.get_rank()

    def comm(self, grid: GridSpec, device) -> DistComm:
        return DistComm(grid, resolve_device(device))


def world_from_env(device=None):
    """The world the environment describes: a :class:`DistWorld` over an
    initialised default group (whoever opened it: the pod runner's
    ``dist.init.initialize``, or the caller); under ``torchrun``
    (``WORLD_SIZE`` set) a :class:`DistWorld`, initialising the default
    group from the environment (NCCL on ``cuda``, with this process on
    card ``LOCAL_RANK``; gloo on ``cpu``); otherwise a :class:`LocalWorld`
    of ``SDDMM_TORCH_LOCAL_RANKS`` ranks (default 1)."""
    if dist.is_initialized():
        return DistWorld()
    if "WORLD_SIZE" in os.environ:
        if not dist.is_initialized():
            dev = resolve_device(device)
            backend = backend_for(dev)
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(backend, init_method="env://")
        return DistWorld()
    return LocalWorld(int(os.environ.get(LOCAL_RANKS_ENV, "1")))
