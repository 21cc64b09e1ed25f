"""The rank grid over ``torch.distributed``: (pod x data) data-parallel
ranks, each cell a model group of M ranks.

Counterpart of ``repro/launch/mesh.py`` (``mesh_topology`` :30,
``dp_topology`` :45 and ``dp_decomposition`` :58).  Ranks form a (pod x
data x model) grid in row-major order, rank = (pod * data + d) * model +
m, as the reference flattens its (pod, data, model) mesh: the model axis
is innermost, so a model group is M neighbouring ranks and never spans two
(pod, data) cells, let alone a pod.  The ``fast`` axis of a rank is the
group of its pod's ranks that share its m (the reference's ``data`` axis:
reduce-scatter and all-gather), the ``slow`` axis the group of the ranks
that share its data index and m (``pod``: the one exchange across pods),
``dp`` all ranks that share its m (the flat baseline), and ``tp`` its
model group (the tensor-parallel collectives of every layer).  One pod
means no slow axis, as the reference's mesh then has no ``pod`` axis.
``Grid.rank`` and ``Grid.world`` count the data-parallel ranks (pod *
data + d of pods * data); ``tp.index`` is m; ``Grid.group`` holds all
the grid's ranks (its barrier).  After a pod fails, the survivors' grid
is a subset of the ranks (``make_grid(..., members=)``): the M ranks of
each kept (pod, data) cell, whose axes and whole-grid group are groups of
their own, created by the members alone; its ranks count from 0 in their
row-major (pod, data, model) order.

``Axis`` runs the collectives the sync and the model axis need on its
group, along any dim (moved to the front and made contiguous, as the group
collectives take it, then moved back into a contiguous result), counts
the calls and the payload this rank puts on it (``calls``,
``wire_bytes``), and, where the backend is gloo and the tensors live on a
card (the ranks share one card, which NCCL refuses), copies them to the
host and back in ``stage_through_host``, counting those bytes too.
``Grid.dry`` is one rank's grid for the dry run (``launch.dryrun``): its
axes (``DryAxis``) run no collective and make no process group, count
alike, and keep one record a call (its kind, its result's bytes, its
group's global ranks) for ``launch.census``.

``Axis.copy_to`` and ``Axis.reduce_from`` are the model axis's two
collectives that autograd differentiates, the Megatron pair: ``copy_to``
is the identity forward and a sum over the axis backward, where a
replicated tensor enters work that each rank does on its own shard (a
column-parallel product, a replicated leaf read on the rank's heads);
``reduce_from`` is the sum forward and the identity backward, at every
row-parallel partial sum.  ``Axis.gather_from`` joins the ranks'
column slices of a tensor whose consumer is replicated (RWKV-6's
channel-mix gate): the all-gather forward, and backward this rank's
slice of the gradient, no collective.  ``Axis.gather_to`` joins them for
a consumer that differs per rank (the RG-LRU's conv output before its
column-split gate products, k and v cut inside a head, a run's layers
split over the axis): the all-gather forward, and backward a
reduce-scatter of the ranks' partial gradients.  Every rank builds the
same graph, so autograd issues the backward's collectives in the same
order on each; ``bwd_calls`` counts them apart from ``calls``.

``run_ranks`` spawns the ranks of a grid on this host, each with a
``file://`` rendezvous, and returns what each returned.  Each rank is a
fresh interpreter that imports torch anew, unless ``preload_ranks`` has
started a fork server that imported it (and the modules named) once.

``grid_topology``, ``dp_topology`` and ``grid_communicator`` are the
counterparts of the reference's ``mesh_topology`` (:30), ``dp_topology``
(:45) and ``mesh_communicator`` (:67): the same strata over the grid's
rank order, but the link classes (``Level`` objects) are the caller's — the
port carries no rate modelled for a TPU; the card's own come from
discovery (``core.discovery``), and its generic classes
(``GENERIC_LEVELS``) stand in where nothing was measured.  The default
policy, ``"paper"``, builds its trees from the coordinates alone.
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import multiprocessing.forkserver
import os
import pickle
import queue as queue_mod
import shutil
import signal
import tempfile
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core.topology import Level, Topology
from ..kernels import work

__all__ = ["Axis", "DryAxis", "Grid", "parse_mesh", "choose_backend",
           "grid_groups", "make_grid", "stage_through_host", "run_ranks",
           "preload_ranks", "grid_topology", "dp_topology", "grid_communicator"]


# torch 2.13 renames the two single-tensor collectives; older releases
# have only the old names
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def stage_through_host(fn: Callable, out: torch.Tensor,
                       inp: torch.Tensor | None, axis: "Axis") -> None:
    """``fn(out, inp)`` on host copies of CUDA tensors, the result copied
    back into ``out``; ``inp`` None means ``fn`` works in place on
    ``out``.  For gloo, whose collectives take host tensors."""
    if inp is None:
        out_h = inp_h = out.cpu()
    else:
        inp_h = inp.cpu()
        out_h = torch.empty(out.shape, dtype=out.dtype)
    fn(out_h, inp_h)
    out.copy_(out_h)
    axis.staged_bytes += inp_h.nbytes + out_h.nbytes


class _CopyTo(torch.autograd.Function):
    """Identity forward, the sum over the axis backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.axis.bwd_calls += 1
        return ctx.axis.psum(g), None


class _ReduceFrom(torch.autograd.Function):
    """The sum over the axis forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.psum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """The all-gather along ``dim`` forward; backward this rank's slice of
    the gradient."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.axis.index * ctx.n
        return g.narrow(ctx.dim, i, ctx.n).contiguous(), None, None


class _GatherTo(torch.autograd.Function):
    """The all-gather along ``dim`` forward; backward the sum over the
    axis of the gradient, this rank keeping its slice (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        ctx.axis.bwd_calls += 1
        return ctx.axis.psum_scatter(g, ctx.dim), None, None


class Axis:
    """One axis of the rank grid: its process group (None for a size-1
    axis or for the default group), this rank's index on it, its size."""

    def __init__(self, name: str, size: int, index: int, group=None,
                 stage: bool = False):
        self.name, self.size, self.index = name, size, index
        self.group, self.stage = group, stage
        self.calls = 0            # collectives this rank joined
        self.bwd_calls = 0        # of them, copy_to's and gather_to's in
                                  # a backward
        self.wire_bytes = 0       # payload this rank put into collectives
        self.staged_bytes = 0     # host copies made for gloo

    def _run(self, kind: str, fn: Callable, out: torch.Tensor,
             inp: torch.Tensor | None) -> torch.Tensor:
        """``fn(out, inp)``, collective ``kind`` ("all-reduce",
        "all-gather", "reduce-scatter"), counted."""
        self.calls += 1
        self.wire_bytes += (out if inp is None else inp).nbytes
        with work.quiet():     # the census counts it, a work counter not
            if self.stage and out.is_cuda:
                stage_through_host(fn, out, inp, self)
            else:
                fn(out, out if inp is None else inp)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis, on every member."""
        if self.size == 1:
            return x
        return self._run("all-reduce", lambda o, _: dist.all_reduce(
            o, group=self.group), x.contiguous().clone(), None)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the axis, on every
        member."""
        if self.size == 1:
            return x
        return self._run("all-reduce", lambda o, _: dist.all_reduce(
            o, op=dist.ReduceOp.MAX, group=self.group),
            x.contiguous().clone(), None)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, whose gradient is summed over the axis in the
        backward."""
        if self.size == 1 or not torch.is_grad_enabled():
            return x
        return _CopyTo.apply(x, self)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`psum`, whose backward passes the gradient through."""
        if self.size == 1 or not torch.is_grad_enabled():
            return self.psum(x)
        return _ReduceFrom.apply(x, self)

    def gather_from(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """:meth:`all_gather` of this rank's slice ``x`` along ``dim``, for
        a consumer that every rank computes alike: the gradient of the
        gathered tensor is then the same on every rank, and its backward
        keeps this rank's slice of it, with no collective.  A sum over
        the axis there (a reduce-scatter) would count that gradient M
        times.  Where each rank's consumer reads the gathered tensor for
        work of its own shard, :meth:`gather_to` is the op."""
        if self.size == 1:
            return x
        if not torch.is_grad_enabled():
            return self.all_gather(x, dim)
        return _GatherFrom.apply(x, self, dim)

    def gather_to(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """:meth:`all_gather` of this rank's slice ``x`` along ``dim``, for
        a consumer that differs per rank (work on this rank's own shard:
        the RG-LRU's column-split gate products, the KV heads that its
        query heads read): each rank's gradient of the gathered tensor is
        then partial, and the backward sums it over the axis, this rank
        keeping its slice (:meth:`psum_scatter`), counted in
        ``bwd_calls``.  The counterpart of :meth:`copy_to` for a tensor
        the ranks hold in slices."""
        if self.size == 1:
            return x
        if not torch.is_grad_enabled():
            return self.all_gather(x, dim)
        return _GatherTo.apply(x, self, dim)

    def psum_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Sum over the axis, member i keeping chunk i along ``dim``
        (``lax.psum_scatter(..., tiled=True)``)."""
        if self.size == 1:
            return x
        xf = x.movedim(dim, 0).contiguous()
        if xf.shape[0] % self.size:
            raise ValueError(f"psum_scatter over {self.name}: dim {dim} of "
                             f"{tuple(x.shape)} does not divide by "
                             f"{self.size}")
        out = xf.new_empty((xf.shape[0] // self.size,) + xf.shape[1:])
        self._run("reduce-scatter", lambda o, i: _reduce_scatter(
            o, i, group=self.group), out, xf)
        return out.movedim(0, dim).contiguous()

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The members' ``x`` concatenated along ``dim`` in member order
        (``lax.all_gather(..., tiled=True)``)."""
        if self.size == 1:
            return x
        xf = x.movedim(dim, 0).contiguous()
        out = xf.new_empty((xf.shape[0] * self.size,) + xf.shape[1:])
        self._run("all-gather", lambda o, i: _all_gather(
            o, i, group=self.group), out, xf)
        return out.movedim(0, dim).contiguous()


class DryAxis(Axis):
    """An axis of the dry run's grid: it runs no collective and has no
    group; it counts as :class:`Axis` does and keeps one record a call in
    ``records``: ``{"kind", "bytes"`` (the result's: the reduced tensor,
    the gathered one, or this rank's scattered shard), ``"ranks"`` (the
    global ranks of its group)``}``.  Its result has the collective's
    shape and dtype, on the input's device (``meta``: no values)."""

    def __init__(self, name: str, ranks: list[int], index: int):
        super().__init__(name, len(ranks), index)
        self.ranks = list(ranks)
        self.records: list[dict] = []

    def _run(self, kind, fn, out, inp):
        self.records.append({"kind": kind, "bytes": out.nbytes,
                             "ranks": self.ranks})
        return super()._run(kind, lambda o, i: None, out, inp)


@dataclasses.dataclass
class Grid:
    """This rank's place in the (pods x data x model) grid and its four
    axes; ``rank`` and ``world`` count the data-parallel ranks.  ``group``
    holds every rank of the grid (None: the default group)."""
    pods: int
    data: int
    rank: int
    fast: Axis
    slow: Axis | None
    dp: Axis
    backend: str | None = None
    model: int = 1
    tp: Axis | None = None
    group: Any = None

    @property
    def world(self) -> int:
        return self.pods * self.data

    @property
    def size(self) -> int:
        """Every rank of the grid, the model axis's included."""
        return self.world * self.model

    @property
    def staging(self) -> str:
        return "host" if self.dp.stage else "none"

    @property
    def staged_bytes(self) -> int:
        return sum(a.staged_bytes for a in self.axes())

    def axes(self) -> list[Axis]:
        return [a for a in (self.fast, self.slow, self.dp, self.tp)
                if a is not None]

    def barrier(self) -> None:
        """Wait for every rank of the grid."""
        if self.size > 1:
            dist.barrier(group=self.group)

    @classmethod
    def single(cls) -> "Grid":
        """One rank: every axis has size 1 and no group."""
        return cls.shape_only(1, 1)

    @classmethod
    def shape_only(cls, pods: int, data: int, model: int = 1) -> "Grid":
        """The shape of a (pods x data x model) grid seen from rank 0, with
        no process group: for the planning plane only (``grid_topology``,
        ``grid_communicator`` with ``backend="sim"``)."""
        return cls(pods, data, 0, Axis("data", data, 0),
                   Axis("pod", pods, 0) if pods > 1 else None,
                   Axis("dp", pods * data, 0), model=model,
                   tp=Axis("model", model, 0) if model > 1 else None)


    @classmethod
    def dry(cls, pods: int, data: int, model: int = 1,
            m: int = 0) -> "Grid":
        """Rank m of the (pod 0, data 0) cell of a (pods x data x model)
        grid, for the dry run: every axis a :class:`DryAxis` over its
        group's global ranks (``grid_groups``), size-1 axes included (they
        record nothing: a size-1 collective returns its input)."""
        groups = grid_groups(pods, data, model)
        mine = lambda kind: next(g for g in groups[kind] if m in g)
        axis = lambda name, kind: DryAxis(name, mine(kind),
                                          mine(kind).index(m))
        return cls(pods, data, 0, axis("data", "fast"),
                   axis("pod", "slow") if pods > 1 else None,
                   axis("dp", "dp"), "dry", model,
                   axis("model", "tp") if model > 1 else None)

    def records(self) -> list[dict]:
        """Every record of the grid's dry axes, in call order within each
        axis."""
        return [r for a in self.axes() for r in getattr(a, "records", ())]


def parse_mesh(spec: str) -> tuple[int, int, int]:
    """``"PxDxM"`` -> (pods, data, model)."""
    try:
        pods, data, model = (int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"mesh must be PODSxDATAxMODEL, got {spec!r}")
    if min(pods, data, model) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {spec!r}")
    return pods, data, model


def choose_backend(requested: str | None, dev: torch.device,
                   local_world: int) -> str:
    """NCCL where every rank of this host has a card of its own, gloo
    where ranks share one or run on the CPU."""
    if dev.type == "cpu":
        if requested not in (None, "gloo"):
            raise ValueError(f"--dist-backend {requested} needs the card; "
                             f"the CPU takes gloo")
        return "gloo"
    cards = torch.cuda.device_count()
    if requested is None:
        return "nccl" if cards >= local_world else "gloo"
    if requested == "nccl" and cards < local_world:
        raise ValueError(f"NCCL refuses two ranks on one device: "
                         f"{local_world} ranks on {cards} card(s); pass "
                         f"--dist-backend gloo")
    if requested not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {requested!r}")
    return requested


def grid_groups(pods: int, data: int, model: int = 1) -> dict:
    """The rank lists of every group of a (pods x data x model) grid,
    rank = (pod * data + d) * model + m: ``"fast"`` one per (pod, m),
    ``"slow"`` one per (d, m), ``"dp"`` one per m, ``"tp"`` one per
    (pod, d) cell, each in the order ``make_grid`` creates them."""
    r = lambda p, d, m: (p * data + d) * model + m
    return {
        "fast": [[r(p, i, m) for i in range(data)]
                 for p in range(pods) for m in range(model)],
        "slow": [[r(p, i, m) for p in range(pods)]
                 for i in range(data) for m in range(model)],
        "dp": [[r(p, i, m) for p in range(pods) for i in range(data)]
               for m in range(model)],
        "tp": [[r(p, i, m) for m in range(model)]
               for p in range(pods) for i in range(data)],
    }


def make_grid(pods: int, data: int, device: torch.device, model: int = 1,
              members: "list[int] | None" = None) -> Grid:
    """This rank's ``Grid`` over the initialised default group, whose size
    must be ``pods * data * model``, or over ``members``: the global ranks
    of a grid that holds only some of them (the survivors of a failure:
    the M ranks of each kept (pod, data) cell), in row-major (pod, data,
    model) order, this rank among them.  Every rank creates every group of
    the default group, in the order of :func:`grid_groups`; a grid of
    ``members`` creates its groups with the members alone
    (``use_local_synchronization``), so ranks that have left need not
    join: each member creates the group of all the members, then its own
    fast, slow, dp and tp groups in that order.  torch names such a group
    by its ranks and the number of groups the process has made, so the
    members must have made equally many before: a rank outside
    ``members`` leaves for good.  Collectives of CUDA tensors are staged
    through the host when the backend is gloo."""
    if members is None and pods * data * model == 1 \
            and not dist.is_initialized():
        return Grid.single()
    world, rank = dist.get_world_size(), dist.get_rank()
    if members is None:
        if world != pods * data * model:
            raise ValueError(f"{world} ranks for a {pods}x{data}x{model} "
                             f"grid")
        members = list(range(world))
        local = False
    else:
        members = list(members)
        if len(members) != pods * data * model or rank not in members:
            raise ValueError(f"members {members} for a {pods}x{data}x"
                             f"{model} grid on rank {rank}")
        local = True
    backend = dist.get_backend()
    stage = backend == "gloo" and device.type == "cuda"
    me = members.index(rank)
    cell, m = divmod(me, model)
    pod, d = divmod(cell, data)
    sizes = {"fast": data, "slow": pods, "dp": pods * data, "tp": model}
    whole = _group(members, range(len(members)), local) \
        if local and len(members) > 1 else None
    mine = {}
    for kind, lists in grid_groups(pods, data, model).items():
        if sizes[kind] == 1 or (kind == "dp" and model == 1 and not local):
            continue                   # no group, or the default group
        for ids in lists:
            if me in ids:
                mine[kind] = _group(members, ids, local)
            elif not local:
                _group(members, ids, local)
    axis = lambda name, kind, size, index: Axis(
        name, size, index, group=mine.get(kind), stage=stage)
    return Grid(pods, data, cell, axis("data", "fast", data, d),
                axis("pod", "slow", pods, pod) if pods > 1 else None,
                axis("dp", "dp", pods * data, cell), backend, model,
                axis("model", "tp", model, m) if model > 1 else None,
                whole)


def _group(members: list[int], ids: list[int], local: bool):
    ranks = [members[i] for i in ids]
    return dist.new_group(ranks, use_local_synchronization=True) \
        if local else dist.new_group(ranks)


def grid_topology(grid: Grid, levels: "list[Level]") -> Topology:
    """The Topology of a grid's ranks: strata = [pod, (pod, data) cell]
    over the row-major rank order (a cell is one model group, M ranks),
    with the caller's three ``levels`` (slowest first); used to build the
    paper's explicit trees for the p2p backend."""
    model = grid.model
    idx = np.arange(grid.pods * grid.data * model)
    return Topology(np.stack([idx // (grid.data * model), idx // model],
                             axis=1), levels)


def dp_topology(grid: Grid, levels: "list[Level]") -> Topology:
    """The Topology over the data-parallel ranks: strata = [pod], with the
    caller's two ``levels`` (across pods, inside a pod) — the rank space of
    the torch backend."""
    return Topology((np.arange(grid.pods * grid.data) // grid.data)[:, None],
                    levels)


def grid_communicator(grid: Grid, levels: "list[Level]", *,
                      backend: str = "torch", policy="paper", **kw):
    """The :class:`repro_torch.core.Communicator` for a grid's ranks.

    ``levels``: three link classes, slowest first (across pods, between
    the ranks of a pod, inside a rank's data row); the dp-scoped topology
    of the torch backend keeps the first and the last, as the reference's
    keeps DCN and ICI.

    backend "torch": grid-decomposed collectives over the grid's groups.
    backend "p2p": explicit tree rounds on the default process group.
    backend "sim": postal-model planning/estimation on the grid's topology.
    """
    from ..core import Communicator

    if backend == "torch":
        # rank space = (pod, data): the dp-scoped topology keeps member and
        # root indices equal to the grid's ranks
        kw.setdefault("grid", grid)
        return Communicator(dp_topology(grid, [levels[0], levels[-1]]),
                            backend=backend, policy=policy, **kw)
    return Communicator(grid_topology(grid, levels), backend=backend,
                        policy=policy, **kw)


def _rank_entry(fn, rank, world, backend, init_method, timeout_s,
                args_path, results) -> None:
    torch.set_num_threads(1)
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


_PRELOADED: list[str] = []      # what the ranks' fork server imported


def preload_ranks(*modules: str) -> None:
    """Start the ranks of every later ``run_ranks`` from a fork server
    that imports torch and ``modules`` once, instead of one fresh
    interpreter a rank that imports them all again; and start that server
    now, so that it imports while the caller goes on.  The server touches
    no card (each rank makes its own CUDA context); this process waits for
    it to end as it exits."""
    mods = ["torch", *modules]
    torch.multiprocessing.get_context("forkserver").set_forkserver_preload(
        mods)
    if not _PRELOADED:
        atexit.register(_stop_fork_server)
    _PRELOADED[:] = mods
    multiprocessing.forkserver.ensure_running()


def _stop_fork_server(timeout: float = 30.0) -> None:
    """Close this process's end of the fork server's "alive" pipe, which
    ends the server once no rank it forked is left, and wait for it to
    exit (it tears down torch), killing it after ``timeout`` seconds."""
    fs = multiprocessing.forkserver._forkserver
    pid, fd = fs._forkserver_pid, fs._forkserver_alive_fd
    if pid is None:
        return
    fs._forkserver_pid = fs._forkserver_alive_fd = None
    fs._forkserver_address = None
    os.close(fd)
    deadline = time.monotonic() + timeout
    while os.waitpid(pid, os.WNOHANG) == (0, 0):
        if time.monotonic() > deadline:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
            return
        time.sleep(0.02)


def run_ranks(fn: Callable, world: int, backend: str, args: tuple = (),
              timeout: float = 900.0) -> list[Any]:
    """Spawn ``world`` ranks on this host, rendezvous through a file in a
    fresh temporary directory, run ``fn(rank, *args)`` in each (``fn`` and
    ``args`` are pickled, so ``fn`` must be importable; ``args`` go through
    a file in that directory, not the start pipe, which blocks each start
    until its child has imported; its result should
    hold numpy arrays, not tensors, which would outlive their process in
    shared memory) and return their results in rank order.  Raises if a
    rank raises, dies, or the ranks take longer than ``timeout`` seconds;
    no rank outlives the call."""
    ctx = torch.multiprocessing.get_context(
        "forkserver" if _PRELOADED else "spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_rdzv_")
    results = ctx.Queue()
    with open(f"{tmp}/args.pkl", "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_rank_entry, daemon=True, args=(
        fn, r, world, backend, f"file://{tmp}/rendezvous", timeout,
        f"{tmp}/args.pkl", results)) for r in range(world)]
    out: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world:
            try:
                rank, ok, res = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       f"result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world - len(out)} of {world} "
                                       f"ranks still running after "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
