"""The data-parallel rank grid over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py`` (``dp_topology`` :45 and
``dp_decomposition`` :58).  Ranks form a (pod x data) grid in row-major
order, rank = pod * data + d, as the reference flattens its (pod, data)
mesh axes.  The ``fast`` axis of a rank is the group of its pod's ranks
(the reference's ``data`` axis: reduce-scatter and all-gather), the
``slow`` axis the group of the ranks that share its data index (``pod``:
the one exchange across pods), and ``dp`` all ranks (the flat baseline).
One pod means no slow axis, as the reference's mesh then has no ``pod``
axis.  After a pod fails, the survivors' grid is a subset of the ranks
(``make_grid(..., members=)``): its three axes are groups of their own,
created by the members alone, and its ranks count from 0 in their
row-major order.

``Axis`` runs the three collectives the sync needs on its group, along
any dim (moved to the front and made contiguous, as the group collectives
take it, then moved back into a contiguous result), counts the payload
this rank puts on it (``wire_bytes``), and, where the backend is gloo and
the tensors live on a card (the ranks share one card, which NCCL
refuses), copies them to the host and back in ``stage_through_host``,
counting those bytes too.

``run_ranks`` spawns the ranks of a grid on this host, each with a
``file://`` rendezvous, and returns what each returned.

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

import dataclasses
import datetime
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core.topology import Level, Topology

__all__ = ["NOT_PORTED_TP", "Axis", "Grid", "parse_mesh", "make_grid",
           "stage_through_host", "run_ranks", "grid_topology",
           "dp_topology", "grid_communicator"]

NOT_PORTED_TP = ("ROADMAP.md, Queue 1 item 5: tensor parallelism over a "
                 "model axis")

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


class Axis:
    """One axis of the rank grid: its process group (None for a size-1
    axis or for the default group), this rank's index on it, its size."""

    def __init__(self, name: str, size: int, index: int, group=None,
                 stage: bool = False):
        self.name, self.size, self.index = name, size, index
        self.group, self.stage = group, stage
        self.wire_bytes = 0       # payload this rank put into collectives
        self.staged_bytes = 0     # host copies made for gloo

    def _run(self, fn: Callable, out: torch.Tensor,
             inp: torch.Tensor | None) -> torch.Tensor:
        self.wire_bytes += (out if inp is None else inp).nbytes
        if self.stage and out.is_cuda:
            stage_through_host(fn, out, inp, self)
        else:
            fn(out, out if inp is None else inp)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis, on every member."""
        if self.size == 1:
            return x
        return self._run(lambda o, _: dist.all_reduce(o, group=self.group),
                         x.contiguous().clone(), None)

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
        self._run(lambda o, i: _reduce_scatter(
            o, i, group=self.group), out, xf)
        return out.movedim(0, dim).contiguous()

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The members' ``x`` concatenated along ``dim`` in member order
        (``lax.all_gather(..., tiled=True)``)."""
        if self.size == 1:
            return x
        xf = x.movedim(dim, 0).contiguous()
        out = xf.new_empty((xf.shape[0] * self.size,) + xf.shape[1:])
        self._run(lambda o, i: _all_gather(
            o, i, group=self.group), out, xf)
        return out.movedim(0, dim).contiguous()


@dataclasses.dataclass
class Grid:
    """This rank's place in the (pods x data) grid and its three axes."""
    pods: int
    data: int
    rank: int
    fast: Axis
    slow: Axis | None
    dp: Axis
    backend: str | None = None

    @property
    def world(self) -> int:
        return self.pods * self.data

    @property
    def staging(self) -> str:
        return "host" if self.dp.stage else "none"

    @property
    def staged_bytes(self) -> int:
        return sum(a.staged_bytes for a in self.axes())

    def axes(self) -> list[Axis]:
        return [a for a in (self.fast, self.slow, self.dp) if a is not None]

    def barrier(self) -> None:
        """Wait for every rank of the grid."""
        if self.world > 1:
            dist.barrier(group=self.dp.group)

    @classmethod
    def single(cls) -> "Grid":
        """One rank: every axis has size 1 and no group."""
        return cls.shape_only(1, 1)

    @classmethod
    def shape_only(cls, pods: int, data: int) -> "Grid":
        """The shape of a (pods x data) grid seen from rank 0, with no
        process group: for the planning plane only (``grid_topology``,
        ``grid_communicator`` with ``backend="sim"``)."""
        return cls(pods, data, 0, Axis("data", data, 0),
                   Axis("pod", pods, 0) if pods > 1 else None,
                   Axis("dp", pods * data, 0))


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"PxDxM"`` -> (pods, data).  A model axis is not ported yet."""
    try:
        pods, data, model = (int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"mesh must be PODSxDATAxMODEL, got {spec!r}")
    if min(pods, data, model) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {spec!r}")
    if model != 1:
        raise NotImplementedError(f"mesh {spec}: a model axis of {model} "
                                  f"({NOT_PORTED_TP})")
    return pods, data


def make_grid(pods: int, data: int, device: torch.device,
              members: "list[int] | None" = None) -> Grid:
    """This rank's ``Grid`` over the initialised default group, whose size
    must be ``pods * data``, or over ``members``: the global ranks of a
    grid that holds only some of them (the survivors of a failure), in
    row-major (pod, data) order, this rank among them.  Every rank creates
    every group of the default group, in the same order; a grid of
    ``members`` creates its groups with the members alone
    (``use_local_synchronization``), so ranks that have left need not
    join, and each member creates its own fast, slow and dp groups in that
    order.  torch names such a group by its ranks and the number of groups
    the process has made, so the members must have made equally many
    before: a rank outside ``members`` leaves for good.  Collectives of
    CUDA tensors are staged through the host when the backend is gloo."""
    if members is None and pods * data == 1 and not dist.is_initialized():
        return Grid.single()
    world, rank = dist.get_world_size(), dist.get_rank()
    if members is None:
        if world != pods * data:
            raise ValueError(f"{world} ranks for a {pods}x{data} grid")
        members = list(range(world))
        local = False
    else:
        members = list(members)
        if len(members) != pods * data or rank not in members:
            raise ValueError(f"members {members} for a {pods}x{data} grid "
                             f"on rank {rank}")
        local = True
    backend = dist.get_backend()
    stage = backend == "gloo" and device.type == "cuda"
    me = members.index(rank)
    pod, d = divmod(me, data)

    def group(ids: list[int]):
        ranks = [members[i] for i in ids]
        return dist.new_group(ranks, use_local_synchronization=True) \
            if local else dist.new_group(ranks)

    fast = Axis("data", data, d, stage=stage)
    for p in range(pods):
        if data > 1 and (p == pod or not local):
            g = group([p * data + i for i in range(data)])
            if p == pod:
                fast.group = g
    slow = Axis("pod", pods, pod, stage=stage) if pods > 1 else None
    for i in range(data):
        if pods > 1 and (i == d or not local):
            g = group([p * data + i for p in range(pods)])
            if i == d:
                slow.group = g
    dp = Axis("dp", pods * data, me, stage=stage)
    if local and pods * data > 1:
        dp.group = group(list(range(pods * data)))
    return Grid(pods, data, me, fast, slow, dp, backend)


def grid_topology(grid: Grid, levels: "list[Level]") -> Topology:
    """The Topology of a grid's ranks: strata = [pod, data-row] over the
    row-major rank order (a data row is one rank: the grid has no model
    axis), with the caller's three ``levels`` (slowest first); used to
    build the paper's explicit trees for the p2p backend."""
    idx = np.arange(grid.pods * grid.data)
    return Topology(np.stack([idx // grid.data, idx], axis=1), levels)


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
    ctx = torch.multiprocessing.get_context("spawn")
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
