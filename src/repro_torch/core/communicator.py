"""The single public entry point for topology-aware collectives.

The paper (Karonis et al. §3.2) replaces MPICH-G2's hidden communicators with
explicit multilevel topology so every process can deterministically build the
same tree.  This module is the communicator-shaped front door over that
machinery: a :class:`Communicator` owns a :class:`~repro_torch.core.topology.Topology`,
selects trees under a policy, **caches plans** so repeated collectives stop
re-running tree construction / cost-model argmin / round scheduling, and
dispatches to pluggable backends:

``"sim"``
    Postal-model simulator (:mod:`repro_torch.core.simulator`).  Operands are
    byte counts; results are :class:`SimResult` per-rank completion times.
    This is the reproduction/benchmark plane.
``"torch"``
    Grid-decomposed collectives over ``torch.distributed``
    (:mod:`repro_torch.core.collectives`): reduce-scatter inside the pod,
    exchange across pods, all-gather inside the pod.  Operands are this
    rank's tensors; the ranks are those of a ``launch.mesh.Grid``.
``"p2p"``
    The faithful §3.2 port (:mod:`repro_torch.core.tree_exec`): one
    ``batch_isend_irecv`` of this rank's point-to-point sends and receives
    per tree round, on a process group whose rank i is member i.

A copy of ``repro/core/communicator.py`` whose two device backends
(``"ppermute"``, ``"jax"``) are translated to ranks as ``"p2p"`` and
``"torch"``.

Quickstart::

    topo = paper_fig8_topology()
    comm = Communicator(topo, policy="paper", backend="sim")
    t = comm.bcast(256e3, root=0).time          # seconds, postal model
    comm.cache_info()                           # plan-cache hits/misses

Ops live in a dispatch table (:data:`OPS`) that replaces the string-keyed
dict formerly buried in ``trees.best_tree``; new collectives register with
:func:`register_op`.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
from typing import Any, Callable, Sequence

from ..obs.metrics import MetricsRegistry
from ..obs.trace import PID_PLANNER, PID_PROGRAMS
from . import rounds as R
from . import schedule as S
from .simulator import simulate, simulate_rounds
from .topology import Topology
from .trees import (LevelPolicy, PAPER_POLICY, Tree, adaptive_policy,
                    binomial_tree, build_multilevel_tree, repair_tree)

__all__ = [
    "OpSpec",
    "OPS",
    "register_op",
    "size_bucket",
    "select_tree",
    "select_plan",
    "PlanChoice",
    "Plan",
    "PlanCache",
    "CacheInfo",
    "CommStats",
    "RepairReport",
    "RefreshReport",
    "SimResult",
    "Communicator",
    "BACKENDS",
]


# ---------------------------------------------------------------------- #
# Op dispatch table.
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One collective: how to schedule it over a tree and its data flow.

    ``schedule(tree, nbytes) -> Schedule`` is the whole-message simulator
    form; ``algorithms`` names the registered lowerings to the rounds IR
    (:mod:`repro_torch.core.rounds`) — ``"tree"`` is the generic segmented tree
    lowering, large-message algorithms (``"sag"``, ``"rsag"``) register
    alongside it and the ``"auto"`` policy searches across them.
    ``rootful`` ops have a distinguished root (bcast/reduce/gather/scatter);
    ``sized`` ops take a byte count (barrier does not).
    """

    name: str
    schedule: Callable[[Tree, float], S.Schedule]
    rootful: bool
    sized: bool = True
    algorithms: tuple[str, ...] = ("tree",)


OPS: dict[str, OpSpec] = {}


def register_op(name: str, schedule: Callable, *, rootful: bool,
                sized: bool = True,
                algorithms: Sequence[str] = ("tree",)) -> OpSpec:
    """Register a collective in the dispatch table (idempotent overwrite)."""
    spec = OpSpec(name, schedule, rootful=rootful, sized=sized,
                  algorithms=tuple(algorithms))
    OPS[name] = spec
    return spec


register_op("bcast", S.bcast, rootful=True, algorithms=("tree", "sag"))
register_op("reduce", S.reduce, rootful=True)
register_op("barrier", lambda tree, nbytes=0.0: S.barrier(tree),
            rootful=False, sized=False)
register_op("gather", S.gather, rootful=True)
register_op("scatter", S.scatter, rootful=True)
register_op("allreduce", S.allreduce, rootful=False,
            algorithms=("tree", "rsag"))
register_op("allgather", S.allgather, rootful=False)


# ---------------------------------------------------------------------- #
# Tree selection (the cost-model argmin that used to be trees.best_tree).
# ---------------------------------------------------------------------- #

def size_bucket(nbytes: float) -> int:
    """Power-of-two bucket for plan-cache keys: tree *choice* (adaptive /
    cost-model policies) is size-dependent, but varies slowly enough that one
    plan per size octave is the right cache granularity."""
    if nbytes is None or nbytes <= 0:
        return -1
    return max(0, int(math.log2(nbytes)))


def select_tree(topo: Topology, root: int, op: str, nbytes: float,
                members: Sequence[int] | None = None,
                policy: Any = "auto",
                view: Topology | None = None) -> tuple[Tree, int]:
    """Pick the tree for ``op`` under ``policy``; returns (tree, n_built).

    ``view`` builds the tree against a *different* (e.g. collapsed MagPIe, or
    deliberately oblivious) topology while the caller still charges costs on
    the true one — how the paper's baselines are reproduced.

    Policies: a :class:`LevelPolicy`, or one of
      "paper"     — flat at the WAN, binomial below (the paper's choice)
      "adaptive"  — per-level Bar-Noy/Kipnis shape from the latency ratio
      "oblivious" — rank-order binomial, no topology knowledge (MPICH)
      "auto"      — simulate paper/adaptive/oblivious candidates on the true
                    topology and take the argmin (beyond-paper; every process
                    reaches the identical choice with zero communication).
    """
    spec = OPS[op]
    build_topo = view if view is not None else topo
    if members is None:
        members = list(range(build_topo.nprocs))
    members = list(members)

    if isinstance(policy, LevelPolicy):
        return build_multilevel_tree(build_topo, root, members, policy), 1
    if policy == "paper":
        return build_multilevel_tree(build_topo, root, members,
                                     PAPER_POLICY), 1
    if policy == "adaptive":
        return build_multilevel_tree(
            build_topo, root, members,
            adaptive_policy(build_topo, nbytes or 0.0)), 1
    if policy == "oblivious":
        return binomial_tree(root, members), 1
    if policy in ("auto", "best"):
        candidates = _candidate_trees(build_topo, root, members, nbytes)
        nb = nbytes or 0.0
        times = [max(simulate(spec.schedule(t, nb), topo).values())
                 for t in candidates]
        return candidates[times.index(min(times))], len(candidates)
    raise ValueError(f"unknown policy {policy!r}")


def _candidate_trees(build_topo: Topology, root: int, members: list,
                     nbytes: float) -> list[Tree]:
    """The ONE candidate-tree list every "auto" argmin searches."""
    return [
        build_multilevel_tree(build_topo, root, members, PAPER_POLICY),
        build_multilevel_tree(build_topo, root, members,
                              adaptive_policy(build_topo, nbytes or 0.0)),
        binomial_tree(root, members),
    ]


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    """Outcome of plan selection: the tree, the rounds-IR algorithm, the
    segment policy (None | "bdp" | bytes) and how many trees were built."""

    tree: Tree
    algorithm: str
    segment: Any
    n_built: int


# Only these ops gain from sub-message segmentation (uniform payload down /
# up the tree); personalised ops pipeline at chunk granularity instead.
_SEGMENTABLE = ("bcast", "reduce", "allreduce")


def select_plan(topo: Topology, root: int, op: str, nbytes: float,
                members: Sequence[int] | None = None,
                policy: Any = "auto",
                view: Topology | None = None,
                algorithm: str | None = None,
                segment_bytes: Any = None) -> PlanChoice:
    """Pick (tree, algorithm, segment size) for one collective.

    Under a fixed tree policy the defaults stay faithful to that baseline:
    algorithm "tree", no segmentation.  Under ``policy="auto"`` (or an
    explicit ``algorithm="auto"``) the argmin searches the full product
    {tree shape} x {registered algorithm} x {segment size} by lowering each
    candidate to the rounds IR and simulating it on the true topology —
    every process reaches the identical choice with zero communication.
    """
    spec = OPS[op]
    build_topo = view if view is not None else topo
    if members is None:
        members = list(range(build_topo.nprocs))
    members = list(members)

    searching = policy in ("auto", "best")
    if searching:
        trees = _candidate_trees(build_topo, root, members, nbytes)
        n_built = len(trees)
    else:
        tree, n_built = select_tree(topo, root, op, nbytes,
                                    members=members, policy=policy,
                                    view=view)
        trees = [tree]

    # algorithm candidates: fixed policies default to the faithful "tree"
    # plan; searching policies (or algorithm="auto") consider everything
    # registered for the op.  Baselines built against a *view* stay on
    # "tree" — they model systems without the leaf-group machinery.
    nb = float(nbytes or 0.0)
    if algorithm not in (None, "auto"):
        algos = [algorithm]
    elif (algorithm == "auto" or searching) and view is None and nb > 0 \
            and len(members) > 1:
        algos = list(spec.algorithms)
    else:
        algos = ["tree"]

    # segment candidates
    if segment_bytes is None:
        segs = ([None, "bdp"] if searching and op in _SEGMENTABLE and nb > 0
                else [None])
    elif segment_bytes == "off":
        segs = [None]
    else:
        segs = [segment_bytes]

    combos: list[tuple[Tree, str, Any]] = []
    for seg in segs:
        for algo in algos:
            if algo == "tree":
                combos.extend((t, "tree", seg) for t in trees)
            else:
                combos.append((trees[0], algo, seg))

    if len(combos) == 1:
        tree, algo, seg = combos[0]
        if algo != "tree":  # forced algorithm: fail at plan time, curated
            try:
                R.lower(op, algo, tree, build_topo, nb, segment_bytes=seg,
                        members=members, root=root)
            except ValueError as e:
                raise ValueError(
                    f"no candidate of [{algo!r}] lowers op {op!r} on this "
                    f"topology ({e}); drop algorithm= to let the policy "
                    f"fall back to 'tree'") from e
        return PlanChoice(tree, algo, seg, n_built)

    best, best_t = None, math.inf
    for tree, algo, seg in combos:
        try:
            low = R.lower(op, algo, tree, build_topo, nb,
                          segment_bytes=seg, members=members, root=root)
        except ValueError:  # e.g. rsag on non-uniform leaf groups
            continue
        t = max(simulate_rounds(low, topo).values())
        if t < best_t:
            best, best_t = (tree, algo, seg), t
    if best is None:
        # only reachable when a non-"tree" algorithm was explicitly forced
        # and no candidate could lower it on this topology
        raise ValueError(
            f"no candidate of {sorted({a for _, a, _ in combos})} lowers "
            f"op {op!r} on this topology (rsag, e.g., needs uniform "
            f"leaf-group sizes); drop algorithm= to let the policy fall "
            f"back to 'tree'")
    return PlanChoice(best[0], best[1], best[2], n_built)


# ---------------------------------------------------------------------- #
# Plans and the plan cache.
# ---------------------------------------------------------------------- #

class Plan:
    """A cached collective plan: the selected ``tree`` + ``algorithm`` +
    ``segment`` policy, the lazily-built whole-message ``schedule(nbytes)``,
    the lowered rounds IR ``lower(nbytes)`` (both memoised per exact size),
    and the static p2p ``rounds`` — everything that is pure function of
    (op, root, members, size-bucket) and therefore reusable across calls.

    The pipeline is select → **lower** → execute: selection fixes the plan,
    ``lower(nbytes)`` splits the payload into per-level segments and emits
    the per-rank timed rounds every backend consumes."""

    __slots__ = ("spec", "root", "tree", "algorithm", "segment", "_topo",
                 "_members", "_schedules", "_lowered", "_rounds",
                 "max_nbytes")

    def __init__(self, spec: OpSpec, root: int, tree: Tree,
                 topo: Topology | None = None,
                 members: Sequence[int] | None = None,
                 algorithm: str = "tree", segment: Any = None):
        self.spec = spec
        self.root = root
        self.tree = tree
        self.algorithm = algorithm
        self.segment = segment
        self._topo = topo
        self._members = tuple(members if members is not None
                              else tree.members())
        self._schedules: dict[float, S.Schedule] = {}
        self._lowered: dict[float, R.Lowered] = {}
        self._rounds: list[list[tuple[int, int]]] | None = None
        # largest size this plan ever served — survives the bounded memo
        # clears below; repair() splices at this scale
        self.max_nbytes = 0.0

    @property
    def op(self) -> str:
        return self.spec.name

    def schedule(self, nbytes: float = 0.0) -> S.Schedule:
        key = float(nbytes or 0.0)
        self.max_nbytes = max(self.max_nbytes, key)
        if key not in self._schedules:
            if len(self._schedules) >= 16:  # bound the per-size memo
                self._schedules.clear()
            self._schedules[key] = (self.spec.schedule(self.tree, key)
                                    if self.spec.sized
                                    else self.spec.schedule(self.tree))
        return self._schedules[key]

    def lower(self, nbytes: float = 0.0) -> R.Lowered:
        """The rounds IR for this plan at one exact size: payload split into
        segments (size from the cost model's bandwidth-delay product when
        ``segment == "bdp"``) and emitted as per-rank pipelined rounds."""
        if self._topo is None:
            raise ValueError("plan was built without a topology; "
                             "cannot lower")
        key = float(nbytes or 0.0)
        self.max_nbytes = max(self.max_nbytes, key)
        if key not in self._lowered:
            if len(self._lowered) >= 16:  # bound the per-size memo
                self._lowered.clear()
            self._lowered[key] = R.lower(
                self.op, self.algorithm, self.tree, self._topo, key,
                segment_bytes=self.segment, members=self._members,
                root=self.root)
        return self._lowered[key]

    @property
    def rounds(self) -> list[list[tuple[int, int]]]:
        if self._rounds is None:
            from .tree_exec import tree_rounds  # lazy: pulls in torch
            self._rounds = tree_rounds(self.tree)
        return self._rounds

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Plan(op={self.op!r}, root={self.root}, "
                f"algorithm={self.algorithm!r}, "
                f"|members|={len(self.tree.members())})")


CacheInfo = collections.namedtuple(
    "CacheInfo", ["hits", "misses", "currsize", "maxsize", "tree_builds"])


@dataclasses.dataclass(frozen=True)
class CommStats:
    """Plan-reuse and elasticity counters for one communicator.

    ``hits``/``misses`` are plan-cache lookups; ``evictions`` counts
    CAPACITY evictions only (``refresh``'s wholesale invalidation is a
    deliberate cost-model change, not cache pressure, and is reported by
    its own return value).  ``tree_builds`` is the number of candidate
    trees ever constructed and ``repairs`` the number of
    :meth:`Communicator.repair` calls that removed at least one member —
    together they let the engine and benchmarks *assert* plan reuse
    instead of inferring it from timing.
    """

    hits: int
    misses: int
    evictions: int
    currsize: int
    maxsize: int
    tree_builds: int
    repairs: int


@dataclasses.dataclass(frozen=True)
class RepairReport:
    """Outcome of one :meth:`Communicator.repair` call.

    ``repaired`` plans had their trees spliced in place (no tree rebuild);
    ``evicted`` plans were dropped and will re-plan lazily (dead root, or a
    leaf-group algorithm whose lowering is membership-shaped); ``kept``
    entries did not intersect the failed ranks and were untouched.
    """

    failed: tuple[int, ...]
    members: tuple[int, ...]
    repaired: int
    evicted: int
    kept: int


@dataclasses.dataclass(frozen=True)
class RefreshReport:
    """Outcome of one :meth:`Communicator.refresh` call.  ``drift`` maps
    link-class index -> the measured/modeled time ratio deviating most
    from 1.0 across both probe sizes (see
    :func:`repro_torch.core.discovery.measure_drift`); ``worst`` is the largest
    |ratio - 1|."""

    refreshed: bool
    drift: dict[int, float]
    worst: float


class PlanCache:
    """Tiny LRU keyed by (op, root, size-bucket, members, policy).

    Counters live in a :class:`repro_torch.obs.MetricsRegistry` (the
    communicator's, when owned by one) so cache behaviour shows up in the
    same sink as every other layer's metrics; ``hits``/``misses``/
    ``evictions`` remain plain-int reads, and monotonicity is now enforced
    by the Counter type rather than promised by convention.
    """

    def __init__(self, maxsize: int = 128, *, metrics=None):
        self.maxsize = maxsize
        m = metrics if metrics is not None else MetricsRegistry()
        self._hits = m.counter("comm.cache.hits")
        self._misses = m.counter("comm.cache.misses")
        self._evictions = m.counter("comm.cache.evictions")
        self._d: collections.OrderedDict = collections.OrderedDict()

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    def get_or_build(self, key, build: Callable[[], Plan]) -> Plan:
        if key in self._d:
            self._hits.inc()
            self._d.move_to_end(key)
            return self._d[key]
        self._misses.inc()
        plan = build()
        self._d[key] = plan
        if len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self._evictions.inc()
        return plan

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()
        self._hits.reset()
        self._misses.reset()
        self._evictions.reset()

    # -- surgical access (elastic repair) ------------------------------- #
    def items(self) -> list[tuple[Any, Plan]]:
        """Snapshot of (key, plan) entries in LRU order, oldest first."""
        return list(self._d.items())

    def pop(self, key) -> Plan | None:
        """Drop one entry (stats untouched); None when absent."""
        return self._d.pop(key, None)

    def put(self, key, plan: Plan) -> None:
        """Insert/overwrite an entry directly — used to re-key repaired
        plans; counts as neither hit nor miss."""
        self._d[key] = plan
        self._d.move_to_end(key)
        if len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self._evictions.inc()

    def invalidate(self) -> None:
        """Drop every entry but keep hit/miss statistics (unlike
        :meth:`clear`) — used when topology refresh voids all plans."""
        self._d.clear()


# ---------------------------------------------------------------------- #
# Backends.
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class SimResult:
    """Per-rank completion times of one simulated collective."""

    op: str
    root: int
    nbytes: float
    completion: dict[int, float]

    @property
    def time(self) -> float:
        """Wall-clock of the collective: the last rank to finish."""
        return max(self.completion.values())


class SimBackend:
    """Postal-model simulation: operands are byte counts.  Executes the
    plan's lowered rounds IR — segment events with per-send dependencies —
    not the whole-message schedule."""

    name = "sim"
    needs_plan = True

    def __init__(self, comm: "Communicator"):
        self.comm = comm

    def run(self, op: str, plan: Plan, x, root: int) -> SimResult:
        nbytes = float(x) if OPS[op].sized else 0.0
        tr = self.comm.tracer
        if tr is None:
            completion = simulate_rounds(plan.lower(nbytes), self.comm.topo)
            return SimResult(op, root, nbytes, completion)
        self.comm._collective_seq += 1
        label = f"{op}#{self.comm._collective_seq}"
        completion = simulate_rounds(plan.lower(nbytes), self.comm.topo,
                                     tracer=tr, label=label)
        t1 = max(completion.values())
        tr.span(PID_PROGRAMS, label, op, 0.0, t1,
                {"op": op, "root": root, "nbytes": nbytes,
                 "algorithm": plan.algorithm, "segment": plan.segment,
                 "measured_s": t1})
        return SimResult(op, root, nbytes, completion)


class P2PBackend:
    """Faithful §3.2 execution: one ``batch_isend_irecv`` per tree round on
    a process group (``group=``, default: the default group) whose rank i
    is member i.  Root-ful ops return zeros on non-root ranks (mirroring
    MPI out-buffer semantics).  ``peers`` (a ``tree_exec.Peers``) counts
    the bytes and messages this rank puts on each link class and, for
    gloo and tensors on a card, the bytes it stages through host memory."""

    name = "p2p"
    needs_plan = True

    def __init__(self, comm: "Communicator"):
        import torch.distributed as dist
        from .tree_exec import Peers

        if not dist.is_initialized():
            raise ValueError("backend='p2p' requires an initialised process "
                             "group (torch.distributed.init_process_group)")
        self.comm = comm
        self.peers = Peers(comm.topo, comm.group)

    def run(self, op: str, plan: Plan, x, root: int):
        return getattr(self, op)(plan, x, root)

    # -- ops ----------------------------------------------------------- #
    def bcast(self, plan, x, root):
        from . import tree_exec as TE
        lowered = plan.lower(self.comm._nbytes_of("bcast", x))
        return TE.run_lowered(x, lowered, self.peers)

    def reduce(self, plan, x, root):
        import torch

        from . import tree_exec as TE
        r = TE.tree_reduce(x, plan.tree, self.peers)
        return r if self.peers.index == root else torch.zeros_like(r)

    def allreduce(self, plan, x, root):
        from . import tree_exec as TE
        lowered = plan.lower(self.comm._nbytes_of("allreduce", x))
        return TE.run_lowered(x, lowered, self.peers)

    def gather(self, plan, x, root):
        import torch

        from . import tree_exec as TE
        buf = TE.tree_gather_flat(x, plan.tree, self.peers,
                                  len(self.comm.members))
        return buf if self.peers.index == root else torch.zeros_like(buf)

    def allgather(self, plan, x, root):
        from . import tree_exec as TE
        buf = TE.tree_gather_flat(x, plan.tree, self.peers,
                                  len(self.comm.members))
        return TE.tree_bcast(buf, plan.tree, self.peers)

    def scatter(self, plan, x, root):
        # Root holds the full [P, ...] buffer; ship it down the tree and let
        # each rank slice its row.  (A trimming scatter that sends only each
        # subtree's rows is the simulator-plane model; on ranks we accept
        # the bcast-sized payload for a fixed round program.)
        from . import tree_exec as TE
        full = TE.tree_bcast(x, plan.tree, self.peers)
        return full[self.peers.index]

    def barrier(self, plan, x, root):
        from . import tree_exec as TE
        token = self.token(self.peers.backend)
        token = TE.tree_reduce(token, plan.tree, self.peers)
        return TE.tree_bcast(token, plan.tree, self.peers)

    @staticmethod
    def token(dist_backend: str | None):
        """A barrier's f32 zero token: on the card for NCCL, else on the
        host."""
        import torch

        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist_backend == "nccl" else torch.device("cpu"))
        return torch.zeros((), dtype=torch.float32, device=dev)


class TorchBackend:
    """Grid-decomposed collectives over the process groups of a
    ``launch.mesh.Grid`` (``grid=``); the rest lower to a single (masked)
    sum over all ranks.

    Allreduce consumes the plan's algorithm choice: ``"rsag"`` lowers to
    the reduce-scatter / exchange / all-gather decomposition
    (:func:`~repro_torch.core.collectives.multilevel_psum`) where the pod
    has more than one rank; ``"tree"`` (the small-message winner) lowers
    to one all-reduce over every rank — the latency-optimal native path.

    Rank space: the grid's row-major (pod, data) rank — the communicator's
    topology/members must cover exactly those ranks
    (``launch.mesh.grid_communicator`` builds the matching topology)."""

    name = "torch"
    needs_plan = True

    def __init__(self, comm: "Communicator"):
        if comm.grid is None:
            raise ValueError("backend='torch' requires grid=<this rank's "
                             "launch.mesh.Grid>")
        self.comm = comm
        self.grid = comm.grid

    def run(self, op: str, plan, x, root: int):
        if op == "allreduce":
            return self.allreduce(x, root, plan)
        return getattr(self, op)(x, root)

    # -- ops ------------------------------------------------------------ #
    def allreduce(self, x, root, plan=None):
        import torch

        from .collectives import multilevel_psum
        fast = self.grid.fast.size
        if (plan is not None and plan.algorithm == "tree") or fast == 1:
            return self.grid.dp.psum(x)  # fused: latency-optimal
        flat = x.reshape(-1)
        pad = (-flat.numel()) % fast
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        flat = multilevel_psum(flat, self.grid.slow, self.grid.fast)
        if pad:
            flat = flat[:flat.numel() - pad]
        return flat.reshape(x.shape)

    def bcast(self, x, root):
        masked = x if self.grid.rank == root else x.new_zeros(x.shape)
        return self.grid.dp.psum(masked)

    def reduce(self, x, root):
        full = self.grid.dp.psum(x)
        return full if self.grid.rank == root else full.new_zeros(full.shape)

    def gather(self, x, root):
        full = self.grid.dp.psum(self._placed(x))
        return full if self.grid.rank == root else full.new_zeros(full.shape)

    def allgather(self, x, root):
        return self.grid.dp.psum(self._placed(x))

    def scatter(self, x, root):
        masked = x if self.grid.rank == root else x.new_zeros(x.shape)
        return self.grid.dp.psum(masked)[self.grid.rank]

    def barrier(self, x, root):
        return self.grid.dp.psum(P2PBackend.token(self.grid.backend))

    def _placed(self, x):
        buf = x.new_zeros((self.grid.world,) + tuple(x.shape))
        buf[self.grid.rank] = x
        return buf


BACKENDS: dict[str, type] = {
    "sim": SimBackend,
    "p2p": P2PBackend,
    "torch": TorchBackend,
}


# ---------------------------------------------------------------------- #
# The communicator.
# ---------------------------------------------------------------------- #

class Communicator:
    """Topology-aware collectives behind one object.

    Parameters
    ----------
    topo : the true multilevel topology costs are charged on.
    policy : "paper" | "adaptive" | "oblivious" | "auto" | LevelPolicy.
    backend : "sim" | "torch" | "p2p" (see module docstring).
    members : participating ranks (default: all of ``topo``).
    view : optional topology the *trees* are built against (MagPIe/oblivious
        baselines) while simulation still charges true per-edge costs.
    algorithm : None (policy decides: "tree" under fixed policies, searched
        under "auto") | "tree" | "sag" | "rsag" | "auto" (force the search).
    segment_bytes : None (policy decides: unsegmented under fixed policies,
        searched under "auto") | "bdp" (bandwidth-delay product) | "off" |
        explicit bytes.  Governs how ``Plan.lower`` splits payloads.
    group : process group of the p2p backend, its rank i being member i
        (default: the default group).
    grid : this rank's ``launch.mesh.Grid`` (torch backend).
    tracer : optional :class:`repro_torch.obs.Tracer`; when set, every planned
        collective run by the sim backend records per-link busy intervals
        and a span with the selected algorithm × segment and predicted
        cost, and every ``plan()`` call emits a planner instant
        (hit/miss + choice) on the wall-clock track.
    metrics : optional shared :class:`repro_torch.obs.MetricsRegistry`; the
        communicator's counters (``comm.cache.*``, ``comm.tree_builds``,
        ``comm.repairs``) register there.  Default: a private registry —
        communicators never alias each other's stats unless asked to.
    """

    def __init__(self, topo: Topology, *, policy: Any = "auto",
                 backend: str = "sim",
                 members: Sequence[int] | None = None,
                 view: Topology | None = None,
                 algorithm: str | None = None,
                 segment_bytes: Any = None,
                 group=None,
                 grid=None,
                 cache_size: int = 128,
                 tracer=None,
                 metrics: MetricsRegistry | None = None):
        self.topo = topo
        self.policy = policy
        self.view = view
        self.algorithm = algorithm
        self.segment_bytes = segment_bytes
        self.members = tuple(members if members is not None
                             else range(topo.nprocs))
        if not self.members:
            raise ValueError("communicator needs at least one member")
        self.group = group
        self.grid = grid
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._tree_builds = self.metrics.counter("comm.tree_builds")
        self._repairs = self.metrics.counter("comm.repairs")
        self._collective_seq = 0
        self._cache = PlanCache(cache_size, metrics=self.metrics)
        try:
            backend_cls = BACKENDS[backend]
        except KeyError:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"choose from {sorted(BACKENDS)}") from None
        self.backend = backend_cls(self)

    # Registry-backed counters behind the historical plain-int attributes.
    # Read-only on purpose: external code asserting on these must not be
    # able to rewind them (monotonicity is part of the stats contract).
    @property
    def tree_builds(self) -> int:
        return self._tree_builds.value

    @property
    def repairs(self) -> int:
        return self._repairs.value

    # -- discovery ------------------------------------------------------- #
    @classmethod
    def from_probes(cls, probes, *, gap_factor: float | None = None,
                    path: str | None = None, refresh: bool = False,
                    **kwargs) -> "Communicator":
        """Build a communicator on a topology *discovered* from probes.

        ``probes`` is a :class:`repro_torch.core.discovery.ProbeSet` (from
        :func:`~repro_torch.core.discovery.simulated_probes`); the probe matrix is
        clustered into strata and per-stratum link classes are fitted —
        see :mod:`repro_torch.core.discovery`.  ``path`` is the Fast-Tuning
        cache: when the file exists (and ``refresh`` is false) the fitted
        topology is loaded from it and the probe matrix is not consulted;
        otherwise the discovered topology is persisted there.  Remaining
        kwargs are the usual constructor knobs (policy/backend/...).
        """
        from . import discovery as D

        if path and not refresh and os.path.exists(path):
            topo = Topology.load(path)
        else:
            gf = (D.DEFAULT_GAP_FACTOR if gap_factor is None
                  else gap_factor)
            topo = D.fit_topology(probes, gap_factor=gf)
            if path:
                topo.save(path)
        return cls(topo, **kwargs)

    # -- planning -------------------------------------------------------- #
    def _size_dependent(self, policy) -> bool:
        """Only searching/adaptive policies (or a searched algorithm)
        choose a different plan per size octave; for the rest, one plan per
        (op, root) serves every message size, so plan() inspection and
        execution always share a cache entry."""
        return (policy in ("adaptive", "auto", "best")
                or self.algorithm == "auto")

    def plan(self, op: str, *, root: int | None = None,
             nbytes: float = 0.0, policy: Any = None) -> Plan:
        """The (cached) plan for one collective.  Key: (op, root,
        size-bucket, members, policy) — a second identical call re-runs
        nothing, and a per-call ``policy=`` override can never be served a
        plan built under a different policy (the override is part of the
        key, not just the build closure)."""
        spec = OPS[op]  # KeyError on unknown op is the dispatch contract
        root = self.members[0] if root is None else root
        if root not in self.members:
            raise ValueError(f"root {root} is not a member")
        policy = self.policy if policy is None else policy
        bucket = (size_bucket(nbytes)
                  if self._size_dependent(policy) and spec.sized else -1)
        # str policies and LevelPolicy (frozen, tuple field) are hashable
        key = (op, root, bucket, self.members, policy)

        def build() -> Plan:
            choice = select_plan(self.topo, root, op, nbytes,
                                 members=self.members,
                                 policy=policy, view=self.view,
                                 algorithm=self.algorithm,
                                 segment_bytes=self.segment_bytes)
            self._tree_builds.inc(choice.n_built)
            return Plan(spec, root, choice.tree,
                        topo=(self.view if self.view is not None
                              else self.topo),
                        members=self.members,
                        algorithm=choice.algorithm, segment=choice.segment)

        if self.tracer is None:
            return self._cache.get_or_build(key, build)
        misses_before = self._cache.misses
        plan = self._cache.get_or_build(key, build)
        hit = self._cache.misses == misses_before
        tr, ts, topo = self.tracer, self.tracer.wall(), self.topo

        def _instant():
            args = {"op": op, "root": root, "nbytes": nbytes, "hit": hit,
                    "algorithm": plan.algorithm, "segment": plan.segment}
            if not hit and spec.sized and nbytes > 0:
                # predicted makespan of the freshly selected plan under
                # the communicator's cost model — the number obs.feedback
                # compares against measured durations.  Deferred: the
                # extra simulation runs at trace-read time.
                args["predicted_s"] = max(
                    simulate_rounds(plan.lower(nbytes), topo).values())
            tr.instant(PID_PLANNER, "plan",
                       f"plan {op} {'hit' if hit else 'miss'}", ts, args)

        tr.defer_record(_instant)
        return plan

    def cache_info(self) -> CacheInfo:
        c = self._cache
        return CacheInfo(c.hits, c.misses, len(c), c.maxsize,
                         self.tree_builds)

    def stats(self) -> CommStats:
        """Plan-reuse counters (:class:`CommStats`): cache hits, misses,
        capacity evictions, tree builds, and repairs — what the async
        engine and the benchmarks assert plan reuse against."""
        c = self._cache
        return CommStats(c.hits, c.misses, c.evictions, len(c), c.maxsize,
                         self.tree_builds, self.repairs)

    def clear_cache(self) -> None:
        self._cache.clear()
        self._tree_builds.reset()

    def verify_plans(self) -> int:
        """Statically verify every cached plan (:mod:`repro_torch.analysis.verify`:
        semantics, byte conservation, dependency DAG, member closure) at
        every payload size it has lowered — or at its largest observed
        traffic when it never lowered.  Returns the number of lowered
        programs checked; raises
        :class:`~repro_torch.analysis.verify.VerificationError` on a plan that
        fails.  :meth:`repair` and :meth:`refresh` run this automatically,
        so a spliced or refitted cache is re-proven before serving traffic.
        """
        from ..analysis.verify import check_lowered  # no load-time cycle

        checked = 0
        for key, plan in self._cache.items():
            op, root, _bucket, _mem, _pol = key
            sizes = sorted(plan._lowered) or [max(plan.max_nbytes, 65536.0)]
            for nb in sizes:
                check_lowered(plan.lower(nb),
                              context=f"cached plan {op}/{plan.algorithm} "
                                      f"root={root} nbytes={nb:g}")
                checked += 1
        return checked

    # -- elasticity: survive failures without a full re-plan ------------- #
    def has_quorum(self, failed: Sequence[int], quorum: float = 0.5) -> bool:
        """True when removing ``failed`` leaves strictly more than
        ``quorum`` of the current membership — the threshold below which
        callers should fall back to checkpoint-restart instead of
        :meth:`repair`.  The rule itself lives in ONE place
        (:func:`repro_torch.runtime.fault_tolerance.has_quorum`; imported lazily
        so the core package keeps no load-time runtime dependency)."""
        from ..runtime.fault_tolerance import has_quorum

        dead = set(failed) & set(self.members)
        return has_quorum(len(self.members), len(dead), quorum)

    def repair(self, failed: Sequence[int], *,
               verify: bool = True) -> RepairReport:
        """Remove failed ranks and repair the plan cache IN PLACE.

        Every cached plan whose member set intersects ``failed`` is either
        *repaired* — its tree spliced by :func:`~repro_torch.core.trees.repair_tree`
        (orphans reparent onto the cheapest surviving attach point; no tree
        is rebuilt, so ``tree_builds`` does not move) and re-keyed under the
        surviving membership — or *evicted* when it cannot be spliced (its
        root died, or it runs a leaf-group algorithm such as sag/rsag whose
        lowering is shaped by membership) and re-plans lazily on next use.
        Entries whose member sets do not intersect the failed ranks are
        untouched.  Unless ``verify=False``, the surviving cache is then
        re-proven by :meth:`verify_plans` — an in-place splice never gets
        to serve traffic unverified.
        """
        dead = set(failed) & set(self.members)
        survivors = tuple(m for m in self.members if m not in dead)
        if not survivors:
            raise ValueError("repair would leave no members")
        repaired = evicted = kept = 0
        for key, plan in self._cache.items():
            op, root, bucket, key_members, pol = key
            if not set(key_members) & dead:
                kept += 1
                continue
            self._cache.pop(key)
            if root in dead or plan.algorithm != "tree":
                evicted += 1
                continue
            new_members = tuple(m for m in key_members if m not in dead)
            build_topo = self.view if self.view is not None else self.topo
            # splice at the plan's largest executed size (1 MiB floor):
            # the repair cost model must weigh bandwidth, not just
            # latency — repairing too small serializes large transfers,
            # while repairing too large is measurably harmless
            nb = max(plan.max_nbytes, float(1 << 20))
            try:
                tree = repair_tree(plan.tree, build_topo, dead, nbytes=nb)
            except ValueError:
                evicted += 1
                continue
            new_plan = Plan(plan.spec, root, tree, topo=build_topo,
                            members=new_members, algorithm="tree",
                            segment=plan.segment)
            # a later repair (before any intervening collective) must
            # still splice at the true traffic scale
            new_plan.max_nbytes = plan.max_nbytes
            self._cache.put((op, root, bucket, new_members, pol), new_plan)
            repaired += 1
        self.members = survivors
        if dead:
            self._repairs.inc()
            if verify:
                self.verify_plans()
        return RepairReport(tuple(sorted(dead)), survivors,
                            repaired, evicted, kept)

    def refresh(self, probes, *, threshold: float = 0.1,
                verify: bool = True) -> RefreshReport:
        """Fold a targeted drift re-probe into the communicator.

        ``probes`` is a :class:`repro_torch.core.discovery.TargetedProbes` taken
        at :func:`~repro_torch.core.discovery.representative_pairs` of this
        topology — O(strata · group-count) measurements, not the O(P²) of
        full discovery.  When any link class has drifted by more than
        ``threshold`` (worst measured/modeled time ratio over both probe
        sizes), the level parameters are refitted (coordinates — i.e.
        membership and grouping — are untouched) and all cached plans are
        invalidated so the next call re-runs the argmin under the fresh
        costs.  Probe pairs touching non-members (e.g. ranks removed by an
        earlier :meth:`repair` when the pair list was built from the full
        topology) are ignored.
        """
        from . import discovery as D

        if self.view is not None:
            # a view's Level objects were copied at construction from an
            # unknown transform (collapse/flat) of some topology; refitting
            # self.topo alone would leave tree construction on stale costs
            # while claiming success
            raise ValueError(
                "refresh is not supported on a view-based communicator; "
                "rebuild the view from the refitted topology instead")
        members = set(self.members)
        if any(p not in members or q not in members
               for p, q, _ in probes.pairs):
            keep = [i for i, (p, q, _) in enumerate(probes.pairs)
                    if p in members and q in members]
            probes = D.TargetedProbes(
                tuple(probes.pairs[i] for i in keep), probes.sizes,
                probes.times[keep],
                None if probes.inject is None else probes.inject[keep])
        drift = D.measure_drift(self.topo, probes)
        worst = max((abs(r - 1.0) for r in drift.values()), default=0.0)
        if worst <= threshold:
            return RefreshReport(False, drift, worst)
        self.topo = D.refit_levels(self.topo, probes)
        self._cache.invalidate()  # stale costs; stats/counters stay
        if verify:
            # the cache was just invalidated, so this proves "no stale
            # plan survived the refit" rather than re-checking lowerings;
            # plans built later verify on the next repair()/verify_plans()
            self.verify_plans()
        return RefreshReport(True, drift, worst)

    # -- the seven collectives -------------------------------------------- #
    def bcast(self, x, *, root: int = 0):
        return self._run("bcast", x, root)

    def reduce(self, x, *, root: int = 0):
        return self._run("reduce", x, root)

    def barrier(self):
        return self._run("barrier", None, self.members[0])

    def gather(self, x, *, root: int = 0):
        return self._run("gather", x, root)

    def scatter(self, x, *, root: int = 0):
        return self._run("scatter", x, root)

    def allreduce(self, x):
        return self._run("allreduce", x, self.members[0])

    def allgather(self, x):
        return self._run("allgather", x, self.members[0])

    def _run(self, op: str, x, root: int):
        if root not in self.members:  # every backend, planned or not
            raise ValueError(f"root {root} is not a member")
        plan = None
        if self.backend.needs_plan:
            plan = self.plan(op, root=root, nbytes=self._nbytes_of(op, x))
        return self.backend.run(op, plan, x, root)

    def allreduce_tree(self, grads, *, mode: str = "multilevel",
                       mean_over: int | None = None, ef=None,
                       bucket_bytes: float | None = None):
        """All-reduce a gradient tree (torch backend only): fuses all leaves
        into one flat buffer per level — see
        :func:`~repro_torch.core.collectives.multilevel_psum_tree`.

        ``bucket_bytes`` switches to SIZE-TARGETED BUCKETS in reverse leaf
        order (:func:`~repro_torch.core.collectives.bucketed_psum_tree`):
        one collective per bucket instead of one monolithic buffer.
        Incompatible with ``ef`` / the compressed mode (the residual is
        shaped by the exchange).

        ``ef`` is the error-feedback residual for
        ``mode="multilevel_compress"`` (build it once with
        :func:`~repro_torch.core.collectives.compress_ef_zeros`); when given
        the call returns ``(grads, new_ef)`` and the residual must be
        carried to the next step — without it the int8 rounding bias
        accumulates across steps."""
        if not isinstance(self.backend, TorchBackend):
            raise ValueError("allreduce_tree requires backend='torch'")
        grid = self.backend.grid
        if bucket_bytes is not None:
            if ef is not None:
                raise ValueError("bucketed sync does not thread an "
                                 "error-feedback residual")
            from .collectives import bucketed_psum_tree
            return bucketed_psum_tree(grads, grid, bucket_bytes=bucket_bytes,
                                      mode=mode, mean_over=mean_over)
        from .collectives import multilevel_psum_tree
        return multilevel_psum_tree(grads, grid, mode=mode,
                                    mean_over=mean_over, ef=ef)

    # -- introspection ----------------------------------------------------- #
    def _nbytes_of(self, op: str, x) -> float:
        """The plan-sizing byte count for one operand.

        PINNED SEMANTICS (plan selection, segment sizing, and the engine's
        bucketing argmin all key off this number):

        * ``bcast`` / ``reduce`` / ``allreduce`` — the full payload every
          rank holds (the schedule ships exactly this many bytes per edge).
        * ``gather`` / ``allgather`` / ``scatter`` — the PER-RANK
          contribution; aggregate traffic grows with subtree sizes
          (``S.gather`` message bytes are ``subtree_size * nbytes``), so
          sizing these by the aggregate would overshoot plan selection by
          a factor of P.

        Numeric operands are that quantity directly.  Tensor operands are
        sized from this rank's tensor (``numel() * element_size()``; an
        array by its shape and item size) — which IS the per-rank
        contribution for gather/allgather, but for ``scatter`` the operand
        is the root's full ``[P, ...]`` buffer, so it is divided by the
        member count to recover the per-rank chunk.
        """
        if not OPS[op].sized or x is None:
            return 0.0
        if isinstance(x, (int, float)):
            return float(x)
        # a tensor or array: bytes of this rank's operand
        size = 1
        for d in getattr(x, "shape", ()):
            size *= int(d)
        itemsize = getattr(getattr(x, "dtype", None), "itemsize", 4)
        nbytes = float(size * itemsize)
        if op == "scatter":
            nbytes /= max(len(self.members), 1)
        return nbytes

    def slow_crossings(self, op: str, *, root: int = 0,
                       nbytes: float = 0.0) -> int:
        """Edges of the plan's tree that cross the slowest level — the
        paper's headline metric (log C -> C-1 -> 1 wide-area messages)."""
        tree = self.plan(op, root=root, nbytes=nbytes).tree
        return sum(1 for p, cs in tree.children.items() for c in cs
                   if self.topo.comm_level(p, c) == 0)

    def describe(self) -> str:
        lv = "/".join(l.name for l in self.topo.levels)
        pol = (self.policy if isinstance(self.policy, str)
               else type(self.policy).__name__)
        return (f"Communicator(P={len(self.members)}, levels={lv}, "
                f"policy={pol}, backend={self.backend.name})")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return self.describe()
