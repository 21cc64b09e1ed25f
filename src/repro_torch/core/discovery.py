"""Automatic topology discovery: probe, cluster, and fit multilevel
topologies at runtime.

The paper's trees are "constructed automatically during execution" — but
only *given* topology information the runtime supplies (MPICH-G2 read it
from RSL "depths" the user wrote by hand).  This module closes the loop the
way Estefanel & Mounié (cs/0408033) proposed: infer the logical homogeneous
clusters from measured point-to-point performance, then cache the decision
("Fast Tuning", cs/0408034) so a fleet is measured once, not per job.

Probe sources feed one pipeline::

    probes ──> cluster_probes ──> fit_levels ──> Topology
    (ProbeSet)  (agglomerative +   (least-squares    (canonical coords
                 dendrogram gap     Level per         + link classes)
                 cut → strata)      stratum)

1. :func:`simulated_probes` — all-pairs postal-model timings sampled from a
   hidden ground-truth :class:`Topology` with configurable multiplicative
   noise.  This is the validation plane: recovery accuracy vs. noise is a
   measurable quantity.
2. :func:`environment_topology` — coordinates from the ranks' environment:
   the node (torchrun's ``GROUP_RANK``) and the card each rank is bound
   to.  No timing needed.
3. :func:`device_probes` — timed point-to-point round trips between the
   ranks of a process group at two message sizes, fitting per-pair latency
   and bandwidth.

A copy of ``repro/core/discovery.py`` whose two device sources read ranks
instead of ``jax.devices()``: the reference's columns ``slice_index`` and
``process_index`` become the node and the card, and its jitted
``ppermute`` bounce becomes a ``batch_isend_irecv`` bounce.

The clusterer makes NO layer-count assumption: strata fall out of the
measurements (cost-gap plateaus in the dendrogram), which is the paper's
core thesis — as many levels as the network actually has.

Front doors: :func:`discover` (source dispatch + persistence) and
:meth:`repro_torch.core.Communicator.from_probes`.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Sequence

import numpy as np

from .topology import Level, Topology, level_matrix

__all__ = [
    "ProbeSet",
    "TargetedProbes",
    "DEFAULT_PROBE_SIZES",
    "DEFAULT_GAP_FACTOR",
    "simulated_probes",
    "GENERIC_LEVELS",
    "RankInfo",
    "environment_topology",
    "device_probes",
    "cluster_probes",
    "fit_levels",
    "fit_topology",
    "discover",
    "representative_pairs",
    "targeted_probes",
    "synthetic_probes",
    "refit_levels",
    "measure_drift",
]


# Two sizes bracket the latency- and bandwidth-dominated regimes; the
# per-pair affine model t = latency + nbytes/bandwidth is then exactly
# identified (slope → bandwidth, intercept → latency).
DEFAULT_PROBE_SIZES = (1024.0, float(1 << 20))

# A dendrogram merge height more than this factor above its predecessor
# starts a new stratum.  Within one homogeneous link class, ±10%
# multiplicative probe noise bounds consecutive-height ratios near 1.2;
# adjacent real link classes in every topology we model differ by ≥ 2×.
DEFAULT_GAP_FACTOR = 1.5


# ---------------------------------------------------------------------- #
# Probe container
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ProbeSet:
    """All-pairs point-to-point measurements at two message sizes.

    sizes  : the two probe payloads, bytes, ascending.
    times  : (P, P, 2) one-way delivery seconds; ``times[p, q, k]`` is a
             lone message p→q of ``sizes[k]`` (diagonal is zero/ignored).
    inject : optional (P, P) per-message *sender occupancy* at ``sizes[0]``,
             from a back-to-back injection-rate probe.  Separates postal
             overhead from latency; without it discovered overhead is 0.
    """

    sizes: tuple[float, float]
    times: np.ndarray
    inject: np.ndarray | None = None

    def __post_init__(self):
        t = np.asarray(self.times, dtype=float)
        if t.ndim != 3 or t.shape[0] != t.shape[1] or t.shape[2] != 2:
            raise ValueError(f"times must be (P, P, 2), got {t.shape}")
        if self.sizes[0] >= self.sizes[1]:
            raise ValueError("probe sizes must be ascending")
        object.__setattr__(self, "times", t)
        if self.inject is not None:
            inj = np.asarray(self.inject, dtype=float)
            if inj.shape != t.shape[:2]:
                raise ValueError(
                    f"inject must be (P, P), got {inj.shape}")
            object.__setattr__(self, "inject", inj)

    @property
    def nprocs(self) -> int:
        return self.times.shape[0]

    def dissimilarity(self) -> np.ndarray:
        """Symmetric (P, P) clustering metric: summed probe time over both
        sizes, so strata that differ in *either* latency or bandwidth
        separate; direction noise is averaged out."""
        d = self.times.sum(axis=2)
        return (d + d.T) / 2.0


# ---------------------------------------------------------------------- #
# Source 1: simulated probes from a hidden ground truth
# ---------------------------------------------------------------------- #

def simulated_probes(topo: Topology, *, noise: float = 0.0, seed: int = 0,
                     sizes: Sequence[float] = DEFAULT_PROBE_SIZES,
                     ) -> ProbeSet:
    """Sample all-pairs probes from ``topo`` under the postal model.

    Per pair and size the one-way time is
    :func:`repro_torch.core.simulator.probe_time` — ``overhead + latency +
    nbytes/bandwidth`` — scaled by independent multiplicative noise drawn
    uniformly from ``[1-noise, 1+noise]``.  Also emits the injection-rate
    probe (``overhead + nbytes/bandwidth``) so the fit can separate
    overhead from latency and recover the ground truth exactly at zero
    noise.
    """
    if not 0.0 <= noise < 1.0:
        raise ValueError(f"noise must be in [0, 1), got {noise}")
    s1, s2 = float(sizes[0]), float(sizes[1])
    rng = np.random.default_rng(seed)
    lm = topo.comm_level_matrix()
    lat = np.array([l.latency for l in topo.levels])[lm]
    bw = np.array([l.bandwidth for l in topo.levels])[lm]
    ovh = np.array([l.overhead for l in topo.levels])[lm]

    def jitter(shape):
        return 1.0 + noise * rng.uniform(-1.0, 1.0, shape) if noise else 1.0

    times = np.stack([(ovh + lat + s / bw) * jitter(lm.shape)
                      for s in (s1, s2)], axis=2)
    inject = (ovh + s1 / bw) * jitter(lm.shape)
    eye = np.eye(topo.nprocs, dtype=bool)
    times[eye] = 0.0
    inject[eye] = 0.0
    return ProbeSet(sizes=(s1, s2), times=times, inject=inject)


# ---------------------------------------------------------------------- #
# Source 2: the ranks' environment (the RSL-depths analogue)
# ---------------------------------------------------------------------- #

# Default link classes off a TPU (the reference's
# ``_ENV_LEVELS["generic"]``), coarsest first; the fitted topology keeps the
# innermost ``S + 1`` of them for ``S`` discovered strata.
GENERIC_LEVELS = (
    Level("dcn", latency=10e-6, bandwidth=6.25e9, overhead=2e-6),
    Level("host", latency=5e-6, bandwidth=12.5e9, overhead=2e-6),
    Level("local", latency=1e-6, bandwidth=100e9, overhead=0.5e-6),
)


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """Where one rank runs: its node and the CUDA device it is bound to
    (-1 for none).  Ranks that share a card share ``device``."""

    node: int
    device: int


def _this_rank(group=None) -> RankInfo:
    """This rank's :class:`RankInfo`: the node is torchrun's
    ``GROUP_RANK``, else the rank over ``LOCAL_WORLD_SIZE`` (default: the
    whole group on one node); the device is the current CUDA device."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if "GROUP_RANK" in os.environ:
        node = int(os.environ["GROUP_RANK"])
    else:
        node = rank // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = torch.cuda.current_device() if torch.cuda.is_available() else -1
    return RankInfo(node, device)


def environment_topology(devices: Sequence[RankInfo] | None = None, *,
                         group=None) -> Topology:
    """Derive a topology from the ranks' environment alone — no timing.

    Strata candidates, coarsest first: the node and the card a rank is
    bound to (``devices``: one :class:`RankInfo` per rank; default: every
    rank's own, gathered over the initialised process ``group``).  Columns
    that do not discriminate (all ranks agree) are dropped, so ranks of one
    node on one card (or on none) yield a flat single-class topology — the
    number of levels follows the environment, never a fixed template.
    Rank order is the group's.  The link classes are
    :data:`GENERIC_LEVELS`.
    """
    if devices is None:
        import torch.distributed as dist

        devices = [None] * dist.get_world_size(group)
        dist.all_gather_object(devices, _this_rank(group), group=group)
    devices = list(devices)
    if not devices:
        raise ValueError("no devices to derive a topology from")

    cols = [
        [int(d.node) for d in devices],
        [int(d.device) for d in devices],
    ]
    cols = [c for c in cols if len(set(c)) > 1]
    coords = (np.stack(cols, axis=1) if cols
              else np.zeros((len(devices), 0), dtype=np.int64))

    classes = GENERIC_LEVELS
    need = coords.shape[1] + 1
    levels = list(classes[-need:])
    while len(levels) < need:  # more strata than canned classes: pad coarse
        levels.insert(0, classes[0])
    return Topology(coords, levels)


# ---------------------------------------------------------------------- #
# Source 3: timed device probes (point-to-point round trips)
# ---------------------------------------------------------------------- #

def device_probes(*, sizes: Sequence[float] = DEFAULT_PROBE_SIZES,
                  repeats: int = 3, roundtrips: int = 4, group=None,
                  device="cuda") -> ProbeSet:
    """Measure per-pair one-way time between the ranks of ``group`` (None:
    the default group) with point-to-point round trips; every rank of the
    group calls it, and every rank returns the same :class:`ProbeSet`.

    For every ordered pair (i, j) rank i bounces a float32 payload of
    about ``s`` bytes i→j→i ``roundtrips`` times (one ``batch_isend_irecv``
    a message) while the other ranks wait at a barrier; every rank walks
    the pairs in the same order.  One untimed bounce warms the pair; the
    best of ``repeats`` timed bounces (host clock around a
    ``torch.cuda.synchronize`` on the card) divided by ``2 * roundtrips``
    estimates the one-way time.  Under gloo a payload on the card is
    staged through host memory, as the tree collectives stage it
    (``tree_exec.Peers``), so the probes time the transport they pay.  Two
    payload sizes give the affine fit its two points; the (P, P, 2) times
    are gathered to every rank.  Cost is O(P²) bounces — this is the
    *once-per-fleet* measurement the persistence cache (:func:`discover`
    ``path=``) exists to amortise.  A pair that fails raises; nothing is
    made up.
    """
    import time

    import torch
    import torch.distributed as dist

    from ..kernels.backend import resolve_device
    from .tree_exec import Peers

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    P = dist.get_world_size(group)
    if P < 2:
        raise ValueError(f"device probes need >= 2 ranks, got {P}")
    peers = Peers(Topology(np.zeros((P, 0), np.int64),
                           [Level("probe", 1.0, 1.0)]), group)
    me = peers.index
    s1, s2 = float(sizes[0]), float(sizes[1])
    mine = np.zeros((P, 2))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for si, s in enumerate((s1, s2)):
        n = max(int(s) // 4, 1)  # float32 payload of ~s bytes
        x = torch.zeros(n, dtype=torch.float32, device=dev)
        for i in range(P):
            for j in range(P):
                if i == j:
                    continue
                if me in (i, j):
                    def bounce(i=i, j=j):
                        for _ in range(roundtrips):
                            if me == i:
                                peers.exchange(x, j, None, None)
                                peers.exchange(None, None, x, j)
                            else:
                                got = peers.exchange(None, None, x, i)
                                peers.exchange(got, i, None, None)
                        sync()

                    bounce()  # warm the pair
                    best = math.inf
                    for _ in range(repeats):
                        sync()
                        t0 = time.perf_counter()
                        bounce()
                        best = min(best, time.perf_counter() - t0)
                    if me == i:
                        mine[j, si] = best / (2 * roundtrips)
                dist.barrier(group=group)
    rows = [None] * P
    dist.all_gather_object(rows, mine, group=group)
    return ProbeSet(sizes=(s1, s2), times=np.stack(rows), inject=None)


# ---------------------------------------------------------------------- #
# The pipeline: cluster → cut → fit
# ---------------------------------------------------------------------- #

def _average_linkage(D: np.ndarray) -> list[tuple[int, int, float]]:
    """UPGMA agglomerative clustering on a symmetric dissimilarity matrix.

    Returns the merge sequence ``(i, j, height)`` — representatives are
    original point indices; heights are non-decreasing (average linkage is
    reducible, so the dendrogram has no inversions).  Lance-Williams row
    updates keep each of the P-1 merges at one vectorised argmin + O(P)
    update, comfortably fast at P = 512.
    """
    P = D.shape[0]
    Dm = D.astype(float).copy()
    np.fill_diagonal(Dm, np.inf)
    sizes = np.ones(P)
    merges: list[tuple[int, int, float]] = []
    for _ in range(P - 1):
        flat = np.argmin(Dm)
        i, j = divmod(int(flat), P)
        if i > j:
            i, j = j, i
        h = float(Dm[i, j])
        ni, nj = sizes[i], sizes[j]
        row = (ni * Dm[i] + nj * Dm[j]) / (ni + nj)
        Dm[i, :] = row
        Dm[:, i] = row
        Dm[i, i] = np.inf
        Dm[j, :] = np.inf
        Dm[:, j] = np.inf
        sizes[i] = ni + nj
        merges.append((i, j, h))
    return merges


def _labels_at(P: int, merges: Sequence[tuple[int, int, float]],
               threshold: float) -> np.ndarray:
    """Cluster labels after applying every merge with height < threshold."""
    parent = np.arange(P)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j, h in merges:
        if h < threshold:
            parent[find(j)] = find(i)
    return np.array([find(r) for r in range(P)])


def cluster_probes(probes: ProbeSet, *,
                   gap_factor: float = DEFAULT_GAP_FACTOR) -> np.ndarray:
    """Infer per-process stratum coordinates from a probe matrix.

    Agglomerative clustering orders all merges by cost; plateaus separated
    by gaps (consecutive merge heights with ratio > ``gap_factor``) are the
    link classes.  Each gap becomes one dendrogram cut = one stratum; cuts
    are applied coarsest first so column 0 of the result is the slowest
    stratum, matching :class:`Topology`'s convention.  Zero gaps (a
    homogeneous network) yield a (P, 0) coordinate array — a single link
    class, no strata.
    """
    P = probes.nprocs
    if P < 2:
        return np.zeros((P, 0), dtype=np.int64)
    merges = _average_linkage(probes.dissimilarity())
    heights = sorted(h for _, _, h in merges)
    cuts = []
    for a, b in zip(heights, heights[1:]):
        if b > gap_factor * max(a, 1e-15):
            cuts.append(math.sqrt(max(a, 1e-15) * b))
    if not cuts:
        return np.zeros((P, 0), dtype=np.int64)
    cols = [_labels_at(P, merges, c) for c in sorted(cuts, reverse=True)]
    return np.stack(cols, axis=1)


def fit_levels(probes: ProbeSet, coords: np.ndarray) -> list[Level]:
    """Least-squares :class:`Level` per link class given the strata.

    For class ``l`` the samples are every ordered pair at that level, both
    probe sizes; the affine fit ``t = a + s·b`` gives ``bandwidth = 1/b``
    and intercept ``a = latency + overhead``.  When the injection-rate
    probe is present, per-message occupancy minus the bandwidth term
    separates ``overhead`` out of the intercept — at zero noise the ground
    truth is recovered exactly.  A class with no pairs (e.g. singleton leaf
    groups) inherits its nearest coarser fitted class.
    """
    P = probes.nprocs
    nstrata = coords.shape[1]
    s1, s2 = probes.sizes
    lm = level_matrix(coords)
    off = ~np.eye(P, dtype=bool)

    levels: list[Level] = []
    for l in range(nstrata + 1):
        mask = (lm == l) & off
        if not mask.any():
            if not levels:
                raise ValueError("cannot fit any link class from "
                                 f"{P} process(es)")
            prev = levels[-1]
            levels.append(Level(f"d{l}", prev.latency, prev.bandwidth,
                                prev.overhead))
            continue
        t1 = float(probes.times[..., 0][mask].mean())
        t2 = float(probes.times[..., 1][mask].mean())
        slope = max((t2 - t1) / (s2 - s1), 1e-30)
        bandwidth = 1.0 / slope
        intercept = ((t1 - s1 * slope) + (t2 - s2 * slope)) / 2.0
        overhead = 0.0
        if probes.inject is not None:
            overhead = max(
                float(probes.inject[mask].mean()) - s1 * slope, 0.0)
        latency = max(intercept - overhead, 0.0)
        levels.append(Level(f"d{l}", latency, bandwidth, overhead))
    return levels


def fit_topology(probes: ProbeSet, *,
                 gap_factor: float = DEFAULT_GAP_FACTOR) -> Topology:
    """The full pipeline: probes → strata → fitted levels → Topology."""
    coords = cluster_probes(probes, gap_factor=gap_factor)
    return Topology(coords, fit_levels(probes, coords))


# ---------------------------------------------------------------------- #
# Targeted drift re-probing: O(strata · group-count) instead of O(P²).
#
# Full discovery measures every pair because it must *find* the strata.
# Once a topology is known, checking whether its link classes still match
# the network only needs a handful of representative pairs — one per
# adjacent sibling-group pair per stratum, one inside each leaf group.
# This is the cheap refresh Estefanel & Mounié's Fast-Tuning loop calls
# for: re-measure in O(strata · group-count), refit levels, re-select.
# ---------------------------------------------------------------------- #

def representative_pairs(topo: Topology,
                         members: Sequence[int] | None = None,
                         ) -> list[tuple[int, int, int]]:
    """Sample pairs ``(p, q, level)`` covering every link class of ``topo``.

    For stratum ``l`` the groups under each common parent path are chained
    in member order and one representative pair is emitted per adjacent
    group pair — enough to refit that class, without the quadratic
    all-pairs sweep.  The finest class gets one intra-leaf-group pair per
    (non-singleton) leaf group.  Total count is at most
    ``(nstrata + 1) · (number of leaf groups)``.
    """
    members = (list(range(topo.nprocs)) if members is None
               else list(members))
    pairs: list[tuple[int, int, int]] = []
    for l in range(topo.nstrata):
        by_parent: dict[tuple, dict[int, int]] = {}
        for m in members:
            path = tuple(topo.coords[m, :l])
            gid = int(topo.coords[m, l])
            by_parent.setdefault(path, {}).setdefault(gid, m)
        for reps in by_parent.values():
            chain = list(reps.values())
            pairs.extend((a, b, l) for a, b in zip(chain, chain[1:]))
    leaf: dict[tuple, list[int]] = {}
    for m in members:
        leaf.setdefault(tuple(topo.coords[m]), []).append(m)
    pairs.extend((g[0], g[1], topo.nstrata)
                 for g in leaf.values() if len(g) >= 2)
    return pairs


@dataclasses.dataclass(frozen=True)
class TargetedProbes:
    """Point-to-point measurements at selected pairs only.

    pairs  : ``(p, q, level)`` triples — ``level`` is the link class the
             *model* topology assigns the pair (what the refit groups by).
    sizes  : the two probe payloads, bytes, ascending.
    times  : (n, 2) one-way delivery seconds per pair and size.
    inject : optional (n,) sender occupancy at ``sizes[0]`` (separates
             overhead from latency, as in :class:`ProbeSet`).
    """

    pairs: tuple[tuple[int, int, int], ...]
    sizes: tuple[float, float]
    times: np.ndarray
    inject: np.ndarray | None = None

    def __post_init__(self):
        t = np.asarray(self.times, dtype=float)
        if t.shape != (len(self.pairs), 2):
            raise ValueError(
                f"times must be ({len(self.pairs)}, 2), got {t.shape}")
        if self.sizes[0] >= self.sizes[1]:
            raise ValueError("probe sizes must be ascending")
        object.__setattr__(self, "times", t)
        object.__setattr__(self, "pairs", tuple(map(tuple, self.pairs)))
        if self.inject is not None:
            inj = np.asarray(self.inject, dtype=float)
            if inj.shape != (len(self.pairs),):
                raise ValueError(
                    f"inject must be ({len(self.pairs)},), got {inj.shape}")
            object.__setattr__(self, "inject", inj)


def targeted_probes(truth: Topology,
                    pairs: Sequence[tuple[int, int, int]], *,
                    noise: float = 0.0, seed: int = 0,
                    sizes: Sequence[float] = DEFAULT_PROBE_SIZES,
                    ) -> TargetedProbes:
    """Sample the postal model of ``truth`` at ``pairs`` only.

    The simulation analogue of pinging just the representative pairs: each
    sample is ``overhead + latency + nbytes/bandwidth`` on the TRUE link
    class of (p, q), under multiplicative noise — the pair's *model* level
    tag rides along untouched so :func:`refit_levels` can group by it.
    """
    if not 0.0 <= noise < 1.0:
        raise ValueError(f"noise must be in [0, 1), got {noise}")
    s1, s2 = float(sizes[0]), float(sizes[1])
    rng = np.random.default_rng(seed)
    n = len(pairs)
    lvls = [truth.level_of_edge(p, q) for p, q, _ in pairs]
    lat = np.array([l.latency for l in lvls])
    bw = np.array([l.bandwidth for l in lvls])
    ovh = np.array([l.overhead for l in lvls])

    def jitter():
        return 1.0 + noise * rng.uniform(-1.0, 1.0, n) if noise else 1.0

    times = np.stack([(ovh + lat + s / bw) * jitter() for s in (s1, s2)],
                     axis=1)
    inject = (ovh + s1 / bw) * jitter()
    return TargetedProbes(tuple(pairs), (s1, s2), times, inject)


def synthetic_probes(topo: Topology,
                     fits: "dict[int, tuple[float, float, float]]", *,
                     sizes: Sequence[float] = DEFAULT_PROBE_SIZES,
                     ) -> TargetedProbes:
    """Render per-level postal fits back into a :class:`TargetedProbes`.

    ``fits`` maps link-class index -> ``(latency, bandwidth, overhead)``
    as estimated elsewhere (e.g. :func:`repro_torch.core.costmodel.link_affine_fit`
    over traced transfer durations).  Each fitted level gets one synthetic
    pair whose two probe times and injection sample are the postal model
    evaluated AT the fit, so feeding the result to :func:`refit_levels`
    reproduces the fitted parameters exactly.

    This keeps refitting single-pathed: measured feedback
    (the reference's ``obs/feedback.py``) does not mutate :class:`Level` objects
    itself — it speaks the same probe language as targeted re-probing, and
    :func:`refit_levels` stays the only writer of level parameters.
    Levels absent from ``fits`` get no pair and keep their parameters.
    """
    if not fits:
        raise ValueError("synthetic_probes needs at least one fitted level")
    bad = [l for l in fits if not 0 <= l < len(topo.levels)]
    if bad:
        raise ValueError(f"fitted level(s) {bad} not in topology "
                         f"(has {len(topo.levels)} classes)")
    s1, s2 = float(sizes[0]), float(sizes[1])
    pairs, t1, t2, inj = [], [], [], []
    for l in sorted(fits):
        lat, bw, ovh = fits[l]
        if bw <= 0:
            raise ValueError(f"level {l}: bandwidth must be positive")
        # the pair endpoints are carriers for the level tag (refit groups
        # by the tag alone); (0, 1) is as good as any real pair
        pairs.append((0, 1, l))
        t1.append(ovh + lat + s1 / bw)
        t2.append(ovh + lat + s2 / bw)
        inj.append(ovh + s1 / bw)
    return TargetedProbes(tuple(pairs), (s1, s2),
                          np.stack([t1, t2], axis=1), np.asarray(inj))


def refit_levels(topo: Topology, probes: TargetedProbes) -> Topology:
    """Refit ``topo``'s link classes from a targeted probe set.

    Coordinates (membership, grouping) are untouched — only the per-class
    postal parameters move, via the same two-point affine fit as
    :func:`fit_levels`.  A class with no sample pairs keeps its previous
    parameters.  Returns a new :class:`Topology`.
    """
    s1, s2 = probes.sizes
    levels = []
    for l, old in enumerate(topo.levels):
        idx = [i for i, (_, _, pl) in enumerate(probes.pairs) if pl == l]
        if not idx:
            levels.append(old)
            continue
        t1 = float(probes.times[idx, 0].mean())
        t2 = float(probes.times[idx, 1].mean())
        slope = max((t2 - t1) / (s2 - s1), 1e-30)
        intercept = ((t1 - s1 * slope) + (t2 - s2 * slope)) / 2.0
        overhead = old.overhead
        if probes.inject is not None:
            overhead = max(
                float(probes.inject[idx].mean()) - s1 * slope, 0.0)
        levels.append(Level(old.name, max(intercept - overhead, 0.0),
                            1.0 / slope, overhead))
    return Topology(topo.coords, levels)


def measure_drift(topo: Topology, probes: TargetedProbes) -> dict[int, float]:
    """Per link class: the measured / modeled one-way time ratio that
    deviates most from 1.0 across BOTH probe sizes — the small probe is
    latency-dominated and the large one bandwidth-dominated, so either
    parameter drifting alone is visible (latency drift on a fat link
    barely moves the large-probe ratio).  1.0 means the class still
    matches the model; the deviation is what
    :meth:`repro_torch.core.Communicator.refresh` thresholds."""
    out: dict[int, float] = {}
    for l, lvl in enumerate(topo.levels):
        idx = [i for i, (_, _, pl) in enumerate(probes.pairs) if pl == l]
        if not idx:
            continue
        ratios = [float(probes.times[idx, k].mean())
                  / (lvl.overhead + lvl.latency + s / lvl.bandwidth)
                  for k, s in enumerate(probes.sizes)]
        out[l] = max(ratios, key=lambda r: abs(r - 1.0))
    return out


# ---------------------------------------------------------------------- #
# Front door
# ---------------------------------------------------------------------- #

def discover(source: str = "sim", *, topo: Topology | None = None,
             noise: float = 0.0, seed: int = 0,
             sizes: Sequence[float] = DEFAULT_PROBE_SIZES,
             gap_factor: float = DEFAULT_GAP_FACTOR,
             devices: Sequence[RankInfo] | None = None,
             path: str | None = None, refresh: bool = False,
             **device_kw) -> Topology:
    """Discover a topology from one of the three probe sources.

    source : "sim" (requires ``topo=`` as hidden ground truth; ``noise``,
        ``seed`` control the probe sampling), "env" (the ranks'
        environment, or ``devices=``: one :class:`RankInfo` per rank), or
        "device" (timed point-to-point probes between the ranks; extra
        kwargs — ``group``, ``device``, ``repeats``, ``roundtrips`` — are
        forwarded to :func:`device_probes`).
    path : Fast-Tuning cache.  When the file exists (and ``refresh`` is
        false) it is loaded and NO probing happens; otherwise discovery
        runs once and persists its result there.
    """
    if path and not refresh and os.path.exists(path):
        return Topology.load(path)
    if source == "sim":
        if topo is None:
            raise ValueError("source='sim' needs topo= as ground truth")
        t = fit_topology(simulated_probes(topo, noise=noise, seed=seed,
                                          sizes=sizes),
                         gap_factor=gap_factor)
    elif source == "env":
        t = environment_topology(devices, group=device_kw.get("group"))
    elif source == "device":
        t = fit_topology(device_probes(sizes=sizes, **device_kw),
                         gap_factor=gap_factor)
    else:
        raise ValueError(f"unknown probe source {source!r}; "
                         "choose from 'sim', 'env', 'device'")
    if path:
        t.save(path)
    return t
