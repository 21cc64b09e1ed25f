"""Multilevel network topology description.

The paper (Karonis et al., 2002) replaces MPICH-G2's "hidden communicators"
with *integer coordinate vectors*: every process carries one group id per
network stratum (site, machine, ...).  The communication level between two
processes is the first stratum at which their coordinates diverge.  This
module is a copy of ``repro/core/topology.py`` less its TPU link classes
and ``tpu_v5e_multipod``: the port carries no rate modelled for a TPU, so a
topology of ranks on cards takes its ``Level``s from the caller
(``launch.mesh.grid_topology``) or from discovery.

Strata are ordered coarsest (slowest links) first.  A topology with ``S``
strata has ``S + 1`` link classes ("levels"):

  level 0      — used when coords differ in column 0        (e.g. WAN)
  level l      — coords agree on columns < l, differ at l   (e.g. LAN)
  level S      — all columns agree: intra-leaf-group links  (e.g. SMP bus)
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

__all__ = [
    "Level",
    "Topology",
    "level_matrix",
    "paper_fig8_topology",
    "magpie_machine_view",
    "magpie_site_view",
    "flat_view",
]


def level_matrix(coords: np.ndarray) -> np.ndarray:
    """(P, P) link-class index for every pair given (P, S) coordinates.

    ``[p, q]`` is the first stratum where p and q diverge, or ``S`` when
    all columns agree (including the diagonal).  This is THE pair-level
    rule — :meth:`Topology.comm_level_matrix` and the discovery fitter
    both defer to it so they can never disagree.
    """
    P, S = coords.shape
    if S == 0:
        return np.zeros((P, P), dtype=np.int64)
    mism = coords[:, None, :] != coords[None, :, :]
    return np.where(mism.any(axis=2), mism.argmax(axis=2), S).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Level:
    """Link class parameters under the postal model.

    latency    seconds from send start until first byte visible at receiver
    bandwidth  bytes / second on the link
    overhead   seconds the *sender* is occupied per message (postal ``o``)
    """

    name: str
    latency: float
    bandwidth: float
    overhead: float = 0.0

    def xfer(self, nbytes: float) -> float:
        """End-to-end time for one message of ``nbytes``."""
        return self.latency + nbytes / self.bandwidth

    def occupy(self, nbytes: float) -> float:
        """Time the sender is busy injecting one message of ``nbytes``."""
        return self.overhead + nbytes / self.bandwidth


class Topology:
    """A multilevel topology: per-process coordinate vectors + link classes.

    coords : (P, S) int array.  Column ``l`` is the group id of each process
        at stratum ``l`` (0 = coarsest).  Group ids only need to be unique
        *within* the parent group path, but we canonicalise them to be
        globally unique per column for simplicity.
    levels : S + 1 ``Level`` objects, coarsest first.
    """

    def __init__(self, coords: np.ndarray, levels: Sequence[Level]):
        coords = np.asarray(coords, dtype=np.int64)
        if coords.ndim == 1:
            coords = coords[:, None]
        if len(levels) != coords.shape[1] + 1:
            raise ValueError(
                f"need {coords.shape[1] + 1} levels for {coords.shape[1]} "
                f"strata, got {len(levels)}"
            )
        # Canonicalise: make each column's group ids encode the full path so
        # that equal ids in column l imply equal ids in all columns < l.
        canon = np.zeros_like(coords)
        for l in range(coords.shape[1]):
            path = coords[:, : l + 1]
            _, canon[:, l] = np.unique(path, axis=0, return_inverse=True)
        self.coords = canon
        self.levels = tuple(levels)
        self._level_matrix: np.ndarray | None = None
        self._level_table: list[list[int]] | None = None

    # ------------------------------------------------------------------ #
    @property
    def nprocs(self) -> int:
        return self.coords.shape[0]

    @property
    def nstrata(self) -> int:
        return self.coords.shape[1]

    def comm_level_matrix(self) -> np.ndarray:
        """(P, P) int array: link-class index for every pair, in one
        broadcast pass (a single argmax over coordinate mismatches).

        ``[p, q]`` is the first stratum where p and q diverge, or
        ``nstrata`` when all columns agree — which includes the diagonal
        (a rank trivially shares every coordinate with itself; the scalar
        :meth:`comm_level` still rejects self links).  Built lazily once
        and reused: plan construction touches O(P²) pairs, and growing a
        dict entry-by-entry dominated tree building on 512-chip fleets.
        """
        if self._level_matrix is None:
            lm = level_matrix(self.coords)
            lm.setflags(write=False)
            self._level_matrix = lm
        return self._level_matrix

    def comm_level_table(self) -> list[list[int]]:
        """:meth:`comm_level_matrix` as nested Python lists, cached.

        The tracer's per-send hot path indexes one entry per recorded
        send; plain list indexing is ~5x cheaper than numpy scalar
        indexing, which is the difference between tracing fitting its
        <5% overhead budget and not."""
        if self._level_table is None:
            self._level_table = self.comm_level_matrix().tolist()
        return self._level_table

    def comm_level(self, p: int, q: int) -> int:
        """Index of the link class used between processes p and q."""
        if p == q:
            raise ValueError("no self link")
        return int(self.comm_level_matrix()[p, q])

    def level_of_edge(self, p: int, q: int) -> Level:
        return self.levels[self.comm_level(p, q)]

    def groups_at(self, members: Sequence[int], stratum: int) -> dict[int, list[int]]:
        """Partition ``members`` by their group id at ``stratum``.

        Insertion order follows the order of ``members`` so tree builders are
        deterministic given the member ordering (paper §3.2: every process
        builds the identical tree with no communication).
        """
        out: dict[int, list[int]] = {}
        for m in members:
            out.setdefault(int(self.coords[m, stratum]), []).append(m)
        return out

    # ------------------------------------------------------------------ #
    # Persistence — the "Fast Tuning" cache (Estefanel & Mounié,
    # cs/0408034): discovery runs once per fleet, the fitted topology is
    # written to disk, and later runs reload it instead of re-measuring.
    # ------------------------------------------------------------------ #
    def to_json(self) -> str:
        """Canonical JSON form: coords (already canonicalised) + levels."""
        doc = {
            "format": "repro.topology/v1",
            "coords": self.coords.tolist(),
            "levels": [
                {"name": l.name, "latency": l.latency,
                 "bandwidth": l.bandwidth, "overhead": l.overhead}
                for l in self.levels
            ],
        }
        return json.dumps(doc, indent=1)

    @classmethod
    def from_json(cls, doc: "str | dict") -> "Topology":
        """Inverse of :meth:`to_json`; accepts the string or parsed dict."""
        if isinstance(doc, str):
            doc = json.loads(doc)
        fmt = doc.get("format", "repro.topology/v1")
        if fmt != "repro.topology/v1":
            raise ValueError(f"unknown topology format {fmt!r}")
        coords = np.asarray(doc["coords"], dtype=np.int64)
        if coords.ndim == 1:  # S == 0 round-trips as a list of empty rows
            coords = coords.reshape(len(doc["coords"]), 0)
        levels = [Level(l["name"], l["latency"], l["bandwidth"],
                        l.get("overhead", 0.0)) for l in doc["levels"]]
        return cls(coords, levels)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Topology":
        with open(path) as f:
            return cls.from_json(f.read())

    # ------------------------------------------------------------------ #
    def collapse(self, stratum: int) -> "Topology":
        """A 2-level view keeping only one stratum (MagPIe-style baseline)."""
        return Topology(
            self.coords[:, stratum : stratum + 1],
            [self.levels[stratum], self.levels[-1]],
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Topology(P={self.nprocs}, strata={self.nstrata}, "
            f"levels={[l.name for l in self.levels]})"
        )


# ---------------------------------------------------------------------- #
# Canned topologies
# ---------------------------------------------------------------------- #

# Link classes of the paper's era (order-of-magnitude figures: TCP over WAN,
# TCP over LAN, shared-memory/switch inside a machine).
WAN = Level("wan", latency=30e-3, bandwidth=1.25e6, overhead=50e-6)     # ~10 Mb/s, 30 ms
LAN = Level("lan", latency=1e-3, bandwidth=12.5e6, overhead=20e-6)      # ~100 Mb/s, 1 ms
SMP = Level("smp", latency=30e-6, bandwidth=100e6, overhead=5e-6)       # intra-machine


def paper_fig8_topology() -> Topology:
    """The paper's experiment: 16 procs on each of SDSC-SP, ANL-SP, ANL-O2K.

    Two sites (SDSC, ANL); ANL holds two machines.  Strata = [site, machine].
    """
    site = [0] * 16 + [1] * 32
    machine = [0] * 16 + [1] * 16 + [2] * 16
    coords = np.stack([site, machine], axis=1)
    return Topology(coords, [WAN, LAN, SMP])


def magpie_machine_view(topo: Topology) -> Topology:
    """MagPIe baseline A: 2-level clustering on *machine* boundaries."""
    return topo.collapse(topo.nstrata - 1)


def magpie_site_view(topo: Topology) -> Topology:
    """MagPIe baseline B: 2-level clustering on *site* boundaries."""
    return topo.collapse(0)


def flat_view(topo: Topology) -> Topology:
    """Topology-unaware view: every pair communicates at the SLOWEST class.

    This models MPICH's assumption of uniform point-to-point cost; the
    simulator still charges true per-edge costs — ``flat_view`` is used only
    to *build* the (oblivious) tree, mirroring how MPICH's binomial tree is
    laid out over ranks with no topology knowledge.
    """
    coords = np.zeros((topo.nprocs, 1), dtype=np.int64)
    return Topology(coords, [topo.levels[0], topo.levels[-1]])
