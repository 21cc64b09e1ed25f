"""Collective-operation schedules over an explicit tree.

Converts a ``Tree`` into a message schedule for each of the paper's five
collectives (Bcast, Reduce, Barrier, Gather, Scatter) plus the training-era
extensions (Allreduce, Allgather, ReduceScatter).  A schedule is a pure data
structure the simulator executes and property tests inspect.

In the plan pipeline (select → lower → execute) this is the WHOLE-MESSAGE
form: one ``Msg`` per tree edge per phase, simulated with per-rank phase
hand-off by :func:`repro_torch.core.simulator.simulate`.  Execution goes through
the segmented rounds IR instead (:mod:`repro_torch.core.rounds`), which splits
these payloads into pipelined per-level segments; the ``Schedule`` form
remains the analytical baseline the IR must converge to as segment size →
nbytes (see tests/test_rounds.py).
"""
from __future__ import annotations

import dataclasses
from enum import Enum

from .trees import Tree

__all__ = ["Direction", "Phase", "Schedule", "bcast", "reduce", "barrier",
           "gather", "scatter", "allreduce", "allgather"]


class Direction(Enum):
    DOWN = "down"  # root -> leaves (bcast, scatter)
    UP = "up"      # leaves -> root (reduce, gather)


@dataclasses.dataclass(frozen=True)
class Msg:
    src: int
    dst: int
    nbytes: float


@dataclasses.dataclass(frozen=True)
class Phase:
    """One tree traversal.  ``msgs[p]`` lists p's outgoing messages in send
    order.  DOWN: node sends after its inbound message arrives.  UP: node
    sends after all its children's messages arrive."""

    tree: Tree
    direction: Direction
    msgs: dict[int, list[Msg]]

    def all_msgs(self) -> list[Msg]:
        return [m for ms in self.msgs.values() for m in ms]


@dataclasses.dataclass(frozen=True)
class Schedule:
    name: str
    phases: tuple[Phase, ...]


# ---------------------------------------------------------------------- #

def _down_phase(tree: Tree, size_of) -> Phase:
    msgs = {
        p: [Msg(p, c, size_of(c)) for c in cs]
        for p, cs in tree.children.items()
    }
    return Phase(tree, Direction.DOWN, msgs)


def _up_phase(tree: Tree, size_of) -> Phase:
    pm = tree.parent_map()
    msgs: dict[int, list[Msg]] = {}
    for c, p in pm.items():
        msgs.setdefault(c, []).append(Msg(c, p, size_of(c)))
    return Phase(tree, Direction.UP, msgs)


def bcast(tree: Tree, nbytes: float) -> Schedule:
    return Schedule("bcast", (_down_phase(tree, lambda c: nbytes),))


def reduce(tree: Tree, nbytes: float) -> Schedule:
    return Schedule("reduce", (_up_phase(tree, lambda c: nbytes),))


def barrier(tree: Tree) -> Schedule:
    # Fan-in then fan-out of zero-byte tokens over the same tree.
    return Schedule(
        "barrier",
        (_up_phase(tree, lambda c: 0.0), _down_phase(tree, lambda c: 0.0)),
    )


def gather(tree: Tree, nbytes: float) -> Schedule:
    sizes = tree.subtree_sizes()
    return Schedule("gather", (_up_phase(tree, lambda c: sizes[c] * nbytes),))


def scatter(tree: Tree, nbytes: float) -> Schedule:
    sizes = tree.subtree_sizes()
    return Schedule("scatter", (_down_phase(tree, lambda c: sizes[c] * nbytes),))


def allreduce(tree: Tree, nbytes: float) -> Schedule:
    """Reduce-to-root then broadcast (the composition the paper's five ops
    support directly; per-level ring reduce-scatter is the JAX-side upgrade)."""
    return Schedule(
        "allreduce",
        (_up_phase(tree, lambda c: nbytes), _down_phase(tree, lambda c: nbytes)),
    )


def allgather(tree: Tree, nbytes: float) -> Schedule:
    sizes = tree.subtree_sizes()
    total = sizes[tree.root] * nbytes
    return Schedule(
        "allgather",
        (_up_phase(tree, lambda c: sizes[c] * nbytes),
         _down_phase(tree, lambda c: total)),
    )
