"""The hazard analyzer: static wait-for analysis of an Engine's pending batch.

An :class:`~repro_torch.core.engine.Engine` batch is a little concurrent program:
explicit ``after=`` edges, the implicit same-member-set FIFO rule (the MPI
same-communicator ordering), and link sharing between any two programs whose
member sets overlap.  The engine's simulator *executes* that program — and a
malformed batch surfaces there as a cryptic late error ("programs ... never
completed") or, on a real backend, as a hang.  This module analyzes the
batch BEFORE execution and reports precisely what is wrong:

``deadlock-cycle``    the wait-for graph (explicit ``after=`` + implicit
                      same-member-set FIFO) contains a cycle: the batch can
                      never complete anywhere (error)
``cross-engine-dep``  a handle's ``after=`` chain reaches a handle owned by
                      a different engine — ``issue()`` rejects these up
                      front, so one can only appear via post-issue mutation;
                      the foreign engine's clock is meaningless here (error)
``dangling-dep``      an ``after=`` dep that is neither resolved nor in this
                      engine's pending set — it can never flush, so the
                      waiter waits forever (error)
``interleaving-race`` two pending programs whose member sets OVERLAP but are
                      UNEQUAL, with no ordering path between them: the fluid
                      simulator resolves the contention deterministically,
                      but a real backend interleaves their sends
                      nondeterministically on the shared ranks' NICs
                      (warning)
``starvation``        strict ``priority`` policy with ``age_rate == 0`` and
                      a sustained stream of higher-priority work overlapping
                      a fat transfer's links: the fat transfer has no aging
                      escape and starves for the stream's lifetime (warning)

:func:`check_hazards` raises :class:`HazardError` on errors and emits
:class:`HazardWarning` for warnings; the engine runs it from ``issue()`` /
``wait_all()`` when constructed with ``check=True`` (errors at issue time,
the full analysis at flush time), and the test-suite always runs it.

A copy of ``repro/analysis/hazards.py``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..core.engine import Engine

__all__ = ["Hazard", "HazardError", "HazardWarning",
           "analyze_engine", "check_hazards"]

# How many strictly-higher-priority overlapping handles constitute a
# "persistent stream" for the starvation heuristic.
_STARVE_STREAM = 3


@dataclasses.dataclass(frozen=True)
class Hazard:
    """One finding: ``kind`` (see module docstring), ``severity`` is
    ``"error"`` (cannot complete / meaningless schedule) or ``"warning"``
    (legal but nondeterministic or unfair), ``handles`` names the involved
    handle ids."""

    kind: str
    severity: str
    message: str
    handles: tuple[int, ...] = ()

    def __str__(self) -> str:
        hs = ",".join(f"#{h}" for h in self.handles)
        return f"[{self.kind}] ({self.severity}) {hs}: {self.message}"


class HazardError(RuntimeError):
    """The pending batch contains error-severity hazards (it would deadlock
    or reference a foreign/dangling handle).  ``hazards`` carries all of
    them."""

    def __init__(self, hazards):
        self.hazards = tuple(hazards)
        super().__init__(
            f"{len(self.hazards)} engine hazard(s): "
            + "; ".join(str(h) for h in self.hazards))


class HazardWarning(UserWarning):
    """Warning-severity hazard (nondeterministic interleaving, starvation
    risk) emitted by :func:`check_hazards`."""


def analyze_engine(engine: "Engine") -> list[Hazard]:
    """Analyze ``engine``'s pending handles; returns ALL hazards found.

    Pure read-only: nothing is flushed, no simulation runs.  Cost is
    O(pending² ) in the worst case (reachability for the race check), which
    is trivial at real batch sizes (tens of handles).
    """
    pending = list(engine._pending)
    out: list[Hazard] = []
    index = {h: i for i, h in enumerate(pending)}

    # --- wait-for edges: i waits on each of adj[i] ---------------------- #
    adj: list[list[int]] = [[] for _ in pending]
    for i, h in enumerate(pending):
        for d in h.after:
            if d.engine is not engine:
                out.append(Hazard(
                    "cross-engine-dep", "error",
                    f"handle #{h.hid} waits on #{d.hid} owned by a "
                    f"different engine — its clock and flush cycle are "
                    f"unrelated to this one", (h.hid, d.hid)))
            elif d.done:
                continue  # resolved: a release-time bound, not an edge
            elif d in index:
                adj[i].append(index[d])
            else:
                out.append(Hazard(
                    "dangling-dep", "error",
                    f"handle #{h.hid} waits on #{d.hid} which is neither "
                    f"resolved nor pending on this engine — it can never "
                    f"flush", (h.hid, d.hid)))
    # implicit same-member-set FIFO: each handle waits on its set's
    # predecessor (exactly what Engine._flush enforces via last_in_batch)
    last_of_set: dict[tuple[int, ...], int] = {}
    for i, h in enumerate(pending):
        prev = last_of_set.get(h.members)
        if prev is not None:
            adj[i].append(prev)
        last_of_set[h.members] = i

    cyc = _find_cycle(adj)
    if cyc is not None:
        hids = tuple(pending[i].hid for i in cyc)
        out.append(Hazard(
            "deadlock-cycle", "error",
            "wait-for cycle " + " -> ".join(f"#{h}" for h in hids)
            + " -> #" + str(hids[0]) + " over after= deps and same-member-"
            "set FIFO order — this batch can never complete",
            hids))
        return out  # reachability below is meaningless with a cycle

    # --- reachability (for the race check): ordered[i][j] = i,j ordered - #
    n = len(pending)
    reach = [set(a) for a in adj]
    for i in _topo_order(adj):
        for j in adj[i]:
            reach[i] |= reach[j]

    # --- interleaving races: overlapping unequal sets, no ordering ------ #
    for i in range(n):
        for j in range(i + 1, n):
            a, b = pending[i], pending[j]
            if a.members == b.members:
                continue  # implicit FIFO orders them
            if not set(a.members) & set(b.members):
                continue  # disjoint: no shared NIC, nothing to race on
            if j in reach[i] or i in reach[j]:
                continue  # explicitly ordered (possibly transitively)
            out.append(Hazard(
                "interleaving-race", "warning",
                f"#{a.hid} ({a.op}, {len(a.members)} ranks) and #{b.hid} "
                f"({b.op}, {len(b.members)} ranks) overlap on "
                f"{len(set(a.members) & set(b.members))} rank(s) with no "
                f"ordering edge — a real backend interleaves them "
                f"nondeterministically; add after= if order matters",
                (a.hid, b.hid)))

    # --- starvation: strict priority, no aging, persistent stream ------- #
    if engine.policy == "priority" and engine.age_rate == 0 and n > 1:
        prios = [h.priority if h.priority is not None else -h.nbytes
                 for h in pending]
        for i, h in enumerate(pending):
            ahead = [pending[j].hid for j in range(n)
                     if j != i and prios[j] > prios[i]
                     and set(pending[j].members) & set(h.members)]
            if len(ahead) >= _STARVE_STREAM:
                out.append(Hazard(
                    "starvation", "warning",
                    f"#{h.hid} ({h.op}, {h.nbytes:.0f}B, priority "
                    f"{prios[i]:.4g}) is outranked by {len(ahead)} "
                    f"overlapping higher-priority handles under strict "
                    f"priority with age_rate=0 — it has no aging escape; "
                    f"set age_rate > 0 to bound its wait",
                    (h.hid, *ahead[:4])))
    return out


def check_hazards(engine: "Engine", *, errors_only: bool = False) -> None:
    """Raise :class:`HazardError` if the pending batch has error-severity
    hazards; emit :class:`HazardWarning` for the rest unless
    ``errors_only`` (the cheap gate ``issue()`` uses — warnings about a
    half-built batch would be noise, the flush-time check sees the whole
    batch)."""
    hazards = analyze_engine(engine)
    errors = [h for h in hazards if h.severity == "error"]
    if errors:
        raise HazardError(errors)
    if not errors_only:
        for h in hazards:
            warnings.warn(str(h), HazardWarning, stacklevel=3)


# ---------------------------------------------------------------------- #
# Small graph helpers (duplicated from verify to keep the modules
# independently importable; both are ~20 lines).
# ---------------------------------------------------------------------- #

def _find_cycle(adj: list[list[int]]) -> list[int] | None:
    WHITE, GREY, BLACK = 0, 1, 2
    color = [WHITE] * len(adj)
    parent: dict[int, int] = {}
    for start in range(len(adj)):
        if color[start] != WHITE:
            continue
        stack = [(start, 0)]
        color[start] = GREY
        while stack:
            node, ptr = stack[-1]
            if ptr < len(adj[node]):
                stack[-1] = (node, ptr + 1)
                nxt = adj[node][ptr]
                if color[nxt] == GREY:
                    cycle = [nxt, node]
                    cur = node
                    while cur != nxt:
                        cur = parent[cur]
                        if cur != nxt:
                            cycle.append(cur)
                    cycle.reverse()
                    return cycle
                if color[nxt] == WHITE:
                    color[nxt] = GREY
                    parent[nxt] = node
                    stack.append((nxt, 0))
            else:
                color[node] = BLACK
                stack.pop()
    return None


def _topo_order(adj: list[list[int]]) -> list[int]:
    """Topological order of an ACYCLIC adjacency list such that every node
    appears after all nodes it points to (post-order DFS)."""
    seen = [False] * len(adj)
    order: list[int] = []
    for start in range(len(adj)):
        if seen[start]:
            continue
        stack = [(start, 0)]
        seen[start] = True
        while stack:
            node, ptr = stack[-1]
            if ptr < len(adj[node]):
                stack[-1] = (node, ptr + 1)
                nxt = adj[node][ptr]
                if not seen[nxt]:
                    seen[nxt] = True
                    stack.append((nxt, 0))
            else:
                order.append(node)
                stack.pop()
    return order
