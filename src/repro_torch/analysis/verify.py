"""The plan verifier: machine-check any :class:`~repro_torch.core.rounds.Lowered`
program before (or after) it touches the network.

The paper's trees are constructed *automatically at runtime*, and since the
elastic PRs this repo goes further: ``repair_tree`` splices cached plans in
place, ``refresh`` refits their costs, and the engine composes them into
concurrent programs.  ``rounds.check_semantics`` proves the op's final-state
contract for a lowering the tests happen to run — this module promotes that
interpreter into a full static checker that any plan, including a mutated or
composed one, must pass:

``no-self-send``      a rank never sends to itself
``segment-range``     seg/chunk ids and byte counts are in range
``member-closure``    no send touches a rank outside ``lowered.members``
``injection-order``   data deps point strictly backward — the contract the
                      linear-pass executor's single sweep relies on
``dependency-cycle``  the wait-for graph (data deps + per-rank FIFO NIC
                      order) is acyclic — a cycle is a guaranteed hang
``byte-conservation`` every send carries exactly its segment's bytes and
                      every receiver's wire bytes equal the distinct payload
                      cells it is owed (sum of seg bytes == nbytes)
``semantics``         exactly-once delivery, fold-once, and the op's
                      final-holdings contract (:func:`rounds.check_semantics`,
                      which also checks the personalised chunk-routing paths)

Each pass returns :class:`Finding`\\ s instead of raising, so callers can
collect everything wrong with a program in one sweep; :func:`check_lowered`
raises :class:`VerificationError` carrying the full list.  :func:`quick_check`
is the cheap structural subset (no symbolic interpretation) behind the
simulator's ``sanitize=True`` runtime mode.

:meth:`Communicator.verify_plans <repro_torch.core.Communicator.verify_plans>`
runs :func:`check_lowered` over every cached plan and is invoked
automatically after ``repair()`` / ``refresh()`` — every in-place splice is
re-proven before it can serve traffic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from ..core import rounds as R

__all__ = [
    "Finding",
    "VerificationError",
    "verify_lowered",
    "check_lowered",
    "quick_check",
    "structural_findings",
    "member_findings",
    "dag_findings",
    "conservation_findings",
    "semantic_findings",
]

_REL_TOL = 1e-9


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verifier violation: which ``rule`` fired, ``where`` in the
    program (send index / rank / cell), and a human-readable message."""

    rule: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.where}: {self.message}"


class VerificationError(ValueError):
    """A lowered program failed verification.  ``findings`` carries every
    violation the passes collected (not just the first)."""

    def __init__(self, findings: Iterable[Finding], context: str = ""):
        self.findings = tuple(findings)
        self.context = context
        head = f"{context}: " if context else ""
        body = "; ".join(str(f) for f in self.findings[:8])
        more = (f" (+{len(self.findings) - 8} more)"
                if len(self.findings) > 8 else "")
        super().__init__(
            f"{head}{len(self.findings)} verification finding(s): "
            f"{body}{more}")


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=_REL_TOL, abs_tol=1e-12)


# ---------------------------------------------------------------------- #
# Pass 1: per-send structure.
# ---------------------------------------------------------------------- #

def structural_findings(low: R.Lowered) -> list[Finding]:
    """Per-send invariants: no self-sends, legal kinds, seg ids in range,
    non-negative byte counts that match the segment contract (a seg=k send
    carries ``chunk_bytes / nsegs``, a seg=None send the whole chunk)."""
    out: list[Finding] = []
    piece = low.chunk_bytes / low.nsegs
    for i, snd in enumerate(low.sends):
        where = f"send #{i} {snd.src}->{snd.dst}"
        if snd.src == snd.dst:
            out.append(Finding("no-self-send", where,
                               "a rank must not send to itself"))
        if snd.kind not in ("copy", "reduce"):
            out.append(Finding("segment-range", where,
                               f"unknown send kind {snd.kind!r}"))
        if snd.seg is not None and not 0 <= snd.seg < low.nsegs:
            out.append(Finding(
                "segment-range", where,
                f"seg {snd.seg} outside [0, {low.nsegs})"))
        if snd.nbytes < 0:
            out.append(Finding("byte-conservation", where,
                               f"negative byte count {snd.nbytes}"))
        elif low.chunk_bytes > 0:
            want = low.chunk_bytes if snd.seg is None else piece
            if not _close(snd.nbytes, want):
                out.append(Finding(
                    "byte-conservation", where,
                    f"carries {snd.nbytes:.6g} B, segment contract says "
                    f"{want:.6g} B (chunk {low.chunk_bytes:.6g} / "
                    f"{'whole' if snd.seg is None else low.nsegs})"))
    return out


# ---------------------------------------------------------------------- #
# Pass 2: member closure.
# ---------------------------------------------------------------------- #

def member_findings(low: R.Lowered) -> list[Finding]:
    """No send may touch a rank outside ``lowered.members`` (the defect a
    splice-to-dead-rank bug injects), the root must be a member, and chunk
    ids must be legal — member ranks for personalised ops, ``[0, nchunks)``
    contiguous blocks otherwise."""
    members = set(low.members)
    personalised = low.op in ("gather", "scatter", "allgather")
    out: list[Finding] = []
    if low.root not in members:
        out.append(Finding("member-closure", f"root {low.root}",
                           "root is not a member of the program"))
    for i, snd in enumerate(low.sends):
        where = f"send #{i} {snd.src}->{snd.dst}"
        for role, r in (("src", snd.src), ("dst", snd.dst)):
            if r not in members:
                out.append(Finding(
                    "member-closure", where,
                    f"{role} rank {r} is not a member "
                    f"(|members|={len(members)})"))
        if personalised:
            if snd.chunk not in members:
                out.append(Finding(
                    "member-closure", where,
                    f"chunk {snd.chunk} is not a member rank "
                    f"(personalised op {low.op})"))
        elif not 0 <= snd.chunk < low.nchunks:
            out.append(Finding(
                "segment-range", where,
                f"chunk {snd.chunk} outside [0, {low.nchunks})"))
    return out


# ---------------------------------------------------------------------- #
# Pass 3: dependency DAG + per-rank FIFO injection feasibility.
# ---------------------------------------------------------------------- #

def dag_findings(low: R.Lowered) -> list[Finding]:
    """Two related guarantees:

    * ``injection-order`` — every data dep points strictly backward in the
      program.  The linear-pass executor resolves ``delivered[d]`` in one
      sweep, so a forward dep is unexecutable there even when the general
      graph is acyclic.
    * ``dependency-cycle`` — the full wait-for graph (data deps plus the
      implicit per-rank FIFO NIC edges between a rank's consecutive sends)
      is acyclic.  A cycle deadlocks *any* executor.
    """
    n = len(low.sends)
    out: list[Finding] = []
    for i, snd in enumerate(low.sends):
        for d in snd.deps:
            if not 0 <= d < n:
                out.append(Finding(
                    "dependency-cycle", f"send #{i}",
                    f"dep index {d} outside the program [0, {n})"))
            elif d >= i:
                out.append(Finding(
                    "injection-order", f"send #{i}",
                    f"depends on send #{d} which is emitted later — the "
                    f"linear injection pass cannot execute this"))
    # wait-for graph: i -> its data deps, plus i -> rank's previous send
    waits: list[list[int]] = []
    last_of_src: dict[int, int] = {}
    for i, snd in enumerate(low.sends):
        ws = [d for d in snd.deps if 0 <= d < n]
        prev = last_of_src.get(snd.src)
        if prev is not None:
            ws.append(prev)
        last_of_src[snd.src] = i
        waits.append(ws)
    cyc = _find_cycle(waits)
    if cyc is not None:
        out.append(Finding(
            "dependency-cycle",
            " -> ".join(f"#{k}" for k in cyc),
            "wait-for cycle over data deps + per-rank FIFO order — this "
            "program can never complete"))
    return out


def _find_cycle(adj: list[list[int]]) -> list[int] | None:
    """Iterative DFS cycle detection; returns one cycle's node list."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = [WHITE] * len(adj)
    parent: dict[int, int] = {}
    for start in range(len(adj)):
        if color[start] != WHITE:
            continue
        stack: list[tuple[int, int]] = [(start, 0)]
        color[start] = GREY
        while stack:
            node, ptr = stack[-1]
            if ptr < len(adj[node]):
                stack[-1] = (node, ptr + 1)
                nxt = adj[node][ptr]
                if color[nxt] == GREY:  # back edge: walk the cycle out
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


# ---------------------------------------------------------------------- #
# Pass 4: byte conservation per receiver.
# ---------------------------------------------------------------------- #

def conservation_findings(low: R.Lowered) -> list[Finding]:
    """Every (receiver, chunk, seg) payload cell that copy-sends target must
    accumulate EXACTLY its piece of the payload — ``sum(seg bytes) ==
    chunk_bytes`` per delivered chunk, so a half-sized or double-counted
    wire message cannot hide behind a symbolically correct delivery (the
    interpreter tracks *which* contributions move, not how many bytes)."""
    if low.chunk_bytes <= 0:
        return []  # barrier-class programs ship no payload
    piece = low.chunk_bytes / low.nsegs
    got: dict[tuple[int, int, int], float] = {}
    for snd in low.sends:
        if snd.kind != "copy":
            continue
        segs = range(low.nsegs) if snd.seg is None else (snd.seg,)
        per_seg = (snd.nbytes / low.nsegs if snd.seg is None
                   else snd.nbytes)
        for k in segs:
            if snd.seg is not None and not 0 <= k < low.nsegs:
                continue  # structural pass already reported the range
            cell = (snd.dst, snd.chunk, k)
            got[cell] = got.get(cell, 0.0) + per_seg
    out: list[Finding] = []
    for (dst, chunk, k), nb in sorted(got.items()):
        if not _close(nb, piece):
            out.append(Finding(
                "byte-conservation",
                f"rank {dst} chunk {chunk} seg {k}",
                f"received {nb:.6g} B of a {piece:.6g} B segment "
                f"({'under' if nb < piece else 'over'}-delivered)"))
    return out


# ---------------------------------------------------------------------- #
# Pass 5: executable semantics.
# ---------------------------------------------------------------------- #

def semantic_findings(low: R.Lowered) -> list[Finding]:
    """Run the symbolic interpreter and the op's final-state contract
    (exactly-once delivery, fold-once, full holdings, personalised
    chunk-routing paths).  The interpreter raises on the FIRST violation,
    so one finding at most — but it is the deepest pass and catches what
    the structural ones cannot (a dropped send shows up only here)."""
    try:
        R.check_semantics(low)
    except (ValueError, KeyError) as e:
        return [Finding("semantics", f"{low.op}/{low.algorithm}", str(e))]
    return []


# ---------------------------------------------------------------------- #
# Entry points.
# ---------------------------------------------------------------------- #

def verify_lowered(low: R.Lowered) -> list[Finding]:
    """Run every pass over one lowered program; returns ALL findings.

    The structural passes always run; the symbolic pass is skipped when
    structure is already broken badly enough that interpretation would
    throw spurious errors (out-of-range deps / unknown kinds)."""
    out = structural_findings(low)
    out += member_findings(low)
    out += dag_findings(low)
    out += conservation_findings(low)
    blocking = {"dependency-cycle", "injection-order", "segment-range"}
    if not any(f.rule in blocking for f in out):
        out += semantic_findings(low)
    return out


def check_lowered(low: R.Lowered, context: str = "") -> None:
    """Raise :class:`VerificationError` (with all findings) unless ``low``
    verifies clean."""
    findings = verify_lowered(low)
    if findings:
        ctx = context or f"{low.op}/{low.algorithm} over " \
                         f"{len(low.members)} ranks"
        raise VerificationError(findings, ctx)


def quick_check(low: R.Lowered, context: str = "") -> None:
    """The cheap structural subset (no symbolic interpretation): per-send
    structure, member closure, dependency order.  This is the simulator's
    ``sanitize=True`` runtime gate — O(sends) with a small constant, and
    memoised per program object by the caller."""
    findings = structural_findings(low)
    findings += member_findings(low)
    findings += dag_findings(low)
    if findings:
        ctx = context or f"{low.op}/{low.algorithm} over " \
                         f"{len(low.members)} ranks"
        raise VerificationError(findings, ctx)
