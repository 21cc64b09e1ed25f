"""The lowered *rounds IR*: segmented, pipelined collective plans.

``Plan.lower(nbytes)`` turns a selected plan (tree + algorithm + segment
policy) into a flat program of :class:`SegSend` events — the IR every backend
consumes:

* the **simulator** executes the sends under the postal model
  (:func:`repro_torch.core.simulator.simulate_rounds`): per-rank FIFO injection,
  per-send dependencies, so a node forwards segment *k* down the tree while
  segment *k+1* is still in flight toward it — no global barrier between the
  phases of a reduce→bcast allreduce;
* the **p2p backend** collapses segments and maps the send DAG to
  rounds of point-to-point sends, one ``batch_isend_irecv`` each
  (:meth:`Lowered.device_rounds`,
  :func:`repro_torch.core.tree_exec.run_lowered`);
* the **torch backend** recognises the ``rsag`` algorithm choice and lowers
  it to reduce-scatter / all-gather where the grid decomposition allows.

Three lowering families:

``lower_tree``
    Any registered collective over an explicit tree.  Uniform-payload phases
    (bcast / reduce / allreduce / barrier) are split into segments sized by
    the cost model's bandwidth-delay product; personalised ops (gather /
    scatter / allgather) are pipelined at *chunk* (per-rank payload)
    granularity.
``lower_sag_bcast``
    Bandwidth-optimal large-message broadcast: scatter chunks inside the
    root's leaf group, route each chunk plane along a tree over leaf groups
    (segmented — the WAN hop of one segment overlaps the LAN hop of the
    next), ring-allgather inside every leaf group.  "Ring at the leaf
    stratum, tree above."
``lower_rsag_allreduce``
    Bandwidth-optimal large-message allreduce: ring reduce-scatter inside
    each leaf group, fold chunk planes up the group tree, broadcast them back
    down, ring-allgather inside each leaf group.

:func:`interpret` is the IR's executable semantics — a symbolic interpreter
tracking which ranks' contributions each (rank, chunk, segment) cell holds.
Property tests use it to prove every lowering delivers every byte exactly
once per receiver and folds every contribution exactly once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .costmodel import MAX_SEGMENTS, MIN_CHUNK_BYTES, pipeline_segment_bytes
from .topology import Topology
from .trees import PAPER_POLICY, Tree, build_multilevel_tree

__all__ = [
    "SegSend",
    "Lowered",
    "lower",
    "lower_tree",
    "lower_sag_bcast",
    "lower_rsag_allreduce",
    "interpret",
    "check_semantics",
]


@dataclasses.dataclass(frozen=True)
class SegSend:
    """One point-to-point transfer of a segment of one payload chunk.

    ``seg`` is the segment index within the chunk, or ``None`` for a send
    carrying the whole chunk (all segments at once — ring steps).  ``deps``
    are indices of earlier sends in the program whose *delivery* must
    complete before this send can be injected (the forwarded data).  A
    rank's sends additionally execute in program order (FIFO NIC).
    ``first`` marks the start of a wire message: only it pays latency and
    sender overhead; later chunks of an aggregated message stream behind it.
    """

    src: int
    dst: int
    nbytes: float
    chunk: int
    seg: int | None
    kind: str  # "copy" | "reduce"
    first: bool
    deps: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Lowered:
    """A lowered plan: the rounds IR for one (op, algorithm, size).

    ``sends`` is topologically ordered (deps point backward) and its
    per-rank subsequences are each rank's injection program.  ``nchunks``
    payload chunks of ``chunk_bytes`` each; segmented chunks split into
    ``nsegs`` equal pieces.  For personalised ops (gather/scatter/allgather)
    chunk ids are member ranks; for bcast/allreduce they are 0..nchunks-1
    contiguous blocks of the flat payload (what device execution reshapes).
    """

    op: str
    algorithm: str
    root: int
    nbytes: float
    members: tuple[int, ...]
    nchunks: int
    chunk_bytes: float
    nsegs: int
    sends: tuple[SegSend, ...]

    def seg_bytes(self) -> float:
        return self.chunk_bytes / self.nsegs

    def device_rounds(self) -> list[list[tuple[int, int, int, str]]]:
        """Segment-collapsed rounds for device execution: each round is a
        list of (src, dst, chunk, kind) edges where every rank sends at most
        one chunk and receives at most one — exactly one ``lax.ppermute``.
        Dependencies and per-sender serialization order the rounds."""
        key_to_id: dict[tuple, int] = {}
        coll: list[tuple[int, int, int, str, set[int]]] = []
        send_coll: list[int] = []
        for s in self.sends:
            key = (s.src, s.dst, s.chunk, s.kind)
            if key not in key_to_id:
                key_to_id[key] = len(coll)
                coll.append((s.src, s.dst, s.chunk, s.kind, set()))
            cid = key_to_id[key]
            send_coll.append(cid)
            coll[cid][4].update(send_coll[d] for d in s.deps)
        rounds: list[tuple[list, set, set]] = []
        assigned: list[int] = []
        for cid, (src, dst, chunk, kind, deps) in enumerate(coll):
            deps.discard(cid)
            r = 1 + max((assigned[d] for d in deps), default=-1)
            while True:
                while r >= len(rounds):
                    rounds.append(([], set(), set()))
                edges, srcs, dsts = rounds[r]
                if src not in srcs and dst not in dsts:
                    break
                r += 1
            edges.append((src, dst, chunk, kind))
            srcs.add(src)
            dsts.add(dst)
            assigned.append(r)
        return [edges for edges, _, _ in rounds if edges]


# ---------------------------------------------------------------------- #
# Lowering entry point (what Plan.lower dispatches through).
# ---------------------------------------------------------------------- #

def lower(op: str, algorithm: str, tree: Tree, topo: Topology,
          nbytes: float, segment_bytes=None,
          members: Sequence[int] | None = None,
          root: int | None = None) -> Lowered:
    """Lower (op, algorithm) to the rounds IR.  ``segment_bytes``: ``None``
    for unsegmented, ``"bdp"`` for the cost model's bandwidth-delay choice,
    or an explicit byte count."""
    members = tuple(members if members is not None else tree.members())
    root = tree.root if root is None else root
    if algorithm == "tree":
        return lower_tree(op, tree, topo, nbytes, segment_bytes)
    if algorithm == "sag" and op == "bcast":
        return lower_sag_bcast(topo, root, members, nbytes, segment_bytes)
    if algorithm == "rsag" and op == "allreduce":
        return lower_rsag_allreduce(topo, members, nbytes, segment_bytes,
                                    root=root)
    raise ValueError(f"no lowering for op={op!r} algorithm={algorithm!r}")


def _resolve_nsegs(topo: Topology, levels_used, nbytes: float,
                   segment_bytes) -> int:
    if segment_bytes is None or nbytes <= 0:
        return 1
    if segment_bytes == "bdp":
        levels = [topo.levels[l] for l in sorted(levels_used)] or \
            list(topo.levels)
        seg = pipeline_segment_bytes(levels, nbytes)
    else:
        seg = max(float(segment_bytes), nbytes / MAX_SEGMENTS)
    return max(1, min(MAX_SEGMENTS, int(math.ceil(nbytes / seg))))


def _edge_levels(tree: Tree, topo: Topology) -> set[int]:
    return {topo.comm_level(p, c)
            for p, cs in tree.children.items() for c in cs}


# ---------------------------------------------------------------------- #
# Tree lowering: any registered op over an explicit tree.
# ---------------------------------------------------------------------- #

def lower_tree(op: str, tree: Tree, topo: Topology, nbytes: float,
               segment_bytes=None) -> Lowered:
    members = tuple(tree.members())
    sends: list[SegSend] = []

    def emit(*args, **kw) -> int:
        sends.append(SegSend(*args, **kw))
        return len(sends) - 1

    pm = tree.parent_map()
    uniform = op in ("bcast", "reduce", "allreduce", "barrier")
    nb = 0.0 if op == "barrier" else float(nbytes)
    if uniform:
        nsegs = _resolve_nsegs(topo, _edge_levels(tree, topo), nb,
                               segment_bytes)
        piece = nb / nsegs
        preorder = members  # Tree.members() is preorder
        post = _postorder(tree)
        up_idx: dict[tuple[int, int], int] = {}

        def up_phase(kind: str):
            for k in range(nsegs):
                for c in post:
                    if c == tree.root:
                        continue
                    deps = tuple(up_idx[(d, k)]
                                 for d in tree.children.get(c, []))
                    up_idx[(c, k)] = emit(c, pm[c], piece, 0, k,
                                          kind, True, deps)

        def down_phase(root_deps=None):
            inbound: dict[tuple[int, int], int] = {}
            for k in range(nsegs):
                for p in preorder:
                    for c in tree.children.get(p, []):
                        if p == tree.root:
                            deps = root_deps(k) if root_deps else ()
                        else:
                            deps = (inbound[(p, k)],)
                        inbound[(c, k)] = emit(p, c, piece, 0, k, "copy",
                                               True, deps)

        if op == "bcast":
            down_phase()
        elif op == "reduce":
            up_phase("reduce")
        else:  # allreduce, barrier: reduce to root, then bcast — the down
            # send of segment k waits only on the ROOT's fold of segment k.
            up_phase("reduce")
            root_cs = tree.children.get(tree.root, [])
            down_phase(lambda k: tuple(up_idx[(c, k)] for c in root_cs))
        return Lowered(op, "tree", tree.root, nb, members, 1, nb, nsegs,
                       tuple(sends))

    # Personalised ops: pipeline at chunk (= per-rank payload) granularity.
    sub = _subtree_orders(tree)
    if op == "gather":
        _chunk_up(tree, pm, sub, nb, emit)
    elif op == "scatter":
        _chunk_down(tree, sub, nb, emit)
    elif op == "allgather":
        up = _chunk_up(tree, pm, sub, nb, emit)
        _chunk_bcast_down(tree, sub, up, nb, emit)
    else:
        raise ValueError(f"no tree lowering for op {op!r}")
    return Lowered(op, "tree", tree.root, nb, members, len(members), nb, 1,
                   tuple(sends))


def _postorder_from(children: dict, root) -> list:
    """Iterative post-order over a children map (deep-chain safe)."""
    out: list = []
    stack: list[tuple] = [(root, False)]
    while stack:
        n, expanded = stack.pop()
        cs = children.get(n, [])
        if cs and not expanded:
            stack.append((n, True))
            stack.extend((c, False) for c in cs)
        else:
            out.append(n)
    return out


def _postorder(tree: Tree) -> list[int]:
    return _postorder_from(tree.children, tree.root)


def _subtree_orders(tree: Tree) -> dict[int, list[int]]:
    """For each node: its subtree's chunks in the order the node ships them
    (own chunk first, then each child's subtree in child order)."""
    orders: dict[int, list[int]] = {}
    for n in _postorder(tree):
        order = [n]
        for c in tree.children.get(n, []):
            order.extend(orders[c])
        orders[n] = order
    return orders


def _chunk_up(tree, pm, sub, nbytes, emit) -> dict[tuple[int, int], int]:
    """Gather flow: each node streams its subtree's chunks to its parent as
    they become available (its own immediately, descendants' on arrival)."""
    up: dict[tuple[int, int], int] = {}
    for c in _postorder(tree):
        if c == tree.root:
            continue
        p = pm[c]
        first = True
        for x in sub[c]:
            deps = () if x == c else (up[(c, x)],)
            up[(p, x)] = emit(c, p, nbytes, x, 0, "copy", first, deps)
            first = False
    return up


def _chunk_down(tree, sub, nbytes, emit) -> None:
    """Trimming scatter: each edge carries exactly the child's subtree
    chunks, forwarded as they arrive from above."""
    down: dict[tuple[int, int], int] = {}
    for p in tree.members():
        for c in tree.children.get(p, []):
            first = True
            for x in sub[c]:
                deps = () if p == tree.root else (down[(p, x)],)
                down[(c, x)] = emit(p, c, nbytes, x, 0, "copy", first, deps)
                first = False


def _chunk_bcast_down(tree, sub, up, nbytes, emit) -> None:
    """Allgather's down sweep: broadcast every chunk down the tree in the
    order the root receives them — chunk x starts down while x+1 is still
    being gathered up.  Edges into a subtree that already holds x (x's own
    up path) are trimmed, so each chunk crosses each stratum once."""
    sub_set = {n: set(order) for n, order in sub.items()}
    started: dict[tuple[int, int], bool] = {}
    down: dict[tuple[int, int], int] = {}
    for x in sub[tree.root]:
        for p in tree.members():
            for c in tree.children.get(p, []):
                if x in sub_set[c]:
                    continue  # c received x on its way up
                if p == x:
                    deps: tuple[int, ...] = ()
                elif x in sub_set[p]:
                    deps = (up[(p, x)],)  # p holds x from the up flow
                else:
                    deps = (down[(p, x)],)
                first = not started.get((p, c), False)
                started[(p, c)] = True
                down[(c, x)] = emit(p, c, nbytes, x, 0, "copy", first, deps)


# ---------------------------------------------------------------------- #
# Leaf-group machinery shared by the bandwidth-optimal algorithms.
# ---------------------------------------------------------------------- #

def _leaf_groups(topo: Topology, members: Sequence[int]) -> list[list[int]]:
    """Members partitioned into leaf groups (finest stratum), in member
    order — the stratum where rings run.  A stratum-less topology (e.g. a
    discovered homogeneous network) is one big leaf group."""
    if topo.nstrata == 0:
        return [list(members)]
    return list(topo.groups_at(list(members), topo.nstrata - 1).values())


def _group_tree(topo: Topology, groups: list[list[int]], root_gi: int,
                root_rep: int) -> tuple[list[tuple[int, int]], dict]:
    """A multilevel tree over one representative per leaf group; returns the
    group-index edges in preorder plus children-of-group map."""
    reps = [root_rep if gi == root_gi else g[0]
            for gi, g in enumerate(groups)]
    gi_of_rep = {r: gi for gi, r in enumerate(reps)}
    if len(reps) == 1:
        return [], {}
    rep_tree = build_multilevel_tree(topo, root_rep, reps, PAPER_POLICY)
    edges = [(gi_of_rep[p], gi_of_rep[c])
             for p in rep_tree.members()
             for c in rep_tree.children.get(p, [])]
    children: dict[int, list[int]] = {}
    for p, c in edges:
        children.setdefault(p, []).append(c)
    return edges, children


# ---------------------------------------------------------------------- #
# Scatter-allgather broadcast.
# ---------------------------------------------------------------------- #

def lower_sag_bcast(topo: Topology, root: int, members: Sequence[int],
                    nbytes: float, segment_bytes=None) -> Lowered:
    """Bandwidth-optimal broadcast: scatter nchunks over the root's leaf
    group, ship each chunk's *plane* along the group tree (one parallel
    slow-link transfer per chunk instead of the whole payload on one edge),
    ring-allgather inside every leaf group."""
    members = tuple(members)
    groups = _leaf_groups(topo, members)
    root_gi = next(gi for gi, g in enumerate(groups) if root in g)
    g0 = groups[root_gi]
    # chunk floor: tiny chunks cannot amortise per-message costs, so small
    # payloads use fewer chunks (down to 1 -> pure group-tree + rings)
    nchunks = max(1, min(len(g0), int(float(nbytes) // MIN_CHUNK_BYTES)))
    chunk = float(nbytes) / nchunks
    edges, _ = _group_tree(topo, groups, root_gi, root)
    lvls = {topo.comm_level(groups[p][0], groups[c][0]) for p, c in edges}
    lvls.add(topo.nstrata)
    nsegs = _resolve_nsegs(topo, lvls, chunk, segment_bytes)
    piece = chunk / nsegs

    sends: list[SegSend] = []

    def emit(*args) -> int:
        sends.append(SegSend(*args))
        return len(sends) - 1

    # Phase 1: scatter within the root's leaf group (flat: distinct data).
    scat: dict[tuple[int, int], int] = {}
    for k in range(nsegs):
        for j in range(nchunks):
            m = g0[j]
            if m != root:
                scat[(j, k)] = emit(root, m, piece, j, k, "copy", True, ())

    # Phase 2: chunk planes along the group tree, segment-pipelined.
    plane: dict[tuple[int, int, int], int] = {}
    for k in range(nsegs):
        for j in range(nchunks):
            for pg, cg in edges:
                src = groups[pg][j % len(groups[pg])]
                dst = groups[cg][j % len(groups[cg])]
                if pg == root_gi:
                    deps = () if src == root else (scat[(j, k)],)
                else:
                    deps = (plane[(pg, j, k)],)
                plane[(cg, j, k)] = emit(src, dst, piece, j, k, "copy",
                                         True, deps)

    # Phase 3: ring allgather inside every leaf group.
    def have(gi: int, j: int) -> tuple[int, ...]:
        if gi == root_gi:
            m = groups[gi][j % len(groups[gi])]
            return () if m == root else tuple(scat[(j, k)]
                                              for k in range(nsegs))
        return tuple(plane[(gi, j, k)] for k in range(nsegs))

    _ring_allgather(groups, nchunks, chunk, have, emit)
    return Lowered("bcast", "sag", root, float(nbytes), members, nchunks,
                   chunk, nsegs, tuple(sends))


def _ring_allgather(groups, nchunks, chunk_bytes, have, emit,
                    kind: str = "copy") -> None:
    """Circulate every chunk around each leaf group's ring; chunk j starts
    at its owner (position j mod group size) once ``have(gi, j)`` delivered
    it there.  Emitted step-major so rings across groups and chunks overlap."""
    prev: dict[tuple[int, int], tuple[int, ...]] = {}
    max_s = max(len(g) for g in groups)
    for t in range(max_s - 1):
        for gi, g in enumerate(groups):
            s = len(g)
            if t >= s - 1:
                continue
            for j in range(nchunks):
                o = j % s
                u, v = g[(o + t) % s], g[(o + t + 1) % s]
                deps = prev.get((gi, j)) if t else have(gi, j)
                prev[(gi, j)] = (emit(u, v, chunk_bytes, j, None, kind,
                                      True, deps or ()),)


# ---------------------------------------------------------------------- #
# Reduce-scatter + allgather allreduce.
# ---------------------------------------------------------------------- #

def lower_rsag_allreduce(topo: Topology, members: Sequence[int],
                         nbytes: float, segment_bytes=None,
                         root: int | None = None) -> Lowered:
    """Bandwidth-optimal allreduce: ring reduce-scatter inside each leaf
    group, fold the chunk planes up the group tree and broadcast them back
    down (segment-pipelined on the slow strata), ring-allgather inside each
    leaf group.  Requires uniform leaf-group sizes (chunk planes must align
    by position); raises ValueError otherwise so callers fall back to the
    tree algorithm."""
    members = tuple(members)
    groups = _leaf_groups(topo, members)
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError(
            f"rsag needs uniform leaf-group sizes, got {sorted(sizes)}")
    s = sizes.pop()
    nchunks = s
    chunk = float(nbytes) / nchunks
    root = members[0] if root is None else root
    root_gi = next(gi for gi, g in enumerate(groups) if root in g)
    edges, gkids = _group_tree(topo, groups, root_gi, groups[root_gi][0])
    lvls = {topo.comm_level(groups[p][0], groups[c][0]) for p, c in edges}
    lvls.add(topo.nstrata)
    nsegs = _resolve_nsegs(topo, lvls, chunk, segment_bytes)
    piece = chunk / nsegs

    sends: list[SegSend] = []

    def emit(*args) -> int:
        sends.append(SegSend(*args))
        return len(sends) - 1

    # Phase 1: ring reduce-scatter inside each leaf group.  Chunk j travels
    # g[j+1] -> g[j+2] -> ... -> g[j], folding at every stop.
    rs_final: dict[tuple[int, int], tuple[int, ...]] = {}
    prev: dict[tuple[int, int], tuple[int, ...]] = {}
    for t in range(s - 1):
        for gi, g in enumerate(groups):
            for j in range(nchunks):
                u = g[(j + 1 + t) % s]
                v = g[(j + 2 + t) % s]
                idx = emit(u, v, chunk, j, None, "reduce", True,
                           prev.get((gi, j), ()))
                prev[(gi, j)] = (idx,)
                rs_final[(gi, j)] = (idx,)

    post_g = _postorder_from(gkids, root_gi)
    gparent = {c: p for p, c in edges}

    # Phase 2: fold chunk planes up the group tree (segmented).
    up: dict[tuple[int, int, int], int] = {}
    for k in range(nsegs):
        for j in range(nchunks):
            for cg in post_g:
                if cg == root_gi:
                    continue
                pg = gparent[cg]
                deps = rs_final.get((cg, j), ()) + tuple(
                    up[(d, j, k)] for d in gkids.get(cg, []))
                up[(cg, j, k)] = emit(groups[cg][j], groups[pg][j], piece,
                                      j, k, "reduce", True, deps)

    # Phase 3: broadcast the folded planes back down.  The down send of
    # segment k leaves as soon as the plane root has folded segment k.
    down: dict[tuple[int, int, int], int] = {}
    for k in range(nsegs):
        for j in range(nchunks):
            for pg, cg in edges:
                if pg == root_gi:
                    deps = rs_final.get((root_gi, j), ()) + tuple(
                        up[(d, j, k)] for d in gkids.get(root_gi, []))
                else:
                    deps = (down[(pg, j, k)],)
                down[(cg, j, k)] = emit(groups[pg][j], groups[cg][j], piece,
                                        j, k, "copy", True, deps)

    # Phase 4: ring allgather inside each leaf group.
    def have(gi: int, j: int) -> tuple[int, ...]:
        if gi == root_gi:
            return rs_final.get((gi, j), ()) + tuple(
                up[(d, j, k)] for d in gkids.get(gi, [])
                for k in range(nsegs))
        return tuple(down[(gi, j, k)] for k in range(nsegs))

    _ring_allgather(groups, nchunks, chunk, have, emit)
    return Lowered("allreduce", "rsag", root, float(nbytes), members,
                   nchunks, chunk, nsegs, tuple(sends))


# ---------------------------------------------------------------------- #
# Executable semantics: the symbolic interpreter.
# ---------------------------------------------------------------------- #

_INIT_HOLDINGS = {
    # op -> which (rank, chunk) cells start populated, and with what.
    "bcast": "root_all",      # root holds every chunk (value {root})
    "scatter": "root_all",
    "reduce": "everyone_all",  # every rank holds every chunk as {rank}
    "allreduce": "everyone_all",
    "barrier": "everyone_all",
    "gather": "own",           # rank r holds chunk r as {r}
    "allgather": "own",
}


def interpret(lowered: Lowered) -> dict:
    """Execute the IR symbolically.  Each (rank, chunk, seg) cell holds a
    frozenset of member ranks whose contribution it contains.  Raises
    ValueError on: sending data the source does not hold, folding a
    contribution twice, or delivering a copy to the same cell twice.
    Returns the final state as {(rank, chunk): [set per seg]}."""
    members = lowered.members
    nsegs = lowered.nsegs
    state: dict[tuple[int, int], list] = {}
    mode = _INIT_HOLDINGS[lowered.op]
    if mode == "root_all":
        chunks = (range(lowered.nchunks) if lowered.op == "bcast"
                  else members)
        for x in chunks:
            state[(lowered.root, x)] = [frozenset([lowered.root])] * nsegs
    elif mode == "everyone_all":
        for r in members:
            for x in range(lowered.nchunks):
                state[(r, x)] = [frozenset([r])] * nsegs
    else:  # own
        for r in members:
            state[(r, r)] = [frozenset([r])] * nsegs

    copies: dict[tuple[int, int, int], int] = {}
    for i, snd in enumerate(lowered.sends):
        src_cell = state.get((snd.src, snd.chunk))
        segs = range(nsegs) if snd.seg is None else (snd.seg,)
        dst_cell = state.setdefault((snd.dst, snd.chunk), [None] * nsegs)
        for k in segs:
            if src_cell is None or src_cell[k] is None:
                raise ValueError(
                    f"send #{i} {snd}: source holds no data for "
                    f"chunk {snd.chunk} seg {k}")
            carried = src_cell[k]
            if snd.kind == "reduce":
                cur = dst_cell[k] or frozenset()
                if cur & carried:
                    raise ValueError(
                        f"send #{i} {snd}: contributions {sorted(cur & carried)} "
                        f"folded twice at rank {snd.dst}")
                dst_cell[k] = cur | carried
            else:
                n = copies.get((snd.dst, snd.chunk, k), 0) + 1
                if n > 1:
                    raise ValueError(
                        f"send #{i} {snd}: chunk {snd.chunk} seg {k} "
                        f"delivered to rank {snd.dst} more than once")
                copies[(snd.dst, snd.chunk, k)] = n
                dst_cell[k] = carried
    return state


def check_semantics(lowered: Lowered) -> None:
    """Assert the lowering computes its op: run :func:`interpret` and check
    the op's final-state contract.  Raises ValueError on any violation."""
    state = interpret(lowered)
    members = lowered.members
    full = frozenset(members)
    root = lowered.root

    def expect(rank, chunk, want, what):
        cell = state.get((rank, chunk))
        for k in range(lowered.nsegs):
            got = cell[k] if cell else None
            if got != want:
                raise ValueError(
                    f"{lowered.op}/{lowered.algorithm}: {what}: rank {rank} "
                    f"chunk {chunk} seg {k} holds {got}, want {want}")

    op = lowered.op
    if op == "bcast":
        for r in members:
            for x in range(lowered.nchunks):
                expect(r, x, frozenset([root]), "every rank gets the payload")
    elif op == "reduce":
        expect(root, 0, full, "root folds every contribution")
    elif op in ("allreduce", "barrier"):
        for r in members:
            for x in range(lowered.nchunks):
                expect(r, x, full, "every rank gets the full fold")
    elif op == "gather":
        for m in members:
            expect(root, m, frozenset([m]), "root gets every member's chunk")
    elif op == "scatter":
        for m in members:
            expect(m, m, frozenset([root]), "each member gets its chunk")
    elif op == "allgather":
        for r in members:
            for m in members:
                expect(r, m, frozenset([m]), "every rank gets every chunk")
    else:  # pragma: no cover - future ops must add a contract
        raise ValueError(f"no semantic contract for op {op!r}")

    if op in ("gather", "scatter"):
        # Routing minimality for the single-consumer personalised ops: the
        # final-state contract above inspects only the terminal cells, so a
        # *leaked* extra copy of chunk x to a bystander rank would pass it
        # (delivered-once is per receiver, not per chunk).  Statically,
        # chunk x's copy sends must form a simple relay path: every rank
        # that receives x and is not its terminal consumer (gather: the
        # root; scatter: rank x itself) forwards it exactly once, and the
        # terminal never forwards it.
        fwd: dict[tuple[int, int], int] = {}
        recv: dict[int, set[int]] = {}
        for snd in lowered.sends:
            if snd.kind != "copy":
                continue
            fwd[(snd.src, snd.chunk)] = fwd.get((snd.src, snd.chunk), 0) + 1
            recv.setdefault(snd.chunk, set()).add(snd.dst)
        for x, dsts in sorted(recv.items()):
            terminal = root if op == "gather" else x
            for r in sorted(dsts):
                want = 0 if r == terminal else 1
                got = fwd.get((r, x), 0)
                if got != want:
                    raise ValueError(
                        f"{lowered.op}/{lowered.algorithm}: chunk routing: "
                        f"rank {r} received chunk {x} and forwarded it "
                        f"{got}x, want {want} "
                        f"({'terminal consumer' if want == 0 else 'relay'})")
