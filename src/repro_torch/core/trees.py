"""Tree builders: flat, binomial, chain, postal-optimal — and the paper's
MULTILEVEL composer.

A tree is represented explicitly (paper §3.2 replaced hidden communicators
with integer vectors precisely to gain this freedom): ``Tree`` maps each rank
to an *ordered* list of children.  Children order matters under the postal
model — a parent injects messages sequentially, so larger subtrees are served
first.

This module is the tree-construction ENGINE; user code should go through
:class:`repro_torch.core.communicator.Communicator`, which selects, caches,
and executes trees behind one API.  A copy of ``repro/core/trees.py`` less
its deprecated ``best_tree`` shim (``select_tree`` replaces it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from .topology import Topology

__all__ = [
    "Tree",
    "flat_tree",
    "binomial_tree",
    "chain_tree",
    "postal_tree",
    "build_multilevel_tree",
    "repair_tree",
    "LevelPolicy",
    "PAPER_POLICY",
]


@dataclasses.dataclass
class Tree:
    root: int
    children: dict[int, list[int]]  # rank -> ordered children

    # ------------------------------------------------------------------ #
    def members(self) -> list[int]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(reversed(self.children.get(n, [])))
        return out

    def parent_map(self) -> dict[int, int]:
        return {c: p for p, cs in self.children.items() for c in cs}

    def subtree_sizes(self) -> dict[int, int]:
        # Iterative post-order: chains of 10k+ ranks must not hit the
        # Python recursion limit.
        sizes: dict[int, int] = {}
        stack: list[tuple[int, bool]] = [(self.root, False)]
        while stack:
            n, expanded = stack.pop()
            cs = self.children.get(n, [])
            if cs and not expanded:
                stack.append((n, True))
                stack.extend((c, False) for c in cs)
            else:
                sizes[n] = 1 + sum(sizes[c] for c in cs)
        return sizes

    def depth(self) -> int:
        best = 0
        stack: list[tuple[int, int]] = [(self.root, 0)]
        while stack:
            n, d = stack.pop()
            best = max(best, d)
            stack.extend((c, d + 1) for c in self.children.get(n, []))
        return best

    def validate(self) -> None:
        """Spanning-tree invariants; raises ValueError on violation (real
        exceptions, not `assert` — they must survive ``python -O``).

        Traverses with a seen-set rather than ``members()`` so that cyclic
        children maps are reported as errors instead of looping forever.
        """
        seen: set[int] = set()
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n in seen:
                raise ValueError(
                    f"invalid tree: rank {n} reachable twice from root "
                    f"{self.root} (duplicate child or cycle)")
            seen.add(n)
            stack.extend(self.children.get(n, []))
        pm = self.parent_map()
        if self.root in pm:
            raise ValueError(f"invalid tree: root {self.root} has a parent")
        if set(pm) | {self.root} != seen:
            raise ValueError("invalid tree: parent map does not cover "
                             "exactly the reachable ranks")


# ---------------------------------------------------------------------- #
# Single-level builders.  All take (root, members) where members includes
# the root, and are deterministic in the order of `members`.
# ---------------------------------------------------------------------- #

def _rotate(root: int, members: Sequence[int]) -> list[int]:
    """members with root first, preserving relative order of the rest."""
    rest = [m for m in members if m != root]
    if len(rest) == len(members):
        raise ValueError("root not in members")
    return [root] + rest


def flat_tree(root: int, members: Sequence[int]) -> Tree:
    """Root sends directly to everyone — optimal on high-latency links
    (Bar-Noy & Kipnis), used by the paper at the wide-area level."""
    order = _rotate(root, members)
    return Tree(root, {root: order[1:]})


def binomial_tree(root: int, members: Sequence[int]) -> Tree:
    """Classic binomial tree B_k over n ranks; the i-th child of the root is
    the root of B_{k-i} (largest subtree served first)."""
    order = _rotate(root, members)
    n = len(order)
    children: dict[int, list[int]] = {m: [] for m in order}
    # In round r, node i (< 2^r) sends to i + 2^r.  Natural round order IS
    # largest-subtree-first: a child acquired earlier has more remaining
    # rounds to fan out (paper's B_k: the i-th child roots B_{k-i}).
    r = 0
    while (1 << r) < n:
        for i in range(min(1 << r, n - (1 << r))):
            children[order[i]].append(order[i + (1 << r)])
        r += 1
    return Tree(root, {m: cs for m, cs in children.items() if cs})


def chain_tree(root: int, members: Sequence[int]) -> Tree:
    """Pipeline chain — optimal for very large segmented messages."""
    order = _rotate(root, members)
    return Tree(root, {order[i]: [order[i + 1]] for i in range(len(order) - 1)})


def postal_tree(root: int, members: Sequence[int], lam: int = 2) -> Tree:
    """Bar-Noy & Kipnis postal-model optimal tree for integer latency ``lam``
    (in units of sender overhead).  lam=1 degenerates to the binomial tree;
    large lam approaches the flat tree.

    N(t) = N(t-1) + N(t-lam): a node that finishes receiving at time T can
    start new sends at T, T+1, ...; each lands lam later.
    """
    lam = max(1, int(lam))
    order = _rotate(root, members)
    n = len(order)
    if n == 1:
        return Tree(root, {})
    # Find minimal completion time t with N(t) >= n.
    N = [1]
    while N[-1] < n:
        t = len(N)
        N.append(N[t - 1] + (N[t - lam] if t - lam >= 0 else 1))

    children: dict[int, list[int]] = {m: [] for m in order}
    next_free = 1  # next unassigned index in `order`

    def grow(node_idx: int, recv_time: int, deadline: int) -> None:
        nonlocal next_free
        t = recv_time
        while t + lam <= deadline and next_free < n:
            child = next_free
            next_free += 1
            children[order[node_idx]].append(order[child])
            grow(child, t + lam, deadline)
            t += 1

    grow(0, 0, len(N) - 1)
    # Any stragglers (rounding) hang off the root, flat.
    while next_free < n:
        children[order[0]].append(order[next_free])
        next_free += 1
    return Tree(root, {m: cs for m, cs in children.items() if cs})


BUILDERS: dict[str, Callable[[int, Sequence[int]], Tree]] = {
    "flat": flat_tree,
    "binomial": binomial_tree,
    "chain": chain_tree,
    "postal": postal_tree,
}


# ---------------------------------------------------------------------- #
# The paper's multilevel composer (§2.3, §3.2).
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class LevelPolicy:
    """Tree shape per level: shapes[l] for the inter-group tree at stratum l,
    shapes[-1] for the leaf level.  Paper's choice: flat at the wide-area
    level, binomial below (§3.2).  Shapes may carry a postal parameter, e.g.
    "postal:3"."""

    shapes: tuple[str, ...]

    def builder(self, level: int) -> Callable[[int, Sequence[int]], Tree]:
        shape = self.shapes[min(level, len(self.shapes) - 1)]
        if shape.startswith("postal:"):
            lam = int(shape.split(":")[1])
            return lambda r, m: postal_tree(r, m, lam=lam)
        return BUILDERS[shape]


PAPER_POLICY = LevelPolicy(("flat", "binomial", "binomial"))
ALL_BINOMIAL = LevelPolicy(("binomial",))


def adaptive_policy(topo, nbytes: float) -> LevelPolicy:
    """Beyond-paper (the paper's §6 future work): pick each level's tree
    shape from the Bar-Noy & Kipnis latency ratio of that level's links.

    lambda_l = (full message time) / (sender occupancy) — when a sender can
    inject many messages before the first lands, flat trees win (pipelined
    latency); when injection is as expensive as delivery (bandwidth-bound or
    intra-machine), binomial wins; in between, the postal tree with
    parameter round(lambda) is optimal.
    """
    shapes = []
    for lvl in topo.levels:
        xfer = lvl.latency + nbytes / lvl.bandwidth
        occupy = max(lvl.occupy(nbytes), 1e-12)
        lam = xfer / occupy
        if lam <= 1.5:
            shapes.append("binomial")
        elif lam >= 64:
            shapes.append("flat")
        else:
            shapes.append(f"postal:{max(2, int(round(lam)))}")
    return LevelPolicy(tuple(shapes))


def build_multilevel_tree(
    topo: Topology,
    root: int,
    members: Sequence[int] | None = None,
    policy: LevelPolicy = PAPER_POLICY,
) -> Tree:
    """Construct the multilevel topology-aware tree, deterministically.

    Mirrors MPICH-G2: cluster at the coarsest stratum, pick one coordinator
    per group (the root's group keeps the root; other groups use their first
    member in rank order), build the inter-group tree over coordinators with
    the level's shape, then recurse within each group.  At a node, slow-level
    children are served before fast-level children (root sends across the WAN
    first — Fig. 4).
    """
    if members is None:
        members = list(range(topo.nprocs))
    members = list(members)
    if root not in members:
        raise ValueError("root must be a member")

    def rec(root: int, members: list[int], stratum: int) -> Tree:
        if len(members) == 1:
            return Tree(root, {})
        if stratum == topo.nstrata:
            return policy.builder(stratum)(root, members)
        groups = topo.groups_at(members, stratum)
        if len(groups) == 1:
            return rec(root, members, stratum + 1)
        coordinators = []
        root_gid = int(topo.coords[root, stratum])
        for gid, gmembers in groups.items():
            coordinators.append(root if gid == root_gid else gmembers[0])
        inter = policy.builder(stratum)(root, coordinators)
        # Recurse inside every group and graft under its coordinator.
        children: dict[int, list[int]] = {}
        for gid, gmembers in groups.items():
            coord = root if gid == root_gid else gmembers[0]
            sub = rec(coord, gmembers, stratum + 1)
            for p, cs in sub.children.items():
                children.setdefault(p, []).extend(cs)
        # Prepend inter-group (slow) children so they are served first.
        for p, cs in inter.children.items():
            children[p] = cs + children.get(p, [])
        return Tree(root, children)

    tree = rec(root, members, 0)
    tree.validate()
    return tree


# ---------------------------------------------------------------------- #
# Elastic repair: splice failed ranks out of an existing tree.
# ---------------------------------------------------------------------- #

def repair_tree(tree: Tree, topo: Topology, failed, nbytes: float = 0.0) -> Tree:
    """Remove ``failed`` ranks from ``tree`` without rebuilding it.

    Dead nodes are spliced out in preorder (dead ancestors before their
    dead descendants).  At each splice the dead node's *deputy* — the
    surviving child sharing its finest stratum (a dead coordinator's
    stand-in from its own group), ties broken by cheapest edge to the
    parent — is promoted into the dead node's exact service slot, so the
    repaired tree keeps the same slow-link structure the builder would
    choose from scratch.  The remaining orphaned subtrees reparent onto
    the cheapest surviving attach point under the postal cost model —
    estimated payload *arrival* at the orphan: the candidate's own
    root-to-node path time, plus the injection occupancy of the children
    the candidate serves first, plus the new edge's transfer.  Pricing
    arrivals (not just edges) balances width against depth: it spreads
    equal-distance orphans across NICs and refuses to hang a large
    subtree below an already-late node.  Candidates are the promoted
    deputy, the lost parent's ancestor
    chain, the surviving children of that chain (the orphan's "uncles" —
    what lets it rejoin a same-stratum subtree instead of paying its own
    slow crossing), and orphan siblings already re-attached in this
    splice.  Children lists stay ordered so slower-level subtrees keep
    being served first (Fig. 4's rule survives the splice).

    Raises ``ValueError`` when the root itself failed (the plan's root is
    semantic; the caller must re-plan) or when no member survives.
    """
    dead = set(failed) & set(tree.members())
    if tree.root in dead:
        raise ValueError(f"cannot repair: root {tree.root} failed")
    children = {p: list(cs) for p, cs in tree.children.items()}
    parent = {c: p for p, cs in children.items() for c in cs}
    if not dead:
        return Tree(tree.root, {p: cs for p, cs in children.items() if cs})

    def occupy(a: int, upto_level: int) -> float:
        """a's injection occupancy for the children served at or before a
        new child of class ``upto_level`` (slow-first service order)."""
        return sum(topo.levels[topo.comm_level(a, x)].occupy(nbytes)
                   for x in children.get(a, [])
                   if topo.comm_level(a, x) <= upto_level)

    def est_ready(a: int) -> float:
        """Postal estimate of when ``a`` holds the payload: queue + xfer
        along its current root path (root is ready at 0)."""
        path = [a]
        while path[-1] in parent:
            path.append(parent[path[-1]])
        t = 0.0
        for node, y in zip(path[::-1], path[-2::-1]):
            lvl = topo.comm_level(node, y)
            idx = children[node].index(y)
            t += sum(topo.levels[topo.comm_level(node, x)].occupy(nbytes)
                     for x in children[node][:idx])
            t += topo.levels[lvl].xfer(nbytes)
        return t

    def cost(a: int, b: int) -> float:
        """Estimated arrival of the payload at ``b`` if attached under
        ``a`` (appended after a's same-or-slower-level children)."""
        lvl = topo.comm_level(a, b)
        return (est_ready(a) + occupy(a, lvl)
                + topo.levels[lvl].xfer(nbytes))

    for d in tree.members():  # preorder: parents before children
        if d not in dead:
            continue
        # d's current parent (and its whole chain) is alive: dead original
        # ancestors were spliced earlier in preorder, and re-attachment
        # only ever targets live nodes
        p, orphans = parent[d], children.pop(d, [])
        slot = children[p].index(d)
        children[p].pop(slot)
        del parent[d]
        chain = [p] + _ancestors(parent, p)
        # uncles root subtrees disjoint from d's, so attaching an orphan
        # (a subtree of d's) under one can never form a cycle
        cands = chain + [c for a in chain for c in children.get(a, [])
                         if c not in dead]
        live = [c for c in orphans if c not in dead]
        if live:
            deputy = min(live, key=lambda c: (-topo.comm_level(d, c),
                                              cost(p, c)))
            orphans.remove(deputy)
            children[p].insert(slot, deputy)
            parent[deputy] = p
            cands.insert(0, deputy)
        for c in orphans:
            best = min(cands, key=lambda a: cost(a, c))
            lvl = topo.comm_level(best, c)
            cs = children.setdefault(best, [])
            pos = sum(1 for x in cs if topo.comm_level(best, x) <= lvl)
            cs.insert(pos, c)
            parent[c] = best
            if c not in dead:  # a dead orphan is spliced on its own visit
                cands.append(c)
    out = Tree(tree.root, {p: cs for p, cs in children.items() if cs})
    out.validate()
    return out


def _ancestors(parent: dict[int, int], n: int) -> list[int]:
    out = []
    while n in parent:
        n = parent[n]
        out.append(n)
    return out
