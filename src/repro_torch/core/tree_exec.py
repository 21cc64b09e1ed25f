"""Execute the paper's explicit multilevel trees on ranks with
point-to-point rounds — the faithful §3.2 port.

ENGINE MODULE: these are the primitives behind the ``backend="p2p"`` path
of :class:`repro_torch.core.communicator.Communicator`, which is the
public entry point (``Communicator(topo, backend="p2p")``) and also caches
the round schedules (``Plan.rounds``) across calls.

MPICH-G2 §3.2: every process independently constructs the identical tree
and executes it with point-to-point sends.  One tree "round" (a set of
disjoint (src, dst) edges: each rank sends at most one message and
receives at most one) is one ``dist.batch_isend_irecv`` of this rank's
send and receive in that round; a rank with neither skips the round.  The
rounds are computed statically from the Tree (``tree_rounds``) or from a
lowered plan (``Lowered.device_rounds``), so every rank runs the same
program with no negotiation.

Counterpart of ``repro/core/tree_exec.py``: ``tree_rounds`` is a copy, and
``run_lowered``, ``tree_bcast``, ``tree_reduce`` and ``tree_gather_flat``
fold what they receive in the reference's order and operand order
(``cur + recv``), so every sum is bit for bit the reference's.  Member i of
the topology is rank i of the process group (:class:`Peers`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .trees import Tree

__all__ = ["Peers", "tree_rounds", "tree_bcast", "tree_reduce",
           "tree_gather_flat", "run_lowered"]


def tree_rounds(tree: Tree) -> list[list[tuple[int, int]]]:
    """Static round schedule: list of rounds, each a list of (src, dst) tree
    edges; a parent injects one message per round (postal sequential sends),
    children become senders the round after they receive."""
    recv_round = {tree.root: -1}
    pending = {p: list(cs) for p, cs in tree.children.items()}
    rounds: list[list[tuple[int, int]]] = []
    r = 0
    injections: dict[int, int] = {}
    while any(pending.values()):
        this: list[tuple[int, int]] = []
        for p in list(pending):
            if p not in recv_round or recv_round[p] >= r:
                continue
            sent = injections.get(p, 0)
            # parent may inject its (r - recv_round[p] - 1)-th message now
            if pending[p] and sent <= r - recv_round[p] - 1:
                c = pending[p].pop(0)
                this.append((p, c))
                injections[p] = sent + 1
                recv_round[c] = r
        if not this:  # safety: should not happen on a valid tree
            raise RuntimeError("tree schedule stalled")
        rounds.append(this)
        r += 1
    return rounds


class Peers:
    """This rank's place in a process group (None: the default group) whose
    rank i is member i of ``topo``.

    ``exchange`` runs one round.  Where the backend is gloo and a tensor
    lives on a card (ranks sharing one card, which NCCL refuses), the
    round's send and receive are staged through host memory and counted in
    ``staged_bytes``.  ``link_bytes`` and ``link_messages`` count the
    payload and the messages this rank sends on each link class, by the
    name of ``topo.comm_level``'s level."""

    def __init__(self, topo, group=None):
        self.topo = topo
        self.group = group
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        if self.size != topo.nprocs:
            raise ValueError(f"process group of {self.size} ranks for a "
                             f"topology of {topo.nprocs} members")
        self.ranks = ([dist.get_global_rank(group, i)
                       for i in range(self.size)] if group is not None
                      else list(range(self.size)))
        self.backend = dist.get_backend(group)
        self.link_bytes = {lvl.name: 0 for lvl in topo.levels}
        self.link_messages = dict(self.link_bytes)
        self.staged_bytes = 0
        # NCCL wants every rank in the group's first point-to-point batch
        self._joined = self.backend != "nccl"

    def exchange(self, send: torch.Tensor | None, dst: int | None,
                 like: torch.Tensor | None, src: int | None
                 ) -> torch.Tensor | None:
        """Send ``send`` to member ``dst`` and receive a tensor shaped and
        typed as ``like`` from member ``src``, in one batch; either side may
        be None.  Returns what was received (on ``like``'s device)."""
        if not self._joined:
            dist.barrier(group=self.group)
            self._joined = True
        stage = self.backend == "gloo" and any(
            t is not None and t.is_cuda for t in (send, like))
        ops, out = [], None
        if send is not None:
            buf = send.contiguous()
            if stage:
                buf = buf.cpu()
                self.staged_bytes += buf.nbytes
            level = self.topo.levels[self.topo.comm_level(self.index, dst)]
            self.link_bytes[level.name] += buf.nbytes
            self.link_messages[level.name] += 1
            ops.append(dist.P2POp(dist.isend, buf, self.ranks[dst],
                                  self.group))
        if like is not None:
            out = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if stage else like.device)
            ops.append(dist.P2POp(dist.irecv, out, self.ranks[src],
                                  self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if out is not None and stage:
            self.staged_bytes += out.nbytes
            out = out.to(like.device)
        return out


def _roles(edges, me: int):
    """(dst this rank sends to, src it receives from) in one round, None
    where it has no such role."""
    dst = next((d for s, d in edges if s == me), None)
    src = next((s for s, d in edges if d == me), None)
    return dst, src


def run_lowered(x: torch.Tensor, lowered, peers: Peers) -> torch.Tensor:
    """Execute a lowered rounds-IR program
    (:class:`repro_torch.core.rounds.Lowered`) on ranks: one
    ``batch_isend_irecv`` per device round.

    The payload is reshaped into ``lowered.nchunks`` contiguous chunks (the
    IR's data units — zero padding as needed); each round every
    participating rank ships one chunk to one peer and folds (``reduce``:
    ``cur + recv``) or overwrites (``copy``) on receipt.  Works for any
    lowering whose chunk ids are 0..nchunks-1 (tree bcast/allreduce, sag,
    rsag).  ``x`` is not modified."""
    C = max(1, lowered.nchunks)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % C
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    buf = flat.reshape(C, -1).clone()
    me = peers.index
    for rnd in lowered.device_rounds():
        send = next(((d, c) for s, d, c, _ in rnd if s == me), None)
        recv = next(((s, c, k) for s, d, c, k in rnd if d == me), None)
        if send is None and recv is None:
            continue
        got = peers.exchange(
            None if send is None else buf[send[1]],
            None if send is None else send[0],
            None if recv is None else buf[recv[1]],
            None if recv is None else recv[0])
        if recv is not None:
            _, c, kind = recv
            buf[c] = buf[c] + got if kind == "reduce" else got
    out = buf.reshape(-1)
    if pad:
        out = out[:out.numel() - pad]
    return out.reshape(x.shape)


def tree_bcast(x: torch.Tensor, tree: Tree, peers: Peers) -> torch.Tensor:
    """Broadcast the root's value to every rank using the tree's rounds.
    Non-root inputs are ignored (replaced)."""
    have = peers.index == tree.root
    for rnd in tree_rounds(tree):
        dst, src = _roles(rnd, peers.index)
        if dst is None and src is None:
            continue
        got = peers.exchange(None if dst is None else x, dst,
                             None if src is None else x, src)
        if src is not None and not have:
            x = got
        have = have or src is not None
    return x


def tree_reduce(x: torch.Tensor, tree: Tree, peers: Peers) -> torch.Tensor:
    """Sum-reduce to the tree root (other ranks return partials — callers
    select on root).  Children send up in reversed round order."""
    for rnd in reversed(tree_rounds(tree)):
        up = [(d, s) for s, d in rnd]  # reverse each edge
        dst, src = _roles(up, peers.index)
        if dst is None and src is None:
            continue
        got = peers.exchange(None if dst is None else x, dst,
                             None if src is None else x, src)
        if src is not None:
            x = x + got
    return x


def tree_gather_flat(x: torch.Tensor, tree: Tree, peers: Peers,
                     size: int) -> torch.Tensor:
    """Gather every rank's ``x`` to the root as [size, ...] via up-edges.

    Each round ships the partial gather buffer up one tree edge (a masked
    all-gather substitute): the buffer costs as much as an all-gather, but
    traffic follows the multilevel tree (slow links crossed once)."""
    buf = x.new_zeros((size,) + tuple(x.shape))
    buf[peers.index] = x
    for rnd in reversed(tree_rounds(tree)):
        up = [(d, s) for s, d in rnd]
        dst, src = _roles(up, peers.index)
        if dst is None and src is None:
            continue
        got = peers.exchange(None if dst is None else buf, dst,
                             None if src is None else buf, src)
        if src is not None:
            buf = buf + got
    return buf
