"""Event-driven postal-model executor for collective schedules and plans.

Charges every message its TRUE per-edge cost from a ``Topology`` — even when
the tree was built from an oblivious (flat) or 2-level (MagPIe) view.  This is
how we reproduce the paper's Fig. 8 on one CPU: build trees under different
views, simulate them all on the real multilevel network.

Model per message (postal / LogP-flavoured):
  sender occupied  [t, t + overhead + nbytes/bw]   (sequential injections)
  arrival at dst    t + latency + nbytes/bw
Receivers of fold (reduce) messages drain inbound messages sequentially with
the same occupancy term, which penalises high fan-in on slow links — the
effect that makes flat trees lose at low latency.

Two executors:

:func:`simulate`
    Whole-message :class:`~repro_torch.core.schedule.Schedule` phases.  Phase
    hand-off is **per-rank**: a rank starts phase i+1 work the moment its own
    phase-i role ends (the root of a reduce→bcast allreduce broadcasts as
    soon as *it* has folded — not when the slowest leaf has finished
    injecting).
:func:`simulate_rounds`
    The lowered rounds IR (:class:`~repro_torch.core.rounds.Lowered`): a single
    linear pass over the send program.  Each send starts at
    max(dependencies delivered, sender NIC free); per-rank program order is
    FIFO.  This is where segment pipelining is priced: a node forwards
    segment k while segment k+1 is still in flight toward it.
:func:`simulate_concurrent`
    Several ``Lowered`` programs live on the network AT ONCE (what the
    reference's async engine schedules).  Contention is
    charged per *link* — a link is one directed edge (src, dst) at its
    level's bandwidth — as fluid fair sharing: k concurrent transfers on a
    link each proceed at bandwidth/k (or, under strict priorities, only the
    highest-priority program's transfers proceed).  A program alone on its
    links prices bit-identically to :func:`simulate_rounds`.
"""
from __future__ import annotations

import heapq
import math
import weakref
from typing import Mapping, Sequence

from ..obs.trace import PID_PROGRAMS
from .schedule import Direction, Schedule
from .topology import Topology

# Critical-path instants carry at most this many edges: enough to read the
# bottleneck chain in a viewer, bounded so a 64-segment pipelined transfer
# cannot bloat the trace.
_CRIT_PATH_CAP = 64

class _IdWeakSet:
    """Identity-keyed weak set.  ``Lowered`` is a frozen dataclass whose
    field-derived hash walks the whole send list — O(n_sends) per lookup —
    so a plain WeakSet memo would cost ~10% of the simulation itself.
    Keying on ``id()`` with a death callback keeps the lookup O(1) without
    keeping evicted plans alive (the callback runs before the interpreter
    can reuse the address)."""

    def __init__(self) -> None:
        self._refs: dict[int, "weakref.ref"] = {}

    def __contains__(self, obj) -> bool:
        ref = self._refs.get(id(obj))
        return ref is not None and ref() is obj

    def add(self, obj) -> None:
        key = id(obj)
        self._refs[key] = weakref.ref(
            obj, lambda _r, k=key: self._refs.pop(k, None))

    def discard(self, obj) -> None:
        if obj in self:
            del self._refs[id(obj)]


# Programs that already passed the sanitize gate this process: Lowered is
# frozen (its send list cannot change), so each object needs checking once
# — the memo makes ``sanitize=True`` free on cached-plan re-runs.
_SANITIZED = _IdWeakSet()


def _sanitize(lowered) -> None:
    if lowered in _SANITIZED:
        return
    from ..analysis.verify import quick_check  # no load-time cycle

    quick_check(lowered, context="sanitize")
    _SANITIZED.add(lowered)

__all__ = ["simulate", "simulate_rounds", "simulate_concurrent",
           "simulate_op", "probe_time"]


def simulate(sched: Schedule, topo: Topology, start: float = 0.0) -> dict[int, float]:
    """Run ``sched`` on ``topo``; return per-rank completion times.

    Phases hand off per rank: ``done[r]`` after phase i seeds rank r's
    availability in phase i+1 (no global barrier between phases).
    """
    done = {r: start for r in sched.phases[0].tree.members()}
    for phase in sched.phases:
        if phase.direction is Direction.DOWN:
            done = _run_down(phase, topo, done)
        else:
            done = _run_up(phase, topo, done)
    return done


def _run_down(phase, topo: Topology, prev: dict[int, float]) -> dict[int, float]:
    tree = phase.tree
    ready = {tree.root: prev[tree.root]}
    order = tree.members()  # preorder: parents before children
    for p in order:
        t = ready[p]
        for msg in phase.msgs.get(p, []):
            lvl = topo.level_of_edge(msg.src, msg.dst)
            arrival = t + lvl.latency + msg.nbytes / lvl.bandwidth
            # the receiver is available once it holds the data AND has
            # finished its own earlier-phase role
            ready[msg.dst] = max(arrival, prev[msg.dst])
            t += lvl.occupy(msg.nbytes)  # next injection after this one
    return ready


def _run_up(phase, topo: Topology, prev: dict[int, float]) -> dict[int, float]:
    tree = phase.tree
    done: dict[int, float] = {}

    # Iterative post-order (children before parent): deep trees — e.g. a
    # chain over thousands of ranks — must not blow the recursion limit.
    # done[p] = time p has received (and folded) all of its subtree.
    # Children send as soon as their own subtrees finish; p drains their
    # messages sequentially (receive occupancy).
    stack: list[tuple[int, bool]] = [(tree.root, False)]
    while stack:
        p, expanded = stack.pop()
        cs = tree.children.get(p, [])
        if cs and not expanded:
            stack.append((p, True))
            stack.extend((c, False) for c in cs)
            continue
        t = prev[p]  # p joins the fan-in once its prior phase ended
        for c in cs:
            (msg,) = phase.msgs[c]
            lvl = topo.level_of_edge(c, p)
            arrival = done[c] + lvl.latency + msg.nbytes / lvl.bandwidth
            t = max(t, arrival) + lvl.overhead
        done[p] = t

    # Leaves are "done" immediately; completion of the phase per rank: a rank
    # finishes when its own up-message has been *injected* (it is then free),
    # the root when it has folded everything.
    pm = tree.parent_map()
    out = {}
    for p in tree.members():
        if p == tree.root:
            out[p] = done[p]
        else:
            (msg,) = phase.msgs[p]
            lvl = topo.level_of_edge(p, pm[p])
            out[p] = done[p] + lvl.occupy(msg.nbytes)
    return out


# ---------------------------------------------------------------------- #
# The rounds-IR executor.
# ---------------------------------------------------------------------- #

def simulate_rounds(lowered, topo: Topology, start: float = 0.0,
                    fail_at: dict[int, float] | None = None,
                    *, tracer=None, label: str | None = None,
                    sanitize: bool = False) -> dict[int, float]:
    """Execute a :class:`~repro_torch.core.rounds.Lowered` program on ``topo``.

    One linear pass: the send list is topologically ordered and each rank's
    subsequence is its FIFO injection program, so every timing input (dep
    delivery, sender NIC, receiver fold occupancy) is already known when a
    send is reached.  Returns per-rank completion times over
    ``lowered.members``.

    ``fail_at`` injects failures: ``{rank: death_time}``.  A send is LOST
    when any dependency was lost, the sender dies before finishing its
    injection, or the receiver dies before arrival.  A surviving rank
    blocked on lost data reports ``math.inf`` — the signature a failure
    detector observes; dead ranks report their death time.  With
    ``fail_at`` empty/None the timing is bit-identical to the fault-free
    path.

    ``lowered`` may also be a *sequence* of ``Lowered`` programs: they are
    handed to :func:`simulate_concurrent` (all released at ``start``, fair
    link sharing) and a list of per-program completion dicts is returned.
    ``fail_at`` is a single-program feature and is rejected there.

    With a ``tracer`` (:class:`repro_torch.obs.Tracer`), every delivered send is
    recorded as a busy interval on its directed edge and the program's
    critical path (the chain of sends whose gates determined the last
    delivery) is emitted as an instant on track ``label``.  Tracing never
    perturbs the computed times — the timing code is byte-for-byte the
    untraced path.

    ``sanitize=True`` runs the cheap structural verifier
    (:func:`repro_torch.analysis.verify.quick_check`: self-sends, member
    closure, dependency order/cycles) before executing; each ``Lowered``
    object is checked at most once per process, so re-running a cached
    plan costs one set lookup.
    """
    if isinstance(lowered, (list, tuple)):
        if fail_at:
            raise ValueError("fail_at is not supported for concurrent "
                             "programs; inject failures per single program")
        return simulate_concurrent(
            lowered, topo, starts=[start] * len(lowered), tracer=tracer,
            labels=[label] * len(lowered) if label is not None else None,
            sanitize=sanitize)
    if sanitize:
        _sanitize(lowered)
    if tracer is not None and tracer.defer:
        # zero-cost tracing on the live run: queue a deterministic replay
        # (this exact call, inline-recording) for when the trace is read,
        # and execute untraced now.  Both runs compute identical times.
        fa = dict(fail_at) if fail_at else None
        tracer.defer_record(
            lambda tr=tracer: simulate_rounds(lowered, topo, start, fa,
                                              tracer=tr, label=label))
        tracer = None
    death = fail_at or {}
    sender_free: dict[int, float] = {}
    recv_free: dict[int, float] = {}
    delivered: list[float] = []
    completion = {r: start for r in lowered.members}

    trace = tracer is not None
    if trace:
        # hot-path discipline: one pre-built tuple appended per delivered
        # send (plain-list level table, bound append) — the <5% tracing
        # overhead budget asserted by benchmarks/bench_obs.py lives here
        lvltab = topo.comm_level_table()
        lappend = tracer.links.append
        gid = tracer.group()  # one sharing group per invocation
        plabel = label if label is not None else "collective"
        cause: list[int | None] = []    # gate that set each send's t0
        last_send_of: dict[int, int] = {}
        last_fold_of: dict[int, int] = {}

    for i, snd in enumerate(lowered.sends):
        src, dst = snd.src, snd.dst
        lvl = topo.level_of_edge(src, dst)
        sf = sender_free.get(src, start)
        t0 = max(start, sf, *(delivered[d] for d in snd.deps)) \
            if snd.deps else max(start, sf)
        xfer = snd.nbytes / lvl.bandwidth
        inject_end = t0 + xfer + (lvl.overhead if snd.first else 0.0)
        arrival = t0 + xfer + (lvl.latency if snd.first else 0.0)
        if trace:
            c = None
            if t0 > start and sf == t0:
                c = last_send_of.get(src)
            for d in snd.deps:
                if delivered[d] == t0:
                    c = d
            cause.append(c)
        if death and (t0 == math.inf
                      or inject_end > death.get(src, math.inf)
                      or arrival > death.get(dst, math.inf)):
            # lost: deps never delivered, sender died mid-injection, or
            # receiver died before arrival.  A live sender blocked on lost
            # data waits forever; downstream consumers inherit the loss.
            delivered.append(math.inf)
            if src not in death:
                if t0 == math.inf:
                    completion[src] = math.inf
                else:  # injected into a dead peer: the NIC time is real
                    sender_free[src] = inject_end
                    completion[src] = max(completion[src], inject_end)
            elif t0 == math.inf or inject_end > death[src]:
                # the dying rank's NIC never frees: its LATER queued sends
                # must not jump the FIFO and get spuriously delivered
                sender_free[src] = math.inf
            else:  # lost to the receiver's death; sender still alive here
                sender_free[src] = inject_end
            if dst not in death:
                completion[dst] = math.inf
            continue
        sender_free[src] = inject_end
        if snd.kind == "reduce":
            # folds drain sequentially at the receiver (postal occupancy)
            done = max(arrival, recv_free.get(dst, start)) + lvl.overhead
            recv_free[dst] = done
        else:
            done = arrival
        delivered.append(done)
        if trace:
            lappend((src, dst, lvltab[src][dst], t0, arrival,
                     snd.nbytes, snd.kind, snd.first, plabel,
                     t0 + xfer, gid))
            if snd.kind == "reduce":
                if done - lvl.overhead > arrival:
                    # queued behind the receiver's fold drain: the delivery
                    # chain runs through the previous fold, not our injection
                    cause[i] = last_fold_of.get(dst, cause[i])
                last_fold_of[dst] = i
            last_send_of[src] = i
        completion[src] = max(completion[src], inject_end)
        completion[dst] = max(completion[dst], done)
    for r, t in death.items():
        if r in completion:
            completion[r] = min(completion[r], t)
    if trace and delivered:
        end = max((t for t in delivered if t != math.inf), default=None)
        if end is not None:
            k: int | None = delivered.index(end)
            path = []
            while k is not None and len(path) < _CRIT_PATH_CAP:
                s = lowered.sends[k]
                path.append(f"{s.src}->{s.dst}")
                k = cause[k]
            path.reverse()
            tracer.instant(PID_PROGRAMS, plabel, "critical_path", end,
                           {"edges": path, "hops": len(path),
                            "length_s": end - start})
    return completion


# ---------------------------------------------------------------------- #
# The concurrent executor: many live programs, per-link bandwidth sharing.
# ---------------------------------------------------------------------- #

_ACTIVATE, _FINISH = 0, 1


def simulate_concurrent(programs: Sequence, topo: Topology, *,
                        starts: Sequence[float] | None = None,
                        deps: "Mapping[int, Sequence[int]] | Sequence[Sequence[int]] | None" = None,
                        priorities: Sequence[float] | None = None,
                        tracer=None,
                        labels: Sequence[str | None] | None = None,
                        trace_programs: bool = True,
                        sanitize: bool = False,
                        ) -> list[dict[int, float]]:
    """Execute several ``Lowered`` programs concurrently on ``topo``.

    Returns one per-rank completion dict per program (same contract as
    :func:`simulate_rounds` per program).

    Model — the postal model extended with *fluid link sharing*:

    * A **link** is a directed edge (src, dst) charged at its level-class
      bandwidth.  The k transfers concurrently active on a link each flow at
      ``bandwidth / k`` (processor sharing); rates re-divide whenever a
      transfer joins or drains.  Within ONE program a sender's FIFO NIC
      admits at most one in-flight transfer, so a program that shares no
      link with another prices **bit-identically** to its isolated
      :func:`simulate_rounds` run — contention is the only coupling.
    * ``starts[j]`` releases program j at an absolute time (default 0.0).
    * ``deps[j]`` names programs that must COMPLETE (every rank done)
      before program j is released — how the engine encodes per-member-set
      FIFO order and explicit handle dependencies.
    * ``priorities[j]`` switches a link from fair sharing to strict
      priority: only the highest-priority transfers active on the link
      flow, lower ones stall until the link clears.  Equal priorities
      share fairly.  ``None`` means all-fair.
    * An entry may also be a ``(base, age_rate)`` pair: the program's
      effective priority at time t is ``base + age_rate * (t - release)``
      — a preempted transfer decays toward the front of the link the
      longer it waits (bounded starvation).  With one shared ``age_rate``
      the pairwise differences are CONSTANT in time (both grow at the
      same slope), so link eligibility can only flip at join/drain
      events, which the fluid executor already processes — no extra
      crossover events are needed.  (Heterogeneous rates are legal but
      re-evaluated only at link events.)  ``age_rate == 0`` is exactly
      the static-priority behaviour.

    Latency and sender/receiver overheads stay per-message quantities
    (charged once at flow end for ``first`` sends), and reduce messages
    still drain sequentially at the receiver — both exactly as in the
    single-program executor.

    With a ``tracer``, every completed transfer becomes a busy interval on
    its directed edge (labelled by ``labels[j]``), each program gets a
    release→finish span on :data:`~repro_torch.obs.PID_PROGRAMS` (suppressed
    with ``trace_programs=False`` when the caller — the engine — emits its
    own richer handle spans on the same tracks) and a critical-path
    instant walking the chain of gates that produced the last delivery.
    Tracing is observation only: completion times are identical with and
    without it.
    """
    if tracer is not None and tracer.defer:
        # as in simulate_rounds: snapshot the arguments, queue an inline
        # replay for trace-read time, run untraced now
        ps = list(programs)
        ss = None if starts is None else list(starts)
        dd = (dict(deps) if isinstance(deps, Mapping)
              else None if deps is None else [list(d) for d in deps])
        pr = None if priorities is None else list(priorities)
        lb = None if labels is None else list(labels)
        tracer.defer_record(
            lambda tr=tracer: simulate_concurrent(
                ps, topo, starts=ss, deps=dd, priorities=pr, tracer=tr,
                labels=lb, trace_programs=trace_programs))
        tracer = None
    progs = list(programs)
    if sanitize:
        for p in progs:
            _sanitize(p)
    K = len(progs)
    rel = list(starts) if starts is not None else [0.0] * K
    if len(rel) != K:
        raise ValueError(f"need {K} start times, got {len(rel)}")
    if deps is None:
        pdeps: list[list[int]] = [[] for _ in range(K)]
    elif isinstance(deps, Mapping):
        pdeps = [sorted(set(deps.get(j, ()))) for j in range(K)]
    else:
        pdeps = [sorted(set(deps[j])) for j in range(K)]
    for j, ds in enumerate(pdeps):
        if any(d == j or not 0 <= d < K for d in ds):
            raise ValueError(f"bad program dependency list for #{j}: {ds}")
    if priorities is None:
        prio = age = None
    else:
        prio, age = [], []
        for p in priorities:
            if isinstance(p, tuple):
                base, rate = p
                if rate < 0:
                    raise ValueError("priority age_rate must be >= 0")
                prio.append(float(base))
                age.append(float(rate))
            else:
                prio.append(float(p))
                age.append(0.0)
        if not any(age):
            age = None

    # -- flatten the programs into one transfer table ------------------- #
    off = [0]
    for p in progs:
        off.append(off[-1] + len(p.sends))
    n = off[-1]
    prog_of = [0] * n
    send_of = [None] * n
    lvl_of = [None] * n
    gdeps: list[tuple[int, ...]] = [()] * n
    fifo_next: list[int | None] = [None] * n
    fifo_prev: list[int | None] = [None] * n
    rev: list[list[int]] = [[] for _ in range(n)]
    fold_chain: dict[tuple[int, int], list[int]] = {}
    for j, p in enumerate(progs):
        last_of_src: dict[int, int] = {}
        for i, snd in enumerate(p.sends):
            g = off[j] + i
            prog_of[g] = j
            send_of[g] = snd
            lvl_of[g] = topo.level_of_edge(snd.src, snd.dst)
            gdeps[g] = tuple(off[j] + d for d in snd.deps)
            for d in gdeps[g]:
                rev[d].append(g)
            prev = last_of_src.get(snd.src)
            if prev is not None:
                fifo_next[prev] = g
                fifo_prev[g] = prev
            last_of_src[snd.src] = g
            if snd.kind == "reduce":
                fold_chain.setdefault((j, snd.dst), []).append(g)

    # -- per-transfer dynamic state ------------------------------------- #
    released = [len(ds) == 0 for ds in pdeps]
    pdep_left = [len(ds) for ds in pdeps]
    completion: list[dict[int, float] | None] = [None] * K
    finish: list[float | None] = [None] * K
    left = [len(p.sends) for p in progs]
    rdeps: list[list[int]] = [[] for _ in range(K)]
    for j, ds in enumerate(pdeps):
        for d in ds:
            rdeps[d].append(j)

    delivered: list[float | None] = [None] * n
    arrived: list[float | None] = [None] * n      # reduce flow-arrivals
    sender_term: list[float | None] = [None] * n  # prev inject_end (FIFO)
    waiting = [0] * n
    remaining = [0.0] * n
    rate = [0.0] * n
    last_t = [0.0] * n
    flow_end = [math.inf] * n
    active = [False] * n
    done = [False] * n
    recv_free: dict[tuple[int, int], float] = {}
    chain_ptr: dict[tuple[int, int], int] = {k: 0 for k in fold_chain}
    edge_active: dict[tuple[int, int], list[int]] = {}

    trace = tracer is not None
    if trace:
        lvltab = topo.comm_level_table()
        gid = tracer.group()  # every transfer of this batch shared links
        lab = [labels[j] if labels is not None and labels[j] is not None
               else f"prog{j}" for j in range(K)]
        astart = [0.0] * n             # first activation (flow start)
        cause: list[int | None] = [None] * n   # gate that set each t0

    events: list[tuple[float, int, int, int]] = []
    seq = 0

    def push(t: float, kind: int, g: int) -> None:
        nonlocal seq
        heapq.heappush(events, (t, seq, kind, g))
        seq += 1

    def ready(g: int) -> None:
        """All gates known: compute the injection start and schedule it."""
        j = prog_of[g]
        t0 = rel[j]
        st = sender_term[g]
        if st is not None and st > t0:
            t0 = st
            if trace:
                cause[g] = fifo_prev[g]
        for d in gdeps[g]:
            if delivered[d] > t0:  # type: ignore[operator]
                t0 = delivered[d]
                if trace:
                    cause[g] = d
        remaining[g] = send_of[g].nbytes
        push(t0, _ACTIVATE, g)

    def reshare(e: tuple[int, int], now: float) -> None:
        """Re-divide a link's bandwidth among its active transfers."""
        xs = edge_active.get(e)
        if not xs:
            return
        if prio is None:
            elig = xs
        else:
            if age is None:
                eff = prio
            else:
                # aged priority: differences are time-invariant under a
                # shared rate, so evaluating at `now` is exact for the
                # whole inter-event interval
                eff = [prio[j] + age[j] * (now - rel[j])
                       for j in range(len(prio))]
            top = max(eff[prog_of[x]] for x in xs)
            elig = [x for x in xs if eff[prog_of[x]] == top]
        bw = lvl_of[xs[0]].bandwidth
        each = bw / len(elig)
        for x in xs:
            if rate[x] > 0.0:
                remaining[x] = max(0.0, remaining[x]
                                   - (now - last_t[x]) * rate[x])
            last_t[x] = now
            if x in elig:
                rate[x] = each
                flow_end[x] = max(now, now + remaining[x] / each)
                push(flow_end[x], _FINISH, x)
            else:
                rate[x] = 0.0
                flow_end[x] = math.inf

    def gate_down(g: int) -> None:
        waiting[g] -= 1
        if waiting[g] == 0:
            ready(g)

    def deliver(g: int, t: float) -> None:
        """A transfer's payload is usable at the receiver: unblock waiters
        and retire it from its program."""
        delivered[g] = t
        snd = send_of[g]
        j = prog_of[g]
        c = completion[j]
        if c[snd.dst] < t:  # type: ignore[index]
            c[snd.dst] = t
        for w in rev[g]:
            gate_down(w)
        left[j] -= 1
        if left[j] == 0:
            finalize(j)

    def drain_folds(j: int, dst: int) -> None:
        """Sequential receive occupancy, in program order (exactly the
        single-program executor's recv_free rule)."""
        key = (j, dst)
        chain = fold_chain[key]
        p = chain_ptr[key]
        while p < len(chain) and arrived[chain[p]] is not None:
            g = chain[p]
            rf = recv_free.get(key, rel[j])
            if trace and p > 0 and rf > arrived[g]:
                # delivery waited on the receiver's fold drain: the chain
                # runs through the previous fold, not our own injection
                cause[g] = chain[p - 1]
            t = max(arrived[g], rf) + lvl_of[g].overhead
            recv_free[key] = t
            deliver(g, t)
            p += 1
        chain_ptr[key] = p

    def finalize(j: int) -> None:
        finish[j] = max(completion[j].values())  # type: ignore[union-attr]
        if trace:
            if trace_programs:
                tracer.span(PID_PROGRAMS, lab[j], lab[j], rel[j], finish[j],
                            {"sends": len(progs[j].sends),
                             "members": len(progs[j].members)})
            best, bt = None, -math.inf
            for i in range(off[j], off[j + 1]):
                d = delivered[i]
                if d is not None and d > bt:
                    best, bt = i, d
            if best is not None:
                path = []
                k: int | None = best
                while k is not None and len(path) < _CRIT_PATH_CAP:
                    s = send_of[k]
                    path.append(f"{s.src}->{s.dst}")
                    k = cause[k]
                path.reverse()
                tracer.instant(PID_PROGRAMS, lab[j], "critical_path",
                               finish[j],
                               {"edges": path, "hops": len(path),
                                "length_s": finish[j] - rel[j]})
        for k in rdeps[j]:
            pdep_left[k] -= 1
            if pdep_left[k] == 0:
                release(k)

    def release(j: int) -> None:
        t = rel[j]
        for d in pdeps[j]:
            if finish[d] > t:  # type: ignore[operator]
                t = finish[d]
        rel[j] = t
        released[j] = True
        completion[j] = {r: t for r in progs[j].members}
        if left[j] == 0:  # empty program: complete at release
            finalize(j)
            return
        for i in range(len(progs[j].sends)):
            gate_down(off[j] + i)

    # -- init ------------------------------------------------------------ #
    for g in range(n):
        j = prog_of[g]
        waiting[g] = 1 + len(gdeps[g])  # release gate + data deps
        # the FIFO gate: all but a rank's first send wait on a predecessor
    for g in range(n):
        nx = fifo_next[g]
        if nx is not None:
            waiting[nx] += 1
    for j in range(K):
        if released[j]:
            released[j] = False  # release() re-marks and opens the gate
            release(j)

    # -- event loop ------------------------------------------------------ #
    while events:
        t, _, kind, g = heapq.heappop(events)
        if done[g]:
            continue
        if kind == _ACTIVATE:
            e = (send_of[g].src, send_of[g].dst)
            edge_active.setdefault(e, []).append(g)
            active[g] = True
            last_t[g] = t
            if trace:
                astart[g] = t
            reshare(e, t)
            continue
        if not active[g] or flow_end[g] != t:
            continue  # stale finish event (rate changed since)
        snd = send_of[g]
        lvl = lvl_of[g]
        j = prog_of[g]
        done[g] = True
        active[g] = False
        e = (snd.src, snd.dst)
        edge_active[e].remove(g)
        reshare(e, t)
        inject_end = t + (lvl.overhead if snd.first else 0.0)
        c = completion[j]
        if c[snd.src] < inject_end:  # type: ignore[index]
            c[snd.src] = inject_end
        nx = fifo_next[g]
        if nx is not None:
            sender_term[nx] = inject_end
            gate_down(nx)
        arrival = t + (lvl.latency if snd.first else 0.0)
        if trace:
            tracer.link(snd.src, snd.dst, lvltab[snd.src][snd.dst],
                        astart[g], arrival, snd.nbytes, snd.kind, snd.first,
                        lab[j], t, gid)
        if snd.kind == "reduce":
            arrived[g] = arrival
            drain_folds(j, snd.dst)
        else:
            deliver(g, arrival)

    if any(f is None for f in finish):
        stuck = [j for j, f in enumerate(finish) if f is None]
        raise ValueError(
            f"programs {stuck} never completed — cyclic dependencies "
            f"between programs, or a malformed send program")
    return completion  # type: ignore[return-value]


def simulate_op(op_fn, tree, topo: Topology, nbytes: float) -> float:
    """Convenience: max completion time of op_fn(tree, nbytes) on topo."""
    sched = op_fn(tree, nbytes) if nbytes is not None else op_fn(tree)
    return max(simulate(sched, topo).values())


def probe_time(topo: Topology, p: int, q: int, nbytes: float) -> float:
    """One-way delivery time of a single point-to-point probe p→q.

    This is the postal-model quantity a timed ping observes: the sender's
    per-message cost (overhead) is on the critical path of a lone message,
    so the measured time is ``overhead + latency + nbytes/bandwidth``.
    :func:`repro_torch.core.discovery.simulated_probes` is the vectorised
    all-pairs version of exactly this expression; keeping the scalar form
    here pins the probe semantics to the simulator's cost model.
    """
    lvl = topo.level_of_edge(p, q)
    return lvl.overhead + lvl.latency + nbytes / lvl.bandwidth
