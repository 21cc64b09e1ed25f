"""The async collective engine: nonblocking handles over the plan machinery.

The paper's trees minimise the cost of ONE collective; this module is the
subsystem that issues, orders, and overlaps MANY.  A training step does not
run one monolithic gradient all-reduce after the full backward pass — it
streams size-targeted buckets into the network while backward is still
producing gradients, and a serving host runs several requests' collectives
at once.  Both need three things the :class:`~repro_torch.core.Communicator`
alone does not give:

**Handles** — ``engine.issue(op, nbytes, ...) -> Handle`` returns
immediately; ``handle.wait()`` / ``engine.wait_all()`` resolve.  Legal
interleavings are enforced, not assumed: collectives on the SAME member set
execute in issue order (the MPI same-communicator rule — every rank must
see the same sequence), and explicit cross-set orderings are declared with
``after=``.

**Contention-aware costing** — a batch of live handles is priced by
:func:`repro_torch.core.simulator.simulate_concurrent`: per-link fair bandwidth
sharing, so two plans crossing the same WAN edge slow each other down
exactly as far as the fluid postal model says they must.

**Scheduler policies** — per issue-batch:

``"fifo"``
    Every handle released at its ready time; concurrent handles share
    links fairly.
``"priority"``
    Strict-priority link arbitration: small/latency-bound collectives
    (default priority ``-nbytes``) preempt fat transfers on shared links
    instead of halving their bandwidth for the fat transfer's whole
    lifetime.  ``age_rate`` bounds starvation: a preempted transfer's
    effective priority rises by ``age_rate`` per second of waiting (from
    its release time), so a fat broadcast under a sustained stream of
    small high-priority ops eventually outranks newly released ones and
    completes — strict priority would starve it for the stream's whole
    lifetime.
``"sim"``
    Candidate orderings (fair, priority, serial issue-order, serial
    shortest-first) are each simulated under contention and the argmin
    makespan wins — the engine *measures* instead of guessing.

The bucketing helpers at the bottom (:func:`partition_buckets`,
:func:`overlapped_step_times`) model the bucketed, overlapped gradient
sync: backward produces per-layer gradients in reverse-layer order; each
size-targeted bucket is issued the moment its last layer's gradient
exists, so the all-reduce of bucket k rides under the backward compute of
the layers below it.

A copy of ``repro/core/engine.py``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Sequence

from ..obs.metrics import MetricsRegistry
from ..obs.trace import PID_PROGRAMS
from .communicator import OPS, Communicator, SimResult
from .simulator import simulate_concurrent, simulate_rounds

__all__ = ["Handle", "Engine", "EngineStats", "POLICIES",
           "partition_buckets", "overlapped_step_times"]

POLICIES = ("fifo", "priority", "sim")


class Handle:
    """One in-flight collective.  Created by :meth:`Engine.issue`; resolved
    by :meth:`wait` (which flushes the engine's pending batch).

    ``started``/``finished`` are simulation-clock times; ``result`` is the
    :class:`~repro_torch.core.SimResult` with per-rank completion times."""

    __slots__ = ("engine", "hid", "op", "root", "nbytes", "members", "at",
                 "after", "priority", "result", "started", "finished")

    def __init__(self, engine: "Engine", hid: int, op: str, root: int,
                 nbytes: float, members: tuple[int, ...], at: float,
                 after: tuple["Handle", ...], priority: float | None):
        self.engine = engine
        self.hid = hid
        self.op = op
        self.root = root
        self.nbytes = nbytes
        self.members = members
        self.at = at
        self.after = after
        self.priority = priority
        self.result: SimResult | None = None
        self.started: float | None = None
        self.finished: float | None = None

    @property
    def done(self) -> bool:
        return self.result is not None

    def wait(self) -> SimResult:
        """Resolve this handle (flushes every pending handle — the batch is
        scheduled as a whole; see :meth:`Engine.wait_all`)."""
        if self.result is None:
            self.engine._flush()
        if self.result is None:  # pragma: no cover - flush resolves batch
            raise RuntimeError(
                f"handle #{self.hid} still unresolved after flush")
        return self.result

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "done" if self.done else "pending"
        return (f"Handle#{self.hid}({self.op}, {self.nbytes:.0f}B, "
                f"|members|={len(self.members)}, {state})")


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Engine-side counters.  Plan-level reuse lives on the communicator:
    ``engine.comm.stats()`` (see :meth:`~repro_torch.core.Communicator.stats`)."""

    issued: int
    completed: int
    batches: int
    replanned: int      # pending handles re-issued by repair()
    last_policy: str    # strategy the last flush actually ran
    now: float          # simulation clock after the last flush


class Engine:
    """Nonblocking collective engine over one :class:`Communicator`.

    ``comm`` supplies the topology and the plan cache; the engine prices
    execution on the simulation plane (any backend's communicator works —
    planning is backend-independent).  ``policy`` is one of
    :data:`POLICIES` and may be overridden per :meth:`wait_all` call.
    ``check=True`` runs the static hazard analyzer
    (:mod:`repro_torch.analysis.hazards`) at every :meth:`issue` (error-severity
    hazards only) and :meth:`wait_all` (the full analysis, warnings
    included) — a deadlock cycle or dangling dependency fails fast with a
    precise diagnosis instead of surfacing as a cryptic simulation error.

    Member subsets: ``issue(..., members=...)`` plans over a sub-group of
    the communicator's ranks.  Sub-group plans are cached in per-subset
    communicators sharing the same topology/policy, so repeated traffic on
    a subset reuses its plans like the main set does.
    """

    def __init__(self, comm: Communicator, *, policy: str = "fifo",
                 now: float = 0.0, age_rate: float = 0.0, check: bool = False,
                 tracer=None, metrics: MetricsRegistry | None = None,
                 truth=None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {POLICIES}")
        if age_rate < 0:
            raise ValueError("age_rate must be >= 0")
        if truth is not None and truth.nprocs != comm.topo.nprocs:
            raise ValueError("truth topology has a different rank count")
        self.comm = comm
        # ``truth`` splits planning from execution: plans (and the
        # predicted_s the spans carry) come from comm.topo, but the batch
        # is *priced* on this topology — the simulation stand-in for the
        # real network, same role as FeedbackLoop.run(truth=).  Swapping
        # it mid-run injects link drift the model has not seen yet.
        self.truth = truth
        # set via HealthMonitor(engine=...): receives every resolved batch
        self.monitor = None
        self.policy = policy
        self.check = bool(check)
        self.age_rate = float(age_rate)
        self.now = float(now)
        # a traced communicator traces its engine too — one tracer covers
        # the whole stack unless the caller splits them explicitly
        self.tracer = tracer if tracer is not None else comm.tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._pending: list[Handle] = []
        self._hid = itertools.count()
        self._subcomms: dict[tuple[int, ...], Communicator] = {}
        self._last_finish: dict[tuple[int, ...], float] = {}
        self._issued = self.metrics.counter("engine.issued")
        self._completed = self.metrics.counter("engine.completed")
        self._batches = self.metrics.counter("engine.batches")
        self._replanned = self.metrics.counter("engine.replanned")
        self._wait_s = self.metrics.histogram("engine.wait_s")
        self._last_policy = policy

    # -- issue ----------------------------------------------------------- #
    def issue(self, op: str, x: Any = None, *, root: int | None = None,
              at: float | None = None,
              after: Sequence[Handle] = (),
              priority: float | None = None,
              members: Sequence[int] | None = None) -> Handle:
        """Enqueue one collective; returns immediately with a Handle.

        ``x`` sizes the op exactly like a Communicator call (bytes, or a
        device-shaped operand — see ``Communicator._nbytes_of`` for the
        per-rank semantics of gather/allgather/scatter).  ``at`` releases
        the collective no earlier than that simulation time (default: the
        engine clock ``now`` — e.g. when the producing backward layer has
        finished).  ``after`` adds explicit dependencies on other handles;
        same-member-set FIFO order is implicit and always enforced.
        ``priority``: larger preempts smaller under the "priority" policy
        (default ``-nbytes``: small collectives jump fat ones).
        """
        if op not in OPS:
            raise KeyError(op)
        mem = (self.comm.members if members is None
               else tuple(members))
        if not mem:
            raise ValueError("collective needs at least one member")
        if any(m not in self.comm.members for m in mem):
            raise ValueError(f"members {sorted(set(mem) - set(self.comm.members))} "
                             f"are not members of the communicator")
        root = mem[0] if root is None else root
        if root not in mem:
            raise ValueError(f"root {root} is not a member")
        for d in after:
            if d.engine is not self:
                raise ValueError("dependency handle belongs to a "
                                 "different engine")
        # size against the communicator that will PLAN the op: a device
        # scatter operand divides by ITS member count (pinned per-rank
        # semantics), which differs from the parent's on a subset
        nbytes = self._comm_for(mem)._nbytes_of(op, x)
        h = Handle(self, next(self._hid), op, root, nbytes, mem,
                   self.now if at is None else float(at), tuple(after),
                   priority)
        self._pending.append(h)
        if self.check:
            from ..analysis.hazards import HazardError, check_hazards

            try:
                check_hazards(self, errors_only=True)
            except HazardError:
                self._pending.remove(h)  # don't poison the batch
                raise
        self._issued.inc()
        return h

    def wait(self, handle: Handle) -> SimResult:
        if handle.engine is not self:
            raise ValueError("handle was issued on a different engine")
        return handle.wait()

    def wait_all(self, handles: Sequence[Handle] | None = None,
                 policy: str | None = None,
                 check: bool | None = None) -> list[SimResult]:
        """Resolve every pending handle (the whole batch is scheduled
        together) and return the results of ``handles`` (default: the
        batch just flushed, in issue order).  Handles issued on a different
        engine are rejected — accepting one would silently flush BOTH
        engines and return results that were never part of this batch.
        ``check`` overrides the engine's ``check=`` flag for this flush."""
        if handles is not None:
            for h in handles:
                if h.engine is not self:
                    raise ValueError("handle was issued on a different "
                                     "engine")
        if self.check if check is None else check:
            from ..analysis.hazards import check_hazards

            check_hazards(self)
        batch = self._flush(policy=policy)
        out = batch if handles is None else list(handles)
        return [h.wait() for h in out]

    # -- internals ------------------------------------------------------- #
    def _comm_for(self, members: tuple[int, ...]) -> Communicator:
        if members == self.comm.members:
            return self.comm
        sub = self._subcomms.get(members)
        if sub is None:
            # shares the tracer (one trace for the whole engine) but NOT
            # the metrics registry: the main communicator's counters must
            # not move when a subset plans
            sub = Communicator(self.comm.topo, policy=self.comm.policy,
                               backend="sim", members=members,
                               view=self.comm.view,
                               algorithm=self.comm.algorithm,
                               segment_bytes=self.comm.segment_bytes,
                               tracer=self.tracer)
            self._subcomms[members] = sub
        return sub

    def _flush(self, policy: str | None = None) -> list[Handle]:
        batch, self._pending = self._pending, []
        if not batch:
            return []
        policy = self.policy if policy is None else policy
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}")

        programs, releases = [], []
        depsets: list[set[int]] = []
        index = {h: i for i, h in enumerate(batch)}
        last_in_batch: dict[tuple[int, ...], int] = {}
        for i, h in enumerate(batch):
            comm = self._comm_for(h.members)
            plan = comm.plan(h.op, root=h.root, nbytes=h.nbytes)
            programs.append(plan.lower(h.nbytes))
            rel = h.at
            ds: set[int] = set()
            for d in h.after:
                if d.done:
                    rel = max(rel, d.finished)
                elif d in index:
                    ds.add(index[d])
                else:  # pragma: no cover - handles resolve batch-wise
                    raise ValueError("dependency handle neither done nor "
                                     "in this batch")
            prev = last_in_batch.get(h.members)
            if prev is not None:
                ds.add(prev)  # same member set: strict issue order
            else:
                rel = max(rel, self._last_finish.get(h.members, 0.0))
            last_in_batch[h.members] = i
            releases.append(rel)
            depsets.append(ds)

        prios = [h.priority if h.priority is not None else -h.nbytes
                 for h in batch]
        if self.age_rate:
            prios = [(p, self.age_rate) for p in prios]
        topo = self.comm.topo  # the model: plans + predicted_s
        net = topo if self.truth is None else self.truth  # what executes
        tr = self.tracer
        labels = [f"{h.op}#{h.hid}" for h in batch] if tr is not None \
            else None

        def run(deps, priorities, tracer=None):
            # trace_programs=False: the engine emits its own, richer,
            # handle spans on the same tracks below
            return simulate_concurrent(programs, net, starts=releases,
                                       deps=deps, priorities=priorities,
                                       tracer=tracer, labels=labels,
                                       trace_programs=False)

        ran = depsets  # the dependency sets the winning schedule executed
        if policy == "fifo":
            results, self._last_policy = run(depsets, None, tr), "fifo"
        elif policy == "priority":
            results, self._last_policy = run(depsets, prios, tr), "priority"
        else:  # "sim": simulate candidate orderings, keep the best
            cands = {"fair": (depsets, None), "priority": (depsets, prios)}
            for label, order in (("serial", range(len(batch))),
                                 ("serial-sjf", _sjf_order(batch, depsets))):
                chained = [set(d) for d in depsets]
                prev = None
                for i in order:
                    if prev is not None:
                        chained[i].add(prev)
                    prev = i
                cands[label] = (chained, None)
            best = None
            for label, (deps, pr) in cands.items():
                res = run(deps, pr)  # candidates stay untraced: only the
                for_pr = pr         # winner's traffic really "happened"
                makespan = max(max(c.values()) for c in res)
                if best is None or makespan < best[0]:
                    best = (makespan, label, res, deps, for_pr)
            results, self._last_policy = best[2], f"sim:{best[1]}"
            ran = best[3]
            if tr is not None:
                run(best[3], best[4], tr)  # deterministic re-run to record

        finishes = [max(c.values()) for c in results]
        for i, h in enumerate(batch):
            h.result = SimResult(h.op, h.root, h.nbytes, results[i])
            h.started = max([releases[i]]
                            + [finishes[d] for d in ran[i]])
            h.finished = finishes[i]
            self._last_finish[h.members] = max(
                self._last_finish.get(h.members, 0.0), finishes[i])
            self._wait_s.observe(h.started - h.at)
        self.now = max(self.now, max(finishes))
        self._completed.inc(len(batch))
        self._batches.inc()
        if tr is not None:
            for i, h in enumerate(batch):
                lb = labels[i]
                if h.started > h.at:
                    tr.span(PID_PROGRAMS, lb, "queued", h.at, h.started,
                            {"reason": "release+deps"})

                def _span(lb=lb, h=h, prog=programs[i],
                          pr=(prios[i] if isinstance(prios[i], float)
                              else prios[i][0]),
                          t0=h.started, t1=h.finished):
                    # isolated (contention-free) makespan of this handle's
                    # program = the plan's predicted cost; the gap to
                    # measured is what obs.feedback aggregates.  Deferred:
                    # the extra simulation runs at trace-read time, not on
                    # the engine's critical path.
                    pred = max(simulate_rounds(prog, topo).values())
                    tr.span(PID_PROGRAMS, lb, h.op, t0, t1,
                            {"op": h.op, "nbytes": h.nbytes,
                             "members": len(h.members),
                             "priority": pr,
                             "predicted_s": pred,
                             "measured_s": t1 - t0})

                tr.defer_record(_span)
            tr.instant(PID_PROGRAMS, "engine", f"flush {self._last_policy}",
                       self.now, {"policy": self._last_policy,
                                  "batch": len(batch)})
        if self.monitor is not None:
            self.monitor.observe_handles(batch)
        return batch

    def refresh_plans(self) -> None:
        """Propagate a topology refit to every cached plan surface.

        ``FeedbackLoop.maybe_refit`` / ``Communicator.refresh`` replace
        ``comm.topo`` and invalidate the *main* communicator's plan cache,
        but the engine's per-subset communicators still point at the old
        topology object.  This re-points them and invalidates their
        caches, so the next flush re-runs every argmin under the refit
        costs — the health monitor calls it after each mid-run refit."""
        self.comm._cache.invalidate()
        for sub in self._subcomms.values():
            sub.topo = self.comm.topo
            sub._cache.invalidate()

    # -- elasticity ------------------------------------------------------ #
    def repair(self, failed: Sequence[int]):
        """Compose with :meth:`Communicator.repair`: shrink the member set
        and splice cached plans, then reconcile in-flight handles.

        Already-resolved handles DRAIN — their results stand (the traffic
        completed before the failure was acted on).  Pending handles are
        RE-ISSUED on the repaired plans: dead ranks leave their member
        sets, a dead root is replaced by the first survivor, and the next
        flush plans over the spliced trees.  Returns the communicator's
        :class:`~repro_torch.core.RepairReport`.

        Atomic: a pending handle whose members ALL died makes the whole
        call raise BEFORE anything — communicator, subcomms, or other
        handles — is touched.
        """
        dead = set(failed) & set(self.comm.members)
        for h in self._pending:
            if h.members and not set(h.members) - dead:
                raise ValueError(
                    f"handle #{h.hid} would lose every member to the "
                    f"failure; cancel it before repairing")
        report = self.comm.repair(failed)
        dead = set(report.failed)
        for mem, sub in list(self._subcomms.items()):
            if set(mem) & dead:
                del self._subcomms[mem]
                survivors = tuple(m for m in mem if m not in dead)
                if survivors:
                    sub.repair(failed)
                    self._subcomms[survivors] = sub
        for key in list(self._last_finish):
            if set(key) & dead:
                survivors = tuple(m for m in key if m not in dead)
                t = self._last_finish.pop(key)
                if survivors:
                    self._last_finish[survivors] = max(
                        self._last_finish.get(survivors, 0.0), t)
        for h in self._pending:
            if not set(h.members) & dead:
                continue
            survivors = tuple(m for m in h.members if m not in dead)
            h.members = survivors
            if h.root not in survivors:
                h.root = survivors[0]
            self._replanned.inc()
        return report

    # -- introspection --------------------------------------------------- #
    def stats(self) -> EngineStats:
        return EngineStats(self._issued.value, self._completed.value,
                           self._batches.value, self._replanned.value,
                           self._last_policy, self.now)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Engine(policy={self.policy!r}, pending="
                f"{len(self._pending)}, now={self.now:.6f})")


def _sjf_order(batch: list[Handle], depsets: list[set[int]]) -> list[int]:
    """Shortest-job-first order that respects the dependency sets (a small
    collective may jump a fat one, never its own member-set predecessor)."""
    placed: set[int] = set()
    order: list[int] = []
    while len(order) < len(batch):
        ready = [i for i in range(len(batch)) if i not in placed
                 and depsets[i] <= placed]
        nxt = min(ready, key=lambda i: (batch[i].nbytes, i))
        order.append(nxt)
        placed.add(nxt)
    return order


# ---------------------------------------------------------------------- #
# Gradient bucketing: size-targeted buckets in reverse-layer order.
# ---------------------------------------------------------------------- #

def partition_buckets(sizes: Sequence[float], bucket_bytes: float,
                      reverse: bool = True) -> list[list[int]]:
    """Greedy partition of per-item byte sizes into buckets of at least
    ``bucket_bytes`` (the last bucket may be smaller).  ``reverse`` walks
    items back-to-front — gradient availability order under backward.
    Returns index lists in emission order."""
    if bucket_bytes <= 0:
        raise ValueError("bucket_bytes must be positive")
    order = range(len(sizes) - 1, -1, -1) if reverse else range(len(sizes))
    buckets: list[list[int]] = []
    cur: list[int] = []
    acc = 0.0
    for i in order:
        cur.append(i)
        acc += sizes[i]
        if acc >= bucket_bytes:
            buckets.append(cur)
            cur, acc = [], 0.0
    if cur:
        buckets.append(cur)
    return buckets


def overlapped_step_times(comm: Communicator,
                          layer_bytes: Sequence[float],
                          layer_compute_s: Sequence[float],
                          *, bucket_bytes: float,
                          policy: str = "fifo") -> dict:
    """Price one training step's gradient sync, serial vs overlapped.

    Backward visits layers last-to-first; layer i's compute takes
    ``layer_compute_s[i]`` and yields ``layer_bytes[i]`` of gradient.
    *Serial* runs the full backward then ONE monolithic all-reduce of every
    byte.  *Overlapped* partitions gradients into size-targeted buckets
    (:func:`partition_buckets`) and issues each bucket's all-reduce through
    an :class:`Engine` the moment its last layer's backward finishes — the
    sync of layer k overlaps the backward of the layers below it.

    Returns a dict with ``serial_s``, ``overlapped_s``, ``speedup``,
    ``overlap_efficiency`` (fraction of the ideal ``min(compute, comm)``
    hiding actually achieved), bucket count and the engine used.
    """
    if len(layer_bytes) != len(layer_compute_s):
        raise ValueError("layer_bytes and layer_compute_s must align")
    total_bytes = float(sum(layer_bytes))
    compute_s = float(sum(layer_compute_s))
    comm_serial_s = comm.allreduce(total_bytes).time
    serial_s = compute_s + comm_serial_s

    buckets = partition_buckets(layer_bytes, bucket_bytes)
    eng = Engine(comm, policy=policy)
    handles = []
    t = 0.0
    done_at = [0.0] * len(layer_bytes)
    for i in range(len(layer_bytes) - 1, -1, -1):
        t += layer_compute_s[i]
        done_at[i] = t
    for idx in buckets:
        nb = float(sum(layer_bytes[i] for i in idx))
        ready = max(done_at[i] for i in idx)
        handles.append(eng.issue("allreduce", nb, at=ready))
    eng.wait_all()
    overlapped_s = max([compute_s] + [h.finished for h in handles])
    hidden = serial_s - overlapped_s
    ideal = min(compute_s, comm_serial_s)
    return {
        "total_bytes": total_bytes,
        "bucket_bytes": float(bucket_bytes),
        "n_buckets": len(buckets),
        "compute_s": compute_s,
        "comm_serial_s": comm_serial_s,
        "serial_s": serial_s,
        "overlapped_s": overlapped_s,
        "speedup": serial_s / overlapped_s,
        "overlap_efficiency": (hidden / ideal) if ideal > 0 else 0.0,
        "engine": eng,
    }
