"""Low-overhead span/event recorder with Chrome trace-event export.

One :class:`Tracer` instance collects everything a run observes — per-link
busy intervals from the simulators, per-handle lifecycle spans from the
async engine, per-request lifecycle spans from the serving scheduler, and
wall-clock planner instants from :meth:`Communicator.plan` — and exports a
single Chrome/Perfetto trace-event JSON (open in ``chrome://tracing`` or
https://ui.perfetto.dev).

Hot-path discipline, two tiers: (1) the simulators pay NOTHING per event
on a live run — they queue a deterministic replay closure
(:meth:`Tracer.defer_record`) and the actual events are produced by
re-executing the program once, when the trace is first read; (2) inline
recording (the replay path, and ``Tracer(defer=False)``) is a bare tuple
append — no dicts, no string formatting, no timestamp conversion.  All
shaping (track assignment, microsecond conversion, metadata events,
deterministic sort) happens once, at export.  This is what keeps traced
simulation within the <5% overhead budget asserted by
``benchmarks/bench_obs.py``.

Track layout (Chrome ``pid``/``tid``):

* pid ``PID_LINKS``    — one tid per directed edge ``src->dst``; "X" spans
  are link-busy intervals (args: bytes, level, kind, first).
* pid ``PID_PROGRAMS`` — one tid per collective program / engine handle;
  "X" spans queue→dispatch→complete, "i" instants for policy decisions and
  critical paths.
* pid ``PID_REQUESTS`` — one tid per serving request; "X" spans for
  WAITING/PREFILL/DECODE, "i" instants for shed/evict.
* pid ``PID_PLANNER``  — wall-clock planner track (cache hit/miss instants
  with the selected algorithm × segment and predicted cost).

All simulated tracks share the virtual clock (seconds, converted to µs at
export); the planner track uses wall-clock µs since tracer creation.  The
two never share a pid, so mixed units cannot mislead within one track.
"""
from __future__ import annotations

import json
import time

__all__ = [
    "Tracer",
    "PID_LINKS",
    "PID_PROGRAMS",
    "PID_REQUESTS",
    "PID_PLANNER",
]

PID_LINKS = 1
PID_PROGRAMS = 2
PID_REQUESTS = 3
PID_PLANNER = 4

_PROCESS_NAMES = {
    PID_LINKS: "network links (virtual time)",
    PID_PROGRAMS: "collectives / engine handles (virtual time)",
    PID_REQUESTS: "serving requests (virtual time)",
    PID_PLANNER: "planner (wall clock)",
}


class Tracer:
    """Append-only event sink.  One instance per run; pass it as the
    ``tracer=`` keyword down through Communicator → Engine → simulator →
    Scheduler and call :meth:`to_chrome` / :meth:`save` at the end."""

    def __init__(self, defer: bool = True):
        # (src, dst, level, t0, t1, nbytes, kind, first, label,
        #  flow_end, gid) — t1 is the delivery time (latency tail included
        # for `first` sends); flow_end is when the payload stopped flowing
        # on the link (t1 minus the latency tail); gid names the simulator
        # invocation the interval shared bandwidth within, so contention
        # analysis never couples transfers that were priced independently
        self.links: list[tuple] = []
        # (pid, key, name, t0, t1, args_or_None)
        self.spans: list[tuple] = []
        # (pid, key, name, t, args_or_None)
        self.instants: list[tuple] = []
        # (name, value) monotonic tallies surfaced as trace metadata
        self.counters: dict[str, float] = {}
        # With ``defer`` (the default) the simulators record NOTHING on
        # their hot paths: they queue a zero-arg replay closure via
        # :meth:`defer_record` and the deterministic re-execution happens
        # once, here, when the trace is first read.  ``defer=False``
        # forces inline recording (what the replay closures themselves
        # use, and what the overhead benchmark compares against).
        self.defer = defer
        self._pending: list = []
        self._group = 0
        self._wall0 = time.perf_counter()

    # -------------------------------------------------------------- #
    # recording (hot path)
    # -------------------------------------------------------------- #

    def link(self, src: int, dst: int, level: int, t0: float, t1: float,
             nbytes: float, kind: str, first: bool, label=None,
             flow_end: float | None = None, gid: int | None = None) -> None:
        """One busy interval on the directed edge src->dst (virtual time).

        ``flow_end`` is when the payload stopped occupying the link
        (default: ``t1``, i.e. no latency tail); ``gid`` is the sharing
        group (default: a fresh group, i.e. the interval contended with
        nothing — the simulators pass :meth:`group` so every transfer of
        one invocation lands in the same group)."""
        self.links.append((src, dst, level, t0, t1, nbytes, kind, first,
                           label, t1 if flow_end is None else flow_end,
                           self.group() if gid is None else gid))

    def group(self) -> int:
        """A fresh bandwidth-sharing group id.  Each simulator invocation
        grabs one and stamps it on every link interval it records; only
        intervals in the same group ever shared a link's bandwidth."""
        self._group += 1
        return self._group

    def span(self, pid: int, key, name: str, t0: float, t1: float,
             args=None) -> None:
        """A complete [t0, t1] span on track ``key`` of process ``pid``."""
        self.spans.append((pid, key, name, t0, t1, args))

    def instant(self, pid: int, key, name: str, t: float, args=None) -> None:
        self.instants.append((pid, key, name, t, args))

    def wall(self) -> float:
        """Seconds since tracer creation — timestamps for PID_PLANNER."""
        return time.perf_counter() - self._wall0

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def defer_record(self, fn) -> None:
        """Queue a zero-arg closure that records into this tracer when the
        trace is first read (any export / analysis accessor).  The
        simulators are deterministic, so replaying a program later yields
        the exact events inline recording would have — at zero cost to the
        live run."""
        self._pending.append(fn)

    def _materialize(self) -> None:
        if not self._pending:
            return
        was, self.defer = self.defer, False  # replays record inline
        try:
            while self._pending:
                fns, self._pending = self._pending, []
                for fn in fns:
                    fn()
        finally:
            self.defer = was

    def n_events(self) -> int:
        """Total recorded events (links + spans + instants)."""
        self._materialize()
        return len(self.links) + len(self.spans) + len(self.instants)

    # -------------------------------------------------------------- #
    # export
    # -------------------------------------------------------------- #

    def to_chrome(self) -> dict:
        """Shape the raw tuples into a Chrome trace-event document.

        Deterministic: tids are assigned in sorted track-name order per
        pid, and events are emitted sorted by (pid, tid, ts, name), so the
        same schedule always serialises to the same JSON — what the trace
        tests round-trip and diff against.
        """
        self._materialize()
        events: list[dict] = []
        tids: dict[tuple, int] = {}
        names: dict[tuple, str] = {}

        def tid_of(pid: int, track_name: str) -> int:
            k = (pid, track_name)
            t = tids.get(k)
            if t is None:
                t = len([1 for (p, _) in tids if p == pid]) + 1
                tids[k] = t
                names[k] = track_name
            return t

        # Pre-register link tracks in sorted edge order so tids are stable
        # regardless of schedule interleaving.
        for e in sorted({(s, d) for (s, d, *_ ) in self.links}):
            tid_of(PID_LINKS, f"{e[0]}->{e[1]}")
        for pid, key, *_ in sorted(self.spans, key=lambda r: (r[0], str(r[1]))):
            tid_of(pid, str(key))
        for pid, key, *_ in sorted(self.instants,
                                   key=lambda r: (r[0], str(r[1]))):
            tid_of(pid, str(key))

        for (src, dst, level, t0, t1, nbytes, kind, first, label,
             _fe, _gid) in self.links:
            args = {"bytes": nbytes, "level": level, "kind": kind,
                    "first": bool(first)}
            if label is not None:
                args["program"] = label
            events.append({
                "name": f"{kind} {int(nbytes)}B",
                "ph": "X", "pid": PID_LINKS,
                "tid": tids[(PID_LINKS, f"{src}->{dst}")],
                "ts": t0 * 1e6, "dur": max(t1 - t0, 0.0) * 1e6,
                "cat": "link", "args": args,
            })
        for (pid, key, name, t0, t1, args) in self.spans:
            ev = {"name": name, "ph": "X", "pid": pid,
                  "tid": tids[(pid, str(key))],
                  "ts": t0 * 1e6, "dur": max(t1 - t0, 0.0) * 1e6,
                  "cat": "span"}
            if args:
                ev["args"] = args
            events.append(ev)
        for (pid, key, name, t, args) in self.instants:
            ev = {"name": name, "ph": "i", "pid": pid,
                  "tid": tids[(pid, str(key))],
                  "ts": t * 1e6, "s": "t", "cat": "instant"}
            if args:
                ev["args"] = args
            events.append(ev)

        events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"], e["name"]))

        meta: list[dict] = []
        for pid in sorted({p for (p, _) in tids}):
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0,
                         "args": {"name": _PROCESS_NAMES.get(pid,
                                                             f"pid {pid}")}})
        for (pid, track_name), t in sorted(tids.items(),
                                           key=lambda kv: (kv[0][0], kv[1])):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": t, "args": {"name": track_name}})

        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if self.counters:
            doc["otherData"] = {"counters": dict(sorted(self.counters.items()))}
        return doc

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)

    # -------------------------------------------------------------- #
    # analysis helpers (used by feedback + benchmarks)
    # -------------------------------------------------------------- #

    def link_samples(self) -> list[tuple]:
        """(src, dst, level, duration_s, nbytes, first) per interval — the
        raw material ``obs.feedback`` turns into per-link-class
        residuals.  Durations are as traced: stretched by contention when
        the run was concurrent (``obs.contention.deconvolve`` undoes
        that)."""
        self._materialize()
        return [(src, dst, level, t1 - t0, nbytes, first)
                for (src, dst, level, t0, t1, nbytes, _k, first, _lb,
                     _fe, _gid)
                in self.links]

    def link_records(self) -> list[tuple]:
        """The raw link tuples (see ``__init__`` for the layout), with any
        deferred replays materialized — what ``obs.contention`` consumes."""
        self._materialize()
        return self.links

    def busy_by_level(self) -> dict[int, float]:
        """Total busy seconds per link class — the quick 'which stratum was
        the bottleneck' readout."""
        self._materialize()
        out: dict[int, float] = {}
        for (_s, _d, level, t0, t1, *_rest) in self.links:
            out[level] = out.get(level, 0.0) + (t1 - t0)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Tracer(links={len(self.links)}, spans={len(self.spans)}, "
                f"instants={len(self.instants)})")
