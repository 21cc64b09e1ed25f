"""Online health monitoring: the closed control loop under production load.

The :class:`~repro_torch.obs.feedback.FeedbackLoop` is passive — something
must notice drift and decide to act.  :class:`HealthMonitor` is that
something, wired into a live serving run:

* **Rolling-window SLO tracking** — TTFT/TPOT p50/p95/p99, shed/evict
  rates over the last ``window`` finished requests (fed by the
  :class:`~repro_torch.serving.scheduler.Scheduler`).
* **Per-rank straggler scoring** — every resolved engine batch reports
  each handle's ``measured_s`` against its isolated (contention-free)
  ``predicted_s``; the inflation is EWMA-attributed to the handle's
  member ranks, so a rank that keeps appearing in slow collectives while
  its peers do not floats to the top.
* **Drift detection and auto-refit** — traced link intervals are drained
  each check, deconvolved (:mod:`repro_torch.obs.contention`) to
  isolated-equivalent durations, and aggregated into per-link-class
  residual ratios smoothed by an EWMA.  A class past ``threshold``
  triggers either a *targeted re-probe* — ``probe(pairs)`` over
  :func:`~repro_torch.core.discovery.representative_pairs` scoped to the
  implicated class, applied via :meth:`Communicator.refresh` — or, with
  no probe path, a passive refit feeding the windowed residuals through
  :meth:`FeedbackLoop.maybe_refit`.  Either way ``refit_levels`` stays
  the only writer of level parameters, every plan cache (main communicator
  AND the engine's per-subset communicators) is invalidated mid-run via
  :meth:`Engine.refresh_plans`, and the residual windows reset so
  post-refit evidence is judged against the new model.

The monitor owns no thread: the scheduler calls :meth:`on_step` once per
step and every ``check_every`` steps the detectors run inline — all on
the run's virtual clock, so behaviour is deterministic and testable.

A copy of ``repro/obs/monitor.py``.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from ..core import discovery as D
from ..core.simulator import simulate_rounds
from . import contention
from .feedback import FeedbackLoop, FeedbackReport
from .log import get_logger
from .metrics import MetricsRegistry, percentile
from .trace import Tracer

__all__ = ["HealthMonitor", "HealthEvent"]


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One detector firing: ``kind`` is ``"drift"`` (a link class left its
    model), ``"refit"`` (level parameters were rewritten and plan caches
    invalidated), or ``"straggler"`` (a rank's inflation score crossed the
    flagging rule).  ``step``/``now`` locate it on the run's clock."""

    kind: str
    step: int
    now: float
    detail: dict

    def to_dict(self) -> dict:
        return {"kind": self.kind, "step": self.step, "now": self.now,
                **self.detail}


class HealthMonitor:
    """See module docstring.

    ``engine=`` attaches to a live :class:`~repro_torch.core.engine.Engine`
    (installing a private :class:`Tracer` if it has none — the monitor
    then drains and discards trace records to stay memory-bounded; a
    caller-owned tracer is only read, via a cursor).  ``probe`` is an
    optional callable ``pairs -> TargetedProbes`` (e.g. wrapping
    :func:`~repro_torch.core.discovery.targeted_probes` against the real
    network); without it, drift is corrected passively from the windowed
    residuals.  ``refit=False`` makes the monitor observe-only.
    """

    def __init__(self, comm=None, *, engine=None, window: int = 512,
                 threshold: float = 0.25, ewma_alpha: float = 0.5,
                 min_samples: int = 8, check_every: int = 8,
                 straggler_factor: float = 2.0, probe=None,
                 refit: bool = True, tracer=None,
                 metrics: MetricsRegistry | None = None,
                 log_every: int = 0):
        if threshold <= 0:
            raise ValueError("threshold must be positive")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if window <= 0 or check_every <= 0:
            raise ValueError("window and check_every must be positive")
        self.engine = engine
        self._own_tracer = False
        if engine is not None:
            if comm is None:
                comm = engine.comm
            elif comm is not engine.comm:
                raise ValueError("comm and engine.comm disagree; pass one")
            engine.monitor = self
            if engine.tracer is None:
                engine.tracer = Tracer()
                self._own_tracer = True
            tracer = engine.tracer
        if comm is None:
            raise ValueError("HealthMonitor needs a communicator or engine")
        if (refit or probe is not None) and comm.view is not None:
            raise ValueError("auto-refit is not supported on a view-based "
                             "communicator (same rule as FeedbackLoop)")
        self.comm = comm
        self.tracer = tracer
        self.window = window
        self.threshold = threshold
        self.ewma_alpha = ewma_alpha
        self.min_samples = min_samples
        self.check_every = check_every
        self.straggler_factor = straggler_factor
        self.probe = probe
        self.refit = refit
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.log = get_logger("monitor")
        self.log_every = log_every
        self.events: deque[HealthEvent] = deque(maxlen=256)

        # rolling request window
        self._ttft: deque[float] = deque(maxlen=window)
        self._tpot: deque[float] = deque(maxlen=window)
        self._outcomes: deque[int] = deque(maxlen=window)  # 1 = shed
        self._done = 0
        self._shed = 0
        self._evicted = 0

        # per-link-class residual window + EWMA
        self._res: dict[int, deque] = {}
        self._ewma: dict[int, float] = {}
        self._alarmed: set[int] = set()
        self._util: dict[int, dict] = {}
        self._cursor = 0
        self._last_drain_now: float | None = None

        # per-rank straggler EWMA + predicted-makespan memo
        self._rank_score: dict[int, float] = {}
        self._flagged: set[int] = set()
        self._pred: dict[tuple, float] = {}
        self._topo_ref = comm.topo

        self._step = 0
        self._now = 0.0
        self._steps_seen = 0
        self._m_checks = self.metrics.counter("monitor.checks")
        self._m_refits = self.metrics.counter("monitor.refits")
        self._m_events = self.metrics.counter("monitor.events")
        self._m_worst = self.metrics.gauge("monitor.worst_drift")
        self._m_stragglers = self.metrics.gauge("monitor.stragglers")
        self.refits = 0

    # -- feeding ------------------------------------------------------- #
    def observe_request(self, req, *, evicted: bool = False) -> None:
        """One finished (DONE or SHED) request enters the rolling window.
        Duck-typed on the :class:`~repro_torch.serving.loadgen.Request` surface
        (``state``/``ttft``/``tpot``) so obs stays below serving."""
        state = getattr(getattr(req, "state", None), "name", "")
        if state == "SHED":
            self._outcomes.append(1)
            self._shed += 1
            if evicted:
                self._evicted += 1
            return
        self._outcomes.append(0)
        self._done += 1
        ttft = getattr(req, "ttft", None)
        tpot = getattr(req, "tpot", None)
        if ttft is not None:
            self._ttft.append(float(ttft))
        if tpot is not None:
            self._tpot.append(float(tpot))

    def observe_handles(self, handles) -> None:
        """One resolved engine batch: attribute each handle's
        measured-over-predicted inflation to its member ranks (EWMA)."""
        a = self.ewma_alpha
        for h in handles:
            if h.started is None or h.finished is None:
                continue
            pred = self._predicted(h)
            if pred <= 0.0:
                continue
            infl = (h.finished - h.started) / pred
            for r in h.members:
                cur = self._rank_score.get(r)
                self._rank_score[r] = infl if cur is None \
                    else a * infl + (1.0 - a) * cur

    def _predicted(self, h) -> float:
        """Isolated (contention-free) makespan of a handle's program on
        the current model — memoized per (op, root, nbytes, members) and
        flushed whenever the topology object changes (refit/repair)."""
        topo = self.comm.topo
        if self._topo_ref is not topo:
            self._pred.clear()
            self._topo_ref = topo
        key = (h.op, h.root, float(h.nbytes), tuple(h.members))
        pred = self._pred.get(key)
        if pred is None:
            comm = (self.engine._comm_for(tuple(h.members))
                    if self.engine is not None else self.comm)
            prog = comm.plan(h.op, root=h.root, nbytes=h.nbytes) \
                .lower(h.nbytes)
            pred = max(simulate_rounds(prog, topo).values())
            self._pred[key] = pred
        return pred

    # -- stepping ------------------------------------------------------ #
    def on_step(self, now: float, step: int) -> None:
        """Scheduler hook: called once per serving step; runs the
        detectors every ``check_every`` steps."""
        self._now = float(now)
        self._step = int(step)
        self._steps_seen += 1
        if self._steps_seen % self.check_every == 0:
            self.check()

    def check(self) -> list[HealthEvent]:
        """Drain the trace, update residuals/utilization, run the drift
        and straggler detectors, and act (targeted re-probe or passive
        refit + plan-cache invalidation).  Returns the events raised."""
        self._m_checks.inc()
        self._ingest(self._drain())
        events = self._detect_drift()
        events += self._detect_stragglers()
        for ev in events:
            self.events.append(ev)
            self._m_events.inc()
        if self.log_every and self._m_checks.value % self.log_every == 0:
            self._log_snapshot()
        return events

    def _drain(self) -> list[tuple]:
        if self.tracer is None:
            return []
        recs = self.tracer.link_records()
        new = recs[self._cursor:]
        self._cursor = len(recs)
        if self._own_tracer:
            # private tracer: nobody exports it, so drop drained records
            # (and the engine spans nobody will read) to bound memory
            self.tracer.links.clear()
            self.tracer.spans.clear()
            self.tracer.instants.clear()
            self._cursor = 0
        return new

    def _ingest(self, records: list[tuple]) -> None:
        if not records:
            return
        for src, dst, lvl, iso, nb, first in contention.deconvolve(records):
            dq = self._res.get(lvl)
            if dq is None:
                dq = self._res[lvl] = deque(maxlen=self.window)
            dq.append((nb, iso, first))
        now = self._now
        prev = self._last_drain_now
        occ = contention.occupancy(records)
        for lvl, row in occ.items():
            util = self._util.setdefault(
                lvl, {"utilization": 0.0, "mean_overlap": 1.0})
            if prev is not None and now > prev:
                util["utilization"] = row["busy_s"] / (now - prev)
            util["mean_overlap"] = row["mean_overlap"]
        self._last_drain_now = now

    # -- detectors ----------------------------------------------------- #
    def _model_time(self, lvl: int, nbytes: float, first: bool) -> float:
        l = self.comm.topo.levels[lvl]
        return (l.latency if first else 0.0) + nbytes / l.bandwidth

    def drift(self) -> dict[int, float]:
        """Per link class: the EWMA-smoothed windowed residual ratio
        (measured-isolated-equivalent over modeled total time; 1.0 = the
        model matches)."""
        return dict(sorted(self._ewma.items()))

    def _detect_drift(self) -> list[HealthEvent]:
        worst = 0.0
        drifted: set[int] = set()
        events: list[HealthEvent] = []
        levels = self.comm.topo.levels
        for lvl, dq in sorted(self._res.items()):
            if not dq:
                continue
            model = sum(self._model_time(lvl, nb, first)
                        for nb, _, first in dq)
            if model <= 0.0:
                continue
            ratio = sum(iso for _, iso, _ in dq) / model
            prev = self._ewma.get(lvl)
            ew = ratio if prev is None \
                else self.ewma_alpha * ratio \
                + (1.0 - self.ewma_alpha) * prev
            self._ewma[lvl] = ew
            self.metrics.gauge(f"monitor.drift.{levels[lvl].name}").set(ew)
            dev = abs(ew - 1.0)
            if len(dq) < self.min_samples:
                continue
            worst = max(worst, dev)
            if dev > self.threshold:
                drifted.add(lvl)
                if lvl not in self._alarmed:
                    self._alarmed.add(lvl)
                    events.append(HealthEvent(
                        "drift", self._step, self._now,
                        {"level": lvl, "name": levels[lvl].name,
                         "ratio": ew, "n_samples": len(dq)}))
            else:
                self._alarmed.discard(lvl)
        self._m_worst.set(worst)
        if drifted:
            ev = self._act_on_drift(drifted)
            if ev is not None:
                events.append(ev)
        return events

    def _act_on_drift(self, drifted: set[int]) -> HealthEvent | None:
        if self.probe is None and not self.refit:
            return None
        before = self.comm.topo
        detail: dict = {"levels": sorted(drifted)}
        if self.probe is not None:
            # targeted re-probe, scoped to the implicated link classes
            pairs = [p for p in D.representative_pairs(
                self.comm.topo, self.comm.members) if p[2] in drifted]
            probes = self.probe(pairs) if pairs else None
            if probes is not None:
                # the detector already decided; refresh at half threshold
                # so a genuine probe confirmation is never shrugged off
                self.comm.refresh(probes, threshold=self.threshold / 2.0)
                detail["via"] = "probe"
                detail["n_pairs"] = len(pairs)
        else:
            report = self._refit_from_window()
            detail["via"] = "feedback"
            detail["worst"] = report.worst
            detail["fits"] = {lvl: list(fit)
                              for lvl, fit in sorted(report.fits.items())}
        if self.comm.topo is before:
            return None  # probe/refit declined: evidence did not confirm
        if self.engine is not None:
            self.engine.refresh_plans()
        self._pred.clear()
        self._topo_ref = self.comm.topo
        # post-refit evidence is judged against the NEW model
        self._res.clear()
        self._ewma.clear()
        self._alarmed.clear()
        self.refits += 1
        self._m_refits.inc()
        return HealthEvent("refit", self._step, self._now, detail)

    def _refit_from_window(self) -> FeedbackReport:
        fb = FeedbackLoop(self.comm, threshold=self.threshold,
                          min_samples=self.min_samples)
        for lvl, dq in sorted(self._res.items()):
            for nb, iso, first in dq:
                fb.observe(lvl, nb, iso, first)
        return fb.maybe_refit()

    def stragglers(self) -> dict[int, float]:
        """Per-rank inflation scores (EWMA of measured/predicted over the
        handles the rank participated in), highest first."""
        return dict(sorted(self._rank_score.items(),
                           key=lambda kv: -kv[1]))

    def _detect_stragglers(self) -> list[HealthEvent]:
        scores = self._rank_score
        events: list[HealthEvent] = []
        if len(scores) >= 2:
            med = percentile(scores.values(), 50)
            for r, s in sorted(scores.items()):
                is_straggler = s > self.straggler_factor * med and s > 1.25
                if is_straggler and r not in self._flagged:
                    self._flagged.add(r)
                    events.append(HealthEvent(
                        "straggler", self._step, self._now,
                        {"rank": r, "score": s, "median": med}))
                elif not is_straggler:
                    self._flagged.discard(r)
        self._m_stragglers.set(len(self._flagged))
        return events

    # -- reading ------------------------------------------------------- #
    def snapshot(self) -> dict:
        """JSON-able state of every detector — what ``serve.py --monitor``
        logs periodically and the bench persists."""
        levels = self.comm.topo.levels
        links = {}
        for lvl in sorted(set(self._res) | set(self._util)):
            dq = self._res.get(lvl, ())
            links[levels[lvl].name] = {
                "ewma_ratio": self._ewma.get(lvl, float("nan")),
                "n_samples": len(dq),
                **self._util.get(lvl, {"utilization": 0.0,
                                       "mean_overlap": 1.0}),
            }
        outcomes = self._outcomes
        flagged = {r: self._rank_score[r] for r in sorted(self._flagged)}
        return {
            "step": self._step,
            "now": self._now,
            "requests": {
                "n_done": self._done,
                "n_shed": self._shed,
                "n_evicted": self._evicted,
                "shed_rate": (sum(outcomes) / len(outcomes)
                              if outcomes else 0.0),
                "ttft": {q: percentile(self._ttft, qv)
                         for q, qv in (("p50", 50), ("p95", 95),
                                       ("p99", 99))},
                "tpot": {q: percentile(self._tpot, qv)
                         for q, qv in (("p50", 50), ("p95", 95),
                                       ("p99", 99))},
            },
            "links": links,
            "stragglers": flagged,
            "worst_drift": self._m_worst.value,
            "refits": self.refits,
            "checks": self._m_checks.value,
            "events": [ev.to_dict() for ev in list(self.events)[-8:]],
        }

    def _log_snapshot(self) -> None:
        s = self.snapshot()
        req = s["requests"]
        self.log.info(
            f"step {s['step']}: ttft p99 {req['ttft']['p99']*1e3:.2f} ms, "
            f"shed rate {req['shed_rate']:.3f}, worst drift "
            f"{s['worst_drift']:.3f}, refits {s['refits']}, "
            f"stragglers {sorted(s['stragglers'])}",
            event="monitor", **{
                "step": s["step"], "now": s["now"],
                "ttft_p99_s": req["ttft"]["p99"],
                "shed_rate": req["shed_rate"],
                "worst_drift": s["worst_drift"],
                "refits": s["refits"],
                "stragglers": sorted(s["stragglers"]),
            })

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"HealthMonitor(window={self.window}, "
                f"threshold={self.threshold}, refits={self.refits}, "
                f"events={len(self.events)})")
