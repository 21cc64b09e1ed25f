"""Closed loop: measured collective durations feed the plan selector.

The Fast-Tuning idea (cs/0408034) applied to this stack: the communicator
selects trees by an a-priori postal model, but every *traced* execution
yields per-link measured durations.  :class:`FeedbackLoop` aggregates those
into per-link-class residuals (measured vs modeled transfer time) and,
when a class has drifted past a threshold, refits the communicator's
:class:`~repro_torch.core.topology.Level` parameters — through the SAME
:func:`repro_torch.core.discovery.refit_levels` path that targeted re-probing
uses (via :func:`~repro_torch.core.discovery.synthetic_probes`), so there is one
writer of level parameters no matter where the evidence came from.  After
a refit the plan cache is invalidated and the next ``plan()`` re-runs its
argmin under costs that track observed reality: the regret of the selected
plan against the best plan *on the true network* drops (asserted by the
JAX package's ``tests/test_obs.py``; ``tests/test_torch_monitor.py`` holds
this copy equal to it).

Two feeding modes:

* :meth:`run` — execute one collective of the communicator's choosing on a
  ``truth`` topology (the simulation stand-in for the real network) and
  harvest its trace.  This is what the regression tests drive.
* :meth:`observe_trace` / :meth:`observe` — ingest link intervals from any
  tracer (e.g. one threaded through an engine or scheduler run), or a
  single wall-clock measurement, for callers that already have traffic.

The ``truth`` topology must share coordinates with the model (parameters
may differ arbitrarily) — the same restriction :meth:`Communicator.refresh`
carries: feedback corrects link *costs*, not cluster membership.

A copy of ``repro/obs/feedback.py``.
"""
from __future__ import annotations

import dataclasses

from ..core import discovery as D
from ..core.costmodel import link_affine_fit
from ..core.simulator import simulate_rounds
from . import contention
from .trace import Tracer

__all__ = ["FeedbackLoop", "FeedbackReport"]


@dataclasses.dataclass(frozen=True)
class FeedbackReport:
    """Outcome of one :meth:`FeedbackLoop.maybe_refit` call.

    ``drift`` maps link-class index -> mean measured/modeled transfer-time
    ratio (1.0 = the model matches); ``worst`` is the largest |ratio - 1|;
    ``fits`` holds the (latency, bandwidth, overhead) applied per refitted
    class (empty when ``refit`` is False); ``n_samples`` the evidence
    count per class.
    """

    refit: bool
    drift: dict[int, float]
    worst: float
    fits: dict[int, tuple[float, float, float]]
    n_samples: dict[int, int]


class FeedbackLoop:
    """Aggregate measured link durations against a communicator's model
    and refit drifted link classes.  See module docstring."""

    def __init__(self, comm, *, threshold: float = 0.15,
                 min_samples: int = 4):
        if comm.view is not None:
            # same reasoning as Communicator.refresh: a view's levels came
            # from an unknown transform; refitting the true topology alone
            # would leave tree construction on stale costs
            raise ValueError("feedback is not supported on a view-based "
                             "communicator")
        if threshold <= 0:
            raise ValueError("threshold must be positive")
        self.comm = comm
        self.threshold = threshold
        self.min_samples = min_samples
        # link class -> [(nbytes, measured_s, first), ...]
        self._samples: dict[int, list[tuple[float, float, bool]]] = {}
        self.refits = 0

    # -- feeding ------------------------------------------------------- #
    def observe(self, level: int, nbytes: float, seconds: float,
                first: bool = True) -> None:
        """One measured transfer on link class ``level``: ``seconds`` is
        the delivery time of ``nbytes`` (latency included when ``first``,
        pure streaming otherwise)."""
        self._samples.setdefault(level, []).append(
            (float(nbytes), float(seconds), bool(first)))

    def observe_trace(self, tracer: Tracer, *,
                      deconvolve: bool = True) -> int:
        """Ingest every link interval a tracer recorded; returns the
        number of samples taken.

        ``deconvolve`` (default) scales each interval back to its
        isolated-equivalent duration via
        :func:`repro_torch.obs.contention.deconvolve`, so traces from the
        concurrent engine yield unbiased residuals.  It is a no-op on
        uncontended traces (lone collectives price identically either
        way); pass ``False`` only to study the contention bias itself.
        """
        rows = (contention.deconvolve(tracer) if deconvolve
                else tracer.link_samples())
        n = 0
        for _src, _dst, level, dt, nbytes, first in rows:
            self.observe(level, nbytes, dt, first)
            n += 1
        return n

    def run(self, op: str, nbytes: float, *, root: int | None = None,
            truth=None) -> tuple[float, float]:
        """Plan ``op`` with the communicator's model, execute it on the
        ``truth`` topology (default: the model itself — a no-drift
        control), harvest the traced link samples, and return
        ``(predicted_s, measured_s)``."""
        truth = self.comm.topo if truth is None else truth
        if truth.nprocs != self.comm.topo.nprocs:
            raise ValueError("truth topology has a different rank count")
        root = self.comm.members[0] if root is None else root
        plan = self.comm.plan(op, root=root, nbytes=nbytes)
        low = plan.lower(nbytes)
        predicted = max(simulate_rounds(low, self.comm.topo).values())
        tr = Tracer()
        measured = max(simulate_rounds(low, truth, tracer=tr,
                                       label=f"feedback:{op}").values())
        self.observe_trace(tr)
        return predicted, measured

    # -- reading -------------------------------------------------------- #
    def _model_time(self, level: int, nbytes: float, first: bool) -> float:
        lvl = self.comm.topo.levels[level]
        return (lvl.latency if first else 0.0) + nbytes / lvl.bandwidth

    def drift(self) -> dict[int, float]:
        """Per link class: mean measured / modeled transfer-time ratio
        over every recorded sample (total-time ratio, so the large
        bandwidth-bound transfers dominate exactly as they dominate the
        makespan the planner mispredicts)."""
        out: dict[int, float] = {}
        for level, rows in sorted(self._samples.items()):
            model = sum(self._model_time(level, n, f) for n, _, f in rows)
            meas = sum(t for _, t, _ in rows)
            if model > 0:
                out[level] = meas / model
        return out

    def n_samples(self) -> dict[int, int]:
        return {lvl: len(rows) for lvl, rows in sorted(self._samples.items())}

    def residual_table(self) -> list[dict]:
        """One row per observed link class, before/after a refit."""
        drift = self.drift()
        return [{"level": lvl,
                 "name": self.comm.topo.levels[lvl].name,
                 "n_samples": len(rows),
                 "measured_over_model": drift.get(lvl, float("nan"))}
                for lvl, rows in sorted(self._samples.items())]

    # -- acting --------------------------------------------------------- #
    def maybe_refit(self) -> FeedbackReport:
        """Refit every sufficiently-evidenced link class when the worst
        per-class drift exceeds the threshold.

        On refit: per-class (latency, bandwidth) come from
        :func:`~repro_torch.core.costmodel.link_affine_fit` over that class's
        samples (overhead is kept — delivery intervals cannot observe
        sender CPU cost), rendered into synthetic probes and applied via
        :func:`~repro_torch.core.discovery.refit_levels`; the communicator's
        plan cache is invalidated (counters stay) and the sample buffer
        resets so post-refit evidence is judged against the NEW model.
        """
        drift = self.drift()
        eligible = {lvl: rows for lvl, rows in self._samples.items()
                    if len(rows) >= self.min_samples and lvl in drift}
        worst = max((abs(drift[lvl] - 1.0) for lvl in eligible),
                    default=0.0)
        counts = self.n_samples()
        if worst <= self.threshold:
            return FeedbackReport(False, drift, worst, {}, counts)
        fits: dict[int, tuple[float, float, float]] = {}
        for lvl, rows in sorted(eligible.items()):
            old = self.comm.topo.levels[lvl]
            lat, bw = link_affine_fit(rows, fallback_latency=old.latency)
            fits[lvl] = (lat, bw, old.overhead)
        probes = D.synthetic_probes(self.comm.topo, fits)
        self.comm.topo = D.refit_levels(self.comm.topo, probes)
        self.comm._cache.invalidate()  # stale costs; stats/counters stay
        self._samples.clear()
        self.refits += 1
        return FeedbackReport(True, drift, worst, fits, counts)
