"""Contention deconvolution: isolated-equivalent durations from busy traces.

Under :func:`repro_torch.core.simulator.simulate_concurrent`'s fluid sharing, a
traced link interval is *stretched*: k transfers concurrently active on a
directed edge each flow at ``bandwidth / k``, so the interval covers more
wall (virtual) time than the same bytes would take alone.  Feeding those
stretched durations straight into :class:`repro_torch.obs.FeedbackLoop` biases
every residual upward — the loop would "correct" a perfectly calibrated
model just because the engine was busy, which is exactly when production
traffic is available to learn from.

The fix needs no extra simulator state, only the intervals themselves.
With fair sharing, a transfer's payload obeys

    nbytes = integral over its flow interval of  bandwidth / k(t)  dt

where ``k(t)`` is the number of transfers active on the edge at time t —
and k(t) is fully determined by the *other recorded intervals on the same
edge in the same sharing group*.  Dividing each elementary overlap segment
by its occupancy therefore recovers the isolated streaming time exactly:

    integral of dt / k(t)  =  nbytes / bandwidth

:func:`deconvolve` computes that occupancy-weighted duration per interval
(plus the traced latency tail for ``first`` sends, which never occupied
the link) and returns samples in the exact shape
:meth:`Tracer.link_samples` produces, so
:meth:`FeedbackLoop.observe_trace` can ingest contended engine traffic
and still see unbiased per-link-class residuals.

Exactness, by sharing discipline:

* **Fair sharing** (the "fifo" engine policy): exact per interval, to
  float precision — every active transfer holds precisely ``1/k`` of the
  link.
* **Strict priority / aged priority**: a stalled transfer holds 0, not
  ``1/k``, of the link, so *per-interval* estimates split the overlap
  evenly instead of (full, nothing).  But the link is work-conserving
  (the eligible set always flows at full bandwidth), so the per-edge
  *sums* — and hence the per-link-class aggregate residuals
  :meth:`FeedbackLoop.drift` thresholds — remain exact: the per-interval
  errors cancel pairwise inside each overlap.

Sharing groups: intervals only couple within one simulator invocation
(one ``gid`` — see :meth:`Tracer.group`).  Two engine flushes may overlap
in virtual time on the trace, but the simulator never shared bandwidth
across them, so occupancy is computed per ``(gid, edge)``.  A lone
:func:`~repro_torch.core.simulator.simulate_rounds` program has no self-overlap
on any edge (the sender NIC is FIFO), so deconvolution is a no-op on
exactly the traces the feedback loop already handled — the two feeding
paths agree on uncontended traffic by construction.

A copy of ``repro/obs/contention.py``.
"""
from __future__ import annotations

__all__ = ["deconvolve", "occupancy"]


def _records(trace) -> list[tuple]:
    """Accept a Tracer or a raw list of link tuples."""
    recs = getattr(trace, "link_records", None)
    return recs() if recs is not None else list(trace)


def _groups(links: list[tuple]) -> dict[tuple, list[int]]:
    """Indices of ``links`` grouped by (sharing group, directed edge)."""
    groups: dict[tuple, list[int]] = {}
    for i, rec in enumerate(links):
        groups.setdefault((rec[10], rec[0], rec[1]), []).append(i)
    return groups


def deconvolve(trace) -> list[tuple]:
    """Isolated-equivalent link samples from a (possibly contended) trace.

    Returns ``(src, dst, level, seconds, nbytes, first)`` per recorded
    interval — the :meth:`Tracer.link_samples` shape — where ``seconds``
    is the occupancy-weighted flow time plus the traced latency tail.
    Uncontended intervals come back with their traced duration unchanged.
    """
    links = _records(trace)
    iso = [0.0] * len(links)
    for idxs in _groups(links).values():
        if len(idxs) == 1:
            i = idxs[0]
            iso[i] = links[i][9] - links[i][3]  # flow ran alone
            continue
        # sweep the elementary segments between flow boundaries; each
        # segment charges 1/occupancy to every interval covering it
        bounds = sorted({links[i][3] for i in idxs}
                        | {links[i][9] for i in idxs})
        for a, b in zip(bounds, bounds[1:]):
            if b <= a:
                continue
            covering = [i for i in idxs
                        if links[i][3] <= a and links[i][9] >= b]
            if not covering:
                continue
            share = (b - a) / len(covering)
            for i in covering:
                iso[i] += share
    return [(rec[0], rec[1], rec[2],
             iso[i] + (rec[4] - rec[9]),  # + observed latency tail
             rec[5], rec[7])
            for i, rec in enumerate(links)]


def occupancy(trace) -> dict[int, dict]:
    """Per-link-class contention summary of a trace.

    For each link class: ``transfer_s`` (sum of flow durations, counting
    overlap multiply), ``busy_s`` (union of flow intervals per edge and
    sharing group — the time the class's links actually carried traffic),
    ``mean_overlap`` (transfer_s / busy_s; 1.0 = never contended), and
    ``n`` intervals.  The :class:`~repro_torch.obs.monitor.HealthMonitor` turns
    ``busy_s`` over its observation window into utilization.
    """
    links = _records(trace)
    out: dict[int, dict] = {}
    for lvl in sorted({rec[2] for rec in links}):
        out[lvl] = {"transfer_s": 0.0, "busy_s": 0.0,
                    "mean_overlap": 0.0, "n": 0}
    for idxs in _groups(links).values():
        by_level: dict[int, list[int]] = {}
        for i in idxs:
            by_level.setdefault(links[i][2], []).append(i)
        for lvl, lis in by_level.items():
            row = out[lvl]
            row["n"] += len(lis)
            union = 0.0
            end = None
            for i in sorted(lis, key=lambda i: links[i][3]):
                t0, fe = links[i][3], links[i][9]
                row["transfer_s"] += fe - t0
                if end is None or t0 > end:
                    union += fe - t0
                    end = fe
                elif fe > end:
                    union += fe - end
                    end = fe
            row["busy_s"] += union
    for row in out.values():
        if row["busy_s"] > 0:
            row["mean_overlap"] = row["transfer_s"] / row["busy_s"]
    return out
