"""The port's contention deconvolution, measured-cost feedback and health
monitor against the reference's, exactly.

``obs/contention.py``, ``obs/feedback.py`` and ``obs/monitor.py`` are
deterministic Python in both packages, so the same traced engine traffic
gives equal deconvolved samples and occupancy, the same feedback runs give
equal reports and refitted levels, and a serving run of the scheduler with
``SimExecutor`` and a priority engine under a mis-modelled network gives
equal health events, snapshots, serving summaries and Prometheus text.
Results that may hold NaN (an empty window's percentile) are compared as
their JSON text.
"""
import dataclasses
import json
import types

import pytest

import repro.core as J
from repro import obs as JO
from repro import serving as JS
from repro.core import engine as JE

import repro_torch.core as T
from repro_torch import obs as TO
from repro_torch import serving as TS
from repro_torch.core import engine as TE

REF = types.SimpleNamespace(core=J, engine=JE, obs=JO, serving=JS)
PORT = types.SimpleNamespace(core=T, engine=TE, obs=TO, serving=TS)
MIB = float(1 << 20)


def _fig8(ns, **scale):
    """The Fig. 8 grid with each named level's bandwidth scaled."""
    t = ns.core.paper_fig8_topology()
    return ns.core.Topology(t.coords, [dataclasses.replace(
        l, bandwidth=l.bandwidth * scale.get(l.name, 1.0))
        for l in t.levels])


def _levels(topo):
    return [dataclasses.astuple(l) for l in topo.levels]


def _json(x) -> str:
    return json.dumps(x, sort_keys=True, default=repr)


def _busy_trace(ns, policy):
    """Overlapping member sets so transfers share WAN edges, priced on
    the true grid and planned on a model whose WAN is 8x too fast."""
    comm = ns.core.Communicator(_fig8(ns, wan=8.0), policy="auto")
    tr = ns.obs.Tracer()
    eng = ns.engine.Engine(comm, policy=policy, truth=_fig8(ns), tracer=tr,
                           age_rate=1e7)
    sets = [tuple(range(48)), tuple(range(0, 32)), tuple(range(16, 48)),
            tuple(range(0, 16)) + tuple(range(32, 48))]
    for rep in range(2):
        for i, mem in enumerate(sets):
            eng.issue("allreduce", (1 + i + rep) * MIB, members=mem)
            eng.issue("bcast", 2 * MIB, members=mem, root=mem[-1])
        eng.wait_all()
    return tr


@pytest.mark.parametrize("policy", ("fifo", "priority"))
def test_contention_equals_reference(policy):
    tp, tj = _busy_trace(PORT, policy), _busy_trace(REF, policy)
    assert tp.link_records() == tj.link_records()
    assert TO.deconvolve(tp) == JO.deconvolve(tj)
    assert TO.occupancy(tp) == JO.occupancy(tj)
    overlap = max(r["mean_overlap"] for r in TO.occupancy(tp).values())
    assert overlap > 1.0          # the trace is really contended


def _feedback(ns):
    comm = ns.core.Communicator(_fig8(ns, wan=8.0, lan=0.5), policy="auto")
    fb = ns.obs.FeedbackLoop(comm, threshold=0.1, min_samples=4)
    truth = _fig8(ns)
    out = {"runs": [fb.run(op, nb, truth=truth)
                    for op, nb in (("allreduce", 16 * MIB),
                                   ("bcast", 4 * MIB), ("reduce", MIB),
                                   ("allgather", 64e3))]}
    out["drift"] = fb.drift()
    out["table"] = fb.residual_table()
    out["report"] = dataclasses.astuple(fb.maybe_refit())
    out["levels"] = _levels(comm.topo)
    out["after"] = fb.run("allreduce", 16 * MIB, truth=truth)
    out["second"] = dataclasses.astuple(fb.maybe_refit())
    # contended traffic through observe_trace, with and without the
    # deconvolution
    for dec in (True, False):
        fb2 = ns.obs.FeedbackLoop(
            ns.core.Communicator(_fig8(ns, wan=8.0), policy="auto"),
            min_samples=4)
        out[f"observed_{dec}"] = fb2.observe_trace(
            _busy_trace(ns, "fifo"), deconvolve=dec)
        out[f"report_{dec}"] = dataclasses.astuple(fb2.maybe_refit())
        out[f"levels_{dec}"] = _levels(fb2.comm.topo)
    return out


def test_feedback_loop_equals_reference():
    got = _feedback(PORT)
    assert _json(got) == _json(_feedback(REF))
    assert got["report"][0] is True            # the drifted model refit
    assert got["second"][0] is False           # and then held


def _serve(ns, policy, probe):
    """The scheduler with SimExecutor and an engine planning on a
    mis-modelled WAN (8x too fast) while the truth drifts mid-run; the
    monitor detects, refits (passively, or by targeted re-probe) and
    scores stragglers."""
    truth = _fig8(ns)
    reg = ns.obs.MetricsRegistry()
    comm = ns.core.Communicator(_fig8(ns, wan=8.0), policy="auto")
    eng = ns.engine.Engine(comm, policy=policy, truth=truth, age_rate=1e8,
                           metrics=reg)
    kw = {}
    if probe:
        kw["probe"] = lambda pairs: ns.core.targeted_probes(eng.truth,
                                                            pairs)
    mon = ns.obs.HealthMonitor(engine=eng, threshold=0.25, min_samples=4,
                               check_every=2, window=64, metrics=reg, **kw)
    replicas = [tuple(range(g * 4, g * 4 + 4)) for g in range(12)]
    bs = 8
    sch = ns.serving.Scheduler(
        ns.serving.SimExecutor(vocab=97, block_size=bs), n_blocks=129,
        block_size=bs, max_slots=8, s_max=64, policy="slo",
        prefill_token_budget=96,
        compute_model=ns.serving.default_compute_model(1e8),
        engine=eng, replicas=replicas, weight_bytes=64 * MIB,
        gather_bytes=4096.0, bcast_every=4, metrics=reg)
    arrivals = ns.serving.poisson_arrivals(400.0, 0.04, seed=3)
    reqs = ns.serving.make_requests(
        arrivals, vocab=97, prompt_len=(5, 30), gen_len=(2, 12),
        slo=ns.serving.SLO(ttft_s=0.05, tpot_s=0.01), seed=3)
    half = len(reqs) // 2
    report = sch.run(reqs[:half])
    eng.truth = _fig8(ns, lan=0.25)            # the LAN degrades mid-run
    report2 = sch.run(reqs[half:])
    return {"events": [ev.to_dict() for ev in mon.events],
            "snapshot": mon.snapshot(), "stragglers": mon.stragglers(),
            "drift": mon.drift(), "refits": mon.refits,
            "levels": _levels(comm.topo),
            "summary": report.summary(), "summary2": report2.summary(),
            "tokens": [r.tokens for r in reqs],
            "prometheus": reg.to_prometheus(),
            "engine": dataclasses.astuple(eng.stats())}


@pytest.mark.parametrize("probe", (False, True), ids=("feedback", "probe"))
@pytest.mark.parametrize("policy", ("fifo", "priority"))
def test_health_monitor_serving_equals_reference(policy, probe):
    got = _serve(PORT, policy, probe)
    assert _json(got) == _json(_serve(REF, policy, probe))
    kinds = {ev["kind"] for ev in got["events"]}
    assert {"drift", "refit"} <= kinds
    assert got["refits"] >= 1
