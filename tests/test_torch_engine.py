"""The port's async collective engine against the reference's, exactly.

``core/engine.py`` is deterministic Python in both packages, so every
comparison is ``==``: each handle's release (``at``), start, finish and
per-rank completion times, the engine clock, ``EngineStats``, the metric
counters and the traced spans, link intervals and instants (the planner's
wall-clock track aside).  The same issue sequence runs in both packages
on the paper's Fig. 8 grid and on 512 ranks in the reference's multipod
strata (the port's topology built from the reference's coordinates and
``Level`` fields: the port carries no TPU constructor).
"""
import dataclasses
import types

import numpy as np
import pytest

import repro.core as J
from repro.core import engine as JE
from repro.core import topology as JT
from repro.launch.step import layer_grad_bytes as j_layer_grad_bytes
from repro.configs import get_config as j_get_config
from repro.obs import MetricsRegistry as JMetrics
from repro.obs import Tracer as JTracer
from repro.obs.trace import PID_PLANNER

import repro_torch.core as T
from repro_torch.analysis.__main__ import strata_512
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import engine as TE
from repro_torch.core import topology as TT
from repro_torch.launch.step import layer_grad_bytes as t_layer_grad_bytes
from repro_torch.obs import MetricsRegistry as TMetrics
from repro_torch.obs import Tracer as TTracer

REF = types.SimpleNamespace(core=J, engine=JE, topology=JT, Tracer=JTracer,
                            Metrics=JMetrics)
PORT = types.SimpleNamespace(core=T, engine=TE, topology=TT, Tracer=TTracer,
                             Metrics=TMetrics)


def _port_topo(ref):
    return TT.Topology(ref.coords, [TT.Level(l.name, l.latency, l.bandwidth,
                                             l.overhead) for l in ref.levels])


def _topo(ns, name, drift=1.0):
    """``name``'s topology in package ``ns``; ``drift`` scales every
    bandwidth (the same coordinates: a ``truth`` or a refit)."""
    ref = (JT.paper_fig8_topology() if name == "fig8"
           else JT.tpu_v5e_multipod(2, 16, 16))
    ref = JT.Topology(ref.coords, [dataclasses.replace(
        l, bandwidth=l.bandwidth * drift) for l in ref.levels])
    return ref if ns is REF else _port_topo(ref)


def _observe(eng, handles, tracer, metrics):
    """Everything an engine run exposes, as plain Python values."""
    hs = [(h.hid, h.op, h.root, h.nbytes, h.members, h.at, h.started,
           h.finished, None if h.result is None else
           (h.result.op, h.result.root, h.result.nbytes,
            dict(h.result.completion)))
          for h in handles]
    st = eng.stats()
    out = {"handles": hs, "now": eng.now,
           "stats": (st.issued, st.completed, st.batches, st.replanned,
                     st.last_policy, st.now),
           "metrics": metrics.snapshot()}
    if tracer is not None:
        tracer.n_events()             # replays the deferred records
        out["links"] = list(tracer.links)
        out["spans"] = [s for s in tracer.spans if s[0] != PID_PLANNER]
        out["instants"] = [i for i in tracer.instants
                           if i[0] != PID_PLANNER]
    return out


def _streams(ns, topo_name, policy, age_rate):
    """A fat bcast under a stream of small subset ops, ``after=`` chains
    across member sets, releases in the future, and a second batch."""
    topo = _topo(ns, topo_name)
    P = topo.nprocs
    tr, reg = ns.Tracer(), ns.Metrics()
    comm = ns.core.Communicator(topo, policy="paper", tracer=tr)
    eng = ns.engine.Engine(comm, policy=policy, age_rate=age_rate,
                           metrics=reg)
    hs = [eng.issue("bcast", 4e7, root=0)]
    quarter = tuple(range(P // 4))
    half = tuple(range(P // 2, P))
    for i in range(4):
        hs.append(eng.issue("allgather", 2e4, members=quarter,
                            priority=1.0))
        hs.append(eng.issue("reduce", 1e5 * (i + 1), members=half,
                            root=half[i], at=1e-3 * i))
    hs.append(eng.issue("barrier", members=quarter, after=[hs[1], hs[2]]))
    hs.append(eng.issue("allreduce", 3e6, after=[hs[-1]]))
    eng.wait_all()
    hs.append(eng.issue("gather", 5e4, root=P - 1))
    hs.append(eng.issue("scatter", 6e4 * P, members=half, after=[hs[3]]))
    hs.append(eng.issue("bcast", 1e6, root=P // 2, at=eng.now + 1e-2))
    eng.wait_all()
    return _observe(eng, hs, tr, reg)


STREAM_CASES = [("fig8", policy, age)
                for policy in ("fifo", "priority", "sim")
                for age in (0.0, 1e9)] + [
    ("512", "fifo", 0.0), ("512", "priority", 1e9), ("512", "sim", 0.0)]


@pytest.mark.parametrize("topo_name,policy,age_rate", STREAM_CASES)
def test_engine_streams_equal_reference(topo_name, policy, age_rate):
    assert _streams(PORT, topo_name, policy, age_rate) == \
        _streams(REF, topo_name, policy, age_rate)


def _truth_swap(ns, topo_name):
    """Plans on the model, prices on a ``truth`` that drifts mid-run."""
    topo = _topo(ns, topo_name)
    tr, reg = ns.Tracer(), ns.Metrics()
    comm = ns.core.Communicator(topo, policy="auto", tracer=tr)
    eng = ns.engine.Engine(comm, policy="priority", age_rate=1e8,
                           truth=_topo(ns, topo_name, drift=0.5),
                           metrics=reg)
    hs = [eng.issue("bcast", 2e7, root=1),
          eng.issue("allreduce", 1e6),
          eng.issue("allgather", 3e4, members=tuple(range(0, 40, 3)))]
    eng.wait_all()
    eng.truth = _topo(ns, topo_name, drift=0.2)
    hs += [eng.issue("bcast", 2e7, root=1),
           eng.issue("reduce", 5e5, root=5, after=[hs[0]])]
    eng.wait_all(policy="sim")
    return _observe(eng, hs, tr, reg)


@pytest.mark.parametrize("topo_name", ("fig8", "512"))
def test_engine_truth_swap_equal_reference(topo_name):
    assert _truth_swap(PORT, topo_name) == _truth_swap(REF, topo_name)


def _repair_refresh(ns):
    """Pending handles re-issued by ``repair``; a refit re-points every
    per-subset plan surface through ``refresh_plans``."""
    topo = _topo(ns, "fig8")
    reg = ns.Metrics()
    comm = ns.core.Communicator(topo, policy="paper")
    eng = ns.engine.Engine(comm, policy="fifo", metrics=reg)
    sub = tuple(range(16, 40))
    hs = [eng.issue("bcast", 1e6, root=17, members=sub),
          eng.issue("allreduce", 2e6)]
    eng.wait_all()
    hs += [eng.issue("reduce", 3e5, root=17, members=sub),
           eng.issue("bcast", 4e6, root=3),
           eng.issue("gather", 1e4, members=tuple(range(8)), root=3)]
    rep = eng.repair([3, 17, 40])
    eng.wait_all()
    comm.topo = _topo(ns, "fig8", drift=3.0)
    eng.refresh_plans()
    hs += [eng.issue("reduce", 3e5, root=18, members=tuple(
        m for m in sub if m != 17)), eng.issue("allreduce", 2e6)]
    eng.wait_all()
    out = _observe(eng, hs, None, reg)
    out["repair"] = (rep.failed, rep.members, rep.repaired, rep.evicted,
                     rep.kept)
    out["comm_stats"] = dataclasses.astuple(comm.stats())
    return out


def test_engine_repair_and_refresh_equal_reference():
    assert _repair_refresh(PORT) == _repair_refresh(REF)


@pytest.mark.parametrize("ns", (PORT, REF), ids=("port", "reference"))
def test_engine_rejects_what_the_reference_rejects(ns):
    comm = ns.core.Communicator(_topo(ns, "fig8"))
    eng = ns.engine.Engine(comm)
    other = ns.engine.Engine(comm)
    with pytest.raises(ValueError, match="unknown policy"):
        ns.engine.Engine(comm, policy="lifo")
    with pytest.raises(ValueError, match="not members"):
        eng.issue("bcast", 1.0, members=(0, 99))
    with pytest.raises(ValueError, match="different engine"):
        eng.issue("bcast", 1.0, after=[other.issue("barrier")])
    with pytest.raises(ValueError, match="root 5 is not a member"):
        eng.issue("bcast", 1.0, members=(0, 1), root=5)


def test_strata_512_are_the_reference_multipod_coordinates():
    ref = JT.tpu_v5e_multipod()
    port = strata_512()
    assert np.array_equal(port.coords, ref.coords)
    assert [l.name for l in port.levels] == ["dcn", "host", "local"]


@pytest.mark.parametrize("bucket_mb", (1, 25, 100))
@pytest.mark.parametrize("arch", ("gpt-100m", "tinyllama-1.1b", "qwen3-4b"))
def test_overlapped_step_times_equal_reference(arch, bucket_mb):
    """The train launcher's bucketed estimate: ``overlapped_step_times`` on
    ``layer_grad_bytes`` of the full-width config, over the data-parallel
    strata of a 2 x 4 grid with the reference's DCN/ICI classes."""
    lb = t_layer_grad_bytes(t_get_config(arch))
    assert lb == j_layer_grad_bytes(j_get_config(arch))
    ref_topo = JT.Topology((np.arange(8) // 4)[:, None],
                           [JT.DCN, JT.ICI])
    outs = []
    for ns, topo in ((PORT, _port_topo(ref_topo)), (REF, ref_topo)):
        comm = ns.core.Communicator(topo, policy="paper")
        t = comm.allreduce(sum(lb)).time
        est = ns.engine.overlapped_step_times(
            comm, lb, [t * b / sum(lb) for b in lb],
            bucket_bytes=bucket_mb * 2 ** 20)
        eng = est.pop("engine")
        est["engine_now"] = eng.now
        outs.append(est)
    assert outs[0] == outs[1]
