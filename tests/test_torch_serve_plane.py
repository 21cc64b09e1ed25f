"""The serving network plane and the train launcher's planning plane of the
port, against the reference's on the same topology.

``launch.serve`` with a mesh builds the reference's weight-broadcast plan,
engine demo, pricing engine and health monitor over the grid's topology
(the generic link classes); the model still runs on one device, so its
tokens cannot depend on the mesh.  ``launch.train`` prices the gradient
sync and, with ``bucket_mb``, the bucketed, overlapped sync through the
engine, as the reference's launcher does.  The reference's numbers come from
its own sim ``Communicator`` and its ``_engine_demo`` on a topology with
the same coordinates and classes.
"""
import json
import math

import numpy as np
import pytest
import jax

from _torch_bridge import forked_ranks
import repro.core as J
from repro.configs import get_config as j_get_config
from repro.core import discovery as JD
from repro.core.engine import overlapped_step_times as j_overlapped
from repro.launch import serve as JSV
from repro.launch.step import layer_grad_bytes as j_layer_grad_bytes
from repro.models import transformer as JT

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.serve import serve
from repro_torch.launch.step import layer_grad_bytes
from repro_torch.launch.train import train
from repro_torch.models import transformer as T

GENERIC = JD._ENV_LEVELS["generic"]


def _ref_grid_topology(pods, data):
    """The reference's ``mesh_topology`` of a (pods, data, 1) mesh with
    the generic classes."""
    idx = np.arange(pods * data)
    return J.Topology(np.stack([idx // data, idx], axis=1), GENERIC)


class _Capture:
    """Stands in for a launcher's logger: keeps each event's fields."""

    def __init__(self):
        self.events = {}

    def info(self, msg, **fields):
        self.events[fields.get("event")] = fields


def test_serve_network_plane_same_tokens_and_reference_numbers(
        tmp_path, monkeypatch):
    kw = dict(smoke=True, device="cpu")
    trace, prom = tmp_path / "t.json", tmp_path / "m.txt"
    net = serve("gpt-100m", 5, 20, 12, "2x2x1", monitor=True,
                trace=str(trace), metrics_out=str(prom), **kw)
    one = serve("gpt-100m", 5, 20, 12, "1x1x1", **kw)
    plain = serve("gpt-100m", 5, 20, 12, **kw)
    assert np.array_equal(net["generated"], one["generated"])
    assert np.array_equal(net["generated"], plain["generated"])
    assert "engine" not in plain and "setup" not in plain
    assert net["engine"]["issued"] == net["engine"]["completed"] > 0
    assert net["health"]["checks"] > 0
    assert json.loads(trace.read_text())["traceEvents"]
    assert "monitor_checks" in prom.read_text()

    # the reference's plan and engine demo on the same topology
    jcfg = j_get_config("gpt-100m", smoke=True)
    wbytes = JSV._weight_bytes(jax.eval_shape(
        lambda: JT.init_model(jax.random.PRNGKey(0), jcfg)))
    assert net["setup"]["weight_bytes"] == wbytes
    for res, (pods, data) in ((net, (2, 2)), (one, (1, 1))):
        wcomm = J.Communicator(_ref_grid_topology(pods, data),
                               backend="sim", policy="paper")
        assert res["setup"]["bcast_est_ms"] == \
            wcomm.bcast(wbytes, root=0).time * 1e3
        assert res["setup"]["slow_crossings"] == \
            wcomm.slow_crossings("bcast", nbytes=wbytes)
        cap = _Capture()
        monkeypatch.setattr(JSV, "log", cap)
        replicas = [(g,) for g in range(pods * data)]
        JSV._engine_demo(wcomm, wbytes, jcfg, 20, 1, replicas, 5)
        ref = cap.events["engine_demo"]
        demo = res["engine_demo"]
        for k in ("makespan_ms", "serial_ms", "mean_latency_priority_ms",
                  "mean_latency_fifo_ms"):
            assert demo[k] == ref[k], k
    assert net["setup"]["slow_crossings"] == 1


def test_serve_model_axis_and_monitor_without_mesh_raise():
    # a model axis that cuts inside an expert (olmoe's smoke config has 4
    # experts of 32 features; 8 ranks divide the features, not the
    # experts), once refused, serves: the 8 ranks' tokens are equal
    # (``serve`` checks), each prefill and step gathers the experts' hidden
    out = serve("olmoe-1b-7b", 1, 4, 2, "1x1x8", smoke=True, device="cpu")
    assert out["generated"].shape == (1, 2)
    assert out["model_axis"]["model"] == 8
    assert out["model_axis"]["collectives_per_decode_step"] > 0
    with pytest.raises(ValueError, match="mesh"):
        serve("gpt-100m", 1, 4, 2, smoke=True, device="cpu", monitor=True)


def _dense(arch):
    try:
        T.port_check(get_config(arch))
    except NotImplementedError:
        return False
    return True


@pytest.mark.parametrize("arch", [a for a in list_archs() if _dense(a)])
def test_layer_grad_bytes_equals_reference(arch):
    for smoke in (False, True):
        assert layer_grad_bytes(get_config(arch, smoke=smoke)) == \
            j_layer_grad_bytes(j_get_config(arch, smoke=smoke))
    assert layer_grad_bytes(get_config(arch), 2) == \
        j_layer_grad_bytes(j_get_config(arch), 2)


def test_train_planning_equals_reference_and_bucketed_losses(tmp_path):
    trace = tmp_path / "train.json"
    kw = dict(mesh_spec="2x2x1", seq=32, batch=4, smoke=True, device="cpu",
              comm="multilevel")
    bucketed = train("gpt-100m", 2, bucket_mb=0.25, trace=str(trace), **kw)
    plain = train("gpt-100m", 2, **kw)
    assert json.loads(trace.read_text())["traceEvents"]
    assert len(bucketed["losses"]) == 2
    for a, b in zip(bucketed["losses"], plain["losses"]):
        assert math.isfinite(a) and abs(a - b) <= 1e-6 * abs(b)

    # the reference's setup and bucketed estimates on the same topology
    lb = j_layer_grad_bytes(j_get_config("gpt-100m", smoke=True))
    sim = J.Communicator(J.Topology((np.arange(4) // 2)[:, None],
                                    [GENERIC[0], GENERIC[-1]]),
                         policy="paper", backend="sim")
    total = sum(lb)
    t = sim.allreduce(total).time
    est = j_overlapped(sim, lb, [t * b / total for b in lb],
                       bucket_bytes=0.25 * 2 ** 20)
    for res in (bucketed, plain):
        assert res["plan"]["est_ms"] == t * 1e3
        assert res["plan"]["slow_crossings"] == sim.slow_crossings(
            "allreduce", nbytes=total)
    assert "bucketed" not in plain["plan"]
    got = bucketed["plan"]["bucketed"]
    assert got["n_buckets"] == est["n_buckets"] > 1
    for k in ("overlapped_s", "serial_s", "speedup", "overlap_efficiency"):
        assert got[k] == est[k], k
