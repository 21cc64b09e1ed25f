"""Discovery's device half in the port: the topology of the ranks'
environment and timed point-to-point probes between ranks.

``environment_topology`` is the reference's with ranks in place of
``jax.devices()``: its columns, the node and the card, are the reference's
``slice_index`` and ``process_index``, so fed the same two columns (the
reference through stand-in devices) the two give equal topologies.
``device_probes`` and ``discover("env"/"device")`` run on 4 spawned gloo
ranks on the CPU.
"""
import dataclasses
import tempfile

import numpy as np
import pytest

from _torch_bridge import forked_ranks
from repro.core import discovery as JD

from repro_torch.core import discovery as TD
from repro_torch.core.topology import Topology
from repro_torch.launch.mesh import run_ranks

import _torch_ranks as ranks


@dataclasses.dataclass
class _Device:
    """A stand-in for a ``jax.Device``: the two columns the reference
    reads, on a platform that is not a TPU."""
    slice_index: int
    process_index: int
    platform: str = "gpu"


# (node, card) per rank
ENVIRONMENTS = {
    "one node one card": [(0, 0)] * 4,
    "one node, no card": [(0, -1)] * 3,
    "one node shared cards": [(0, 0), (0, 0), (0, 1), (0, 1), (0, 2)],
    "two nodes": [(0, 0), (0, 1), (1, 0), (1, 1)],
    "two nodes, one card each": [(0, 0), (0, 0), (1, 0), (1, 0)],
    "uneven nodes": [(0, 0), (0, 0), (0, 1), (1, 0), (1, 0), (1, 0),
                     (2, 3)],
}


@pytest.mark.parametrize("name", sorted(ENVIRONMENTS))
def test_environment_topology_equals_reference(name):
    env = ENVIRONMENTS[name]
    port = TD.environment_topology([TD.RankInfo(n, d) for n, d in env])
    ref = JD.environment_topology([_Device(n, d) for n, d in env])
    assert port.to_json() == ref.to_json()
    assert port.nstrata == sum(len(set(c)) > 1 for c in zip(*env))


def test_generic_levels_are_the_reference_generic_classes():
    assert TD.GENERIC_LEVELS == tuple(
        TD.Level(l.name, l.latency, l.bandwidth, l.overhead)
        for l in JD._ENV_LEVELS["generic"])
    with pytest.raises(ValueError, match="no devices"):
        TD.environment_topology([])


# torchrun's variables for 2 nodes of 2 ranks, or only the local world
# size (the node is then the rank over it)
ENV_STYLES = {
    "GROUP_RANK": [{"GROUP_RANK": str(r // 2), "LOCAL_WORLD_SIZE": "2",
                    "LOCAL_RANK": str(r % 2)} for r in range(4)],
    "LOCAL_WORLD_SIZE": [{"LOCAL_WORLD_SIZE": "2"} for _ in range(4)],
}


@pytest.mark.parametrize("style", sorted(ENV_STYLES))
def test_discovery_on_spawned_ranks(style):
    xs = np.random.default_rng(5).standard_normal((4, 1000)).astype(
        np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks(ranks.discovery, 4, "gloo",
                        (tmp, ENV_STYLES[style], xs), timeout=300)
    flat = TD.environment_topology([TD.RankInfo(0, -1)] * 4)
    nodes = TD.environment_topology([TD.RankInfo(r // 2, -1)
                                     for r in range(4)])
    ref = JD.environment_topology([_Device(r // 2, -1) for r in range(4)])
    assert nodes.to_json() == ref.to_json() and nodes.nstrata == 1
    times = res[0]["times"]
    assert times.shape == (4, 4, 2)
    off = ~np.eye(4, dtype=bool)
    assert np.all(times[~off] == 0.0) and np.all(times[off] > 0.0)
    assert res[0]["sizes"] == TD.DEFAULT_PROBE_SIZES
    for r in res:
        assert r["env_spawned"] == flat.to_json()   # one node, no card
        assert r["env"] == nodes.to_json()
        assert np.array_equal(r["times"], times)    # every rank alike
        assert r["topo"] == res[0]["topo"] and r["again"] == r["topo"]
        assert r["probes_topo"] == res[0]["probes_topo"]
        assert np.array_equal(r["bcast"], xs[3])
    topo = Topology.from_json(res[0]["topo"])
    assert topo.nprocs == 4 and len(topo.levels) == topo.nstrata + 1
