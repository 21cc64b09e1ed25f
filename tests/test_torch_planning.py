"""The port's planning plane against the reference's, with exact equality.

Topologies, trees, plans, the rounds IR, the simulators, the cost model,
the verifier, discovery and the sim ``Communicator`` are deterministic
Python and numpy in both packages, so every comparison here is ``==``:
trees by their children, ``Lowered`` programs field by field (sends as
tuples), device rounds, the symbolic interpreter's final state, simulated
completion times, verifier findings, cache statistics and reports.

The four topologies: the paper's Fig. 8 grid, the reference's TPU fleets
``tpu_v5e_multipod(2, 2, 2)`` and ``(2, 4, 4)`` rebuilt in the port from
the reference's coordinates and ``Level`` fields (the port has no TPU
constructor), and a seeded irregular topology of 4 strata with uneven
groups.  The reference's ``tests/test_trees.py``, ``test_rounds.py``,
``test_communicator.py``, ``test_simulator.py`` and ``test_analysis.py``
name the cases.
"""
import dataclasses
import functools

import numpy as np
import pytest

import repro.core as J
from repro.analysis import verify as JV
from repro.core import costmodel as JCM
from repro.core import discovery as JD
from repro.core import rounds as JR
from repro.core import simulator as JS
from repro.core import topology as JT
from repro.core import trees as JTR
from repro.core.tree_exec import tree_rounds as j_tree_rounds

import repro_torch.core as T
from repro_torch.analysis import verify as TV
from repro_torch.core import costmodel as TCM
from repro_torch.core import discovery as TD
from repro_torch.core import rounds as TR
from repro_torch.core import simulator as TS
from repro_torch.core import topology as TT
from repro_torch.core import trees as TTR
from repro_torch.core.tree_exec import tree_rounds as t_tree_rounds

KIB = 1024.0
OPS = ("bcast", "reduce", "barrier", "gather", "scatter", "allreduce",
       "allgather")
POLICIES = ("paper", "adaptive", "oblivious", "auto")
SIZES = (KIB, 64 * KIB, 16 * 1024 * KIB)
ALGORITHMS = (None, "auto", "sag", "rsag")
SEGMENTS = (None, "bdp")


def _irregular():
    """4 strata, uneven groups at every level, from a seed."""
    rng = np.random.default_rng(7)
    rows = []
    for site in range(3):
        for machine in range(int(rng.integers(1, 4))):
            for board in range(int(rng.integers(1, 3))):
                for chip in range(int(rng.integers(1, 3))):
                    rows += [[site, machine, board, chip]] * int(
                        rng.integers(1, 3))
    coords = np.array(rows)
    lat = (40e-3, 2e-3, 1e-4, 8e-6, 1e-6)
    bw = (1e6, 1.5e7, 3e8, 2e9, 2e10)
    levels = [JT.Level(f"l{i}", lat[i], bw[i], lat[i] / 10)
              for i in range(5)]
    return JT.Topology(coords, levels)


REF_TOPOS = {
    "fig8": JT.paper_fig8_topology,
    "tpu_2x2x2": lambda: JT.tpu_v5e_multipod(2, 2, 2),
    "tpu_2x4x4": lambda: JT.tpu_v5e_multipod(2, 4, 4),
    "irregular": _irregular,
}


def _port_topo(ref):
    return TT.Topology(ref.coords, [TT.Level(l.name, l.latency, l.bandwidth,
                                             l.overhead)
                                    for l in ref.levels])


@functools.lru_cache(maxsize=None)
def _pair(name):
    ref = REF_TOPOS[name]()
    if name == "fig8":
        return ref, TT.paper_fig8_topology()
    return ref, _port_topo(ref)


def _roots(topo):
    return (0, topo.nprocs // 2 - 1, topo.nprocs - 1)


def _tree(tree):
    return tree.root, {p: list(cs) for p, cs in tree.children.items()}


def _lowered(low):
    sends = [(s.src, s.dst, s.nbytes, s.chunk, s.seg, s.kind, s.first,
              s.deps) for s in low.sends]
    return (low.op, low.algorithm, low.root, low.nbytes, low.members,
            low.nchunks, low.chunk_bytes, low.nsegs, sends)


def _findings(fs):
    return [dataclasses.astuple(f) for f in fs]


def _msgs(sched):
    return [(p.direction.value, {r: [dataclasses.astuple(m) for m in ms]
                                 for r, ms in p.msgs.items()})
            for p in sched.phases]


def _outcome(fn):
    """``fn()``'s result, or the type and text of what it raised."""
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


# ---------------------------------------------------------------------- #
# Topologies
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(REF_TOPOS))
def test_topology_equal(name):
    ref, port = _pair(name)
    assert np.array_equal(port.coords, ref.coords)
    assert [dataclasses.astuple(l) for l in port.levels] == \
        [dataclasses.astuple(l) for l in ref.levels]
    assert np.array_equal(port.comm_level_matrix(), ref.comm_level_matrix())
    assert port.comm_level_table() == ref.comm_level_table()
    assert port.to_json() == ref.to_json()
    assert np.array_equal(TT.Topology.from_json(ref.to_json()).coords,
                          ref.coords)
    for view in ("magpie_machine_view", "magpie_site_view", "flat_view"):
        a, b = getattr(TT, view)(port), getattr(JT, view)(ref)
        assert np.array_equal(a.coords, b.coords), view
        assert [l.name for l in a.levels] == [l.name for l in b.levels]
    members = list(range(0, ref.nprocs, 3))
    for s in range(ref.nstrata):
        assert port.groups_at(members, s) == ref.groups_at(members, s)


def test_topology_save_load_round_trip(tmp_path):
    ref, port = _pair("irregular")
    port.save(str(tmp_path / "t.json"))
    back = JT.Topology.load(str(tmp_path / "t.json"))
    assert back.to_json() == ref.to_json()


def test_no_tpu_constants_in_the_port():
    for name in ("DCN", "ICI_FAR", "ICI", "tpu_v5e_multipod"):
        assert not hasattr(TT, name), name
    assert not hasattr(T, "tpu_v5e_multipod")
    # the roofline is the card's: no TPU constant, the H100 the default
    assert not hasattr(TCM, "TPU_V5E")
    for fn in (TCM.roofline_terms, TCM.kernel_roofline):
        assert TCM.H100 in fn.__defaults__, fn.__name__
    assert TCM.H100.name == "h100"
    assert not hasattr(TTR, "best_tree")


# ---------------------------------------------------------------------- #
# Trees
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(REF_TOPOS))
def test_trees_equal(name):
    ref, port = _pair(name)
    P = ref.nprocs
    subsets = [list(range(P)), list(range(0, P, 2)) + [P - 1],
               list(range(P))[::-1]]
    for members in subsets:
        for root in (members[0], members[len(members) // 2], members[-1]):
            for kind in ("flat", "binomial", "chain"):
                assert _tree(getattr(TTR, f"{kind}_tree")(root, members)) \
                    == _tree(getattr(JTR, f"{kind}_tree")(root, members))
            for lam in (1, 2, 3, 7):
                assert _tree(TTR.postal_tree(root, members, lam)) == \
                    _tree(JTR.postal_tree(root, members, lam))
            for nb in SIZES:
                pairs = [(TTR.PAPER_POLICY, JTR.PAPER_POLICY),
                         (TTR.ALL_BINOMIAL, JTR.ALL_BINOMIAL),
                         (TTR.adaptive_policy(port, nb),
                          JTR.adaptive_policy(ref, nb))]
                for tp, jp in pairs:
                    assert tp.shapes == jp.shapes
                    a = TTR.build_multilevel_tree(port, root, members, tp)
                    b = JTR.build_multilevel_tree(ref, root, members, jp)
                    assert _tree(a) == _tree(b), (root, jp)
                    assert a.depth() == b.depth()
                    assert a.subtree_sizes() == b.subtree_sizes()
                    assert t_tree_rounds(a) == j_tree_rounds(b)


def test_tree_validate_and_root_errors_match():
    bad = TTR.Tree(0, {0: [1, 2], 1: [2]})
    with pytest.raises(ValueError, match="reachable twice"):
        bad.validate()
    with pytest.raises(ValueError, match="root not in members"):
        TTR.binomial_tree(9, [0, 1, 2])
    ref, port = _pair("fig8")
    with pytest.raises(ValueError, match="root must be a member"):
        TTR.build_multilevel_tree(port, 5, [0, 1, 2])


@pytest.mark.parametrize("name", list(REF_TOPOS))
def test_repair_tree_equal(name):
    ref, port = _pair(name)
    rng = np.random.default_rng(11)
    P = ref.nprocs
    for root in _roots(ref):
        for policy in ("paper", "oblivious"):
            a, _ = T.select_tree(port, root, "bcast", 1 << 20,
                                 policy=policy)
            b, _ = J.select_tree(ref, root, "bcast", 1 << 20, policy=policy)
            for k in (1, 2, max(2, P // 4)):
                failed = [int(r) for r in rng.choice(P, k, replace=False)]
                for nb in (0.0, float(1 << 20)):
                    got = _outcome(lambda: _tree(TTR.repair_tree(
                        a, port, failed, nbytes=nb)))
                    want = _outcome(lambda: _tree(JTR.repair_tree(
                        b, ref, failed, nbytes=nb)))
                    assert got == want, (root, policy, failed, nb)


# ---------------------------------------------------------------------- #
# Plans: select -> lower -> interpret / simulate / verify
# ---------------------------------------------------------------------- #

PORT = (T, TR, TS, TV)
REF = (J, JR, JS, JV)


def _choice(mods, topo, op, root, policy, nb, algo, seg):
    c = mods[0].select_plan(topo, root, op, nb, policy=policy,
                            algorithm=algo, segment_bytes=seg)
    return c, (_tree(c.tree), c.algorithm, c.segment, c.n_built)


def _execution(mods, topo, op, root, nb, choice):
    """Everything a selected plan determines, in comparable form: the
    lowered program, its device rounds, the interpreter's final state,
    both simulators, the whole-message schedule, the verifier's
    findings."""
    core, rounds, sim, verify = mods
    spec = core.OPS[op]
    low = core.Plan(spec, root, choice.tree, topo=topo,
                    algorithm=choice.algorithm,
                    segment=choice.segment).lower(nb)
    sched = (spec.schedule(choice.tree, nb) if spec.sized
             else spec.schedule(choice.tree))
    return {"lowered": _lowered(low), "device_rounds": low.device_rounds(),
            "interpret": rounds.interpret(low),
            "simulate_rounds": sim.simulate_rounds(low, topo),
            "schedule": _msgs(sched), "simulate": sim.simulate(sched, topo),
            "findings": _findings(verify.verify_lowered(low))}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", list(REF_TOPOS))
def test_select_plan_equal(name, op):
    """7 ops x 3 roots x 4 policies x 3 sizes (1 KiB-16 MiB) x 4
    algorithms x 2 segment policies, on each topology; an op without a
    root plans from the communicator's first member only, as
    ``Communicator`` calls it.  Each distinct selected plan is then
    lowered, interpreted, simulated and verified in both packages once."""
    ref, port = _pair(name)
    executed = {}
    for root in _roots(ref) if T.OPS[op].rootful else (0,):
        for policy in POLICIES:
            for nb in SIZES:
                for algo in ALGORITHMS:
                    for seg in SEGMENTS:
                        args = (op, root, policy, nb, algo, seg)
                        got = _outcome(lambda: _choice(PORT, port, *args))
                        want = _outcome(lambda: _choice(REF, ref, *args))
                        if got[0] == "ValueError":
                            assert got == want, args
                            continue
                        assert got[1] == want[1], args
                        key = repr((root, nb) + got[1][:3])
                        if key not in executed:
                            executed[key] = True
                            assert _execution(PORT, port, op, root, nb,
                                              got[0]) == \
                                _execution(REF, ref, op, root, nb,
                                           want[0]), args
    assert executed


@pytest.mark.parametrize("name", ["fig8", "tpu_2x2x2"])
def test_concurrent_simulation_equal(name):
    ref, port = _pair(name)
    lows = []
    for pkg, topo in ((T, port), (J, ref)):
        progs = []
        for op, root, nb in (("bcast", 0, 1 << 20), ("allreduce", 0, 1 << 18),
                             ("gather", ref.nprocs - 1, 4096.0)):
            c = pkg.select_plan(topo, root, op, nb, policy="paper")
            progs.append(pkg.Plan(pkg.OPS[op], root, c.tree, topo=topo)
                         .lower(nb))
        lows.append(progs)
    kw = dict(starts=[0.0, 1e-4, 0.0], deps={2: [0]},
              priorities=[1.0, 2.0, 0.5])
    assert TS.simulate_concurrent(lows[0], port, **kw) == \
        JS.simulate_concurrent(lows[1], ref, **kw)
    assert TS.simulate_concurrent(lows[0], port) == \
        JS.simulate_concurrent(lows[1], ref)


@pytest.mark.parametrize("name", list(REF_TOPOS))
def test_lowerings_by_hand_equal(name):
    """The lowering entry points directly, with explicit segment bytes and
    member subsets, and their semantic checks."""
    ref, port = _pair(name)
    P = ref.nprocs
    members = list(range(P)) if P <= 8 else list(range(0, P, 2))
    for nb in (512.0, 64 * KIB, 4 * 1024 * KIB):
        for seg in (None, "bdp", 4096.0):
            for root in (members[0], members[-1]):
                a = _outcome(lambda: _lowered(TR.lower_sag_bcast(
                    port, root, members, nb, seg)))
                b = _outcome(lambda: _lowered(JR.lower_sag_bcast(
                    ref, root, members, nb, seg)))
                assert a == b
            a = _outcome(lambda: _lowered(TR.lower_rsag_allreduce(
                port, members, nb, seg)))
            b = _outcome(lambda: _lowered(JR.lower_rsag_allreduce(
                ref, members, nb, seg)))
            assert a == b
            if isinstance(a, tuple) and a[0] != "ValueError":
                TR.check_semantics(TR.lower_rsag_allreduce(port, members, nb,
                                                           seg))


# ---------------------------------------------------------------------- #
# Cost model
# ---------------------------------------------------------------------- #

def test_costmodel_equal():
    for P, C in ((48, 3), (512, 32), (8, 1), (16, 16)):
        for nb in (0.0, 1e3, 1e6):
            args = (P, C, nb, 30e-3, 1.25e6, 30e-6, 1e8)
            for f in ("binomial_bcast_cost", "multilevel_bcast_cost",
                      "two_level_bcast_cost"):
                assert getattr(TCM, f)(*args) == getattr(JCM, f)(*args)
    ref, port = _pair("irregular")
    for a, b in zip(port.levels, ref.levels):
        assert TCM.bdp_segment_bytes(a) == JCM.bdp_segment_bytes(b)
    for nb in (0.0, 100.0, 3e4, 1e6, 7.7e7, 2.0 ** 30):
        for ms in (1, 8, TCM.MAX_SEGMENTS):
            assert TCM.pipeline_segment_bytes(port.levels, nb, ms) == \
                JCM.pipeline_segment_bytes(ref.levels, nb, ms)
    assert (TCM.MAX_SEGMENTS, TCM.MIN_CHUNK_BYTES) == \
        (JCM.MAX_SEGMENTS, JCM.MIN_CHUNK_BYTES)
    rng = np.random.default_rng(3)
    samples = [(float(n), 1e-5 + n / 1e9 * (1 + 0.01 * rng.standard_normal()),
                i % 3 == 0) for i, n in enumerate(rng.integers(1, 1 << 20, 40))]
    assert TCM.link_affine_fit(samples) == JCM.link_affine_fit(samples)
    one = [(4096.0, 2e-5, True)] * 3
    assert TCM.link_affine_fit(one, fallback_latency=1e-5) == \
        JCM.link_affine_fit(one, fallback_latency=1e-5)


# ---------------------------------------------------------------------- #
# The sim communicator: caching, stats, repair, refresh, discovery
# ---------------------------------------------------------------------- #

def _drive(pkg, topo, policy):
    comm = pkg.Communicator(topo, policy=policy, cache_size=6)
    out = []
    P = topo.nprocs
    calls = [("bcast", 1e3, 0), ("bcast", 1e3, 0), ("bcast", 3e5, P - 1),
             ("reduce", 2e4, 1), ("gather", 512.0, 0), ("scatter", 512.0, 2),
             ("allreduce", 1 << 20, None), ("allgather", 4096.0, None),
             ("allreduce", 1 << 20, None), ("bcast", 1e3, 0)]
    for op, nb, root in calls:
        fn = getattr(comm, op)
        r = fn(nb) if root is None else fn(nb, root=root)
        out.append((r.op, r.root, r.nbytes, r.completion))
    out.append(comm.barrier().completion)
    out.append(tuple(comm.cache_info()))
    out.append(dataclasses.astuple(comm.stats()))
    out.append(comm.slow_crossings("bcast", root=P - 1, nbytes=3e5))
    out.append(comm.verify_plans())
    out.append(comm.has_quorum(range(P // 2)))
    out.append(comm.has_quorum(range(P // 2 - 1)))
    out.append(comm.describe())
    return comm, out


@pytest.mark.parametrize("policy", ["paper", "adaptive", "auto"])
@pytest.mark.parametrize("name", list(REF_TOPOS))
def test_sim_communicator_equal(name, policy):
    ref, port = _pair(name)
    tc, got = _drive(T, port, policy)
    jc, want = _drive(J, ref, policy)
    assert got == want
    P = ref.nprocs
    failed = [1, P - 2] if P > 4 else [1]
    a, b = tc.repair(failed), jc.repair(failed)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert tuple(tc.members) == tuple(jc.members)
    assert tuple(tc.cache_info()) == tuple(jc.cache_info())
    assert tc.bcast(4096.0, root=0).completion == \
        jc.bcast(4096.0, root=0).completion
    # a drifted truth: the slowest class 3x slower
    truth_j = JT.Topology(ref.coords, [dataclasses.replace(
        ref.levels[0], bandwidth=ref.levels[0].bandwidth / 3)]
        + list(ref.levels[1:]))
    pairs = JD.representative_pairs(ref)
    assert TD.representative_pairs(port) == pairs
    tp = TD.targeted_probes(_port_topo(truth_j), pairs, noise=0.02, seed=5)
    jp = JD.targeted_probes(truth_j, pairs, noise=0.02, seed=5)
    assert np.array_equal(tp.times, jp.times)
    assert TD.measure_drift(port, tp) == JD.measure_drift(ref, jp)
    ra, rb = tc.refresh(tp), jc.refresh(jp)
    assert dataclasses.astuple(ra) == dataclasses.astuple(rb)
    assert tc.topo.to_json() == jc.topo.to_json()
    assert tc.allreduce(1 << 20).completion == \
        jc.allreduce(1 << 20).completion
    assert dataclasses.astuple(tc.stats()) == dataclasses.astuple(jc.stats())


@pytest.mark.parametrize("name", list(REF_TOPOS))
def test_discovery_equal(name, tmp_path):
    ref, port = _pair(name)
    for noise, seed in ((0.0, 0), (0.05, 1), (0.1, 2)):
        tp = TD.simulated_probes(port, noise=noise, seed=seed)
        jp = JD.simulated_probes(ref, noise=noise, seed=seed)
        assert np.array_equal(tp.times, jp.times)
        assert np.array_equal(tp.inject, jp.inject)
        assert np.array_equal(TD.cluster_probes(tp), JD.cluster_probes(jp))
        a, b = TD.fit_topology(tp), JD.fit_topology(jp)
        assert a.to_json() == b.to_json()
        ca = T.Communicator.from_probes(tp, policy="paper")
        cb = J.Communicator.from_probes(jp, policy="paper")
        assert ca.topo.to_json() == cb.topo.to_json()
    fits = {0: (1e-3, 1e7, 1e-5), len(ref.levels) - 1: (1e-6, 1e10, 0.0)}
    a = TD.refit_levels(port, TD.synthetic_probes(port, fits))
    b = JD.refit_levels(ref, JD.synthetic_probes(ref, fits))
    assert a.to_json() == b.to_json()
    path = str(tmp_path / "topo.json")
    a = TD.discover("sim", topo=port, noise=0.05, seed=3, path=path)
    assert a.to_json() == JD.discover("sim", topo=ref, noise=0.05,
                                      seed=3).to_json()
    assert TD.discover("env", path=path).to_json() == a.to_json()  # cached


def test_discovery_device_sources_not_ported():
    """The device sources no longer raise ``NotImplementedError``: "env"
    fits the given ranks (``tests/test_torch_discovery_env.py`` holds both
    sources against the reference and on spawned ranks); an unknown
    source still raises."""
    ranks = [TD.RankInfo(0, 0), TD.RankInfo(0, 1)]
    assert TD.discover("env", devices=ranks).to_json() == \
        TD.environment_topology(ranks).to_json()
    with pytest.raises(ValueError, match="unknown probe source"):
        TD.discover("nvlink")
    assert callable(TD.environment_topology)
    assert callable(TD.device_probes)


# ---------------------------------------------------------------------- #
# Communicator surface: dispatch, sizing, errors
# ---------------------------------------------------------------------- #

def test_nbytes_of_pinned_sizing_semantics():
    import torch

    comm = T.Communicator(TT.paper_fig8_topology(), policy="paper")
    P = comm.topo.nprocs
    for op in ("bcast", "reduce", "allreduce", "gather", "scatter",
               "allgather"):
        assert comm._nbytes_of(op, 12345.0) == 12345.0
    assert comm._nbytes_of("barrier", 999.0) == 0.0
    assert comm._nbytes_of("bcast", None) == 0.0
    shard = torch.zeros((64, 8), dtype=torch.bfloat16)
    for op in ("gather", "allgather", "bcast"):
        assert comm._nbytes_of(op, shard) == 64 * 8 * 2
    full = torch.zeros((P, 64), dtype=torch.float32)
    assert comm._nbytes_of("scatter", full) == 64 * 4
    assert comm._nbytes_of("scatter", np.zeros((P, 64), np.float32)) == 256
    assert T.size_bucket(comm._nbytes_of("scatter", full)) == \
        J.size_bucket(full.numel() * 4 / P)
    sub = T.Communicator(comm.topo, policy="paper", members=[0, 1, 2, 16])
    assert sub._nbytes_of("scatter", torch.zeros((4, 10))) == 40.0


def test_dispatch_and_errors_match():
    assert set(T.OPS) == set(J.OPS)
    for op in OPS:
        a, b = T.OPS[op], J.OPS[op]
        assert (a.rootful, a.sized, a.algorithms) == \
            (b.rootful, b.sized, b.algorithms)
    assert set(T.BACKENDS) == {"sim", "p2p", "torch"}
    topo = TT.paper_fig8_topology()
    with pytest.raises(ValueError, match="unknown backend"):
        T.Communicator(topo, backend="ppermute")
    comm = T.Communicator(topo, policy="paper")
    with pytest.raises(KeyError):
        comm.plan("alltoall")
    with pytest.raises(ValueError, match="not a member"):
        comm.bcast(1e3, root=99)
    with pytest.raises(ValueError, match="unknown policy"):
        comm.plan("bcast", policy="magic")
    with pytest.raises(ValueError, match="requires backend='torch'"):
        comm.allreduce_tree({})
    assert T.size_bucket(0) == J.size_bucket(0) == -1
    for nb in (1.0, 1023.0, 1024.0, 1025.0, 3e9):
        assert T.size_bucket(nb) == J.size_bucket(nb)


def test_device_backends_name_what_is_missing():
    import torch.distributed as dist

    assert not dist.is_initialized()
    topo = TT.paper_fig8_topology()
    with pytest.raises(ValueError, match="init_process_group"):
        T.Communicator(topo, backend="p2p")
    with pytest.raises(ValueError, match="grid="):
        T.Communicator(topo, backend="torch")


# ---------------------------------------------------------------------- #
# Fig. 8: the paper's ordering on the port's plans
# ---------------------------------------------------------------------- #

FIG8_SIZES = [1 << k for k in range(10, 21)]  # 1 KB .. 1 MB
ROOT_STRIDE = 4


def test_fig8_ordering_on_the_ports_plans():
    """A copy of ``benchmarks/bench_bcast_fig8.py``'s ``check()`` on the
    port's communicators (every 4th rank as root): multilevel <= MagPIe
    site <= MagPIe machine <= binomial from 16 KB, and adaptive within 1%
    of multilevel at every size."""
    topo = TT.paper_fig8_topology()
    comms = {
        "mpich-binomial": T.Communicator(topo, policy="oblivious"),
        "magpie-machine": T.Communicator(
            topo, policy="paper", view=TT.magpie_machine_view(topo)),
        "magpie-site": T.Communicator(topo, policy="paper",
                                      view=TT.magpie_site_view(topo)),
        "multilevel": T.Communicator(topo, policy="paper"),
        "adaptive": T.Communicator(topo, policy="adaptive"),
    }
    by = {name: {nb: sum(c.bcast(float(nb), root=r).time
                         for r in range(0, topo.nprocs, ROOT_STRIDE))
                 for nb in FIG8_SIZES} for name, c in comms.items()}
    for nb in FIG8_SIZES[4:]:
        ml, site = by["multilevel"][nb], by["magpie-site"][nb]
        mach, binm = by["magpie-machine"][nb], by["mpich-binomial"][nb]
        assert ml <= site <= mach <= binm * 1.001, (nb, ml, site, mach, binm)
    for nb in FIG8_SIZES:
        assert by["adaptive"][nb] <= by["multilevel"][nb] * 1.01, nb
    # the paper's headline: one wide-area message per multilevel bcast
    ml = comms["multilevel"]
    assert ml.slow_crossings("bcast", root=0) == 1
    assert comms["mpich-binomial"].slow_crossings("bcast", root=0) > 1


@pytest.mark.parametrize("pods,data,model", [
    (2, 4, 1), (4, 2, 1), (1, 3, 1), (3, 1, 1), (2, 2, 2), (1, 2, 4)])
def test_grid_topologies_are_the_reference_mesh_strata(pods, data, model):
    """``grid_topology``/``dp_topology`` keep the reference's
    ``mesh_topology``/``dp_topology`` strata (launch/mesh.py:30, :45) for
    a mesh of ``pods x data x model``, with the caller's levels."""
    import types

    from repro_torch.launch.mesh import dp_topology, grid_topology

    grid = types.SimpleNamespace(pods=pods, data=data, model=model)
    ref, port = _pair("tpu_2x2x2")
    idx = np.arange(pods * data * model)
    want = JT.Topology(np.stack([idx // (data * model), idx // model],
                                axis=1), ref.levels)
    got = grid_topology(grid, port.levels)
    assert got.to_json() == want.to_json()
    idx = np.arange(pods * data)
    want = JT.Topology((idx // data)[:, None],
                       [ref.levels[0], ref.levels[-1]])
    got = dp_topology(grid, [port.levels[0], port.levels[-1]])
    assert got.to_json() == want.to_json()
