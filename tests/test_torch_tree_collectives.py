"""The port's device backends on spawned gloo ranks against the reference's.

``"p2p"`` runs the paper's trees as one ``batch_isend_irecv`` per round on
8 ranks, on the topology of ``examples/tree_collectives_on_mesh.py`` (2
pods of 2 boards of 2); its oracle is the reference's ``Communicator(...,
backend="ppermute", axis="all")`` on 8 host devices.  ``"torch"`` runs the
grid-decomposed collectives on a 2 x 4 grid of 8 ranks; its oracle is the
reference's ``mesh_communicator(make_mesh((2, 4), ("pod", "data")),
backend="jax")``.  Each backend is one ``run_ranks`` spawn (bodies in
``tests/_torch_ranks.py``); the oracle is one subprocess for the module.
The oracle's outputs are read through ``np.asarray`` before any indexing
(indexing a sharded output raises ``ShardingTypeError``).

Tolerances.  The p2p backend folds what it receives in the reference's
order and operand order (``cur + recv``), so all seven ops are held bit
for bit at roots 0, 3 and 7.  The torch backend is bit for bit where each
sum has at most two nonzero terms (the masked sums of bcast, gather,
allgather and scatter, whose other terms are zeros; the barrier's zero
token); the all-rank sums of reduce and allreduce, and the in-pod
reduce-scatter of 4 ranks in rsag, add in gloo's order, not XLA's, so they
are held to 1e-6 x max|ref|.
"""
import functools

import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_bridge import forked_ranks
from repro.core import Communicator as JCommunicator
from repro.core.topology import tpu_v5e_multipod
from repro_torch.launch.mesh import run_ranks

ROOTS = (0, 3, 7)
N = 4099             # bcast/reduce/allreduce: ragged for sag's 2 chunks
M = 33               # gather/allgather/scatter: per rank
TIMEOUT = 300.0
REL_TOL = 1e-6
TOPO = tpu_v5e_multipod(2, 2, 2)
LEVELS = tuple((l.name, l.latency, l.bandwidth, l.overhead)
               for l in TOPO.levels)


def _inputs():
    rng = np.random.default_rng(19)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = {"a": f32(8, 64, 40), "b": f32(8, 5, 7), "c": f32(8, 3, 300)}
    return f32(8, N), f32(8, M), f32(8, M), tree


ORACLE = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import Communicator
from repro.core.topology import tpu_v5e_multipod
from repro.launch.mesh import mesh_communicator

d = np.load({inp!r})
xs, gs, sc = d["xs"], d["gs"], d["sc"]
ROOTS = {roots!r}
out = {{}}

def run(mesh, spec, name, fn, arg, out_spec=None):
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=spec,
                          out_specs=out_spec or spec))
    out[name] = np.asarray(f(jnp.asarray(arg)))

def ops(prefix, comm, mesh, spec):
    rep = P(None, None)
    for root in ROOTS:
        run(mesh, spec, f"{{prefix}}bcast_{{root}}",
            lambda v: comm.bcast(v, root=root), xs.reshape(-1))
        run(mesh, spec, f"{{prefix}}reduce_{{root}}",
            lambda v: comm.reduce(v, root=root), xs.reshape(-1))
        run(mesh, spec, f"{{prefix}}gather_{{root}}",
            lambda v: comm.gather(v, root=root), gs.reshape(-1))
        f = jax.jit(shard_map(lambda v: comm.scatter(v, root=root),
                              mesh=mesh, in_specs=rep, out_specs=spec))
        out[f"{{prefix}}scatter_{{root}}"] = np.asarray(f(jnp.asarray(sc)))
    run(mesh, spec, f"{{prefix}}allreduce", comm.allreduce, xs.reshape(-1))
    run(mesh, spec, f"{{prefix}}allgather", comm.allgather, gs.reshape(-1))
    run(mesh, spec, f"{{prefix}}barrier",
        lambda v: comm.barrier().reshape(1) + 0 * v[:1], xs.reshape(-1))

topo = tpu_v5e_multipod(2, 2, 2)
mesh1 = jax.make_mesh((8,), ("all",))
spec1 = P("all")
ops("p2p_", Communicator(topo, policy="paper", backend="ppermute",
                         axis="all"), mesh1, spec1)
sag = Communicator(topo, policy="paper", backend="ppermute", axis="all",
                   algorithm="sag")
run(mesh1, spec1, "p2p_bcast_sag_3", lambda v: sag.bcast(v, root=3),
    xs.reshape(-1))
rsag = Communicator(topo, policy="paper", backend="ppermute", axis="all",
                    algorithm="rsag")
run(mesh1, spec1, "p2p_allreduce_rsag", rsag.allreduce, xs.reshape(-1))

mesh2 = jax.make_mesh((2, 4), ("pod", "data"))
spec2 = P(("pod", "data"))
ops("torch_", mesh_communicator(mesh2, backend="jax"), mesh2, spec2)
jr = mesh_communicator(mesh2, backend="jax", algorithm="rsag")
run(mesh2, spec2, "torch_allreduce_rsag", jr.allreduce, xs.reshape(-1))
np.savez({outp!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def oracle(subproc, tmp_path_factory):
    """The reference's device backends on 8 host devices, once: each
    output reshaped to (rank, ...)."""
    tmp = tmp_path_factory.mktemp("tree_oracle")
    xs, gs, sc, _ = _inputs()
    np.savez(tmp / "in.npz", xs=xs, gs=gs, sc=sc)
    subproc(ORACLE.format(inp=str(tmp / "in.npz"), roots=ROOTS,
                          outp=str(tmp / "out.npz")))
    with np.load(tmp / "out.npz") as d:
        return {k: np.asarray(d[k]).reshape((8, -1)) for k in d.files}


@functools.lru_cache(maxsize=None)
def _p2p():
    xs, gs, sc, _ = _inputs()
    return run_ranks(ranks.tree_p2p, 8, "gloo",
                     (TOPO.coords, LEVELS, ROOTS, xs, gs, sc),
                     timeout=TIMEOUT)


@functools.lru_cache(maxsize=None)
def _torch():
    xs, gs, sc, tree = _inputs()
    return run_ranks(ranks.tree_torch, 8, "gloo",
                     (2, 4, LEVELS, ROOTS, xs, gs, sc, tree),
                     timeout=TIMEOUT)


def _cases():
    names = [f"{op}_{r}" for r in ROOTS
             for op in ("bcast", "reduce", "gather", "scatter")]
    return names + ["allreduce", "allgather", "barrier", "allreduce_rsag"]


def _stacked(res, name, key=None):
    rows = [r[key][name] if key else r[name] for r in res]
    return np.stack([np.asarray(x).reshape(-1) for x in rows])


@pytest.mark.parametrize("name", _cases() + ["bcast_sag_3"])
def test_p2p_bit_for_bit_with_ppermute(oracle, name):
    got = _stacked(_p2p(), name, "out")
    want = oracle["p2p_" + name]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_p2p_answers_are_the_collectives():
    """The p2p results are what the seven ops mean, on the inputs."""
    xs, gs, sc, _ = _inputs()
    res = _p2p()
    for root in ROOTS:
        bc = _stacked(res, f"bcast_{root}", "out")
        np.testing.assert_array_equal(bc, np.broadcast_to(xs[root], bc.shape))
        red = _stacked(res, f"reduce_{root}", "out")
        assert not np.delete(red, root, axis=0).any()
        np.testing.assert_allclose(red[root], xs.sum(0), rtol=1e-5,
                                   atol=1e-5)
        ga = _stacked(res, f"gather_{root}", "out")
        np.testing.assert_array_equal(ga[root], gs.reshape(-1))
        assert not np.delete(ga, root, axis=0).any()
        np.testing.assert_array_equal(_stacked(res, f"scatter_{root}", "out"),
                                      sc)
    np.testing.assert_array_equal(
        _stacked(res, "allgather", "out"),
        np.broadcast_to(gs.reshape(-1), (8, 8 * M)))
    assert not _stacked(res, "barrier", "out").any()
    assert all(r["repeat_equal"] for r in res)
    # the second identical bcast was a plan-cache hit: no tree built
    hits, misses, _, _, builds = res[0]["cache"]
    assert hits >= 1 and builds == misses
    assert all(r["staged"] == 0 for r in res)   # CPU tensors: no staging


def _level_sums(pairs_bytes):
    out = {l.name: 0.0 for l in TOPO.levels}
    for src, dst, nbytes in pairs_bytes:
        out[TOPO.levels[TOPO.comm_level(src, dst)].name] += nbytes
    return out


def test_p2p_link_bytes_follow_the_plan():
    """Bytes sent per link class, summed over ranks, equal the reference
    plan's sends summed by ``comm_level``: the lowered sends of bcast and
    allreduce, and each tree edge's payload for the ops run by
    ``tree_rounds``."""
    res = _p2p()
    sim = JCommunicator(TOPO, policy="paper")
    got = lambda name: {k: float(sum(r["links"][name][k] for r in res))
                        for k in res[0]["links"][name]}
    nb = 4.0 * N
    for name, op, root in [(f"bcast_{r}", "bcast", r) for r in ROOTS] + [
            ("allreduce", "allreduce", 0)]:
        low = sim.plan(op, root=root, nbytes=nb).lower(nb)
        assert got(name) == _level_sums(
            (s.src, s.dst, s.nbytes) for s in low.sends), name
    for root in ROOTS:
        tree = sim.plan("reduce", root=root).tree
        edges = [(p, c) for p, cs in tree.children.items() for c in cs]
        assert got(f"reduce_{root}") == _level_sums(
            (c, p, nb) for p, c in edges)
        assert got(f"gather_{root}") == _level_sums(
            (c, p, 4.0 * 8 * M) for p, c in edges)
        assert got(f"scatter_{root}") == _level_sums(
            (p, c, 4.0 * 8 * M) for p, c in edges)
    # one slow-level message per multilevel bcast (the paper's metric)
    for root in ROOTS:
        assert sim.slow_crossings("bcast", root=root) == 1
        assert got(f"bcast_{root}")["dcn"] == nb


EXACT_TORCH = {"bcast", "gather", "scatter", "allgather", "barrier"}


@pytest.mark.parametrize("name", _cases())
def test_torch_backend_against_jax_backend(oracle, name):
    got = _stacked(_torch(), name)
    want = oracle["torch_" + name]
    assert got.dtype == want.dtype == np.float32
    if name.split("_")[0] in EXACT_TORCH:
        np.testing.assert_array_equal(got, want)
    else:
        err = np.abs(got - want).max()
        assert err <= REL_TOL * np.abs(want).max(), (name, err)


def test_allreduce_tree_is_multilevel_psum_tree():
    res = _torch()
    keys = [k for k in res[0] if k.startswith("tree_")]
    assert len(keys) == 4 * 3 + 1
    for r in res:
        for k in keys:
            np.testing.assert_array_equal(r[k], r["direct_" + k[5:]])
    # and the sum is the sum: multilevel over 8 ranks, mean over 8
    _, _, _, tree = _inputs()
    for k, v in tree.items():
        err = np.abs(res[0][f"tree_multilevel_{k}"] - v.sum(0) / 8).max()
        assert err <= REL_TOL * np.abs(v).sum(0).max(), k
