"""The port's multilevel collectives on spawned gloo ranks against the
reference under nested ``jax.vmap``.

Each grid (2x2, 2x1 and 1x2 of (pods, data)) is one ``run_ranks`` spawn
of a ``tests/_torch_ranks.py`` body, fed the same numpy inputs per rank as
the reference, whose ``repro.core.collectives`` run per rank under
``jax.vmap(jax.vmap(..., axis_name="data"), axis_name="pod")``, eagerly:
the eager jnp quantiser is the bit-exact oracle (a jitted one divides by
127 as a product with the reciprocal).

Tolerances.  Every sum over two ranks is exact whatever its order, so the
multilevel paths (plain, int8, int8 + EF, trees, bucketed) are held bit
for bit; the flat all-reduce over four ranks sums in gloo's order, not
XLA's, so flat results are held to 1e-6 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_bridge import jax_to_numpy
from repro.core import collectives as JC
from repro.core import compression as JCOMP
from repro_torch.launch import mesh
from repro_torch.launch.mesh import run_ranks

GRIDS = [(2, 2), (2, 1), (1, 2)]
N = 3 * 4096 + 512           # divides by 2 and by 256, not by QTILE
TIMEOUT = 300.0


def _vmap2(fn):
    return jax.vmap(jax.vmap(fn, axis_name="data"), axis_name="pod")


def _inputs(pods, data, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((pods, data, N)).astype(np.float32)
    ef = 0.01 * rng.standard_normal((pods, data, N // data)).astype(
        np.float32)
    tree = {"a": rng.standard_normal((pods, data, 64, 40)),
            "b": rng.standard_normal((pods, data, 5, 7)),
            "c": rng.standard_normal((pods, data, 3, 300))}
    return x, ef, {k: v.astype(np.float32) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _port(pods, data):
    # spawned ranks (a fresh interpreter each) even where another test
    # module of this process forks them (``_torch_ranks.fork_ranks``):
    # test_preloaded_ranks_compute_what_spawned_ones_do holds forked ranks
    # to these
    forked, mesh._PRELOADED[:] = mesh._PRELOADED[:], []
    try:
        out = run_ranks(ranks.collectives, pods * data, "gloo",
                        (pods, data, *_inputs(pods, data)), timeout=TIMEOUT)
    finally:
        mesh._PRELOADED[:] = forked
    return {k: np.stack([o[k] for o in out]).reshape(
        (pods, data) + out[0][k].shape) for k in out[0]}


@functools.lru_cache(maxsize=None)
def _ref(pods, data):
    x, ef, tree = (jax.tree.map(jnp.asarray, a) for a in _inputs(pods, data))
    slow = "pod" if pods > 1 else None
    fast = ["data"]
    v = lambda fn, *a: jax.tree.map(np.asarray, _vmap2(fn)(*a))
    out = {"flat": v(lambda a: JC.flat_psum(a, ("pod", "data")), x),
           "multilevel": v(lambda a: JC.multilevel_psum(a, slow, fast), x)}
    if slow:
        out["compressed"] = v(lambda a: JC.multilevel_psum(
            a, slow, fast, True), x)
        out["compressed_ef"], out["compressed_ef_new"] = v(
            lambda a, e: JC.multilevel_psum(a, slow, fast, True, e), x, ef)
        n = N // data      # the kernel-path call returns the rank's shard
        out["kernel_path_ef"] = np.stack(
            [out["compressed_ef"][:, d, d * n:(d + 1) * n]
             for d in range(data)], axis=1)
        out["kernel_path_ef_new"] = out["compressed_ef_new"]
    for mode in ("flat", "multilevel", "multilevel_compress"):
        res = v(lambda t: JC.multilevel_psum_tree(t, slow, fast, mode,
                                                  mean_over=4), tree)
        out.update({f"tree_{mode}_{k}": a for k, a in res.items()})
    one = jax.tree.map(lambda a: a[0, 0], tree)
    out["ef_zeros_size"] = np.full((pods, data), JC.compress_ef_zeros(
        one, data, tile=JCOMP.QTILE).size)
    res, new = v(lambda t: JC.multilevel_psum_tree(
        t, slow, fast, "multilevel_compress",
        ef=JC.compress_ef_zeros(t, data, tile=JCOMP.QTILE) + 0.01), tree)
    out.update({f"tree_ef_{k}": a for k, a in res.items()})
    out["tree_ef_new"] = new
    for mode in ("flat", "multilevel"):
        res = v(lambda t: JC.bucketed_psum_tree(
            t, slow, fast, bucket_bytes=300.0, mode=mode, mean_over=2), tree)
        out.update({f"bucketed_{mode}_{k}": a for k, a in res.items()})
    return out


CASES = {   # name -> (result keys, exact)
    "flat": (["flat"], False),
    "multilevel": (["multilevel"], True),
    "compressed": (["compressed"], True),
    "compressed_ef": (["compressed_ef", "compressed_ef_new"], True),
    "kernel_path_ef": (["kernel_path_ef", "kernel_path_ef_new"], True),
    "tree_flat": ([f"tree_flat_{k}" for k in "abc"], False),
    "tree_multilevel": ([f"tree_multilevel_{k}" for k in "abc"], True),
    "tree_multilevel_compress": (
        [f"tree_multilevel_compress_{k}" for k in "abc"], True),
    "compress_ef_zeros": (["ef_zeros_size"], True),
    "tree_ef": ([f"tree_ef_{k}" for k in "abc"] + ["tree_ef_new"], True),
    "bucketed_flat": ([f"bucketed_flat_{k}" for k in "abc"], False),
    "bucketed_multilevel": ([f"bucketed_multilevel_{k}" for k in "abc"],
                            True),
}
NEEDS_PODS = ("compressed", "compressed_ef", "kernel_path_ef")


@pytest.mark.parametrize("grid,case", [
    (g, c) for g in GRIDS for c in CASES
    if g[0] > 1 or c not in NEEDS_PODS], ids=lambda p: (
        "x".join(map(str, p)) if isinstance(p, tuple) else p))
def test_collective_matches_reference(grid, case):
    got, want = _port(*grid), _ref(*grid)
    keys, exact = CASES[case]
    for k in keys:
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if exact:
            assert np.array_equal(g, w), (k, np.abs(g - w).max())
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_compressed_slow_hop_sends_int8():
    """At 2x2 each rank's slow hop carries its 1/|data| shard: 4 bytes an
    element in f32, and compressed one int8 byte an element plus one f32
    scale per 256 (0.254x)."""
    got = _port(2, 2)
    n = N // 2                   # the shard; a multiple of BLOCK, no pad
    assert np.all(got["slow_bytes_multilevel"] == 4 * n)
    assert np.all(got["slow_bytes_compressed"]
                  == n + 4 * (n // JCOMP.BLOCK))


PRELOADED = """
import sys
import multiprocessing.forkserver as fs
import numpy as np
sys.path[:0] = [{tests!r}, {src!r}]
import _torch_ranks as ranks
from repro_torch.launch import mesh

ins = np.load({path!r})
mesh.preload_ranks("numpy", "_torch_ranks")
out = mesh.run_ranks(ranks.collectives, 4, "gloo", (
    2, 2, ins["x"], ins["ef"], {{k[2:]: ins[k] for k in ins if k[:2] == "t_"}}),
    timeout=300.0)
assert fs._forkserver._forkserver_pid is not None
np.savez({out!r}, **{{k: np.stack([o[k] for o in out]) for k in out[0]}})
"""


def test_preloaded_ranks_compute_what_spawned_ones_do(tmp_path):
    """``mesh.preload_ranks``: the ranks fork from a server that imported
    torch and the named modules once; the 2x2 grid's collectives equal
    the spawned ranks' bit for bit.  In a process of its own, since the
    choice holds for the rest of the process that makes it."""
    import os
    import subprocess
    import sys

    x, ef, tree = _inputs(2, 2)
    np.savez(tmp_path / "ins.npz", x=x, ef=ef,
             **{f"t_{k}": v for k, v in tree.items()})
    here = os.path.dirname(os.path.abspath(__file__))
    subprocess.run([sys.executable, "-c", PRELOADED.format(
        tests=here, src=os.path.join(os.path.dirname(here), "src"),
        path=str(tmp_path / "ins.npz"), out=str(tmp_path / "out.npz"))],
        check=True, timeout=TIMEOUT)
    got = np.load(tmp_path / "out.npz")
    want = _port(2, 2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].reshape(want[k].shape),
                                      want[k], err_msg=k)
