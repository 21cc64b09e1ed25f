"""The port's ``apply_updates`` in all its sync paths on spawned gloo
ranks against the reference's under nested ``jax.vmap``.

Each grid (2x2, 2x1 and 1x2 of (pods, data)) is one ``run_ranks`` spawn
of a ``tests/_torch_ranks.py`` body that runs every case: the dense flat,
multilevel and EF paths, bucketed flat and multilevel, ZeRO-1 and ZeRO-1
+ EF, each unclipped and clipped, three steps on bf16 and f32 leaves and
one leaf no dim of which divides by 2.  The reference runs per rank under
``jax.vmap(jax.vmap(..., axis_name="data"), axis_name="pod")`` on its opt
state cut per rank as ``opt_manual_specs`` shards it; eagerly where the
int8 quantiser runs (the eager jnp path is the bit-exact oracle).

On a model axis, the grids 2x1x2, 1x2x2 and 2x2x2 of (pods, data,
model): each rank holds its model shard of the parameters, state and
gradients along the leaves' model dims (the vocabulary rows of
``embed``, the last dim of ``w`` and of ``mcol``, whose only dim that
the data axis divides is its model dim, so the scatter falls back to it;
the rest replicated), as the reference's update sees them inside its
inner ``shard_map`` manual over ``model``; the reference runs under
``jax.vmap`` over a third axis ``"model"`` with ``model_dims`` and
``model_axis="model"``, which pins its norm over ``model``: a replicated
leaf's squares count once on each model rank.

Tolerances are ``test_torch_train.py``'s: 1e-6 x max|ref| on f32 leaves,
one bf16 ulp on bf16 params.  The clipped cases patch the reference's
``vdot`` to an f64 dot (its own f32 sum is off by about 1e-5 relative on
this CPU; ROADMAP Queue 3), as the one-rank test holds it against an exact
norm.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_bridge import (forked_ranks, jax_to_numpy, model_cut, rank_opt,
                           vmap_ranks)
from repro.optim import adamw as jadamw
from repro_torch.launch.mesh import run_ranks

GRIDS = [(2, 2), (2, 1), (1, 2)]
GRIDS3 = [(2, 1, 2), (1, 2, 2), (2, 2, 2)]       # (pods, data, model)
# the model-sharded dim of each leaf of _params(model > 1)
MDIMS = {"embed": 0, "final_norm": -1, "mcol": 1, "odd": -1,
         "runs": [{"norm1": -1, "w": 2}]}
TIMEOUT = 300.0


PATHS = {
    "dense_flat": dict(comm_mode="flat", zero1=False),
    "dense_multilevel": dict(comm_mode="multilevel", zero1=False),
    "dense_ef": dict(comm_mode="multilevel_compress", zero1=False),
    "bucketed_flat": dict(comm_mode="flat", zero1=False, bucket_bytes=4096.0),
    "bucketed_multilevel": dict(comm_mode="multilevel", zero1=False,
                                bucket_bytes=4096.0),
    "zero1": dict(comm_mode="multilevel", zero1=True),
    "zero1_ef": dict(comm_mode="multilevel_compress", zero1=True),
}
SCALES = (1e-3, 1.0)           # unclipped, clipped
COMMON = dict(lr=1e-3, warmup_steps=2, total_steps=5)


def _params(model=1):
    """bf16 weights and f32 norms in the stacked-run shape, and a leaf no
    dim of which divides by 2; on a model axis, ``mcol`` besides."""
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"embed": jnp.asarray(f(64, 32), jnp.bfloat16), "final_norm": f(32),
         "runs": [{"w": jnp.asarray(f(2, 32, 48), jnp.bfloat16),
                   "norm1": f(2, 32)}], "odd": f(3, 5)}
    if model > 1:
        p["mcol"] = f(3, 8)
    return jax.tree.map(jnp.asarray, p)


def _local(params, model):
    """The shapes of one rank's model shard of ``params``."""
    return jax.tree.map(lambda a, md: model_cut(a, md, model, 0), params,
                        MDIMS)


def _grads(pods, data, model=1):
    """Three steps' gradients of every rank: leaves (pods, data, ...), or
    on a model axis (pods, data, model, ...) of the model shards."""
    rng = np.random.default_rng(2)
    lead = (pods, data) if model == 1 else (pods, data, model)
    like = _params() if model == 1 else _local(_params(model), model)
    return [jax.tree.map(lambda a: rng.standard_normal(
        lead + a.shape).astype(np.float32), like) for _ in range(3)]


class _ExactNorm:
    """``jnp`` for ``repro.optim.adamw`` with an f64 ``vdot``."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def vdot(a, b):
        f = lambda x, y: np.asarray(np.vdot(np.asarray(x, np.float64),
                                            np.asarray(y, np.float64)),
                                    np.float32)
        return jax.pure_callback(f, jax.ShapeDtypeStruct((), jnp.float32),
                                 a, b, vmap_method="sequential")


def _ref_updates(pods, data, kw, scale):
    cfg = jadamw.OptConfig(**kw, **COMMON)
    params = _params()
    opt = rank_opt(jadamw.init_opt_state(params, cfg, n_slow=pods), params,
                    cfg, pods, data)
    bcast = jax.tree.map(lambda a: jnp.broadcast_to(
        a, (pods, data) + a.shape), params)
    slow = "pod" if pods > 1 else None
    fn = vmap_ranks(lambda p, g, o: jadamw.apply_updates(
        p, g, o, cfg, slow, data, pods * data))
    if not cfg.error_feedback:     # eager only where the quantiser runs
        fn = jax.jit(fn)
    for g in _grads(pods, data):
        g = jax.tree.map(lambda a: jnp.asarray(np.float32(scale) * a), g)
        bcast, opt = fn(bcast, g, opt)
    return jax_to_numpy({"params": bcast, "opt": opt})


def _ref_updates3(pods, data, model, kw, scale):
    """The reference's ``apply_updates`` per rank of a (pods, data, model)
    grid, each rank on its model shard, the norm over ``model``."""
    cfg = jadamw.OptConfig(**kw, **COMMON)
    params = _params(model)
    opt = rank_opt(jadamw.init_opt_state(params, cfg, n_slow=pods), params,
                   cfg, pods, data, model, MDIMS)
    shards = [jax.tree.map(lambda a, md: model_cut(a, md, model, m), params,
                           MDIMS) for m in range(model)]
    local = jax.tree.map(lambda *a: jnp.broadcast_to(
        jnp.stack(a), (pods, data, model) + a[0].shape), *shards)
    slow = "pod" if pods > 1 else None
    fn = vmap_ranks(lambda p, g, o: jadamw.apply_updates(
        p, g, o, cfg, slow, data, pods * data, MDIMS, model_axis="model"),
        model=True)
    if not (cfg.error_feedback and slow):  # eager where the quantiser runs
        fn = jax.jit(fn)
    for g in _grads(pods, data, model):
        g = jax.tree.map(lambda a: jnp.asarray(np.float32(scale) * a), g)
        local, opt = fn(local, g, opt)
    return jax_to_numpy({"params": local, "opt": opt})


@functools.lru_cache(maxsize=None)
def _port_updates(pods, data, model=1):
    params = _params(model)
    cases, opts = [], []
    for scale in SCALES:
        for kw in PATHS.values():
            cfg = jadamw.OptConfig(**kw, **COMMON)
            opts.append(jax_to_numpy(jadamw.init_opt_state(params, cfg,
                                                           n_slow=pods)))
            cases.append((dict(kw, **COMMON), scale))
    res = run_ranks(ranks.updates, pods * data * model, "gloo",
                    (pods, data, cases, jax_to_numpy(params), opts,
                     [jax_to_numpy(g) for g in _grads(pods, data, model)],
                     model, MDIMS if model > 1 else None),
                    timeout=TIMEOUT)
    return {(name, scale): [r[i] for r in res] for i, (name, scale) in
            enumerate((n, s) for s in SCALES for n in PATHS)}


def _bf16(a):
    return (np.asarray(a).astype(np.uint32) << 16).view(np.float32)


def _check(rank_got, w):
    """One rank's params and opt shard against the reference's."""
    assert jax.tree.structure(w) == jax.tree.structure(
        jax.tree.map(lambda a: 0, rank_got))
    for g, wl in zip(jax.tree.leaves(rank_got), jax.tree.leaves(w)):
        assert g.dtype == wl.dtype and g.shape == wl.shape
        if wl.dtype == np.int32:
            assert np.array_equal(g, wl)
        elif wl.dtype == np.uint16:
            g, wl = _bf16(g), _bf16(wl)
            assert np.all(np.abs(g - wl) <= 2.0 ** -7 * np.abs(wl))
        else:
            assert np.abs(g - wl).max() <= 1e-6 * max(np.abs(wl).max(),
                                                      1e-30)


@pytest.mark.parametrize("scale", SCALES, ids=["unclipped", "clipped"])
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_apply_updates_matches_reference(grid, path, scale, monkeypatch):
    pods, data = grid
    if scale >= 1:
        monkeypatch.setattr(jadamw, "jnp", _ExactNorm())
    want = _ref_updates(pods, data, PATHS[path], scale)
    got = _port_updates(pods, data)[path, scale]
    for r, rank_got in enumerate(got):
        p, d = divmod(r, data)
        _check(rank_got, jax.tree.map(lambda a: a[p, d], want))


@pytest.mark.parametrize("scale", SCALES, ids=["unclipped", "clipped"])
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("grid", GRIDS3,
                         ids=lambda g: "x".join(map(str, g)))
def test_apply_updates_on_a_model_axis_matches_reference(grid, path, scale,
                                                         monkeypatch):
    pods, data, model = grid
    if scale >= 1:
        monkeypatch.setattr(jadamw, "jnp", _ExactNorm())
    want = _ref_updates3(pods, data, model, PATHS[path], scale)
    got = _port_updates(pods, data, model)[path, scale]
    for r, rank_got in enumerate(got):
        cell, m = divmod(r, model)
        p, d = divmod(cell, data)
        _check(rank_got, jax.tree.map(lambda a: a[p, d, m], want))


def test_reference_norm_counts_a_replicated_leaf_on_each_model_rank():
    """The reference's global norm on a model axis sums every leaf's
    squares over ``model`` (``repro/optim/adamw.py:282-283, 290-292``),
    the leaves replicated over it too: with a gradient on one replicated
    leaf alone, the clip divides by sqrt(M) times its norm, where one rank
    divides by its norm.  The port copies it
    (``test_apply_updates_on_a_model_axis_matches_reference``)."""
    g = jnp.asarray(np.arange(1.0, 5.0, dtype=np.float32))
    params = {"norm": jnp.zeros(4), "w": jnp.zeros((2, 4))}
    mdims = {"norm": -1, "w": 1}
    for zero1 in (False, True):
        cfg = jadamw.OptConfig(comm_mode="multilevel", zero1=zero1,
                               clip_norm=1.0, **COMMON)
        for model in (1, 2):
            local = {"norm": params["norm"], "w": jnp.zeros((2, 4 // model))}
            opt = jadamw.init_opt_state(local, cfg)
            fn = jax.jit(vmap_ranks(lambda p, gr, o: jadamw.apply_updates(
                p, gr, o, cfg, None, 1, 1, mdims, model_axis="model"),
                model=True))
            lead = lambda t: jnp.broadcast_to(t, (1, 1, model) + t.shape)
            _, new = fn(jax.tree.map(lead, local),
                        {"norm": lead(g), "w": lead(local["w"])},
                        jax.tree.map(lead, opt))
            m = np.asarray(new["m"]["norm"][0, 0, 0])
            want = 0.1 * np.asarray(g) / (np.sqrt(model)
                                          * np.linalg.norm(np.asarray(g)))
            np.testing.assert_allclose(m, want, rtol=1e-6)
