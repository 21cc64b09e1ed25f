"""Training the MoE and the frontend configs on a model axis on the CPU.

The expert-parallel block (``layers._moe_block_ep``) sums the ranks'
partial outputs with ``Axis.reduce_from`` (the gradient passes through),
takes the replicated router through ``copy_to`` (each rank's gates reach
only its own experts, so the router's gradient is summed over the axis),
and its input arrives through ``copy_to`` in ``transformer._ffn``; the
shared expert is a tensor-parallel MLP summed with ``reduce_from``.
pixtral's image prefix is replicated and joins the tokens' embeddings
after their sum over the axis.

The reference's model-axis paths are red on this toolchain (ROADMAP Queue
3 F), so the model-level oracle is the port's one-rank ``loss_and_grads``,
itself held to the reference by ``tests/test_torch_train.py``; the
expert-parallel block's VJP with dropped slots is held to ``jax.vjp`` of
the reference's ``_moe_block_ep`` under ``jax.vmap(axis_name="model")``.

Configs: olmoe-1b-7b, llama4-scout-17b-a16e (top-1 and a shared expert)
and pixtral-12b at smoke size, in f32; llama4-scout and pixtral take 8
heads and 4 KV heads (their smoke configs have one KV head, which no axis
divides).  Where the MoE is compared with one rank its capacity factor is
4, so that no slot is dropped on 2 or 4 ranks.  Four gloo ranks are
spawned once for the module: a 1x1x4 grid, then 2x1x2.  Tolerances: the
loss within 1e-5 relative, each gradient leaf within 1e-4 of its largest
entry, llama4-scout's router (its renormalised top-1 gate is 1: a zero
gradient but for rounding) under 1e-6 of the largest gradient entry, as
``tests/test_torch_train.py`` holds them; the block's VJP f32 within 1e-5
of each gradient's largest entry.  ``train`` on 1x1x2 and 2x1x2
(``multilevel_compress``, ZeRO-1) within 1e-4 of one rank's losses, and a
checkpoint of olmoe's expert shards restored bit for bit on one rank and
on 1x2x2.
"""
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_bridge import forked_ranks, jax_to_numpy, numpy_to_torch
from repro.models import layers as JL
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.step import device_batch, loss_and_grads
from repro_torch.launch.train import train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import (from_numpy, shard_params,
                                        stack_runs, to_numpy, unstack_runs)
from repro_torch.tree import tree_leaves, tree_map, tree_paths
from test_torch_tp import _Rank

LOSS_TOL = 1e-5      # relative
GRAD_TOL = 1e-4      # x max|g| per leaf
ZERO_TOL = 1e-6      # x the largest gradient entry
VJP_TOL = 1e-5       # x max|g|
TRAIN_TOL = 1e-4     # relative
MODE = "multilevel_compress"
NAMES = ["olmoe_1b_7b", "llama4_scout_17b_a16e", "pixtral_12b"]
BLOCK_CHUNK = 8      # token blocks of the blocks case: 32 tokens, 4 blocks


def _cfg(name, cf=4.0):
    base = name.split("/")[0]
    cfg = configs.get_config(base, smoke=True)
    if cfg.n_kv_heads == 1:
        cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=4)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _params(cfg):
    return to_numpy(stack_runs(tree_map(lambda t: t.float(), T.init_model(
        cfg, seed=0, device="cpu")), cfg))


def _batch(cfg, S=100, B=2):
    return DataPipeline(cfg, ShapeSpec("test", "train", S, B)).host_batch(0)


@functools.lru_cache(maxsize=None)
def _cases():
    """name -> (name, cfg, f32 params, batch); ``olmoe_1b_7b/drops`` at
    capacity factor 0.5, where every rank drops slots."""
    cases = {n: (n, _cfg(n), _params(_cfg(n)), _batch(_cfg(n)))
             for n in NAMES}
    drops = _cfg("olmoe_1b_7b", cf=0.5)
    cases["olmoe_1b_7b/drops"] = ("olmoe_1b_7b/drops", drops,
                                  cases["olmoe_1b_7b"][2], _batch(drops))
    return cases


def _blocks():
    """(cfg, one MoE layer's f32 params, x (2, 16, D), cotangent, chunk):
    olmoe at capacity factor 4."""
    cfg = _cfg("olmoe_1b_7b")
    layer = to_numpy(tree_map(lambda t: t.float(), L.init_moe(
        torch.Generator().manual_seed(2), cfg)))
    rng = np.random.default_rng(7)
    x, ct = (rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
             for _ in range(2))
    return cfg, layer, x, ct, BLOCK_CHUNK


@pytest.fixture(scope="module")
def runs():
    res = run_ranks(ranks.tp_moe, 4, "gloo",
                    (list(_cases().values()), _blocks()), timeout=600.0)
    return {4: res[:4], 2: res[:2]}


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    _, cfg, params, batch = _cases()[name]
    loss, grads = loss_and_grads(unstack_runs(from_numpy(
        params, device="cpu"), cfg), cfg, device_batch(batch, "cpu"))
    return loss.item(), stack_runs(grads, cfg)


def _top1_router(cfg, path):
    return cfg.moe is not None and cfg.moe.top_k == 1 \
        and path.endswith("router")


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_one_rank(runs, model, name):
    """Each rank's f32 loss and gradients against the one-rank ones cut to
    its model shard, every leaf (the experts split on the expert dim, the
    router and the norms whole); no slot dropped; every rank of the group
    made the same model-axis collectives, in the forward, the remat's
    re-run and the backward."""
    cfg = _cases()[name][1]
    loss, grads = _one_rank(name)
    group = runs[model]
    for m, r in enumerate(group):
        got = r[model, name]
        assert abs(float(got["loss"]) - loss) <= LOSS_TOL * abs(loss)
        want = to_numpy(shard_params(grads, cfg, model, m))
        top = max(np.abs(w).max() for w in tree_leaves(want))
        gl, wl = tree_paths(got["grads"]), tree_leaves(want)
        assert len(gl) == len(wl)
        for (path, g), w in zip(gl, wl):
            assert g.shape == w.shape and g.dtype == w.dtype, path
            if _top1_router(cfg, path):
                assert max(np.abs(g).max(), np.abs(w).max()) \
                    <= ZERO_TOL * top, path
            else:
                assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), \
                    path
        if cfg.moe is not None:
            assert got["dropped"] == [0] * cfg.n_layers
    calls = [r[model, name]["calls"] for r in group]
    assert all(c == calls[0] for c in calls)
    assert min(calls[0].values()) > 0, calls[0]


@pytest.mark.parametrize("model", [2, 4])
def test_drops_are_counted_once_a_forward(runs, model):
    """olmoe at capacity factor 0.5: every rank drops slots; each layer's
    block appends its drops once, in the forward, though the remat routes
    it again in the backward (a host read each time)."""
    cfg = _cases()["olmoe_1b_7b/drops"][1]
    for r in runs[model]:
        got = r[model, "olmoe_1b_7b/drops"]
        assert np.isfinite(got["loss"])
        assert len(got["dropped"]) == cfg.n_layers and all(
            n > 0 for n in got["dropped"])
        assert got["syncs"] == 2 * cfg.n_layers


@pytest.mark.parametrize("model", [2, 4])
def test_token_blocks_remat_on_a_model_axis(runs, model):
    """Token blocks of 8 under remat on the axis: each block's backward
    routes it again and re-issues its sum on every rank alike; the output
    and the gradients (input, router, experts) equal one block's over
    all 32 tokens; each block's drops (none) counted once."""
    for r in runs[model]:
        blocks, whole = r[model, "blocks"]
        assert blocks["dropped"] == [0] * 4 and whole["dropped"] == [0]
        assert blocks["syncs"] == 8 and whole["syncs"] == 1
        np.testing.assert_allclose(blocks["y"], whole["y"], rtol=0,
                                   atol=1e-5 * np.abs(whole["y"]).max())
        for g, w in zip(blocks["grads"], whole["grads"]):
            assert np.abs(g - w).max() <= VJP_TOL * np.abs(w).max()


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("model", [2, 4])
def test_ep_block_vjp_matches_reference(model, cf):
    """The expert-parallel block's gradients on each rank against
    ``jax.vjp`` of the reference's ``_moe_block_ep`` under
    ``jax.vmap(axis_name="model")``: tokens lean towards the first two
    experts, so at 1.25 slots are dropped.  Each rank's output is the
    sum over the axis, and each rank's loss is the whole loss, so the
    reference's cotangent sits on one rank's output and the port's
    ``reduce_from`` passes it to every rank's part; the router's and the
    input's gradients are the sums over the ranks that ``copy_to`` takes
    (added here: the ranks run in one process, their sums left out)."""
    cfg = configs.get_config("olmoe_1b_7b", smoke=True)
    m = dataclasses.replace(cfg.moe, capacity_factor=cf)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JL.init_moe(jax.random.PRNGKey(0), cfg))
    E = m.n_experts
    lean = jp["router"][:, 0] + jp["router"][:, 1]
    xt = jax.random.normal(jax.random.PRNGKey(1), (64, cfg.d_model)) \
        + 4.0 * lean / jnp.linalg.norm(lean)
    experts = ("w_in", "w_gate", "w_out")
    sl = {k: jp[k].reshape(model, E // model, *jp[k].shape[1:])
          for k in experts}
    ct = np.random.default_rng(3).standard_normal(
        (64, cfg.d_model)).astype(np.float32)
    _, vjp = jax.vjp(lambda s, router, x: jax.vmap(
        lambda s: JL._moe_block_ep(dict(s, router=router), m, x, "model"),
        axis_name="model")(s), sl, jp["router"], xt)
    cts = np.zeros((model,) + ct.shape, np.float32)
    cts[0] = ct
    j_sl, j_router, j_x = vjp(jnp.asarray(cts))

    p = numpy_to_torch(jax_to_numpy(jp))
    dropped = []
    L.moe_fwd.dropped = dropped
    try:
        router_g, x_g = 0, 0
        for r in range(model):
            leaves = {k: p[k].reshape(model, E // model, *p[k].shape[1:])[r]
                      .clone().requires_grad_(True) for k in experts}
            router = p["router"].clone().requires_grad_(True)
            x = torch.from_numpy(np.array(xt)).requires_grad_(True)
            y = L._moe_block_ep(dict(p, router=router, **leaves), m, x,
                                _Rank(model, r))
            g = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                                    [router, x] + [leaves[k]
                                                   for k in experts])
            router_g, x_g = router_g + g[0], x_g + g[1]
            for k, gk in zip(experts, g[2:]):
                want = np.asarray(j_sl[k][r])
                assert np.abs(gk.numpy() - want).max() \
                    <= VJP_TOL * np.abs(want).max(), (k, r)
    finally:
        L.moe_fwd.dropped = None
    for got, want in ((router_g, j_router), (x_g, j_x)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() \
            <= VJP_TOL * np.abs(want).max()
    assert len(dropped) == model
    assert (sum(dropped) > 0) == (cf == 1.25)


# ---------------------------------------------------------------------- #
# The entry point: train --mesh PxDxM, and grid checkpoints
# ---------------------------------------------------------------------- #

def _train(mesh, steps, **kw):
    cfg = _cfg("olmoe_1b_7b")
    return train("olmoe-1b-7b", steps, mesh_spec=mesh, seq=32, batch=4,
                 comm=MODE, smoke=True, device="cpu", config=cfg,
                 init_params=_params(cfg), **kw)


@functools.lru_cache(maxsize=None)
def _one_rank_losses():
    return _train("1x1x1", 4)["losses"]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """olmoe's 4 steps on 1x1x2, checkpointing at step 2: the directory
    and the run."""
    path = tmp_path_factory.mktemp("moe_ckpt")
    return path, _train("1x1x2", 4, ckpt_dir=str(path / "a"), ckpt_every=2,
                        digests=True)


@pytest.mark.parametrize("mesh", ["1x1x2", "2x1x2"])
def test_train_drives_moe_on_a_model_axis(saved, mesh):
    """``train`` of olmoe smoke in f32 on a model axis of 2 (with 2 pods:
    int8 + EF on the slow axis), ZeRO-1: finite losses within 1e-4 of one
    rank's, the same model-axis collectives each step, no kernel launch
    on the CPU; every rank reports two host reads of the routing a layer
    and step and each layer's dropped slots (none)."""
    out = saved[1] if mesh == "1x1x2" else _train(mesh, 4)
    n = _cfg("olmoe_1b_7b").n_layers
    assert out["model"] == 2 and len(out["losses"]) == 4
    for g, o in zip(out["losses"], _one_rank_losses()):
        assert np.isfinite(g) and abs(g - o) <= TRAIN_TOL * abs(o)
    assert all(c == out["tp_calls"][0] for c in out["tp_calls"])
    assert all(n == 0 for rank in out["launches"] for n in rank.values())
    assert len(out["moe"]) == len(out["launches"]) == out["world"] * 2
    assert all(r == {"syncs": [2 * n] * 4, "dropped": [[0] * n] * 4}
               for r in out["moe"])
    assert out["peak_mem_bytes"] == [None] * len(out["launches"])


def test_checkpoint_of_expert_shards_crosses_grid_shapes(saved):
    """A checkpoint of olmoe saved on 1x1x2 (each rank's experts gathered
    over the model axis into the reference's global layout) restores bit
    for bit on one rank and on 1x2x2 (ZeRO-1 over data beside the expert
    shards), and each resumed run's next loss is within 1e-4 of the
    uninterrupted one-rank run's."""
    path, first = saved
    assert [s["step"] for s in first["saves"]] == [2]
    one = _one_rank_losses()
    for mesh in ("1x1x1", "1x2x2"):
        shutil.copytree(path / "a", path / mesh)
        out = _train(mesh, 4, ckpt_dir=str(path / mesh), digests=True)
        assert out["start_step"] == 3
        assert out["restored"] == [{"step": 2,
                                    "digest": first["saves"][0]["digest"]}]
        assert abs(out["losses"][0] - one[3]) <= TRAIN_TOL * abs(one[3])
