"""Training on a model axis: the port's tensor-parallel forward and
backward, its vocab-parallel cross-entropy, the train step on (pod x data
x model) grids of gloo ranks on the CPU, and grid checkpoints across grid
shapes.

The reference's own model-axis training does not run on this toolchain
(``test_zero1_multilevel_trains_identically_to_flat`` raises
``ShardingTypeError``; ROADMAP Queue 3 F), so the loss and gradients are
held to the port's one-rank ``loss_and_grads`` (itself held to the
reference by ``tests/test_torch_train.py``) and, in one case, to the
reference's ``jax.grad`` of ``loss_fn`` cut by its ``param_pspecs``.  The
update is held to the reference's ``apply_updates`` under ``jax.vmap``
over (pod, data, model) in ``tests/test_torch_sync_updates.py``.

The smoke configs of tinyllama and qwen3 have 4 heads and one KV head,
which no model axis of 2 or 4 divides as whole heads; their cases take 8
heads and 4 KV heads (GQA, G 2 on every rank at M 2 and 4), phi4-mini's
2 KV heads.  Each grid runs once per module (a fixture): 2x2x2 (8 ranks;
the first model group computes the gradient cases, then every rank trains
qwen3's trajectories, and the model index 0 ranks again on a 2x2x1 grid of
their own) and 1x1x4.  Tolerances: f32 gradients within 1e-5 x max|ref|
per leaf, losses within 1e-6 relative (one rank against the model
group: the row-parallel sums add in another order); against the
reference, ``tests/test_torch_train.py``'s f32 ones.
"""
import dataclasses
import functools
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_bridge import forked_ranks, ref_cut
from repro.models import sharding as JSH
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.step import device_batch, loss_and_grads
from repro_torch.launch.train import train
from repro_torch.models import transformer as T
from repro_torch.models.convert import (from_numpy, shard_params,
                                        stack_runs, to_numpy, unstack_runs)
from repro_torch.tree import tree_leaves, tree_map

GRAD_TOL = 1e-5      # x max|ref| per leaf, model group against one rank
LOSS_TOL = 1e-6      # relative
REF_GRAD_TOL = 1e-4  # tests/test_torch_train.py's f32 tolerances
REF_LOSS_TOL = 1e-5
TRAJ_TOL = 1e-4      # tests/test_torch_train.py's trajectory tolerance
TIMEOUT = 600.0

# name -> sequence length: S 1024 takes the flash path's plain versions
# and the chunked cross-entropy (two rematted chunks); S 100 the naive one
CASES = {"gpt_100m": 1024, "tinyllama_1p1b": 100, "qwen3_4b": 100,
         "gpt_100m/parallel": 100}


def _cfg(name):
    base = name.split("/")[0]
    cfg = configs.get_config(base, smoke=True)
    if base in ("tinyllama_1p1b", "qwen3_4b"):
        cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=4)
    if base == "phi4_mini_3p8b":
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    if name.endswith("/parallel"):
        cfg = dataclasses.replace(cfg, parallel_block=True)
    return cfg


def _params(cfg, f32=True):
    """The port's seed-0 weights in the stacked layout (numpy), in f32 or
    as initialised (bf16 weights, f32 norms)."""
    p = T.init_model(cfg, seed=0, device="cpu")
    if f32:
        p = tree_map(lambda t: t.float(), p)
    return to_numpy(stack_runs(p, cfg))


def _batch(cfg, S, B=2, step=0):
    return DataPipeline(cfg, ShapeSpec("test", "train", S, B)).host_batch(step)


def _pair(model):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((model, 6)).astype(np.float32),
            rng.standard_normal((model, 6)).astype(np.float32))


def _ce_inputs():
    """x (2, 24, 16), a head of 32 columns, labels in every rank's range
    at M 2 and 4 and some masked (-1)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    head = rng.standard_normal((16, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (2, 24))
    labels[0, :8] = np.arange(0, 32, 4)
    labels[1, ::5] = -1
    return x, labels, head


def _traj():
    """qwen3's trajectories: the reference test's batches (8 x 16 random
    tokens, labels = tokens, lr 1e-2, 2 warmup steps of 50), bf16 weights
    and the default clip, and f32 weights unclipped, the latter also on
    the 2x2x1 grid."""
    cfg = _cfg("qwen3_4b")
    batches = []
    for s in range(4):
        t = np.asarray(jax.random.randint(jax.random.PRNGKey(s % 2), (8, 16),
                                          0, cfg.vocab))
        batches.append({"tokens": t, "labels": t})
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=50)
    runs = [("bf16", ("flat", "multilevel"), kw, _params(cfg, f32=False),
             False),
            ("f32", ("flat", "multilevel"), dict(kw, clip_norm=1e9),
             _params(cfg), True)]
    return cfg, runs, batches


@functools.lru_cache(maxsize=None)
def _cases():
    """name -> (name, cfg, f32 params, batch) of each gradient case."""
    return {name: (name, _cfg(name), _params(_cfg(name)),
                   _batch(_cfg(name), S)) for name, S in CASES.items()}


@pytest.fixture(scope="module")
def runs():
    cases = list(_cases().values())
    out = {"cases": _cases()}
    out[2] = run_ranks(ranks.tp_train, 8, "gloo", (
        2, 2, 2, _pair(2), _ce_inputs(), cases, _traj()), timeout=TIMEOUT)
    out[4] = run_ranks(ranks.tp_train, 4, "gloo", (
        1, 1, 4, _pair(4), _ce_inputs(), cases), timeout=TIMEOUT)
    return out


def _group(runs, model):
    """The ranks of the first model group."""
    return runs[model][:model]


@pytest.mark.parametrize("model", [2, 4])
def test_copy_to_and_reduce_from_differentiate(runs, model):
    """``reduce_from``: the sum forward, the gradient passed through;
    ``copy_to``: the identity forward, the gradients summed; one
    collective each, the second in the backward."""
    xs, cs = _pair(model)
    for r in runs[model]:
        got = r["pair"]
        np.testing.assert_allclose(got["reduce_y"], xs.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(got["reduce_grad"], cs[0])
        np.testing.assert_array_equal(got["copy_z"], xs[0])
        np.testing.assert_allclose(got["copy_grad"], cs.sum(0), rtol=1e-6)
        assert list(got["calls"]) == [2, 1]


@pytest.mark.parametrize("model", [2, 4])
def test_vocab_parallel_ce_matches_full(runs, model):
    """The vocab-parallel cross-entropy of each rank's head columns
    against the full one, labels in every rank's range and masked: the
    loss, the input's gradient and each rank's columns' gradient."""
    x, labels, head = _ce_inputs()
    xt = torch.from_numpy(x).requires_grad_(True)
    ht = torch.from_numpy(head).requires_grad_(True)
    nll, cnt = T._ce_chunk(xt, torch.from_numpy(labels), ht)
    (nll / cnt).backward()
    n = head.shape[1] // model
    for m, r in enumerate(runs[model][:model]):
        got = r["ce"]
        assert float(got["cnt"]) == float(cnt) == (labels >= 0).sum()
        assert abs(float(got["nll"]) - nll.item()) <= LOSS_TOL * nll.item()
        gx, gh = xt.grad.numpy(), ht.grad.numpy()[:, m * n:(m + 1) * n]
        assert np.abs(got["x_grad"] - gx).max() <= GRAD_TOL * np.abs(gx).max()
        assert np.abs(got["head_grad"] - gh).max() \
            <= GRAD_TOL * np.abs(gh).max()


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    _, cfg, params, batch = _cases()[name]
    loss, grads = loss_and_grads(unstack_runs(from_numpy(
        params, device="cpu"), cfg), cfg, device_batch(batch, "cpu"))
    return loss.item(), stack_runs(grads, cfg)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_one_rank(runs, model, name):
    """Each rank's f32 loss and gradients against the one-rank ones and
    their model shards, every leaf (the replicated ones, norms and q/k
    norms included, whole); every rank of the group made the same
    model-axis collectives, in the forward, the remat's re-run and the
    backward."""
    cfg = runs["cases"][name][1]
    loss, grads = _one_rank(name)
    group = _group(runs, model)
    for m, r in enumerate(group):
        got = r[name]
        assert abs(float(got["loss"]) - loss) <= LOSS_TOL * abs(loss)
        want = to_numpy(shard_params(grads, cfg, model, m))
        gl, wl = tree_leaves(got["grads"]), tree_leaves(want)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()
    calls = [r[name]["calls"] for r in group]
    assert all(c == calls[0] for c in calls)
    assert calls[0]["fwd"] > 0 and calls[0]["bwd"] > 0, calls[0]
    # the remat re-runs a layer's forward only as far as the backward
    # needs it: the sequential block's first sum, none of the parallel
    # block's single sum
    assert (calls[0]["remat"] > 0) != cfg.parallel_block, calls[0]


def test_grads_match_reference_jax_grad(runs):
    """gpt-100m at S 1024 on a model axis of 2 against the reference's
    ``jax.grad`` of ``loss_fn`` on the same f32 weights and batch, cut by
    its ``param_pspecs``."""
    name, cfg, params, batch = runs["cases"]["gpt_100m"]
    jparams = jax.tree.map(jnp.asarray, params)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, cfg, b)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    specs = JSH.param_pspecs(jparams, 2)
    for m, r in enumerate(_group(runs, 2)):
        got = r[name]
        assert abs(float(got["loss"]) - float(jloss)) \
            <= REF_LOSS_TOL * abs(float(jloss))
        want = ref_cut(jax.tree.map(np.asarray, jgrads), specs, 2, m)
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda a: 0, got["grads"]))
        for g, w in zip(jax.tree.leaves(got["grads"]),
                        jax.tree.leaves(want)):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= REF_GRAD_TOL * np.abs(w).max()


def test_zero1_multilevel_trains_like_flat_on_a_model_axis(runs):
    """The port's counterpart of the reference's
    ``test_zero1_multilevel_trains_identically_to_flat``: qwen3 on 2x2x2,
    bf16, flat against ZeRO-1 multilevel within its 5e-3, losses falling;
    every rank reports the same losses; unclipped in f32 both equal the
    2x2x1 grid's on the same batches within 1e-4 relative."""
    res = runs[2]
    for run in ("bf16", "f32"):
        assert all(r[run] == res[0][run] for r in res)
    bf = res[0]["bf16"]
    for mode in ("flat", "multilevel"):
        assert bf[mode][-1] < bf[mode][0], (mode, bf[mode])
    np.testing.assert_allclose(bf["flat"], bf["multilevel"], rtol=5e-3,
                               atol=5e-3)
    grid1 = res[0]["grid1/f32"]
    for mode in ("flat", "multilevel"):
        for g, w in zip(res[0]["f32"][mode], grid1[mode]):
            assert abs(g - w) <= TRAJ_TOL * abs(w)


# ---------------------------------------------------------------------- #
# The entry point: train --mesh PxDxM
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["tinyllama_1p1b", "qwen3_4b",
                                  "phi4_mini_3p8b"])
def test_train_drives_a_model_axis(arch):
    """``train`` on 1x1x2: two spawned gloo ranks, finite losses, the
    same model-axis collectives on each step, no kernel launch on the
    CPU."""
    out = train(arch, 2, mesh_spec="1x1x2", seq=32, batch=2, smoke=True,
                device="cpu", config=_cfg(arch))
    assert out["model"] == 2 and out["world"] == 1
    assert out["rank"] == out["model_rank"] == 0
    assert len(out["losses"]) == 2 and all(map(math.isfinite,
                                               out["losses"]))
    assert len(out["tp_calls"]) == 2 and out["tp_calls"][0] \
        == out["tp_calls"][1] and min(out["tp_calls"][0].values()) > 0
    assert len(out["launches"]) == 2
    assert all(n == 0 for rank in out["launches"] for n in rank.values())


@pytest.mark.parametrize("arch,mesh", [("gpt-100m", "1x2x2"),
                                       ("recurrentgemma-2b", "1x1x2")])
def test_one_pod_failure_on_a_model_axis_carries_on(arch, mesh):
    """``fail_at`` on a model axis of one pod makes the reference's
    one-pod decision (``tests/test_torch_elastic.py``'s ``one_rank``
    case): nothing to shrink and no checkpoint, so a restart that carries
    on, with every step's loss."""
    out = train(arch, 2, mesh_spec=mesh, seq=32, batch=2, device="cpu",
                smoke=True, fail_at={1: [0]})
    assert (out["recoveries"], out["repairs"]) == (1, 0)
    assert out["events"] == [{"event": "failure", "step": 1, "failed": [0],
                              "accum": 1, "in_place": False}]
    assert out["model"] == 2 and out["pods"] == 1
    assert len(out["losses"]) == 2 and all(map(math.isfinite,
                                               out["losses"]))


@pytest.mark.parametrize("arch,mesh,kw,item", [
    # 16 experts whose 8192 features the axis cuts inside each
    ("llama4-scout-17b-a16e", "1x1x32", dict(smoke=False), "16 experts"),
    # an untied head of 32,000 rows cut by its 2048 rows
    ("tinyllama-1.1b", "1x1x512", dict(smoke=False),
     "32000 vocabulary rows"),
    ("rwkv6-1.6b", "1x1x8", {}, "Queue 1 item 5")])      # 4 heads
def test_what_a_model_axis_still_refuses(arch, mesh, kw, item):
    """Once refused, now admitted: llama4-scout's experts cut inside on
    32 ranks, tinyllama's untied head cut by rows on 512, RWKV-6's 4
    smoke heads cut inside on 8 (``tests/test_torch_tp_inside.py``
    trains each cut on 3 gloo ranks).  So many ranks are not spawned
    here: ``port_check`` admits the config, and a training step of the
    mesh builds every rank program on ``meta`` (``dryrun.dry_cell``; the
    full configs cut to 2 layers), with one reduce-scatter in the
    backward for each ``gather_to`` of a layer: q's, k's and v's, and the
    experts' hidden for llama4-scout, q's for tinyllama (4 columns a
    rank), the time mix's four for RWKV-6."""
    from repro_torch.launch.dryrun import dry_cell
    from repro_torch.launch.mesh import parse_mesh

    cfg = configs.get_config(arch, **{"smoke": True, **kw})
    if not kw.get("smoke", True):
        cfg = dataclasses.replace(cfg, n_layers=2, pattern=cfg.pattern[:2])
    pods, data, model = parse_mesh(mesh)
    T.port_check(cfg)
    rec = dry_cell(cfg, ShapeSpec("train", "train", 32, 2), pods, data,
                   model)
    assert sorted(m for p in rec["per_rank"].values()
                  for m in p["members"]) == list(range(model))
    gathers = {"llama4-scout-17b-a16e": 3, "tinyllama-1.1b": 1,
               "rwkv6-1.6b": 1}[arch]
    assert rec["collective_counts"]["reduce-scatter/fast"] == \
        gathers * cfg.n_layers


def _run(mesh, steps, ckpt_dir, **kw):
    return train("gpt-100m", steps, mesh_spec=mesh, seq=32, batch=4,
                 comm="multilevel_compress", smoke=True, device="cpu",
                 ckpt_dir=str(ckpt_dir), ckpt_every=2, digests=True, **kw)


def test_grid_checkpoints_cross_grid_shapes(tmp_path):
    """A checkpoint saved on 1x2x2 (the reference's global layout: the
    ZeRO-1 shards and EF rows gathered over data, then over model)
    restores on 1x2x1 and on one rank bit for bit, and one saved on one
    rank restores on 1x2x2; a 1x2x2 run resumed from its own checkpoint
    reports the uninterrupted run's loss."""
    first = _run("1x2x2", 4, tmp_path / "a")
    saved = first["saves"][0]
    assert saved["step"] == 2 and len(first["losses"]) == 4
    for name in ("b", "c", "d"):
        shutil.copytree(tmp_path / "a", tmp_path / name)
    for mesh, d in (("1x2x1", "b"), ("1x1x1", "c"), ("1x2x2", "d")):
        out = _run(mesh, 4, tmp_path / d)
        assert out["start_step"] == 3
        assert out["restored"] == [{"step": 2, "digest": saved["digest"]}]
        if mesh == "1x2x2":
            assert out["losses"] == first["losses"][3:]
    one = _run("1x1x1", 3, tmp_path / "e")
    back = _run("1x2x2", 3, tmp_path / "e")
    assert back["restored"] == [{"step": 2,
                                 "digest": one["saves"][0]["digest"]}]


# ---------------------------------------------------------------------- #
# The scatter axes beside the model shards
# ---------------------------------------------------------------------- #

# (arch, M, n, leaf) where the reference's opt specs, decided on the
# global shapes (``opt_manual_specs``, ``repro/launch/step.py:109``), pick
# another data-scatter dim than its update, decided on the model shards
# inside the inner ``shard_map``: seamless's 256,206-row embedding at M 2
# and n 6 divides by 6 whole but not as its 128,103-row shard
GLOBAL_VS_LOCAL = {("seamless_m4t_medium", 2, 6, "['embed']")}
# at the model-axis sizes where the reference's fallbacks place leaves, M
# and n share a factor (3 or 5): there a leaf whose model dim is the only
# one that divides by n is scattered on it by the global shapes, while
# its model shard does not divide by n and the update scatters it nowhere
# (791 leaves of 8 configs at M 3, 5, 6 and 12, n 3, 5 and 6)
FALLBACK_MODELS = (3, 5, 6, 12)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_scatter_axes_with_model_dims_match_reference(arch):
    """``convert.model_dims`` equals the reference's ``model_dims_of`` and
    the port's ``scatter_axes`` on the model shards equals the
    reference's, every leaf, at M 2-16 and data sizes 2-8; the global
    shapes decide alike but where ``GLOBAL_VS_LOCAL`` lists, and at M 3,
    5, 6 and 12 but for the reference's quirk of ``FALLBACK_MODELS``: the
    global shapes scatter a leaf on its model dim, whose shard does not
    divide by n, and the update scatters it nowhere."""
    from repro import configs as jconfigs
    from repro.launch import step as JSTEP
    from repro.optim import adamw as jadamw
    from repro_torch.models.convert import model_dims
    from repro_torch.optim import adamw

    jcfg = jconfigs.get_config(arch)
    shapes = jax.eval_shape(lambda k: JT.init_model(k, jcfg),
                            jax.random.PRNGKey(0))
    differ = set()
    for model in (2, 4, 8, 16) + FALLBACK_MODELS:
        jdims = JSTEP.model_dims_of(shapes, model)
        dims = model_dims(configs.get_config(arch), model)
        assert jax.tree.leaves(dims) == jax.tree.leaves(jdims)
        local = jax.tree.map(lambda a, md: jax.ShapeDtypeStruct(tuple(
            s // model if i == md else s for i, s in enumerate(a.shape)),
            a.dtype), shapes, jdims)
        for n in range(2, 9):
            want = jadamw.scatter_axes(local, n, jdims)
            got = adamw.scatter_axes(local, n, dims)
            flat = lambda t: jax.tree.leaves(t, is_leaf=lambda x: x is None)
            assert flat(got) == flat(want)
            glob = jax.tree_util.tree_flatten_with_path(
                jadamw.scatter_axes(shapes, n, jdims),
                is_leaf=lambda x: x is None)[0]
            for ((path, g), w, md, a) in zip(glob, flat(want),
                                             jax.tree.leaves(jdims),
                                             jax.tree.leaves(shapes)):
                if g == w:
                    continue
                if model in FALLBACK_MODELS:
                    assert (g, w) == (md, None) and \
                        (a.shape[md] // model) % n, (path, model, n)
                else:
                    differ.add((arch, model, n, jax.tree_util.keystr(path)))
    assert differ == {d for d in GLOBAL_VS_LOCAL if d[0] == arch}


@pytest.mark.parametrize("model", [2, 4])
def test_opt_state_cuts_and_joins_over_a_model_axis(model):
    """``shard_params`` cuts an optimiser state of the stacked layout (m,
    v, master along each leaf's model dim, the EF rows with their leading
    ``(n_slow,)`` ahead of the shard, the step whole) and
    ``unshard_params`` joins the ranks' cuts back bit for bit."""
    from repro_torch.models.convert import model_dims, unshard_params
    from repro_torch.optim import adamw

    cfg = _cfg("gpt_100m")
    params = from_numpy(_params(cfg), device="cpu")
    opt = adamw.init_opt_state(params, adamw.OptConfig(
        comm_mode="multilevel_compress"), n_slow=2)
    opt = tree_map(lambda t: t + torch.arange(t.numel()).reshape(
        t.shape).to(t.dtype) % 7, opt)
    cuts = [shard_params(opt, cfg, model, m) for m in range(model)]
    dims = model_dims(cfg, model)
    for k in ("m", "v", "master"):
        for t, c, d in zip(tree_leaves(opt[k]), tree_leaves(cuts[0][k]),
                           tree_leaves(dims)):
            want = list(t.shape)
            if d >= 0:
                want[d] //= model
            assert list(c.shape) == want
    for t, c, d in zip(tree_leaves(opt["ef"]), tree_leaves(cuts[1]["ef"]),
                       tree_leaves(dims)):
        assert c.shape[0] == 2 and (d < 0 or c.shape[d + 1] * model
                                    == t.shape[d + 1])
    back = unshard_params(cuts, cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(opt)))
