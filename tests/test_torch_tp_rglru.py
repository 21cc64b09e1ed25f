"""The RG-LRU family and the KV-head split on a model axis, served and
trained on gloo ranks on the CPU, against the port's one-rank model and
the reference.

The RG-LRU runs on R/M channels a rank: ``w_x``, ``w_gate``, ``w_a`` and
``w_i`` by columns, ``conv`` and ``lam`` replicated and read on the
rank's channels through one ``copy_to``, the conv output gathered over
the axis for the gate products (``Axis.gather_to``: the all-gather
forward, a reduce-scatter backward), the scan and its state on the
rank's channels.  ``w_out`` takes the reference's "expert" rule: on a
run of 2 layers at M 2 the reference splits the run's layers
(``sharding.RUN_DIM``), the per-layer serving tree keeps the leaf whole
and the rank uses its rows (a partial sum), and training gathers the
stacked shard along the run dim (``convert.unstack_runs``); at M 4 it is
split by columns.  ``wk``/``wv`` keep the reference's flat cut, inside a
head where the axis does not divide the KV heads: k and v are gathered
over the axis and each rank keeps the KV heads its query heads read.

Configs, the reference's ``init_model(PRNGKey(0))`` weights in f32:
recurrentgemma-2b's smoke config (rglru, rglru, local; 4 heads, one KV
head) at M 2 and 4, its dense cache split over the sequence (``s_max``
24) or holding the rank's KV head (the ``/kv`` case, ``s_max`` 7);
qwen3-4b's and tinyllama-1.1b's (4 heads, one KV head) and gemma3-12b's
(two KV heads, each read by two ranks at M 4), served paged and dense;
and qwen3's with 8 heads of 6 dims at M 4, whose ``wk``/``wv`` the
reference's fallback cuts by rows (d_model 64: a partial k and v, summed
over the axis) or keeps whole (d_model 66: read through ``copy_to``).
Four gloo ranks are spawned once for the module: a 1x1x4 grid, then
1x2x2, whose first model group computes, and takes one clipped train step
as a 1x1x2 grid.  Each rank's decode step starts from the one-rank run's
cache of that step, cut for the rank.

Tolerances: prefill, decode and full-forward logits within 1e-5 of the
one-rank port (``tests/test_torch_tp.py``'s f32 ones; a paged decode step
within its 1e-4), the forward also of the reference's ``model_fwd``; the
f32 RG-LRU state within 1e-5 of its largest entry, bf16 cache leaves
within 1e-2; the loss within 1e-5 relative and each gradient leaf within
1e-4 of its largest entry (of one rank's, and for recurrentgemma of the
reference's ``jax.value_and_grad``); the step's parameters and state
within 1e-6 of the reference's ``apply_updates`` under ``jax.vmap`` on
the same gradients (``tests/test_torch_sync_updates.py``'s); ``train`` on
1x1x2 within 1e-4 of one rank's losses.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

import _torch_ranks as ranks
from _torch_bridge import (cast_tree, forked_ranks, jax_to_numpy, model_cut,
                           rank_opt, ref_cut, vmap_ranks)
from repro.models import sharding as JSH
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.step import device_batch, loss_and_grads
from repro_torch.launch.train import train
from repro_torch.models.convert import (from_numpy, shard_params,
                                        unstack_runs)
from repro_torch.tree import tree_leaves, tree_paths

TOL = 1e-5           # f32 logits, sharded against unsharded and reference
PAGED_TOL = 1e-4     # a paged decode step (tests/test_torch_tp.py)
STATE_TOL = 1e-5     # x max|h|, the f32 RG-LRU state
CACHE_TOL = 1e-2     # bf16 cache leaves (tests/test_torch_tp.py)
LOSS_TOL = 1e-5      # relative
GRAD_TOL = 1e-4      # x max|g| per leaf
UPDATE_TOL = 1e-6    # x max|ref|, tests/test_torch_sync_updates.py
TRAIN_TOL = 1e-4     # relative
OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=5, comm_mode="multilevel",
              zero1=True)           # clip_norm 1.0: the step clips
STEPS = 4

RG = "recurrentgemma_2b"
# name -> (model-axis sizes, paths, trained)
CASES = {RG: ((2, 4), "family", True), RG + "/kv": ((2, 4), "family", False),
         "qwen3_4b": ((2, 4), "model", True),
         "tinyllama_1p1b": ((2, 4), "model", True),
         "gemma3_12b": ((4,), "model", True),
         "qwen3_4b/rows": ((4,), "model", True),
         "qwen3_4b/whole": ((4,), "model", True)}
# wk/wv of 6 columns that 4 ranks cannot split: the reference's fallback
# cuts their rows (d_model 64), or keeps them whole (d_model 66)
VARIANTS = {"qwen3_4b/rows": dict(n_heads=8, head_dim=6),
            "qwen3_4b/whole": dict(n_heads=8, head_dim=6, d_model=66)}
ALL = [(m, n) for n, (ms, _, _) in CASES.items() for m in ms]
IDS = [f"{m}-{n}" for m, n in ALL]
TRAINED = [(m, n) for m, n in ALL if CASES[n][2]]


def _cfg(name):
    return dataclasses.replace(configs.get_config(name.split("/")[0],
                                                  smoke=True),
                               **VARIANTS.get(name, {}))


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The reference's seed-0 weights of case ``name``'s config, f32,
    numpy, the stacked layout."""
    return jax_to_numpy(cast_tree(JT.init_model(jax.random.PRNGKey(0),
                                                _cfg(name)), jnp.float32))


def _inputs(name):
    cfg = _cfg(name)
    rng = np.random.default_rng(13)
    if CASES[name][1] == "model":         # tests/test_torch_tp.py's
        S_p, L_ = 8, 6
        toks = np.zeros((1, S_p), np.int64)
        toks[0, :L_] = rng.integers(0, cfg.vocab, L_)
        return {"BS": 4, "L": L_, "S_p": S_p, "max_blocks": 4, "toks": toks,
                "forced": rng.integers(0, cfg.vocab, (5, 1)),
                "dense": rng.integers(0, cfg.vocab, (2, 16)), "s_max": 24,
                "dense_forced": rng.integers(0, cfg.vocab, (6, 2, 1))}
    if name.endswith("/kv"):              # a ring of 7: no sequence split
        return {"tokens": rng.integers(0, cfg.vocab, (2, 4)), "s_max": 7,
                "forced": rng.integers(0, cfg.vocab, (3, 2, 1))}
    return {"tokens": rng.integers(0, cfg.vocab, (2, 16)), "s_max": 24,
            "forced": rng.integers(0, cfg.vocab, (4, 2, 1))}


def _batch(name):
    return DataPipeline(_cfg(name), ShapeSpec("test", "train", 100,
                                              2)).host_batch(0)


def _gather_inputs(model):
    rng = np.random.default_rng(6)
    return (rng.standard_normal((model, 3, 5)).astype(np.float32),
            rng.standard_normal((model, 5 * model, 4)).astype(np.float32),
            rng.standard_normal((3, 4)).astype(np.float32))


@pytest.fixture(scope="module")
def runs():
    """The one-rank runs (their caches before each decode step go to the
    ranks) and the four ranks', one spawn."""
    cases, whole = [], {}
    for name, (models, paths, trained) in CASES.items():
        cfg, jp, ins = _cfg(name), _weights(name), _inputs(name)
        fn = ranks.family_paths if paths == "family" else ranks.model_paths
        whole[name] = fn(unstack_runs(from_numpy(jp, device="cpu"), cfg),
                         cfg, ins)
        for key in ("caches_before", "pools_before"):
            if key in whole[name]:
                ins[key] = whole[name].pop(key)
        cases.append((name, cfg, models, paths, jp, ins,
                      _batch(name) if trained else None))
    step = (_cfg(RG), _weights(RG), _batch(RG), OPT_KW)
    res = run_ranks(ranks.tp_rglru, 4, "gloo",
                    (cases, {m: _gather_inputs(m) for m in (2, 4)}, step),
                    timeout=600.0)
    return {"whole": whole, 4: res[:4], 2: res[:2]}


def _group(runs, model, name):
    return [r[model, name] for r in runs[model]]


PATH_KEYS = {"family": ("prefill", "steps", "fwd"),
             "model": ("paged_prefill", "paged_steps", "dense_prefill",
                       "dense_steps", "fwd")}


@pytest.mark.parametrize("model,name", ALL, ids=IDS)
def test_prefill_and_decode_match_one_rank(runs, model, name):
    """Every rank's logits: the dense prefill and decode steps (the
    sequence-parallel decode where M divides the cache, the rank's KV
    head in the ``/kv`` case) and the full forward, and for the attention
    configs the paged prefill and steps: equal across the ranks, within
    1e-5 of the one-rank port (a paged step within 1e-4)."""
    group, want = _group(runs, model, name), runs["whole"][name]
    for key in PATH_KEYS[CASES[name][1]]:
        got = group[0][key]
        for r in group[1:]:
            np.testing.assert_array_equal(r[key], got)
        assert got.shape == want[key].shape, key
        np.testing.assert_allclose(
            got, want[key], rtol=0, err_msg=key,
            atol=PAGED_TOL if key == "paged_steps" else TOL)


# leaf -> its sharded dims in the prefill's cache: the RG-LRU's h
# (n, B, R) and conv (n, B, 3, R) by channels; k and v (n, B, S, Hkv, hd)
# by the sequence, or whole where each rank holds the one KV head
_SHARDED = {(False, "h"): [2], (False, "conv"): [3], (False, "k"): [2],
            (False, "v"): [2], (True, "h"): [2], (True, "conv"): [3],
            (True, "k"): [], (True, "v"): []}


@pytest.mark.parametrize("model,name", [(m, n) for m, n in ALL
                                        if n.startswith(RG)],
                         ids=[i for i in IDS if RG in i])
def test_prefill_cache_is_the_one_rank_cache(runs, model, name):
    """The prefill's cache, in ``init_cache(tp=)``'s layout, joined over
    the ranks along its sharded dim, is the one-rank cache: the RG-LRU's
    state and conv inputs by channels, the local layer's k and v by the
    sequence, or the one KV head on every rank."""
    group, want = _group(runs, model, name), runs["whole"][name]
    for run, (parts, full) in enumerate(zip(
            zip(*[r["cache"] for r in group]), want["cache"])):
        for k, w in full.items():
            assert all(p[k].shape == group[0]["init_shapes"][run][k]
                       for p in parts)
            dims = [d for d in range(w.ndim) if parts[0][k].shape[d]
                    != w.shape[d]]
            assert dims == _SHARDED[name.endswith("/kv"), k], (k, dims)
            if dims:
                got = np.concatenate([p[k] for p in parts], dims[0])
            else:
                got = parts[0][k]
                for p in parts[1:]:
                    np.testing.assert_array_equal(p[k], got)
            tol = STATE_TOL * np.abs(w).max() if k == "h" else CACHE_TOL
            np.testing.assert_allclose(got, w, atol=tol, rtol=0,
                                       err_msg=f"{run}/{k}")


@pytest.mark.parametrize("model,name", [(m, n) for m, n in ALL
                                        if n.startswith(RG)],
                         ids=[i for i in IDS if RG in i])
def test_collectives_a_prefill_and_a_step(runs, model, name):
    """The model axis's collectives, the same on every rank: the
    embedding's sum and the logits' gather; an RG-LRU layer's conv-output
    gather, its output's sum (M 2: ``w_out``'s rows) or its two gathers
    (M 4: by columns), and the MLP's sum; the local layer's k/v gather,
    attention sum and MLP sum; the prefill's two gathers that split the
    cache over the sequence, and a sequence-parallel step's gather of q
    and its combine's max and two sums."""
    seq = not name.endswith("/kv")
    rglru = 3 if model == 2 else 4
    prefill = 2 + 2 * rglru + 3 + 2 * seq
    step = 2 + 2 * rglru + 3 + 4 * seq
    for r in _group(runs, model, name):
        assert int(r["prefill_calls"]) == prefill
        assert r["step_calls"] == [step] * len(_inputs(name)["forced"])


def test_sharded_reference_weights_give_the_reference_logits(runs):
    """The ranks' full forward on their shards of the reference's weights
    is the reference's one-device ``model_fwd`` on those weights and
    inputs, within 1e-5, at every model size of every case."""
    for model, name in ALL:
        want = _ref_fwd(name)
        for r in _group(runs, model, name):
            np.testing.assert_allclose(r["fwd"], want, atol=TOL, rtol=0,
                                       err_msg=f"{model}-{name}")


@functools.lru_cache(maxsize=None)
def _ref_fwd(name):
    """The reference's ``model_fwd`` logits of case ``name``'s dense
    tokens."""
    ins = _inputs(name)
    toks = ins["tokens"] if "tokens" in ins else ins["dense"]
    return np.asarray(JT.model_fwd(jax.tree.map(jnp.asarray, _weights(name)),
                                   _cfg(name), {"tokens": jnp.asarray(toks)}))


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    cfg = _cfg(name)
    loss, grads = loss_and_grads(from_numpy(_weights(name), device="cpu"),
                                 cfg, device_batch(_batch(name), "cpu"))
    return loss.item(), grads


def _check_grads(got, want):
    gl, wl = tree_paths(got), tree_leaves(want)
    assert len(gl) == len(wl)
    for (path, g), w in zip(gl, wl):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), path


@pytest.mark.parametrize("model,name", TRAINED,
                         ids=[f"{m}-{n}" for m, n in TRAINED])
def test_loss_and_grads_match_one_rank(runs, model, name):
    """Each rank's f32 loss and gradients of its stacked shard against
    the one-rank ones cut to it, every leaf: the RG-LRU's column-split
    leaves, ``conv`` and ``lam`` (replicated, summed by ``copy_to``),
    ``w_out`` (M 2: the rank's layer of the run, its gradient handed back
    by ``gather_to``'s reduce-scatter; M 4: its columns), ``wk``/``wv``
    cut inside a head; every rank made the same model-axis collectives
    in the forward, the remat's re-run and the backward."""
    cfg = _cfg(name)
    loss, grads = _one_rank(name)
    group = _group(runs, model, name)
    for m, got in enumerate(group):
        assert abs(float(got["loss"]) - loss) <= LOSS_TOL * abs(loss)
        _check_grads(got["grads"], [t.numpy() for t in tree_leaves(
            shard_params(grads, cfg, model, m))])
    calls = [r["calls"] for r in group]
    assert all(c == calls[0] for c in calls)
    assert min(calls[0].values()) > 0, calls[0]


@pytest.mark.parametrize("model", [2, 4])
def test_rglru_grads_match_reference_jax_grad(runs, model):
    """recurrentgemma's smoke config on a model axis of 2 (``w_out`` on
    the run dim) and 4 (by columns) against the reference's
    ``jax.value_and_grad`` of ``loss_fn`` on the same f32 weights and
    batch, cut by its ``param_pspecs``: the loss and every leaf of each
    rank."""
    cfg = _cfg(RG)
    jparams = jax.tree.map(jnp.asarray, _weights(RG))
    jloss, jgrads = _ref_loss_and_grads()
    specs = JSH.param_pspecs(jparams, model)
    for m, got in enumerate(_group(runs, model, RG)):
        assert abs(float(got["loss"]) - jloss) <= LOSS_TOL * abs(jloss)
        want = ref_cut(jgrads, specs, model, m)
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda a: 0, got["grads"]))
        _check_grads(got["grads"], jax.tree.leaves(want))
    assert cfg.runs()[0] == ("rglru", 2)


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads():
    cfg = _cfg(RG)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, cfg, b)))(
        jax.tree.map(jnp.asarray, _weights(RG)),
        {k: jnp.asarray(v) for k, v in _batch(RG).items()})
    return float(jloss), jax.tree.map(np.asarray, jgrads)


class _ExactNorm:
    """``jnp`` for ``repro.optim.adamw`` with an f64 ``vdot``, as
    ``tests/test_torch_sync_updates.py`` holds a clipped step."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def vdot(a, b):
        f = lambda x, y: np.asarray(np.vdot(np.asarray(x, np.float64),
                                            np.asarray(y, np.float64)),
                                    np.float32)
        return jax.pure_callback(f, jax.ShapeDtypeStruct((), jnp.float32),
                                 a, b, vmap_method="sequential")


def test_clipped_step_on_1x1x2_matches_reference_update(runs, monkeypatch):
    """One ``make_train_step`` step of recurrentgemma's smoke config on
    1x1x2, ZeRO-1 multilevel, clipped at 1.0, against the reference's
    ``apply_updates`` under ``jax.vmap`` over a ``model`` axis on each
    rank's shard of the parameters and state and on the gradients the
    rank synced: the parameters and m, v and master within 1e-6 of their
    largest entry.  The stacked layout's model dims are the reference's
    (``w_out``'s is the run dim); the clipped norm counts ``w_out`` once
    and the replicated ``conv``, ``lam`` and norms on each model rank, as
    the reference's does."""
    monkeypatch.setattr(jadamw, "jnp", _ExactNorm())
    cfg = _cfg(RG)
    got = [r["step"] for r in runs[2]]
    params = jax.tree.map(jnp.asarray, _weights(RG))
    mdims = jax.tree.map(
        lambda s: list(s).index("model") if "model" in s else -1,
        JSH.param_pspecs(params, 2),
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert got[0]["mdims"] == mdims
    assert mdims["runs"][0]["rec"]["w_out"] == 0
    jcfg = jadamw.OptConfig(**OPT_KW)
    opt = rank_opt(jadamw.init_opt_state(params, jcfg), params, jcfg, 1, 1,
                   2, mdims)
    lead = lambda *a: jnp.stack(a)[None, None]
    local = jax.tree.map(lead, *[jax.tree.map(
        lambda a, md: model_cut(a, md, 2, m), params, mdims)
        for m in range(2)])
    grads = jax.tree.map(lambda *a: lead(*map(jnp.asarray, a)),
                         *[g["grads"] for g in got])
    gnorm = np.sqrt(sum(float(np.vdot(a, a)) for g in got
                        for a in jax.tree.leaves(g["grads"])))
    assert gnorm > jcfg.clip_norm
    fn = jax.jit(vmap_ranks(lambda p, g, o: jadamw.apply_updates(
        p, g, o, jcfg, None, 1, 1, mdims, model_axis="model"), model=True))
    new_p, new_o = jax_to_numpy(fn(local, grads, opt))
    for m, r in enumerate(got):
        assert abs(float(r["loss"]) - _one_rank(RG)[0]) \
            <= LOSS_TOL * _one_rank(RG)[0]
        for mine, ref in ((r["params"], new_p),
                          ({k: r["opt"][k] for k in ("m", "v", "master")},
                           {k: new_o[k] for k in ("m", "v", "master")})):
            ref = jax.tree.map(lambda a: a[0, 0, m], ref)
            assert jax.tree.structure(ref) == jax.tree.structure(
                jax.tree.map(lambda a: 0, mine))
            for g, w in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
                assert g.shape == w.shape and g.dtype == w.dtype
                assert np.abs(g - w).max() <= UPDATE_TOL * max(
                    np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("model", [2, 4])
def test_gather_to_differentiates(runs, model):
    """``gather_to``: the all-gather forward (the ranks' slices in rank
    order), and backward the sum over the axis of the ranks' partial
    gradients of a consumer each rank computes on its own
    (``gathered @ ws[m]``), one reduce-scatter: the slice's gradient of
    the one-rank sum of every rank's product."""
    import torch

    xs, ws, c = _gather_inputs(model)
    x = torch.from_numpy(np.concatenate(list(xs), -1)).requires_grad_(True)
    sum(((x @ torch.from_numpy(w)) * torch.from_numpy(c)).sum()
        for w in ws).backward()
    k = xs.shape[-1]
    for m, r in enumerate(runs[model]):
        got = r[model, "gather"]
        np.testing.assert_array_equal(got["y"], np.concatenate(list(xs), -1))
        np.testing.assert_allclose(got["grad"],
                                   x.grad.numpy()[:, m * k:(m + 1) * k],
                                   rtol=1e-6, atol=1e-6)
        assert list(got["calls"]) == [2, 1]


# ---------------------------------------------------------------------- #
# The entry point: train --mesh 1x1x2
# ---------------------------------------------------------------------- #

def _train(arch, mesh, **kw):
    return train(arch, STEPS, mesh_spec=mesh, seq=32, batch=4,
                 smoke=True, device="cpu", config=_cfg(arch),
                 init_params=_weights(arch), **kw)


@pytest.mark.parametrize("arch", [RG, "qwen3_4b"])
def test_train_drives_a_model_axis(arch, tmp_path):
    """``train`` in f32 on 1x1x2 (recurrentgemma's ``w_out`` on the run
    dim; qwen3's one KV head split) within 1e-4 of one rank's losses, the
    same model-axis collectives each step on every rank, no kernel launch
    on the CPU.  Its checkpoint of step 2 (each rank's shard gathered
    over the axis into the reference's global layout: ``w_out`` along the
    run dim, ``wk``/``wv`` along their columns) restores bit for bit on
    one rank, whose next loss is the uninterrupted run's."""
    out = _train(arch, "1x1x2", ckpt_dir=str(tmp_path / "a"), ckpt_every=2,
                 digests=True)
    one = _train(arch, "1x1x1")
    assert out["model"] == 2 and len(out["losses"]) == STEPS
    for g, o in zip(out["losses"], one["losses"]):
        assert np.isfinite(g) and abs(g - o) <= TRAIN_TOL * abs(o)
    assert all(c == out["tp_calls"][0] for c in out["tp_calls"])
    assert min(out["tp_calls"][0].values()) > 0
    assert all(n == 0 for rank in out["launches"] for n in rank.values())
    assert [s["step"] for s in out["saves"]] == [2]
    resumed = _train(arch, "1x1x1", ckpt_dir=str(tmp_path / "a"),
                     digests=True)
    assert resumed["start_step"] == 3
    assert resumed["restored"] == [{"step": 2,
                                    "digest": out["saves"][0]["digest"]}]
    assert abs(resumed["losses"][0] - one["losses"][3]) \
        <= TRAIN_TOL * abs(one["losses"][3])
