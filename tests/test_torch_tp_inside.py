"""A model axis of 3 that cuts a leaf inside the unit its consumer reads
whole, served and trained on three gloo ranks on the CPU, against the
port's one-rank model and the reference; and the full configs whose
production meshes take these cuts, dry-run on the ``meta`` device.

Where the axis divides the dim of the reference's fallback but not the
unit (``repro/models/sharding.py`` ``_spec_for``), the leaf is cut inside
it, and GSPMD computes the layout that results.  The port computes each
cut from the leaf's shard:

* an expert's ``w_in``/``w_gate`` by its features (the axis divides
  ``d_ff_expert`` but not the experts): each rank's feature columns of
  every expert's hidden, gathered whole (``gather_to``) for its columns of
  ``w_out``, or times its rows of a whole ``w_out``, a partial sum;
* RWKV-6's time-mix columns inside a head (the axis divides ``d_model``
  but not the heads): the ranks' columns of r, k, v and the decay
  gathered, the WKV on the heads the rank's columns meet, and its own
  columns of the output times its rows of ``w_o``;
* an untied head by rows (the axis divides ``d_model`` but not the
  vocabulary): the rank's slice of the hidden states times its rows,
  partial logits summed over the axis.

Variants of the smoke configs (the reference's ``init_model(PRNGKey(0))``
weights in f32), each with a full config's placement on M 3:

* ``llama4_scout_17b_a16e/d48f48``: 4 experts of 48 features on a 48-wide
  model, ``w_in``/``w_gate`` by features and ``w_out`` by the columns of
  its output (llama4-scout on M 32);
* ``llama4_scout_17b_a16e/f48``: 48 features on a 64-wide model,
  ``w_in``/``w_gate`` by features and ``w_out`` whole;
* ``rwkv6_1p6b/d48h24``: 2 heads of 24 columns, 16 columns a rank: rank 1
  holds parts of both heads (rwkv6-1.6b on M 64);
* ``tinyllama_1p1b/d48v511``: an untied head of 511 rows cut by its 48
  rows (tinyllama on M 512).

Tolerances, ``tests/test_torch_tp_fallback.py``'s: prefill, decode and
full-forward logits within 1e-5 of the one-rank port (a paged step within
1e-4), the forward also of the reference's ``model_fwd``; the loss within
1e-5 relative and each gradient leaf within 1e-4 of its largest entry, of
one rank's and of the reference's ``jax.value_and_grad`` (llama4-scout's
top-1 router under 1e-6 of the largest entry of any leaf).  A whole
leaf's gradient is equal bit for bit on the three ranks.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_bridge import cast_tree, forked_ranks, jax_to_numpy, ref_cut
from repro import configs as jconfigs
from repro.models import sharding as JSH
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.step import device_batch, loss_and_grads
from repro_torch.models.convert import (from_numpy, model_dims,
                                        shard_params, unstack_runs)
from repro_torch.models.sharding import rwkv_heads
from repro_torch.tree import tree_leaves, tree_paths

TOL = 1e-5           # f32 logits, sharded against unsharded and reference
PAGED_TOL = 1e-4     # a paged decode step (tests/test_torch_tp.py)
LOSS_TOL = 1e-5      # relative
GRAD_TOL = 1e-4      # x max|g| per leaf
ZERO_TOL = 1e-6      # x max|g| over the leaves: a top-1 router's
M = 3

# name -> (config changes, paths)
CASES = {
    "llama4_scout_17b_a16e/d48f48": (dict(
        d_model=48, n_heads=6, n_kv_heads=2), 48, "model"),
    "llama4_scout_17b_a16e/f48": ({}, 48, "model"),
    "rwkv6_1p6b/d48h24": (dict(d_model=48, rwkv_head_dim=24), None,
                          "family"),
    "tinyllama_1p1b/d48v511": (dict(d_model=48, vocab=511), None, "model"),
}
NAMES = list(CASES)


def _replace(cfg, name):
    kw, fe, _ = CASES[name]
    cfg = dataclasses.replace(cfg, **kw)
    if fe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=fe))
    return cfg


def _cfg(name):
    return _replace(configs.get_config(name.split("/")[0], smoke=True), name)


def _jcfg(name):
    return _replace(jconfigs.get_config(name.split("/")[0], smoke=True),
                    name)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The reference's seed-0 weights of case ``name``'s config, f32,
    numpy, the stacked layout."""
    init = jax.jit(JT.init_model, static_argnums=1)
    return jax_to_numpy(cast_tree(init(jax.random.PRNGKey(0), _jcfg(name)),
                                  jnp.float32))


def _inputs(name):
    cfg = _cfg(name)
    rng = np.random.default_rng(29)
    if CASES[name][2] == "model":         # tests/test_torch_tp.py's
        S_p, L_ = 8, 6
        toks = np.zeros((1, S_p), np.int64)
        toks[0, :L_] = rng.integers(0, cfg.vocab, L_)
        return {"BS": 4, "L": L_, "S_p": S_p, "max_blocks": 4, "toks": toks,
                "forced": rng.integers(0, cfg.vocab, (4, 1)),
                "dense": rng.integers(0, cfg.vocab, (2, 16)), "s_max": 24,
                "dense_forced": rng.integers(0, cfg.vocab, (3, 2, 1))}
    return {"tokens": rng.integers(0, cfg.vocab, (2, 16)), "s_max": 24,
            "forced": rng.integers(0, cfg.vocab, (3, 2, 1))}


def _batch(name):
    return DataPipeline(_cfg(name), ShapeSpec("test", "train", 64,
                                              2)).host_batch(0)


@pytest.fixture(scope="module")
def runs():
    """The one-rank runs (their caches before each decode step go to the
    ranks) and the three ranks', one spawn."""
    cases, whole = [], {}
    for name, (_, _, paths) in CASES.items():
        cfg, jp, ins = _cfg(name), _weights(name), _inputs(name)
        fn = ranks.family_paths if paths == "family" else ranks.model_paths
        whole[name] = fn(unstack_runs(from_numpy(jp, device="cpu"), cfg),
                         cfg, ins)
        for key in ("caches_before", "pools_before"):
            if key in whole[name]:
                ins[key] = whole[name].pop(key)
        cases.append((name, cfg, (M,), paths, jp, ins, _batch(name)))
    res = run_ranks(ranks.tp_fallback, M, "gloo", (cases,), timeout=600.0)
    return {"whole": whole, "ranks": res}


def _group(runs, name):
    return [r[M, name] for r in runs["ranks"]]


# the first layer's leaves that the variant cuts inside a unit, and how
INSIDE = {
    "llama4_scout_17b_a16e/d48f48": {"mlp/w_in": -1, "mlp/w_gate": -1,
                                     "mlp/w_out": -1},
    "llama4_scout_17b_a16e/f48": {"mlp/w_in": -1, "mlp/w_gate": -1,
                                  "mlp/w_out": None},
    "rwkv6_1p6b/d48h24": {"rwkv/w_r": -1, "rwkv/w_k": -1, "rwkv/w_o": -2,
                          "rwkv/u": None},
    "tinyllama_1p1b/d48v511": {"lm_head": -2, "embed": None},
}


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _spec_dim(spec):
    spec = tuple(spec)
    return spec.index("model") if "model" in spec else -1


@pytest.mark.parametrize("name", NAMES)
def test_the_variant_has_the_full_configs_placement(name):
    """Every leaf of the variant is cut on M 3 where the reference's
    ``param_pspecs`` cuts it (its rules and fallbacks), the leaves that
    the variant is about as the description says (a dim counted from the
    end, None: whole); RWKV-6's ranks meet its heads as a rank of
    rwkv6-1.6b on M 64 meets them (a head shared by two ranks, from an
    offset inside it)."""
    cfg, jp = _cfg(name), _weights(name)
    dims = model_dims(cfg, M)
    specs = JSH.param_pspecs(jax.tree.map(jnp.asarray, jp), M)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    want = [_spec_dim(s) for s in jax.tree.leaves(specs, is_leaf=is_spec)]
    assert tree_leaves(dims) == want
    for path, cut in INSIDE[name].items():
        top = path if path in dims else None
        d = dims[top] if top else _leaf(dims["runs"][0], path)
        nd = (jp[top] if top else _leaf(jp["runs"][0], path)).ndim
        assert d == (-1 if cut is None else nd + cut), path
    if "rwkv" in name:
        spans = [rwkv_heads(cfg, M, m) for m in range(M)]
        assert [(s.h0, s.nh, s.off, s.cols) for s in spans] == [
            (0, 1, 0, 16), (0, 2, 16, 16), (1, 1, 8, 16)]
        full = configs.get_config("rwkv6-1.6b")
        assert [tuple(rwkv_heads(full, 64, m)) for m in (0, 1, 63)] == [
            (0, 1, 0, 32), (0, 1, 32, 32), (31, 1, 32, 32)]


PATH_KEYS = {"family": ("prefill", "steps", "fwd"),
             "model": ("paged_prefill", "paged_steps", "dense_prefill",
                       "dense_steps", "fwd")}


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_one_rank(runs, name):
    """Every rank's logits: the dense prefill and decode steps, the paged
    prefill and steps of the attention configs, and the full forward:
    equal across the ranks, within 1e-5 of the one-rank port (a paged
    step within 1e-4); every rank made the same model-axis collectives
    in each; RWKV-6's prefill cache holds ``init_cache(tp=)``'s shapes,
    the state of the heads each rank meets."""
    group, want = _group(runs, name), runs["whole"][name]
    for key in [k for k in group[0] if k.endswith("_calls")]:
        assert all(np.array_equal(r[key], group[0][key]) for r in group), key
    for key in PATH_KEYS[CASES[name][2]]:
        got = group[0][key]
        for r in group[1:]:
            np.testing.assert_array_equal(r[key], got)
        assert got.shape == want[key].shape, key
        np.testing.assert_allclose(
            got, want[key], rtol=0, err_msg=key,
            atol=PAGED_TOL if key == "paged_steps" else TOL)
    if "rwkv" in name:
        for m, r in enumerate(group):
            assert [{k: v.shape for k, v in e.items()} for e in r["cache"]] \
                == r["init_shapes"]
            h0, nh = rwkv_heads(_cfg(name), M, m)[:2]
            np.testing.assert_allclose(
                r["cache"][0]["S"], want["cache"][0]["S"][:, :, h0:h0 + nh],
                atol=TOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _ref_fwd(name):
    """The reference's ``model_fwd`` logits of case ``name``'s dense
    inputs."""
    ins = _inputs(name)
    toks = ins["tokens"] if "tokens" in ins else ins["dense"]
    cfg = _jcfg(name)
    return np.asarray(jax.jit(lambda p, t: JT.model_fwd(
        p, cfg, {"tokens": t}))(jax.tree.map(jnp.asarray, _weights(name)),
                                jnp.asarray(toks)))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_reference_weights_give_the_reference_logits(runs, name):
    """The ranks' full forward on their shards of the reference's weights
    is the reference's one-device ``model_fwd`` on those weights and
    inputs, within 1e-5."""
    want = _ref_fwd(name)
    for r in _group(runs, name):
        np.testing.assert_allclose(r["fwd"], want, atol=TOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    cfg = _cfg(name)
    loss, grads = loss_and_grads(from_numpy(_weights(name), device="cpu"),
                                 cfg, device_batch(_batch(name), "cpu"))
    return loss.item(), grads


def _check_grads(got, want, cfg):
    """Each leaf within GRAD_TOL of its largest entry; llama4-scout's
    top-1 router, whose renormalised gate is 1 (a zero gradient but for
    rounding), under ZERO_TOL of the largest entry of any leaf."""
    gl, wl = tree_paths(got), [np.asarray(w) for w in tree_leaves(want)]
    assert len(gl) == len(wl)
    top = max(np.abs(w).max() for w in wl)
    for (path, g), w in zip(gl, wl):
        assert g.shape == w.shape, path
        if cfg.moe is not None and cfg.moe.top_k == 1 \
                and path.endswith("router"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= ZERO_TOL * top
        else:
            assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), path


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_one_rank(runs, name):
    """Each rank's f32 loss and gradients of its stacked shard against
    the one-rank ones cut to it, every leaf; a whole leaf's gradient is
    equal bit for bit on every rank (it is not summed over the axis, or
    summed alike on every rank); every rank made the same model-axis
    collectives."""
    cfg = _cfg(name)
    loss, grads = _one_rank(name)
    group = _group(runs, name)
    for m, got in enumerate(group):
        assert abs(float(got["loss"]) - loss) <= LOSS_TOL * abs(loss)
        _check_grads(got["grads"], [t.numpy() for t in tree_leaves(
            shard_params(grads, cfg, M, m))], cfg)
    calls = [r["calls"] for r in group]
    assert all(c == calls[0] for c in calls)
    whole = [i for i, d in enumerate(tree_leaves(model_dims(cfg, M)))
             if d < 0]
    assert whole
    for r in group[1:]:
        for i in whole:
            np.testing.assert_array_equal(
                tree_leaves(r["grads"])[i], tree_leaves(group[0]["grads"])[i])


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(name):
    cfg = _jcfg(name)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, cfg, b)))(
        jax.tree.map(jnp.asarray, _weights(name)),
        {k: jnp.asarray(v) for k, v in _batch(name).items()})
    return float(jloss), jax.tree.map(np.asarray, jgrads)


@pytest.mark.parametrize("name", NAMES)
def test_grads_match_reference_jax_grad(runs, name):
    """The loss and every leaf of each rank against the reference's
    ``jax.value_and_grad`` of ``loss_fn`` on the same f32 weights and
    batch, cut by its ``param_pspecs``."""
    jparams = jax.tree.map(jnp.asarray, _weights(name))
    jloss, jgrads = _ref_loss_and_grads(name)
    specs = JSH.param_pspecs(jparams, M)
    for m, got in enumerate(_group(runs, name)):
        assert abs(float(got["loss"]) - jloss) <= LOSS_TOL * abs(jloss)
        want = ref_cut(jgrads, specs, M, m)
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda a: 0, got["grads"]))
        _check_grads(got["grads"], jax.tree.leaves(want), _cfg(name))


# ---------------------------------------------------------------------- #
# The production meshes that take these cuts, dry-run on meta
# ---------------------------------------------------------------------- #

TRAIN = ShapeSpec("train_1x128", "train", 128, 1)
DECODE = ShapeSpec("decode_1x128", "decode", 128, 1)
# arch, model axis, the collectives of one decode step after 127 tokens
# by kind, and the gather_to's of a layer, each a reduce-scatter in a
# training step's backward.  Per layer of the decode:
#  * llama4-scout on M 32 (48 layers): q and the stacked k, v gathered by
#    columns (gather_to; 40 heads, 8 KV heads), the sequence-parallel
#    combine (a max and two sums), wo's partial sum; the experts' hidden
#    (gather_to, the new gather) and the combine's columns (gather_from);
#    the shared MLP's partial sum: 4 all-gathers and 5 all-reduces, and
#    the cut embedding's sum and the tied head's gather;
#  * olmoe on M 128 (16): the same less the shared MLP: 4 and 4;
#  * rwkv6 on M 64 (24): r, k, v and the decay gathered (the new gather),
#    ``w_o``'s partial sum, the channel mix's gate gathered and its
#    partial sum: 2 and 2;
#  * tinyllama on M 512 (22): q gathered, k and v by rows summed, ``wo``'s
#    and the MLP's partial sums: 1 and 3; the replicated embedding sums
#    nothing and the head by rows sums its partial logits once.
DRY = {"llama4-scout-17b-a16e": (32, {"all-gather/fast": 4 * 48 + 1,
                                      "all-reduce/fast": 5 * 48 + 1}, 3),
       "olmoe-1b-7b": (128, {"all-gather/fast": 4 * 16 + 1,
                             "all-reduce/fast": 4 * 16 + 1}, 3),
       "rwkv6-1.6b": (64, {"all-gather/fast": 2 * 24 + 1,
                           "all-reduce/fast": 2 * 24 + 1}, 1),
       "tinyllama-1.1b": (512, {"all-gather/fast": 22,
                                "all-reduce/fast": 3 * 22 + 1}, 1)}


@functools.lru_cache(maxsize=None)
def _dry(arch, shape):
    return D.dry_cell(configs.get_config(arch), shape, 1, 1, DRY[arch][0])


@pytest.mark.parametrize("arch", list(DRY))
def test_the_production_cut_builds_every_rank_program(arch):
    """The full config on its model axis, a training step of 1 x 128 and
    a decode step on ``meta``: every rank program builds (one a
    ``rank_key``), and the census counts the collectives a decode step
    makes (the new gathers among them, derived above), and one
    reduce-scatter a ``gather_to`` of a layer in the training step's
    backward."""
    model, decode, per_layer = DRY[arch]
    cfg = configs.get_config(arch)
    train = _dry(arch, TRAIN)
    for rec in (train, _dry(arch, DECODE)):
        assert sorted(m for p in rec["per_rank"].values()
                      for m in p["members"]) == list(range(model))
        assert rec["bytes_per_device"] > 0
    assert train["gflops"] > 0
    assert _dry(arch, DECODE)["collective_counts"] == decode
    assert train["collective_counts"]["reduce-scatter/fast"] == \
        per_layer * cfg.n_layers


def test_the_rwkv6_record_is_the_maximum_over_its_rank_programs():
    """rwkv6-1.6b on 1x1x64 runs two rank programs, its heads met from
    offset 0 (even ranks) and from 32 (odd ranks): ``rank_key`` tells
    them apart, and the record is the one of the larger ``step_s``, its
    rank named, with the largest ``bytes_per_device`` of the two."""
    cfg = configs.get_config("rwkv6-1.6b")
    keys = {D.rank_key(cfg, TRAIN, 1, 64, m) for m in range(64)}
    assert len(keys) == 2
    rec = _dry("rwkv6-1.6b", TRAIN)
    per = rec["per_rank"]
    assert sorted(per) == [0, 1]
    assert per[0]["members"] == list(range(0, 64, 2))
    assert per[1]["members"] == list(range(1, 64, 2))
    assert rec["rank"] in per
    assert rec["step_s"] == max(p["step_s"] for p in per.values()) == \
        per[rec["rank"]]["step_s"]
    assert rec["bytes_per_device"] == max(
        p["bytes_per_device"] for p in per.values()) == \
        per[rec["bytes_rank"]]["bytes_per_device"]
