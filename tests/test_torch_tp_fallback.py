"""A model axis of 3, where the reference's fallback moves a leaf to its
other matmul dim or replicates it, served and trained on three gloo
ranks on the CPU, against the port's one-rank model and the reference.

Where the axis does not divide the dim a leaf's rule cuts, the reference
(``repro/models/sharding.py`` ``_spec_for``) cuts the leaf's other matmul
dim, or replicates it where the axis divides neither, and GSPMD computes
the layout that results.  The port computes each product from the leaf's
cut: a whole input times a leaf's rows gives a partial sum (added over
the axis), times its columns the rank's columns of the output (gathered
whole), times a whole leaf a whole output on every rank.  Where ``wq`` is
not cut by columns every rank computes every head; where the experts are
not cut every rank runs the dense MoE block on every expert.

Variants of the smoke configs (hd 16), each with a full config's
placements on a model axis, the reference's ``init_model(PRNGKey(0))``
weights in f32:

* ``gemma3_12b/d48``: ``wq``, ``wk``, ``wv`` by rows, ``wo`` by columns,
  the MLP by features, the 512-row tied embedding whole (gemma3-12b on
  M 3);
* ``phi4_mini_3p8b/d48``: ``wq`` by columns (2 heads a rank), ``wk``/``wv``
  by rows, the MLP's ``wi``/``wg`` by rows and ``wo`` by columns
  (phi4-mini-3.8b on M 3);
* ``llama4_scout_17b_a16e/d48``: the experts whole but for ``w_out``, by
  the columns of its output, and the shared MLP by rows and columns
  (llama4-scout on M 5);
* ``olmoe_1b_7b``: attention, router and the 4 experts whole, the dense
  block on every rank (olmoe-1b-7b on M 3);
* ``tinyllama_1p1b``: every leaf whole, the untied head too (tinyllama on
  M 3);
* ``recurrentgemma_2b/f96``: the RG-LRU and attention whole, the MLP by
  features (recurrentgemma-2b on M 3);
* ``recurrentgemma_2b/d48``: the RG-LRU's ``w_x``/``w_gate`` by rows and
  ``w_out`` by columns (64 channels on a 48-wide model), attention by
  rows;
* ``rwkv6_1p6b``: every leaf whole (rwkv6-1.6b on M 3);
* ``rwkv6_1p6b/f96``: the time mix and ``cm_r`` whole, ``cm_k`` by
  columns and ``cm_v`` by rows (rwkv6-1.6b on M 7);
* ``seamless_m4t_medium/v510``: the encoder, the cross attention and the
  MLP whole, the 510-row vocabulary cut (seamless-m4t-medium on M 3).

Tolerances, ``tests/test_torch_tp_headcut.py``'s: prefill, decode and
full-forward logits within 1e-5 of the one-rank port (a paged step within
1e-4), the forward also of the reference's ``model_fwd``; the loss within
1e-5 relative and each gradient leaf within 1e-4 of its largest entry, of
one rank's and of the reference's ``jax.value_and_grad`` (llama4-scout's
top-1 router under 1e-6 of the largest entry).  A whole leaf's
gradient is equal bit for bit on the three ranks.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_bridge import (cast_tree, forked_ranks, jax_to_numpy, ref_cut,
                           ref_encoder_f32)
from repro import configs as jconfigs
from repro.models import sharding as JSH
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.step import device_batch, loss_and_grads
from repro_torch.models.convert import (from_numpy, model_dims,
                                        shard_params, unstack_runs)
from repro_torch.models.sharding import rank_heads
from repro_torch.tree import tree_leaves, tree_paths

TOL = 1e-5           # f32 logits, sharded against unsharded and reference
PAGED_TOL = 1e-4     # a paged decode step (tests/test_torch_tp.py)
LOSS_TOL = 1e-5      # relative
GRAD_TOL = 1e-4      # x max|g| per leaf
ZERO_TOL = 1e-6      # x max|g| over the leaves: a top-1 router's
M = 3

# name -> (config changes, paths, {leaf path: its cut on M 3}); a cut is
# "col", "row" or "" (whole), of the first layer's leaves
CASES = {
    "gemma3_12b/d48": (dict(d_model=48, d_ff=96), "model", {
        "attn/wq": "row", "attn/wk": "row", "attn/wo": "col",
        "mlp/wi": "col", "mlp/wo": "row", "embed": ""}),
    "phi4_mini_3p8b/d48": (dict(d_model=48, n_heads=6, n_kv_heads=2),
                           "model", {
        "attn/wq": "col", "attn/wk": "row", "attn/wo": "row",
        "mlp/wi": "row", "mlp/wg": "row", "mlp/wo": "col"}),
    "llama4_scout_17b_a16e/d48": (dict(d_model=48, n_heads=6,
                                       n_kv_heads=2), "model", {
        "attn/wq": "col", "attn/wv": "row", "mlp/w_in": "",
        "mlp/w_gate": "", "mlp/w_out": "col", "mlp/router": "",
        "mlp/shared/wi": "row", "mlp/shared/wo": "col"}),
    "olmoe_1b_7b": ({}, "model", {
        "attn/wq": "", "attn/wo": "", "mlp/w_in": "", "mlp/w_out": "",
        "embed": ""}),
    "tinyllama_1p1b": ({}, "model", {
        "attn/wq": "", "mlp/wi": "", "mlp/wo": "", "lm_head": ""}),
    "recurrentgemma_2b/f96": (dict(d_ff=96), "family", {
        "rec/w_x": "", "rec/w_a": "", "rec/w_out": "", "mlp/wi": "col"}),
    "recurrentgemma_2b/d48": (dict(d_model=48, d_ff=96), "family", {
        "rec/w_x": "row", "rec/w_gate": "row", "rec/w_a": "",
        "rec/w_out": "col"}),
    "rwkv6_1p6b": ({}, "family", {
        "rwkv/w_r": "", "rwkv/w_o": "", "rwkv/cm_k": "", "rwkv/cm_v": ""}),
    "rwkv6_1p6b/f96": (dict(d_ff=96), "family", {
        "rwkv/w_r": "", "rwkv/w_o": "", "rwkv/cm_k": "col",
        "rwkv/cm_v": "row", "rwkv/cm_r": ""}),
    "seamless_m4t_medium/v510": (dict(vocab=510), "family", {
        "attn/wq": "", "xattn/wk": "", "mlp/wi": "", "embed": "row"}),
}
NAMES = list(CASES)
# the reference's value_and_grad for these (the one-rank port is held to
# it for every family by tests/test_torch_train.py)
REF_GRADS = ["gemma3_12b/d48", "phi4_mini_3p8b/d48",
             "recurrentgemma_2b/d48", "seamless_m4t_medium/v510"]


def _changes(name):
    return name.split("/")[0], CASES[name][0]


def _cfg(name):
    arch, kw = _changes(name)
    return dataclasses.replace(configs.get_config(arch, smoke=True), **kw)


def _jcfg(name):
    arch, kw = _changes(name)
    return dataclasses.replace(jconfigs.get_config(arch, smoke=True), **kw)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The reference's seed-0 weights of case ``name``'s config, f32,
    numpy, the stacked layout."""
    init = jax.jit(JT.init_model, static_argnums=1)
    return jax_to_numpy(cast_tree(init(jax.random.PRNGKey(0), _jcfg(name)),
                                  jnp.float32))


def _inputs(name):
    cfg = _cfg(name)
    rng = np.random.default_rng(23)
    if CASES[name][1] == "model":         # tests/test_torch_tp.py's
        S_p, L_ = 8, 6
        toks = np.zeros((1, S_p), np.int64)
        toks[0, :L_] = rng.integers(0, cfg.vocab, L_)
        return {"BS": 4, "L": L_, "S_p": S_p, "max_blocks": 4, "toks": toks,
                "forced": rng.integers(0, cfg.vocab, (4, 1)),
                "dense": rng.integers(0, cfg.vocab, (2, 16)), "s_max": 24,
                "dense_forced": rng.integers(0, cfg.vocab, (3, 2, 1))}
    ins = {"tokens": rng.integers(0, cfg.vocab, (2, 16)), "s_max": 24,
           "forced": rng.integers(0, cfg.vocab, (3, 2, 1))}
    if cfg.enc_dec is not None:
        ins["src_embeds"] = rng.standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
    return ins


def _batch(name):
    return DataPipeline(_cfg(name), ShapeSpec("test", "train", 64,
                                              2)).host_batch(0)


@pytest.fixture(scope="module")
def runs():
    """The one-rank runs (their caches before each decode step go to the
    ranks) and the three ranks', one spawn."""
    cases, whole = [], {}
    for name, (_, paths, _) in CASES.items():
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


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", NAMES)
def test_the_variant_has_the_full_configs_placements(name):
    """Each variant's leaves are cut on M 3 as the description says (the
    reference's rule and fallbacks: ``param_pspecs``), and where ``wq``
    is not cut by columns every rank has every head."""
    cfg = _cfg(name)
    dims = model_dims(cfg, M)
    shapes = _weights(name)
    for path, want in CASES[name][2].items():
        top = path if path in dims else None
        d = dims[top] if top else _leaf(dims["runs"][0], path)
        nd = (shapes[top] if top else _leaf(shapes["runs"][0], path)).ndim
        got = "" if d < 0 else "col" if d == nd - 1 else "row" \
            if d == nd - 2 else "embed" if top == "embed" and d == 0 \
            else str(d)
        got = "row" if got == "embed" else got
        assert got == want, path
    if "attn" in dims["runs"][0]:
        heads_cut = cfg.q_dim % M == 0
        assert (rank_heads(cfg, M, 1) == rank_heads(cfg)) != heads_cut


PATH_KEYS = {"family": ("prefill", "steps", "fwd"),
             "model": ("paged_prefill", "paged_steps", "dense_prefill",
                       "dense_steps", "fwd")}


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_one_rank(runs, name):
    """Every rank's logits: the dense prefill and decode steps (the
    sequence-parallel decode where M divides the cache, every KV head a
    rank for the 8-slot rings of windowed layers), the paged prefill and
    steps of the attention configs, and the full forward: equal across
    the ranks, within 1e-5 of the one-rank port (a paged step within
    1e-4); every rank made the same model-axis collectives in each."""
    group, want = _group(runs, name), runs["whole"][name]
    for key in [k for k in group[0] if k.endswith("_calls")]:
        assert all(np.array_equal(r[key], group[0][key]) for r in group), key
    for key in PATH_KEYS[CASES[name][1]]:
        got = group[0][key]
        for r in group[1:]:
            np.testing.assert_array_equal(r[key], got)
        assert got.shape == want[key].shape, key
        np.testing.assert_allclose(
            got, want[key], rtol=0, err_msg=key,
            atol=PAGED_TOL if key == "paged_steps" else TOL)


@functools.lru_cache(maxsize=None)
def _ref_fwd(name):
    """The reference's ``model_fwd`` logits of case ``name``'s dense
    inputs (seamless's encoder through ``ref_encoder_f32``)."""
    ins = _inputs(name)
    toks = ins["tokens"] if "tokens" in ins else ins["dense"]
    inputs = {"tokens": jnp.asarray(toks)}
    if "src_embeds" in ins:
        inputs["src_embeds"] = jnp.asarray(ins["src_embeds"])
    cfg = _jcfg(name)
    return np.asarray(jax.jit(lambda p, i: JT.model_fwd(p, cfg, i))(
        jax.tree.map(jnp.asarray, _weights(name)), inputs))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_reference_weights_give_the_reference_logits(
        runs, name, monkeypatch):
    """The ranks' full forward on their shards of the reference's weights
    is the reference's one-device ``model_fwd`` on those weights and
    inputs, within 1e-5."""
    monkeypatch.setattr(JT, "encoder_fwd", ref_encoder_f32)
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
    rounding), under ZERO_TOL of the largest entry of any leaf
    (``tests/test_torch_tp_train_moe.py``)."""
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
    equal bit for bit on every rank (it is not summed over the axis); every
    rank made the same model-axis collectives."""
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


@pytest.mark.parametrize("name", REF_GRADS)
def test_grads_match_reference_jax_grad(runs, name, monkeypatch):
    """The loss and every leaf of each rank against the reference's
    ``jax.value_and_grad`` of ``loss_fn`` on the same f32 weights and
    batch, cut by its ``param_pspecs``."""
    monkeypatch.setattr(JT, "encoder_fwd", ref_encoder_f32)
    jparams = jax.tree.map(jnp.asarray, _weights(name))
    jloss, jgrads = _ref_loss_and_grads(name)
    specs = JSH.param_pspecs(jparams, M)
    for m, got in enumerate(_group(runs, name)):
        assert abs(float(got["loss"]) - jloss) <= LOSS_TOL * abs(jloss)
        want = ref_cut(jgrads, specs, M, m)
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda a: 0, got["grads"]))
        _check_grads(got["grads"], jax.tree.leaves(want), _cfg(name))
