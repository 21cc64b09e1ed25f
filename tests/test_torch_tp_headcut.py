"""A model axis that cuts inside a head, and a vocabulary it does not
divide, served and trained on four gloo ranks on the CPU, against the
port's one-rank model and the reference.

Where M divides a config's query columns ``Q = n_heads * head_dim`` but
not its heads, the reference cuts ``wq`` by columns and ``wo`` by rows at
``Q / M``, inside a head.  Each rank makes its columns of q, gathers the
ranks' columns (``Axis.gather_to``: the all-gather forward, a
reduce-scatter backward), keeps the heads its columns meet
(``sharding.rank_heads``), applies the q/k norms and rope to whole heads,
runs attention on them and on the KV heads they read, and multiplies its
own columns of the output by its rows of ``wo``.  A head that spans two
ranks is computed on both.  Where M does not divide a tied vocabulary
the embedding is replicated: every rank looks up every id, and the head
gives whole logits and a plain cross-entropy.

Variants of the smoke configs (hd 16), each with a full config's ratio on
M 4, the reference's ``init_model(PRNGKey(0))`` weights in f32:

* ``recurrentgemma_2b/h10``: 10 heads on one KV head, 2.5 heads a rank,
  the local layer and the RG-LRU (recurrentgemma-2b on M 4); its dense
  cache split over the sequence (``s_max`` 24);
* ``recurrentgemma_2b/h3``: 3 heads, ranks with 1, 2, 2 and 1 heads
  (recurrentgemma-2b on M 16); its cache on the rank's KV head
  (``s_max`` 7);
* ``gpt_100m/h6``: 6 heads on 6 KV heads, 1.5 heads a rank, k and v cut
  inside heads (gpt-100m on M 8);
* ``qwen3_4b/g5``: 10 heads on 2 KV heads, G 5, the q/k norms
  (llama4-scout on M 16);
* ``qwen3_4b/h6kv3``: 6 heads on 3 KV heads: ranks whose heads read two
  KV heads, and KV counts 1, 2, 2, 1 (the prefill's sequence split pads
  them);
* ``qwen3_4b/g2``: 10 heads on 5 KV heads: a rank's heads 2, 3, 4 read
  KV heads 1, 1, 2, not in equal groups (one KV head a query head);
* ``seamless_m4t_medium/v510``: a tied vocabulary of 510 rows that 4 does
  not divide, with the encoder and the cross attention.

Tolerances, ``tests/test_torch_tp_rglru.py``'s: prefill, decode and
full-forward logits within 1e-5 of the one-rank port (a paged step within
1e-4), the forward also of the reference's ``model_fwd``; the f32 RG-LRU
state within 1e-5 of its largest entry, bf16 cache leaves within 1e-2;
the loss within 1e-5 relative and each gradient leaf within 1e-4 of its
largest entry (of one rank's, and for recurrentgemma and seamless of the
reference's ``jax.value_and_grad``); one clipped step within 1e-6 of the
reference's ``apply_updates`` under ``jax.vmap``; ``train`` on 1x1x4
within 1e-4 of one rank's losses.
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
                           rank_opt, ref_cut, ref_encoder_f32, vmap_ranks)
from repro.models import sharding as JSH
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.serve import serve
from repro_torch.launch.step import device_batch, loss_and_grads
from repro_torch.launch.train import train
from repro_torch.models.convert import from_numpy, shard_params, unstack_runs
from repro_torch.models.sharding import param_model_dims, rank_heads
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
STEPS = 3
M = 4

RG, SM = "recurrentgemma_2b/h10", "seamless_m4t_medium/v510"
# name -> (config changes, paths, trained)
CASES = {RG: (dict(n_heads=10), "family", True),
         "recurrentgemma_2b/h3": (dict(n_heads=3), "family", True),
         "gpt_100m/h6": (dict(n_heads=6, n_kv_heads=6), "model", True),
         "qwen3_4b/g5": (dict(n_heads=10, n_kv_heads=2), "model", True),
         "qwen3_4b/h6kv3": (dict(n_heads=6, n_kv_heads=3), "model", True),
         "qwen3_4b/g2": (dict(n_heads=10, n_kv_heads=5), "model", False),
         SM: (dict(vocab=510), "family", True)}
NAMES = list(CASES)
TRAINED = [n for n in NAMES if CASES[n][2]]
REF_GRADS = [RG, SM]
# the zoo's configs at the model-axis sizes of ROADMAP's item 5
ZOO = [(a, m) for a in configs.list_archs() for m in (2, 4, 8, 16)]


def _cfg(name):
    return dataclasses.replace(configs.get_config(name.split("/")[0],
                                                  smoke=True),
                               **CASES[name][0])


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The reference's seed-0 weights of case ``name``'s config, f32,
    numpy, the stacked layout."""
    return jax_to_numpy(cast_tree(JT.init_model(jax.random.PRNGKey(0),
                                                _cfg(name)), jnp.float32))


def _inputs(name):
    cfg = _cfg(name)
    rng = np.random.default_rng(17)
    if CASES[name][1] == "model":         # tests/test_torch_tp.py's
        S_p, L_ = 8, 6
        toks = np.zeros((1, S_p), np.int64)
        toks[0, :L_] = rng.integers(0, cfg.vocab, L_)
        return {"BS": 4, "L": L_, "S_p": S_p, "max_blocks": 4, "toks": toks,
                "forced": rng.integers(0, cfg.vocab, (5, 1)),
                "dense": rng.integers(0, cfg.vocab, (2, 16)), "s_max": 24,
                "dense_forced": rng.integers(0, cfg.vocab, (4, 2, 1))}
    ring = name.endswith("/h3")           # a ring of 7: no sequence split
    ins = {"tokens": rng.integers(0, cfg.vocab, (2, 4 if ring else 16)),
           "s_max": 7 if ring else 24,
           "forced": rng.integers(0, cfg.vocab, (3, 2, 1))}
    if cfg.enc_dec is not None:
        ins["src_embeds"] = rng.standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
    return ins


def _batch(name):
    return DataPipeline(_cfg(name), ShapeSpec("test", "train", 100,
                                              2)).host_batch(0)


@pytest.fixture(scope="module")
def runs():
    """The one-rank runs (their caches before each decode step go to the
    ranks) and the four ranks', one spawn."""
    cases, whole = [], {}
    for name, (_, paths, trained) in CASES.items():
        cfg, jp, ins = _cfg(name), _weights(name), _inputs(name)
        fn = ranks.family_paths if paths == "family" else ranks.model_paths
        whole[name] = fn(unstack_runs(from_numpy(jp, device="cpu"), cfg),
                         cfg, ins)
        for key in ("caches_before", "pools_before"):
            if key in whole[name]:
                ins[key] = whole[name].pop(key)
        cases.append((name, cfg, (M,), paths, jp, ins,
                      _batch(name) if trained else None))
    steps = {n: (_cfg(n), _weights(n), _batch(n), OPT_KW) for n in REF_GRADS}
    res = run_ranks(ranks.tp_headcut, M, "gloo", (cases, steps),
                    timeout=600.0)
    return {"whole": whole, "ranks": res}


def _group(runs, name):
    return [r[M, name] for r in runs["ranks"]]


PATH_KEYS = {"family": ("prefill", "steps", "fwd"),
             "model": ("paged_prefill", "paged_steps", "dense_prefill",
                       "dense_steps", "fwd")}


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_one_rank(runs, name):
    """Every rank's logits: the dense prefill and decode steps (the
    sequence-parallel decode where M divides the cache, the rank's KV
    heads for ``/h3``'s ring of 7), the paged prefill and steps of the
    attention configs, and the full forward: equal across the ranks,
    within 1e-5 of the one-rank port (a paged step within 1e-4)."""
    group, want = _group(runs, name), runs["whole"][name]
    for key in PATH_KEYS[CASES[name][1]]:
        got = group[0][key]
        for r in group[1:]:
            np.testing.assert_array_equal(r[key], got)
        assert got.shape == want[key].shape, key
        np.testing.assert_allclose(
            got, want[key], rtol=0, err_msg=key,
            atol=PAGED_TOL if key == "paged_steps" else TOL)


def _rank_part(w, k, like, cfg, m):
    """Rank ``m``'s part of the one-rank cache leaf ``w`` (run ``k``), the
    layout it must have beside the rank's leaf ``like``: an attention
    leaf's sequence slice where M divides its length, else its KV heads
    (``rank_heads``); the cross K/V's KV heads; the RG-LRU's channels."""
    sh = rank_heads(cfg, M, m)
    if k in ("k", "v") and w.shape[2] % M == 0:
        dim, start, n = 2, m * w.shape[2] // M, w.shape[2] // M
    elif k in ("k", "v", "xk", "xv"):
        dim, start, n = 3, sh.kv0, sh.nkv
    elif k in ("h", "conv"):
        dim = w.ndim - 1
        start, n = m * w.shape[dim] // M, w.shape[dim] // M
    else:
        return w
    assert like.shape[dim] == n, (k, like.shape, n)
    return np.take(w, range(start, start + n), axis=dim)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_the_one_rank_cache_cut_for_it(runs, name):
    """Each rank's cache is the one-rank cache cut for it: the prefill's
    (dense path; the RG-LRU's state and conv inputs by channels, k and v
    by the sequence or the rank's KV heads, seamless's cross K/V by KV
    heads), in ``init_cache(tp=)``'s shapes; the attention configs' dense
    cache after the last step, split over the sequence."""
    cfg, group, want = _cfg(name), _group(runs, name), runs["whole"][name]
    if CASES[name][1] == "family":
        pairs = [(p, w) for p, w in zip(zip(*[r["cache"] for r in group]),
                                        want["cache"])]
        for r in group:
            for run, ent in enumerate(r["cache"]):
                assert {k: v.shape for k, v in ent.items()} \
                    == r["init_shapes"][run]
    else:
        n_runs = len(cfg.runs())
        pairs = [([{k: r[f"cache{i}_{k}"] for k in ("k", "v")}
                   for r in group],
                  {k: want[f"cache{i}_{k}"] for k in ("k", "v")})
                 for i in range(n_runs)]
    for parts, full in pairs:
        for k, w in full.items():
            for m, part in enumerate(parts):
                cut = _rank_part(w, k, part[k], cfg, m)
                tol = STATE_TOL * np.abs(w).max() if k == "h" else CACHE_TOL
                np.testing.assert_allclose(part[k], cut, atol=tol, rtol=0,
                                           err_msg=f"{m}/{k}")


@functools.lru_cache(maxsize=None)
def _ref_fwd(name):
    """The reference's ``model_fwd`` logits of case ``name``'s dense
    inputs (seamless's encoder through ``ref_encoder_f32``)."""
    ins, cfg = _inputs(name), _cfg(name)
    toks = ins["tokens"] if "tokens" in ins else ins["dense"]
    inputs = {"tokens": jnp.asarray(toks)}
    if "src_embeds" in ins:
        inputs["src_embeds"] = jnp.asarray(ins["src_embeds"])
    return np.asarray(JT.model_fwd(jax.tree.map(jnp.asarray, _weights(name)),
                                   cfg, inputs))


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


def _check_grads(got, want):
    gl, wl = tree_paths(got), tree_leaves(want)
    assert len(gl) == len(wl)
    for (path, g), w in zip(gl, wl):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), path


@pytest.mark.parametrize("name", TRAINED)
def test_loss_and_grads_match_one_rank(runs, name):
    """Each rank's f32 loss and gradients of its stacked shard against
    the one-rank ones cut to it, every leaf: ``wq`` and ``wo`` cut inside
    a head (a head that spans two ranks gets both ranks' gradients of its
    q through ``gather_to``'s reduce-scatter), ``wk``/``wv``, the q/k
    norms, and seamless's replicated embedding, whole and equal on every
    rank; every rank made the same model-axis collectives."""
    cfg = _cfg(name)
    loss, grads = _one_rank(name)
    group = _group(runs, name)
    for m, got in enumerate(group):
        assert abs(float(got["loss"]) - loss) <= LOSS_TOL * abs(loss)
        _check_grads(got["grads"], [t.numpy() for t in tree_leaves(
            shard_params(grads, cfg, M, m))])
    calls = [r["calls"] for r in group]
    assert all(c == calls[0] for c in calls)
    assert min(calls[0].values()) > 0, calls[0]
    if name == SM:
        for r in group[1:]:
            np.testing.assert_array_equal(r["grads"]["embed"],
                                          group[0]["grads"]["embed"])


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(name):
    cfg = _cfg(name)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, cfg, b)))(
        jax.tree.map(jnp.asarray, _weights(name)),
        {k: jnp.asarray(v) for k, v in _batch(name).items()})
    return float(jloss), jax.tree.map(np.asarray, jgrads)


@pytest.mark.parametrize("name", REF_GRADS)
def test_grads_match_reference_jax_grad(runs, name, monkeypatch):
    """recurrentgemma's 10 heads and seamless's 510 rows on M 4 against
    the reference's ``jax.value_and_grad`` of ``loss_fn`` on the same f32
    weights and batch, cut by its ``param_pspecs``: the loss and every
    leaf of each rank."""
    monkeypatch.setattr(JT, "encoder_fwd", ref_encoder_f32)
    jparams = jax.tree.map(jnp.asarray, _weights(name))
    jloss, jgrads = _ref_loss_and_grads(name)
    specs = JSH.param_pspecs(jparams, M)
    for m, got in enumerate(_group(runs, name)):
        assert abs(float(got["loss"]) - jloss) <= LOSS_TOL * abs(jloss)
        want = ref_cut(jgrads, specs, M, m)
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda a: 0, got["grads"]))
        _check_grads(got["grads"], jax.tree.leaves(want))


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


@pytest.mark.parametrize("name", REF_GRADS)
def test_clipped_step_on_1x1x4_matches_reference_update(runs, name,
                                                        monkeypatch):
    """One ``make_train_step`` step on 1x1x4, ZeRO-1 multilevel, clipped
    at 1.0, against the reference's ``apply_updates`` under ``jax.vmap``
    over a ``model`` axis on each rank's shard of the parameters and
    state and on the gradients the rank synced: the parameters and m, v
    and master within 1e-6 of their largest entry.  The model dims are
    the reference's (``wq`` by columns inside a head; seamless's embedding
    replicated, its norm counted on each rank as the norms' are)."""
    monkeypatch.setattr(jadamw, "jnp", _ExactNorm())
    got = [r[M, name, "step"] for r in runs["ranks"]]
    params = jax.tree.map(jnp.asarray, _weights(name))
    mdims = jax.tree.map(
        lambda s: list(s).index("model") if "model" in s else -1,
        JSH.param_pspecs(params, M),
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert got[0]["mdims"] == mdims
    assert (mdims["embed"] == -1) == (name == SM)
    jcfg = jadamw.OptConfig(**OPT_KW)
    opt = rank_opt(jadamw.init_opt_state(params, jcfg), params, jcfg, 1, 1,
                   M, mdims)
    lead = lambda *a: jnp.stack(a)[None, None]
    local = jax.tree.map(lead, *[jax.tree.map(
        lambda a, md: model_cut(a, md, M, m), params, mdims)
        for m in range(M)])
    grads = jax.tree.map(lambda *a: lead(*map(jnp.asarray, a)),
                         *[g["grads"] for g in got])
    fn = jax.jit(vmap_ranks(lambda p, g, o: jadamw.apply_updates(
        p, g, o, jcfg, None, 1, 1, mdims, model_axis="model"), model=True))
    new_p, new_o = jax_to_numpy(fn(local, grads, opt))
    for m, r in enumerate(got):
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


# ---------------------------------------------------------------------- #
# The entry points: train and serve on 1x1x4
# ---------------------------------------------------------------------- #

def _train(name, mesh):
    return train(name.split("/")[0], STEPS, mesh_spec=mesh, seq=32, batch=4,
                 smoke=True, device="cpu", config=_cfg(name),
                 init_params=_weights(name))


@pytest.mark.parametrize("name", REF_GRADS)
def test_train_drives_a_model_axis_of_4(name):
    """``train`` in f32 on 1x1x4 within 1e-4 of one rank's losses, the
    same model-axis collectives each step on every rank, no kernel launch
    on the CPU."""
    out, one = _train(name, "1x1x4"), _train(name, "1x1x1")
    assert out["model"] == M and len(out["losses"]) == STEPS
    for g, o in zip(out["losses"], one["losses"]):
        assert np.isfinite(g) and abs(g - o) <= TRAIN_TOL * abs(o)
    assert all(c == out["tp_calls"][0] for c in out["tp_calls"])
    assert min(out["tp_calls"][0].values()) > 0
    assert all(n == 0 for rank in out["launches"] for n in rank.values())


def test_serve_on_1x1x4_gives_the_one_rank_tokens():
    """``serve`` of gpt-100m's 6-head variant, paged, on 1x1x4 (each rank
    1.5 heads' columns, two whole heads computed) generates the tokens of
    the one-rank serve, request by request."""
    kw = dict(smoke=True, device="cpu", config=_cfg("gpt_100m/h6"))
    one = serve("gpt-100m", 3, 12, 6, "1x1x1", **kw)
    four = serve("gpt-100m", 3, 12, 6, "1x1x4", **kw)
    np.testing.assert_array_equal(four["generated"], one["generated"])
    assert four["model_axis"]["model"] == M


# ---------------------------------------------------------------------- #
# No ranks: every config of the zoo at M 2, 4, 8 and 16
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,model", ZOO, ids=[f"{a}-{m}" for a, m in ZOO])
def test_zoo_is_admitted_and_the_heads_are_covered(arch, model):
    """The ranks' query heads cover
    every head in order, each rank's cut of ``wq`` lies inside its heads
    (from ``off`` into the first), its KV range is the KV heads those
    heads read, and ``kv_of`` maps each head to its KV head; the
    embedding is replicated exactly where M does not divide the
    vocabulary (then the head is tied)."""
    cfg = configs.get_config(arch)
    hd, c = cfg.head_dim, cfg.q_dim // model
    G = cfg.n_heads // cfg.n_kv_heads
    covered = set()
    for m in range(model):
        sh = rank_heads(cfg, model, m)
        heads = range(sh.q0, sh.q0 + sh.nq)
        covered |= set(heads)
        assert sh.q0 * hd + sh.off == m * c and 0 <= sh.off < hd
        assert (sh.q0 + sh.nq - 1) * hd < (m + 1) * c <= (sh.q0 + sh.nq) * hd
        assert [h // G for h in heads] == [sh.kv0 + i for i in sh.kv_of]
        assert sorted({h // G for h in heads}) == list(
            range(sh.kv0, sh.kv0 + sh.nkv))
    assert covered == set(range(cfg.n_heads))
    dims = param_model_dims({"embed": np.empty((cfg.vocab, 1))}, model)
    assert (dims["embed"] == -1) == (cfg.vocab % model != 0)
    assert cfg.vocab % model == 0 or cfg.tie_embeddings
