"""RWKV-6 and the enc-dec config on a model axis, served and trained on
gloo ranks on the CPU, against the port's one-rank model and the
reference.

RWKV-6's time mix runs on H/M heads a rank (``w_r``, ``w_k``, ``w_v``,
``w_g``, ``w_w`` by columns, the WKV scan and its state on those heads,
``u`` cut to them after ``copy_to``), ``w_o`` by rows and one sum over
the axis; its channel mix splits ``cm_k`` and ``cm_r`` by columns and
``cm_v`` by rows, so the gate is gathered over the axis
(``Axis.gather_from``) and multiplies the sum of ``kk @ cm_v``'s
partial sums.  The enc-dec encoder runs under the attention rules, its
output whole on every rank (through one ``copy_to`` where a gradient is
taken); the cross attention runs on the rank's heads, its cache of the
rank's KV heads over every source position; the decoder's self-attention
cache is split over the sequence where M divides it (``s_max`` 24), else
by KV heads (the ``/kv`` case, ``s_max`` 21).

Configs: rwkv6-1.6b's smoke config (4 heads) at M 2 and 4,
seamless-m4t-medium's (4 heads, 4 KV heads) at M 2, with the reference's
``init_model(PRNGKey(0))`` weights in f32 (``params_from_jax``, then
``shard_params``).  Four gloo ranks are spawned once for the module: a
1x1x4 grid, then 1x2x2, whose first model group computes.  Each rank's
decode step starts from the one-rank run's cache of that step, cut for
the rank, since a bf16 cache entry (RWKV-6's carried rows, a k or v) may
round the other way when the row-parallel sums add in another order.

Tolerances: prefill and full-forward logits within 1e-5 of the one-rank
port and of the reference's ``model_fwd`` (seamless's encoder through
``_torch_bridge.ref_encoder_f32``), a decode step within 1e-4
(``tests/test_torch_model.py``'s f32 ``LOGIT_TOL``), as
``tests/test_torch_tp.py`` holds them; the f32 WKV state within 1e-5 of
its largest entry, bf16 cache leaves within 1e-2 (that file's
``CACHE_TOL``); the loss within 1e-5 relative and each gradient leaf
within 1e-4 of its largest entry (of one rank's, and for rwkv6 at M 2
also of the reference's ``jax.grad``), and ``train`` on 1x1x2 and 2x1x2
(``multilevel_compress``, ZeRO-1) within 1e-4 of one rank's losses, as
``tests/test_torch_tp_train_moe.py`` holds them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_bridge import (cast_tree, forked_ranks, jax_to_numpy, ref_cut,
                           ref_encoder_f32)
from repro.models import sharding as JSH
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.step import device_batch, loss_and_grads
from repro_torch.launch.train import train
from repro_torch.models.convert import (params_from_jax, shard_params,
                                        stack_runs, to_numpy)
from repro_torch.tree import tree_leaves, tree_paths

TOL = 1e-5           # f32 logits, sharded against unsharded and reference
DECODE_TOL = 1e-4    # a decode step's logits: LOGIT_TOL["float32"]
STATE_TOL = 1e-5     # x max|S|, the f32 WKV state
CACHE_TOL = 1e-2     # bf16 cache leaves (tests/test_torch_tp.py)
LOSS_TOL = 1e-5      # relative
GRAD_TOL = 1e-4      # x max|g| per leaf
TRAIN_TOL = 1e-4     # relative
MODE = "multilevel_compress"
STEPS = 4

# name -> the model-axis sizes it runs at, and its dense cache's length
CASES = {"rwkv6_1p6b": ((2, 4), 24), "seamless_m4t_medium": ((2,), 24),
         "seamless_m4t_medium/kv": ((2,), 21)}
ALL = [(m, n) for n, (ms, _) in CASES.items() for m in ms]
IDS = [f"{m}-{n}" for m, n in ALL]


def _cfg(name):
    return configs.get_config(name.split("/")[0], smoke=True)


@functools.lru_cache(maxsize=None)
def _weights(base):
    """The reference's seed-0 weights of ``base``'s smoke config, f32,
    numpy."""
    cfg = configs.get_config(base, smoke=True)
    return jax_to_numpy(cast_tree(JT.init_model(jax.random.PRNGKey(0), cfg),
                                  jnp.float32))


def _inputs(name):
    cfg = _cfg(name)
    rng = np.random.default_rng(9)
    ins = {"tokens": rng.integers(0, cfg.vocab, (2, 16)),
           "forced": rng.integers(0, cfg.vocab, (4, 2, 1)),
           "s_max": CASES[name][1]}
    if cfg.enc_dec is not None:
        ins["src_embeds"] = rng.standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
    return ins


def _batch(name):
    """The training batch (2 x 100 tokens; seamless's source frames); the
    ``/kv`` case serves only."""
    if name.endswith("/kv"):
        return None
    return DataPipeline(_cfg(name), ShapeSpec("test", "train", 100,
                                              2)).host_batch(0)


def _gather_inputs(model):
    rng = np.random.default_rng(4)
    return (rng.standard_normal((model, 3, 5)).astype(np.float32),
            rng.standard_normal((3, 5 * model)).astype(np.float32))


@pytest.fixture(scope="module")
def runs():
    """The one-rank runs (their caches before each decode step go to the
    ranks) and the four ranks', one spawn."""
    cases, whole = [], {}
    for name, (models, _) in CASES.items():
        cfg, jp, ins = _cfg(name), _weights(name.split("/")[0]), \
            _inputs(name)
        whole[name] = ranks.family_paths(params_from_jax(jp, cfg,
                                                         device="cpu"),
                                         cfg, ins)
        ins["caches_before"] = whole[name].pop("caches_before")
        cases.append((name, cfg, models, jp, ins, _batch(name)))
    res = run_ranks(ranks.tp_families, 4, "gloo",
                    (cases, {m: _gather_inputs(m) for m in (2, 4)}),
                    timeout=600.0)
    return {"whole": whole, 4: res[:4], 2: res[:2]}


def _group(runs, model, name):
    return [r[model, name] for r in runs[model]]


@pytest.mark.parametrize("model,name", ALL, ids=IDS)
def test_prefill_and_decode_match_one_rank(runs, model, name):
    """Every rank's prefill logits, 4 decode steps and full forward:
    equal across the ranks, within 1e-5 of the one-rank port (a step
    within 1e-4).  The prefill's cache, in ``init_cache(tp=)``'s layout,
    joined over the ranks along its sharded dim, is the one-rank cache:
    RWKV-6's state by heads, its carried rows whole on every rank;
    seamless's cross K/V by KV heads, its self K/V by the sequence (by KV
    heads in the ``/kv`` case)."""
    group, want = _group(runs, model, name), runs["whole"][name]
    for key in ("prefill", "steps", "fwd"):
        got = group[0][key]
        for r in group[1:]:
            np.testing.assert_array_equal(r[key], got)
        assert got.shape == want[key].shape, key
        np.testing.assert_allclose(got, want[key], rtol=0, err_msg=key,
                                   atol=DECODE_TOL if key == "steps" else TOL)
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
            tol = STATE_TOL * np.abs(w).max() if k == "S" else CACHE_TOL
            np.testing.assert_allclose(got, w, atol=tol, rtol=0,
                                       err_msg=f"{run}/{k}")


# (KV-head split of the self cache, leaf) -> the cache's sharded dims:
# RWKV-6's state (n, B, H, hd, hd) by heads, its rows whole; the cross
# K/V (n, B, Ss, Hkv, hd) by KV heads; the self K/V by the sequence, or
# by KV heads where M does not divide its length
_SHARDED = {(False, "S"): [2], (False, "x_tm"): [], (False, "x_cm"): [],
            (False, "xk"): [3], (False, "xv"): [3], (True, "xk"): [3],
            (True, "xv"): [3], (False, "k"): [2], (False, "v"): [2],
            (True, "k"): [3], (True, "v"): [3]}


@pytest.mark.parametrize("model,name", ALL, ids=IDS)
def test_collectives_a_prefill_and_a_step(runs, model, name):
    """The model axis's collectives, the same on every rank: the
    embedding's sum and the logits' all-gather, and a layer's.  RWKV-6:
    the time mix's sum, the channel mix's gather and sum (3), in the
    prefill and in a decode step.  seamless: 2 an encoder layer; a
    decoder layer's self-attention, cross-attention and MLP sums (3), the
    prefill's gathers that split the self cache over the sequence (2),
    and a sequence-parallel step's gather of q, k and v and its combine's
    max and two sums (4 more a layer)."""
    cfg = _cfg(name)
    n = cfg.n_layers
    group = _group(runs, model, name)
    if cfg.enc_dec is None:
        prefill, step = 2 + 3 * n, 2 + 3 * n
    else:
        seq = not name.endswith("/kv")
        prefill = 2 + 2 * cfg.enc_dec.n_enc_layers + 3 * n + 2 * seq
        step = 2 + (3 + 4 * seq) * n
    for r in group:
        assert int(r["prefill_calls"]) == prefill
        assert r["step_calls"] == [step] * 4


def test_sharded_reference_weights_give_the_reference_logits(runs,
                                                             monkeypatch):
    """``shard_params`` of the reference's weights (``params_from_jax``)
    feeds the ranks: their full forward's logits are the reference's
    one-device ``model_fwd``'s on the same weights and inputs, within
    1e-5, at every model size of every case."""
    monkeypatch.setattr(JT, "encoder_fwd", ref_encoder_f32)
    for model, name in ALL:
        cfg, ins = _cfg(name), _inputs(name)
        jp = jax.tree.map(jnp.asarray, _weights(name.split("/")[0]))
        inputs = {k: jnp.asarray(ins[k]) for k in ("tokens", "src_embeds")
                  if k in ins}
        want = np.asarray(JT.model_fwd(jp, cfg, inputs))
        for r in _group(runs, model, name):
            np.testing.assert_allclose(r["fwd"], want, atol=TOL, rtol=0,
                                       err_msg=f"{model}-{name}")


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    cfg = _cfg(name)
    loss, grads = loss_and_grads(
        params_from_jax(_weights(name), cfg, device="cpu"), cfg,
        device_batch(_batch(name), "cpu"))
    return loss.item(), stack_runs(grads, cfg)


TRAINED = [(m, n) for m, n in ALL if not n.endswith("/kv")]


@pytest.mark.parametrize("model,name", TRAINED,
                         ids=[f"{m}-{n}" for m, n in TRAINED])
def test_loss_and_grads_match_one_rank(runs, model, name):
    """Each rank's f32 loss and gradients against the one-rank ones cut
    to its model shard, every leaf: the column- and row-split
    projections, ``u``, ``mix`` and ``cm_mix`` (replicated, their
    gradients summed over the axis by ``copy_to``), the encoder's layers
    and final norm (its output read by every decoder layer's cross
    attention, through one ``copy_to``); every rank made the same
    model-axis collectives in the forward, the remat's re-run and the
    backward."""
    cfg = _cfg(name)
    loss, grads = _one_rank(name)
    group = _group(runs, model, name)
    for m, got in enumerate(group):
        assert abs(float(got["loss"]) - loss) <= LOSS_TOL * abs(loss)
        want = to_numpy(shard_params(grads, cfg, model, m))
        gl, wl = tree_paths(got["grads"]), tree_leaves(want)
        assert len(gl) == len(wl)
        for (path, g), w in zip(gl, wl):
            assert g.shape == w.shape and g.dtype == w.dtype, path
            assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), path
    calls = [r["calls"] for r in group]
    assert all(c == calls[0] for c in calls)
    assert min(calls[0].values()) > 0, calls[0]
    # a layer's forward sums and gathers, as in serving; the embedding's
    # sum and the loss's max and sum.  Backward: one copy_to a sublayer
    # (RWKV-6's stacked mixes; the encoder's output once for every cross
    # attention) and u's, and the head's
    n = cfg.n_layers
    if cfg.enc_dec is None:
        want = {"fwd": 3 * n + 3, "bwd": 3 * n + 1}
    else:
        e = cfg.enc_dec.n_enc_layers
        want = {"fwd": 2 * e + 3 * n + 3, "bwd": 2 * e + 3 * n + 2}
    assert {k: calls[0][k] for k in want} == want


def test_rwkv6_grads_match_reference_jax_grad(runs):
    """rwkv6's smoke config on a model axis of 2 against the reference's
    ``jax.grad`` of ``loss_fn`` on the same f32 weights and batch, cut by
    its ``param_pspecs``: the loss and every leaf of each rank."""
    name = "rwkv6_1p6b"
    cfg = _cfg(name)
    jparams = jax.tree.map(jnp.asarray, _weights(name))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, cfg, b)))(
        jparams, {k: jnp.asarray(v) for k, v in _batch(name).items()})
    specs = JSH.param_pspecs(jparams, 2)
    for m, got in enumerate(_group(runs, 2, name)):
        assert abs(float(got["loss"]) - float(jloss)) \
            <= LOSS_TOL * abs(float(jloss))
        want = ref_cut(jax.tree.map(np.asarray, jgrads), specs, 2, m)
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda a: 0, got["grads"]))
        for g, w in zip(jax.tree.leaves(got["grads"]),
                        jax.tree.leaves(want)):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("model", [2, 4])
def test_gather_from_differentiates(runs, model):
    """``gather_from``: the all-gather forward (the ranks' slices in rank
    order), and backward this rank's slice of the gradient of a consumer
    every rank computes alike, with no collective (a reduce-scatter would
    give M times it)."""
    xs, c = _gather_inputs(model)
    k = xs.shape[-1]
    for m, r in enumerate(runs[model]):
        got = r[model, "gather"]
        np.testing.assert_array_equal(got["y"], np.concatenate(list(xs), -1))
        np.testing.assert_array_equal(got["grad"], c[:, m * k:(m + 1) * k])
        assert list(got["calls"]) == [1, 0]


# ---------------------------------------------------------------------- #
# The entry point: train --mesh PxDxM
# ---------------------------------------------------------------------- #

def _train(arch, mesh):
    cfg = _cfg(arch)
    params = to_numpy(stack_runs(params_from_jax(_weights(arch), cfg,
                                                 device="cpu"), cfg))
    return train(arch, STEPS, mesh_spec=mesh, seq=32, batch=4, comm=MODE,
                 smoke=True, device="cpu", config=cfg, init_params=params)


@functools.lru_cache(maxsize=None)
def _one_rank_losses(arch):
    return _train(arch, "1x1x1")["losses"]


@pytest.mark.parametrize("mesh", ["1x1x2", "2x1x2"])
@pytest.mark.parametrize("arch", ["rwkv6_1p6b", "seamless_m4t_medium"])
def test_train_drives_the_families_on_a_model_axis(arch, mesh):
    """``train`` in f32 on a model axis of 2 (with 2 pods: int8 + EF on
    the slow axis), ZeRO-1 beside the model shards: finite losses within
    1e-4 of one rank's, the same model-axis collectives each step on
    every rank, no kernel launch on the CPU."""
    out = _train(arch, mesh)
    assert out["model"] == 2 and len(out["losses"]) == STEPS
    for g, o in zip(out["losses"], _one_rank_losses(arch)):
        assert np.isfinite(g) and abs(g - o) <= TRAIN_TOL * abs(o)
    assert all(c == out["tp_calls"][0] for c in out["tp_calls"])
    assert min(out["tp_calls"][0].values()) > 0
    assert all(n == 0 for rank in out["launches"] for n in rank.values())
