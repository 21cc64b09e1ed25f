"""Training of the MoE, RG-LRU, enc-dec and frontend configs against the
JAX package on the CPU.

The five configs (olmoe-1b-7b, llama4-scout-17b-a16e with its shared
expert, recurrentgemma-2b, seamless-m4t-medium, pixtral-12b) at their
smoke sizes, with the reference's ``init_model(PRNGKey(0))`` weights
carried over by ``params_from_jax``, in f32.  Their loss and gradients are
held to ``jax.value_and_grad(loss_fn)`` in ``test_torch_train.py``; here:

* the batch's float entries (``embeds``, ``src_embeds``) stay floats on
  the device, and the loss skips the frontend's prefix positions;
* the MoE's remat routes the recomputed forward as the forward, both
  where the layer remats and where the token blocks do;
* on a model axis of any size the train step builds, the cuts inside a
  unit included;
* ``apply_updates`` on each family's parameter tree fed identical f32
  gradients against the reference's, to 1e-6 x max|ref| per leaf (as
  ``test_apply_updates_matches_reference``); the update writes the state
  in place, bit for bit the reference's out-of-place formula;
* a 2-step f32 loss trajectory of ``make_train_step`` against the
  reference's on a 1x1x1 mesh, to 1e-4 relative (as
  ``test_train_trajectory_matches_reference``);
* olmoe and seamless on a 2x2x1 grid of four spawned gloo ranks (one
  spawn for both), ``multilevel_compress`` with ZeRO-1, 3 f32 steps:
  every rank reports one loss, within 1e-4 relative of one rank's and of
  the reference's composed per rank.

seamless in f32 takes the reference's encoder on its bf16 input promoted
to f32 (``_torch_bridge.ref_encoder_f32``): the reference's own layer
scan refuses the f32 model, whose first layer would change the carry's
dtype.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_bridge import forked_ranks, jax_to_numpy, ref_encoder_f32
from repro.configs.shapes import ShapeSpec as JaxShape
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.launch.mesh import Grid, run_ranks
from repro_torch.launch.step import (device_batch, loss_and_grads,
                                     make_train_step)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import from_numpy, params_from_jax, to_numpy
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map
from test_torch_train import _f32, _ref_grid_trajectory, _ref_update

ARCHS = ["olmoe_1b_7b", "llama4_scout_17b_a16e", "recurrentgemma_2b",
         "seamless_m4t_medium", "pixtral_12b"]
GRID_ARCHS = ["olmoe_1b_7b", "seamless_m4t_medium"]
MODE = "multilevel_compress"


def _cfg(arch):
    return configs.get_config(arch, smoke=True)


@functools.lru_cache(maxsize=None)
def _jax_init(cfg):
    return jax.jit(lambda key: JT.init_model(key, cfg))(jax.random.PRNGKey(0))


def _jax_params(cfg, dtype="float32"):
    return jax.tree.map(lambda a: jnp.array(
        a, jnp.float32 if dtype == "float32" else a.dtype, copy=True),
        _jax_init(cfg))


def _batch(cfg, S, B=2, step=0):
    return JaxPipeline(cfg, JaxShape("test", "train", S, B)).host_batch(step)


@pytest.fixture
def ref_f32(monkeypatch):
    """The reference runs an f32 enc-dec model through
    ``ref_encoder_f32``."""
    monkeypatch.setattr(JT, "encoder_fwd", ref_encoder_f32)


@pytest.mark.parametrize("arch", ["pixtral_12b", "seamless_m4t_medium"])
def test_device_batch_keeps_float_entries(arch):
    """Tokens and labels become int64; a frontend's ``embeds`` and the
    encoder's ``src_embeds`` stay f32, bit for bit (magnitude about
    1/sqrt(d): an integer cast would zero them)."""
    cfg = _cfg(arch)
    host = _batch(cfg, 64)
    got = device_batch(host, "cpu")
    key = "src_embeds" if cfg.enc_dec else "embeds"
    assert got[key].dtype == torch.float32
    assert np.array_equal(got[key].numpy(), host[key])
    assert 0 < np.abs(host[key]).max() < 1
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int64
        assert np.array_equal(got[k].numpy(), host[k])


def test_loss_skips_the_prefix():
    """pixtral's loss is the cross-entropy of the token positions' logits
    only: the (B, P + S) hidden states lose their P prefix positions
    before the head, so S labels line up."""
    cfg = _cfg("pixtral_12b")
    params = params_from_jax(jax_to_numpy(_jax_params(cfg)), cfg,
                             device="cpu")
    batch = device_batch(_batch(cfg, 100), "cpu")
    P, S = batch["embeds"].shape[1], batch["tokens"].shape[1]
    assert P > 0 and batch["labels"].shape[1] == S
    with torch.no_grad():
        loss = T.loss_fn(params, cfg, batch)
        logits = T.model_fwd(params, cfg, batch)
    assert logits.shape[1] == P + S
    want = torch.nn.functional.cross_entropy(
        logits[:, P:].reshape(-1, cfg.vocab), batch["labels"].reshape(-1))
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)


def _recording_route(monkeypatch):
    """Record every routing's dispatch order, forward and recomputation
    alike."""
    orders, route = [], L._moe_route

    def rec(p, m, xt):
        out = route(p, m, xt)
        orders.append(out[1].clone())
        return out
    monkeypatch.setattr(L, "_moe_route", rec)
    return orders


def test_moe_remat_routes_as_the_forward(monkeypatch):
    """olmoe's layers are rematted: the backward runs each layer's forward
    again, routing it again and reading its group sizes on the host again,
    and each recomputation routes as its forward did (the backward takes
    the layers last to first)."""
    cfg = _cfg("olmoe_1b_7b")
    params = params_from_jax(jax_to_numpy(_jax_params(cfg)), cfg,
                             device="cpu")
    batch = device_batch(_batch(cfg, 32), "cpu")
    orders = _recording_route(monkeypatch)
    n0 = L.moe_fwd.host_syncs
    loss_and_grads(params, cfg, batch)
    n = cfg.n_layers
    assert len(orders) == 2 * n and L.moe_fwd.host_syncs - n0 == 2 * n
    for fwd, again in zip(orders[:n], reversed(orders[n:])):
        assert torch.equal(fwd, again)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_scout_17b_a16e"])
def test_moe_token_blocks_remat(arch, monkeypatch):
    """With a gradient, token blocks of ``chunk`` run under remat: each
    block's backward routes it again as its forward did, and the
    gradients equal those of one block over all the tokens."""
    cfg = _cfg(arch)
    gen = torch.Generator().manual_seed(0)
    p = {k: v.float() if not isinstance(v, dict) else
         {kk: vv.float() for kk, vv in v.items()}
         for k, v in L.init_moe(gen, cfg).items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))

    def grads(chunk):
        leaves = [x] + [p[k] for k in ("router", "w_in", "w_gate", "w_out")]
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        pp = dict(p, router=leaves[1], w_in=leaves[2], w_gate=leaves[3],
                  w_out=leaves[4])
        y = L.moe_fwd(pp, cfg, leaves[0], chunk=chunk)
        return torch.autograd.grad((y * y).sum(), leaves)

    orders = _recording_route(monkeypatch)
    blocks = grads(4)
    assert len(orders) == 8                  # 4 blocks, 4 recomputations
    for fwd, again in zip(orders[:4], reversed(orders[4:])):
        assert torch.equal(fwd, again)
    whole = grads(L.MOE_CHUNK)
    for a, b in zip(blocks, whole):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_on_a_model_axis_raises(arch):
    """``make_train_step`` on a grid with a model axis builds every
    family's step on a model axis of any size: at M 2 all five
    smoke configs (the RG-LRU, and the one KV head of llama4-scout's and
    pixtral's split over the axis; ``tests/test_torch_tp_rglru.py``,
    ``tests/test_torch_tp_train_moe.py`` and
    ``tests/test_torch_tp_families.py`` train them there), and at M 3,
    which divides neither their 64 query columns nor their features (the
    reference's fallbacks: ``tests/test_torch_tp_fallback.py``), and an
    untied head over 510 rows at M 4, cut by its 64 rows
    (``tests/test_torch_tp_inside.py`` trains that cut)."""
    cfg = _cfg(arch)
    build = lambda c, m: make_train_step(
        c, adamw.OptConfig(), Grid.shape_only(1, 1, m), device="cpu")
    assert callable(build(cfg, 2)) and callable(build(cfg, 3))
    assert callable(build(dataclasses.replace(
        cfg, tie_embeddings=False, vocab=510), 4))


@pytest.mark.parametrize("arch", ARCHS)
def test_family_apply_updates_matches_reference(arch):
    """Three unclipped updates of each family's tree (router and experts,
    the RG-LRU's leaves, the encoder and cross-attention) from identical
    f32 gradients, ZeRO-1 over one rank, against the reference's
    ``apply_updates``."""
    cfg = _cfg(arch)
    kw = dict(comm_mode="multilevel", zero1=True, lr=1e-3, warmup_steps=2,
              total_steps=5)
    jopt_cfg, opt_cfg = jadamw.OptConfig(**kw), adamw.OptConfig(**kw)
    jparams = _jax_params(cfg, "bfloat16")
    jopt = jadamw.init_opt_state(jparams, jopt_cfg)
    params = from_numpy(jax_to_numpy(jparams), device="cpu")
    opt = adamw.init_opt_state(params, opt_cfg)
    ref = _ref_update(jopt_cfg)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g_np = jax.tree.map(lambda a: 1e-3 * rng.standard_normal(
            a.shape).astype(np.float32), jax_to_numpy(jparams))
        jparams, jopt = ref(jparams, jax.tree.map(jnp.asarray, g_np), jopt)
        params, opt = adamw.apply_updates(
            params, from_numpy(g_np, device="cpu"), opt, opt_cfg)
    got = to_numpy({"params": params, "opt": opt})
    want = jax_to_numpy({"params": jparams, "opt": jopt})
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda a: 0, got))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == np.int32:
            assert np.array_equal(g, w)
        elif w.dtype == np.uint16:
            g, w = _f32(g), _f32(w)
            assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w))
        else:
            assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("t", [1, 3])
def test_adamw_math_in_place_is_the_reference_math(t):
    """``_adamw_math`` writes m, v and master in place with the values of
    the reference's out-of-place formula on the same f32 operations, bit
    for bit."""
    cfg = adamw.OptConfig(lr=1e-3, weight_decay=0.1)
    rng = np.random.default_rng(t)
    m, v, g, w = (torch.from_numpy(rng.standard_normal(1000).astype(
        np.float32)) for _ in range(4))
    v = v.abs()
    lr, tt = torch.tensor(3e-4), torch.tensor(t, dtype=torch.int32)
    b1, b2 = cfg.betas
    m_want = b1 * m + (1 - b1) * g
    v_want = b2 * v + (1 - b2) * g * g
    w_want = w - lr * ((m_want / (1 - b1 ** tt))
                       / (torch.sqrt(v_want / (1 - b2 ** tt)) + cfg.eps)
                       + cfg.weight_decay * w)
    ids = [x.data_ptr() for x in (m, v, w)]
    out = adamw._adamw_math(m, v, g, w, cfg, lr, tt)
    assert [x.data_ptr() for x in out] == ids
    for got, want in zip(out, (m_want, v_want, w_want)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [dict(comm_mode="multilevel", zero1=True),
                                dict(comm_mode="flat", zero1=False)])
def test_apply_updates_donates_the_state(kw):
    """The update returns the m, v and master it was given, written in
    place, as the reference's train step donates its state."""
    cfg = _cfg("olmoe_1b_7b")
    opt_cfg = adamw.OptConfig(**kw)
    params = from_numpy(jax_to_numpy(_jax_params(cfg, "bfloat16")),
                        device="cpu")
    opt = adamw.init_opt_state(params, opt_cfg)
    ids = {k: [t.data_ptr() for t in tree_leaves(opt[k])]
           for k in ("m", "v", "master")}
    grads = tree_map(lambda p: torch.ones(p.shape), params)
    _, new = adamw.apply_updates(params, grads, opt, opt_cfg)
    for k, want in ids.items():
        assert [t.data_ptr() for t in tree_leaves(new[k])] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_family_train_trajectory_matches_reference(arch, ref_f32):
    """Two f32 steps of 2 x 64 tokens: ``make_train_step`` on one rank
    against the reference's step composed of ``value_and_grad(loss_fn)``
    and ``apply_updates`` on a 1x1x1 mesh (its ``make_train_step`` places
    the MoE's inputs with explicit shardings, which ``lax.ragged_dot``
    refuses on this JAX)."""
    cfg = _cfg(arch)
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=2)
    jopt_cfg = jadamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=2)
    jparams = _jax_params(cfg)
    params = from_numpy(jax_to_numpy(jparams), device="cpu")
    jopt = jadamw.init_opt_state(jparams, jopt_cfg)
    opt = adamw.init_opt_state(params, opt_cfg)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, cfg, b)))
    update = _ref_update(jopt_cfg)
    step = make_train_step(cfg, opt_cfg, device="cpu")
    for i in range(2):
        batch = _batch(cfg, 64, step=i)
        jloss, jgrads = grad_fn(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        jparams, jopt = update(jparams, jgrads, jopt)
        # off the update's mesh: ragged_dot takes no explicit sharding
        jparams = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                               jparams)
        params, opt, loss = step(params, opt, batch)
        assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))


def _grid_batches(cfg):
    return [_batch(cfg, 64, B=4, step=i) for i in range(3)]


@functools.lru_cache(maxsize=None)
def _port_grid():
    cases = [(cfg, jax_to_numpy(_jax_params(cfg)), _grid_batches(cfg))
             for cfg in map(_cfg, GRID_ARCHS)]
    return run_ranks(ranks.family_trajectories, 4, "gloo",
                     (2, 2, cases, (MODE,)), timeout=300.0)


@pytest.mark.parametrize("arch", GRID_ARCHS)
def test_family_grid_trajectory_matches_reference(arch, ref_f32):
    """olmoe and seamless at smoke size, f32, 3 steps of 4 x 64 tokens
    (one row a rank) on 2x2x1 with int8 + EF on the slow axis and ZeRO-1:
    every rank reports the same loss, within 1e-4 of one rank's step on
    the global batch and of the reference's grid."""
    cfg = _cfg(arch)
    got = [r[cfg.name][MODE] for r in _port_grid()]
    assert all(g == got[0] for g in got)
    batches = _grid_batches(cfg)
    opt_cfg = adamw.OptConfig(comm_mode=MODE, lr=1e-3, warmup_steps=20,
                              total_steps=3)
    params = from_numpy(jax_to_numpy(_jax_params(cfg)), device="cpu")
    opt = adamw.init_opt_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, device="cpu")
    one = []
    for b in batches:
        params, opt, loss = step(params, opt, b)
        one.append(loss.item())
    want = _ref_grid_trajectory(cfg, MODE, _jax_params(cfg), batches)
    for g, o, w in zip(got[0], one, want):
        assert abs(g - o) <= 1e-4 * abs(o)
        assert abs(g - w) <= 1e-4 * abs(w)
