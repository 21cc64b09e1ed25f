"""Training RWKV-6 against the JAX package on the CPU.

The reference trains RWKV-6 through XLA's autodiff of its jnp chunked scan
(``layers._wkv_chunk_scan``, called from ``rwkv6_fwd``); its Pallas
``wkv_chunked`` has no VJP and no model path calls it.  The port's
``kernels.wkv.WKV`` runs the WKV kernel forward (on the CPU its plain
version, a copy of that jnp scan) and autograd through the plain scan in
the backward, recomputed from the saved inputs.  Held here:

* the Function against autograd straight through ``wkv_chunk_scan_ref``:
  equal bit for bit, the same graph recomputed;
* the Function against ``jax.vjp`` of ``_wkv_chunk_scan`` at the reference
  kernel test's shapes and with decays on the clip, and ``rwkv6_fwd``'s
  VJP against the reference's at a length that needs padding: f32 within
  1e-5 of max|g|;
* rwkv6-1.6b at smoke size (4 layers, d 64, 4 heads of 16), the
  reference's ``init_model(PRNGKey(0))`` weights carried over by
  ``params_from_jax``, in f32: the loss within 1e-5 (relative) and every
  gradient leaf within 1e-4 of its max|g| against
  ``jax.value_and_grad(loss_fn)``, as ``tests/test_torch_train.py``'s
  families; the remat runs each layer's WKV forward twice;
* a 2-step f32 trajectory of ``make_train_step`` against the reference's
  ``value_and_grad(loss_fn)`` and ``apply_updates`` (1e-4 relative);
* the train step on a 2x2x1 grid of four spawned gloo ranks with ZeRO-1
  (every leaf of the RWKV-6 layers synced, and scattered over data),
  against ``train`` on one rank from the same f32 weights: every loss
  within 1e-6 relative with the f32 sync, and with int8 + EF on the slow
  axis the first within 1e-6 and the rest within 1e-4, as the families'
  grid; the four ranks are spawned once for both;
* RWKV-6 on a model axis that cuts its columns inside a head trains, its
  losses those of one rank to bf16's rounding.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_bridge import forked_ranks, jax_to_numpy
from repro.configs.shapes import ShapeSpec as JaxShape
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.kernels import wkv as kw
from repro_torch.launch.mesh import Grid, run_ranks
from repro_torch.launch.step import (device_batch, loss_and_grads,
                                     make_train_step)
from repro_torch.launch.train import train
from repro_torch.models import layers as L
from repro_torch.models.convert import (from_numpy, params_from_jax,
                                        params_to_jax)
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves
from test_torch_train import _ref_update
from test_torch_wkv import wkv_inputs

ARCH = "rwkv6_1p6b"
VJP_TOL = 1e-5       # x max|g|
LOSS_TOL = 1e-5      # relative
GRAD_TOL = 1e-4      # x max|g| per leaf
TRAJ_TOL = 1e-4      # relative
GRID_TOL = 1e-6      # relative, a grid with the f32 sync against one rank
GRID_MODES = {"multilevel": GRID_TOL, "multilevel_compress": TRAJ_TOL}
# the reference kernel test's shapes (tests/test_kernels.py), and decays on
# the clip at two head dims
CASES = [(2, 64, 2, 16, "test"), (1, 128, 4, 32, "test"),
         (1, 64, 1, 64, "test"), (2, 64, 2, 16, "clip"),
         (1, 48, 2, 64, "clip")]


def _cfg():
    return configs.get_config(ARCH, smoke=True)


@functools.lru_cache(maxsize=None)
def _jax_init(cfg):
    return jax.jit(lambda key: JT.init_model(key, cfg))(jax.random.PRNGKey(0))


def _jax_params(cfg):
    return jax.tree.map(lambda a: jnp.array(a, jnp.float32, copy=True),
                        _jax_init(cfg))


def _batch(cfg, S, B=2, step=0):
    return JaxPipeline(cfg, JaxShape("test", "train", S, B)).host_batch(step)


def _cotangents(o_shape, s_shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(o_shape).astype(np.float32),
            rng.standard_normal(s_shape).astype(np.float32))


def _leaves(ins):
    return [torch.from_numpy(a).requires_grad_(True) for a in ins]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,hd,decay", CASES[:2] + CASES[3:4])
def test_function_is_the_plain_scans_autograd(B, S, H, hd, decay,
                                              with_state):
    """o, the final state and the five input gradients of ``wkv`` equal
    autograd straight through ``wkv_chunk_scan_ref``, bit for bit, with a
    cotangent on o alone or on both outputs."""
    ins = wkv_inputs(B, S, H, hd, decay, seed=2)
    g_o, g_s = map(torch.from_numpy, _cotangents((B, S, H, hd),
                                                 (B, H, hd, hd), 3))
    a, b = _leaves(ins), _leaves(ins)
    o, st = kw.wkv(*a, return_state=True)
    assert o.grad_fn is not None and "WKV" in type(o.grad_fn).__name__
    want_o, want_st = kw.wkv_chunk_scan_ref(*b, kw.CHUNK)
    assert torch.equal(o, want_o) and torch.equal(st, want_st)
    outs, cots = ([o, st], [g_o, g_s]) if with_state else ([o], [g_o])
    got = torch.autograd.grad(outs, a, cots)
    want = torch.autograd.grad([want_o, want_st][:len(outs)], b, cots)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,S,H,hd,decay", CASES)
def test_function_matches_reference_vjp(B, S, H, hd, decay):
    """The five gradients of ``wkv`` against ``jax.vjp`` of the reference's
    ``_wkv_chunk_scan``, cotangents on o and on the final state."""
    ins = wkv_inputs(B, S, H, hd, decay, seed=4)
    cots = _cotangents((B, S, H, hd), (B, H, hd, hd), 5)
    _, vjp = jax.vjp(lambda *t: JL._wkv_chunk_scan(*t, kw.CHUNK),
                     *map(jnp.asarray, ins))
    want = vjp(tuple(map(jnp.asarray, cots)))
    a = _leaves(ins)
    o, st = kw.wkv(*a, return_state=True)
    got = torch.autograd.grad([o, st], a, list(map(torch.from_numpy, cots)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= VJP_TOL * np.abs(w).max()


@pytest.mark.parametrize("S", [37, 64])
def test_rwkv6_fwd_vjp_matches_reference(S):
    """The time-mix sublayer's gradients (each of its parameters and the
    input) against ``jax.vjp`` of the reference's ``rwkv6_fwd``:
    S 37 is padded to 48 before the scan, and the pad's gradient is cut
    off by the slice back to 37 positions, as in the reference."""
    cfg = _cfg()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JL.init_rwkv6(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: JL.rwkv6_fwd(p, cfg, x), jp,
                     jnp.asarray(x))
    jg_p, jg_x = vjp(jnp.asarray(ct))
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in jax_to_numpy(jp).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = L.rwkv6_fwd(p, cfg, xt)
    names = ["mix", "u", "w_g", "w_k", "w_o", "w_r", "w_v", "w_w"]
    got = torch.autograd.grad(y, [p[k] for k in names] + [xt],
                              torch.from_numpy(ct))
    want = [jg_p[k] for k in names] + [jg_x]
    for name, g, w in zip(names + ["x"], got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= VJP_TOL * np.abs(w).max(), \
            name


def test_without_a_gradient_nothing_is_saved():
    """With grad mode off, or no input that requires a gradient, ``wkv``
    is the wrapper alone: no graph, nothing saved."""
    ins = _leaves(wkv_inputs(1, 32, 2, 16, "model"))
    with torch.no_grad():
        assert kw.wkv(*ins).grad_fn is None
    plain = [t.detach() for t in ins]
    o, st = kw.wkv(*plain, return_state=True)
    assert o.grad_fn is None and st.grad_fn is None
    assert torch.equal(o, kw.wkv_chunked(*plain))


@functools.lru_cache(maxsize=None)
def _ref_grad_fn(cfg):
    return jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, cfg, b)))


def _ref_loss_and_grads(cfg, jparams, batch):
    return _ref_grad_fn(cfg)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("S", [64, 100])
def test_loss_and_grads_match_reference(S, monkeypatch):
    """rwkv6-1.6b smoke in f32 against ``jax.value_and_grad(loss_fn)`` (S
    100 pads each layer's scan to 112): the loss and every gradient leaf.
    Each layer's WKV forward runs twice, in the forward and in the remat's
    re-run inside the backward, whose recomputed inputs its backward
    reads."""
    cfg = _cfg()
    jparams = _jax_params(cfg)
    batch = _batch(cfg, S)
    jloss, jgrads = _ref_loss_and_grads(cfg, jparams, batch)
    params = params_from_jax(jax_to_numpy(jparams), cfg, device="cpu")
    calls = []
    chunked = kw.wkv_chunked

    def counting(*a, **k):
        calls.append(torch.is_grad_enabled())
        return chunked(*a, **k)
    monkeypatch.setattr(kw, "wkv_chunked", counting)
    loss, grads = loss_and_grads(params, cfg, device_batch(batch, "cpu"))
    assert len(calls) == 2 * cfg.n_layers and not any(calls)
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    got = tree_leaves(params_to_jax(grads, cfg))
    want = jax.tree.leaves(jax_to_numpy(jgrads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


def test_train_trajectory_matches_reference():
    """Two f32 steps of 2 x 64 tokens: ``make_train_step`` on one rank
    against the reference's ``value_and_grad(loss_fn)`` and
    ``apply_updates`` on a 1x1x1 mesh."""
    cfg = _cfg()
    kw_ = dict(lr=1e-3, warmup_steps=20, total_steps=2)
    opt_cfg, jopt_cfg = adamw.OptConfig(**kw_), jadamw.OptConfig(**kw_)
    jparams = _jax_params(cfg)
    params = from_numpy(jax_to_numpy(jparams), device="cpu")
    jopt = jadamw.init_opt_state(jparams, jopt_cfg)
    opt = adamw.init_opt_state(params, opt_cfg)
    update = _ref_update(jopt_cfg)
    step = make_train_step(cfg, opt_cfg, device="cpu")
    for i in range(2):
        batch = _batch(cfg, 64, step=i)
        jloss, jgrads = _ref_loss_and_grads(cfg, jparams, batch)
        jparams, jopt = update(jparams, jgrads, jopt)
        params, opt, loss = step(params, opt, batch)
        assert abs(loss.item() - float(jloss)) <= TRAJ_TOL * abs(float(jloss))


def _grid_batches(cfg):
    return [_batch(cfg, 32, B=4, step=i) for i in range(3)]


@pytest.fixture(scope="module")
def grid_losses():
    """The losses of 3 f32 steps on a 2x2x1 grid of four spawned gloo
    ranks (ZeRO-1), each sync mode from the reference's weights: every
    rank's, per mode."""
    cfg = _cfg()
    return run_ranks(ranks.family_trajectories, 4, "gloo", (
        2, 2, [(cfg, jax_to_numpy(_jax_params(cfg)), _grid_batches(cfg))],
        tuple(GRID_MODES)), timeout=300.0)


@pytest.mark.parametrize("mode", list(GRID_MODES))
def test_train_on_a_grid_matches_one_rank(grid_losses, mode):
    """rwkv6-1.6b smoke from the reference's f32 weights, 3 steps of 4 x
    32, on a 2x2x1 grid (ZeRO-1 over data) against ``train`` on one rank:
    every rank reports the same finite losses, the first within 1e-6 of
    one rank's, the rest within 1e-6 with the f32 sync and within 1e-4
    with int8 + EF on the slow axis (its rounding moves the update)."""
    cfg = _cfg()
    got = [r[cfg.name][mode] for r in grid_losses]
    assert all(g == got[0] for g in got) and len(got[0]) == 3
    one = train(ARCH, 3, seq=32, batch=4, comm=mode, smoke=True,
                device="cpu", init_params=jax_to_numpy(_jax_params(cfg)))
    want = one["losses"]
    assert all(np.isfinite(got[0] + want))
    assert abs(got[0][0] - want[0]) <= GRID_TOL * abs(want[0])
    for g, o in zip(got[0], want):
        assert abs(g - o) <= GRID_MODES[mode] * abs(o)


def test_a_model_axis_still_refuses_rwkv6():
    """RWKV-6 trains on a model axis that divides its heads
    (``tests/test_torch_tp_families.py``) and, once refused, on one that
    cuts inside a head: the smoke config's 4 heads of 16 columns on 8
    ranks, 8 columns a rank (``tests/test_torch_tp_inside.py`` holds the
    cut to one rank and the reference in f32).  Here the train step
    builds, and ``train`` runs 2 bf16 steps on 1x1x8 whose losses are
    those of one rank to bf16's rounding (1e-2 relative)."""
    for model in (2, 8):
        assert callable(make_train_step(_cfg(), adamw.OptConfig(),
                                        Grid.shape_only(1, 1, model),
                                        device="cpu"))
    kw = dict(seq=32, batch=2, smoke=True, device="cpu")
    got = train(ARCH, 2, mesh_spec="1x1x8", **kw)["losses"]
    want = train(ARCH, 2, **kw)["losses"]
    assert len(got) == 2 and all(map(np.isfinite, got))
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-2 * abs(w)
