"""The port's RWKV-6 layers, its dense prefill and decode, against
``repro.models``: the layers, ``prefill`` and a greedy ``decode_step``
loop on rwkv6-1.6b at smoke size, the dense attention decode on gpt-100m
and gemma3 (a windowed ring), the paths that refuse RWKV-6, and that it
trains.

Weights are the reference's initialisers, carried over by
``params_from_jax``.  Tolerances:

* layers: f32 1e-5 relative and absolute (summation order, the last bit of
  log/exp); bf16 2e-2 absolute plus 2e-2 relative, one bf16 ulp of values
  near 1, the bf16 tolerance of the JAX tests (as ``test_torch_layers``);
* the model in f32 (every weight cast): logits 1e-4 and the WKV state
  1e-4 of its largest value; x_tm and x_cm are stored in bf16, where the
  two frameworks may round a value to the neighbouring bf16 number, so
  they agree to one bf16 ulp, 2**-7 of the value;
* the model as shipped (bf16 matrices): every op rounds to bf16, and over
  four layers a value rounded the other way moves the logits by a few bf16
  ulps: 5e-2 absolute on logits up to 8 (3.7e-2 measured), as
  ``test_torch_model``; the state and the carried rows 5e-2 of their
  largest value (1.1e-2 measured).
The greedy tokens agree in both.

The time mix also at a head dim of 128 (the smoke config with d_model
256, two heads) and in chunks of 8, where the port raised before, and its
gradient at chunk 8 against ``jax.grad`` of the reference's, in f32 within
1e-5 of max|g| (``test_torch_train_rwkv.py``'s tolerance at chunk 16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_f32, cast_tree, jax_to_numpy, to_torch
from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.launch import serve as torch_serve
from repro_torch.launch.step import make_decode_fn, make_prefill_fn
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax)
from repro_torch.tree import tree_leaves

KEY = jax.random.PRNGKey(3)
DTYPES = ["float32", "bfloat16"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STATE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}     # of the largest value


def _close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _rwkv(dtype):
    cfg = jconfigs.get_config("rwkv6_1p6b", smoke=True)
    jp = JL.init_rwkv6(KEY, cfg)
    if dtype == "float32":
        jp = cast_tree(jp, jnp.float32)
    return cfg, jp, to_torch(jp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [32, 21])
def test_rwkv6_fwd(S, dtype):
    """The time mix with its state: 32 tokens, and 21, which pads to 32."""
    cfg, jp, tp = _rwkv(dtype)
    jx, tx = _x((2, S, cfg.d_model), dtype)
    y, st = L.rwkv6_fwd(tp, cfg, tx, return_state=True)
    jy, jst = JL.rwkv6_fwd(jp, cfg, jx, return_state=True)
    assert y.dtype == tx.dtype and st["S"].dtype == torch.float32
    _close(y, jy, dtype)
    _close(st["S"], jst["S"], dtype)
    _close(L.rwkv6_fwd(tp, cfg, tx), jy, dtype)


def _variant(name, dtype):
    """The smoke config and weights of ``name``: "hd128" (d_model 256,
    two heads of 128) or "chunk8" (the smoke config), and its chunk."""
    cfg = jconfigs.get_config("rwkv6_1p6b", smoke=True)
    if name == "hd128":
        cfg = dataclasses.replace(cfg, d_model=256, rwkv_head_dim=128)
    jp = JL.init_rwkv6(KEY, cfg)
    if dtype == "float32":
        jp = cast_tree(jp, jnp.float32)
    return cfg, jp, to_torch(jp), 8 if name == "chunk8" else 16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["hd128", "chunk8"])
def test_rwkv6_fwd_other_head_dims_and_chunks(name, dtype):
    """The time mix with its state at hd 128 and in chunks of 8: 21
    tokens, padded to the chunk, against the reference's."""
    cfg, jp, tp, chunk = _variant(name, dtype)
    jx, tx = _x((2, 21, cfg.d_model), dtype, seed=2)
    y, st = L.rwkv6_fwd(tp, cfg, tx, chunk=chunk, return_state=True)
    jy, jst = JL.rwkv6_fwd(jp, cfg, jx, chunk=chunk, return_state=True)
    assert st["S"].shape == (2, cfg.d_model // cfg.rwkv_head_dim,
                             cfg.rwkv_head_dim, cfg.rwkv_head_dim)
    _close(y, jy, dtype)
    _close(st["S"], jst["S"], dtype)


@pytest.mark.parametrize("name", ["chunk8", "hd128"])
def test_rwkv6_fwd_grad_other_chunks_matches_reference(name):
    """The gradient of a scalar of the time mix (every parameter and the
    input) through ``wkv`` at chunk 8 and at hd 128, against ``jax.grad``
    of the reference's: 37 tokens, padded to 40 and 48."""
    cfg, jp, _, chunk = _variant(name, "float32")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    jg_p, jg_x = jax.grad(lambda p, x: jnp.sum(
        JL.rwkv6_fwd(p, cfg, x, chunk=chunk) * ct), argnums=(0, 1))(
            jp, jnp.asarray(x))
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in jax_to_numpy(jp).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = L.rwkv6_fwd(p, cfg, xt, chunk=chunk)
    names = ["mix", "u", "w_g", "w_k", "w_o", "w_r", "w_v", "w_w"]
    got = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                              [p[k] for k in names] + [xt])
    for k, g, w in zip(names + ["x"], got, [jg_p[k] for k in names]
                       + [jg_x]):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), k


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv6_channel_mix(dtype):
    cfg, jp, tp = _rwkv(dtype)
    jx, tx = _x((2, 24, cfg.d_model), dtype)
    _close(L.rwkv6_channel_mix(tp, cfg, tx),
           JL.rwkv6_channel_mix(jp, cfg, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv6_decode_steps(dtype):
    """The one-token time mix and channel mix from a random state."""
    cfg, jp, tp = _rwkv(dtype)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    rng = np.random.default_rng(7)
    S0 = rng.standard_normal((3, H, hd, hd)).astype(np.float32)
    jx, tx = _x((3, 1, cfg.d_model), dtype)
    jprev, tprev = _x((3, cfg.d_model), dtype, seed=1)
    y, st = L.rwkv6_decode(tp, cfg, tx, {"S": torch.from_numpy(S0),
                                         "x_tm": tprev})
    jy, jst = JL.rwkv6_decode(jp, cfg, jx, {"S": jnp.asarray(S0),
                                            "x_tm": jprev})
    _close(y, jy, dtype)
    _close(st["S"], jst["S"], dtype)
    _close(st["x_tm"], jst["x_tm"], dtype)
    y2, carry = L.rwkv6_channel_mix_decode(tp, cfg, tx, tprev)
    jy2, jcarry = JL.rwkv6_channel_mix_decode(jp, cfg, jx, jprev)
    _close(y2, jy2, dtype)
    _close(carry, jcarry, dtype)


def _model(arch, dtype):
    """The reference's weights: as shipped (bf16 matrices, f32 norms, u and
    mixes) for "bfloat16", every leaf cast for "float32"."""
    cfg = configs.get_config(arch, smoke=True)
    jparams = JT.init_model(jax.random.PRNGKey(0), cfg)
    if dtype == "float32":
        jparams = cast_tree(jparams, jnp.float32)
    return cfg, jparams, params_from_jax(jax_to_numpy(jparams), cfg,
                                         device="cpu")


def _close_cache(cache, jcache, dtype):
    for ent, jent in zip(cache, jcache):
        assert set(ent) == set(jent)
        for name in ent:
            got, want = as_f32(ent[name]), as_f32(jent[name])
            assert got.shape == want.shape
            assert ent[name].dtype == {"S": torch.float32}.get(
                name, torch.bfloat16)
            top = np.abs(want).max()
            if name == "S" or dtype == "bfloat16":
                tol = STATE_TOL[dtype] * top
                np.testing.assert_allclose(got, want, atol=tol, rtol=0)
            else:                        # bf16 rows of an f32 model
                np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                           atol=1e-6 * top)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [32, 21])
def test_prefill_and_greedy_decode_match_reference(S, dtype):
    """rwkv6-1.6b smoke through ``make_prefill_fn``/``make_decode_fn``:
    the prefill's logits and every cache leaf, then six greedy steps, each
    fed the reference's token, logits and caches after every step."""
    cfg, jparams, params = _model("rwkv6_1p6b", dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, S),
                                             dtype=np.int32)
    s_max = S + 8
    logits, cache, pos = make_prefill_fn(cfg, s_max)(
        params, {"tokens": torch.from_numpy(toks).long()})
    jlogits, jcache, jpos = jax.jit(lambda p, t: JT.prefill(
        p, cfg, {"tokens": t}, s_max))(jparams, jnp.asarray(toks))
    assert pos == jpos == S
    np.testing.assert_allclose(as_f32(logits), as_f32(jlogits),
                               atol=LOGIT_TOL[dtype], rtol=0)
    _close_cache(cache, jcache, dtype)
    assert np.array_equal(as_f32(logits).argmax(-1), as_f32(jlogits).argmax(-1))

    decode = make_decode_fn(cfg)
    jstep = jax.jit(lambda p, c, t, i: JT.decode_step(p, cfg, c, t, i))
    tok = np.argmax(as_f32(jlogits)[:, -1], -1).astype(np.int32)[:, None]
    for i in range(6):
        lg, cache = decode(params, cache, torch.from_numpy(tok).long(),
                           pos + i)
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tok),
                            jnp.int32(pos + i))
        np.testing.assert_allclose(as_f32(lg), as_f32(jlg),
                                   atol=LOGIT_TOL[dtype], rtol=0)
        _close_cache(cache, jcache, dtype)
        assert np.array_equal(as_f32(lg).argmax(-1), as_f32(jlg).argmax(-1))
        tok = np.argmax(as_f32(jlg)[:, 0], -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("arch", ["gpt_100m", "gemma3_12b"])
def test_dense_attention_decode_matches_reference(arch):
    """``decode_step`` over the dense cache of ``prefill`` (f32 weights):
    gpt-100m's full cache, and gemma3's windowed layers (a ring of 8
    slots, wrapped twice in 16 steps) beside its global ones."""
    cfg, jparams, params = _model(arch, "float32")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16),
                                             dtype=np.int32)
    s_max = 32
    logits, cache, pos = T.prefill(params, cfg,
                                   {"tokens": torch.from_numpy(toks).long()},
                                   s_max)
    jlogits, jcache, _ = jax.jit(lambda p, t: JT.prefill(
        p, cfg, {"tokens": t}, s_max))(jparams, jnp.asarray(toks))
    jstep = jax.jit(lambda p, c, t, i: JT.decode_step(p, cfg, c, t, i))
    tok = np.argmax(as_f32(jlogits)[:, -1], -1).astype(np.int32)[:, None]
    for i in range(16):
        lg, cache = T.decode_step(params, cfg, cache,
                                  torch.from_numpy(tok).long(),
                                  torch.tensor(pos + i))
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tok),
                            jnp.int32(pos + i))
        np.testing.assert_allclose(as_f32(lg), as_f32(jlg),
                                   atol=LOGIT_TOL["float32"], rtol=0)
        tok = np.argmax(as_f32(jlg)[:, 0], -1).astype(np.int32)[:, None]
    for ent, jent in zip(cache, jcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(as_f32(ent[name]), as_f32(jent[name]),
                                       atol=1e-2, rtol=0)


def test_init_cache_and_cache_conversion_match_reference():
    cfg = configs.get_config("rwkv6_1p6b", smoke=True)
    want = jax_to_numpy(JT.init_cache(cfg, 3, 40))
    got = cache_to_numpy(T.init_cache(cfg, 3, 40, device="cpu"))
    assert len(got) == len(want)
    for ent, jent in zip(got, want):
        assert set(ent) == set(jent)
        for name in ent:
            assert ent[name].shape == jent[name].shape
            assert ent[name].dtype == jent[name].dtype
    back = cache_from_jax(want, cfg, device="cpu")
    assert back[0]["x_tm"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="runs"):
        cache_from_jax(want + want, cfg, device="cpu")
    with pytest.raises(ValueError, match="rwkv6"):
        cache_from_jax([{"k": want[0]["S"], "v": want[0]["S"]}], cfg,
                       device="cpu")


def test_paged_serving_refuses_rwkv6_as_the_reference_does():
    cfg = configs.get_config("rwkv6_1p6b", smoke=True)
    with pytest.raises(ValueError, match="attention-only"):
        JT.paged_arch_check(cfg)
    with pytest.raises(ValueError, match="attention-only"):
        T.paged_arch_check(cfg)
    with pytest.raises(ValueError, match="attention-only"):
        T.init_paged_pools(cfg, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        torch_serve.serve("rwkv6-1.6b", 2, 8, 2, device="cpu")


def test_rwkv6_trains_and_runs_the_full_forward():
    """RWKV-6 trains (``tests/test_torch_train_rwkv.py`` holds it to the
    reference): a finite loss and a finite gradient for every leaf, the
    time mix's included; and the full forward without a gradient gives
    the prefill's last logits."""
    from repro_torch.launch.step import loss_and_grads

    cfg = configs.get_config("rwkv6_1p6b", smoke=True)
    params = T.init_model(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 21),
                         generator=torch.Generator().manual_seed(0))
    loss, grads = loss_and_grads(params, cfg, {"tokens": toks,
                                               "labels": toks})
    assert torch.isfinite(loss)
    leaves = [g.float() for g in tree_leaves(grads["layers"][0]["rwkv"])]
    assert all(torch.isfinite(g).all() and g.abs().max() > 0
               for g in leaves)
    with torch.no_grad():
        logits = T.model_fwd(params, cfg, {"tokens": toks})
    last, _, _ = T.prefill(params, cfg, {"tokens": toks}, 32)
    torch.testing.assert_close(logits[:, -1:], last, rtol=0, atol=1e-5)
