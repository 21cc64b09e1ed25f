"""The port's enc-dec pieces and the frontends' prefix against
``repro.models``: cross-attention (the sublayer, its K/V and its
one-token decode), the encoder, and pixtral's vision prefix through
prefill and the dense decode.

Weights come from the reference's initialisers, carried over by
``params_from_jax``; inputs from numpy with a seed.  Tolerances: layers
as ``test_torch_layers`` (f32 1e-5 relative and absolute; bf16 2e-2
absolute plus 2e-2 relative); the encoder's output and the models'
logits as ``test_torch_model``'s ``LOGIT_TOL`` (f32 1e-4; bf16 5e-2, a
few bf16 ulps over the layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_f32, cast_tree, jax_to_numpy, to_torch
from repro.configs import get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

KEY = jax.random.PRNGKey(3)
DTYPES = ["float32", "bfloat16"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _close(got, want, tol):
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=0)


def _layer_close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _xattn(arch, dtype):
    cfg = get_config(arch, smoke=True)
    jp = cast_tree(JL.init_attention(KEY, cfg, cross=True),
                   getattr(jnp, dtype))
    return cfg, jp, to_torch(jp)


def test_cross_attention_has_no_qk_norm():
    """qwen3 has q/k norms; its cross-attention, as the reference's, has
    none."""
    cfg = get_config("qwen3_4b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    assert "q_norm" in L.init_attention(gen, cfg)
    ours = L.init_attention(gen, cfg, cross=True)
    assert set(ours) == set(JL.init_attention(KEY, cfg, cross=True)) \
        == {"wq", "wk", "wv", "wo"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_fwd_matches_reference(dtype):
    """``attention_fwd(kv_src=)``: 12 queries against 20 encoder frames,
    no rope and no causal mask."""
    cfg, jp, tp = _xattn("seamless_m4t_medium", dtype)
    jx, tx = _x((2, 12, cfg.d_model), dtype)
    je, te = _x((2, 20, cfg.d_model), dtype, seed=1)
    want = jax.jit(lambda p, x, e: JL.attention_fwd(p, cfg, x, kv_src=e))(
        jp, jx, je)
    _layer_close(L.attention_fwd(tp, cfg, tx, kv_src=te), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kv_and_decode_match_reference(dtype):
    cfg, jp, tp = _xattn("seamless_m4t_medium", dtype)
    je, te = _x((2, 20, cfg.d_model), dtype, seed=1)
    jk, jv = jax.jit(lambda p, e: JL.cross_kv(p, cfg, e))(jp, je)
    k, v = L.cross_kv(tp, cfg, te)
    assert k.dtype == v.dtype == torch.bfloat16
    _layer_close(k, jk, dtype)
    _layer_close(v, jv, dtype)
    jx, tx = _x((2, 1, cfg.d_model), dtype, seed=2)
    want = jax.jit(lambda p, x, a, b: JL.cross_attention_decode(
        p, cfg, x, a, b))(jp, jx, jk, jv)
    _layer_close(L.cross_attention_decode(tp, cfg, tx, to_torch(jk),
                                          to_torch(jv)), want, dtype)


def _model(arch, dtype):
    cfg = get_config(arch, smoke=True)
    jparams = cast_tree(JT.init_model(jax.random.PRNGKey(0), cfg),
                        getattr(jnp, dtype))
    return cfg, jparams, params_from_jax(jax_to_numpy(jparams), cfg,
                                         device="cpu")


def _encoder_unrolled(params, cfg, src):
    """The reference's ``encoder_fwd`` with its layer scan unrolled: its
    scan refuses f32 weights, whose first layer turns the bf16 carry into
    f32, while the layers themselves promote as ``jnp.matmul`` does."""
    x = src.astype(jnp.bfloat16)
    run = params["enc"]["runs"][0]
    for i in range(cfg.enc_dec.n_enc_layers):
        p = jax.tree.map(lambda a: a[i], run)
        x = JT._layer_fwd(p, cfg, "attn", x, None, False)
    return JL.rmsnorm(x, params["enc"]["final_norm"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_fwd_matches_reference(dtype):
    """seamless's encoder (2 non-causal layers at smoke size) on bf16
    ``src_embeds``.  In f32 its first layer takes the bf16 input against
    f32 weights; the reference's layers (unrolled) promote it to f32.
    Both dtypes are held to the bf16 tolerance: the input is bf16 in both,
    and XLA keeps the first norm's ``x * scale`` in f32 where the code
    (and the port) rounds it to bf16 (excess precision; 9e-4 apart at the
    output in f32)."""
    cfg, jparams, params = _model("seamless_m4t_medium", dtype)
    src = np.random.default_rng(5).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32)
    ref = JT.encoder_fwd if dtype == "bfloat16" else _encoder_unrolled
    want = jax.jit(lambda p, s: ref(p, cfg, s))(jparams, jnp.asarray(src))
    got = T.encoder_fwd(params, cfg, torch.from_numpy(src))
    assert got.shape == (2, 10, cfg.d_model)
    _close(got, want, LOGIT_TOL["bfloat16"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_vision_prefix_through_prefill_and_decode(dtype):
    """pixtral with 4 patch embeds before 6 tokens: prefill logits and
    caches (10 positions), then greedy dense decode steps that read the
    prefix from the cache."""
    cfg, jparams, params = _model("pixtral_12b", dtype)
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    jemb = jnp.asarray(emb, jnp.bfloat16)
    s_max = 16
    jlg, jcache, jS = jax.jit(lambda p, t, e: JT.prefill(
        p, cfg, {"tokens": t, "embeds": e}, s_max))(
        jparams, jnp.asarray(toks), jemb)
    lg, cache, S = T.prefill(params, cfg,
                             {"tokens": torch.from_numpy(toks).long(),
                              "embeds": to_torch(jemb)}, s_max)
    assert S == jS == 10
    _close(lg, jlg, LOGIT_TOL[dtype])
    for ent, jent in zip(cache, jcache):
        assert ent["k"].shape == jent["k"].shape == (len(ent["k"]), 2,
                                                     s_max, 1, 16)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
    tok = np.argmax(as_f32(jlg)[:, -1], -1)[:, None].astype(np.int32)
    for i in range(3):
        jlg, jcache = step(jparams, jcache, jnp.asarray(tok),
                           jnp.int32(S + i))
        lg, cache = T.decode_step(params, cfg, cache,
                                  torch.from_numpy(tok).long(), S + i)
        _close(lg, jlg, LOGIT_TOL[dtype])
        tok = np.argmax(as_f32(jlg)[:, -1], -1)[:, None].astype(np.int32)
