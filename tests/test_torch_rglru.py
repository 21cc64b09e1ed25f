"""The port's RG-LRU block against ``repro.models.layers`` on the same
inputs: ``init_rglru``'s leaves, ``rglru_fwd`` (with and without a
carried state), the prefill's state, the one-token decode, and the
log-step scan against a sequential loop.

Weights come from the reference's ``init_rglru`` (bf16 matrices and conv,
f32 ``lam``; in the f32 cases every leaf cast to f32) and inputs from
numpy with a seed.  Tolerances are ``test_torch_layers``': f32 1e-5
relative and absolute (the log-step scan and XLA's associative scan
combine in other trees; exp and the sums differ in the last bit); bf16
2e-2 absolute plus 2e-2 relative.  The prefill's conv state is the
pre-conv input itself, so it is compared exactly, and so is the decode's
bf16 conv: its four taps summed in f32 and rounded once give XLA's bf16
``einsum("bkr,kr->br")`` bit for bit.  The scan is held to a sequential
f32 loop within 1e-5 of the state's largest value at S 2048.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_f32, cast_tree, to_torch
from repro.configs import get_config
from repro.models import layers as JL
from repro_torch.models import layers as L

KEY = jax.random.PRNGKey(3)
DTYPES = ["float32", "bfloat16"]


def _close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _rglru(dtype):
    cfg = get_config("recurrentgemma_2b", smoke=True)
    jp = JL.init_rglru(KEY, cfg)
    if dtype == "float32":
        jp = cast_tree(jp, jnp.float32)
    return cfg, jp, to_torch(jp)


def test_init_rglru_leaves_match_reference():
    cfg = get_config("recurrentgemma_2b", smoke=True)
    ours = L.init_rglru(torch.Generator().manual_seed(0), cfg)
    ref = JL.init_rglru(KEY, cfg)
    assert set(ours) == set(ref)
    for k, a in ours.items():
        assert tuple(a.shape) == ref[k].shape, k
        assert str(a.dtype) == f"torch.{ref[k].dtype}", k
    np.testing.assert_allclose(ours["lam"].numpy(), np.asarray(ref["lam"]),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("carry", [False, True])
def test_rglru_fwd_matches_reference(dtype, carry):
    """y and the last state, from a zero state or a carried ``h0``."""
    cfg, jp, tp = _rglru(dtype)
    jx, tx = _x((2, 33, cfg.d_model), dtype)
    h0 = np.random.default_rng(1).standard_normal((2, 64)).astype(np.float32)
    jh0, th0 = (jnp.asarray(h0), torch.from_numpy(h0)) if carry \
        else (None, None)
    jy, jh = jax.jit(lambda p, x, h: JL.rglru_fwd(p, cfg, x, h))(jp, jx, jh0)
    y, h = L.rglru_fwd(tp, cfg, tx, th0)
    assert y.dtype == tx.dtype and h.dtype == torch.float32
    _close(y, jy, dtype)
    _close(h, jh, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [2, 16])
def test_rglru_prefill_state_matches_reference(dtype, S):
    """y, h and the conv state (the last three pre-conv inputs, zero
    padded in front when S < 3)."""
    cfg, jp, tp = _rglru(dtype)
    jx, tx = _x((2, S, cfg.d_model), dtype)
    jy, jh, jc = jax.jit(lambda p, x: JL.rglru_prefill(p, cfg, x))(jp, jx)
    y, h, conv = L.rglru_prefill(tp, cfg, tx)
    _close(y, jy, dtype)
    _close(h, jh, dtype)
    assert conv.shape == (2, 3, 64) and h.dtype == torch.float32
    np.testing.assert_array_equal(as_f32(conv), as_f32(jc))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode_matches_reference(dtype):
    """Three decode steps from a prefill's state, each fed the same
    state on both sides: y, h and the shifted conv window."""
    cfg, jp, tp = _rglru(dtype)
    jx, tx = _x((2, 5, cfg.d_model), dtype)
    _, jh, jc = jax.jit(lambda p, x: JL.rglru_prefill(p, cfg, x))(jp, jx)
    jc = jc.astype(jnp.bfloat16)          # the cache keeps it in bf16
    decode = jax.jit(lambda p, x, h, c: JL.rglru_decode(p, cfg, x, h, c))
    for step in range(3):
        jx1, tx1 = _x((2, 1, cfg.d_model), dtype, seed=10 + step)
        jy, jh2, jc2 = decode(jp, jx1, jh, jc)
        y, h, conv = L.rglru_decode(tp, cfg, tx1, to_torch(jh),
                                    to_torch(jc))
        _close(y, jy, dtype)
        _close(h, jh2, dtype)
        np.testing.assert_array_equal(as_f32(conv), as_f32(jc2))
        jh, jc = jh2, jc2.astype(jnp.bfloat16)


def test_decode_conv_rounds_once_as_xla():
    """The bf16 conv of the decode: the f32 sum of the four taps rounded
    once equals the reference's bf16 einsum bit for bit."""
    rng = np.random.default_rng(4)
    win = rng.standard_normal((8, 4, 256)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (4, 256)).astype(np.float32)
    jw, jk = jnp.asarray(win, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jax.jit(lambda a, b: jnp.einsum("bkr,kr->br", a, b))(jw, jk)
    tw, tk = to_torch(jw), to_torch(jk)
    got = (tw.float() * tk.float()).sum(1).to(torch.bfloat16)
    np.testing.assert_array_equal(as_f32(got), as_f32(want))


def test_log_step_scan_matches_sequential_loop():
    """h_t = a_t h_{t-1} + b_t at S 2048 with decays in (0.9, 1), the
    RG-LRU's range: the log-step scan within 1e-5 of max|h| of an f32
    loop over t."""
    rng = np.random.default_rng(0)
    B, S, R = 2, 2048, 64
    a = torch.from_numpy(rng.uniform(0.9, 0.9999, (B, S, R))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((B, S, R)).astype(np.float32))
    got = L.linear_scan(a, b)
    want = torch.empty_like(b)
    h = torch.zeros(B, R)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    top = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * top)


def test_log_step_scan_takes_decays_to_zero():
    """Decays that make a running product underflow f32 (0.5 ** 2048):
    the scan never forms one, so the states stay finite and exact."""
    B, S, R = 1, 2048, 4
    a = torch.full((B, S, R), 0.5)
    b = torch.ones((B, S, R))
    h = L.linear_scan(a, b)
    assert torch.isfinite(h).all()
    torch.testing.assert_close(h[:, -1], torch.full((B, R), 2.0))
