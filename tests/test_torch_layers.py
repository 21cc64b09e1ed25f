"""The port's layers against ``repro.models.layers`` on the same inputs.

Weights come from the reference's own initialisers and inputs from numpy
with a seed.  In f32 the two frameworks differ only in summation order and
in the last bit of pow/sin/cos: tolerance 1e-5 relative and absolute.  In
bf16 every elementwise op rounds, and the frameworks may round one value to
the neighbouring bf16 number: tolerance 2e-2 absolute plus 2e-2 relative
(one bf16 ulp is 2**-8 of the value), the bf16 tolerance of the JAX tests.
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    jx, tx = _x((2, 5, 64), dtype)
    w = np.random.default_rng(1).standard_normal(64).astype(np.float32) * 0.1
    _close(L.rmsnorm(tx, torch.from_numpy(w)),
           jax.jit(JL.rmsnorm)(jx, jnp.asarray(w)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    jx, tx = _x((2, 7, 4, 16), dtype)
    pos = np.arange(3, 10)
    rope = jax.jit(JL.rope, static_argnums=2)
    _close(L.rope(tx, torch.from_numpy(pos), 1e4),
           rope(jx, jnp.asarray(pos), 1e4), dtype)
    # per-slot decode positions, (B, 1)
    jx, tx = _x((3, 1, 4, 16), dtype, seed=2)
    pos = np.array([[0], [5], [17]])
    _close(L.rope(tx, torch.from_numpy(pos), 1e6),
           rope(jx, jnp.asarray(pos), 1e6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["gpt_100m", "qwen3_4b", "gemma3_12b"])
def test_mlp(arch, dtype):
    """gelu (tanh approximation), swiglu and geglu."""
    cfg = get_config(arch, smoke=True)
    jp = cast_tree(JL.init_mlp(KEY, cfg), getattr(jnp, dtype))
    jx, tx = _x((2, 6, cfg.d_model), dtype)
    want = jax.jit(lambda p, x: JL.mlp_fwd(p, cfg, x))(jp, jx)
    _close(L.mlp_fwd(to_torch(jp), cfg, tx), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,window", [("gpt_100m", None),
                                         ("qwen3_4b", None),
                                         ("gemma3_12b", 8)])
def test_attention_prefill(arch, window, dtype):
    """Output and bf16 cache of the causal prefill sublayer: plain, GQA
    with qk_norm, and a sliding window (full and wrapped cache)."""
    cfg = get_config(arch, smoke=True)
    jp = cast_tree(JL.init_attention(KEY, cfg), getattr(jnp, dtype))
    tp = to_torch(jp)
    jx, tx = _x((2, 16, cfg.d_model), dtype)
    for keep_full in (True, False):
        y, ck, cv = L.attention_prefill(tp, cfg, tx, window=window,
                                        keep_full=keep_full)
        jy, jck, jcv = jax.jit(lambda p, x: JL.attention_prefill(
            p, cfg, x, window=window, keep_full=keep_full))(jp, jx)
        _close(y, jy, dtype)
        assert ck.dtype == torch.bfloat16 and ck.shape == jck.shape
        _close(ck, jck, "bfloat16")
        _close(cv, jcv, "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,window", [("tinyllama_1p1b", None),
                                         ("qwen3_4b", None),
                                         ("gemma3_12b", 8)])
def test_paged_attention_decode(arch, window, dtype):
    """One decode token per slot against random pools: the output and the
    pools after the write, with slots at different depths and an idle slot
    on the null block."""
    cfg = get_config(arch, smoke=True)
    jp = cast_tree(JL.init_attention(KEY, cfg), getattr(jnp, dtype))
    tp = to_torch(jp)
    n_blocks, BS = 9, 4
    rng = np.random.default_rng(5)
    pool = rng.standard_normal(
        (2, n_blocks, BS, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    jpk, jpv = (jnp.asarray(pool[i], jnp.bfloat16) for i in range(2))
    tpk, tpv = (torch.from_numpy(pool[i]).bfloat16() for i in range(2))
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0],
                       [6, 7, 8, 0]], np.int32)
    pos = np.array([9, 4, 0, 11], np.int32)
    jx, tx = _x((4, 1, cfg.d_model), dtype)
    y, pk, pv = L.paged_attention_decode(
        tp, cfg, tx, tpk, tpv, torch.from_numpy(tables),
        torch.from_numpy(pos).long(), window=window)
    jy, jpk, jpv = jax.jit(lambda *a: JL.paged_attention_decode(
        *a, window=window), static_argnums=1)(
        jp, cfg, jx, jpk, jpv, jnp.asarray(tables), jnp.asarray(pos))
    _close(y, jy, dtype)
    # every block but the null one, which idle slots race to write
    _close(pk[1:], jpk[1:], "bfloat16")
    _close(pv[1:], jpv[1:], "bfloat16")
