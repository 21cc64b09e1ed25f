"""The port's flash-attention backward on the CPU against the JAX package.

On CPU tensors ``flash_attention_bwd`` runs the kernels' plain version,
and ``FlashAttention`` (the autograd Function) runs it under
``torch.autograd.grad``.  Both are held against the Pallas backward
kernels in interpret mode (what ``tests/test_kernels.py`` runs) fed the
same (q, k, v, o, lse, do), and against ``jax.vjp`` through the
reference's ``chunked_attention(impl="jnp")``, whose custom VJP is the
kernels' oracle.  Inputs come from numpy with a seed; the blocks are 64,
so S 128/256 tile them.  Tolerances: 1e-4 x max|ref| in f32, as
``tests/test_kernels.py`` uses for the backward, and 2e-2 x max|ref| in
bf16 (the outputs round to bf16, and the two frameworks round the f32
sums at different places).  The plain version that mirrors the card's
bf16 kernels (P and dS rounded to bf16 where they feed a product) is held
to the Pallas backward under the same 2e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_f32, jax_to_numpy, numpy_to_torch
from repro.kernels.flash_attention import flash_attention_bwd as jax_bwd
from repro.models.layers import chunked_attention as jax_chunked
from repro.models.layers import naive_attention as jax_naive
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _close(got, want, dtype):
    got, want = as_f32(got), as_f32(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


def _inputs(B, Sq, Sk, H, Hkv, hd, dtype, seed=0):
    """(q, k, v, do) from a numpy seed, as torch tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        getattr(torch, dtype)) for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd),
                                         (B, Sk, Hkv, hd), (B, Sq, H, hd))]


def _jax(t):
    """A torch tensor as a JAX array of the same dtype, bit for bit."""
    bits = t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()
    a = jnp.asarray(bits)
    return jax.lax.bitcast_convert_type(a, jnp.bfloat16) \
        if a.dtype == jnp.uint16 else a


def _vjp(fn, q, k, v, do):
    """jax.vjp of ``fn`` at (q, k, v) applied to ``do``, jitted."""
    return jax.jit(lambda *a: jax.vjp(fn, *a[:3])[1](a[3]))(
        *map(_jax, (q, k, v, do)))


# (B, Sq, Sk, Hkv, G, hd, causal, window, q_offset, dtype, every row has a
# key: the jnp VJP has no explicit mask, so it is the oracle only then)
CASES = [
    (1, 128, 128, 2, 1, 64, True, None, 0, "float32", True),
    (1, 128, 128, 1, 2, 64, False, None, 0, "float32", True),
    (2, 256, 256, 1, 4, 32, True, None, 0, "float32", True),
    (1, 128, 128, 2, 2, 64, True, 48, 0, "float32", True),
    (1, 128, 256, 1, 2, 64, True, None, 128, "float32", True),
    # q positions 200..327 past Sk + window: fully masked rows too
    (1, 128, 256, 2, 1, 64, True, 64, 200, "bfloat16", False),
    (1, 256, 256, 1, 4, 64, True, None, 0, "bfloat16", True),
    (1, 128, 128, 2, 2, 128, False, None, 0, "bfloat16", True),
    # head dims between the kernels' tile widths (test_torch_flash.py)
    (1, 128, 128, 2, 1, 48, True, None, 0, "bfloat16", True),
    (1, 128, 128, 1, 4, 72, True, None, 0, "bfloat16", True),
    (1, 128, 128, 2, 1, 80, False, None, 0, "float32", True),
    (1, 128, 256, 2, 2, 96, True, 48, 128, "bfloat16", True),
    (1, 128, 128, 2, 1, 100, True, None, 0, "float32", True),
    (1, 128, 128, 1, 2, 100, False, None, 0, "bfloat16", True),
    (1, 128, 128, 1, 2, 33, True, None, 0, "bfloat16", True),
    (1, 128, 128, 2, 1, 200, True, 40, 0, "bfloat16", True),
]


@pytest.mark.parametrize(
    "B,Sq,Sk,Hkv,G,hd,causal,window,q_offset,dtype,all_rows_keyed", CASES)
def test_flash_bwd_matches_pallas_and_jnp_vjp(B, Sq, Sk, Hkv, G, hd, causal,
                                              window, q_offset, dtype,
                                              all_rows_keyed):
    q, k, v, do = _inputs(B, Sq, Sk, Hkv * G, Hkv, hd, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want = jax.jit(functools.partial(jax_bwd, block_q=64, block_k=64,
                                     interpret=True, **kw))(
        *map(_jax, (q, k, v, o, lse, do)))

    launches = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, dtype)

    # the autograd Function gives the same gradients
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, **kw)
    _close(out, o, dtype)
    for g, w in zip(torch.autograd.grad(out, leaves, do), got):
        assert torch.equal(g, w)
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == launches

    if all_rows_keyed:
        attn = functools.partial(jax_chunked, chunk_q=64, chunk_k=64,
                                 impl="jnp", **kw)
        for g, w in zip(got, _vjp(attn, q, k, v, do)):
            _close(g, w, dtype)


@pytest.mark.parametrize(
    "B,Sq,Sk,Hkv,G,hd,causal,window,q_offset",
    [c[:9] for c in CASES if c[9] == "bfloat16"])
def test_flash_bwd_bf16_mirror_matches_pallas(B, Sq, Sk, Hkv, G, hd, causal,
                                              window, q_offset):
    """The plain version of the bf16 tensor-core kernels against the Pallas
    backward (f32 math) on the same bf16 inputs."""
    q, k, v, do = _inputs(B, Sq, Sk, Hkv * G, Hkv, hd, "bfloat16")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want = jax.jit(functools.partial(jax_bwd, block_q=64, block_k=64,
                                     interpret=True, **kw))(
        *map(_jax, (q, k, v, o, lse, do)))
    delta = fa._delta(o, do, lse)
    dq = fa.flash_bwd_dq_bf16_ref(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv_bf16_ref(q, k, v, do, lse, delta, **kw)
    for g, w, t in zip((dq, dk, dv), want, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == t.shape
        _close(g, w, "bfloat16")


@pytest.mark.parametrize("causal,window,dtype", [
    (True, None, "float32"), (True, 40, "bfloat16"), (False, None, "float32")])
def test_flash_bwd_ragged_matches_naive_grad(causal, window, dtype):
    """Lengths that are no multiple of any block (what the kernels take on
    the card): the plain backward against ``jax.vjp`` of the reference's
    naive attention, and the port's chunked dispatch (naive + autograd on
    the CPU) against it too."""
    B, S, H, Hkv, hd = 2, 100, 4, 2, 32
    q, k, v, do = _inputs(B, S, S, H, Hkv, hd, dtype, seed=1)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    pos = jnp.arange(S)
    want = _vjp(functools.partial(jax_naive, q_pos=pos, k_pos=pos, **kw),
                q, k, v, do)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    chunked = torch.autograd.grad(L.chunked_attention(*leaves, **kw),
                                  leaves, do)
    for g, c, w in zip(got, chunked, want):
        _close(g, w, dtype)
        _close(c, w, dtype)


def test_flash_bwd_delta_reads_the_stored_o():
    """delta = rowsum(do * o) from o as stored (bf16 here), cast to f32:
    the reference's einsum at flash_attention.py:291."""
    q, k, v, do = _inputs(1, 64, 64, 4, 2, 16, "bfloat16", seed=2)
    o, lse = fa.flash_attention_fwd(q, k, v)
    want = jnp.einsum("bqhd,bqhd->bhq", _jax(do).astype(jnp.float32),
                      _jax(o).astype(jnp.float32))
    got = fa._delta(o, do, lse)                     # (B,Hkv,G,Sq)
    np.testing.assert_allclose(as_f32(got).reshape(1, 4, 64), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def _bad_bwd(kind):
    q, k, v, do = _inputs(1, 8, 8, 4, 2, 16, "float32")
    o, lse = fa.flash_attention_fwd(q, k, v)
    if kind == "do_shape":
        do = do[:, :4].contiguous()
    elif kind == "do_dtype":
        do = do.bfloat16()
    elif kind == "o_layout":
        o = o.transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "lse_dtype":
        lse = lse.double()
    elif kind == "lse_shape":
        lse = lse[..., :4].contiguous()
    return q, k, v, o, lse, do


@pytest.mark.parametrize("kind", ["do_shape", "do_dtype", "o_layout",
                                  "lse_dtype", "lse_shape"])
def test_flash_bwd_wrapper_rejects_bad_inputs(kind):
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(*_bad_bwd(kind))


def test_bridge_roundtrip_is_bit_exact():
    """The numpy bridge the tests feed both packages through."""
    a = jnp.asarray(np.random.default_rng(3).standard_normal((5, 7)),
                    jnp.bfloat16)
    t = numpy_to_torch(jax_to_numpy(a))
    assert t.dtype == torch.bfloat16
    assert bool(jnp.all(_jax(t) == a))
