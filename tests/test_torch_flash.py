"""The port's flash-attention forward on the CPU against the JAX package.

On CPU tensors the wrapper runs the kernel's plain version; it is held
against the Pallas kernel in interpret mode (what ``tests/test_kernels.py``
runs) on o AND lse, and against ``naive_attention`` at ragged lengths.
The plain version that mirrors the card's bf16 kernel (p rounded to bf16
where it feeds p v) is held against the Pallas kernel too.  Inputs come
from numpy with a seed.  Tolerances are the JAX kernel tests' own: 3e-5
absolute in f32, 2e-2 in bf16 (one bf16 ulp of an output near 2 is
1.6e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_f32
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.models.layers import naive_attention as jax_naive
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import layers as L

TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _inputs(B, Sq, Sk, H, Hkv, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, pt


CASES = [   # B, Sq, Sk, Hkv, G, hd, causal, window, q_offset, block, dtype
    (1, 128, 128, 2, 1, 64, True, None, 0, 64, "float32"),
    (1, 128, 128, 1, 2, 64, False, None, 0, 64, "float32"),
    (2, 128, 128, 1, 4, 128, True, None, 0, 64, "float32"),
    (1, 128, 128, 2, 2, 128, False, None, 0, 128, "bfloat16"),
    (1, 256, 256, 1, 4, 64, True, None, 0, 128, "bfloat16"),
    (1, 128, 128, 2, 2, 64, True, 48, 0, 64, "float32"),
    (1, 128, 256, 1, 2, 64, True, None, 128, 64, "float32"),
    # q positions 200..327 past Sk + window: fully masked rows too
    (1, 128, 256, 2, 1, 128, True, 64, 200, 64, "bfloat16"),
    # head dims between the kernels' tile widths: run at the least width
    # that holds them, rows 16-byte (72), 8-byte (100) or 2-byte (33)
    # aligned; 200 at the widths above 128 (32-key tiles)
    (1, 128, 128, 2, 1, 48, True, None, 0, 64, "bfloat16"),
    (1, 128, 128, 1, 4, 72, True, None, 0, 64, "bfloat16"),
    (1, 128, 128, 2, 1, 80, False, None, 0, 64, "float32"),
    (1, 128, 256, 2, 2, 96, True, 48, 128, 64, "bfloat16"),
    (1, 128, 128, 2, 1, 100, True, None, 0, 64, "float32"),
    (1, 128, 128, 1, 2, 100, False, None, 0, 64, "bfloat16"),
    (1, 128, 128, 1, 2, 33, True, None, 0, 64, "bfloat16"),
    (1, 128, 128, 2, 1, 200, True, 40, 0, 64, "bfloat16"),
]


@pytest.mark.parametrize(
    "B,Sq,Sk,Hkv,G,hd,causal,window,q_offset,block,dtype", CASES)
def test_flash_fwd_matches_pallas_kernel(B, Sq, Sk, Hkv, G, hd, causal,
                                         window, q_offset, block, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sk, Hkv * G, Hkv, hd, dtype)
    o_ref, lse_ref = jax_fwd(jq, jk, jv, causal=causal, window=window,
                             q_offset=q_offset, block_q=block,
                             block_k=block, interpret=True)
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    assert fa.flash_attention_fwd.launches == before   # CPU: no kernel
    assert o.dtype == q.dtype and tuple(o.shape) == tuple(o_ref.shape)
    assert lse.dtype == torch.float32
    assert tuple(lse.shape) == tuple(lse_ref.shape) == (B, Hkv, G, Sq)
    tol = TOL[dtype]
    np.testing.assert_allclose(as_f32(o), as_f32(o_ref), atol=tol, rtol=0)
    np.testing.assert_allclose(as_f32(lse), as_f32(lse_ref), atol=tol,
                               rtol=0)


@pytest.mark.parametrize(
    "B,Sq,Sk,Hkv,G,hd,causal,window,q_offset,block",
    [c[:10] for c in CASES if c[10] == "bfloat16"])
def test_flash_fwd_bf16_mirror_matches_pallas(B, Sq, Sk, Hkv, G, hd, causal,
                                              window, q_offset, block):
    """The plain version of the bf16 tensor-core kernel (its 64-key tiles,
    p rounded to bf16 where it feeds p v) against the Pallas forward (f32
    p) on the same bf16 inputs: o and lse."""
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sk, Hkv * G, Hkv, hd,
                                      "bfloat16")
    o_ref, lse_ref = jax_fwd(jq, jk, jv, causal=causal, window=window,
                             q_offset=q_offset, block_q=block,
                             block_k=block, interpret=True)
    o, lse = fa.flash_attention_fwd_bf16_ref(q, k, v, causal=causal,
                                             window=window,
                                             q_offset=q_offset)
    assert o.dtype == lse.dtype == torch.float32
    assert tuple(o.shape) == tuple(o_ref.shape)
    assert tuple(lse.shape) == tuple(lse_ref.shape)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(as_f32(o), as_f32(o_ref), atol=tol, rtol=0)
    np.testing.assert_allclose(as_f32(lse), as_f32(lse_ref), atol=tol,
                               rtol=0)


@pytest.mark.parametrize(
    "B,Sq,Sk,H,Hkv,hd,causal,window,q_offset", [
        (1, 128, 128, 4, 2, 64, True, None, 0),
        (2, 100, 100, 4, 4, 32, False, None, 0),
        (1, 96, 96, 10, 1, 256, True, 40, 0),      # G = 10, 32-key tiles
        (1, 96, 96, 4, 2, 200, True, 40, 0),       # width 224: 32-key tiles
        (1, 100, 100, 4, 4, 72, True, None, 0),    # width 80: 64-key tiles
        (1, 128, 256, 4, 2, 16, True, 64, 300),    # fully masked rows
    ])
def test_flash_fwd_bf16_mirror_is_plain_for_f32(B, Sq, Sk, H, Hkv, hd,
                                                causal, window, q_offset):
    """f32 inputs are not rounded: the mirror is then the f32 plain version
    at the kernel's KV tiles, bit for bit; and at its own 512-key blocks
    the plain version agrees within f32 noise."""
    _, (q, k, v) = _inputs(B, Sq, Sk, H, Hkv, hd, "float32", seed=3)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o_m, lse_m = fa.flash_attention_fwd_bf16_ref(q, k, v, **kw)
    o, lse = fa.flash_attention_fwd_ref(q, k, v, **kw,
                                        block_k=fa.kernel_block_k(hd))
    assert torch.equal(o_m, o) and torch.equal(lse_m, lse)
    o, lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(o_m, o, atol=TOL["float32"], rtol=0)
    torch.testing.assert_close(lse_m, lse, atol=TOL["float32"], rtol=1e-6)


@pytest.mark.parametrize("hd,width,block_k", [
    (1, 16, 64), (16, 16, 64), (17, 32, 64), (33, 48, 64), (48, 48, 64),
    (72, 80, 64), (96, 96, 64), (100, 112, 64), (128, 128, 64),
    (129, 160, 32), (200, 224, 32), (256, 256, 32)])
def test_kernel_width_and_tiles(hd, width, block_k):
    """The tile width a head dim runs at (``head_width`` in
    csrc/flash_mma.cuh: the least multiple of 16 up to 128, of 32 above)
    and the bf16 forward's KV tile there, which the mirror takes."""
    assert fa.kernel_width(hd) == width
    assert width in fa.KERNEL_HEAD_WIDTHS
    assert fa.kernel_block_k(hd) == block_k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_flash_ragged_matches_naive(dtype, causal, window):
    """Lengths that are no multiple of any block: the plain version (what
    the kernel computes on the card) and the port's naive oracle against
    the reference's naive attention."""
    B, Sq, H, Hkv, hd = 2, 100, 4, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sq, H, Hkv, hd, dtype, seed=1)
    pos = jnp.arange(Sq)
    want = as_f32(jax_naive(jq, jk, jv, causal=causal, window=window,
                            q_pos=pos, k_pos=pos))
    o, _ = fa.flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                      block_k=64)
    tpos = torch.arange(Sq)
    naive = L.naive_attention(q, k, v, causal=causal, window=window,
                              q_pos=tpos, k_pos=tpos)
    chunked = L.chunked_attention(q, k, v, causal=causal, window=window)
    for got in (o, naive, chunked):
        np.testing.assert_allclose(as_f32(got), want, atol=TOL[dtype],
                                   rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_mha_reference_matches_jax(dtype, causal, window):
    """The port's naive oracle against the reference's, and the flash
    forward against it."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 72, 72, 6, 2, 32, dtype, seed=2)
    want = as_f32(jax_ref.mha_reference(jq, jk, jv, causal=causal,
                                        window=window))
    got = ref.mha_reference(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(as_f32(got), want, atol=TOL[dtype], rtol=0)
    o, _ = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(as_f32(o), as_f32(got), atol=TOL[dtype],
                               rtol=0)


def _bad(kind):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    # on meta, which takes the card's checks: no head dim 0 or past 256,
    # no more than 64 query heads a KV head
    if kind.startswith("meta_"):
        hd, H = {"meta_hd0": (0, 4), "meta_hd257": (257, 4),
                 "meta_groups65": (64, 130)}[kind]
        return (torch.zeros(1, 8, H, hd, device="meta"),
                torch.zeros(1, 8, 2, hd, device="meta"),
                torch.zeros(1, 8, 2, hd, device="meta"), None)
    if kind == "rank":
        return q[0], k, k, None
    if kind == "head_dim":
        return q, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8), None
    if kind == "groups":
        return q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16), None
    if kind == "dtype":
        return q.half(), k.half(), k.half(), None
    if kind == "mixed":
        return q, k.bfloat16(), k, None
    if kind == "layout":
        return q.transpose(1, 2).contiguous().transpose(1, 2), k, k, None
    if kind == "window":
        return q, k, k, 0
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["rank", "head_dim", "groups", "dtype",
                                  "mixed", "layout", "window", "meta_hd0",
                                  "meta_hd257", "meta_groups65"])
def test_flash_wrapper_rejects_bad_inputs(kind):
    q, k, v, window = _bad(kind)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v, window=window)


@pytest.mark.parametrize("hd", [1, 33, 48, 100, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wrapper_takes_head_dims_to_256_on_the_card_path(hd, dtype):
    """On meta (the card's checks, no data) every head dim 1..256 and G 64
    is taken, forward and backward, with outputs of the kernels' shapes."""
    q = torch.zeros(1, 8, 64, hd, device="meta", dtype=dtype)
    k = torch.zeros(1, 8, 1, hd, device="meta", dtype=dtype)
    o, lse = fa.flash_attention_fwd(q, k, k)
    assert o.shape == q.shape and lse.shape == (1, 1, 64, 8)
    dq, dk, dv = fa.flash_attention_bwd(q, k, k, o, lse, q)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
