"""The port's chunked WKV recurrence against the reference: the plain
version against ``layers._wkv_chunk_scan`` (o and the final state) and
against the Pallas ``wkv_chunked`` in interpret mode (o), and the wrapper's
checks.

Inputs are made with numpy from a seed.  Tolerance: 1e-4 times
max(1, max|ref|), the reference's own kernel test's atol
(``tests/test_kernels.py:104``) at unit scale, as ``chip_smoke.py`` holds
the kernel.  The two sum in different orders and XLA's cumsum, log and exp
round differently from torch's by an ulp; that moves o by about 1e-6 of
its scale, and at hd 64 o reaches 120 (1.1e-4 apart measured here, where
the unscaled 1e-4 would fail on rounding alone).  Decays come from the
reference test's range (0.39, 0.99), from the clip w = exp(-e^0.5) =
0.1923 throughout, and from the model's own formula on normal inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import wkv_chunked as jax_wkv_chunked
from repro.models.layers import _wkv_chunk_scan
from repro_torch.kernels.wkv import (CHUNK, KERNEL_MAX_HEAD_DIM,
                                     wkv_chunk_scan_ref, wkv_chunked)

ATOL = 1e-4
W_CLIP = np.exp(-np.exp(np.float32(0.5)), dtype=np.float32)


def close(got, want):
    want = np.asarray(want)
    tol = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0)


def wkv_inputs(B, S, H, hd, decay, seed=0):
    """r, k, v, w (B,S,H,hd) and u (H,hd), f32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v, n = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
                  for _ in range(4))
    if decay == "test":                  # tests/test_kernels.py's range
        w = 1 / (1 + np.exp(-n)) * 0.6 + 0.39
    elif decay == "clip":
        w = np.full_like(n, W_CLIP)
    else:                                # rwkv6_fwd's formula
        w = np.exp(-np.exp(np.clip(n, -8, 0.5)))
    u = 0.5 * rng.standard_normal((H, hd)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u


CASES = [(2, 64, 2, 16, "test"), (1, 128, 4, 32, "test"),
         (1, 64, 1, 64, "test"), (2, 64, 2, 16, "clip"),
         (1, 128, 4, 64, "clip"), (2, 96, 4, 64, "model")]


@pytest.mark.parametrize("B,S,H,hd,decay", CASES)
def test_ref_matches_reference_oracle(B, S, H, hd, decay):
    ins = wkv_inputs(B, S, H, hd, decay)
    o, s_fin = wkv_chunk_scan_ref(*map(torch.from_numpy, ins), CHUNK)
    jo, js = _wkv_chunk_scan(*map(jnp.asarray, ins), CHUNK)
    assert o.shape == (B, S, H, hd) and s_fin.shape == (B, H, hd, hd)
    assert o.dtype == s_fin.dtype == torch.float32
    close(o.numpy(), jo)
    close(s_fin.numpy(), js)


@pytest.mark.parametrize("B,S,H,hd,decay", CASES)
def test_ref_matches_pallas_kernel(B, S, H, hd, decay):
    ins = wkv_inputs(B, S, H, hd, decay, seed=1)
    o = wkv_chunked(*map(torch.from_numpy, ins))
    jo = jax_wkv_chunked(*map(jnp.asarray, ins), chunk=CHUNK, interpret=True)
    close(o.numpy(), jo)


@pytest.mark.parametrize("B,S,H,hd,decay", CASES)
def test_ref_on_a_column_slice_of_v_gives_that_slice(B, S, H, hd, decay):
    """What the kernel's split of a head over blocks rests on: run on a
    slice of v's columns (all of r, k, w, u), the plain version gives that
    slice of the full run's o and final state.  Tolerance 1e-6 times
    max(1, max|ref|): einsum may block a narrower operand differently."""
    r, k, v, w, u = map(torch.from_numpy, wkv_inputs(B, S, H, hd, decay,
                                                      seed=2))
    o, s_fin = wkv_chunk_scan_ref(r, k, v, w, u, CHUNK)
    cut = (hd + 2) // 3                   # three tiles, the last one short
    for a in range(0, hd, cut):
        b = min(hd, a + cut)
        o_s, s_s = wkv_chunk_scan_ref(r, k, v[..., a:b].contiguous(), w, u,
                                      CHUNK)
        assert o_s.shape == (B, S, H, b - a)
        assert s_s.shape == (B, H, hd, b - a)
        for got, want in ((o_s, o[..., a:b]), (s_s, s_fin[..., a:b])):
            tol = 1e-6 * max(1.0, want.abs().max().item())
            torch.testing.assert_close(got, want, atol=tol, rtol=0)


def test_cpu_wrapper_is_the_plain_version():
    ins = [torch.from_numpy(a) for a in wkv_inputs(2, 48, 3, 16, "model")]
    before = wkv_chunked.launches
    o, s_fin = wkv_chunked(*ins, return_state=True)
    want_o, want_s = wkv_chunk_scan_ref(*ins, CHUNK)
    assert torch.equal(o, want_o) and torch.equal(s_fin, want_s)
    assert torch.equal(wkv_chunked(*ins), want_o)
    assert torch.equal(wkv_chunked(*ins, n_split=3), want_o)
    assert wkv_chunked.launches == before       # no kernel on the CPU


def test_padding_leaves_the_state_exact():
    """rwkv6_fwd's pad (zero r, k, v; w = 1) changes nothing: a 300-token
    sequence padded to 304 and to 320 gives the same final state and the
    same first 300 outputs, bit for bit."""
    r, k, v, w, u = (torch.from_numpy(a)
                     for a in wkv_inputs(1, 300, 4, 16, "clip"))
    outs = []
    for S in (304, 320):
        pad = (0, 0, 0, 0, 0, S - 300)
        outs.append(wkv_chunked(
            *(torch.nn.functional.pad(t, pad) for t in (r, k, v)),
            torch.nn.functional.pad(w, pad, value=1.0), u,
            return_state=True))
    (o1, s1), (o2, s2) = outs
    assert torch.equal(s1, s2)
    assert torch.equal(o1[:, :300], o2[:, :300])


def test_wrapper_refuses_what_the_kernel_cannot_take():
    r, k, v, w, u = (torch.from_numpy(a)
                     for a in wkv_inputs(1, 64, 2, 16, "test"))
    with pytest.raises(ValueError, match="S % chunk"):
        wkv_chunked(r[:, :40], k[:, :40], v[:, :40], w[:, :40], u)
    with pytest.raises(ValueError, match="chunk"):
        wkv_chunked(r, k, v, w, u, chunk=8)
    hd = KERNEL_MAX_HEAD_DIM + 1
    big = [torch.zeros(1, 16, 1, hd) for _ in range(4)]
    with pytest.raises(ValueError, match="head_dim"):
        wkv_chunked(*big, torch.zeros(1, hd))
    with pytest.raises(ValueError, match="f32"):
        wkv_chunked(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv_chunked(r, k, v, w, u[:1])
    for n in (-1, 17):                    # hd 16
        with pytest.raises(ValueError, match="n_split"):
            wkv_chunked(r, k, v, w, u, n_split=n)
