"""The port's chunked WKV recurrence against the reference: the plain
version against ``layers._wkv_chunk_scan`` (o and the final state) and
against the Pallas ``wkv_chunked`` in interpret mode (o), at chunk 16 and
at the head dims (80-256) and chunk lengths (1-64) the reference takes
beside it, ``wkv``'s gradient at chunk 8 against ``jax.vjp`` of the
reference's scan, and the wrapper's checks (the card's limits are one
predicate, ``kernel_takes``, that only a CUDA call is held to).

Inputs are made with numpy from a seed.  Tolerance: 1e-4 times
max(1, max|ref|), the reference's own kernel test's atol
(``tests/test_kernels.py:104``) at unit scale, as ``chip_smoke.py`` holds
the kernel.  The two sum in different orders and XLA's cumsum, log and exp
round differently from torch's by an ulp; that moves o by about 1e-6 of
its scale, and at hd 64 o reaches 120 (1.1e-4 apart measured here, where
the unscaled 1e-4 would fail on rounding alone).  Decays come from the
reference test's range (0.39, 0.99), from the clip w = exp(-e^0.5) =
0.1923 throughout, and from the model's own formula on normal inputs; the
clip only at chunks up to 16, where the reference's note (its
``rwkv6_fwd``) says the factored form stays in f32 range.  The gradient
is held as ``test_torch_train_rwkv.py`` holds it at chunk 16: 1e-5 of
max|g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import wkv_chunked as jax_wkv_chunked
from repro.models.layers import _wkv_chunk_scan
from repro_torch.kernels.wkv import (CHUNK, KERNEL_MAX_CHUNK,
                                     KERNEL_MAX_HEAD_DIM, KERNEL_MAX_TILE,
                                     kernel_takes, kernel_width, wkv,
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
# (B, S, H, hd, chunk, decay): the head dims above 64 at chunk 16, and the
# chunk lengths other than 16 at hd 64 (the clip only up to 16)
WIDE_CASES = [(1, 32, 2, 80, 16, "model"), (1, 48, 1, 96, 16, "test"),
              (1, 32, 2, 128, 16, "clip"), (1, 32, 1, 256, 16, "model"),
              (1, 32, 2, 64, 1, "clip"), (2, 32, 1, 64, 4, "test"),
              (1, 64, 2, 64, 8, "clip"), (1, 48, 2, 64, 12, "model"),
              (1, 96, 1, 64, 32, "test"), (1, 128, 1, 64, 32, "model"),
              (1, 128, 1, 64, 64, "model"), (1, 128, 1, 64, 64, "test")]
VJP_TOL = 1e-5       # x max|g|, as test_torch_train_rwkv.py


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


@pytest.mark.parametrize("B,S,H,hd,chunk,decay", WIDE_CASES)
def test_wide_ref_matches_reference_oracle(B, S, H, hd, chunk, decay):
    """Head dims above 64 and chunk lengths other than 16, where the port
    raised before: the plain version (what the wrapper runs on the CPU)
    against the reference's oracle, o and the final state."""
    ins = wkv_inputs(B, S, H, hd, decay, seed=3)
    o, s_fin = wkv_chunked(*map(torch.from_numpy, ins), chunk=chunk,
                           return_state=True)
    jo, js = _wkv_chunk_scan(*map(jnp.asarray, ins), chunk)
    assert o.shape == (B, S, H, hd) and s_fin.shape == (B, H, hd, hd)
    close(o.numpy(), jo)
    close(s_fin.numpy(), js)


@pytest.mark.parametrize("B,S,H,hd,chunk,decay", WIDE_CASES)
def test_wide_ref_matches_pallas_kernel(B, S, H, hd, chunk, decay):
    ins = wkv_inputs(B, S, H, hd, decay, seed=4)
    o = wkv_chunked(*map(torch.from_numpy, ins), chunk=chunk)
    jo = jax_wkv_chunked(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
    close(o.numpy(), jo)


@pytest.mark.parametrize("decay", ["test", "clip"])
def test_function_at_chunk_8_matches_reference_vjp(decay):
    """``wkv`` at chunk 8 (the forward and the backward's recomputed scan
    both in chunks of 8): o, the final state and the five gradients
    against ``jax.vjp`` of the reference's scan at chunk 8."""
    B, S, H, hd = 1, 40, 2, 16
    ins = wkv_inputs(B, S, H, hd, decay, seed=5)
    rng = np.random.default_rng(6)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, H, hd, hd))]
    (jo, js), vjp = jax.vjp(lambda *t: _wkv_chunk_scan(*t, 8),
                            *map(jnp.asarray, ins))
    want = vjp(tuple(map(jnp.asarray, cots)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    o, st = wkv(*leaves, chunk=8, return_state=True)
    close(o.detach().numpy(), jo)
    close(st.detach().numpy(), js)
    got = torch.autograd.grad([o, st], leaves,
                              list(map(torch.from_numpy, cots)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= VJP_TOL * np.abs(w).max()


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
    """The wrapper raises on what the reference raises on (S % chunk) and
    on what no device takes (dtypes, shapes, n_split).  The card's limits
    are one predicate, ``kernel_takes``, held at its edges: chunk x head
    width up to 4096, hd up to 256, chunk up to 64.  Only a CUDA call is
    held to it: the same inputs run on the CPU (chunk 8 and hd 65 among
    them) and on ``meta``, as the reference runs them."""
    r, k, v, w, u = (torch.from_numpy(a)
                     for a in wkv_inputs(1, 64, 2, 16, "test"))
    with pytest.raises(ValueError, match="S % chunk"):
        wkv_chunked(r[:, :40], k[:, :40], v[:, :40], w[:, :40], u)
    with pytest.raises(ValueError, match="chunk >= 1"):
        wkv_chunked(r, k, v, w, u, chunk=0)
    assert (KERNEL_MAX_HEAD_DIM, KERNEL_MAX_CHUNK, KERNEL_MAX_TILE) == \
        (256, 64, 4096)
    assert [kernel_width(hd) for hd in (1, 64, 65, 128, 129, 256)] == \
        [64, 64, 128, 128, 256, 256]
    for hd, chunk in ((256, 16), (129, 16), (128, 32), (65, 32), (64, 64),
                      (1, 64), (1, 1), (256, 1), (65, 8), (100, 20)):
        assert kernel_takes(hd, chunk), (hd, chunk)
        assert chunk * kernel_width(hd) <= KERNEL_MAX_TILE
    for hd, chunk in ((256, 17), (129, 17), (128, 33), (65, 33), (64, 65),
                      (1, 65), (257, 1), (257, 16), (0, 16), (64, 0)):
        assert not kernel_takes(hd, chunk), (hd, chunk)
    for hd, chunk in ((65, 8), (16, 8), (257, 16), (256, 17), (128, 33),
                      (64, 65)):
        ins = wkv_inputs(1, 2 * chunk, 1, hd, "test", seed=hd)
        cpu = [torch.from_numpy(a) for a in ins]
        o, s_fin = wkv_chunked(*cpu, chunk=chunk, return_state=True)
        want_o, want_s = wkv_chunk_scan_ref(*cpu, chunk)
        assert torch.equal(o, want_o) and torch.equal(s_fin, want_s)
        meta = [t.to("meta") for t in cpu]
        o, s_fin = wkv_chunked(*meta, chunk=chunk, return_state=True)
        assert o.is_meta and o.shape == (1, 2 * chunk, 1, hd)
        assert s_fin.shape == (1, 1, hd, hd)
    with pytest.raises(ValueError, match="f32"):
        wkv_chunked(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv_chunked(r, k, v, w, u[:1])
    for n in (-1, 17):                    # hd 16
        with pytest.raises(ValueError, match="n_split"):
            wkv_chunked(r, k, v, w, u, n_split=n)
