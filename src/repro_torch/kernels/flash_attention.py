"""Flash attention: the Hopper kernels, their plain versions, and the
differentiable entry point.

Counterpart of ``repro/kernels/flash_attention.py``.  Three kernels replace
the three Pallas kernels there: ``csrc/flash_fwd.cu`` the forward
``_flash_kernel``, and ``csrc/flash_bwd.cu`` the backward
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``; see the notes at
the top of those files for their design and what bounds them.  Each has
two designs chosen by the dtype: bf16 inputs run on the tensor cores
(``mma.sync`` with bf16 operands, f32 sums), f32 inputs on f32 FMA.

``flash_attention_fwd`` and ``flash_attention_bwd`` are the wrappers every
caller goes through.  They take the plain version only for tensors on the
CPU; for a CUDA tensor they launch the kernels or raise, and count each
launch (``flash_attention_fwd.launches``, ``flash_bwd_dq.launches``,
``flash_bwd_dkv.launches``); for a ``meta`` tensor (the dry run) they
return empty outputs of the kernels' shapes.  While a
``kernels.work.WorkCounter`` is active they add each kernel's work
(:func:`fwd_work`, :func:`bwd_dq_work`, :func:`bwd_dkv_work`) on every
device.  ``FlashAttention`` wires them into a
``torch.autograd.Function``, the analogue of the reference's custom VJP.

The plain versions compute in f32, as the Pallas kernels do.  The bf16
kernels round P (forward, dk/dv) and dS (backward) to bf16 where they feed
a product; ``flash_attention_fwd_bf16_ref``, ``flash_bwd_dq_bf16_ref`` and
``flash_bwd_dkv_bf16_ref`` mirror that rounding, so the card's bf16
kernels can be held to them more tightly than to the f32 versions.  The
mirrors are for tests and ``chip_smoke.py``: on the CPU the wrappers
return the f32 plain versions for every dtype.

Layouts are the JAX package's: q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd), query
head ``h`` reads KV head ``h // G`` (G = H // Hkv); outputs o (B,Sq,H,hd)
in q's dtype and lse (B,Hkv,G,Sq) in f32.  Masked scores are the finite
``NEG_INF``, as in the Pallas kernel, which visits every KV block: a row
with no unmasked key averages V over all keys.  The backward masks
explicitly, so such a row gets zero gradient, as in the Pallas backward.
On the card, bf16 q, k, v (and the backward's do) must be 16-byte
aligned: the bf16 kernels stage rows with 16-byte copies.

The card takes every head dim from 1 to 256, as the Pallas kernels take
any: the kernels are instantiated at the tile widths
``KERNEL_HEAD_WIDTHS`` and a call runs the least that holds its head dim
(:func:`kernel_width`), the extra columns zeros in shared memory only.
A head dim equal to its width runs an instance written for it; one below
it runs an instance that reads hd at run time, and stages rows an element
at a time where hd % 8 != 0 (csrc/flash_mma.cuh).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import backend, work
from .backend import on_card

__all__ = ["NEG_INF", "pairs", "fwd_work", "bwd_dq_work", "bwd_dkv_work",
           "DEFAULT_BLOCK_K", "KERNEL_HEAD_WIDTHS", "KERNEL_MAX_HEAD_DIM",
           "KERNEL_MAX_GROUP", "flash_attention_fwd",
           "flash_attention_fwd_ref", "flash_attention_fwd_bf16_ref",
           "kernel_width", "kernel_block_k", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_dq_ref", "flash_bwd_dkv_ref", "flash_bwd_dq_bf16_ref",
           "flash_bwd_dkv_bf16_ref", "FlashAttention",
           "flash_attention"]

NEG_INF = -1e30
DEFAULT_BLOCK_K = 512
# the tile widths the kernels are instantiated at (FLASH_HEAD_WIDTHS in
# csrc/flash_mma.cuh): every multiple of 16 up to 128, of 32 above it.
# Above 128 the bf16 forward takes 32-key tiles, the bf16 backward splits
# the output columns over two blocks and the f32 one halves its key tile.
KERNEL_HEAD_WIDTHS = (16, 32, 48, 64, 80, 96, 112, 128, 160, 192, 224, 256)
KERNEL_MAX_HEAD_DIM = KERNEL_HEAD_WIDTHS[-1]
KERNEL_MAX_GROUP = 64          # G query heads must fit the 64-row tile
DTYPES = (torch.float32, torch.bfloat16)


def _ramp(n: int, Sk: int) -> int:
    """sum over t in [0, n) of clamp(t, 0, Sk)."""
    if n <= 0:
        return 0
    if n <= Sk + 1:
        return n * (n - 1) // 2
    return Sk * (Sk + 1) // 2 + (n - Sk - 1) * Sk


def pairs(Sq: int, Sk: int, causal: bool = True, window: int | None = None,
          q_offset: int = 0) -> int:
    """The unmasked (query, key) pairs of one head, in closed form: query
    i sits at p = q_offset + i and sees the keys j in [0, Sk) with j <= p
    (causal) and p - j < window; their count is clamp(p + 1, 0, Sk) -
    clamp(p - window + 1, 0, Sk), summed over p as two ramps."""
    lo, hi = q_offset, q_offset + Sq
    ramp = lambda c: _ramp(max(hi + c, 0), Sk) - _ramp(max(lo + c, 0), Sk)
    upper = ramp(1) if causal else Sq * Sk
    lower = ramp(1 - window) if window is not None else 0
    return upper - lower


def fwd_work(B: int, Sq: int, Sk: int, H: int, Hkv: int, hd: int, *,
             causal: bool = True, window: int | None = None,
             q_offset: int = 0, esz: int = 2) -> tuple[float, float]:
    """(flops, hbm_bytes) of the forward kernel: two products (q k^T and
    p v) over the unmasked pairs; q, k, v read and o written once in
    ``esz``-byte elements, lse (f32) written once."""
    n = B * H * pairs(Sq, Sk, causal, window, q_offset)
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd) * esz \
        + B * H * Sq * 4
    return 4.0 * hd * n, float(nbytes)


def _bwd_in_bytes(B, Sq, Sk, H, Hkv, hd, esz):
    # q, do, k, v, and lse and delta (f32)
    return (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd) * esz \
        + 2 * B * H * Sq * 4


def bwd_dq_work(B: int, Sq: int, Sk: int, H: int, Hkv: int, hd: int, *,
                causal: bool = True, window: int | None = None,
                q_offset: int = 0, esz: int = 2) -> tuple[float, float]:
    """(flops, hbm_bytes) of the dq kernel: three products (q k^T, do v^T,
    ds k) over the unmasked pairs; its inputs read and dq written once."""
    n = B * H * pairs(Sq, Sk, causal, window, q_offset)
    return 6.0 * hd * n, float(_bwd_in_bytes(B, Sq, Sk, H, Hkv, hd, esz)
                                + B * Sq * H * hd * esz)


def bwd_dkv_work(B: int, Sq: int, Sk: int, H: int, Hkv: int, hd: int, *,
                 causal: bool = True, window: int | None = None,
                 q_offset: int = 0, esz: int = 2) -> tuple[float, float]:
    """(flops, hbm_bytes) of the dk/dv kernel: four products (q k^T,
    do v^T, p^T do, ds^T q) over the unmasked pairs; its inputs read and
    dk, dv written once."""
    n = B * H * pairs(Sq, Sk, causal, window, q_offset)
    return 8.0 * hd * n, float(_bwd_in_bytes(B, Sq, Sk, H, Hkv, hd, esz)
                                + 2 * B * Sk * Hkv * hd * esz)


def _dims(q, k):
    B, Sq, H, hd = q.shape
    return B, Sq, k.shape[1], H, k.shape[2], hd


def _block_mask(q_pos, k_pos, causal: bool, window: int | None):
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return mask


def _f32(t):
    return t


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _fwd_sum(q, k, v, rnd, causal, window, q_offset, block_k):
    """The online-softmax forward over KV blocks of ``block_k`` (the last
    one may be short), math in f32; p is passed through ``rnd`` where it
    feeds p v, and l sums the unrounded p.  Returns (o (B,Sq,H,hd) f32,
    lse (B,Hkv,G,Sq))."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    f32 = torch.float32
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd).to(f32)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=f32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, hd), dtype=f32, device=dev)
    for k0 in range(0, Sk, block_k):
        kj = k[:, k0:k0 + block_k].to(f32)
        vj = v[:, k0:k0 + block_k].to(f32)
        k_pos = k0 + torch.arange(kj.shape[1], device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj) * scale
        s = s.masked_fill(~_block_mask(q_pos, k_pos, causal, window),
                          NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                    rnd(p), vj)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    o = acc / l[..., None]
    lse = m + torch.log(l)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd), lse


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True,
                            window: int | None = None, q_offset: int = 0,
                            block_k: int = DEFAULT_BLOCK_K):
    """Plain PyTorch online-softmax forward over KV blocks of ``block_k``
    (the last one may be short), math in f32.  Mirrors
    ``repro.models.layers._flash_fwd_impl`` without its block skipping,
    i.e. what ``_flash_kernel`` computes.  Returns (o, lse)."""
    o, lse = _fwd_sum(q, k, v, _f32, causal, window, q_offset, block_k)
    return o.to(q.dtype).contiguous(), lse


def kernel_width(hd: int) -> int:
    """The tile width the kernels run at head dim ``hd``: the least of
    ``KERNEL_HEAD_WIDTHS`` that holds it (``head_width`` in
    csrc/flash_mma.cuh)."""
    if not 1 <= hd <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take head_dim 1.."
                         f"{KERNEL_MAX_HEAD_DIM}, got {hd}")
    return next(w for w in KERNEL_HEAD_WIDTHS if w >= hd)


def kernel_block_k(hd: int) -> int:
    """Keys per KV tile of the bf16 forward kernel at head dim ``hd``: 32
    at the widths above 128, else 64."""
    return 32 if kernel_width(hd) > 128 else 64


def flash_attention_fwd_bf16_ref(q, k, v, *, causal: bool = True,
                                 window: int | None = None,
                                 q_offset: int = 0):
    """Plain PyTorch forward as the bf16 kernel computes it: its KV tiles
    (``kernel_block_k``), p rounded to bf16 where it feeds p v, the row
    sum l taken over the unrounded f32 p, sums in f32.  f32 inputs are not
    rounded, so for them this is :func:`flash_attention_fwd_ref` at those
    tiles.  Returns (o, lse) in f32: the kernel's one further rounding, of
    o to bf16 on its store, is left to the caller's tolerance."""
    rnd = _bf16 if q.dtype == torch.bfloat16 else _f32
    return _fwd_sum(q, k, v, rnd, causal, window, q_offset,
                    kernel_block_k(q.shape[3]))


def _check(q, k, v, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash attention: {name} must be a 4-D tensor")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"flash attention: q, k, v must share one dtype "
                             f"of {DTYPES}, got {q.dtype}/{k.dtype}/"
                             f"{v.dtype}")
        if t.device != q.device or \
                t.device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"flash attention: q, k, v must be on one cpu "
                             f"or cuda device (or all on meta), got "
                             f"{q.device}/{k.device}/{v.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash attention: k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if min(B, Sq, Sk, H, Hkv, hd) < 1 or H % Hkv:
        raise ValueError(f"flash attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} (H must be a multiple of Hkv)")
    if window is not None and window < 1:
        raise ValueError(f"flash attention: window must be None or >= 1, "
                         f"got {window}")
    if on_card(q) and (hd > KERNEL_MAX_HEAD_DIM
                       or H // Hkv > KERNEL_MAX_GROUP):
        raise ValueError(f"flash attention kernel takes head_dim 1.."
                         f"{KERNEL_MAX_HEAD_DIM} and at most "
                         f"{KERNEL_MAX_GROUP} query heads per KV head, got "
                         f"hd={hd} G={H // Hkv}")
    # the bf16 kernels stage rows with 16-byte copies
    if on_card(q) and q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash attention: bf16 q, k and v must be 16-byte "
                         "aligned on the card")


def _lib() -> ctypes.CDLL:
    lib = backend.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd.argtypes = [ptr] * 5 + [i] * 11 + [ptr]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [i]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0):
    """Returns (o: (B,Sq,H,hd) in q's dtype, lse: (B,Hkv,G,Sq) f32).

    Any Sq and Sk are taken: the kernel masks the ragged edge itself."""
    _check(q, k, v, window)
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    job = fwd_work(*_dims(q, k), **mask, esz=q.element_size())
    if not q.is_cuda:
        with work.quiet():
            if q.is_meta:
                o = torch.empty_like(q)
                lse = q.new_empty((B, Hkv, H // Hkv, Sq),
                                  dtype=torch.float32)
            else:
                o, lse = flash_attention_fwd_ref(q, k, v, **mask)
        work.count("flash_fwd", *job, o, lse)
        return o, lse
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty((B, Hkv, H // Hkv, Sq), dtype=torch.float32,
                      device=q.device)
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, H, Hkv, hd,
        int(q.dtype == torch.bfloat16), int(causal), window or 0, q_offset,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: "
                           f"{lib.flash_fwd_error_string(err).decode()}")
    flash_attention_fwd.launches += 1
    work.count("flash_fwd", *job, o, lse)
    return o, lse


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------------- #
# Backward
# ---------------------------------------------------------------------- #

def _delta(o, do, lse):
    """delta = rowsum(do * o) in f32 from the stored o (bf16 on the bf16
    path, as the reference's einsum at :291 reads it): (B,Hkv,G,Sq)."""
    B, Sq = o.shape[:2]
    Hkv, G = lse.shape[1:3]
    d = (do.float() * o.float()).sum(-1)
    return d.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1).contiguous()


def _bwd_blocks(q, k, v, do, lse, delta, causal, window, q_offset, block_k):
    """Yield (kj, p, ds) per KV block of ``block_k``, math in f32, with
    the explicit mask of the Pallas backward: p = where(mask, exp(s - lse),
    0) and ds = p * (dp - delta) * scale, each (B,Hkv,G,Sq,bk)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd).to(f32)
    dog = do.reshape(B, Sq, Hkv, G, hd).to(f32)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    for k0 in range(0, Sk, block_k):
        kj = k[:, k0:k0 + block_k].to(f32)
        vj = v[:, k0:k0 + block_k].to(f32)
        k_pos = k0 + torch.arange(kj.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj) * scale
        mask = _block_mask(q_pos, k_pos, causal, window)
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vj)
        yield kj, p, p * (dp - delta[..., None]) * scale


def _dq_sum(q, k, v, do, lse, delta, rnd, causal, window, q_offset,
            block_k):
    """dq = sum over keys of rnd(ds) k, f32, (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    dq = torch.zeros((B, Hkv, H // Hkv, Sq, hd), dtype=torch.float32,
                     device=q.device)
    for kj, _, ds in _bwd_blocks(q, k, v, do, lse, delta, causal, window,
                                 q_offset, block_k):
        dq += torch.einsum("bhgqk,bkhd->bhgqd", rnd(ds), kj)
    return dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).contiguous()


def _dkv_sums(q, k, v, do, lse, delta, rnd, causal, window, q_offset,
              block_k):
    """dk = sum over queries and the G heads of rnd(ds)^T q, dv of
    rnd(p)^T do; f32, (B,Sk,Hkv,hd) each."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd).float()
    dog = do.reshape(B, Sq, Hkv, H // Hkv, hd).float()
    dks, dvs = [], []
    for _, p, ds in _bwd_blocks(q, k, v, do, lse, delta, causal, window,
                                q_offset, block_k):
        dvs.append(torch.einsum("bhgqk,bqhgd->bkhd", rnd(p), dog))
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", rnd(ds), qg))
    return torch.cat(dks, 1), torch.cat(dvs, 1)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                     window: int | None = None, q_offset: int = 0,
                     block_k: int = DEFAULT_BLOCK_K):
    """Plain PyTorch dq, KV block by KV block (what ``_flash_bwd_dq_kernel``
    computes): sum over keys of ds k, f32, cast to q's dtype."""
    return _dq_sum(q, k, v, do, lse, delta, _f32, causal, window, q_offset,
                   block_k).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                      window: int | None = None, q_offset: int = 0,
                      block_k: int = DEFAULT_BLOCK_K):
    """Plain PyTorch (dk, dv), KV block by KV block (what
    ``_flash_bwd_dkv_kernel`` computes): dv = sum over queries and the G
    heads of p^T do, dk of ds^T q; f32, cast to k's dtype."""
    dk, dv = _dkv_sums(q, k, v, do, lse, delta, _f32, causal, window,
                       q_offset, block_k)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_bf16_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                          window: int | None = None, q_offset: int = 0,
                          block_k: int = DEFAULT_BLOCK_K):
    """Plain PyTorch dq as the bf16 kernel computes it: ds rounded to bf16
    where it feeds ds k, sums in f32.  Returned in f32: the kernel's one
    further rounding, of dq to bf16 on its store, is left to the caller's
    tolerance."""
    return _dq_sum(q, k, v, do, lse, delta, _bf16, causal, window, q_offset,
                   block_k)


def flash_bwd_dkv_bf16_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: int | None = None, q_offset: int = 0,
                           block_k: int = DEFAULT_BLOCK_K):
    """Plain PyTorch (dk, dv) as the bf16 kernel computes them: p and ds
    rounded to bf16 where they feed p^T do and ds^T q, sums in f32;
    returned in f32, as :func:`flash_bwd_dq_bf16_ref`."""
    return _dkv_sums(q, k, v, do, lse, delta, _bf16, causal, window,
                     q_offset, block_k)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int | None = None, q_offset: int = 0,
                            block_k: int = DEFAULT_BLOCK_K):
    """Plain PyTorch backward (what the two Pallas backward kernels
    compute).  Returns (dq, dk, dv) in the input dtypes."""
    delta = _delta(o, do, lse)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              block_k=block_k)
    dq = flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def _check_bwd(q, k, v, o, lse, do, window) -> None:
    _check(q, k, v, window)
    for name, t in (("o", o), ("do", do)):
        if (not isinstance(t, torch.Tensor) or t.shape != q.shape
                or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"flash attention backward: {name} must be a "
                             f"contiguous tensor like q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    B, Sq, H, _ = q.shape
    Hkv = k.shape[2]
    if (not isinstance(lse, torch.Tensor)
            or lse.shape != (B, Hkv, H // Hkv, Sq)
            or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash attention backward: lse must be a "
                         f"contiguous f32 tensor {(B, Hkv, H // Hkv, Sq)} "
                         f"on {q.device}")
    if on_card(q) and q.dtype == torch.bfloat16 and do.data_ptr() % 16:
        raise ValueError("flash attention backward: bf16 do must be "
                         "16-byte aligned on the card")


def _bwd_lib() -> ctypes.CDLL:
    lib = backend.load("flash_bwd")
    if lib.flash_bwd_dq.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_bwd_dq.argtypes = [ptr] * 7 + [i] * 11 + [ptr]
        lib.flash_bwd_dkv.argtypes = [ptr] * 8 + [i] * 11 + [ptr]
        lib.flash_bwd_dq.restype = lib.flash_bwd_dkv.restype = ctypes.c_int
        lib.flash_bwd_error_string.argtypes = [i]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_launch(name: str, ptrs, q, k, causal, window, q_offset) -> None:
    lib = _bwd_lib()
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    err = getattr(lib, name)(
        *ptrs, B, Sq, Sk, H, Hkv, hd, int(q.dtype == torch.bfloat16),
        int(causal), window or 0, q_offset, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.flash_bwd_error_string(err).decode()}")


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 window: int | None = None, q_offset: int = 0):
    """Launch the dq kernel on checked CUDA tensors (``flash_attention_bwd``
    is the wrapper callers use).  Returns dq like q."""
    dq = torch.empty_like(q)
    _bwd_launch("flash_bwd_dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(), dq.data_ptr()),
                q, k, causal, window, q_offset)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  window: int | None = None, q_offset: int = 0):
    """Launch the dk/dv kernel on checked CUDA tensors.  Returns (dk, dv)
    like k."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_bwd_dkv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  do.data_ptr(), lse.data_ptr(),
                                  delta.data_ptr(), dk.data_ptr(),
                                  dv.data_ptr()),
                q, k, causal, window, q_offset)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0):
    """Returns (dq, dk, dv) in the input dtypes.  ``lse``: (B,Hkv,G,Sq) f32
    from :func:`flash_attention_fwd`; delta = rowsum(do * o) is a torch op
    on the stored o.  Any Sq and Sk are taken on the card."""
    _check_bwd(q, k, v, o, lse, do, window)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    delta = _delta(o, do, lse)
    dims, esz = _dims(q, k), q.element_size()
    if q.is_cuda:
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    else:
        with work.quiet():
            if q.is_meta:
                dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            else:
                dq = flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
                dk, dv = flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    work.count("flash_bwd_dq", *bwd_dq_work(*dims, **kw, esz=esz), dq)
    work.count("flash_bwd_dkv", *bwd_dkv_work(*dims, **kw, esz=esz), dk, dv)
    return dq, dk, dv


# ---------------------------------------------------------------------- #
# Differentiable entry point
# ---------------------------------------------------------------------- #

class FlashAttention(torch.autograd.Function):
    """Flash attention with the kernels' backward: the analogue of the
    reference's ``jax.custom_vjp`` (:342-371).  The forward saves
    (q, k, v, o, lse); the backward recomputes p from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0):
    """Differentiable flash attention: o (B,Sq,H,hd)."""
    return FlashAttention.apply(q, k, v, causal, window, q_offset)
