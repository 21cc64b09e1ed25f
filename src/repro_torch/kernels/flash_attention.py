"""Flash-attention forward: the Hopper kernel and its plain version.

Counterpart of ``repro/kernels/flash_attention.py`` (forward only).  The
kernel (``csrc/flash_fwd.cu``) replaces the Pallas ``_flash_kernel``; see
the note at the top of that file for its design and what bounds it.

``flash_attention_fwd`` is the wrapper every caller goes through.  It
takes the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises, and counts the launch in
``flash_attention_fwd.launches``.

Layouts are the JAX package's: q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd), query
head ``h`` reads KV head ``h // G`` (G = H // Hkv); outputs o (B,Sq,H,hd)
in q's dtype and lse (B,Hkv,G,Sq) in f32.  Masked scores are the finite
``NEG_INF``, as in the Pallas kernel, which visits every KV block: a row
with no unmasked key averages V over all keys.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import backend

__all__ = ["NEG_INF", "DEFAULT_BLOCK_K", "KERNEL_HEAD_DIMS",
           "KERNEL_MAX_GROUP", "flash_attention_fwd",
           "flash_attention_fwd_ref"]

NEG_INF = -1e30
DEFAULT_BLOCK_K = 512
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
KERNEL_MAX_GROUP = 64          # G query heads must fit the 64-row tile
DTYPES = (torch.float32, torch.bfloat16)


def _block_mask(q_pos, k_pos, causal: bool, window: int | None):
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return mask


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True,
                            window: int | None = None, q_offset: int = 0,
                            block_k: int = DEFAULT_BLOCK_K):
    """Plain PyTorch online-softmax forward over KV blocks of ``block_k``
    (the last one may be short), math in f32.  Mirrors
    ``repro.models.layers._flash_fwd_impl`` without its block skipping,
    i.e. what ``_flash_kernel`` computes.  Returns (o, lse)."""
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
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vj)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    o = acc / l[..., None]
    lse = m + torch.log(l)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    return o, lse


def _check(q, k, v, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash attention: {name} must be a 4-D tensor")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"flash attention: q, k, v must share one dtype "
                             f"of {DTYPES}, got {q.dtype}/{k.dtype}/"
                             f"{v.dtype}")
        if t.device != q.device or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"flash attention: q, k, v must be on one cpu "
                             f"or cuda device, got {q.device}/{k.device}/"
                             f"{v.device}")
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
    if q.is_cuda and (hd not in KERNEL_HEAD_DIMS
                      or H // Hkv > KERNEL_MAX_GROUP):
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS} and at most "
                         f"{KERNEL_MAX_GROUP} query heads per KV head, got "
                         f"hd={hd} G={H // Hkv}")


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
    if not q.is_cuda:
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    lib = _lib()
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
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
    return o, lse


flash_attention_fwd.launches = 0
