"""RWKV-6 chunked WKV recurrence: the Hopper kernel, its plain version and
the wrapper.

Counterpart of ``repro/kernels/wkv.py``.  ``csrc/wkv.cu`` replaces the
Pallas ``_wkv_kernel``; see the note at the top of that file for its design
and what bounds it.  The plain version, :func:`wkv_chunk_scan_ref`, is a
copy of the reference model's ``layers._wkv_chunk_scan``, the oracle the
Pallas kernel was written to replace and the function the reference's
``rwkv6_fwd`` calls.

:func:`wkv_chunked` takes the plain version only for CPU tensors, at any
chunk and head dim, as the reference does; for a CUDA tensor it launches
the kernel where :func:`kernel_takes` the (head dim, chunk) pair (hd
1-256 and chunk 1-64 with chunk x hd's width <= 4096) or raises, and
counts each launch in ``wkv_chunked.launches``; for a ``meta`` tensor (the
dry run) it returns empty outputs of the kernel's shapes.  While a
``kernels.work.WorkCounter`` is active it adds the kernel's :func:`work`
on every device.  Unlike the Pallas wrapper it can also return the final
state, the oracle's second result, which the prefill cache holds.

:func:`wkv` is what the model calls.  Where no gradient is taken it is
:func:`wkv_chunked` itself.  Where one is, it runs :class:`WKV`, whose
forward is :func:`wkv_chunked` (the kernel on the card) and whose backward
is autograd through the plain version, recomputed from the saved inputs.
That is the reference's own gradient: its ``rwkv6_fwd`` trains through
XLA's autodiff of the same jnp scan, and its Pallas kernel has no VJP, so
no TPU kernel stands behind the backward for a kernel here to port.
"""
from __future__ import annotations

import ctypes

import torch

from . import backend, work as _work

__all__ = ["CHUNK", "KERNEL_HEAD_WIDTHS", "KERNEL_MAX_CHUNK",
           "KERNEL_MAX_HEAD_DIM", "KERNEL_MAX_TILE", "WKV", "kernel_takes",
           "kernel_width", "launch_plan", "wkv", "wkv_chunk_scan_ref",
           "wkv_chunked", "work"]

CHUNK = 16
# The kernel's head widths; a call runs the least that holds its head dim,
# and a chunk length of 16, 32 or 64 that holds its chunk, where the tiles
# (chunk x width) fit one block's shared memory (see csrc/wkv.cu)
KERNEL_HEAD_WIDTHS = (64, 128, 256)
KERNEL_MAX_CHUNK = 64
KERNEL_MAX_HEAD_DIM = KERNEL_HEAD_WIDTHS[-1]
KERNEL_MAX_TILE = 4096          # chunk x head width


def work(B: int, S: int, H: int, hd: int, C: int = CHUNK,
         state: bool = True) -> tuple[float, float]:
    """(flops, hbm_bytes) of one chunked WKV: per chunk and (b, h) the
    inter-chunk product and the state update (2 C hd^2 each), the decay
    and sum of the old state (2 hd^2), the strictly lower scores and their
    product with v (C (C-1) hd each), the bonus (5 C hd), the decays (6 C
    hd, log and exp counted as one each) and k/e times e_C (C hd); r, k,
    v, w and u read and o (and the final state, with ``state``) written
    once, in f32."""
    per_chunk = 4 * C * hd * hd + 2 * C * (C - 1) * hd + 2 * hd * hd \
        + 12 * C * hd
    flops = B * H * (S // C) * per_chunk
    nbytes = 4 * (5 * B * S * H * hd + state * B * H * hd * hd + H * hd)
    return flops, nbytes


def wkv_chunk_scan_ref(r, k, v, w, u, chunk: int):
    """Chunked linear recurrence S_t = diag(w_t) S_{t-1} + k_t v_t^T with
    per-step output o_t = r_t S_{t-1} + (r_t . (u*k_t)) v_t.

    r,k,w: (B,S,H,hd) f32, w in (0,1); v: (B,S,H,hv) f32, hv = hd or
    any slice of v's columns; u: (H,hd) f32.  Returns (o (B,S,H,hv),
    S_final (B,H,hd,hv)), both f32: column e of each needs only column e
    of v."""
    B, S, H, hd = r.shape
    hv = v.shape[-1]
    C = chunk
    if S % C != 0:
        raise ValueError(f"linear-attention chunking needs S % chunk "
                         f"== 0, got S={S} chunk={C}")
    n = S // C
    fold = lambda t: t.reshape(B, n, C, H, -1).permute(1, 0, 3, 2, 4)
    rs, ks, vs, ws = (fold(t) for t in (r, k, v, w))    # (n,B,H,C,hd|hv)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      -1)
    state = torch.zeros((B, H, hd, hv), dtype=torch.float32, device=r.device)
    os_ = torch.empty((n, B, H, C, hv), dtype=torch.float32, device=r.device)
    for i in range(n):
        rc, kc, vc, wc = rs[i], ks[i], vs[i], ws[i]
        logw = torch.log(torch.clamp_min(wc, 1e-8))
        e = torch.exp(torch.cumsum(logw, dim=2))     # e_t = prod_{j<=t} w_j
        e_excl = e / torch.clamp_min(wc, 1e-8)       # e_{t-1} relative
        # inter-chunk: o_t += (r_t * e_excl_t) @ S_prev
        o = torch.einsum("bhtd,bhde->bhte", rc * e_excl, state)
        # intra-chunk: scores_{t,j} = (r_t*e_excl_t) . (k_j/e_j), j < t
        kk = kc / torch.clamp_min(e, 1e-30)
        sc = torch.einsum("bhtd,bhjd->bhtj", rc * e_excl, kk)
        sc = torch.where(mask, sc, 0.0)
        o = o + torch.einsum("bhtj,bhjd->bhtd", sc, vc)
        # diagonal bonus term
        bonus = torch.einsum("bhtd,bhtd->bht", rc, u[None, :, None, :] * kc)
        os_[i] = o + bonus[..., None] * vc
        # state update
        ec = e[:, :, -1]
        state = ec[..., None] * state + torch.einsum(
            "bhtd,bhte->bhde", kk * ec[:, :, None], vc)
    o = os_.permute(1, 0, 3, 2, 4).reshape(B, S, H, hv)
    return o, state


def kernel_width(hd: int) -> int:
    """The head width of the instance that runs head dim ``hd``."""
    return next((W for W in KERNEL_HEAD_WIDTHS if hd <= W),
                KERNEL_HEAD_WIDTHS[-1])


def kernel_takes(hd: int, chunk: int) -> bool:
    """Whether the kernel takes head dim ``hd`` in chunks of ``chunk``:
    hd 1-256 and chunk 1-64 with chunk x (hd's width) <= 4096, so every
    chunk 1-16 at every hd and every chunk up to 64 at hd <= 64.  Only a
    card's call is held to it; the plain version takes any."""
    return (1 <= hd <= KERNEL_MAX_HEAD_DIM and 1 <= chunk <= KERNEL_MAX_CHUNK
            and chunk * kernel_width(hd) <= KERNEL_MAX_TILE)


def _check(r, k, v, w, u, chunk: int, n_split: int) -> None:
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or t.shape != r.shape or t.dim() != 4:
            raise ValueError(f"wkv_chunked: r, k, v, w must be f32 tensors "
                             f"of one (B,S,H,hd) shape, got {name} "
                             f"{getattr(t, 'dtype', type(t))} "
                             f"{tuple(getattr(t, 'shape', ()))}")
        if t.device != r.device or \
                t.device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"wkv_chunked: inputs must be on one cpu or "
                             f"cuda device (or all on meta), got {name} on "
                             f"{t.device}")
    B, S, H, hd = r.shape
    if not isinstance(u, torch.Tensor) or u.dtype != torch.float32 \
            or u.shape != (H, hd) or u.device != r.device:
        raise ValueError(f"wkv_chunked: u must be f32 ({H}, {hd}) on "
                         f"{r.device}, got {getattr(u, 'dtype', type(u))} "
                         f"{tuple(getattr(u, 'shape', ()))}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"wkv_chunked needs chunk >= 1 and S % chunk == 0, "
                         f"got S={S} chunk={chunk}")
    if r.is_cuda and not kernel_takes(hd, chunk):
        raise ValueError(
            f"the WKV kernel takes head_dim 1..{KERNEL_MAX_HEAD_DIM} and "
            f"chunk 1..{KERNEL_MAX_CHUNK} with chunk x head width <= "
            f"{KERNEL_MAX_TILE} (widths {KERNEL_HEAD_WIDTHS}), got head_dim "
            f"{hd} (width {kernel_width(hd)}) and chunk {chunk}")
    if not 0 <= n_split <= hd:
        raise ValueError(f"wkv_chunked takes n_split 0..{hd} (0: the "
                         f"launcher's choice), got {n_split}")


def _lib() -> ctypes.CDLL:
    lib = backend.load("wkv")
    if lib.wkv_fwd.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv_fwd.argtypes = [ptr] * 7 + [i] * 6 + [ptr, i]
        lib.wkv_fwd.restype = ctypes.c_int
        lib.wkv_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)]
        lib.wkv_plan.restype = ctypes.c_int
        lib.wkv_supported.argtypes = [i, i]
        lib.wkv_supported.restype = ctypes.c_int
        lib.wkv_error_string.argtypes = [i]
        lib.wkv_error_string.restype = ctypes.c_char_p
    return lib


def launch_plan(B: int, H: int, hd: int, n_split: int = 0,
                device: int | None = None, *, chunk: int = CHUNK) -> dict:
    """What the kernel launches for a (B, S, H, hd) call on a card in
    chunks of ``chunk``: blocks per head (``n_split``), blocks, threads and
    dynamic shared bytes a block, how many blocks an SM holds at once, and
    the instance (its chunk length and head width, and whether it is the
    exact one; inputs 16-byte aligned)."""
    dev = torch.cuda.current_device() if device is None else device
    lib = _lib()
    out = (ctypes.c_int * 8)()
    err = lib.wkv_plan(B, H, hd, chunk, n_split, dev, out)
    if err:
        raise RuntimeError(f"wkv_plan failed: "
                           f"{lib.wkv_error_string(err).decode()}")
    plan = dict(zip(("n_split", "blocks", "threads", "smem_bytes",
                     "blocks_per_sm", "chunk_width", "head_width", "exact"),
                    out))
    plan["exact"] = bool(plan["exact"])
    return plan


def wkv_chunked(r, k, v, w, u, *, chunk: int = CHUNK,
                return_state: bool = False, n_split: int = 0):
    """r,k,v,w: (B,S,H,hd) f32; u: (H,hd) f32.  Returns o (B,S,H,hd) f32,
    and with ``return_state`` also the final state (B,H,hd,hd) f32.

    S must divide by ``chunk`` (callers pad, as ``models.layers`` does).
    On the card (hd, chunk) must be one :func:`kernel_takes`; the plain
    version takes any, as the reference does.  ``n_split`` is a test hook:
    0 lets the kernel's launcher choose how many blocks share a head's
    value columns, 1..hd asks for that many (raised to the head's floor
    above hd 64); the plain version ignores it (its columns are
    independent either way)."""
    _check(r, k, v, w, u, chunk, n_split)
    B, S, H, hd = r.shape
    job = work(B, S, H, hd, chunk, return_state)
    if not r.is_cuda:
        with _work.quiet():
            if r.is_meta:
                o = torch.empty_like(r)
                state = r.new_empty((B, H, hd, hd))
            else:
                o, state = wkv_chunk_scan_ref(r, k, v, w, u, chunk)
        _work.count("wkv", *job, o, *(state,) * return_state)
        return (o, state) if return_state else o
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    o = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32,
                        device=r.device) if return_state else None
    lib = _lib()
    err = lib.wkv_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      u.data_ptr(), o.data_ptr(),
                      None if state is None else state.data_ptr(),
                      B, S, H, hd, chunk, r.device.index,
                      torch.cuda.current_stream(r.device).cuda_stream,
                      n_split)
    if err:
        raise RuntimeError(f"wkv_fwd launch failed: "
                           f"{lib.wkv_error_string(err).decode()}")
    wkv_chunked.launches += 1
    _work.count("wkv", *job, o, state)
    return (o, state) if return_state else o


wkv_chunked.launches = 0


class WKV(torch.autograd.Function):
    """:func:`wkv_chunked` forward in chunks of ``chunk``, (o, the final
    state); the backward recomputes the plain scan at the same chunk from
    the saved inputs and differentiates it."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk: int = CHUNK):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        return wkv_chunked(r, k, v, w, u, chunk=chunk, return_state=True)

    @staticmethod
    def backward(ctx, g_o, g_state):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            outs = wkv_chunk_scan_ref(*ins, ctx.chunk)
        pairs = [(y, g) for y, g in zip(outs, (g_o, g_state))
                 if g is not None]
        got = iter(torch.autograd.grad(
            [y for y, _ in pairs], [t for t in ins if t.requires_grad],
            [g for _, g in pairs]))
        return tuple(next(got) if t.requires_grad else None
                     for t in ins) + (None,)


def wkv(r, k, v, w, u, *, chunk: int = CHUNK, return_state: bool = False):
    """:func:`wkv_chunked` in chunks of ``chunk``, differentiable: with a
    gradient to take (grad mode on and an input that requires it) through
    :class:`WKV`, else the wrapper alone, which saves nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u)):
        o, state = WKV.apply(r, k, v, w, u, chunk)
        return (o, state) if return_state else o
    return wkv_chunked(r, k, v, w, u, chunk=chunk, return_state=return_state)
