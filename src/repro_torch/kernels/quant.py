"""Blockwise int8 quantise, dequantise and the fused quantise + error
feedback: the Hopper kernels, their plain versions and the wrappers.

Counterpart of ``repro/kernels/quant.py`` with the quant wrappers of
``repro/kernels/ops.py:33-71``.  ``csrc/quant.cu`` holds the three kernels
that replace the Pallas ``_quant_kernel``, ``_dequant_kernel`` and
``_quant_ef_kernel``; see the note at the top of that file for their
design and what bounds them.  The plain versions are the reference's eager
jnp path (``repro_torch.core.compression``): ``quantize_int8_ref``,
``dequantize_int8_ref`` and ``quantize_ef_int8_ref``.

The wrappers pad to ``QTILE`` as ``ops.py`` does and return the pad.  They
take the plain versions only for CPU tensors; for a CUDA tensor they
launch the kernel or raise, and count each launch (``quantize_int8.
launches``, ``dequantize_int8.launches``, ``quantize_ef_int8.launches``);
for a ``meta`` tensor (the dry run) they return empty outputs of the
kernels' shapes.  While a ``kernels.work.WorkCounter`` is active they add
each kernel's :func:`work` on every device.  The kernels themselves take
any length that is a multiple of ``BLOCK``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.compression import (BLOCK, QTILE, pad_to_block,
                                dequantize_int8 as dequantize_int8_ref,
                                quantize_ef_int8 as quantize_ef_int8_ref,
                                quantize_int8 as quantize_int8_ref)
from . import backend, work as _work

__all__ = ["QUANT_BYTES", "work", "quantize_int8", "dequantize_int8",
           "quantize_ef_int8",
           "quantize_int8_ref", "dequantize_int8_ref",
           "quantize_ef_int8_ref"]

# HBM bytes each kernel moves per element: its inputs read and outputs
# written once (scales: 4 bytes per BLOCK elements)
QUANT_BYTES = {"quantize_int8": 4 + 1 + 4 / BLOCK,
               "dequantize_int8": 1 + 4 / BLOCK + 4,
               "quantize_ef_int8": 4 + 4 + 1 + 4 / BLOCK + 4}


def work(name: str, n: int) -> tuple[float, float]:
    """(flops, hbm_bytes) of kernel ``name`` over ``n`` elements: no
    products (the counter's FLOPs are those of products alone), and
    ``QUANT_BYTES[name]`` a element."""
    return 0.0, QUANT_BYTES[name] * n


def _check(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if not isinstance(t, torch.Tensor) or t.dim() != 1 or t.dtype != dtype:
        raise ValueError(f"{name} must be a 1-D {dtype} tensor, got "
                         f"{getattr(t, 'dtype', type(t))} "
                         f"{tuple(getattr(t, 'shape', ()))}")
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name} must be on a cpu or cuda device (or on "
                         f"meta), got {t.device}")


def _q_out(xp: torch.Tensor):
    """Empty q (int8, like ``xp``) and scales (f32, one per block) on
    ``xp``'s device: the kernels' outputs."""
    return (torch.empty(xp.shape, dtype=torch.int8, device=xp.device),
            torch.empty((xp.numel() // BLOCK,), dtype=torch.float32,
                        device=xp.device))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte boundary (the kernels load 16 bytes a
    lane); a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lib() -> ctypes.CDLL:
    lib = backend.load("quant")
    if lib.quant_int8.argtypes is None:
        ptr, i64, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.quant_int8.argtypes = [ptr] * 3 + [i64, i, ptr]
        lib.dequant_int8.argtypes = [ptr] * 3 + [i64, i, ptr]
        lib.quant_ef_int8.argtypes = [ptr] * 5 + [i64, i, ptr]
        for f in (lib.quant_int8, lib.dequant_int8, lib.quant_ef_int8):
            f.restype = ctypes.c_int
        lib.quant_error_string.argtypes = [i]
        lib.quant_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, ptrs, nblk: int, like: torch.Tensor) -> None:
    lib = _lib()
    err = getattr(lib, name)(
        *ptrs, nblk, like.device.index,
        torch.cuda.current_stream(like.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.quant_error_string(err).decode()}")


def quantize_int8(x: torch.Tensor):
    """x: 1-D f32.  Returns (q int8 [N'], scales f32 [N'/BLOCK], pad) for
    ``x`` zero-padded to ``N' = N + pad``, a multiple of ``QTILE``."""
    _check(x, "quantize_int8: x", torch.float32)
    xp, pad = pad_to_block(x, QTILE)
    if not xp.is_cuda:
        with _work.quiet():
            q, s = _q_out(xp) if xp.is_meta else quantize_int8_ref(xp)
    else:
        xp = _aligned(xp)
        q, s = _q_out(xp)
        if xp.numel():
            _launch("quant_int8", (xp.data_ptr(), q.data_ptr(),
                                   s.data_ptr()), s.numel(), xp)
            quantize_int8.launches += 1
    if xp.numel():
        _work.count("quantize_int8", *work("quantize_int8", xp.numel()),
                    q, s)
    return q, s, pad


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    pad: int = 0) -> torch.Tensor:
    """q int8 [N] (N a multiple of BLOCK), scales f32 [N/BLOCK] -> f32
    [N - pad]."""
    _check(q, "dequantize_int8: q", torch.int8)
    _check(scales, "dequantize_int8: scales", torch.float32)
    if q.numel() % BLOCK or scales.numel() != q.numel() // BLOCK \
            or scales.device != q.device:
        raise ValueError(f"dequantize_int8 needs q of a multiple of "
                         f"{BLOCK} and one scale per block on its device; "
                         f"got q {tuple(q.shape)} on {q.device}, scales "
                         f"{tuple(scales.shape)} on {scales.device}")
    if not q.is_cuda:
        with _work.quiet():
            x = torch.empty(q.shape, dtype=torch.float32, device=q.device) \
                if q.is_meta else dequantize_int8_ref(q, scales)
    else:
        q, scales = _aligned(q), scales.contiguous()
        x = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        if q.numel():
            _launch("dequant_int8", (q.data_ptr(), scales.data_ptr(),
                                     x.data_ptr()), scales.numel(), q)
            dequantize_int8.launches += 1
    if q.numel():
        _work.count("dequantize_int8", *work("dequantize_int8", q.numel()),
                    x)
    return x[:x.numel() - pad] if pad else x


def quantize_ef_int8(x: torch.Tensor, ef: torch.Tensor):
    """Fused quantise + error feedback of 1-D f32 ``x`` and ``ef`` of one
    length.  Returns (q, scales, new_ef, pad): q and scales cover the
    buffer padded to ``QTILE``; ``new_ef = (x + ef) - q * scale`` is
    sliced back to ``x``'s length."""
    _check(x, "quantize_ef_int8: x", torch.float32)
    _check(ef, "quantize_ef_int8: ef", torch.float32)
    if ef.shape != x.shape or ef.device != x.device:
        raise ValueError(f"quantize_ef_int8 needs matching shapes and "
                         f"devices, got x={tuple(x.shape)} on {x.device}, "
                         f"ef={tuple(ef.shape)} on {ef.device}")
    n = x.numel()
    xp, pad = pad_to_block(x, QTILE)
    efp, _ = pad_to_block(ef, QTILE)
    if not xp.is_cuda:
        with _work.quiet():
            if xp.is_meta:
                (q, s), r = _q_out(xp), torch.empty_like(xp)
            else:
                q, s, r = quantize_ef_int8_ref(xp, efp)
    else:
        xp, efp = _aligned(xp), _aligned(efp)
        (q, s), r = _q_out(xp), torch.empty_like(xp)
        if xp.numel():
            _launch("quant_ef_int8", (xp.data_ptr(), efp.data_ptr(),
                                      q.data_ptr(), s.data_ptr(),
                                      r.data_ptr()), s.numel(), xp)
            quantize_ef_int8.launches += 1
    if xp.numel():
        _work.count("quantize_ef_int8",
                    *work("quantize_ef_int8", xp.numel()), q, s, r)
    return q, s, r[:n], pad


quantize_int8.launches = 0
dequantize_int8.launches = 0
quantize_ef_int8.launches = 0
