"""Public wrappers around the kernels.

Counterpart of ``repro/kernels/ops.py``.  The differentiable flash
attention and the RWKV-6 chunked WKV (the kernel, and :func:`wkv`, its
differentiable form) are here; the int8 quantise,
dequantise and fused error-feedback wrappers, which pad to ``QTILE`` as
the reference's do, are in ``kernels/quant.py``.
"""
from __future__ import annotations

from .flash_attention import flash_attention
from .wkv import wkv, wkv_chunked

__all__ = ["flash_attention", "wkv", "wkv_chunked"]
