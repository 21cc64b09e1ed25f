"""Public wrappers around the kernels.

Counterpart of ``repro/kernels/ops.py``.  Only the attention forward is
ported so far; the flash backward and the int8 quantisers are still to
come (``ROADMAP.md``, kernel queue).
"""
from __future__ import annotations

from . import flash_attention as _fa

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0):
    """Flash attention forward: o (B,Sq,H,hd).  The Hopper kernel for CUDA
    tensors, its plain version for CPU tensors."""
    o, _ = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return o
