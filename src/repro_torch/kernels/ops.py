"""Public wrappers around the kernels.

Counterpart of ``repro/kernels/ops.py``.  The flash-attention forward and
backward are ported; the int8 quantisers are still to come (``ROADMAP.md``,
kernel queue).
"""
from __future__ import annotations

from .flash_attention import flash_attention

__all__ = ["flash_attention"]
