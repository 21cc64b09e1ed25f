"""Slow-link gradient compression: blockwise int8 quantisation + error
feedback.

Counterpart of ``repro/core/compression.py``.  Compression is applied only
on the pod (slow) hop of the multilevel all-reduce, where the payload is
already 1/|data| of the gradient: int8 plus one f32 scale per block of
``BLOCK`` crosses the slow link instead of f32.

The plain functions here (``quantize_int8``, ``dequantize_int8``,
``quantize_ef_int8``) are the reference's eager jnp path, bit for bit:
``x / scale`` is a true division (a tensor divisor, so no backend rewrites
it as a product with the reciprocal), ``torch.round`` rounds half to even,
and the EF residual subtracts the rounded product ``q * scale``.  They are
also the plain versions of the Hopper kernels in ``repro_torch.kernels.
quant``, which a CUDA tensor always takes (``use_kernel=None``); a CPU
tensor takes the plain path.  ``apply_error_feedback`` is the local (no
collective) form of the correction ``compressed_psum`` applies with an
``ef`` buffer.  The kernel path pads to ``QTILE`` (the
reference's kernel granularity) instead of ``BLOCK``: the extra blocks are
zeros, so the values are the same and only the wire bytes grow.

Two edge cases are pinned down where eager jnp leaves them to the
backend: a NaN in a block makes its scale NaN and its int8 payload 0 (what
XLA's convert gives), and the residual clamps the product to +-F32_MAX,
so a block whose largest magnitude is F32_MAX leaves a finite residual
(the reference's jnp path gives +-inf there; its Pallas kernel guards the
positive side with the same clamp).
"""
from __future__ import annotations

import torch

from ..kernels.backend import on_card

__all__ = ["BLOCK", "TILE", "QTILE", "WIRE_BYTES_PER_ELEM", "F32_MAX",
           "pad_to_block", "quantize_int8", "dequantize_int8",
           "quantize_ef_int8", "compressed_psum", "apply_error_feedback"]

BLOCK = 256        # elements per scale block
TILE = 32          # quant blocks per kernel grid step of the reference
QTILE = BLOCK * TILE   # the reference kernel's granularity

# int8 payload + one f32 scale per BLOCK: the compressed slow-hop wire cost
# per f32 element (vs 4.0 uncompressed)
WIRE_BYTES_PER_ELEM = 1.0 + 4.0 / BLOCK

F32_MAX = 3.4028234663852886e38


def pad_to_block(x: torch.Tensor, multiple: int = BLOCK):
    """Zero-pad a 1-D buffer to a multiple.  Returns ``(padded, pad)`` with
    ``pad`` a python int."""
    if x.dim() != 1:
        raise ValueError(f"pad_to_block needs a 1-D buffer, got "
                         f"{tuple(x.shape)}")
    pad = (-x.numel()) % multiple
    return (torch.nn.functional.pad(x, (0, pad)) if pad else x), pad


def _check_blocks(x: torch.Tensor, block: int, name: str) -> None:
    if x.dim() != 1 or x.numel() % block != 0:
        raise ValueError(f"{name} needs a 1-D buffer whose size is a "
                         f"multiple of the block; got shape "
                         f"{tuple(x.shape)} with block {block}")


def quantize_int8(x: torch.Tensor, block: int = BLOCK):
    """Blockwise symmetric int8 quantisation of a 1-D f32 buffer whose
    length is a multiple of ``block``.  Returns (q int8 [N], scales f32
    [N/block])."""
    _check_blocks(x, block, "quantize_int8")
    xb = x.reshape(-1, block)
    amax = xb.abs().amax(dim=1)                  # NaN propagates
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return q.reshape(-1), scale


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    block: int = BLOCK) -> torch.Tensor:
    """q * scale per block, f32."""
    _check_blocks(q, block, "dequantize_int8")
    return (q.reshape(-1, block).to(torch.float32)
            * scales[:, None]).reshape(-1)


def quantize_ef_int8(x: torch.Tensor, ef: torch.Tensor,
                     block: int = BLOCK):
    """Quantise ``x + ef`` and return the new residual beside it:
    (q, scales, new_ef) with ``new_ef = (x + ef) - clamp(q * scale)``, the
    product rounded before the subtract.  What the fused kernel computes;
    x and ef are 1-D f32 of one length, a multiple of ``block``."""
    if ef.shape != x.shape:
        raise ValueError(f"quantize_ef_int8 needs matching shapes, got "
                         f"x={tuple(x.shape)} ef={tuple(ef.shape)}")
    xin = x + ef
    q, s = quantize_int8(xin, block)
    deq = torch.clamp(dequantize_int8(q, s, block), -F32_MAX, F32_MAX)
    return q, s, xin - deq


def _resolve_use_kernel(use_kernel: bool | None, block: int,
                        x: torch.Tensor) -> bool:
    """None -> the kernel for a CUDA tensor (and a ``meta`` one, the dry
    run's), the plain path for a CPU one.  A CUDA tensor never takes the
    plain path."""
    if use_kernel is None:
        use_kernel = on_card(x)
    if use_kernel and block != BLOCK:
        raise ValueError(f"the int8 kernels are tiled for block={BLOCK}; "
                         f"pass use_kernel=False for block={block}")
    if on_card(x) and not use_kernel:
        raise ValueError("a CUDA tensor takes the int8 kernels "
                         "(use_kernel=False is for CPU tensors)")
    return bool(use_kernel)


def compressed_psum(x: torch.Tensor, slow, block: int = BLOCK,
                    ef: torch.Tensor | None = None,
                    use_kernel: bool | None = None):
    """All-reduce the 1-D f32 ``x`` over the ``slow`` axis (a
    ``launch.mesh.Axis``) sending int8 on the wire.

    Every pod's quantised shard and scales are all-gathered, dequantised
    (on the card by the dequant kernel, as one ``[npods * N]`` buffer) and
    summed in pod order.  With ``ef`` (same size as ``x``) the residual is
    added before quantisation and the call returns ``(out, new_ef)``, the
    local rounding error of the corrected buffer."""
    use_kernel = _resolve_use_kernel(use_kernel, block, x)
    n = x.numel()
    new_ef = None
    if use_kernel:
        from ..kernels import quant as kq
        if ef is not None:
            q, s, new_ef, pad = kq.quantize_ef_int8(x, ef.reshape(-1))
        else:
            q, s, pad = kq.quantize_int8(x)
        full = kq.dequantize_int8(slow.all_gather(q), slow.all_gather(s))
    else:
        if ef is not None:
            xp, pad = pad_to_block(x, block)
            efp, _ = pad_to_block(ef.reshape(-1), block)
            q, s, new_ef = quantize_ef_int8(xp, efp, block)
            new_ef = new_ef[:n]
        else:
            xp, pad = pad_to_block(x, block)
            q, s = quantize_int8(xp, block)
        full = dequantize_int8(slow.all_gather(q), slow.all_gather(s), block)
    rows = full.reshape(slow.size, -1)
    out = rows[0]
    for row in rows[1:]:
        out = out + row
    out = out[:n]
    return out if ef is None else (out, new_ef)


def apply_error_feedback(grad_flat: torch.Tensor, ef: torch.Tensor,
                         block: int = BLOCK,
                         use_kernel: bool | None = None):
    """Classic EF: add the residual, quantise-dequantise locally to compute
    the new residual.  Returns (corrected_grad, new_ef).  ``use_kernel``
    as in :func:`compressed_psum`: the kernel path pads to ``QTILE`` and
    takes the fused quantise + EF kernel, which produces the residual in
    the same pass as the quantisation (its plain version on a CPU
    tensor)."""
    use_kernel = _resolve_use_kernel(use_kernel, block, grad_flat)
    g = grad_flat + ef
    if use_kernel:
        from ..kernels import quant as kq
        _, _, new_ef, _ = kq.quantize_ef_int8(grad_flat, ef)
        return g, new_ef
    gp, _ = pad_to_block(g, block)
    q, s = quantize_int8(gp, block)
    deq = dequantize_int8(q, s, block)[:g.numel()]
    return g, g - deq
