"""Plain PyTorch oracles for the kernels (counterpart of
``repro/kernels/ref.py``; the quantiser oracles are ``quantize_int8_ref``
and ``dequantize_int8_ref`` in ``kernels/quant.py``)."""
from __future__ import annotations

import math

import torch

__all__ = ["mha_reference"]


def mha_reference(q, k, v, *, causal: bool = True,
                  window: int | None = None):
    """Naive O(S^2) GQA attention.  q:(B,Sq,H,hd) k/v:(B,Sk,Hkv,hd)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k.float()) / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)
