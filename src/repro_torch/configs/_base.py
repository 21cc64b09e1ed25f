"""Shared helpers for arch config modules."""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig, MoECfg, EncDecCfg, pattern_repeat

__all__ = ["ModelConfig", "MoECfg", "EncDecCfg", "pattern_repeat", "shrink"]


def shrink(cfg: ModelConfig, n_layers: int = 4) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: tiny widths, few
    layers (pattern prefix preserved), tiny vocab / expert count."""
    hd = 16
    n_heads = 4
    n_kv = max(1, min(cfg.n_kv_heads * n_heads // max(cfg.n_heads, 1), n_heads))
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32)
    enc_dec = None
    if cfg.enc_dec is not None:
        enc_dec = EncDecCfg(n_enc_layers=2, n_dec_layers=n_layers)
    pattern = pattern_repeat(cfg.pattern, max(len(cfg.pattern), n_layers))[:n_layers]
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=128,
        vocab=512,
        pattern=pattern,
        window=min(cfg.window, 8),
        moe=moe,
        enc_dec=enc_dec,
        d_rnn=64 if cfg.d_rnn else None,
        rwkv_head_dim=16,
    )
