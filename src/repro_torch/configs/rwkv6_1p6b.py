"""rwkv6-1.6b [ssm]: 24L d=2048 (attention-free) d_ff=7168 vocab=65536.
Finch: data-dependent per-channel decay.  [arXiv:2404.05892]"""
from ._base import ModelConfig, shrink

def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", n_layers=24, d_model=2048, n_heads=32,
        n_kv_heads=32, head_dim=64, d_ff=7168, vocab=65536,
        pattern=("rwkv6",) * 24, activation="gelu", tie_embeddings=True,
        rwkv_head_dim=64, family="ssm",
    )

def smoke_config() -> ModelConfig:
    return shrink(config())
