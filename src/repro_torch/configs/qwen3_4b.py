"""qwen3-4b [dense]: 36L d=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
qk_norm + GQA.  [hf:Qwen/Qwen3-8B family; hf-verified tier]"""
from ._base import ModelConfig, shrink

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=9728, vocab=151936, pattern=("attn",) * 36,
        qk_norm=True, rope_theta=1e6, activation="swiglu", tie_embeddings=True,
        family="dense",
    )

def smoke_config() -> ModelConfig:
    return shrink(config())
