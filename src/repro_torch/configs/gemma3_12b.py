"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
5:1 local:global attention, 128k context.  [hf:google/gemma-3 family]"""
from ._base import ModelConfig, shrink

def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        head_dim=256, d_ff=15360, vocab=262144,
        pattern=(("local",) * 5 + ("attn",)) * 8, window=1024,
        qk_norm=True, rope_theta=1e6, activation="geglu", tie_embeddings=True,
        family="dense",
    )

def smoke_config() -> ModelConfig:
    return shrink(config(), n_layers=6)  # one full 5:1 period
