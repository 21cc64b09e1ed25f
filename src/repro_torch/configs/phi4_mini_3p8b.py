"""phi4-mini-3.8b [dense]: 32L d=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
RoPE + SwiGLU + GQA.  [arXiv:2412.08905; hf-verified]"""
from ._base import ModelConfig, shrink

def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, head_dim=128, d_ff=8192, vocab=200064,
        pattern=("attn",) * 32, activation="swiglu", tie_embeddings=True,
        family="dense",
    )

def smoke_config() -> ModelConfig:
    return shrink(config())
