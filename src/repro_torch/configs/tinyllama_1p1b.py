"""tinyllama-1.1b [dense]: 22L d=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
llama2-arch small.  [arXiv:2401.02385; hf-verified]"""
from ._base import ModelConfig, shrink

def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
        n_kv_heads=4, head_dim=64, d_ff=5632, vocab=32000,
        pattern=("attn",) * 22, activation="swiglu", tie_embeddings=False,
        family="dense",
    )

def smoke_config() -> ModelConfig:
    return shrink(config())
