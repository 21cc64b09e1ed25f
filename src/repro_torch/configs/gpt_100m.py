"""gpt-100m: ~100M-param dense LM used by the end-to-end training example
(examples/train_e2e.py) — small enough to train a few hundred steps on CPU
in the CI budget while exercising the full distributed stack."""
from ._base import ModelConfig, shrink

def config() -> ModelConfig:
    return ModelConfig(
        name="gpt-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        head_dim=64, d_ff=3072, vocab=32000, pattern=("attn",) * 12,
        activation="gelu", tie_embeddings=True, family="dense",
    )

def smoke_config() -> ModelConfig:
    return shrink(config())
