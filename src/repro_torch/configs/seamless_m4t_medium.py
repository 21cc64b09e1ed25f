"""seamless-m4t-medium [audio]: enc-dec, 12+12L d=1024 16H d_ff=4096
vocab=256206.  Audio frontend is a STUB (input_specs supplies precomputed
frame embeddings).  [arXiv:2308.11596; hf-verified]"""
from ._base import ModelConfig, EncDecCfg, shrink

def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", n_layers=12, d_model=1024, n_heads=16,
        n_kv_heads=16, head_dim=64, d_ff=4096, vocab=256206,
        pattern=("attn",) * 12, activation="gelu", tie_embeddings=True,
        enc_dec=EncDecCfg(n_enc_layers=12, n_dec_layers=12),
        family="audio", frontend="audio",
    )

def smoke_config() -> ModelConfig:
    return shrink(config())
