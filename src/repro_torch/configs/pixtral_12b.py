"""pixtral-12b [vlm]: 40L d=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
Pixtral-ViT frontend is a STUB (input_specs supplies patch embeddings);
backbone = mistral-nemo-style decoder.  [hf:mistralai/Pixtral-12B-2409]"""
from ._base import ModelConfig, shrink

def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab=131072,
        pattern=("attn",) * 40, activation="swiglu", tie_embeddings=True,
        family="vlm", frontend="vision",
    )

def smoke_config() -> ModelConfig:
    return shrink(config())
