"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from ._base import ModelConfig, MoECfg, shrink

def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048,
        pattern=("attn",) * 48, activation="swiglu", tie_embeddings=True,
        moe=MoECfg(n_experts=16, top_k=1, d_ff_expert=8192, shared_expert=True),
        family="moe",
    )

def smoke_config() -> ModelConfig:
    return shrink(config())
