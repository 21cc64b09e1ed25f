"""olmoe-1b-7b [moe]: 16L d=2048 16H (kv=16) d_ff_expert=1024 vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060; hf-verified]"""
from ._base import ModelConfig, MoECfg, shrink

def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=1024, vocab=50304,
        pattern=("attn",) * 16, activation="swiglu", tie_embeddings=True,
        moe=MoECfg(n_experts=64, top_k=8, d_ff_expert=1024),
        family="moe",
    )

def smoke_config() -> ModelConfig:
    return shrink(config())
