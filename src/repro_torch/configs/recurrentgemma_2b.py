"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (GQA kv=1, MQA) d_ff=7680
vocab=256000.  RG-LRU + local attention, 1 attn per 2 recurrent (Griffin).
[arXiv:2402.19427; hf-verified]"""
from ._base import ModelConfig, shrink

def config() -> ModelConfig:
    pattern = (("rglru", "rglru", "local") * 9)[:26]
    return ModelConfig(
        name="recurrentgemma-2b", n_layers=26, d_model=2560, n_heads=10,
        n_kv_heads=1, head_dim=256, d_ff=7680, vocab=256000,
        pattern=pattern, window=2048, activation="geglu", tie_embeddings=True,
        d_rnn=2560, family="hybrid",
    )

def smoke_config() -> ModelConfig:
    return shrink(config(), n_layers=3)  # one rglru,rglru,local period
