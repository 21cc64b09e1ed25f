"""Model configuration: one dataclass covering every assigned architecture.

Layer stacks are described by a per-layer ``pattern`` of block kinds:
  "attn"    full causal self-attention
  "local"   sliding-window self-attention (window = cfg.window)
  "rglru"   RG-LRU recurrent block (Griffin / recurrentgemma)
  "rwkv6"   RWKV-6 "Finch" linear-attention block with data-dependent decay
Every block is followed by an MLP (or MoE) sublayer except "rwkv6", which
uses the RWKV channel-mix in place of the MLP.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["MoECfg", "EncDecCfg", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # llama4-style: a shared dense expert alongside the routed ones
    shared_expert: bool = False


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    n_enc_layers: int
    n_dec_layers: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[str, ...]            # len == n_layers (decoder side)
    window: int = 1024                  # sliding-window size for "local"
    qk_norm: bool = False
    rope_theta: float = 10000.0
    activation: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = True
    moe: MoECfg | None = None
    enc_dec: EncDecCfg | None = None
    d_rnn: int | None = None            # RG-LRU recurrence width
    rwkv_head_dim: int = 64
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # which family flag ("dense"|"moe"|"vlm"|"hybrid"|"audio"|"ssm")
    family: str = "dense"
    # PaLM/GPT-J-style parallel residual block: y = x + attn(n(x)) + mlp(n(x))
    # — halves the per-layer tensor-parallel all-reduces (perf variant; the
    # paper-faithful configs keep sequential blocks)
    parallel_block: bool = False
    # modality frontend stub: number of non-token embedding positions
    frontend: str | None = None         # None | "vision" | "audio"

    # ------------------------------------------------------------------ #
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def subquadratic(self) -> bool:
        """True iff a 500k-token decode is feasible (no full-attention layer)."""
        return all(k in ("rglru", "rwkv6", "local") for k in self.pattern)

    def runs(self) -> list[tuple[str, int]]:
        """Maximal runs of identical block kinds (scan groups)."""
        out: list[tuple[str, int]] = []
        for k in self.pattern:
            if out and out[-1][0] == k:
                out[-1] = (k, out[-1][1] + 1)
            else:
                out.append((k, 1))
        return out

    def param_count(self) -> int:
        """Total parameters (embedding + blocks); MoE counts all experts."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb + D  # final norm
        n_dec = self.enc_dec.n_dec_layers if self.enc_dec else self.n_layers
        for kind in self.pattern:
            total += self._block_params(kind, cross=False)
        if self.enc_dec:
            for _ in range(self.enc_dec.n_enc_layers):
                total += self._block_params("attn", cross=False)
            # decoder cross-attention on top of the pattern blocks
            total += n_dec * self._attn_params()
        return total

    def _attn_params(self) -> int:
        D = self.d_model
        return D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D

    def _mlp_params(self) -> int:
        D, F = self.d_model, self.d_ff
        if self.moe is not None:
            E, Fe = self.moe.n_experts, self.moe.d_ff_expert
            routed = E * (3 if self.activation == "swiglu" else 2) * self.d_model * Fe
            shared = (3 * D * F) if self.moe.shared_expert else 0
            return routed + shared + D * E  # + router
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        return mult * D * F

    def _block_params(self, kind: str, cross: bool) -> int:
        D = self.d_model
        if kind in ("attn", "local"):
            return self._attn_params() + self._mlp_params() + 2 * D
        if kind == "rglru":
            R = self.d_rnn or D
            return (2 * D * R + 2 * R * R + 4 * R + R * D
                    + self._mlp_params() + 2 * D)
        if kind == "rwkv6":
            # time-mix (r,k,v,g,w proj + out) + channel-mix (k,v,r)
            return 7 * D * D + 2 * D * self.d_ff + 2 * D
        raise ValueError(kind)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        E, k = self.moe.n_experts, self.moe.top_k
        routed_all = self.moe.n_experts * 3 * self.d_model * self.moe.d_ff_expert
        routed_active = k * 3 * self.d_model * self.moe.d_ff_expert
        return self.param_count() - self.n_layers * (routed_all - routed_active)


def pattern_repeat(base: Sequence[str], n_layers: int) -> tuple[str, ...]:
    out: list[str] = []
    while len(out) < n_layers:
        out.extend(base)
    return tuple(out[:n_layers])
