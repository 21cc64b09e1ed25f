"""Model assembly: init, the training forward and loss, prefill, paged
pools, paged decode.

The subset of ``repro/models/transformer.py`` for decoder stacks of
attention layers ("attn" and "local" kinds, dense MLPs).  Parameters are
a plain dict: ``embed``, ``final_norm``, optional ``lm_head``, and
``layers``, one dict per layer in pattern order (the reference stacks the
layers of each run and scans them; here a Python loop walks them).  Caches
and pools keep the reference's per-run stacked layout,
(run, ..., Hkv, hd), so they compare one to one.

The training forward remats each layer and each cross-entropy chunk with
``torch.utils.checkpoint`` (non-reentrant), where the reference wraps its
scan bodies in ``jax.checkpoint``; so a backward runs every layer's
forward, flash attention included, a second time.  Serving runs under
``torch.inference_mode`` and never goes through the training forward.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.backend import resolve_device
from . import layers as L
from .config import ModelConfig

__all__ = ["NOT_PORTED", "port_check", "init_model", "embed_inputs",
           "trunk_fwd", "model_fwd", "loss_fn", "prefill",
           "paged_arch_check", "init_paged_pools", "scatter_prefill_cache",
           "decode_step_paged"]

NOT_PORTED = ("ROADMAP.md, Queue 1 item 4: MoE, recurrent, enc-dec and "
              "frontend architectures")


def port_check(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for the parts of the zoo the port has not
    reached yet."""
    missing = []
    if cfg.moe is not None:
        missing.append("MoE")
    missing += sorted({k for k in cfg.pattern if k not in ("attn", "local")})
    if cfg.enc_dec is not None:
        missing.append("enc-dec")
    if cfg.frontend is not None:
        missing.append(f"{cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not "
                                  f"ported yet ({NOT_PORTED})")


# ---------------------------------------------------------------------- #
# Init
# ---------------------------------------------------------------------- #

def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """Random weights with the reference's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the numbers are
    not the JAX ones; ``convert.params_from_jax`` carries those over)."""
    port_check(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, V = cfg.d_model, cfg.vocab
    zeros = lambda: torch.zeros((D,), dtype=torch.float32, device=dev)
    embed = torch.randn((V, D), generator=gen, device=dev) / math.sqrt(D)
    params = {"embed": embed.to(torch.bfloat16), "final_norm": zeros(),
              "layers": [{"norm1": zeros(), "norm2": zeros(),
                          "attn": L.init_attention(gen, cfg),
                          "mlp": L.init_mlp(gen, cfg)}
                         for _ in cfg.pattern]}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, D, V)
    return params


# ---------------------------------------------------------------------- #
# Train / full-sequence forward
# ---------------------------------------------------------------------- #

def embed_inputs(params, cfg: ModelConfig, inputs: dict) -> torch.Tensor:
    """tokens (B,S) -> (B,S,D).  The scale is rounded to the embedding's
    dtype before the product, as JAX does with a weakly typed scalar."""
    x = params["embed"][inputs["tokens"]]
    return x * x.new_tensor(math.sqrt(cfg.d_model))


def _head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _runs(params, cfg: ModelConfig):
    """(kind, layer params of the run) for each run of identical kinds."""
    i = 0
    for kind, n in cfg.runs():
        yield kind, params["layers"][i:i + n]
        i += n


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward instead of saved."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def _layer_fwd(p, cfg: ModelConfig, kind: str, x):
    window = cfg.window if kind == "local" else None
    if cfg.parallel_block:
        # parallel residual: both sublayers read x (transformer.py:84-91)
        xn = L.rmsnorm(x, p["norm1"])
        return (x + L.attention_fwd(p["attn"], cfg, xn, window=window)
                + L.mlp_fwd(p["mlp"], cfg, L.rmsnorm(x, p["norm2"])))
    x = x + L.attention_fwd(p["attn"], cfg, L.rmsnorm(x, p["norm1"]),
                            window=window)
    return x + L.mlp_fwd(p["mlp"], cfg, L.rmsnorm(x, p["norm2"]))


def trunk_fwd(params, cfg: ModelConfig, inputs: dict) -> torch.Tensor:
    """Embeddings + layer stack (each layer rematted) + final norm ->
    hidden states (B, S, D)."""
    x = embed_inputs(params, cfg, inputs)
    for kind, layers in _runs(params, cfg):
        for p in layers:
            x = _remat(functools.partial(_layer_fwd, p, cfg, kind), x)
    return L.rmsnorm(x, params["final_norm"])


def model_fwd(params, cfg: ModelConfig, inputs: dict) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V) f32."""
    x = trunk_fwd(params, cfg, inputs)
    return (x @ _head(params, cfg).to(x.dtype)).float()


def _ce_chunk(x, labels, head):
    """Cross-entropy partial sums (nll, count) for one sequence chunk."""
    logits = (x @ head.to(x.dtype)).float()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def loss_fn(params, cfg: ModelConfig, batch: dict,
            ce_chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy over the batch (f32 scalar).

    The unembedding and softmax run over sequence chunks of ``ce_chunk``,
    each rematted, so the (B, S, V) logits are never held whole."""
    x = trunk_fwd(params, cfg, batch)
    labels = batch["labels"]
    head = _head(params, cfg)
    S = x.shape[1]
    if S % ce_chunk or S <= ce_chunk:
        nll, cnt = _ce_chunk(x, labels, head)
        return nll / torch.clamp_min(cnt, 1.0)
    nll = cnt = 0.0
    for s0 in range(0, S, ce_chunk):
        dn, dc = _remat(_ce_chunk, x[:, s0:s0 + ce_chunk],
                        labels[:, s0:s0 + ce_chunk], head)
        nll, cnt = nll + dn, cnt + dc
    return nll / torch.clamp_min(cnt, 1.0)


# ---------------------------------------------------------------------- #
# Prefill
# ---------------------------------------------------------------------- #


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, inputs: dict, s_max: int, *,
            last_pos=None, full_local_cache: bool = False):
    """Process the prompt; return (last-token logits (B,1,V) f32, cache,
    S).  ``cache`` holds one {"k", "v"} entry per run, (run, B, S_c, Hkv,
    hd) bf16, padded to ``s_max``.

    ``last_pos`` ((B,) int) selects each row's last real token, so
    right-padded prompts are safe: causality keeps the pads out of the real
    positions.  ``full_local_cache`` keeps windowed layers' caches at full
    length (the paged pools store them so and mask at read time)."""
    x = embed_inputs(params, cfg, inputs)
    B, S = x.shape[:2]
    cache = []
    for kind, layers in _runs(params, cfg):
        window = cfg.window if kind == "local" else None
        ks, vs = [], []
        for p in layers:
            y, ck, cv = L.attention_prefill(
                p["attn"], cfg, L.rmsnorm(x, p["norm1"]), window=window,
                keep_full=full_local_cache)
            x = x + y
            x = x + L.mlp_fwd(p["mlp"], cfg, L.rmsnorm(x, p["norm2"]))
            ks.append(ck)
            vs.append(cv)
        k, v = torch.stack(ks), torch.stack(vs)
        tgt = s_max if full_local_cache or kind != "local" \
            else min(cfg.window, s_max)
        if k.shape[2] < tgt:
            pad = (0, 0, 0, 0, 0, tgt - k.shape[2])
            k, v = F.pad(k, pad), F.pad(v, pad)
        cache.append({"k": k, "v": v})
    x = L.rmsnorm(x, params["final_norm"])
    if last_pos is None:
        xl = x[:, -1:]
    else:
        xl = x[torch.arange(B, device=x.device), last_pos][:, None]
    logits = (xl @ _head(params, cfg).to(x.dtype)).float()
    return logits, cache, S


# ---------------------------------------------------------------------- #
# Paged serving: block-pool cache / per-request-position decode
# ---------------------------------------------------------------------- #

def paged_arch_check(cfg: ModelConfig) -> None:
    """Paged serving covers pure-attention stacks (attn/local, no enc-dec).

    Recurrent kinds (rglru/rwkv6) carry positionless state that right-padded
    variable-length prefill would corrupt, and enc-dec needs per-request
    encoder outputs — neither fits the shared-pool layout."""
    bad = [k for k, _ in cfg.runs() if k not in ("attn", "local")]
    if bad or cfg.enc_dec:
        raise ValueError(
            f"paged serving supports attention-only decoder stacks; "
            f"got kinds {bad or ['enc_dec']}")


def init_paged_pools(cfg: ModelConfig, n_blocks: int, block_size: int, *,
                     device: str | torch.device = "cuda") -> list:
    """One k/v pool pair per run: (run, n_blocks, block_size, Hkv, hd)
    bf16.  Physical block 0 is the null block no request ever owns."""
    paged_arch_check(cfg)
    dev = resolve_device(device)
    shape = (n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros((n, *shape), dtype=torch.bfloat16, device=dev),
             "v": torch.zeros((n, *shape), dtype=torch.bfloat16, device=dev)}
            for _, n in cfg.runs()]


@torch.inference_mode()
def scatter_prefill_cache(pools: list, cache: list, blocks, block_size: int,
                          row: int = 0) -> list:
    """Copy one request's dense prefill cache (``prefill`` with
    ``full_local_cache=True``) into its physical blocks, in place.

    cache entries: (run, B, S_p, Hkv, hd) with S_p % block_size == 0;
    ``blocks``: the request's block ids, len == S_p // block_size."""
    for pool, ent in zip(pools, cache):
        n, _, S_p, Hkv, hd = ent["k"].shape
        if S_p % block_size:
            raise ValueError(f"prefill length {S_p} not a multiple of "
                             f"block_size {block_size}")
        nb = S_p // block_size
        if nb != len(blocks):
            raise ValueError(f"need {nb} blocks, got {len(blocks)}")
        idx = torch.as_tensor(np.asarray(blocks, np.int64),
                              device=pool["k"].device)
        pool["k"][:, idx] = ent["k"][:, row].reshape(n, nb, block_size,
                                                     Hkv, hd)
        pool["v"][:, idx] = ent["v"][:, row].reshape(n, nb, block_size,
                                                     Hkv, hd)
    return pools


@torch.inference_mode()
def decode_step_paged(params, cfg: ModelConfig, pools: list, block_tables,
                      tokens, pos):
    """One-token serve step over paged pools (updated in place).
    tokens: (B,1) int; block_tables: (B, max_blocks) int; pos: (B,) int.
    Returns (logits (B,1,V) f32, pools)."""
    x = embed_inputs(params, cfg, {"tokens": tokens})
    for ent, (kind, layers) in zip(pools, _runs(params, cfg)):
        window = cfg.window if kind == "local" else None
        for i, p in enumerate(layers):
            y, _, _ = L.paged_attention_decode(
                p["attn"], cfg, L.rmsnorm(x, p["norm1"]), ent["k"][i],
                ent["v"][i], block_tables, pos, window=window)
            x = x + y
            x = x + L.mlp_fwd(p["mlp"], cfg, L.rmsnorm(x, p["norm2"]))
    x = L.rmsnorm(x, params["final_norm"])
    logits = (x @ _head(params, cfg).to(x.dtype)).float()
    return logits, pools
