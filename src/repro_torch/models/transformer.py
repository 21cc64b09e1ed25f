"""Model assembly: init, the training forward and loss, prefill, the
dense decode, paged pools, paged decode.

The counterpart of ``repro/models/transformer.py`` for every kind of the
zoo: decoder stacks of attention layers ("attn", "local"), RG-LRU layers
("rglru") and RWKV-6 layers ("rwkv6", time mix and channel mix, no MLP),
each attention or RG-LRU layer followed by an MLP or a top-k MoE; an
encoder stack and per-layer cross-attention for enc-dec configs; and the
frontends' stub, precomputed embeddings as a prefix.  Parameters are a
plain dict: ``embed``, ``final_norm``, optional ``lm_head``, ``layers``,
one dict per layer in pattern order (the reference stacks the layers of
each run and scans them; here a Python loop walks them), and for enc-dec
``enc`` = {``layers``, ``final_norm``}.  Caches and pools keep the
reference's per-run stacked layout, (run, B, ...), so they compare one to
one.

Serving and training run every config: the dense attention stacks, the
MoE (autograd through the router's renormalised top-k gates and the
per-expert products), RG-LRU (through the log-step scan), RWKV-6 (the
WKV kernel's forward, the plain scan's autograd backward:
``kernels.wkv.wkv``), enc-dec (the cross-attention's gradient flows into
the encoder) and the frontends, whose prefix positions the loss skips.
So does the full-sequence forward (``model_fwd``).

The training forward remats each layer and each cross-entropy chunk with
``torch.utils.checkpoint`` (non-reentrant), where the reference wraps its
scan bodies in ``jax.checkpoint``; so a backward runs every layer's
forward, flash attention included, a second time.  Serving runs under
``torch.inference_mode`` and never goes through the training forward.

Serving and the forward also run on a model axis: ``tp``, the
``launch.mesh.Axis`` of this rank's model group (None: one rank), with
parameters from ``init_model(model=, m=)`` or ``convert.shard_params``.
The embedding's rows are split over the axis where M divides the
vocabulary (each rank looks up the ids it owns, then one all-reduce), the
tied head gives this rank's columns of the logits, all-gathered so that
every rank takes the same greedy token; where M does not divide it the
embedding and its tied head are replicated (whole logits, no collective).
Attention (on the query heads that the rank's columns of ``wq`` meet,
``sharding.rank_heads``) and the MLP return row-parallel partial sums,
all-reduced once a sublayer, and once for both in the parallel-residual
block; the MoE reduces inside its expert-parallel block.  Caches hold the
KV heads this rank's query heads read (ranks may share one, and hold
unequal counts: gpt-100m on M 8 holds 2 of its 12 a rank), but the dense
cache's sequence dim is split over the axis where M divides it (the
reference's sequence-parallel decode).  The
RG-LRU runs on the rank's R/M channels, its state and conv inputs in the
cache on them, and returns the whole output.  RWKV-6 runs its
time mix on the heads the rank's columns meet (their WKV state in the
cache; ``sharding.rwkv_heads``) and its
channel mix with the gate gathered over the axis; its carried rows
``x_tm``/``x_cm`` are whole on every rank.  The enc-dec encoder runs its
layers under the attention stack's rules, its output whole on every
rank, and the cross attention on the rank's heads, its cache of the
rank's KV heads over every source position.

Training runs on a model axis too (the reference's GSPMD forward and
backward over ``model``), with the axis's differentiated collectives
(``launch.mesh.Axis.copy_to``/``reduce_from``): ``reduce_from`` at the
embedding's lookup sum and at every row-parallel sum, ``copy_to`` on the
normed input of each attention and MLP sublayer and of the head, on
RWKV-6's token-shift mixes (one stack a sublayer) and on the encoder's
output, and on the q/k norms' weights, RWKV-6's ``u`` and the MoE
router's, replicated leaves that each rank reads on its own heads or
experts only (the other replicated leaves of a trained config, the RMS
norms and RWKV-6's ``mix``/``cm_mix``, act on replicated activations
ahead of a ``copy_to``, so their gradients are whole on every rank), and
on the RG-LRU's ``conv`` and ``lam`` (one stack).  RWKV-6's channel-mix
gate is gathered with ``gather_from``, whose backward keeps the rank's
slice; the RG-LRU's conv output, k and v cut inside a head, and a run's
layers that the axis splits are gathered with ``gather_to``, whose
backward sums the ranks' partial gradients.  The MoE takes its normed
input through ``copy_to`` and sums its experts' and its shared expert's
partial outputs with ``reduce_from``.  A frontend's prefix is
replicated: it joins the tokens' embeddings after their sum over the
axis.  The loss is a vocab-parallel cross-entropy: each rank's head
columns give its logits, and the max over the axis (detached), one sum
of the exponentials and of the gold logit from the rank that owns the
label's column give the loss; the (B, S, V) logits are never gathered.
A replicated head takes the plain cross-entropy on every rank, and its
hidden states no ``copy_to``; an untied head cut by its rows (the axis
divides ``d_model`` but not the vocabulary) sums the ranks' partial
logits over the axis, whole logits then the plain cross-entropy, its
hidden states through ``copy_to``.

Where the reference's fallback moves a sublayer's leaves to their other
matmul dim or replicates them (``layers.cuts`` reads it from their
shapes), a sublayer whose leaves that read its input are whole takes it
without ``copy_to`` (each rank's gradient of it is whole), and a
sublayer whose output is whole (gathered, or computed on every rank) is
not summed: each output is summed over the axis exactly once.  The
encoder's output enters through ``copy_to`` only where the cross
attention cuts it.
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
from .sharding import (cut_shard, layer_model_dims, param_model_dims,
                       rank_count, rank_heads, rwkv_heads)

__all__ = ["port_check", "init_model", "embed_inputs",
           "encoder_fwd", "trunk_fwd", "model_fwd", "loss_fn", "init_cache",
           "prefill", "decode_step", "paged_arch_check", "init_paged_pools",
           "scatter_prefill_cache", "decode_step_paged"]

KINDS = ("attn", "local", "rglru", "rwkv6")


def port_check(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a block kind the port does not
    have."""
    missing = sorted({k for k in cfg.pattern if k not in KINDS})
    if missing:
        raise NotImplementedError(f"{cfg.name}: block kinds {missing} are "
                                  f"not ported")


# ---------------------------------------------------------------------- #
# Init
# ---------------------------------------------------------------------- #

def _init_layer(gen, cfg: ModelConfig, kind: str, cross: bool, zeros):
    p = {"norm1": zeros(), "norm2": zeros()}
    if kind == "rwkv6":
        p["rwkv"] = L.init_rwkv6(gen, cfg)
        return p
    if kind == "rglru":
        p["rec"] = L.init_rglru(gen, cfg)
    else:
        p["attn"] = L.init_attention(gen, cfg)
    p["mlp"] = L.init_moe(gen, cfg) if cfg.moe else L.init_mlp(gen, cfg)
    if cross:
        p["norm_x"] = zeros()
        p["xattn"] = L.init_attention(gen, cfg, cross=True)
    return p


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: str | torch.device = "cuda", model: int = 1,
               m: int = 0) -> dict:
    """Random weights with the reference's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the numbers are
    not the JAX ones; ``convert.params_from_jax`` carries those over).
    With ``model`` > 1, rank ``m``'s share of the same weights
    (``convert.shard_params`` of the full model), cut as each layer is
    drawn, so that one full layer at most is held beside the shares.  On
    the ``meta`` device (the dry run) the leaves have their shapes and
    dtypes and nothing is drawn."""
    port_check(cfg)
    dev = resolve_device(device)
    gen = L.MetaDraws() if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    D, V = cfg.d_model, cfg.vocab
    zeros = lambda: torch.zeros((D,), dtype=torch.float32, device=dev)

    def cut(name, t):
        return cut_shard(t, param_model_dims({name: t}, model)[name],
                         model, m)

    def layer(kind, cross, run):
        # cut as param_model_dims decides it on the run's stacked shapes
        # (the RG-LRU's w_out lands on the run dim where M divides the run)
        p = _init_layer(gen, cfg, kind, cross, zeros)
        if model == 1:
            return p
        return _tree_cut(p, layer_model_dims(p, model, run), model, m)

    embed = L.randn(gen, (V, D)) / math.sqrt(D)
    cross = cfg.enc_dec is not None
    params = {"embed": cut("embed", embed.to(torch.bfloat16)),
              "final_norm": zeros()}
    del embed
    params["layers"] = [layer(kind, cross, n) for kind, n in cfg.runs()
                        for _ in range(n)]
    if not cfg.tie_embeddings:
        params["lm_head"] = cut("lm_head", L.dense_init(gen, D, V))
    if cross:
        n_enc = cfg.enc_dec.n_enc_layers
        params["enc"] = {
            "layers": [layer("attn", False, n_enc) for _ in range(n_enc)],
            "final_norm": zeros()}
    return params


def _tree_cut(tree: dict, dims: dict, model: int, m: int) -> dict:
    return {k: _tree_cut(v, dims[k], model, m) if isinstance(v, dict)
            else cut_shard(v, dims[k], model, m) for k, v in tree.items()}


# ---------------------------------------------------------------------- #
# Train / full-sequence forward
# ---------------------------------------------------------------------- #

def _vocab_axis(cfg: ModelConfig, tp):
    """``tp`` where it splits the vocabulary (the embedding's rows and a
    tied head's columns, or an untied head's columns), else None: one rank,
    or a vocabulary the axis does not divide, whose embedding and tied head
    are replicated (``sharding.param_model_dims``)."""
    return tp if tp is not None and cfg.vocab % tp.size == 0 else None


def embed_inputs(params, cfg: ModelConfig, inputs: dict,
                 tp=None) -> torch.Tensor:
    """tokens (B,S), and the frontends' ``embeds`` (B,P,D) as a prefix ->
    (B,P+S,D).  The scale is rounded to the embedding's dtype before the
    product, as JAX does with a weakly typed scalar.  On a model axis
    ``tp`` that divides the vocabulary the embedding holds this rank's
    rows of it: the ids outside them look up zeros, and one all-reduce
    adds the ranks' rows (each id has one owner, so the sum is exact; the
    gradient of a row is its owner's).  A replicated embedding looks up
    every id on every rank, with no sum."""
    emb, ids = params["embed"], inputs["tokens"]
    tp = _vocab_axis(cfg, tp)
    if tp is None:
        x = emb[ids]
    else:
        n = emb.shape[0]
        loc = ids - tp.index * n
        own = (loc >= 0) & (loc < n)
        x = emb[loc.clamp(0, n - 1)] * own[..., None].to(emb.dtype)
    x = x * x.new_tensor(math.sqrt(cfg.d_model))
    if tp is not None:
        x = tp.reduce_from(x)
    if "embeds" in inputs:
        x = torch.cat([inputs["embeds"].to(x.dtype), x], 1)
    return x


def _head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _head_rows(params, cfg: ModelConfig, tp):
    """``tp`` where it cuts an untied head by its rows (the reference's
    fallback where the axis divides ``d_model`` but not the vocabulary),
    else None."""
    if tp is None or cfg.tie_embeddings \
            or params["lm_head"].shape[0] == cfg.d_model:
        return None
    return tp


def _row_logits(x, head, tp):
    """Whole (…, V) f32 logits of ``x`` from this rank's rows of the head:
    the rank's slice of ``x`` times them, partial logits in f32, summed
    over the axis ``tp`` (``reduce_from``: the gradient passes through to
    each rank's part)."""
    n = head.shape[0]
    part = x[..., tp.index * n:(tp.index + 1) * n] @ head.to(x.dtype)
    return tp.reduce_from(part.float())


def _logits(params, cfg: ModelConfig, x, tp=None) -> torch.Tensor:
    """(…, V) f32 logits of hidden states ``x``; on a model axis that
    splits the vocabulary this rank's columns, all-gathered in rank order
    (a replicated head gives them whole, a head cut by rows the sum of
    the ranks' partial logits)."""
    rows = _head_rows(params, cfg, tp)
    if rows is not None:
        return _row_logits(x, params["lm_head"], rows)
    tp = _vocab_axis(cfg, tp)
    logits = (x @ _head(params, cfg).to(x.dtype)).float()
    return logits if tp is None else tp.all_gather(logits, dim=-1)


def _psum(tp, y, p, cfg: ModelConfig):
    """Sublayer ``p``'s output ``y``, all-reduced over the model axis
    where it is a row-parallel partial sum (``layers.cuts``; the gradient
    passes through to each rank's part); a whole output as it is."""
    return y if tp is None or not L.cuts(p, cfg)[1] else tp.reduce_from(y)


def _copy(tp, x, p=None, cfg: ModelConfig | None = None):
    """A replicated ``x`` entering this rank's shard of the work of
    sublayer ``p`` through a cut leaf (``layers.cuts``): its gradient, a
    partial sum on each rank, summed over the model axis.  Where ``p``'s
    leaves that read it are whole, ``x`` as it is: each rank's gradient
    is whole.  Without ``p``, ``x`` enters a cut product."""
    if tp is None or (p is not None and not L.cuts(p, cfg)[0]):
        return x
    return tp.copy_to(x)


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


def _ffn(p, cfg: ModelConfig, x, tp=None):
    """The MLP or MoE sublayer, pre-norm, whole on every rank (a partial
    sum summed over the model axis; the MoE's input enters its cut
    products through ``copy_to`` inside it)."""
    xn = L.rmsnorm(x, p["norm2"])
    if cfg.moe:
        return L.moe_fwd(p["mlp"], cfg, xn, tp=tp)
    return _psum(tp, L.mlp_fwd(p["mlp"], cfg, _copy(tp, xn, p["mlp"], cfg),
                               tp), p["mlp"], cfg)


def _layer_fwd(p, cfg: ModelConfig, kind: str, x, enc_out=None,
               causal: bool = True, tp=None):
    if kind == "rwkv6":
        x = x + _psum(tp, L.rwkv6_fwd(p["rwkv"], cfg,
                                      L.rmsnorm(x, p["norm1"]), tp=tp),
                      p["rwkv"], cfg)
        return x + L.rwkv6_channel_mix(p["rwkv"], cfg,
                                       L.rmsnorm(x, p["norm2"]), tp)
    if kind == "rglru":
        y, _ = L.rglru_fwd(p["rec"], cfg, _copy(
            tp, L.rmsnorm(x, p["norm1"]), p["rec"], cfg), tp=tp)
        x = x + y
    else:
        window = cfg.window if kind == "local" else None
        pa = p["attn"]
        if cfg.parallel_block and enc_out is None and not cfg.moe:
            # parallel residual: both sublayers read x, and their partial
            # sums are added before one all-reduce (transformer.py:84-91)
            ya = L.attention_fwd(pa, cfg, _copy(tp, L.rmsnorm(
                x, p["norm1"]), pa, cfg), causal=causal, window=window,
                tp=tp)
            ym = L.mlp_fwd(p["mlp"], cfg, _copy(tp, L.rmsnorm(
                x, p["norm2"]), p["mlp"], cfg), tp)
            if L.cuts(pa, cfg)[1] and L.cuts(p["mlp"], cfg)[1]:
                return x + tp.reduce_from(ya + ym)
            return x + (_psum(tp, ya, pa, cfg)
                        + _psum(tp, ym, p["mlp"], cfg))
        x = x + _psum(tp, L.attention_fwd(
            pa, cfg, _copy(tp, L.rmsnorm(x, p["norm1"]), pa, cfg),
            causal=causal, window=window, tp=tp), pa, cfg)
    if enc_out is not None:
        # on a model axis enc_out arrives through one copy_to where the
        # cross attention cuts it (trunk_fwd), which sums every layer's
        # partial gradient at once
        px = p["xattn"]
        x = x + _psum(tp, L.attention_fwd(
            px, cfg, _copy(tp, L.rmsnorm(x, p["norm_x"]), px, cfg),
            kv_src=enc_out, tp=tp), px, cfg)
    return x + _ffn(p, cfg, x, tp)


def encoder_fwd(params, cfg: ModelConfig, src_embeds,
                tp=None) -> torch.Tensor:
    """The enc-dec encoder: ``src_embeds`` (B,Ss,D), rounded to bf16 as
    the reference's, through its non-causal attention layers and final
    norm.  The layers' carry keeps the weights' dtype from the first layer
    on, as the reference's layer scan requires: an f32 model promotes the
    rounded input to f32 before the first norm (the reference's scan
    refuses an f32 model outright).  On a model axis ``tp`` the layers
    run on this rank's heads and features, and the output is whole on
    every rank."""
    x = src_embeds.to(torch.bfloat16)
    x = x.to(torch.promote_types(
        x.dtype, params["enc"]["layers"][0]["attn"]["wq"].dtype))
    for p in params["enc"]["layers"]:
        x = _remat(functools.partial(_layer_fwd, p, cfg, "attn",
                                     causal=False, tp=tp), x)
    return L.rmsnorm(x, params["enc"]["final_norm"])


def trunk_fwd(params, cfg: ModelConfig, inputs: dict,
              tp=None) -> torch.Tensor:
    """Embeddings (``embeds`` prefix included), the encoder for enc-dec
    (``src_embeds``), the layer stack (each layer rematted) and the final
    norm -> hidden states (B, S, D).  On a model axis ``tp``, this rank's
    shard of the work, every rank's hidden states equal; a gradient flows
    through the axis's collectives."""
    port_check(cfg)
    enc_out = None
    if cfg.enc_dec:
        enc_out = _copy(tp, encoder_fwd(params, cfg, inputs["src_embeds"],
                                        tp), params["layers"][0]["xattn"],
                        cfg)
    x = embed_inputs(params, cfg, inputs, tp)
    for kind, layers in _runs(params, cfg):
        for p in layers:
            x = _remat(functools.partial(_layer_fwd, p, cfg, kind,
                                         enc_out=enc_out, tp=tp), x)
    return L.rmsnorm(x, params["final_norm"])


def model_fwd(params, cfg: ModelConfig, inputs: dict,
              tp=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V) f32."""
    return _logits(params, cfg, trunk_fwd(params, cfg, inputs, tp), tp)


def _ce_chunk(x, labels, head, tp=None, rows=None):
    """Cross-entropy partial sums (nll, count) for one sequence chunk.  On
    a model axis ``tp`` ``head`` holds this rank's vocabulary columns: the
    max over the axis (detached: the log-sum-exp does not depend on it),
    then one sum over the axis of each row's exponentials and of its gold
    logit, which only the rank owning the label's column contributes.  On
    a model axis ``rows`` that cuts ``head`` by rows the whole logits are
    the sum of the ranks' partial logits (:func:`_row_logits`), and the
    cross-entropy is the plain one."""
    logits = _row_logits(x, head, rows) if rows is not None \
        else (x @ head.to(x.dtype)).float()
    mask = (labels >= 0).float()
    if tp is None:
        lse = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1,
                            labels.clamp_min(0)[..., None])[..., 0]
        return ((lse - gold) * mask).sum(), mask.sum()
    n = logits.shape[-1]
    loc = labels - tp.index * n
    own = (loc >= 0) & (loc < n)
    m = tp.pmax(logits.detach().amax(-1))
    gold = torch.gather(logits, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
    sums = tp.reduce_from(torch.stack(
        [torch.exp(logits - m[..., None]).sum(-1), gold * own], -1))
    lse = m + torch.log(sums[..., 0])
    return ((lse - sums[..., 1]) * mask).sum(), mask.sum()


def loss_fn(params, cfg: ModelConfig, batch: dict, ce_chunk: int = 512,
            tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy over the batch (f32 scalar).

    The unembedding and softmax run over sequence chunks of ``ce_chunk``,
    each rematted, so the (B, S, V) logits are never held whole.  On a
    model axis ``tp`` (``params`` this rank's shard), the vocab-parallel
    cross-entropy of :func:`_ce_chunk` where the axis splits the
    vocabulary, else the plain one on every rank: of the summed partial
    logits where it cuts an untied head by rows (the hidden states enter
    through ``copy_to``: each rank's gradient of them holds its slice),
    else of a replicated head, whose hidden states skip ``copy_to`` (each
    rank's gradient of them is whole, and a sum would count it M times);
    every rank returns the same loss.  A
    frontend's ``embeds`` prefix positions are dropped before the loss,
    which runs over the token positions only (the reference's
    :173-174)."""
    x = trunk_fwd(params, cfg, batch, tp)
    if "embeds" in batch:
        x = x[:, batch["embeds"].shape[1]:]
    rows = _head_rows(params, cfg, tp)
    tp = _vocab_axis(cfg, tp)
    x = _copy(rows if rows is not None else tp, x)
    labels = batch["labels"]
    head = _head(params, cfg)
    S = x.shape[1]
    if S % ce_chunk or S <= ce_chunk:
        nll, cnt = _ce_chunk(x, labels, head, tp, rows)
        return nll / torch.clamp_min(cnt, 1.0)
    nll = cnt = 0.0
    for s0 in range(0, S, ce_chunk):
        dn, dc = _remat(_ce_chunk, x[:, s0:s0 + ce_chunk],
                        labels[:, s0:s0 + ce_chunk], head, tp, rows)
        nll, cnt = nll + dn, cnt + dc
    return nll / torch.clamp_min(cnt, 1.0)


# ---------------------------------------------------------------------- #
# Serving: cache init / prefill / dense decode
# ---------------------------------------------------------------------- #

def _cache_len(cfg: ModelConfig, kind: str, s_max: int) -> int:
    return min(cfg.window, s_max) if kind == "local" else s_max


def _seq_sharded(tp, s_c: int) -> bool:
    """The dense cache's layout on a model axis: this rank's slice of the
    sequence (every KV head) where the axis divides its length ``s_c``
    (the reference's ``_sp_decode_ctx``), else this rank's KV heads."""
    return tp is not None and tp.size > 1 and s_c % tp.size == 0


def init_cache(cfg: ModelConfig, B: int, s_max: int, src_len: int = 0, *,
               device: str | torch.device = "cuda", tp=None) -> list:
    """One zero cache entry per run, stacked on the run dim: attention
    {"k", "v"} (n, B, S_c, Hkv, hd) bf16 (S_c = min(window, s_max) for
    windowed runs), and for enc-dec {"xk", "xv"} (n, B, src_len, Hkv, hd)
    bf16; RG-LRU {"h"} (n, B, R) f32 and {"conv"} (n, B, 3, R) bf16;
    RWKV-6 {"S"} (n, B, H, hd, hd) f32 and {"x_tm", "x_cm"} (n, B, D)
    bf16.  On a model axis ``tp`` an attention entry is (n, B, S_c/M,
    Hkv, hd) where M divides S_c, else (n, B, S_c, h, hd) with h the KV
    heads that the rank's query heads read (``sharding.rank_heads``: Hkv/M
    where M divides the heads, else one or more, which ranks may share);
    the cross entry (n, B, src_len, h, hd), RWKV-6's state (n, B, h, hd,
    hd) of the heads that the rank's columns meet (``sharding.rwkv_heads``:
    H/M where M divides them, else one or more, which ranks may share), and
    the RG-LRU's h and conv of R/M channels."""
    port_check(cfg)
    dev = resolve_device(device)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    M = 1 if tp is None else tp.size
    R = rank_count(cfg.d_rnn or cfg.d_model, M)
    h_kv = L.heads(cfg, tp).nkv
    n_rwkv = rwkv_heads(cfg, M, 0 if tp is None else tp.index).nh
    cache = []
    for kind, n in cfg.runs():
        if kind == "rwkv6":
            hd = cfg.rwkv_head_dim
            cache.append({
                "S": torch.zeros((n, B, n_rwkv, hd, hd),
                                 dtype=torch.float32, device=dev),
                "x_tm": torch.zeros((n, B, cfg.d_model), **bf16),
                "x_cm": torch.zeros((n, B, cfg.d_model), **bf16)})
        elif kind == "rglru":
            cache.append({"h": torch.zeros((n, B, R), dtype=torch.float32,
                                           device=dev),
                          "conv": torch.zeros((n, B, 3, R), **bf16)})
        else:
            s_c = _cache_len(cfg, kind, s_max)
            shape = (n, B, s_c, h_kv, cfg.head_dim)
            if _seq_sharded(tp, s_c):
                shape = (n, B, s_c // tp.size, cfg.n_kv_heads, cfg.head_dim)
            ent = {"k": torch.zeros(shape, **bf16),
                   "v": torch.zeros(shape, **bf16)}
            if cfg.enc_dec:
                xshape = (n, B, src_len, h_kv, cfg.head_dim)
                ent["xk"] = torch.zeros(xshape, **bf16)
                ent["xv"] = torch.zeros(xshape, **bf16)
            cache.append(ent)
    return cache


def _layer_prefill(p, cfg: ModelConfig, kind: str, x, enc_out,
                   keep_full: bool, tp=None):
    """(x_out, cache entry) for one layer (this rank's KV heads on a model
    axis)."""
    if kind == "rwkv6":
        xn = L.rmsnorm(x, p["norm1"])
        y, st = L.rwkv6_fwd(p["rwkv"], cfg, xn, return_state=True, tp=tp)
        x = x + _psum(tp, y, p["rwkv"], cfg)
        xn2 = L.rmsnorm(x, p["norm2"])
        x = x + L.rwkv6_channel_mix(p["rwkv"], cfg, xn2, tp)
        return x, {"S": st["S"], "x_tm": xn[:, -1].to(torch.bfloat16),
                   "x_cm": xn2[:, -1].to(torch.bfloat16)}
    if kind == "rglru":
        y, h, conv = L.rglru_prefill(p["rec"], cfg, L.rmsnorm(x, p["norm1"]),
                                     tp)
        x = x + y
        return x + _ffn(p, cfg, x, tp), {"h": h,
                                         "conv": conv.to(torch.bfloat16)}
    y, ck, cv = L.attention_prefill(
        p["attn"], cfg, L.rmsnorm(x, p["norm1"]),
        window=cfg.window if kind == "local" else None, keep_full=keep_full,
        tp=tp)
    x = x + _psum(tp, y, p["attn"], cfg)
    ent = {"k": ck, "v": cv}
    if enc_out is not None:
        ent["xk"], ent["xv"] = L.cross_kv(p["xattn"], cfg, enc_out, tp)
        x = x + _psum(tp, L.attention_fwd(
            p["xattn"], cfg, L.rmsnorm(x, p["norm_x"]), kv_src=enc_out,
            tp=tp), p["xattn"], cfg)
    return x + _ffn(p, cfg, x, tp), ent


def _seq_slice(tp, t, s_c: int, cfg: ModelConfig):
    """A run's cache (n, B, s_c, h, hd) of the KV heads that this rank's
    query heads read (``sharding.rank_heads``) -> its slice of the
    sequence with every KV head, (n, B, s_c/M, Hkv, hd): one all-gather
    over the model axis of the ranks' heads, padded to the largest count
    (none where every rank computes every head).  Each KV head is taken
    from the first rank that reads it (the ranks that share one hold
    equal values)."""
    n = s_c // tp.size
    if cfg.q_dim % tp.size:         # every rank computes every head
        return t[:, :, tp.index * n:(tp.index + 1) * n].contiguous()
    shares = [rank_heads(cfg, tp.size, r) for r in range(tp.size)]
    h = max(sh.nkv for sh in shares)
    t = tp.all_gather(F.pad(t, (0, 0, 0, h - t.shape[3])), dim=3)
    idx = [next(r * h + j - sh.kv0 for r, sh in enumerate(shares)
                if sh.kv0 <= j < sh.kv0 + sh.nkv)
           for j in range(cfg.n_kv_heads)]
    if idx != list(range(t.shape[3])):
        t = t[:, :, :, idx]
    return t[:, :, tp.index * n:(tp.index + 1) * n].contiguous()


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, inputs: dict, s_max: int, *,
            last_pos=None, full_local_cache: bool = False, tp=None,
            seq_shard: bool = True):
    """Process the prompt; return (last-token logits (B,1,V) f32, cache,
    S).  ``inputs``: ``tokens`` (B,S), the frontends' ``embeds`` (B,P,D)
    as a prefix (S then counts them), and for enc-dec ``src_embeds``
    (B,Ss,D) for the encoder.  ``cache`` holds one entry per run in the
    layout of :func:`init_cache` with src_len Ss; attention entries are
    padded to ``s_max``.

    ``last_pos`` ((B,) int) selects each row's last real token, so
    right-padded prompts are safe: causality keeps the pads out of the real
    positions.  ``full_local_cache`` keeps windowed layers' caches at full
    length (the paged pools store them so and mask at read time).

    On a model axis ``tp`` the cache is in :func:`init_cache`'s layout;
    ``seq_shard`` False keeps every run's entry on this rank's KV heads
    (the paged pools' split)."""
    enc_out = None
    if cfg.enc_dec:
        enc_out = encoder_fwd(params, cfg, inputs["src_embeds"], tp)
    x = embed_inputs(params, cfg, inputs, tp)
    B, S = x.shape[:2]
    cache = []
    for kind, layers in _runs(params, cfg):
        ents = []
        for p in layers:
            x, ent = _layer_prefill(p, cfg, kind, x, enc_out,
                                    full_local_cache, tp)
            ents.append(ent)
        ent = {k: torch.stack([e[k] for e in ents]) for k in ents[0]}
        if kind in ("attn", "local"):
            tgt = s_max if full_local_cache \
                else _cache_len(cfg, kind, s_max)
            if ent["k"].shape[2] < tgt:
                pad = (0, 0, 0, 0, 0, tgt - ent["k"].shape[2])
                ent["k"], ent["v"] = F.pad(ent["k"], pad), F.pad(ent["v"],
                                                                 pad)
            if seq_shard and _seq_sharded(tp, tgt):
                ent["k"] = _seq_slice(tp, ent["k"], tgt, cfg)
                ent["v"] = _seq_slice(tp, ent["v"], tgt, cfg)
        cache.append(ent)
    x = L.rmsnorm(x, params["final_norm"])
    if last_pos is None:
        xl = x[:, -1:]
    else:
        xl = x[torch.arange(B, device=x.device), last_pos][:, None]
    return _logits(params, cfg, xl, tp), cache, S


def _layer_decode(p, cfg: ModelConfig, kind: str, x, ent: dict, i: int,
                  pos: int, tp=None, seq_shard: bool = False):
    """One layer's decode step; writes layer ``i`` of the run's cache
    entry ``ent`` in place (an attention run's split over the sequence
    where ``seq_shard``)."""
    if kind == "rwkv6":
        xn = L.rmsnorm(x, p["norm1"])
        y, st = L.rwkv6_decode(p["rwkv"], cfg, xn,
                               {"S": ent["S"][i],
                                "x_tm": ent["x_tm"][i].to(xn.dtype)}, tp)
        x = x + _psum(tp, y, p["rwkv"], cfg)
        xn2 = L.rmsnorm(x, p["norm2"])
        y2, x_cm = L.rwkv6_channel_mix_decode(p["rwkv"], cfg, xn2,
                                              ent["x_cm"][i].to(xn2.dtype),
                                              tp)
        ent["S"][i] = st["S"]
        ent["x_tm"][i] = st["x_tm"].to(torch.bfloat16)
        ent["x_cm"][i] = x_cm.to(torch.bfloat16)
        return x + y2
    if kind == "rglru":
        y, h, conv = L.rglru_decode(p["rec"], cfg, L.rmsnorm(x, p["norm1"]),
                                    ent["h"][i], ent["conv"][i], tp)
        ent["h"][i] = h
        ent["conv"][i] = conv.to(torch.bfloat16)
        x = x + y
        return x + _ffn(p, cfg, x, tp)
    y, _, _ = L.attention_decode(p["attn"], cfg, L.rmsnorm(x, p["norm1"]),
                                 ent["k"][i], ent["v"][i], pos,
                                 windowed=kind == "local", tp=tp,
                                 seq_shard=seq_shard)
    x = x + _psum(tp, y, p["attn"], cfg)
    if "xk" in ent:
        x = x + _psum(tp, L.cross_attention_decode(
            p["xattn"], cfg, L.rmsnorm(x, p["norm_x"]), ent["xk"][i],
            ent["xv"][i], tp), p["xattn"], cfg)
    return x + _ffn(p, cfg, x, tp)


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, cache: list, tokens, pos,
                tp=None, s_max: int | None = None):
    """One-token serve step over the dense cache of :func:`prefill` or
    :func:`init_cache`, updated in place.  tokens: (B,1) int; pos: the
    number of tokens already in the cache, one for the whole batch (an int
    or a 0-d tensor).  Returns (logits (B,1,V) f32, cache).  On a model
    axis ``s_max``, the length the cache was made for, gives each
    attention run's layout (:func:`init_cache`): a rank's cache cannot
    say it where every rank holds the one KV head."""
    pos = int(pos)
    attn = [k in ("attn", "local") for k, _ in cfg.runs()]
    if tp is not None and tp.size > 1 and any(attn) and s_max is None:
        raise ValueError(f"{cfg.name}: a dense decode on a model axis takes "
                         f"the prefill's s_max, which gives the cache's "
                         f"layout")
    x = embed_inputs(params, cfg, {"tokens": tokens}, tp)
    for ent, a, (kind, layers) in zip(cache, attn, _runs(params, cfg)):
        sp = a and s_max is not None \
            and _seq_sharded(tp, _cache_len(cfg, kind, s_max))
        for i, p in enumerate(layers):
            x = _layer_decode(p, cfg, kind, x, ent, i, pos, tp, sp)
    x = L.rmsnorm(x, params["final_norm"])
    return _logits(params, cfg, x, tp), cache


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
                     device: str | torch.device = "cuda", tp=None) -> list:
    """One k/v pool pair per run: (run, n_blocks, block_size, Hkv, hd)
    bf16.  Physical block 0 is the null block no request ever owns.  On a
    model axis ``tp``, the KV heads that this rank's query heads read
    (``sharding.rank_heads``; their count may differ across ranks): as
    in the reference's ``paged_pool_shardings``, only the KV-head dim
    splits, since any request's blocks live anywhere in the pool."""
    paged_arch_check(cfg)
    dev = resolve_device(device)
    Hkv = L.heads(cfg, tp).nkv
    shape = (n_blocks, block_size, Hkv, cfg.head_dim)
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
                      tokens, pos, tp=None):
    """One-token serve step over paged pools (updated in place).
    tokens: (B,1) int; block_tables: (B, max_blocks) int; pos: (B,) int.
    Returns (logits (B,1,V) f32, pools)."""
    x = embed_inputs(params, cfg, {"tokens": tokens}, tp)
    for ent, (kind, layers) in zip(pools, _runs(params, cfg)):
        window = cfg.window if kind == "local" else None
        for i, p in enumerate(layers):
            y, _, _ = L.paged_attention_decode(
                p["attn"], cfg, L.rmsnorm(x, p["norm1"]), ent["k"][i],
                ent["v"][i], block_tables, pos, window=window, tp=tp)
            x = x + _psum(tp, y, p["attn"], cfg)
            x = x + _ffn(p, cfg, x, tp)
    x = L.rmsnorm(x, params["final_norm"])
    return _logits(params, cfg, x, tp), pools
