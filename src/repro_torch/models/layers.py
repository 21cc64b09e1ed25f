"""Neural building blocks in PyTorch: the counterparts of
``repro/models/layers.py`` (attention, self and cross, the MLP, the dense
MoE, the RG-LRU recurrent block, and RWKV-6's time and channel mix).

Functions take and return tensors in the JAX package's layouts, and
parameters are plain dicts of tensors with the JAX names.  Numerics follow
the reference step by step: f32 statistics in ``rmsnorm``, f32 rope angles,
f32 softmax, the finite -1e30 mask, gelu with the tanh approximation
(``jax.nn.gelu``'s default).

Attention goes through :func:`chunked_attention`: on a CUDA tensor always
the Hopper flash kernels (forward, and backward under autograd), whatever
the sequence length; on a CPU tensor the same dispatch as the reference
(the naive oracle, differentiated by autograd, for lengths that are not a
multiple of the chunk, else the kernels' plain versions).

RWKV-6's time mix runs the chunked WKV recurrence through
:func:`~repro_torch.kernels.wkv.wkv`: the Hopper kernel on a CUDA tensor,
the reference's ``_wkv_chunk_scan`` on a CPU one, and where a gradient is
taken, autograd through that plain scan, recomputed in the backward (the
reference's own gradient: XLA's autodiff of its jnp scan).

The MoE computes the reference's ``lax.ragged_dot`` (XLA, not Pallas) as
one ``torch.matmul`` per non-empty expert on its slice of the
expert-sorted tokens; the group sizes are read on the host once per token
block (``moe_fwd.host_syncs`` counts the reads).  The RG-LRU computes the
reference's ``lax.associative_scan`` as a log-step (Hillis-Steele) scan
on the same (a, b) combine: ceil(log2 S) elementwise passes, with no
running product of the decays, which would underflow f32.

The paged and dense decodes write their caches in place and return them,
where the JAX versions return updated copies.

On a model axis (``tp``, a ``launch.mesh.Axis`` over the M ranks of a
model group, or None) each rank holds its shard of the parameters
(``sharding.param_model_dims``): the attention layers, self and cross,
run on the query heads that its Q/M columns of ``wq`` meet
(``sharding.rank_heads``: Hq/M heads where M divides them; else q is
gathered by columns, ``_q``, and a head cut between two ranks is computed
on both) and the KV heads they read (``wk``/``wv``'s columns where M
divides the KV heads; else k and v gathered from the reference's cut
inside a head, ``_kv``), and return the rank's columns of the output
times its rows of ``wo`` (``_out``), a partial sum, as ``mlp_fwd`` on
its feature slice does, and RWKV-6's time mix on the heads its columns
meet (``sharding.rwkv_heads``: H/M where M divides them, else a head cut
between two ranks computed on both from the gathered columns; the WKV
kernel and state on those heads) with its ``w_o`` rows; the caller adds
what it can and all-reduces once.  RWKV-6's channel mix returns the
whole output: its gate, split by columns, is gathered over the axis.  So
does the RG-LRU, on R/M channels (its conv output gathered for the gate
products, ``w_out`` by rows or by columns: ``_rglru_out``).
The dense decode attends a cache whose sequence dim is sharded over the
axis through the reference's log-sum-exp combine (``_cache_attend_sp``),
and the MoE runs
the reference's expert-parallel block (``_moe_block_ep``: E/M experts a
rank, capacity-bounded local dispatch, one sum over the axis).

Where the axis does not divide the dim a leaf's rule cuts, the
reference's fallback moves the leaf to its other matmul dim or
replicates it, and each product reads that cut from the leaf's shape: a
whole input times a leaf's rows gives a partial sum (``_whole`` adds it
over the axis), times its columns the rank's columns of the output
(``_gathered``), times a whole leaf a whole output on every rank.  Then
a ``wq`` not cut by columns gives every rank every head, whole q, k and
v and a whole output; the MLP by rows and columns a whole output; a MoE
whose experts the axis does not divide the dense block on every rank
(an expert cut by its features: the rank's columns of every expert's
hidden, gathered whole for ``w_out``'s columns, or times its rows of a
whole ``w_out``, a partial sum); a whole RG-LRU or RWKV-6 every channel
or head.  :func:`cuts` tells the caller which sublayers take their input
through ``copy_to`` and return a partial sum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.backend import on_card
from ..kernels.flash_attention import NEG_INF
from ..kernels.ops import flash_attention, wkv
from ..kernels.wkv import CHUNK
from .config import ModelConfig
from .sharding import RankHeads, RwkvHeads, rank_heads, rwkv_heads

__all__ = ["heads", "rmsnorm", "rope", "dense_init", "init_attention",
           "naive_attention", "chunked_attention", "attention_fwd",
           "attention_prefill", "attention_decode", "paged_attention_decode",
           "cross_kv", "cross_attention_decode", "init_mlp", "mlp_fwd",
           "MOE_CHUNK", "init_moe", "moe_fwd", "init_rglru", "linear_scan",
           "rglru_fwd", "rglru_prefill", "rglru_decode", "init_rwkv6", "rwkv6_fwd",
           "rwkv6_channel_mix", "rwkv6_channel_mix_decode", "rwkv6_decode"]


# ---------------------------------------------------------------------- #
# Small pieces
# ---------------------------------------------------------------------- #

def heads(cfg: ModelConfig, tp) -> RankHeads:
    """This rank's :class:`~.sharding.RankHeads` on the model axis ``tp``:
    the query heads that its columns of ``wq`` meet and the KV heads they
    read (every head where ``tp`` is None)."""
    return rank_heads(cfg) if tp is None else rank_heads(cfg, tp.size,
                                                          tp.index)


def cuts(p: dict, cfg: ModelConfig) -> tuple[bool, bool]:
    """How sublayer ``p`` meets the model axis, read from its leaves'
    shapes: (whether a product reads its whole input through a cut leaf,
    so that each rank's gradient of that input is partial and the input
    enters through ``copy_to``; whether its output is a partial sum, its
    output projection cut by rows, which the caller adds over the axis
    once).  Attention (self or cross), the MLP, the RG-LRU block (which
    returns a whole output) and RWKV-6's time mix (whose token-shift
    mixes enter through ``copy_to`` inside it); a MoE takes care of both
    itself.  Whole leaves, as on one rank: (False, False)."""
    D = cfg.d_model
    if "wq" in p:
        w_in, w_out, mid = p["wq"], p["wo"], cfg.q_dim
    elif "wi" in p:
        w_in, w_out, mid = p["wi"], p["wo"], cfg.d_ff
    elif "w_x" in p:
        return tuple(p["w_x"].shape) != (D, p["conv"].shape[1]), False
    elif "w_o" in p:
        return False, p["w_o"].shape[0] < D
    else:
        return False, False
    return tuple(w_in.shape) != (D, mid), w_out.shape[0] < mid


def _whole(tp, x, *ws):
    """``x @ w`` for each of ``ws``, whole on every rank: ``x`` is whole
    (through ``copy_to`` where a ``w`` is cut), each ``w`` whole or this
    rank's rows (the reference's "col" leaf moved to rows), whose product
    with the rank's slice of ``x`` is a partial sum; those are added over
    the axis ``tp`` in one all-reduce of them all, flattened (its backward
    passes each gradient through)."""
    cut = [tp is not None and w.shape[0] < x.shape[-1] for w in ws]
    outs = [_mm(x[..., tp.index * w.shape[0]:(tp.index + 1) * w.shape[0]],
                w) if c else _mm(x, w) for w, c in zip(ws, cut)]
    parts = [o for o, c in zip(outs, cut) if c]
    if not parts:
        return outs
    flat = tp.reduce_from(torch.cat([t.reshape(-1) for t in parts]))
    summed = iter([f.view(t.shape) for f, t in
                   zip(flat.split([t.numel() for t in parts]), parts)])
    return [next(summed) if c else o for o, c in zip(outs, cut)]


def _gathered(tp, h, w, d: int):
    """``h @ w`` whole on every rank, of ``h`` (…, K) whole and ``w`` (K,
    d) whole or this rank's columns (the reference's "row" leaf moved to
    columns): then ``h`` enters through ``copy_to`` (each rank's columns
    of the output give a partial gradient of it) and the columns are
    gathered with ``gather_from`` (every rank reads them whole)."""
    if tp is None or w.shape[-1] == d:
        return _mm(h, w)
    return tp.gather_from(_mm(tp.copy_to(h), w), -1)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """RMSNorm: sum of squares in f32, then ``x * scale`` in x's dtype with
    ``scale = inv.astype(x.dtype) * (1 + w).astype(x.dtype)``."""
    xf = x.float()
    ss = (xf * xf).sum(-1)
    inv = torch.rsqrt(ss / x.shape[-1] + eps)
    scale = inv[..., None].to(x.dtype) * (1.0 + w).to(x.dtype)
    return x * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: (..., S).  Rotates the two halves of
    the head (not interleaved pairs), angles in f32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class MetaDraws:
    """Stands in for a ``torch.Generator`` on the ``meta`` device (the dry
    run's): its draws are tensors of their shapes and dtypes that hold no
    values."""
    device = torch.device("meta")


def randn(gen, shape) -> torch.Tensor:
    """N(0, 1) in f32 drawn from ``gen`` on its device."""
    if isinstance(gen, MetaDraws):
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def _uniform(gen: torch.Generator, shape, scale: float,
             dtype=torch.float32):
    """U(-scale, scale) drawn from ``gen`` on its device (in f32, in
    place, then cast: an expert stack's f32 draw is its largest buffer)."""
    if isinstance(gen, MetaDraws):
        return torch.empty(shape, dtype=dtype, device="meta")
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u.mul_(2.0).sub_(1.0).mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16):
    """U(-1/sqrt(d_in), 1/sqrt(d_in)) as in the reference."""
    return _uniform(gen, (d_in, d_out), 1.0 / math.sqrt(d_in)).to(dtype)


# ---------------------------------------------------------------------- #
# Attention
# ---------------------------------------------------------------------- #

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False) -> dict:
    """Projections, and q/k norms where the config has them; a cross
    attention (``cross``) has none."""
    D, Q, KV, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    p = {
        "wq": dense_init(gen, D, Q),
        "wk": dense_init(gen, D, KV),
        "wv": dense_init(gen, D, KV),
        "wo": dense_init(gen, Q, D),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.zeros((hd,), dtype=torch.float32,
                                  device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=torch.float32,
                                  device=gen.device)
    return p


def naive_attention(q, k, v, *, causal: bool, window: int | None,
                    q_pos, k_pos):
    """Reference O(S^2)-memory attention.  q:(B,Sq,H,hd) k/v:(B,Sk,Hkv,hd)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k.float()) / math.sqrt(hd)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)     # fully-masked rows
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, chunk_q: int = 512,
                      chunk_k: int = 512, q_offset: int = 0):
    """Differentiable flash attention, GQA-aware.  A CUDA tensor of any
    length goes to the Hopper kernels, which mask the ragged edge
    themselves (a ``meta`` one too, as the card's).  On the CPU, lengths
    that are not a multiple of the chunk take the naive oracle, as in the
    reference."""
    Sq, Sk = q.shape[1], k.shape[1]
    if not on_card(q) and (Sq % chunk_q or Sk % chunk_k):
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_pos=q_pos,
                               k_pos=torch.arange(Sk, device=q.device))
    # k and v of a model axis's KV heads cut by columns are slices
    q, k, v = (t.contiguous() for t in (q, k, v))
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def _mm(x, w):
    """``x @ w`` in the promoted dtype, as ``jnp.matmul`` promotes: a bf16
    ``x`` meets f32 weights where an f32 model's encoder takes its bf16
    input."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def _kv(p, cfg: ModelConfig, src, tp=None, every: bool = False):
    """k and v (B,S,n,hd) of ``src`` (B,S,D): of the KV heads that this
    rank's query heads read on the model axis ``tp`` (``rank_heads``), or
    of every KV head (``every``).  Where the axis divides the KV heads and
    ``every`` is not asked, the rank's columns of ``wk``/``wv`` are its KV
    heads.  Otherwise k and v are made whole first, from the rank's cut of
    the two leaves (the reference's, ``sharding.param_model_dims``):
    columns cut inside a head give the rank's columns of k and v, gathered
    with one ``gather_to`` of the two stacked (each rank keeps its own KV
    heads of them, so the backward sums the ranks' partial gradients);
    rows give a partial sum, summed over the axis with a sum backward too;
    a replicated leaf is read whole through ``copy_to``.  Where every
    rank computes every head (``wq`` not cut by columns: ``wk``/``wv``
    by rows or whole), k and v are whole (:func:`_whole`), with no
    ``copy_to``: each rank's gradient of them is whole."""
    B, S, D = src.shape
    hd = cfg.head_dim
    wk, wv = p["wk"], p["wv"]
    if tp is not None and not _heads_cut(p, cfg):
        k, v = _whole(tp, src, wk, wv)
    elif tp is None or (cfg.n_kv_heads % tp.size == 0 and not every):
        k, v = _mm(src, wk), _mm(src, wv)
    else:
        if wk.shape[1] < cfg.kv_dim:
            kv = tp.gather_to(torch.stack([_mm(src, wk), _mm(src, wv)]), -1)
        elif wk.shape[0] < D:
            n = wk.shape[0]
            xs = src[..., tp.index * n:(tp.index + 1) * n]
            kv = tp.copy_to(tp.reduce_from(torch.stack([_mm(xs, wk),
                                                        _mm(xs, wv)])))
        else:
            kv = _mm(src[None], tp.copy_to(torch.stack([wk, wv]))[:, None])
        k, v = kv.unbind(0)
        if not every:
            sh = heads(cfg, tp)
            k = k[..., sh.kv0 * hd:(sh.kv0 + sh.nkv) * hd]
            v = v[..., sh.kv0 * hd:(sh.kv0 + sh.nkv) * hd]
    return (k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd))


def _q(p, cfg: ModelConfig, x, tp=None, every: bool = False):
    """q (B,S,n,hd) of ``x``: of this rank's query heads on the model axis
    ``tp``, or of every head (``every``).  Where the axis divides the
    heads, the rank's columns of ``wq`` are its heads.  Otherwise (and
    for ``every``) the ranks' columns, cut inside a head, are gathered
    with ``gather_to`` and the rank keeps the heads its columns meet: its
    gradient of the whole q is partial, and the backward sums the ranks'
    (a head that spans two ranks gets both ranks' parts).  Where the
    axis does not cut ``wq`` by columns, q is whole (:func:`_whole`)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    if tp is not None and not _heads_cut(p, cfg):
        return _whole(tp, x, p["wq"])[0].reshape(B, S, -1, hd)
    q = _mm(x, p["wq"])
    if tp is not None and tp.size > 1 and (every or cfg.n_heads % tp.size):
        q = tp.gather_to(q, -1)
        if not every:
            sh = heads(cfg, tp)
            q = q[..., sh.q0 * hd:(sh.q0 + sh.nq) * hd]
    return q.reshape(B, S, -1, hd)


def _heads_cut(p, cfg: ModelConfig) -> bool:
    """Whether the model axis cuts attention ``p``'s ``wq`` by columns,
    giving each rank the heads that its columns meet; else every rank
    computes every head."""
    return p["wq"].shape[1] < cfg.q_dim


def _gather_cols(tp, *ts):
    """Each of ``ts`` (..., c), this rank's columns, with every rank's
    columns in rank order: one all-gather over the model axis."""
    n = [t.shape[-1] for t in ts]
    g = tp.all_gather(torch.cat(ts, -1), dim=-1)
    g = g.reshape(*g.shape[:-1], tp.size, sum(n))
    return [t.reshape(*t.shape[:-2], -1) for t in g.split(n, dim=-1)]


def _qkv(p, cfg: ModelConfig, x, src=None, tp=None, every: bool = False):
    """q from ``x`` as :func:`_q` gives it, k and v from ``src`` (``x`` if
    None) as :func:`_kv` gives them, with the q/k norms where ``p`` has
    them (on whole heads: after the gathers).  ``every`` (inference only)
    gathers the three in one call where the rank's columns of ``wk`` and
    ``wv`` are whole KV heads.  Where every rank computes every head, a
    self attention's three partial sums by rows take one all-reduce."""
    if src is None and tp is not None and not _heads_cut(p, cfg):
        B, S, _ = x.shape
        return _norm_qk(p, *[t.reshape(B, S, -1, cfg.head_dim) for t in
                             _whole(tp, x, p["wq"], p["wk"], p["wv"])])
    src = x if src is None else src
    if every and tp is not None and tp.size > 1 \
            and cfg.n_kv_heads % tp.size == 0:
        B, S, _ = x.shape
        q, k, v = [t.reshape(B, S, -1, cfg.head_dim) for t in _gather_cols(
            tp, _mm(x, p["wq"]), _mm(src, p["wk"]), _mm(src, p["wv"]))]
    else:
        q = _q(p, cfg, x, tp, every)
        k, v = _kv(p, cfg, src, tp, every)
    return _norm_qk(p, q, k, v)


def _norm_qk(p, q, k, v):
    if "q_norm" in p:
        q, k = rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])
    return q, k, v


def _rank_kv(k, v, sh: RankHeads):
    """k and v (B,S,nkv,hd) of this rank's KV heads, laid out for its
    query heads: as they are where those read them in equal groups
    (``sh.grouped``), else one KV head for each query head."""
    if sh.grouped:
        return k, v
    idx = torch.tensor(sh.kv_of, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _out(o, p, sh: RankHeads, cfg: ModelConfig, tp=None):
    """The output projection of this rank's heads' o (B,S,nq,hd): its
    columns of o (``sh.off`` into the first head) times its rows of
    ``wo``, the row-parallel partial sum on a model axis.  Where every
    rank computes every head, o is whole and so is the result: ``wo``
    whole, or by columns (:func:`_gathered`)."""
    o = o.reshape(o.shape[0], o.shape[1], -1)
    if tp is not None and not _heads_cut(p, cfg):
        return _gathered(tp, o, p["wo"], cfg.d_model)
    return o[..., sh.off:sh.off + p["wo"].shape[0]] @ p["wo"]


def attention_fwd(p, cfg: ModelConfig, x, *, causal: bool = True,
                  window: int | None = None, kv_src=None, positions=None,
                  tp=None):
    """Attention sublayer of the full-sequence forward (projections,
    optional q/k norm, rope, attention, out projection).  ``kv_src``: the
    encoder's output for cross-attention, which takes no rope and no
    causal mask.  With ``tp``, this rank's heads and the partial sum of
    its ``wo`` rows; the q/k norms' weights, replicated but read on this
    rank's heads only, go through ``tp.copy_to``, so that a backward sums
    their gradient over the axis.  Where the axis does not cut ``wq`` by
    columns, every head on every rank and a whole output (:func:`cuts`
    tells the caller which)."""
    if tp is not None and "q_norm" in p and _heads_cut(p, cfg):
        p = dict(p, q_norm=tp.copy_to(p["q_norm"]),
                 k_norm=tp.copy_to(p["k_norm"]))
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, kv_src, tp)
    if kv_src is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, torch.arange(S, device=x.device), cfg.rope_theta)
    sh = heads(cfg, tp)
    k, v = _rank_kv(k, v, sh)
    o = chunked_attention(q, k, v, causal=causal and kv_src is None,
                          window=window)
    return _out(o, p, sh, cfg, tp)


def _decode_attend(q, k, v, valid):
    """One query token's attention over a cache: q (B,n,hd); k/v
    (B,S,nkv,hd), whose head i // (n / nkv) each query head reads; valid
    (B,S) or (S,).  Returns o (B,1,n,hd) f32."""
    B, n, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, nkv, n // nkv, hd)
    sc = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                      k.float()) / math.sqrt(hd)
    if valid is not None:
        mask = valid[:, None, None, :] if valid.dim() == 2 else valid
        sc = sc.masked_fill(~mask, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", pr, v.float())
    return o.reshape(B, 1, n, hd)


def paged_attention_decode(p, cfg: ModelConfig, x, pool_k, pool_v,
                           block_tables, pos, *, window: int | None = None,
                           tp=None):
    """One-token decode against a paged KV pool.

    x: (B,1,D); pool_k/v: (n_blocks, block_size, Hkv, hd), written in
    place; block_tables: (B, max_blocks) int mapping each slot's logical
    block to a physical one (0 = the reserved null block, where idle slots
    write harmlessly); pos: (B,) per-slot token count.  Windowed layers
    store the full sequence and mask ``pos - idx >= window`` at read.
    With ``tp``, the pools hold the KV heads that this rank's query heads
    read and y is the partial sum of its ``wo`` rows.  Returns (y, pool_k,
    pool_v)."""
    q, k, v = _qkv(p, cfg, x, tp=tp)
    B = x.shape[0]
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)

    BS = pool_k.shape[1]
    block_tables = block_tables.long()
    bidx = block_tables[torch.arange(B, device=x.device), pos // BS]
    off = pos % BS
    pool_k[bidx, off] = k[:, 0].to(pool_k.dtype)
    pool_v[bidx, off] = v[:, 0].to(pool_v.dtype)

    S = block_tables.shape[1] * BS
    gk = pool_k[block_tables].reshape(B, S, *pool_k.shape[2:])
    gv = pool_v[block_tables].reshape(B, S, *pool_v.shape[2:])
    idx = torch.arange(S, device=x.device)
    valid = idx[None, :] <= pos[:, None]
    if window is not None:
        valid &= pos[:, None] - idx[None, :] < window
    sh = heads(cfg, tp)
    o = _decode_attend(q[:, 0], *_rank_kv(gk, gv, sh), valid)
    return _out(o.to(x.dtype), p, sh, cfg, tp), pool_k, pool_v


def _cache_attend_sp(q, k_new, v_new, cache_k, cache_v, pos: int,
                     windowed: bool, tp):
    """The reference's flash-decode combine (``layers.py:332``): the cache's
    sequence dim is sharded over the model axis ``tp``; this rank writes
    the new k/v where it owns the slot, scores its slice, and a max and two
    sums over the axis merge the partials.  q: (B,Hkv,G,hd), every head;
    k/v_new: (B,1,Hkv,hd); cache_k/v: (B,S_loc,Hkv,hd), this rank's slice,
    written in place.  Returns o (B,Hkv,G,hd) f32."""
    B, S_loc, Hkv, hd = cache_k.shape
    r = tp.index
    S_tot = S_loc * tp.size
    slot_g = pos % S_tot if windowed else min(pos, S_tot - 1)
    local = slot_g - r * S_loc
    if 0 <= local < S_loc:
        cache_k[:, local] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, local] = v_new[:, 0].to(cache_v.dtype)
    idx = r * S_loc + torch.arange(S_loc, device=q.device)
    if windowed:
        abs_pos = pos - ((pos - idx) % S_tot)
        valid = (abs_pos >= 0) & (abs_pos >= pos - S_tot + 1) \
            & (abs_pos <= pos)
    else:
        valid = idx <= pos
    sc = torch.einsum("bhgd,bkhd->bhgk", q.float(),
                      cache_k.float()) / math.sqrt(hd)
    sc = sc.masked_fill(~valid, NEG_INF)
    m = tp.pmax(sc.amax(-1))                       # (B,Hkv,G)
    pr = torch.exp(sc - m[..., None])
    l = tp.psum(pr.sum(-1))
    o = tp.psum(torch.einsum("bhgk,bkhd->bhgd", pr, cache_v.float()))
    return o / torch.clamp_min(l, 1e-30)[..., None]


def attention_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos: int, *,
                     windowed: bool, tp=None, seq_shard: bool = False):
    """One-token decode against a dense cache.  x: (B,1,D); cache_k/v:
    (B,S_cache,Hkv,hd), written in place; pos: the number of tokens
    already in the cache (a Python int).  A windowed cache is a ring of
    ``S_cache`` slots.  Returns (y, cache_k, cache_v).

    With ``tp``, y is the partial sum of this rank's ``wo`` rows.  With
    ``seq_shard`` the cache is this rank's slice of the sequence with
    every KV head (the reference's sequence-parallel decode, taken where
    the model axis divides ``S_cache``): q, k and v are gathered by their
    columns over the axis, as the reference's q enters its combine whole,
    the combine runs on every head, and the rank keeps its columns of its
    output.  Otherwise the cache holds the KV heads that this rank's query
    heads read, and so does the attention."""
    B = x.shape[0]
    hd = cfg.head_dim
    sp = seq_shard and tp is not None and tp.size > 1
    q, k, v = _qkv(p, cfg, x, tp=tp, every=sp)
    pos_t = torch.tensor([pos], device=x.device)
    q = rope(q, pos_t, cfg.rope_theta)
    k = rope(k, pos_t, cfg.rope_theta)
    if sp:
        G = cfg.n_heads // cfg.n_kv_heads
        o = _cache_attend_sp(q.reshape(B, cfg.n_kv_heads, G, hd), k, v,
                             cache_k, cache_v, pos, windowed, tp)
        if not _heads_cut(p, cfg):
            return _out(o.reshape(B, 1, cfg.q_dim).to(x.dtype), p,
                        heads(cfg, tp), cfg, tp), cache_k, cache_v
        n = p["wo"].shape[0]
        o = o.reshape(B, 1, cfg.q_dim)[..., tp.index * n:
                                       (tp.index + 1) * n].to(x.dtype)
        return o @ p["wo"], cache_k, cache_v

    s_cache = cache_k.shape[1]
    slot = pos % s_cache if windowed else min(pos, s_cache - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    idx = torch.arange(s_cache, device=x.device)
    if windowed:
        # entry i holds the latest position p' <= pos with p' % S_cache == i
        abs_pos = pos - ((pos - idx) % s_cache)
        valid = (abs_pos >= 0) & (abs_pos >= pos - s_cache + 1) \
            & (abs_pos <= pos)
    else:
        valid = idx <= pos
    sh = heads(cfg, tp)
    o = _decode_attend(q[:, 0], *_rank_kv(cache_k, cache_v, sh), valid)
    return _out(o.to(x.dtype), p, sh, cfg, tp), cache_k, cache_v


def attention_prefill(p, cfg: ModelConfig, x, *, window=None,
                      keep_full: bool = False, tp=None):
    """Causal self-attention sublayer that also returns the KV cache slice
    (bf16).  Windowed layers keep the last ``window`` keys (prefill length
    must then be a multiple of the window) unless ``keep_full``.  With
    ``tp``, this rank's heads (and the cache of the KV heads they read)
    and the partial sum of its ``wo`` rows."""
    q, k, v = _qkv(p, cfg, x, tp=tp)
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    sh = heads(cfg, tp)
    o = chunked_attention(q, *_rank_kv(k, v, sh), causal=True,
                          window=window)
    y = _out(o, p, sh, cfg, tp)
    if window is not None and S >= window and not keep_full:
        if S % window != 0:
            raise ValueError(
                f"windowed prefill needs S % window == 0, got "
                f"S={S} window={window}")
        ck, cv = k[:, S - window:], v[:, S - window:]
    else:
        ck, cv = k, v
    return y, ck.to(torch.bfloat16), cv.to(torch.bfloat16)


def cross_kv(p, cfg: ModelConfig, enc_out, tp=None):
    """Cross-attention K/V (bf16) from the encoder's output (B,Sk,D); on a
    model axis ``tp``, of the KV heads that this rank's query heads read
    (every source position)."""
    k, v = _kv(p, cfg, enc_out, tp)
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


def cross_attention_decode(p, cfg: ModelConfig, x, ck, cv, tp=None):
    """One-token cross-attention (B,1,D) against the encoder's K/V, every
    source position visible.  On a model axis ``tp``, this rank's heads
    against the ``ck``/``cv`` of the KV heads they read, and the partial
    sum of its ``wo`` rows."""
    sh = heads(cfg, tp)
    o = _decode_attend(_q(p, cfg, x, tp)[:, 0], *_rank_kv(ck, cv, sh), None)
    return _out(o.to(x.dtype), p, sh, cfg, tp)


# ---------------------------------------------------------------------- #
# MLP / MoE
# ---------------------------------------------------------------------- #

def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(gen, D, F_), "wo": dense_init(gen, F_, D)}
    if cfg.activation in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, D, F_)
    return p


def mlp_fwd(p, cfg: ModelConfig, x, tp=None):
    """The MLP of ``x`` (B,S,D).  On a model axis ``tp`` the leaves' cut
    decides (:func:`cuts`): ``wi``/``wg`` by columns give this rank's
    features and the partial sum of its ``wo`` rows; by rows (the axis
    does not divide ``d_ff``) the whole hidden activations, their partial
    sums added in one all-reduce, and ``wo``'s columns of the output,
    gathered whole; whole leaves a whole output."""
    if tp is not None and p["wi"].shape[1] == cfg.d_ff:
        hg = _whole(tp, x, *[p[k] for k in ("wi", "wg") if k in p])
        return _gathered(tp, _activate(cfg, *hg), p["wo"], cfg.d_model)
    h = x @ p["wi"]
    return _activate(cfg, h, x @ p["wg"] if "wg" in p else None) @ p["wo"]


def _activate(cfg: ModelConfig, h, g=None):
    """The MLP's hidden activations of ``h = x @ wi`` and, for a gated
    activation, ``g = x @ wg``."""
    if cfg.activation == "swiglu":
        return F.silu(g) * h
    if cfg.activation == "geglu":
        return F.gelu(g, approximate="tanh") * h
    return F.gelu(h, approximate="tanh")


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Router (D,E) f32 (bf16 values), experts ``w_in``/``w_gate``
    (E,D,Fe) and ``w_out`` (E,Fe,D) bf16, and llama4's ``shared`` MLP."""
    m = cfg.moe
    D, Fe, E = cfg.d_model, m.d_ff_expert, m.n_experts
    scale = 1.0 / math.sqrt(D)
    p = {
        "router": dense_init(gen, D, E).float(),
        "w_in": _uniform(gen, (E, D, Fe), scale, torch.bfloat16),
        "w_gate": _uniform(gen, (E, D, Fe), scale, torch.bfloat16),
        "w_out": _uniform(gen, (E, Fe, D), 1.0 / math.sqrt(Fe),
                          torch.bfloat16),
    }
    if m.shared_expert:
        p["shared"] = init_mlp(gen, cfg)
    return p


MOE_CHUNK = 8192  # token-block size of the dispatch


def _moe_gates(p, m, xt):
    """f32 router logits, softmax, top-k with the gates renormalised:
    (gates (T,k), flat expert ids (T*k,))."""
    logits = _mm(xt.float(), p["router"])
    gates, eidx = torch.topk(torch.softmax(logits, dim=-1), m.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, eidx.reshape(-1)


def _moe_route(p, m, xt):
    """Router and dispatch order for one block of tokens (T,D): the gates,
    a stable sort of the flat expert ids, and the tokens each expert
    takes, read on the host (one sync).  Returns (gates (T,k), order
    (T*k,), sizes list)."""
    gates, flat_e = _moe_gates(p, m, xt)
    order = torch.argsort(flat_e, stable=True)
    sizes = even_sizes(flat_e.numel(), m.n_experts) if flat_e.is_meta \
        else torch.bincount(flat_e, minlength=m.n_experts).tolist()
    moe_fwd.host_syncs += 1
    return gates, order, sizes


def even_sizes(n: int, E: int) -> list[int]:
    """The dry run's group sizes, which a ``meta`` tensor cannot give: an
    even share of the ``n`` routed rows per expert, the first ``n mod E``
    experts one more.  A real run never takes them."""
    return [n // E + (e < n % E) for e in range(E)]


def _moe_experts(p, xs, sizes, tp=None, feats: bool = False):
    """The three grouped products and ``silu(g) * h`` over the
    expert-sorted rows ``xs``: one matmul per non-empty expert on its
    slice (``lax.ragged_dot`` in the reference).  On a model axis ``tp``
    that does not divide the experts (the dense block) the leaves' cuts
    decide.  Where ``feats`` (``w_in``/``w_gate`` hold this rank's
    feature columns of every expert) ``xs`` enters through ``copy_to``
    and each rank computes its columns of the hidden; then, where
    ``w_out`` holds its columns of the output, one ``gather_to`` of the
    hidden of every row gives it whole (each rank reads it for its own
    columns: the backward is a reduce-scatter), and where ``w_out`` is
    whole the rank's hidden times its rows of it is a partial sum, which
    the caller adds over the axis (``w_out`` enters through ``copy_to``:
    each rank's gradient holds its rows).  Where the experts are whole
    but ``w_out`` holds the rank's columns, every expert's ``silu(g) *
    h`` first, whole, then one ``copy_to`` of them all (the rank's
    columns of the output give a partial gradient of them), then its
    columns."""
    spans, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            spans.append((e, start, start + n))
        start += n
    hidden = lambda e, xe: F.silu(xe @ p["w_gate"][e]) * (xe @ p["w_in"][e])
    yo = xs.new_empty(xs.shape[:-1] + p["w_out"].shape[-1:])
    if tp is None:
        for e, a, b in spans:
            yo[a:b] = hidden(e, xs[a:b]) @ p["w_out"][e]
        return yo
    if feats:
        xs = tp.copy_to(xs)
    hs = xs.new_empty(xs.shape[:-1] + p["w_in"].shape[-1:])
    for e, a, b in spans:
        hs[a:b] = hidden(e, xs[a:b])
    w_out = p["w_out"]
    if not feats:
        hs = tp.copy_to(hs)
    elif w_out.shape[-1] == xs.shape[-1]:       # whole: the rank's rows
        n = hs.shape[-1]
        w_out = tp.copy_to(w_out)[:, tp.index * n:(tp.index + 1) * n]
    else:
        hs = tp.gather_to(hs, -1)
    for e, a, b in spans:
        yo[a:b] = hs[a:b] @ w_out[e]
    return yo


def _moe_block(p, m, xt, tp=None):
    """Route, dispatch and expert compute for one block of tokens (T,D);
    every routed token is computed (no capacity).  On a model axis ``tp``
    that does not divide the experts every rank routes every token, the
    router whole, and runs the dense block on every expert (the
    reference's there; :func:`_moe_experts`): the output is whole where
    the experts are whole; where ``w_out`` holds the rank's columns of
    the output the gates enter the combine through ``copy_to`` and its
    columns are gathered (``gather_from``); where ``w_in``/``w_gate``
    hold its features and ``w_out`` is whole, the combine of its partial
    sums (gates through ``copy_to``) is added over the axis
    (``reduce_from``)."""
    T, D = xt.shape
    gates, order, sizes = _moe_route(p, m, xt)
    feats = tp is not None and p["w_in"].shape[-1] < m.d_ff_expert
    cols = tp is not None and p["w_out"].shape[-1] < D
    if cols or feats:
        gates = tp.copy_to(gates)
    yo = _moe_experts(p, xt[order // m.top_k], sizes,
                      tp if cols or feats else None, feats)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    yo = yo[inv].reshape(T, m.top_k, -1)
    y = torch.einsum("tk,tkd->td", gates.to(yo.dtype), yo)
    if cols:
        return tp.gather_from(y, -1)
    return tp.reduce_from(y) if feats else y


def _moe_block_ep(p, m, xt, tp):
    """The reference's expert-parallel block (``layers.py:634``) on this
    rank of the model axis ``tp``, which holds E/M experts (``w_*`` are
    its slices).  Tokens are replicated over the axis, so the dispatch is
    local: this rank's slots, sorted stably by local expert id, the first
    C kept (C = int(T k capacity_factor) // M, rounded down to a multiple
    of 8, at least 8), the rest dropped; the combine is one sum over the
    axis (``reduce_from``: the gradient passes through to each rank's
    part).  The router is replicated and each rank's gates reach only its
    own experts' products, so it enters through ``copy_to``, which sums
    its gradient over the axis.  The kept group sizes are read on the host
    once (one sync), and the slots this rank dropped are appended to
    ``moe_fwd.dropped`` where a caller has set it to a list, once a
    forward: not again where a remat re-runs the block in a backward."""
    T, D = xt.shape
    E_local = p["w_in"].shape[0]
    gates, flat_e = _moe_gates(dict(p, router=tp.copy_to(p["router"])), m,
                               xt)
    local = flat_e - tp.index * E_local
    mine = (local >= 0) & (local < E_local)
    C = int(T * m.top_k * m.capacity_factor) // tp.size
    C = max(C - C % 8, 8)
    key = torch.where(mine, local, E_local)
    order = torch.argsort(key, stable=True)
    if key.is_meta:             # the dry run: even shares, none dropped
        sizes = even_sizes(key.numel(), m.n_experts)[
            tp.index * E_local:(tp.index + 1) * E_local]
        counts = sizes + [key.numel() - sum(sizes)]
    else:
        counts = torch.bincount(key, minlength=E_local + 1).tolist()
        sizes, left = [], C
        for n in counts[:E_local]:
            sizes.append(min(n, left))
            left -= sizes[-1]
    moe_fwd.host_syncs += 1
    kept = sum(sizes)
    if moe_fwd.dropped is not None and not _in_backward():
        moe_fwd.dropped.append(sum(counts[:E_local]) - kept)
    sel = order[:kept]
    tok_for = sel // m.top_k
    yo = _moe_experts(p, xt[tok_for], sizes)
    w = gates.reshape(-1)[sel]
    out = torch.zeros((T, D), dtype=torch.float32, device=xt.device)
    out.index_add_(0, tok_for, yo.float() * w[:, None])
    return tp.reduce_from(out).to(xt.dtype)


def moe_fwd(p, cfg: ModelConfig, x, chunk: int = MOE_CHUNK, tp=None):
    """Top-k MoE, x (B,S,D).  Inputs longer than ``chunk`` tokens and a
    multiple of it run in blocks of ``chunk`` (the reference's condition),
    which bounds the dispatch buffers; where a gradient is taken each
    block runs under remat, as the reference's ``jax.checkpoint`` of its
    scanned blocks, so its backward routes the block again (the same
    routing: the same inputs, and a stable sort).  The gradient reaches
    the router through the renormalised top-k gates, and every non-empty
    expert's three weights through its products (autograd through one
    ``torch.matmul`` each, where the reference differentiates
    ``lax.ragged_dot``).  On a model axis ``tp`` that divides the experts
    each block takes the expert-parallel path (the reference's condition
    for it), whose output is summed over the axis (``reduce_from``); on
    one that does not, every rank runs the dense block on every expert
    (:func:`_moe_block`).  The shared expert is an MLP on the axis
    (:func:`mlp_fwd`), summed where its output is a partial sum.  ``x``
    is the whole input; it enters through one ``copy_to`` (which sums the
    ranks' partial input gradients) where the expert-parallel block or a
    cut shared expert reads it."""
    m = cfg.moe
    B, S, D = x.shape
    ep = tp is not None and p["w_in"].shape[0] < m.n_experts
    shared_cut = tp is not None and m.shared_expert \
        and cuts(p["shared"], cfg)[0]
    xc = tp.copy_to(x) if ep or shared_cut else x
    xt = (xc if ep else x).reshape(B * S, D)
    block = (lambda xb: _moe_block(p, m, xb, tp)) if not ep else \
        (lambda xb: _moe_block_ep(p, m, xb, tp))
    if B * S <= chunk or (B * S) % chunk:
        y = block(xt)
    elif torch.is_grad_enabled():
        y = torch.cat([checkpoint(block, xb, use_reentrant=False)
                       for xb in xt.split(chunk)])
    else:
        y = torch.cat([block(xb) for xb in xt.split(chunk)])
    y = y.reshape(B, S, D)
    if m.shared_expert:
        sh = mlp_fwd(p["shared"], cfg, xc if shared_cut else x, tp)
        y = y + (tp.reduce_from(sh) if tp is not None
                 and cuts(p["shared"], cfg)[1] else sh)
    return y.to(x.dtype)


moe_fwd.host_syncs = 0     # group-size reads, one per token block
moe_fwd.dropped = None     # a list a caller sets (and takes back) to
                           # count each expert-parallel block's drops


def _in_backward() -> bool:
    """Whether this thread runs inside autograd's backward, where a remat
    re-runs a forward."""
    return torch._C._current_graph_task_id() != -1


# ---------------------------------------------------------------------- #
# RG-LRU (Griffin / recurrentgemma recurrent block)
# ---------------------------------------------------------------------- #

def init_rglru(gen: torch.Generator, cfg: ModelConfig) -> dict:
    R = cfg.d_rnn or cfg.d_model
    D = cfg.d_model
    return {
        "w_x": dense_init(gen, D, R),
        "w_gate": dense_init(gen, D, R),
        "conv": _uniform(gen, (4, R), 0.5, torch.bfloat16),
        "w_a": dense_init(gen, R, R),
        "w_i": dense_init(gen, R, R),
        "lam": torch.linspace(-4.3, -9.0, R, dtype=torch.float32,
                              device=gen.device),    # a in (.9, .999)
        "w_out": dense_init(gen, R, D),
    }


def _rglru_gates(p, u, u_own, lam):
    """u: (..., R) conv output, every channel; ``u_own`` this rank's
    channels of it (``u`` itself on one rank), ``lam`` theirs -> (a,
    gated input b) of those channels, both f32.  softplus is
    ``logaddexp(x, 0)``, as ``jax.nn.softplus``."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"].float())
    i = torch.sigmoid(uf @ p["w_i"].float())
    log_a = -8.0 * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * (i * u_own.float())
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, for every t:
    a log-step scan of the reference's combine
    ``(al, bl), (ar, br) -> (al ar, ar bl + br)``."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def _gelu_gate(gate, h, dtype):
    return (F.gelu(gate.float(), approximate="tanh") * h).to(dtype)


def _rglru_cut(p, tp) -> bool:
    """Whether the model axis ``tp`` cuts the RG-LRU's channels (``w_x``
    by columns); else every rank runs every channel, its leaves whole
    (``w_x`` and ``w_gate`` perhaps by rows)."""
    return tp is not None and p["w_x"].shape[1] < p["conv"].shape[1]


def _rglru_channels(p, tp):
    """``conv`` (4, r) and ``lam`` (r,) of this rank's r = R/M channels.
    Both are replicated leaves that each rank reads on its channels only,
    so on a model axis ``tp`` they enter through one ``copy_to`` of their
    stack (in f32, ``lam``'s dtype, which holds ``conv``'s values
    exactly): a backward sums their partial gradients over the axis.
    Whole channels read them whole."""
    if not _rglru_cut(p, tp):
        return p["conv"], p["lam"]
    n = p["w_x"].shape[1]
    cl = tp.copy_to(torch.cat([p["conv"].float(), p["lam"][None]]))
    cl = cl[:, tp.index * n:(tp.index + 1) * n]
    return cl[:4].to(p["conv"].dtype), cl[4]


def _rglru_out(p, y, tp, D: int):
    """The block's output (…, D), whole on every rank, from the gated
    activations ``y`` of this rank's channels.  On a model axis ``tp``:
    where ``w_out`` is whole (the reference splits a run's layers over
    the axis, ``sharding.RUN_DIM``, and the per-layer tree keeps the leaf)
    the rank's rows give a partial sum, summed over the axis
    (``reduce_from``); where it holds the rank's columns (a run the axis
    does not divide), ``y`` is gathered (``gather_to``: each rank reads it
    for its own columns) and the output's columns with ``gather_from``.
    With whole channels ``y`` is whole, and so is the output of ``D``
    columns (``w_out`` whole, or by columns: :func:`_gathered`)."""
    w = p["w_out"]
    if not _rglru_cut(p, tp):
        return _gathered(tp, y, w, D)
    if w.shape[1] == p["w_x"].shape[0]:             # whole: (R, D)
        n = y.shape[-1]
        return tp.reduce_from(y @ w[tp.index * n:(tp.index + 1) * n])
    return tp.gather_from(tp.gather_to(y, -1) @ w, -1)


def _gather_channels(p, tp, u):
    return tp.gather_to(u, -1) if _rglru_cut(p, tp) else u


def _rglru(p, x, h0=None, tp=None):
    """(y, h (B,S,r) f32, the pre-conv inputs u (B,S,r)) of the recurrent
    block on this rank's r = R/M channels (all of them on one rank, or
    where the axis does not cut them)."""
    S = x.shape[1]
    conv, lam = _rglru_channels(p, tp)
    if _rglru_cut(p, tp):
        u_pre, gate = x @ p["w_x"], x @ p["w_gate"]
    else:
        u_pre, gate = _whole(tp, x, p["w_x"], p["w_gate"])
    # causal depthwise conv, kernel 4, rounded after each add as the
    # reference's Python sum
    upad = F.pad(u_pre, (0, 0, 3, 0))
    u = sum(upad[:, i:i + S] * conv[i] for i in range(4))
    a, b = _rglru_gates(p, _gather_channels(p, tp, u), u, lam)
    if h0 is not None:
        # out of place: autograd may have saved b
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], 1)
    h = linear_scan(a, b)
    return _rglru_out(p, _gelu_gate(gate, h, x.dtype), tp, x.shape[-1]), \
        h, u_pre


def rglru_fwd(p, cfg: ModelConfig, x, h0=None, tp=None):
    """x: (B,S,D) -> (y (B,S,D), the last state (B,R) f32).  On a model
    axis ``tp`` (the RG-LRU's ``d_rnn`` split over it): ``w_x``,
    ``w_gate``, ``w_a`` and ``w_i`` by columns, the conv, the gates, the
    scan and the state on this rank's R/M channels, the conv output
    gathered for the gate products (``gather_to``), and ``w_out`` as
    :func:`_rglru_out` takes it; y is whole on every rank, and the state
    of the rank's channels.  Where a gradient is taken ``x`` arrives
    through ``copy_to``."""
    y, h, _ = _rglru(p, x, h0, tp)
    return y, h[:, -1]


def rglru_prefill(p, cfg: ModelConfig, x, tp=None):
    """Forward plus the state decode continues from: (y, h (B,R) f32, the
    last 3 pre-conv inputs (B,3,R), zero-padded in front if S < 3); on a
    model axis ``tp``, the state of this rank's R/M channels."""
    y, h, u_pre = _rglru(p, x, tp=tp)
    S = x.shape[1]
    conv = u_pre[:, -3:] if S >= 3 else F.pad(u_pre, (0, 0, 3 - S, 0))
    return y, h[:, -1].float(), conv


def rglru_decode(p, cfg: ModelConfig, x, h_prev, conv_state, tp=None):
    """x: (B,1,D); h_prev: (B,R); conv_state: (B,3,R) (on a model axis
    ``tp``, of this rank's R/M channels).  The conv's four taps are summed
    in f32 and rounded once, as XLA's bf16 dot.  Returns (y (B,1,D), h,
    the next conv state)."""
    conv, lam = _rglru_channels(p, tp)
    if _rglru_cut(p, tp):
        u_new, gate = (x @ p["w_x"])[:, 0], (x @ p["w_gate"])[:, 0]
    else:
        u_new, gate = (t[:, 0] for t in _whole(tp, x, p["w_x"],
                                               p["w_gate"]))
    window = torch.cat([conv_state, u_new[:, None]], 1)      # (B,4,R)
    u = (window.float() * conv.float()).sum(1).to(
        torch.promote_types(window.dtype, conv.dtype))
    a, b = _rglru_gates(p, _gather_channels(p, tp, u), u, lam)
    h = a * h_prev + b
    y = _rglru_out(p, _gelu_gate(gate, h, x.dtype), tp, x.shape[-1])
    return y[:, None], h, window[:, 1:]


# ---------------------------------------------------------------------- #
# RWKV-6 ("Finch"): linear attention with data-dependent per-channel decay
# ---------------------------------------------------------------------- #

def init_rwkv6(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    H = D // cfg.rwkv_head_dim
    return {
        # time-mix
        "w_r": dense_init(gen, D, D),
        "w_k": dense_init(gen, D, D),
        "w_v": dense_init(gen, D, D),
        "w_g": dense_init(gen, D, D),
        "w_w": dense_init(gen, D, D),       # decay projection
        "w_o": dense_init(gen, D, D),
        "u": _uniform(gen, (H, cfg.rwkv_head_dim), 0.5),
        "mix": _uniform(gen, (5, D), 0.5),  # r, k, v, g, w
        # channel-mix
        "cm_k": dense_init(gen, D, F_),
        "cm_v": dense_init(gen, F_, D),
        "cm_r": dense_init(gen, D, D),
        "cm_mix": _uniform(gen, (2, D), 0.5),
    }


def _token_shift(x):
    """x_{t-1} with zero at t=0.  x: (B,S,D)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _mixed(x, xp, mix, tp=None, cut=None):
    """The token-shift mixes ``x + mix[i] * (xp - x)`` of each row ``i``
    of ``mix`` (n, D), elementwise as the reference computes them.  On a
    model axis those that feed cut products (``cut[i]``) enter through one
    ``copy_to`` of their stack: a backward sums the ranks' partial
    gradients of ``mix`` and of the normed input in one collective.  Those
    that feed whole leaves do not: their gradients are whole."""
    mix = mix.view((mix.shape[0],) + (1,) * (x.dim() - 1) + mix.shape[1:])
    mixed = x + mix * (xp - x)
    if tp is None or not any(cut):
        return mixed.unbind(0)
    if all(cut):
        return tp.copy_to(mixed).unbind(0)
    out = list(mixed.unbind(0))
    idx = [i for i, c in enumerate(cut) if c]
    for i, t in zip(idx, tp.copy_to(torch.stack([out[i] for i in idx]))
                    .unbind(0)):
        out[i] = t
    return out


def _rwkv_span(cfg: ModelConfig, tp) -> RwkvHeads:
    """This rank's :class:`~.sharding.RwkvHeads` on the model axis ``tp``
    (every head where ``tp`` is None)."""
    return rwkv_heads(cfg) if tp is None else rwkv_heads(cfg, tp.size,
                                                         tp.index)


def _rwkv_u(p, sh: RwkvHeads, tp):
    """The bonus ``u`` (nh, hd) of the heads this rank meets: ``u`` is
    replicated and read for this rank's columns only (on a rank that
    meets every head too), so it enters through ``copy_to`` (its
    gradient summed over the axis); whole where the rank has every
    column."""
    if tp is None or sh.cols == p["w_o"].shape[1]:
        return p["u"]
    return tp.copy_to(p["u"])[sh.h0:sh.h0 + sh.nh]


def _rwkv_met(p, xs, sh: RwkvHeads, hd: int, tp):
    """``x_r @ w_r``, ``x_k @ w_k``, ``x_v @ w_v`` and ``x_w @ w_w`` (…,
    nh hd) of the heads this rank's columns meet.  Where those columns are
    whole heads they are the products themselves.  Where they cut inside
    a head, the ranks' columns of the four are gathered (one ``gather_to``
    of their stack: each rank reads them for its own heads, so the
    backward sums the ranks' partial gradients) and the rank keeps the
    heads it meets: a head that spans two ranks is computed on both."""
    outs = [x @ p[k] for x, k in zip(xs, ("w_r", "w_k", "w_v", "w_w"))]
    if sh.cols == sh.nh * hd:
        return outs
    full = tp.gather_to(torch.stack(outs), -1)
    return full[..., sh.h0 * hd:(sh.h0 + sh.nh) * hd].unbind(0)


def _decay(w_pre):
    """The data-dependent decay ``exp(-exp(w))`` in f32; the clamp keeps
    the factored chunk recurrence in f32 range for chunks of up to 16."""
    return torch.exp(-torch.exp(torch.clamp(w_pre.float(), -8, 0.5)))


def _rwkv_out(p, o, g, sh: RwkvHeads, dtype):
    """This rank's columns of the WKV output ``o`` (…, nh hd), from
    ``sh.off`` into its first head, gated by its columns of ``silu(g)``,
    times its rows of ``w_o``: a partial sum on a model axis that cuts
    them."""
    o = o[..., sh.off:sh.off + sh.cols]
    return (o * F.silu(g.float())).to(dtype) @ p["w_o"]


def rwkv6_fwd(p, cfg: ModelConfig, x, chunk: int = CHUNK,
              return_state: bool = False, tp=None):
    """RWKV-6 time-mix sublayer (pre-norm handled by the caller).
    x: (B,S,D); the WKV recurrence runs in chunks of ``chunk`` steps, the
    sequence padded to a multiple of it.  With ``return_state`` also
    returns {"S": the WKV state
    (B,H,hd,hd) f32, "x_tm", "x_cm": x's last row}.  On a model axis
    ``tp``, the heads that this rank's columns of the column-parallel
    ``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_w`` meet (``sharding.rwkv_heads``:
    H/M heads where M divides them, else the columns gathered and a head
    cut between two ranks computed on both, :func:`_rwkv_met`), the WKV
    kernel and the state on those heads, and the partial sum of its
    columns of the output times its ``w_o`` rows, which the caller adds
    over the axis.  Where the axis does not divide ``d_model``, every
    leaf is whole: every head on every rank, the whole state and a whole
    output."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    sh = _rwkv_span(cfg, tp)
    H = sh.nh
    xp = _token_shift(x)
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = _mixed(x, xp, mix, tp, [sh.cols < D] * 5)
    r, k, v, w = _rwkv_met(p, (xr, xk, xv, xw), sh, hd, tp)
    r, k, v = (t.reshape(B, S, H, hd).float() for t in (r, k, v))
    g = xg @ p["w_g"]
    w = _decay(w).reshape(B, S, H, hd)
    # pad the sequence to a chunk multiple: zero k adds nothing and w = 1
    # keeps the state unchanged, so the final state stays exact
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    out = wkv(r, k, v, w, _rwkv_u(p, sh, tp), chunk=chunk,
              return_state=return_state)
    o, s_fin = out if return_state else (out, None)
    if pad:
        o = o[:, :S]
    y = _rwkv_out(p, o.reshape(B, S, H * hd), g, sh, x.dtype)
    if return_state:
        return y, {"S": s_fin, "x_tm": x[:, -1], "x_cm": x[:, -1]}
    return y


def _channel_mix(p, cfg: ModelConfig, x, xp, tp=None):
    """On a model axis ``tp``: ``cm_k`` and ``cm_r`` split by columns,
    ``cm_v`` by rows.  The gate ``sigmoid(xr @ cm_r)`` then holds this
    rank's D/M channels; it is gathered over the axis (``gather_from``:
    what reads it is replicated) and multiplies the sum over the axis of
    ``kk @ cm_v``'s partial sums (``reduce_from``), so every rank returns
    the whole output.  Where the axis does not divide ``d_ff``, ``cm_k``
    is by rows or whole and ``kk`` whole (:func:`_whole`), ``cm_v`` by
    columns or whole (:func:`_gathered`); where it does not divide
    ``d_model``, ``cm_r`` is whole and so is the gate."""
    D, F_ = cfg.d_model, cfg.d_ff
    k_cut = tp is not None and tuple(p["cm_k"].shape) != (D, F_)
    r_cut = tp is not None and p["cm_r"].shape[1] < D
    mix = p["cm_mix"].to(x.dtype)
    xk, xr = _mixed(x, xp, mix, tp, (k_cut, r_cut))
    gate = torch.sigmoid((xr @ p["cm_r"]).float()).to(x.dtype)
    if r_cut:
        gate = tp.gather_from(gate, -1)
    if tp is not None and p["cm_k"].shape[1] == F_:
        kk = torch.square(F.relu(_whole(tp, xk, p["cm_k"])[0]))
        return gate * _gathered(tp, kk, p["cm_v"], D)
    kk = torch.square(F.relu(xk @ p["cm_k"]))
    if tp is None:
        return gate * (kk @ p["cm_v"])
    return gate * tp.reduce_from(kk @ p["cm_v"])


def rwkv6_channel_mix(p, cfg: ModelConfig, x, tp=None):
    return _channel_mix(p, cfg, x, _token_shift(x), tp)


def rwkv6_channel_mix_decode(p, cfg: ModelConfig, x, x_cm_prev, tp=None):
    """Single-token channel mix.  x: (B,1,D); x_cm_prev: (B,D).  Returns
    (y (B,1,D), x's row to carry)."""
    xt = x[:, 0]
    return _channel_mix(p, cfg, xt, x_cm_prev, tp)[:, None], xt


def rwkv6_decode(p, cfg: ModelConfig, x, state, tp=None):
    """Single-token time mix.  state = {"S": (B,H,hd,hd) f32, "x_tm":
    (B,D)}.  Returns (y (B,1,D), the new state).  On a model axis ``tp``,
    as :func:`rwkv6_fwd`: the state of the heads this rank meets, and y
    the partial sum of its ``w_o`` rows."""
    B = x.shape[0]
    hd = cfg.rwkv_head_dim
    sh = _rwkv_span(cfg, tp)
    H = sh.nh
    xt = x[:, 0]
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = _mixed(xt, state["x_tm"], mix, tp,
                                [sh.cols < cfg.d_model] * 5)
    r, k, v, w = _rwkv_met(p, (xr, xk, xv, xw), sh, hd, tp)
    r, k, v = (t.reshape(B, H, hd).float() for t in (r, k, v))
    g = xg @ p["w_g"]
    w = _decay(w).reshape(B, H, hd)
    S = state["S"]
    o = torch.einsum("bhd,bhde->bhe", r, S) + torch.einsum(
        "bhd,bhd->bh", r, _rwkv_u(p, sh, tp)[None] * k)[..., None] * v
    S = w[..., None] * S + k[..., None] * v[:, :, None, :]
    y = _rwkv_out(p, o.reshape(B, H * hd), g, sh, x.dtype)[:, None]
    return y, dict(state, S=S, x_tm=xt)
