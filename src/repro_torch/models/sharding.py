"""Which dim of each parameter the model axis shards: the port's copy of
``repro/models/sharding.py``.

Topology-aware placement, per the paper's principle: the tensor-parallel
(``model``) axis, whose collectives run every layer, is the innermost,
fastest group of ranks and never crosses a pod (``launch.mesh.make_grid``
puts the M ranks of a model group next to each other); the data-parallel
axes (``pod``, ``data``) carry one gradient collective a step.

The rules are the reference's, name-based over the parameter tree (``_RULES``
and ``_dim_for``, its ``_spec_for`` with its two fallbacks: a dim that does
not divide by the model-axis size moves to the other matmul dim, else the
leaf is replicated).  The reference decides on its run-stacked shapes, a
leading dim of the run's layers; the port keeps one dict per layer, so a
layer's leaf is decided on ``(n,) + shape`` for its run of n layers and
the dim is given in the per-layer leaf.  That keeps the MoE gate
(``w_gate`` of an expert stack, 4-D once stacked) apart from the RG-LRU's
input gate (3-D once stacked).  One rule lands on the run dim itself: the
RG-LRU's ``w_out`` shares the expert stacks' name, and on a run whose
length the axis divides the reference splits the run's layers over the
ranks.  A per-layer tree cannot hold that split: its dim is ``RUN_DIM``,
the per-layer leaf stays whole on every rank, and the RG-LRU uses the
rows of its channels (``layers.rglru_fwd``); the stacked training layout
holds the rank's layers of the run (``convert.model_dims``: dim 0).

The flat-dim rule cuts ``wq``, ``wk`` and ``wv`` inside a head where the
axis does not divide the heads (recurrentgemma-2b's 10 query heads of 256
at M 4: 640 columns a rank, two and a half heads; its one KV head at M 2:
128 of its 256 columns).  The port keeps that cut, which ZeRO-1's scatter
dims, the checkpoints and the clipped norm read.  :func:`rank_heads`
gives a rank the query heads that its columns of ``wq`` meet and the KV
heads those read: the rank gathers the ranks' columns of q (and of k and
v, ``layers._kv``), computes attention on whole heads, and keeps its own
columns of the output for its rows of ``wo``.  A head that spans two
ranks is computed on both.  The embedding falls back to replicated where
the axis does not divide the vocabulary; a tied head is then whole on
every rank.

Where the axis does not divide a leaf's dim, the fallback's placement is
computed as it lands: a leaf moved to its other matmul dim (``wq``,
``wk``, ``wv``, an MLP's ``wi``/``wg`` by rows; ``wo``, an expert's
``w_out`` by columns) or replicated.  A whole input times a leaf's rows
gives a partial sum over the axis, times its columns the rank's columns
of the output (gathered whole), times a whole leaf a whole output,
computed on every rank.  Where ``wq`` is not cut by columns every rank
computes every head (:func:`rank_heads`); where the axis does not divide
the experts, every rank runs every expert (the reference's dense block,
no drops); a whole RG-LRU or RWKV-6 runs on every channel or head
(:func:`rank_count`, :func:`rwkv_heads`).

Three fallbacks cut a leaf inside the unit its consumer reads whole, and
each is computed from the leaf's shard as it lands.  An expert's
``w_in``/``w_gate`` by its features (the axis divides those but not the
experts): every rank computes its feature columns of every expert's
hidden, gathers them whole (``layers._moe_experts``) and multiplies by
its columns of ``w_out``, or, where ``w_out`` stays whole, by its rows
of it, a partial sum.  RWKV-6's time-mix columns inside a head (the axis
divides ``d_model`` but not the heads): :func:`rwkv_heads` gives a rank
the heads its columns meet, which it computes whole from the gathered
columns, keeping its own columns of the output.  An untied head by rows
(the axis divides ``d_model`` but not the vocabulary): the rank's slice
of the hidden states times its rows gives partial logits, summed over
the axis.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

from .config import ModelConfig

__all__ = ["RUN_DIM", "param_model_dims", "RankHeads", "rank_heads",
           "RwkvHeads", "rwkv_heads", "rank_count", "layer_model_dims",
           "cut_shard", "dp_axes", "batch_pspec"]

RUN_DIM = -2      # the reference splits the run's layers over the axis

# leaf name -> which logical dim to shard over "model"
#   "col": the LAST dim (output features)
#   "row": the SECOND-TO-LAST dim (input features)
#   "expert": the expert dim (ndim-3 with run stacking)
#   None: replicate
_RULES: dict[str, str | None] = {
    "embed": "vocab", "lm_head": "col",
    "wq": "col", "wk": "col", "wv": "col", "wo": "row",
    "wi": "col", "wg": "col",
    "router": None,
    "w_in": "expert", "w_out": "expert",
    "w_x": "col", "w_a": "col", "w_i": "col",
    "conv": None, "lam": None,
    "w_r": "col", "w_k": "col", "w_v": "col", "w_g": "col", "w_w": "col",
    "w_o": "row", "u": None, "mix": None,
    "cm_k": "col", "cm_v": "row", "cm_r": "col", "cm_mix": None,
}


def _dim_for(name: str, shape: tuple, model_size: int) -> int:
    """The reference's ``_spec_for`` on a (run-stacked) shape: the index
    of the dim sharded over ``model``, or -1 for a replicated leaf."""
    if model_size <= 1:
        return -1
    rule = _RULES.get(name)
    # the MoE gate shares the name "w_gate" with the RG-LRU's input gate:
    # expert tensors are 4-D once run-stacked
    if name == "w_gate":
        rule = "expert" if len(shape) >= 4 else "col"
    axis = {"vocab": 0, "col": len(shape) - 1, "row": len(shape) - 2,
            "expert": len(shape) - 3}.get(rule)
    if axis is None:
        return -1
    if shape[axis] % model_size != 0:
        # fall back: try the other matmul dim, else replicate
        alt = len(shape) - 1 if rule in ("row", "expert") else len(shape) - 2
        if 0 <= alt < len(shape) and shape[alt] % model_size == 0 \
                and alt != axis:
            axis = alt
        else:
            return -1
    return axis


def _dims(tree, model_size: int, run: int, name: str = ""):
    """The dims of a subtree; ``run`` the length of the layer's run, 0 for
    a leaf outside the layers."""
    if isinstance(tree, dict):
        return {k: _dims(v, model_size, run, k) for k, v in tree.items()}
    shape = tuple(tree.shape)
    if not run:
        return _dim_for(name, shape, model_size)
    dim = _dim_for(name, (run,) + shape, model_size)
    return {-1: -1, 0: RUN_DIM}.get(dim, dim - 1)


def layer_model_dims(layer: dict, model_size: int, run: int = 1) -> dict:
    """:func:`param_model_dims` of one layer's dict, decided on its shapes
    stacked for a run of ``run`` layers."""
    return _dims(layer, model_size, run)


def _run_lens(cfg: ModelConfig | None, kinds, n: int) -> list[int]:
    if cfg is None:
        return [1] * n
    return [k for _, k in kinds for _ in range(k)]


def param_model_dims(params: dict, model_size: int,
                     cfg: ModelConfig | None = None) -> dict:
    """A tree mirroring the port's ``params``: for each leaf the dim that
    is sharded over a model axis of ``model_size`` ranks, -1 where the
    leaf is replicated, ``RUN_DIM`` where the reference splits the layers
    of its run.  ``cfg`` gives each layer its run's length (without it a
    layer is a run of one, which changes only ``RUN_DIM`` leaves).  Any
    object with a ``shape`` serves as a leaf."""
    out = {}
    for k, v in params.items():
        if k == "layers":
            runs = _run_lens(cfg, cfg.runs() if cfg else (), len(v))
            out[k] = [layer_model_dims(l, model_size, n)
                      for l, n in zip(v, runs)]
        elif k == "enc":
            n_enc = len(v["layers"])
            runs = _run_lens(cfg, [("attn", n_enc)], n_enc)
            out[k] = {"layers": [layer_model_dims(l, model_size, n)
                                 for l, n in zip(v["layers"], runs)],
                      "final_norm": _dims(v["final_norm"], model_size, 0,
                                          "final_norm")}
        else:
            out[k] = _dims(v, model_size, 0, k)
    return out


def cut_shard(t, dim: int, model: int, m: int):
    """Rank ``m``'s slice of tensor ``t`` along ``dim`` of ``model`` equal
    parts, a copy that does not hold ``t``'s storage; ``t`` itself where
    ``dim`` is negative."""
    if dim < 0:                     # replicated, or RUN_DIM
        return t
    n = t.shape[dim] // model
    part = t.narrow(dim, m * n, n)
    return part.clone() if part.is_contiguous() else part.contiguous()


class RankHeads(NamedTuple):
    """Rank ``m``'s share of the attention heads on a model axis: its
    query heads ``q0 .. q0 + nq - 1`` (those that its columns of ``wq``
    meet), ``off`` the first of its columns inside head ``q0``, its KV
    heads ``kv0 .. kv0 + nkv - 1`` (those that its query heads read) and
    ``kv_of``, the KV head (counted from ``kv0``) that each of its query
    heads reads."""
    q0: int
    nq: int
    off: int
    kv0: int
    nkv: int
    kv_of: tuple

    @property
    def grouped(self) -> bool:
        """Whether the query heads read the KV heads in equal groups, in
        order (head i reads KV head i // (nq / nkv)), as GQA lays them
        out."""
        g = self.nq // self.nkv
        return self.nq % self.nkv == 0 and \
            self.kv_of == tuple(i // g for i in range(self.nq))


@functools.lru_cache(maxsize=None)
def rank_heads(cfg: ModelConfig, model: int = 1, m: int = 0) -> RankHeads:
    """Rank ``m``'s :class:`RankHeads` on a model axis of ``model``, whose
    cut of ``wq`` is the columns ``[m Q/M, (m+1) Q/M)`` of ``Q = n_heads
    * head_dim``.  Where M divides the heads: ``H/M`` heads from ``m
    H/M``, no offset.  Where M does not divide ``Q``, ``wq`` is cut by
    rows or whole, q is whole, and every rank has every head."""
    hd, G = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    if cfg.q_dim % model:
        return RankHeads(0, cfg.n_heads, 0, 0, cfg.n_kv_heads,
                         tuple(h // G for h in range(cfg.n_heads)))
    c = cfg.q_dim // model
    lo, hi = m * c, (m + 1) * c
    q0, q1 = lo // hd, (hi - 1) // hd + 1
    kv0 = q0 // G
    return RankHeads(q0, q1 - q0, lo - q0 * hd, kv0, (q1 - 1) // G + 1 - kv0,
                     tuple(h // G - kv0 for h in range(q0, q1)))


def rank_count(n: int, model: int) -> int:
    """A rank's share of the RG-LRU's ``n`` channels, which the axis cuts
    where it divides them: ``n / M``, else ``n``, their leaves whole and
    every channel computed on every rank."""
    return n if n % model else n // model


class RwkvHeads(NamedTuple):
    """Rank ``m``'s share of RWKV-6's time mix on a model axis: its
    ``cols`` columns of ``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_w`` (and
    rows of ``w_o``), from ``off`` inside head ``h0``, meet the heads
    ``h0 .. h0 + nh - 1``."""
    h0: int
    nh: int
    off: int
    cols: int


@functools.lru_cache(maxsize=None)
def rwkv_heads(cfg: ModelConfig, model: int = 1, m: int = 0) -> RwkvHeads:
    """Rank ``m``'s :class:`RwkvHeads` on a model axis of ``model``, whose
    cut of the time mix is the columns ``[m D/M, (m+1) D/M)``.  Where M
    divides the heads: ``H/M`` heads from ``m H/M``, no offset; where it
    divides ``d_model`` but not the heads, the heads its columns meet (a
    head that spans two ranks is met by both); where it does not divide
    ``d_model``, the leaves are whole and every rank has every head."""
    D, hd = cfg.d_model, cfg.rwkv_head_dim
    if D % model:
        return RwkvHeads(0, D // hd, 0, D)
    c = D // model
    lo, hi = m * c, (m + 1) * c
    h0 = lo // hd
    return RwkvHeads(h0, (hi - 1) // hd + 1 - h0, lo - h0 * hd, c)


def dp_axes(pods: int) -> tuple[str, ...]:
    """Data-parallel axes of a grid, slowest first (``pod`` only where the
    grid has more than one)."""
    return ("pod", "data") if pods > 1 else ("data",)


def batch_pspec(pods: int) -> tuple:
    """The batch dim sharded over every data-parallel axis, as the
    reference's ``P(dp_axes)`` reads (one axis as its name)."""
    axes = dp_axes(pods)
    return (axes[0] if len(axes) == 1 else axes,)
