"""AdamW with f32 master weights, global-norm clipping, cosine schedule,
the multilevel gradient sync and an optional ZeRO-1 mode.

Counterpart of ``repro/optim/adamw.py``.  ``OptConfig``, ``lr_at``,
``scatter_axes``, ``_adamw_math`` and ``init_opt_state`` are copies; the
update writes the optimiser state in place, where the reference's jitted
train step donates it.
``apply_updates`` runs on every rank of a ``launch.mesh.Grid`` (the
reference runs inside ``shard_map`` over the (pod, data) axes) and syncs
each leaf over the grid's process groups: flat (one all-reduce over all
ranks), multilevel (reduce-scatter in the pod, the slow exchange on the
1/|data| shard, all-gather), multilevel_compress (the slow hop as int8
with an error-feedback residual), bucketed (fused buffers in reverse leaf
order), and under ZeRO-1 the sync stops after the slow hop: each rank
updates its shard of the optimiser state and all-gathers updated
parameters.  ``shard_opt_state`` cuts the global state to this rank's
shard, the counterpart of ``opt_manual_specs``, and ``gather_opt_state``
puts the shards back together into the global state (for a checkpoint).
One rank (no grid) is the identity sync.

On a model axis (``grid.tp``) each rank holds its model shard of the
parameters, gradients and state, as the reference's update sees them
inside its inner ``shard_map`` that is manual over ``model``:
``model_dims`` (a tree of ints, the model-sharded dim of each leaf, -1
where it is replicated) keeps the scatter axes off the model-sharded dim,
the sync runs over the data-parallel axes of the rank's model index
(beside the model shards, never across them), and the global norm adds
its squares over the model axis as well, as the reference's does:
a leaf replicated over ``model`` counts once on each model rank.
``shard_opt_state`` and ``gather_opt_state`` go between a model shard's
state and its data-parallel shards; ``models.convert.shard_params`` and
``gather_shards`` go between the global state and the model shards.

The trees are walked leaf by leaf, so the scatter axes, the int8 blocks
and the EF rows follow the layout of the tree given; the train step passes
the reference's stacked-run layout (``models.convert.stack_runs``), so
they are the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..core import compression
from ..core.collectives import bucketed_psum_tree
from ..launch.mesh import Grid
from ..tree import tree_leaves, tree_map

__all__ = ["OptConfig", "scatter_axes", "init_opt_state", "shard_opt_state",
           "gather_opt_state", "apply_updates", "lr_at"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    zero1: bool = True
    # gradient communication: flat | multilevel | multilevel_compress
    comm_mode: str = "multilevel"
    # size-targeted gradient buckets (wire bytes); dense modes only
    bucket_bytes: float | None = None
    # quantiser kernel toggle of the compressed slow hop (None -> auto)
    quant_kernel: bool | None = None

    def __post_init__(self):
        if (self.quant_kernel is not None
                and self.comm_mode != "multilevel_compress"):
            raise ValueError("quant_kernel only applies to "
                             "comm_mode='multilevel_compress'")
        if self.bucket_bytes is not None:
            if self.bucket_bytes <= 0:
                raise ValueError("bucket_bytes must be positive")
            if self.comm_mode not in ("flat", "multilevel"):
                raise ValueError("bucketed gradient sync supports "
                                 "comm_mode 'flat'/'multilevel' only")
            if self.sharded_state:
                raise ValueError("bucketed gradient sync requires "
                                 "zero1=False (the ZeRO-1 path scatters "
                                 "per leaf)")

    @property
    def error_feedback(self) -> bool:
        """True when the opt state carries an EF residual (the int8
        slow-hop exchange of ``multilevel_compress``)."""
        return self.comm_mode == "multilevel_compress"

    @property
    def sharded_state(self) -> bool:
        """True when the opt state lives as 1/|data| shards (ZeRO-1; the
        flat baseline always keeps it dense)."""
        return self.zero1 and self.comm_mode != "flat"


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay; f32."""
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos).float()


def scatter_axes(params: Any, n: int, model_dims: Any | None = None) -> Any:
    """For each leaf: the dim to reduce-scatter over the fast axis (size
    ``n``), the largest that ``n`` divides (the first of equals) that is
    not the leaf's model-sharded dim (``model_dims``, -1 for none), else
    the largest that ``n`` divides, or None if none does.  Decided on the
    shapes given: the train step gives the model shards, as the
    reference's update sees them."""
    def pick(leaf, mdim):
        shape = leaf.shape
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for avoid_model in (True, False):
            for i in order:
                if shape[i] % n == 0 and (not avoid_model or i != mdim):
                    return i
        return None
    if model_dims is None:
        model_dims = tree_map(lambda _: -1, params)
    return tree_map(pick, params, model_dims)


def _adamw_math(m, v, g, master, cfg: OptConfig, lr, t):
    """The reference's AdamW step on one leaf, in place on ``m``, ``v`` and
    ``master`` (returned): the same operations in the same order, so the
    same values, with one copy of the state held (the reference's jitted
    step donates it; recurrentgemma-2b's 2.9 B parameters hold 32 GiB of
    it)."""
    b1, b2 = cfg.betas
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    upd = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + cfg.eps)
    master.sub_(lr * (upd + cfg.weight_decay * master))
    return m, v, master


def init_opt_state(params: Any, cfg: OptConfig, n_slow: int = 1) -> dict:
    """m, v and master (f32 copies of the params) mirroring ``params``, the
    step counter (int32), and in the compressed mode an ``ef`` residual of
    shape ``(n_slow,) + param.shape`` per leaf."""
    zeros = tree_map(lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                           device=l.device), params)
    master = tree_map(lambda l: l.detach().to(torch.float32, copy=True),
                      params)
    dev = tree_leaves(params)[0].device
    state = {"m": zeros, "v": tree_map(torch.clone, zeros),
             "master": master,
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.error_feedback:
        state["ef"] = tree_map(
            lambda l: torch.zeros((max(n_slow, 1),) + tuple(l.shape),
                                  dtype=torch.float32, device=l.device),
            params)
    return state


def shard_opt_state(opt: dict, params: Any, cfg: OptConfig, grid: Grid,
                    model_dims: Any | None = None) -> dict:
    """This rank's shard of the optimiser state (the per-rank view of the
    reference's ``opt_manual_specs``): ``opt`` is the global state, or on
    a model axis the state of this rank's model shard (``params``, with
    ``model_dims``; ``models.convert.shard_params`` cuts it).  Under
    ZeRO-1 m, v and master keep the rank's chunk along each leaf's scatter
    axis; otherwise they are whole.  The EF residual keeps the rank's pod
    row and its chunk along the scatter axis in both modes, shape ``(1,) +
    shard``."""
    axes = scatter_axes(params, grid.data, model_dims)
    d, pod = grid.fast.index, 0 if grid.slow is None else grid.slow.index

    def chunk(t, ax, lead=0):
        if ax is None:
            return t.clone()
        n = t.shape[ax + lead] // grid.data
        return t.narrow(ax + lead, d * n, n).clone()

    out = dict(opt)
    if cfg.sharded_state:
        for k in ("m", "v", "master"):
            out[k] = tree_map(chunk, opt[k], axes)
    if cfg.error_feedback:
        out["ef"] = tree_map(lambda e, ax: chunk(e[pod:pod + 1], ax, 1),
                             opt["ef"], axes)
    return out


def gather_opt_state(opt: dict, params: Any, cfg: OptConfig, grid: Grid,
                     model_dims: Any | None = None) -> dict:
    """The state of this rank's model shard (the global state without a
    model axis) from every data-parallel rank's shard, on every rank: the
    inverse of :func:`shard_opt_state`.  Under ZeRO-1 m, v and master are
    all-gathered along each leaf's scatter axis over the fast axis (the
    pods hold replicas); the EF rows are gathered over both axes into
    ``(n_slow,) + shard``.  A collective over the grid's data-parallel
    axes."""
    axes = scatter_axes(params, grid.data, model_dims)

    def whole(t, ax, lead=0):
        return t if ax is None else grid.fast.all_gather(t, ax + lead)

    out = dict(opt)
    if cfg.sharded_state:
        for k in ("m", "v", "master"):
            out[k] = tree_map(whole, opt[k], axes)
    if cfg.error_feedback:
        def rows(e, ax):
            e = whole(e, ax, 1)
            return e if grid.slow is None else grid.slow.all_gather(e, 0)
        out["ef"] = tree_map(rows, opt["ef"], axes)
    return out


def _sync_shard(g, ax, grid: Grid, cfg: OptConfig, ef=None):
    """Multilevel stages 1 and 2 for one leaf: reduce-scatter over the fast
    axis (an all-reduce where no dim divides), then the (optionally int8)
    exchange over the slow axis on the 1/|data| shard.  With ``ef``, the
    leaf's residual (shard-shaped), returns ``(g, new_ef)``."""
    g = g.float()
    g = grid.fast.psum(g) if ax is None else grid.fast.psum_scatter(g, ax)
    new_ef = ef
    if grid.slow is not None:
        if cfg.comm_mode == "multilevel_compress":
            shp = g.shape
            if ef is not None:
                g, new_ef = compression.compressed_psum(
                    g.reshape(-1), grid.slow, ef=ef.reshape(-1),
                    use_kernel=cfg.quant_kernel)
                g, new_ef = g.reshape(shp), new_ef.reshape(shp)
            else:
                g = compression.compressed_psum(
                    g.reshape(-1), grid.slow,
                    use_kernel=cfg.quant_kernel).reshape(shp)
        else:
            g = grid.slow.psum(g)
    return g if ef is None else (g, new_ef)


def _clip_scale(gn2, cfg: OptConfig):
    return torch.clamp(cfg.clip_norm / torch.clamp_min(torch.sqrt(gn2),
                                                       1e-12), max=1.0)


def _update(grads: list, opt, cfg: OptConfig, scale, lr, t):
    """AdamW on every leaf of ``opt``, in place; ``grads`` the list of the
    synced f32 gradient leaves, each dropped from it once its leaf is
    updated (the caller holds no other reference), so that one leaf's
    temporaries, not a second copy of the gradient, top the state.
    Returns the (m, v, master) trees."""
    grads.reverse()
    for m, v, w in zip(tree_leaves(opt["m"]), tree_leaves(opt["v"]),
                       tree_leaves(opt["master"])):
        _adamw_math(m, v, grads.pop() * scale, w, cfg, lr, t)
    return opt["m"], opt["v"], opt["master"]


def _model_sum(gn2, grid: Grid):
    """The squared norm summed over the model axis, as the reference's
    ``psum`` over ``model`` (``repro/optim/adamw.py:282,291``)."""
    return gn2 if grid.tp is None else grid.tp.psum(gn2.reshape(1))[0]


@torch.no_grad()
def apply_updates(params: Any, grads: Any, opt: dict, cfg: OptConfig,
                  grid: Grid | None = None,
                  model_dims: Any | None = None) -> tuple[Any, dict]:
    """Gradient sync over ``grid`` (one rank if None), global-norm clip and
    AdamW on the f32 master; returns (params cast back to their dtypes,
    opt).  Under ZeRO-1 the opt leaves are this rank's shards
    (``shard_opt_state``).  On a model axis the trees are this rank's
    model shards, ``model_dims`` their model-sharded dims.  ``opt`` is
    donated, as the reference's jitted step donates its state: its m, v
    and master are updated in place and returned, and the ``opt`` passed
    in is not to be read again."""
    grid = grid or Grid.single()
    data_size, dp_degree = grid.data, grid.world
    t = opt["step"] + 1
    lr = lr_at(cfg, opt["step"])
    axes = scatter_axes(params, data_size, model_dims)
    pick = lambda pairs, i: tree_map(lambda _, r: r[i], grads, pairs)

    if not cfg.sharded_state:
        # the flat baseline or dense state: full grads on every rank
        new_ef = opt.get("ef")
        if cfg.bucket_bytes is not None:
            grads = bucketed_psum_tree(
                tree_map(lambda g: g.float(), grads), grid,
                bucket_bytes=cfg.bucket_bytes, mode=cfg.comm_mode,
                mean_over=dp_degree)
        elif cfg.comm_mode == "flat":
            grads = tree_map(lambda g: grid.dp.psum(g.float()) / dp_degree,
                             grads)
        elif cfg.error_feedback:
            def ml_ef(g, ax, e):
                gs, ne = _sync_shard(g, ax, grid, cfg, e[0])
                gs = gs / dp_degree
                if ax is not None:
                    gs = grid.fast.all_gather(gs, ax)
                return gs, ne[None]
            pairs = tree_map(ml_ef, grads, axes, opt["ef"])
            grads, new_ef = pick(pairs, 0), pick(pairs, 1)
        else:
            def ml(g, ax):
                gs = _sync_shard(g, ax, grid, cfg) / dp_degree
                return gs if ax is None else grid.fast.all_gather(gs, ax)
            grads = tree_map(ml, grads, axes)
        gn2 = _model_sum(sum(torch.dot(g.reshape(-1), g.reshape(-1))
                             for g in tree_leaves(grads)), grid)
        scale = _clip_scale(gn2, cfg)
        grads = tree_leaves(grads)      # the tree goes: _update frees each
        new_m, new_v, new_w = _update(grads, opt, cfg, scale, lr, t)
        new_params = tree_map(lambda w, p: w.to(p.dtype), new_w, params)
        out = dict(opt, m=new_m, v=new_v, master=new_w, step=t)
        if new_ef is not None:
            out["ef"] = new_ef
        return new_params, out

    # ---------------- ZeRO-1 ---------------- #
    new_ef = None
    if cfg.error_feedback:
        pairs = tree_map(lambda g, ax, e: _sync_shard(g, ax, grid, cfg, e[0]),
                         grads, axes, opt["ef"])
        shards = tree_map(lambda _, r: r[0] / dp_degree, grads, pairs)
        new_ef = tree_map(lambda _, r: r[1][None], grads, pairs)
    else:
        shards = tree_map(
            lambda g, ax: _sync_shard(g, ax, grid, cfg) / dp_degree,
            grads, axes)

    # the global norm from the shards: they tile the gradient, except the
    # leaves no dim of which divides, replicated on the fast axis
    def sq(g, ax):
        s = torch.dot(g.reshape(-1), g.reshape(-1))
        return s if ax is not None else s / data_size
    gn2 = sum(tree_leaves(tree_map(sq, shards, axes)))
    gn2 = _model_sum(grid.fast.psum(gn2.reshape(1))[0], grid)
    scale = _clip_scale(gn2, cfg)
    shards = tree_leaves(shards)        # the tree goes: _update frees each
    new_m, new_v, new_w = _update(shards, opt, cfg, scale, lr, t)

    # stage 3: all-gather updated params over the fast axis, cast to their
    # dtype first (half the bytes for bf16)
    def gather(w, ax, p):
        wc = w.to(p.dtype)
        return wc if ax is None else grid.fast.all_gather(wc, ax)
    new_params = tree_map(gather, new_w, axes, params)
    out = dict(opt, m=new_m, v=new_v, master=new_w, step=t)
    if new_ef is not None:
        out["ef"] = new_ef
    return new_params, out
