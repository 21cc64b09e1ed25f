"""The data-parallel train step of the port.

Counterpart of ``repro/launch/step.py:83 make_train_fn``.  The reference
runs ``value_and_grad(loss_fn)`` and ``apply_updates`` inside a
``shard_map`` over the (pod, data) axes; here each rank of a
``launch.mesh.Grid`` runs the step on its rows of the global batch
(``P(dp)``: rows split over the ranks in row-major (pod, data) order),
takes the loss and its gradients (autograd, through the flash kernels'
backward on the card) with respect to the reference's stacked run layout
(the layers read views of it, so a backward stacks each run's gradients
once), and calls ``apply_updates``, whose sync runs over the
grid's process groups.  The returned loss is the mean over the ranks
(``lax.pmean(loss, dp)``).  One rank is the grid of size 1.

On a grid with a model axis (``grid.tp``, M > 1) the reference runs the
forward and backward under GSPMD over ``model`` and the update in an
inner ``shard_map`` manual over it; here each rank holds its model shard
(``models.convert.shard_params``), the M ranks of a model group take the
same rows (``rank_rows`` indexes by the data-parallel rank), the forward
and backward run the model axis's differentiated collectives
(``transformer.loss_fn(tp=)``; a run's layers that the axis splits, the
RG-LRU's ``w_out``, are gathered along the run dim first), and
``apply_updates`` syncs each shard
over the data-parallel axes of its model index, with the model's
``convert.model_dims``.  ``Grid.tp``'s counters split the model axis's
collectives of a step: ``tp_calls`` holds the forward's, the backward's
(``copy_to``'s sums) and the forward's that the remat re-issues inside
the backward.

The paged serve steps run through ``serving.TorchExecutor``.  The dense
ones, ``make_prefill_fn`` and ``make_decode_fn``, are the counterparts of
the reference's ``:233``/``:243``: plain functions under
``torch.inference_mode`` (the reference jits them).  They serve what the
paged path refuses, the recurrent stacks (RWKV-6, RG-LRU) and enc-dec,
and prompts that carry a frontend's embeddings; given a grid with a model
axis, this rank's shard of an attention stack, its dense cache's sequence
split over the axis where the axis divides it, of RWKV-6 (the WKV state
of its heads), of the RG-LRU (the state of its channels) or of the
enc-dec config (the encoder on its heads, the cross cache of its KV
heads).

``layer_grad_bytes`` is a copy of the reference's ``:41``: the per-layer
gradient bytes the engine's bucketed-sync estimate takes, from the
parameter shapes alone (fake tensors; nothing is allocated).
``abstract_params`` is the reference's ``:31`` for the dry run: one model
rank's stacked shard on the ``meta`` device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.backend import resolve_device
from ..models import transformer as T
from ..models.config import ModelConfig
from ..models.convert import model_dims, stack_runs, unstack_runs
from ..optim import adamw
from ..tree import tree_leaves, tree_unflatten
from .mesh import Grid

__all__ = ["abstract_params", "device_batch", "rank_rows", "loss_and_grads",
           "make_train_step", "make_prefill_fn", "make_decode_fn",
           "layer_grad_bytes"]


def abstract_params(cfg: ModelConfig, model: int = 1, m: int = 0) -> dict:
    """Rank ``m``'s shard of the parameters on a model axis of ``model``
    (all of them on one rank), in the stacked run layout the train step
    takes, on the ``meta`` device: their shapes and dtypes, nothing
    drawn or allocated."""
    return stack_runs(T.init_model(cfg, device="meta", model=model, m=m),
                      cfg, model, m)


def layer_grad_bytes(cfg: ModelConfig, model_size: int = 1) -> list[float]:
    """Per-layer gradient wire bytes (f32 sync) in FORWARD order.

    Backward produces gradients for these entries last-to-first, which is
    exactly the issue order of the engine's bucketed gradient sync — feed
    this list to :func:`repro_torch.core.engine.overlapped_step_times`
    (the train launcher's overlap estimate does).  Entry 0 aggregates the
    non-layer leaves (embedding/head/norms): their gradients arrive at the
    very end of backward.  ``model_size`` divides out the tensor-parallel
    shard — the sync moves 1/model_size of the bytes per model slice.  The
    shapes come from ``init_model`` under a fake-tensor mode, which
    allocates no storage.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = T.init_model(cfg, seed=0, device="cpu")
    numel = lambda tree: sum(l.numel() for l in tree_leaves(tree))
    run_bytes = 0.0
    layers: list[float] = []
    i = 0
    for kind, n in cfg.runs():
        rb = 4.0 * sum(numel(l) for l in params["layers"][i:i + n])
        i += n
        run_bytes += rb
        layers.extend([rb / n] * n)
    total = 4.0 * numel(params)
    return [(total - run_bytes) / model_size] + [b / model_size
                                                for b in layers]


def device_batch(batch: dict, device) -> dict:
    """A host batch on ``device``: the integer arrays (tokens, labels) as
    int64, the float ones (a frontend's ``embeds``, an enc-dec config's
    ``src_embeds``) as f32, as the reference's ``global_batch`` places
    them; ``transformer.embed_inputs`` casts them to the model's dtype."""
    def put(v):
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        return t.to(device, torch.float32 if t.is_floating_point()
                    else torch.long)
    return {k: put(v) for k, v in batch.items()}


def rank_rows(batch: dict, grid: Grid) -> dict:
    """This rank's rows of a global host batch (arrays, or the dry run's
    ``meta`` tensors), whose rows must divide by the number of
    data-parallel ranks (a model group's ranks take the same rows)."""
    out = {}
    for k, v in batch.items():
        v = v if isinstance(v, torch.Tensor) else np.asarray(v)
        if v.shape[0] % grid.world:
            raise ValueError(f"batch of {v.shape[0]} rows does not split "
                             f"over {grid.world} ranks")
        n = v.shape[0] // grid.world
        out[k] = v[grid.rank * n:(grid.rank + 1) * n]
    return out


def loss_and_grads(params, cfg: ModelConfig, batch: dict, tp=None,
                   calls: dict | None = None):
    """(loss, grads): the mean cross-entropy and its gradient with respect
    to every parameter leaf, in the parameters' structure and dtypes:
    the per-layer tree, or the stacked layout (``convert.stack_runs``),
    whose per-layer views the loss reads (``convert.unstack_runs``).  On
    a model axis ``tp``, of this rank's shard ``params``; a stacked
    shard's leaves cut along the run dim (the RG-LRU's ``w_out``) are
    gathered over the axis inside the differentiated region
    (``Axis.gather_to``), whose backward hands each rank its layers' whole
    gradient.  ``calls`` gets the axis's collectives of the forward
    (``fwd``), of the backward (``bwd``: ``copy_to``'s sums and
    ``gather_to``'s reduce-scatters) and of the forward re-run under remat
    (``remat``)."""
    leaves = [l.detach().requires_grad_(True) for l in tree_leaves(params)]
    c0 = (tp.calls, tp.bwd_calls) if tp is not None else (0, 0)
    p = tree_unflatten(params, leaves)
    if "runs" in p:
        p = unstack_runs(p, cfg, tp)
    loss = T.loss_fn(p, cfg, batch, tp=tp)
    c1 = tp.calls if tp is not None else 0
    grads = torch.autograd.grad(loss, leaves)
    if tp is not None and calls is not None:
        bwd = tp.bwd_calls - c0[1]
        calls.update(fwd=c1 - c0[0], bwd=bwd,
                     remat=tp.calls - c1 - bwd)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                    grid: Grid | None = None,
                    device: str | torch.device = "cuda"):
    """``step(params, opt, batch) -> (params, opt, loss)`` for this rank of
    ``grid`` (one rank if None) on ``device``.  ``params`` is in the
    stacked-run layout (``models.convert.stack_runs``; on a model axis
    this rank's shard of it), ``opt`` this rank's shard of the state
    (``adamw.shard_opt_state``), ``batch`` the global host batch of
    ``DataPipeline.host_batch``.  The step donates ``opt``, as the
    reference's jitted step does: its m, v and master are updated in
    place and returned, and the ``opt`` passed in is not to be read
    again.  ``step.tp_calls`` holds the last step's model-axis
    collectives (:func:`loss_and_grads`' ``calls``)."""
    grid = grid or Grid.single()
    tp = grid.tp
    T.port_check(cfg)
    dev = resolve_device(device)
    mdims = model_dims(cfg, tp.size) if tp is not None else None

    def step(params, opt, batch):
        rows = device_batch(rank_rows(batch, grid), dev)
        loss, grads = loss_and_grads(params, cfg, rows, tp, step.tp_calls)
        params, opt = adamw.apply_updates(params, grads, opt, opt_cfg, grid,
                                          mdims)
        loss = grid.dp.psum(loss.reshape(1))[0] / grid.world
        return params, opt, loss

    step.tp_calls = {}
    return step


def _tp(cfg: ModelConfig, grid: Grid | None):
    T.port_check(cfg)
    return grid.tp if grid is not None else None


def make_prefill_fn(cfg: ModelConfig, s_max: int, grid: Grid | None = None):
    """``run(params, inputs) -> (logits (B,1,V) f32, cache, S)``: the
    prompt through the model, its dense cache sized for ``s_max`` tokens
    (``transformer.prefill``).  ``inputs``: ``tokens`` (B,S); a
    frontend's ``embeds`` (B,P,D), a prefix the cache and S count; an
    enc-dec config's ``src_embeds`` (B,Ss,D), the encoder's input, whose
    cross K/V the cache keeps.  On a ``grid`` with a model axis,
    ``params`` are this rank's shard and so is the cache."""
    tp = _tp(cfg, grid)

    def run(params, inputs):
        return T.prefill(params, cfg, inputs, s_max, tp=tp)
    return run


def make_decode_fn(cfg: ModelConfig, grid: Grid | None = None,
                   s_max: int | None = None):
    """``run(params, cache, tokens, pos) -> (logits (B,1,V) f32, cache)``:
    one greedy step over the dense cache, updated in place
    (``transformer.decode_step``), on this rank of ``grid``'s model axis
    where it has one.  ``s_max``, the prefill's, gives the cache's layout
    there (a model axis needs it)."""
    tp = _tp(cfg, grid)

    def run(params, cache, tokens, pos):
        return T.decode_step(params, cfg, cache, tokens, pos, tp=tp,
                             s_max=s_max)
    return run
