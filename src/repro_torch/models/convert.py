"""Carry parameters and optimiser state between the port's per-layer tree,
the reference's stacked-run layout, and numpy.

``repro.models.transformer.init_model`` returns a tree whose layers are
stacked per run of identical block kinds (leading dim = layers in the
run): ``{"embed", "final_norm", ["lm_head"], "runs": [run, ...],
["enc": {"runs": [run], "final_norm"}]}``.  The port's model keeps one
dict per layer (``"layers"``, and ``enc["layers"]``).  ``stack_runs`` and
``unstack_runs`` go between the two on the device; ``unstack_runs`` gives
views, so a model can run on stacked parameters without a copy (the
train step differentiates the stacked leaves through them).  The
training path keeps parameters, gradients for the sync and the optimiser
state in the stacked layout, so scatter axes, int8 blocks and EF rows are
the reference's.

The dense serving caches (``transformer.init_cache``/``prefill``) already
use the reference's layout, one stacked entry per run; ``cache_from_jax``
and ``cache_to_numpy`` carry them across.

Trees cross the framework boundary as numpy arrays, with bf16 leaves as
their uint16 bit patterns (numpy has no bf16), so the values arrive bit
for bit; the port's checkpoints hold the same numpy layout, so the two
packages read each other's checkpoints.

``shard_params`` cuts rank m's share of a model axis out of the full
parameters (by ``sharding.param_model_dims``), so ``params_from_jax``
followed by it carries the reference's parameters to each rank;
``unshard_params`` puts the ranks' shares back together, and
``gather_shards`` does so over the ranks' model axis.  All three take the
port's per-layer tree, the stacked layout, or an optimiser state of the
stacked layout (m, v, master, the step, and the EF residual, whose rows
lead ``(n_slow,)`` ahead of the shard).  ``model_dims`` gives the stacked
layout's dims, the ``model_dims`` of ``optim.adamw``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.backend import resolve_device
from ..tree import tree_map
from .config import ModelConfig
from .sharding import RUN_DIM, cut_shard, param_model_dims
from .transformer import port_check

__all__ = ["stack_runs", "unstack_runs", "from_numpy", "to_numpy",
           "params_from_jax", "params_to_jax", "cache_from_jax",
           "cache_to_numpy", "model_dims", "shard_params", "unshard_params",
           "gather_shards"]


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.array(a)                  # a writable copy torch can own
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    if a.dtype in (np.float32, np.int32):
        return torch.from_numpy(a).to(dev)
    raise ValueError(f"expected float32, int32 or uint16 (bf16 bits), got "
                     f"{a.dtype}")


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy(tree, *, device: str | torch.device = "cuda"):
    """A tree of numpy arrays (bf16 as uint16 bits) -> tensors on
    ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def to_numpy(tree):
    """A tree of tensors -> numpy arrays (bf16 as uint16 bits), the
    inverse of :func:`from_numpy`."""
    return tree_map(_numpy, tree)


def _stack(layers: list) -> dict:
    return {k: _stack([l[k] for l in layers]) if isinstance(layers[0][k], dict)
            else torch.stack([l[k] for l in layers]) for k in layers[0]}


def _unbind(run: dict, n: int, tp) -> list:
    """The ``n`` layers' dicts of one run's stacked leaves, views (a
    backward stacks their gradients once).  A leaf that holds fewer layers
    is this rank's part of a run that the model axis ``tp`` splits
    (``sharding.RUN_DIM``): it is gathered along the run dim with
    ``tp.gather_to`` first, whose backward hands each rank its layers'
    whole gradient."""
    cols = {}
    for k, v in run.items():
        if isinstance(v, dict):
            cols[k] = _unbind(v, n, tp)
            continue
        if v.shape[0] != n:
            if tp is None or v.shape[0] * tp.size != n:
                raise ValueError(f"{k} stacks {v.shape[0]} of a run of {n} "
                                 f"layers")
            v = tp.gather_to(v, 0)
        cols[k] = v.unbind(0)
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _enc_runs(cfg: ModelConfig) -> list:
    return [("attn", cfg.enc_dec.n_enc_layers)]


def _stack_layers(layers: list, runs: list) -> list:
    out, i = [], 0
    for _, n in runs:
        out.append(_stack(layers[i:i + n]))
        i += n
    return out


def _unstack_layers(stacked: list, runs: list, cfg: ModelConfig,
                    tp=None) -> list:
    if len(stacked) != len(runs):
        raise ValueError(f"tree has {len(stacked)} runs, config "
                         f"{cfg.name} has {len(runs)}")
    out = []
    for run, (kind, n) in zip(stacked, runs):
        if run["norm1"].shape[0] != n:
            raise ValueError(f"run of {kind} stacks {run['norm1'].shape[0]} "
                             f"layers, config says {n}")
        out += _unbind(run, n, tp)
    return out


def stack_runs(params: dict, cfg: ModelConfig, model: int = 1,
               m: int = 0) -> dict:
    """The port's per-layer tree -> the reference's stacked layout (a copy
    of the layer leaves).  With ``model`` > 1, ``params`` is rank ``m``'s
    per-layer model shard (``transformer.init_model(model=, m=)``), whose
    leaves on the run dim (``sharding.RUN_DIM``) are whole: the stacked
    shard holds the rank's layers of them, as ``shard_params`` of the
    stacked layout cuts them."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["runs"] = _stack_layers(params["layers"], cfg.runs())
    if cfg.enc_dec:
        out["enc"] = {"runs": _stack_layers(params["enc"]["layers"],
                                            _enc_runs(cfg)),
                      "final_norm": params["enc"]["final_norm"]}
    if model > 1:                       # a run's leaf on dim 0: RUN_DIM
        out["runs"] = tree_map(lambda t, d: cut_shard(t, 0, model, m)
                               if d == 0 else t, out["runs"],
                               model_dims(cfg, model)["runs"])
    return out


def unstack_runs(tree: dict, cfg: ModelConfig, tp=None) -> dict:
    """The reference's stacked layout -> the port's per-layer tree, each
    layer leaf a view into its run's stacked leaf.  On a model axis
    ``tp``, a model shard of it: a leaf cut along the run dim (the
    RG-LRU's ``w_out`` on a run the axis divides) is gathered over the
    axis first, so every layer gets its whole leaf."""
    out = {k: v for k, v in tree.items() if k != "runs"}
    out["layers"] = _unstack_layers(tree["runs"], cfg.runs(), cfg, tp)
    if cfg.enc_dec:
        out["enc"] = {"layers": _unstack_layers(tree["enc"]["runs"],
                                                _enc_runs(cfg), cfg),
                      "final_norm": tree["enc"]["final_norm"]}
    return out


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device: str | torch.device = "cuda") -> dict:
    """JAX parameter tree of numpy arrays -> the port's parameters."""
    port_check(cfg)
    return unstack_runs(from_numpy(tree, device=device), cfg)


def params_to_jax(params: dict, cfg: ModelConfig) -> dict:
    """The port's parameters -> the JAX parameter tree of numpy arrays
    (bf16 as uint16 bits), the inverse of :func:`params_from_jax`."""
    port_check(cfg)
    return to_numpy(stack_runs(params, cfg))


def cache_from_jax(cache: list, cfg: ModelConfig, *,
                   device: str | torch.device = "cuda") -> list:
    """The reference's dense cache (a list of per-run dicts of numpy
    arrays, bf16 as uint16 bits) -> the port's, on ``device``."""
    port_check(cfg)
    runs = cfg.runs()
    if len(cache) != len(runs):
        raise ValueError(f"cache has {len(cache)} runs, config {cfg.name} "
                         f"has {len(runs)}")
    for ent, (kind, n) in zip(cache, runs):
        names = {"rwkv6": {"S", "x_tm", "x_cm"},
                 "rglru": {"h", "conv"}}.get(kind, {"k", "v"})
        if cfg.enc_dec and kind in ("attn", "local"):
            names = names | {"xk", "xv"}
        if set(ent) != names or any(a.shape[0] != n for a in ent.values()):
            raise ValueError(f"a {kind} run of {n} layers caches {names} "
                             f"stacked {n}, got "
                             f"{ {k: a.shape for k, a in ent.items()} }")
    return from_numpy(cache, device=device)


def cache_to_numpy(cache: list) -> list:
    """The port's dense cache -> numpy arrays (bf16 as uint16 bits) in the
    reference's layout, the inverse of :func:`cache_from_jax`."""
    return to_numpy(cache)


def _full_dims(cfg: ModelConfig, model: int) -> dict:
    """``param_model_dims`` of ``cfg``'s full per-layer parameters, decided
    on their shapes (``init_model`` under a fake-tensor mode allocates
    nothing)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from . import transformer as T

    with FakeTensorMode():
        full = T.init_model(cfg, seed=0, device="cpu")
    return param_model_dims(full, model, cfg)


def _stacked(dims: dict) -> dict:
    """A layer's dims as its run's stacked leaf's: one leading dim."""
    return {k: _stacked(v) if isinstance(v, dict)
            else {-1: -1, RUN_DIM: 0}.get(v, v + 1) for k, v in dims.items()}


def model_dims(cfg: ModelConfig, model: int) -> dict:
    """The model-sharded dim of every leaf of ``cfg``'s parameters in the
    stacked layout (-1: replicated), for a model axis of ``model`` ranks."""
    port_check(cfg)
    dims = _full_dims(cfg, model)
    out = {k: v for k, v in dims.items() if k not in ("layers", "enc")}
    i, out["runs"] = 0, []
    for _, n in cfg.runs():
        out["runs"].append(_stacked(dims["layers"][i]))
        i += n
    if cfg.enc_dec:
        out["enc"] = {"runs": [_stacked(dims["enc"]["layers"][0])],
                      "final_norm": dims["enc"]["final_norm"]}
    return out


def _tree_dims(tree: dict, cfg: ModelConfig, model: int) -> dict:
    """The model-sharded dim of each leaf of ``tree``: per-layer
    parameters, stacked parameters, or an optimiser state of the stacked
    layout (the EF rows' leading dim shifts theirs; the step is whole)."""
    if "layers" in tree:
        return _full_dims(cfg, model)
    if "master" not in tree:
        return model_dims(cfg, model)
    dims = model_dims(cfg, model)
    out = {k: dims for k in ("m", "v", "master")}
    out["step"] = -1
    if "ef" in tree:
        out["ef"] = tree_map(lambda d: d + 1 if d >= 0 else d, dims)
    return out


def shard_params(params: dict, cfg: ModelConfig, model: int,
                 m: int) -> dict:
    """Rank ``m``'s share of the port's full ``params`` (or of a stacked
    tree or optimiser state, see :func:`_tree_dims`) on a model axis of
    ``model`` ranks: each leaf cut along its model-sharded dim (a copy of
    its own), replicated leaves kept whole."""
    port_check(cfg)
    return tree_map(lambda t, d: cut_shard(t, d, model, m), params,
                    _tree_dims(params, cfg, model))


def unshard_params(shards: list, cfg: ModelConfig) -> dict:
    """The full tree from every rank's share (``shards[m]`` of
    :func:`shard_params`), the inverse of it.  The dims are decided on the
    full shapes, which ``cfg`` gives."""
    port_check(cfg)
    return tree_map(lambda d, *ts: ts[0] if d < 0 else torch.cat(ts, d),
                    _tree_dims(shards[0], cfg, len(shards)), *shards)


def gather_shards(tree: dict, cfg: ModelConfig, tp) -> dict:
    """:func:`unshard_params` over the model axis ``tp`` (a
    ``launch.mesh.Axis``; None: ``tree`` itself): each rank's share
    all-gathered along its dim, the full tree on every rank."""
    if tp is None:
        return tree
    return tree_map(lambda t, d: t if d < 0 else tp.all_gather(t, d), tree,
                    _tree_dims(tree, cfg, tp.size))
