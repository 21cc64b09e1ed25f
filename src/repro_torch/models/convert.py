"""Carry parameters and optimiser state between the JAX package's layout
and the port's.

``repro.models.transformer.init_model`` returns a tree whose layers are
stacked per run of identical block kinds (leading dim = layers in the
run).  The port keeps one dict per layer.  The tree crosses the framework
boundary as numpy arrays, with bf16 leaves as their uint16 bit patterns
(numpy has no bf16), so the weights arrive bit for bit.  The same numpy
layout is what the port's checkpoints hold, so the two packages read each
other's checkpoints.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.backend import resolve_device
from .config import ModelConfig
from .transformer import port_check

__all__ = ["params_from_jax", "params_to_jax", "opt_from_jax",
           "opt_to_jax"]


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


def _layer(run: dict, i: int, axis: int, dev: torch.device) -> dict:
    return {k: _layer(v, i, axis, dev) if isinstance(v, dict)
            else _tensor(np.take(v, i, axis), dev) for k, v in run.items()}


def _stack(layers: list, axis: int) -> dict:
    return {k: _stack([l[k] for l in layers], axis)
            if isinstance(layers[0][k], dict)
            else np.stack([_numpy(l[k]) for l in layers], axis)
            for k in layers[0]}


def _from_jax(tree: dict, cfg: ModelConfig, dev: torch.device,
              axis: int = 0) -> dict:
    """A params-shaped JAX tree -> the port's layout.  ``axis`` is the run
    dim of the stacked leaves (1 for the EF residual, whose leaves lead
    with the slow-axis dim)."""
    runs = cfg.runs()
    if len(tree["runs"]) != len(runs):
        raise ValueError(f"tree has {len(tree['runs'])} runs, config "
                         f"{cfg.name} has {len(runs)}")
    out = {"embed": _tensor(tree["embed"], dev),
           "final_norm": _tensor(tree["final_norm"], dev), "layers": []}
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], dev)
    for run, (kind, n) in zip(tree["runs"], runs):
        if run["norm1"].shape[axis] != n:
            raise ValueError(f"run of {kind} stacks "
                             f"{run['norm1'].shape[axis]} layers, config "
                             f"says {n}")
        out["layers"] += [_layer(run, i, axis, dev) for i in range(n)]
    return out


def _to_jax(params: dict, cfg: ModelConfig, axis: int = 0) -> dict:
    out = {"embed": _numpy(params["embed"]),
           "final_norm": _numpy(params["final_norm"]), "runs": []}
    if "lm_head" in params:
        out["lm_head"] = _numpy(params["lm_head"])
    i = 0
    for _, n in cfg.runs():
        out["runs"].append(_stack(params["layers"][i:i + n], axis))
        i += n
    return out


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device: str | torch.device = "cuda") -> dict:
    """JAX parameter tree of numpy arrays -> the port's parameters."""
    port_check(cfg)
    return _from_jax(tree, cfg, resolve_device(device))


def params_to_jax(params: dict, cfg: ModelConfig) -> dict:
    """The port's parameters -> the JAX parameter tree of numpy arrays
    (bf16 as uint16 bits), the inverse of :func:`params_from_jax`."""
    port_check(cfg)
    return _to_jax(params, cfg)


def opt_from_jax(tree: dict, cfg: ModelConfig, *,
                 device: str | torch.device = "cuda") -> dict:
    """The reference's optimiser state (``m``, ``v``, ``master``, ``step``
    and, in the compressed mode, ``ef``) as numpy -> the port's."""
    port_check(cfg)
    dev = resolve_device(device)
    out = {k: _from_jax(tree[k], cfg, dev) for k in ("m", "v", "master")}
    out["step"] = _tensor(np.asarray(tree["step"], np.int32), dev)
    if "ef" in tree:
        out["ef"] = _from_jax(tree["ef"], cfg, dev, axis=1)
    return out


def opt_to_jax(opt: dict, cfg: ModelConfig) -> dict:
    """The inverse of :func:`opt_from_jax`."""
    port_check(cfg)
    out = {k: _to_jax(opt[k], cfg) for k in ("m", "v", "master")}
    out["step"] = _numpy(opt["step"])
    if "ef" in opt:
        out["ef"] = _to_jax(opt["ef"], cfg, axis=1)
    return out
