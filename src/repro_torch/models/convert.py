"""Carry the JAX package's parameters over into the port.

``repro.models.transformer.init_model`` returns a tree whose layers are
stacked per run of identical block kinds (leading dim = layers in the
run).  The port keeps one dict per layer.  The tree crosses the framework
boundary as numpy arrays, with bf16 leaves as their uint16 bit patterns
(numpy has no bf16), so the weights arrive bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.backend import resolve_device
from .config import ModelConfig
from .transformer import port_check

__all__ = ["params_from_jax"]


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.array(a)                  # a writable copy torch can own
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    if a.dtype == np.float32:
        return torch.from_numpy(a).to(dev)
    raise ValueError(f"expected float32 or uint16 (bf16 bits), got {a.dtype}")


def _layer(run: dict, i: int, dev: torch.device) -> dict:
    return {k: _layer(v, i, dev) if isinstance(v, dict) else _tensor(v[i], dev)
            for k, v in run.items()}


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device: str | torch.device = "cuda") -> dict:
    """JAX parameter tree of numpy arrays -> the port's parameters."""
    port_check(cfg)
    dev = resolve_device(device)
    runs = cfg.runs()
    if len(tree["runs"]) != len(runs):
        raise ValueError(f"tree has {len(tree['runs'])} runs, config "
                         f"{cfg.name} has {len(runs)}")
    out = {"embed": _tensor(tree["embed"], dev),
           "final_norm": _tensor(tree["final_norm"], dev), "layers": []}
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], dev)
    for run, (kind, n) in zip(tree["runs"], runs):
        if run["norm1"].shape[0] != n:
            raise ValueError(f"run of {kind} stacks {run['norm1'].shape[0]} "
                             f"layers, config says {n}")
        out["layers"] += [_layer(run, i, dev) for i in range(n)]
    return out
