"""AdamW with f32 master weights, global-norm clipping, cosine schedule.

Counterpart of ``repro/optim/adamw.py``.  ``OptConfig``, ``lr_at``,
``_adamw_math`` and ``init_opt_state`` are copies.  ``apply_updates`` is
the single-rank update: the reference's gradient sync over the (pod, data)
axes is the identity at world size 1 (every psum is over a size-1 axis and
the slow axis is absent), so only the f32 cast, the global-norm clip and
the AdamW math remain.  A larger world raises until the multilevel sync is
ported (``ROADMAP.md``, Queue 1 item 2).  The ZeRO-1, bucketed and
compressed modes are accepted and validated as in the reference; at world
size 1 they compute the same update, and the compressed mode's EF residual
passes through unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["OptConfig", "NOT_PORTED", "init_opt_state", "apply_updates",
           "lr_at"]

NOT_PORTED = ("ROADMAP.md, Queue 1 item 2: the multilevel gradient sync "
              "over torch.distributed")


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


def _adamw_math(m, v, g, master, cfg: OptConfig, lr, t, decay_mask=1.0):
    b1, b2 = cfg.betas
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    upd = (mhat / (torch.sqrt(vhat) + cfg.eps)
           + cfg.weight_decay * decay_mask * master)
    return m, v, master - lr * upd


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


def _sync(grads: Any, world_size: int) -> Any:
    """The gradient sync, as f32: the identity on one rank."""
    if world_size != 1:
        raise NotImplementedError(f"gradient sync over {world_size} ranks "
                                  f"is not ported yet ({NOT_PORTED})")
    return tree_map(lambda g: g.float(), grads)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, opt: dict, cfg: OptConfig, *,
                  world_size: int = 1) -> tuple[Any, dict]:
    """Gradient sync (identity on one rank), global-norm clip and AdamW on
    the f32 master; returns (params cast back to their dtypes, opt)."""
    t = opt["step"] + 1
    lr = lr_at(cfg, opt["step"])
    grads = _sync(grads, world_size)
    gn2 = sum(torch.dot(g.reshape(-1), g.reshape(-1))
              for g in tree_leaves(grads))
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(torch.sqrt(gn2),
                                                        1e-12), max=1.0)
    res = tree_map(lambda m, v, g, w: _adamw_math(m, v, g * scale, w, cfg,
                                                  lr, t),
                   opt["m"], opt["v"], grads, opt["master"])
    # res holds an (m, v, w) tuple per leaf: pick along grads' structure
    new_m, new_v, new_w = (tree_map(lambda _, r: r[i], grads, res)
                           for i in range(3))
    new_params = tree_map(lambda w, p: w.to(p.dtype), new_w, params)
    return new_params, dict(opt, m=new_m, v=new_v, master=new_w, step=t)
