"""The train step of the port on one device.

Counterpart of ``repro/launch/step.py:83 make_train_fn`` on a 1x1x1 mesh:
``value_and_grad(loss_fn)`` then ``apply_updates``.  With one rank every
collective of the reference's shard_map is over a size-1 axis, so the step
is the loss, its gradients (autograd, through the flash kernels' backward
on the card) and the clipped AdamW update.  The serve steps run through
``serving.TorchExecutor``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.backend import resolve_device
from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim import adamw
from ..tree import tree_leaves, tree_unflatten

__all__ = ["device_batch", "loss_and_grads", "make_train_step"]


def device_batch(batch: dict, device) -> dict:
    """A host batch (numpy int32 tokens and labels) as int64 tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device, torch.long)
            for k, v in batch.items()}


def loss_and_grads(params, cfg: ModelConfig, batch: dict):
    """(loss, grads): the mean cross-entropy and its gradient with respect
    to every parameter leaf, in the parameters' structure and dtypes."""
    leaves = [l.detach().requires_grad_(True) for l in tree_leaves(params)]
    loss = T.loss_fn(tree_unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                    device: str | torch.device = "cuda"):
    """``step(params, opt, batch) -> (params, opt, loss)`` on ``device``;
    ``batch`` is a host batch of ``DataPipeline.host_batch``."""
    T.port_check(cfg)
    dev = resolve_device(device)

    def step(params, opt, batch):
        loss, grads = loss_and_grads(params, cfg, device_batch(batch, dev))
        params, opt = adamw.apply_updates(params, grads, opt, opt_cfg)
        return params, opt, loss

    return step
