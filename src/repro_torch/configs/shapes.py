"""Assigned input shapes and their ``meta`` stand-ins for the dry run.

A copy of ``repro/configs/shapes.py``: the four assigned cells
(``SHAPES``), which of them an architecture runs (``applicable``), and the
inputs of one step (``input_specs``) and the decode cache
(``cache_specs``) at global shapes, as ``meta`` tensors where the
reference has ShapeDtypeStructs: nothing is allocated.  The cache comes
from the port's own ``init_cache`` on ``meta``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ShapeSpec", "SHAPES", "VISION_PATCHES", "AUDIO_SRC_FRACTION",
           "applicable", "input_specs", "cache_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# Modality stubs: how many leading positions come from the frontend.
VISION_PATCHES = 1024
AUDIO_SRC_FRACTION = 0.5  # enc-dec: half the budget is encoder frames


def applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """Is (arch x shape) a runnable cell?  Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 512k decode is quadratic (skip per brief)"
    return True, ""


def _tok(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape: ShapeSpec) -> dict:
    """Model inputs for one step, as ``meta`` tensors (global shapes)."""
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    pos = lambda: _tok((), torch.int32)

    if cfg.enc_dec:  # audio enc-dec: split budget between encoder and decoder
        s_src = int(S * AUDIO_SRC_FRACTION)
        s_tgt = S - s_src
        if shape.kind == "train":
            return {"src_embeds": _tok((B, s_src, D), torch.bfloat16),
                    "tokens": _tok((B, s_tgt)), "labels": _tok((B, s_tgt))}
        if shape.kind == "prefill":
            return {"src_embeds": _tok((B, s_src, D), torch.bfloat16),
                    "tokens": _tok((B, s_tgt))}
        # decode: one new target token against an S-long cache
        return {"tokens": _tok((B, 1)), "pos": pos()}

    if cfg.frontend == "vision":
        n_img = min(VISION_PATCHES, S // 4)
        if shape.kind == "train":
            return {"embeds": _tok((B, n_img, D), torch.bfloat16),
                    "tokens": _tok((B, S - n_img)),
                    "labels": _tok((B, S - n_img))}
        if shape.kind == "prefill":
            return {"embeds": _tok((B, n_img, D), torch.bfloat16),
                    "tokens": _tok((B, S - n_img))}
        return {"tokens": _tok((B, 1)), "pos": pos()}

    if shape.kind == "train":
        return {"tokens": _tok((B, S)), "labels": _tok((B, S))}
    if shape.kind == "prefill":
        return {"tokens": _tok((B, S))}
    return {"tokens": _tok((B, 1)), "pos": pos()}


def cache_specs(cfg, shape: ShapeSpec, tp=None) -> list:
    """The decode cache on ``meta`` (global shapes; this rank's shard of
    them on a model axis ``tp``)."""
    from ..models import transformer as T

    B, S = shape.global_batch, shape.seq_len
    src_len = int(S * AUDIO_SRC_FRACTION) if cfg.enc_dec else 0
    return T.init_cache(cfg, B, S, src_len, device="meta", tp=tp)
