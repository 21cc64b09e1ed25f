"""Input shapes: the part of ``repro/configs/shapes.py`` the data pipeline
uses (``input_specs`` and ``cache_specs`` build JAX shape structs for the
dry-run, and the assigned-shape registry serves it).
"""
from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "VISION_PATCHES", "AUDIO_SRC_FRACTION"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


# Modality stubs: how many leading positions come from the frontend.
VISION_PATCHES = 1024
AUDIO_SRC_FRACTION = 0.5  # enc-dec: half the budget is encoder frames

