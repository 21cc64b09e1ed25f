"""Gradient bucketing.

Copy of ``partition_buckets`` from ``repro/core/engine.py:498``, the part
of the async collective engine that the bucketed gradient sync uses; the
engine itself comes with the planning plane (``ROADMAP.md``, Queue 1).
"""
from __future__ import annotations

from typing import Sequence

__all__ = ["partition_buckets"]


def partition_buckets(sizes: Sequence[float], bucket_bytes: float,
                      reverse: bool = True) -> list[list[int]]:
    """Greedy partition of per-item byte sizes into buckets of at least
    ``bucket_bytes`` (the last bucket may be smaller).  ``reverse`` walks
    items back-to-front — gradient availability order under backward.
    Returns index lists in emission order."""
    if bucket_bytes <= 0:
        raise ValueError("bucket_bytes must be positive")
    order = range(len(sizes) - 1, -1, -1) if reverse else range(len(sizes))
    buckets: list[list[int]] = []
    cur: list[int] = []
    acc = 0.0
    for i in order:
        cur.append(i)
        acc += sizes[i]
        if acc >= bucket_bytes:
            buckets.append(cur)
            cur, acc = [], 0.0
    if cur:
        buckets.append(cur)
    return buckets
