"""Straggler detection for the training loop, and the repair quorum.

Copies of ``StragglerMonitor`` and ``has_quorum`` from
``repro/runtime/fault_tolerance.py``: the parts the training loop and
``Communicator.has_quorum`` use.  Failure injection and elastic recovery
planning (``FailureInjector``, ``plan_recovery``) come with elastic
recovery over the rank grid (``ROADMAP.md``, Queue 1 item 4).
"""
from __future__ import annotations

import numpy as np

__all__ = ["StragglerMonitor", "has_quorum"]


class StragglerMonitor:
    """Bounded-staleness straggler policy.

    Tracks per-step wall times; a worker whose step exceeds
    ``threshold x running-median`` is declared a straggler.  The driver's
    response (at scale): drop that worker's microbatch from the current
    all-reduce (the multilevel tree makes this cheap — its subtree simply
    contributes zero and the mean renormalises) and rebalance its shard at
    the next accumulation boundary.  Here we record + expose decisions so
    drivers/tests can act on them.
    """

    def __init__(self, threshold: float = 3.0, window: int = 32):
        self.threshold = threshold
        self.window = window
        self._times: list[float] = []
        self.dropped_steps: list[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; True -> this step was straggler-slow."""
        med = float(np.median(self._times)) if self._times else seconds
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        is_straggler = len(self._times) >= 8 and seconds > self.threshold * med
        if is_straggler:
            self.dropped_steps.append(step)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


def has_quorum(total: int, n_failed: int, quorum: float = 0.5) -> bool:
    """True when strictly more than ``quorum`` of ``total`` members survive
    ``n_failed`` losses — the threshold between in-place communicator
    repair (carry live state, no replay) and checkpoint-restart."""
    return (total - n_failed) > quorum * total
