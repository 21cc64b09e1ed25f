"""Fault tolerance: failure detection, elastic re-meshing, straggler
mitigation.

Copy of ``repro/runtime/fault_tolerance.py``, code and numerics unchanged.
The training loop (``launch/train.py``) takes ``FailureInjector``'s
schedule, ``plan_recovery``'s shrunk grid and accumulation factor, and
``pod_member_ranks`` for the ranks ``Communicator.repair`` splices out;
``has_quorum`` is the rule behind ``Communicator.has_quorum``.

At 1000+ nodes the design assumptions are:
  * failures are the steady state — MTBF of a 512-chip job is hours;
  * the control plane must react without a global barrier: detection via
    heartbeat timeout, recovery via checkpoint-restart onto a SHRUNK mesh
    (drop the failed pod / data slice), re-expansion when capacity returns;
  * stragglers are handled with bounded staleness, not synchronous waits.

Failures are injected by tests and drivers through ``FailureInjector``;
the recovery logic itself (grid shrink maps, restore, pipeline
fast-forward) is the code path that would run on a fleet — only the
detector's input (heartbeats vs injected events) differs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

__all__ = ["HeartbeatTracker", "FailureInjector", "ElasticPlan",
           "plan_recovery", "StragglerMonitor", "has_quorum",
           "pod_member_ranks"]


# ---------------------------------------------------------------------- #
# Detection
# ---------------------------------------------------------------------- #

class HeartbeatTracker:
    """Coordinator-side liveness table.  Hosts ping; silence past
    ``timeout_s`` marks every device on that host failed."""

    def __init__(self, hosts: list[str], timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.timeout_s = timeout_s
        now = clock()
        self._last: dict[str, float] = {h: now for h in hosts}

    def ping(self, host: str) -> None:
        self._last[host] = self._clock()

    def dead_hosts(self) -> list[str]:
        now = self._clock()
        return [h for h, t in self._last.items()
                if now - t > self.timeout_s]


class FailureInjector:
    """Deterministic failure schedule for tests: (step -> failed pod ids).

    Events are CONSUMED on read — a pod fails once; after the driver
    recovers and replays from the last checkpoint, re-reaching the same
    step number must not re-fire the event (that would loop forever)."""

    def __init__(self, schedule: dict[int, list[int]]):
        self.schedule = dict(schedule)

    def failed_pods_at(self, step: int) -> list[int]:
        return self.schedule.pop(step, [])


def has_quorum(total: int, n_failed: int, quorum: float = 0.5) -> bool:
    """True when strictly more than ``quorum`` of ``total`` members survive
    ``n_failed`` losses — the threshold between in-place communicator
    repair (carry live state, no replay) and checkpoint-restart."""
    return (total - n_failed) > quorum * total


def pod_member_ranks(mesh_shape: tuple[int, ...],
                     axis_names: tuple[str, ...],
                     pods: list[int]) -> list[int]:
    """Data-parallel member ranks living on the given pods, in the flat
    row-major (pod, data) rank space shared by ``launch.mesh.dp_topology``
    and the torch backend — what :meth:`Communicator.repair` takes."""
    shape = dict(zip(axis_names, mesh_shape))
    data = shape.get("data", 1)
    n_pods = shape.get("pod", 1)
    return [p * data + i for p in sorted(set(pods)) if p < n_pods
            for i in range(data)]


# ---------------------------------------------------------------------- #
# Elastic recovery planning
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """What the launcher does after failures: the new mesh shape and how the
    global batch re-maps onto it."""
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    lost_pods: tuple[int, ...]
    # grad-accumulation factor so the GLOBAL batch stays constant after the
    # dp degree shrank (bit-for-bit identical training trajectory)
    accum_factor: int

    @property
    def changed(self) -> bool:
        return self.old_shape != self.new_shape


def plan_recovery(mesh_shape: tuple[int, ...], axis_names: tuple[str, ...],
                  failed_pods: list[int]) -> ElasticPlan:
    """Shrink the 'pod' axis by the failed pods; keep intra-pod axes whole
    (a pod either works or is drained — ICI failures take out the slice).
    The dp degree drops, so grad accumulation rises to hold the global batch
    constant."""
    shape = dict(zip(axis_names, mesh_shape))
    n_pods = shape.get("pod", 1)
    lost = sorted(set(p for p in failed_pods if p < n_pods))
    new_pods = max(n_pods - len(lost), 1)
    new_shape = tuple(new_pods if a == "pod" else shape[a] for a in axis_names)
    accum = max(1, n_pods // new_pods)
    return ElasticPlan(mesh_shape, new_shape, axis_names, tuple(lost), accum)


# ---------------------------------------------------------------------- #
# Straggler mitigation
# ---------------------------------------------------------------------- #

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


def plan_expansion(mesh_shape: tuple[int, ...], axis_names: tuple[str, ...],
                   available_pods: int) -> ElasticPlan:
    """Re-expand the pod axis when drained capacity returns: the inverse of
    ``plan_recovery``.  Grad accumulation drops so the global batch stays
    constant; the checkpoint restores onto the wider mesh unchanged (params
    are pod-replicated; ZeRO shards live on the intra-pod data axis)."""
    shape = dict(zip(axis_names, mesh_shape))
    cur = shape.get("pod", 1)
    new_pods = max(available_pods, cur)
    new_shape = tuple(new_pods if a == "pod" else shape[a] for a in axis_names)
    # dp degree grows back -> accumulation returns to 1 (global batch const)
    return ElasticPlan(mesh_shape, new_shape, axis_names, (), 1)
