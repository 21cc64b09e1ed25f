"""Topology-aware collective operations (the paper's system plane), over
``torch.distributed``.

Public API — one front door:

  :class:`Communicator`   build once per (topology, policy, backend), then
                          call ``bcast/reduce/barrier/gather/scatter/
                          allreduce/allgather``; plans are cached.

Supporting vocabulary re-exported for construction and inspection:
topologies (:class:`Topology` + canned grids), tree builders and policies,
the op dispatch table, and simulation results.  The multilevel all-reduce
of a rank grid and its int8 slow hop live in :mod:`.collectives` and
:mod:`.compression`.

The async :class:`Engine` issues, orders and prices many collectives at
once on the simulation plane.  Discovery fits a topology from simulated
probes, from the ranks' environment (torchrun's variables and the card
each rank is bound to) or from timed point-to-point round trips between
the ranks.

Counterpart of ``repro/core/__init__.py``, less ``tpu_v5e_multipod``
(ROADMAP.md, Queue 3 D).
"""
from .communicator import (BACKENDS, CacheInfo, CommStats, Communicator,
                           OPS, OpSpec, Plan, PlanCache, PlanChoice,
                           RefreshReport, RepairReport, SimResult,
                           register_op, select_plan, select_tree,
                           size_bucket)
from .engine import (Engine, EngineStats, Handle, overlapped_step_times,
                     partition_buckets)
from .discovery import (ProbeSet, TargetedProbes, cluster_probes,
                        device_probes, discover, environment_topology,
                        fit_levels, fit_topology, measure_drift,
                        refit_levels, representative_pairs,
                        simulated_probes, targeted_probes)
from .rounds import Lowered, SegSend
from .topology import (Level, Topology, flat_view, magpie_machine_view,
                       magpie_site_view, paper_fig8_topology)
from .trees import (LevelPolicy, PAPER_POLICY, Tree, adaptive_policy,
                    binomial_tree, build_multilevel_tree, chain_tree,
                    flat_tree, postal_tree, repair_tree)

__all__ = [
    # the front door
    "Communicator", "Plan", "PlanCache", "PlanChoice", "SimResult",
    "CacheInfo", "CommStats", "RepairReport", "RefreshReport",
    # the async engine (nonblocking handles + concurrent scheduling)
    "Engine", "EngineStats", "Handle", "partition_buckets",
    "overlapped_step_times",
    # topology discovery (probe -> cluster -> fit)
    "ProbeSet", "simulated_probes", "environment_topology", "device_probes",
    "cluster_probes", "fit_levels", "fit_topology", "discover",
    # elastic refresh (targeted re-probe -> drift -> refit)
    "TargetedProbes", "representative_pairs", "targeted_probes",
    "measure_drift", "refit_levels",
    # the rounds IR (select -> lower -> execute)
    "Lowered", "SegSend",
    # op dispatch
    "OPS", "OpSpec", "register_op", "select_plan", "select_tree",
    "size_bucket", "BACKENDS",
    # topology
    "Topology", "Level", "paper_fig8_topology",
    "magpie_machine_view", "magpie_site_view", "flat_view",
    # trees & policies
    "Tree", "LevelPolicy", "PAPER_POLICY", "adaptive_policy",
    "binomial_tree", "build_multilevel_tree", "chain_tree", "flat_tree",
    "postal_tree", "repair_tree",
]
