"""Training entry point of the port: one rank or a (pod x data) grid of
ranks with the paper's multilevel gradient sync, checkpoints of the grid,
and elastic recovery from failed pods.

On the H100:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-100m \\
      --steps 5 --seq 1024 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.train --mesh 2x2x1 \\
      --comm multilevel_compress --dist-backend gloo --steps 3 --seq 1024
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --mesh 2x2x1 --dist-backend gloo
  PYTHONPATH=src python -m repro_torch.launch.train --mesh 1x2x2 \\
      --comm multilevel --dist-backend gloo --steps 4 --seq 1024
On the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --mesh 2x2x1 --comm multilevel_compress --batch 4 --ckpt-dir /tmp/c
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --mesh 2x2x1 --comm multilevel --bucket-mb 1 --trace /tmp/t.json \\
      --steps 2 --seq 32 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --mesh 1x2x2 --steps 3 --seq 32 --batch 4
Elastic recovery (no CLI flag, as the reference's driver):
  train("gpt-100m", 6, mesh_spec="4x1x1", seq=32, batch=4,
        comm="multilevel_compress", fail_at={2: [1]}, smoke=True,
        device="cpu")
  train("gpt-100m", 6, mesh_spec="3x1x2", seq=32, batch=6,
        comm="multilevel_compress", ckpt_dir="/tmp/c", ckpt_every=2,
        fail_at={2: [1], 4: [1]}, smoke=True, device="cpu")

Counterpart of ``repro/launch/train.py:79 train``.  ``--mesh PxDxM`` runs
P*D*M ranks, rank = (pod * D + d) * M + m (``mesh.grid_groups``): under
``torchrun`` each process is one rank (env rendezvous); otherwise
``train`` spawns the ranks itself (``mesh.run_ranks``) and returns the
first surviving rank's result.  On a model axis (M > 1) each rank holds
its model shard of the parameters and state (``launch.step``), the
planning plane prices 1/M of the gradient, as the reference's
``train.py:124-126``, and checkpoints keep the reference's global layout:
gathered over the data axes, then over the model axis; a restore cuts the
model shard, then the data shard, so a checkpoint crosses between grids
of any shape.  Each step takes
``DataPipeline.host_batch`` (the reference's tokens, bit for bit), this
rank's rows of it, the loss and its gradients, and ``apply_updates`` with
the sync over the grid's groups.  The backend is NCCL where every rank has
a card of its own and gloo where ranks share one (NCCL refuses two ranks
on one device) or run on the CPU; gloo's collectives take host tensors, so
the sync then stages the card's tensors through host memory, and rank 0
says so.

Checkpoints hold the reference's global layout: every rank gathers the
ZeRO-1 shards and EF rows (``adamw.gather_opt_state``), the grid's first
rank writes them, and a restore reads the global state on every rank and
cuts this rank's shard; a run resumes from the newest checkpoint in
``ckpt_dir``.  ``fail_at={step: [pod, ...]}`` injects pod failures
(``runtime.fault_tolerance``), with the reference's decisions: while the
survivors keep a quorum, an in-place repair of the planning communicator
and the live state carried onto the shrunk grid; below it, a restart from
the newest checkpoint; on a shrunk grid the reference's accumulation
factor.  The plan is the reference's, on the (pod, data, model) shape:
the pod axis shrinks, ``data`` and ``model`` stay whole, and quorum,
repair and accumulation read only the data-parallel ranks.  The failed
pods' ranks, whole model groups, leave at that step; the survivors go on
over a grid of their own groups, model axis included
(``mesh.make_grid(members=)``), each carrying its model shard through a
repair, or restoring its model and data shard from the checkpoint.

Every rank runs the reference's planning plane, so that each makes the
same decisions: a sim ``Communicator`` over the grid's data-parallel
topology (the generic link classes of ``core.discovery``) prices the
gradient sync for the setup log (``est_ms``, ``slow_crossings``), decides
quorum and is repaired in place; with ``--bucket-mb`` the async engine
prices the bucketed, overlapped sync (``bucketed_estimate``); ``--trace``
writes rank 0's Chrome trace of that plane.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config
from ..configs.shapes import ShapeSpec
from ..core import Communicator
from ..core.discovery import GENERIC_LEVELS
from ..core.engine import overlapped_step_times
from ..data.pipeline import DataPipeline
from ..kernels import flash_attention as fa
from ..kernels import quant as kq
from ..kernels import wkv as kw
from ..kernels.backend import resolve_device
from ..launch.mesh import (Grid, choose_backend, dp_topology, make_grid,
                           parse_mesh, run_ranks)
from ..launch.step import layer_grad_bytes, make_train_step
from ..models import layers as L
from ..models import transformer as T
from ..models.convert import (from_numpy, gather_shards, model_dims,
                              shard_params, stack_runs, to_numpy,
                              unshard_params)
from ..obs import Tracer, get_logger, set_json
from ..optim.adamw import (OptConfig, gather_opt_state, init_opt_state,
                           scatter_axes, shard_opt_state)
from ..runtime.fault_tolerance import (FailureInjector, StragglerMonitor,
                                       plan_recovery, pod_member_ranks)
from ..tree import tree_leaves, tree_map

log = get_logger("train")

SPAWN_TIMEOUT_S = 3600.0
AXES = ("pod", "data", "model")
LEVELS = [GENERIC_LEVELS[0], GENERIC_LEVELS[-1]]   # across pods, inside
KERNELS = {"flash_fwd": fa.flash_attention_fwd,
           "flash_bwd_dq": fa.flash_bwd_dq,
           "flash_bwd_dkv": fa.flash_bwd_dkv,
           "quantize_int8": kq.quantize_int8,
           "dequantize_int8": kq.dequantize_int8,
           "quantize_ef_int8": kq.quantize_ef_int8,
           "wkv": kw.wkv_chunked}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    return {name: f.launches for name, f in KERNELS.items()}


def _fit_ef(opt_tree: dict, lost_pods, new_pods: int) -> dict:
    """Fit the EF residual's leading pod dim after an elastic mesh change:
    surviving pods keep their own rows (their residuals are still the
    rounding error of the shard they exchange); any other mismatch resets
    to zeros (EF re-warms in one step).  Copy of the reference's, on a
    global numpy tree."""
    if "ef" not in opt_tree:
        return opt_tree
    lost = set(lost_pods)

    def fit(e):
        if e.shape[0] == new_pods:
            return e
        keep = [p for p in range(e.shape[0]) if p not in lost]
        if len(keep) == new_pods:
            return np.asarray(e)[keep]
        return np.zeros((new_pods,) + e.shape[1:], e.dtype)

    return dict(opt_tree, ef=tree_map(fit, opt_tree["ef"]))


def _fit_ef_rows(opt: dict, old_pods: int, lost_pods, new_pods: int) -> dict:
    """``_fit_ef`` on this surviving rank's shard: it keeps its own EF row
    where the reference keeps the surviving pods' rows in order, and
    zeros where the reference resets them."""
    if "ef" not in opt or old_pods == new_pods:
        return opt
    if len([p for p in range(old_pods) if p not in set(lost_pods)]) \
            == new_pods:
        return opt
    return dict(opt, ef=tree_map(torch.zeros_like, opt["ef"]))


def _fit_batch(arr: np.ndarray, dp: int) -> np.ndarray:
    """Fit a host batch to a (possibly shrunk) dp degree: drop the tail
    rows that no longer tile (the lost pod's share — the straggler-drop
    semantics, the mean renormalises), or wrap-pad tiny batches up."""
    b = arr.shape[0]
    n = (b // dp) * dp
    if n == b:
        return arr
    if n == 0:
        reps = -(-dp // b)
        return np.concatenate([arr] * reps, axis=0)[:dp]
    return arr[:n]


def train(arch: str = "gpt-100m", steps: int = 100, mesh_spec: str = "1x1x1",
          seq: int = 128, batch: int = 8, comm: str = "multilevel",
          zero1: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 25,
          fail_at: dict[int, list[int]] | None = None, *,
          smoke: bool = False, device: str | torch.device = "cuda",
          log_every: int = 10, profile: str | None = None,
          dist_backend: str | None = None, log_json: bool = False,
          bucket_mb: float = 0.0, trace: str | None = None,
          digests: bool = False, ef_trees: bool = False, config=None,
          init_params=None) -> dict:
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens
    (the global batch, split over the data-parallel ranks) from random
    weights (seed 0),
    with lr 1e-3 and 20 warmup steps as the reference's driver.

    Returns the first surviving rank's losses (the mean over the ranks;
    a step of ``accum`` micro-steps gives their mean), each step's wall ms
    (the host clock around a step that ends when its loss reaches the
    host), tokens per second over the steps after the first, and for the
    grid: ``world``, ``mode``, the backend and staging, the bytes this rank
    put on the slow axis per step beside what f32 would have sent, the
    host bytes staged per step, and each surviving rank's kernel launches
    in this run.  Elastic recovery adds ``recoveries`` (restarts),
    ``repairs`` (in-place repairs), ``events`` (the ``failure`` and
    ``repair`` log records), ``recovery_s``, ``saves`` (each checkpoint's
    step, pods, bytes and the seconds of its gather and host copy) and
    ``ckpt_writes`` (the writer's bytes and seconds on disk).  A run
    restarts from the newest checkpoint in ``ckpt_dir``; ``fail_at`` maps
    a step to the pods that fail before it, on any grid: a failed pod's
    model groups leave whole, and ``pods`` and ``world`` are the final
    grid's.  On a model axis: ``model``, ``model_rank`` (this rank's index
    on it; ``rank`` is the data-parallel one), ``tp_calls``, the
    model-axis collectives of each step on this rank
    (``launch.step.loss_and_grads``' ``fwd``, ``remat``, ``bwd``), and
    ``tp_calls_ranks``, every surviving rank's.  For a MoE config,
    ``moe``: each step's host reads of the routing (``syncs``) and, on a
    model axis, the slots each layer's expert-parallel blocks dropped in
    the forward (``dropped``).  On the card, ``peak_mem_bytes``: the
    process's peak allocation.  With more than one rank, ``launches``,
    ``moe`` and ``peak_mem_bytes`` hold every surviving rank's, in rank
    order.

    ``bucket_mb`` > 0 switches the gradient sync to size-targeted buckets
    (reverse-layer order, one fused collective per bucket); it forces
    ``zero1=False`` as the reference does, since ZeRO-1 scatters per leaf.
    ``trace`` writes a Chrome trace of rank 0's planning plane (simulated
    link occupancy, planner decisions, the engine's spans) to that path.
    ``profile`` traces rank 0's steps after the first with
    ``torch.profiler`` and writes its op table to that path
    (``_write_profile``).  For checks: ``digests`` adds the SHA-256 of
    each saved global state (``saves``) and of each restored one
    (``restored``); ``ef_trees`` adds, at each live carry of the state
    onto a shrunk grid, the global EF rows (numpy) gathered on the old grid
    just before the failure and on the new one just after the carry
    (``carried``: step, lost pods, ``before``, ``after``); ``config``
    trains that ``ModelConfig`` instead of
    ``arch``'s; ``init_params`` (numpy, the stacked layout) replaces the
    seed-0 weights."""
    pods, data, model = parse_mesh(mesh_spec)
    cfg = config or get_config(arch, smoke=smoke)
    T.port_check(cfg)
    world = pods * data * model
    dev = resolve_device(device)
    kw = dict(arch=arch, steps=steps, pods=pods, data=data, model=model,
              seq=seq, batch=batch, comm=comm, zero1=zero1, ckpt_dir=ckpt_dir,
              ckpt_every=ckpt_every, fail_at=fail_at, smoke=smoke,
              device=str(dev), log_every=log_every, profile=profile,
              log_json=log_json, bucket_mb=bucket_mb, trace=trace,
              digests=digests, ef_trees=ef_trees, config=config,
              init_params=init_params)
    if world == 1:
        return _train_rank(**kw)
    if "WORLD_SIZE" in os.environ:          # torchrun: this process is a rank
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} "
                             f"ranks for mesh {mesh_spec}")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        dist.init_process_group(choose_backend(dist_backend, dev, local))
        try:
            return _train_rank(local_rank=int(os.environ.get("LOCAL_RANK",
                                                             0)), **kw)
        finally:
            dist.destroy_process_group()
    res = run_ranks(_spawned_rank, world,
                    choose_backend(dist_backend, dev, world), (kw,),
                    timeout=SPAWN_TIMEOUT_S)
    return next(r for r in res if not r["left"])


def _spawned_rank(rank: int, kw: dict) -> dict:
    return _train_rank(local_rank=rank, **kw)


def _digest(tree) -> str:
    """SHA-256 of a tree's leaves (tensors or numpy, bf16 as its bits), as
    bytes in leaf order."""
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = to_numpy(leaf)
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def _lead(grid: Grid) -> bool:
    """The grid's first rank: data-parallel rank 0, model index 0."""
    return grid.rank == 0 and (grid.tp is None or grid.tp.index == 0)


def _save(ckpt, step: int, params, opt, opt_cfg, grid: Grid, cfg,
          mdims, digests: bool) -> dict:
    """Checkpoint ``step``: every rank gathers the global state (over the
    data axes, then over the model axis), the grid's first rank writes it
    (the write runs on after the call)."""
    t0 = time.monotonic()
    state = {"params": gather_shards(params, cfg, grid.tp),
             "opt": gather_shards(gather_opt_state(opt, params, opt_cfg,
                                                   grid, mdims),
                                  cfg, grid.tp)}
    if _lead(grid):
        ckpt.save(step, state)
    rec = {"step": step, "pods": grid.pods,
           "bytes": sum(l.nbytes for l in tree_leaves(state)),
           "s": time.monotonic() - t0}
    if digests:
        rec["digest"] = _digest(state)
    return rec


def _global_ef(opt, params, opt_cfg, grid: Grid, cfg, mdims) -> dict:
    """The global EF rows (numpy; empty without EF), gathered as a save
    gathers them."""
    if "ef" not in opt:
        return {}
    return to_numpy(gather_shards(gather_opt_state(
        opt, params, opt_cfg, grid, mdims), cfg, grid.tp)["ef"])


def _restore(ckpt, step: int, params, opt_cfg, grid: Grid, saved_pods: int,
             lost_pods, dev: torch.device, cfg=None, mdims=None) -> tuple:
    """Checkpoint ``step`` read on this rank: the global state, whose EF
    rows are the ``saved_pods`` of its save, the rows fitted to the grid
    (``_fit_ef``), then this rank's model shard (on a model axis, with
    ``cfg`` and ``mdims``) and its data-parallel shard.  Returns (params,
    opt, the global state read)."""
    tp = grid.tp
    meta = tree_map(lambda t: t.to("meta"), params)
    if tp is not None:
        meta = unshard_params([meta] * tp.size, cfg)
    state = ckpt.restore(step, {"params": meta, "opt": init_opt_state(
        meta, opt_cfg, n_slow=saved_pods)})
    cut = (lambda t: t) if tp is None \
        else (lambda t: shard_params(t, cfg, tp.size, tp.index))
    params = tree_map(lambda t: t.to(dev), cut(from_numpy(
        state["params"], device="cpu")))
    opt = shard_opt_state(cut(from_numpy(_fit_ef(state["opt"], lost_pods,
                                                 grid.pods), device="cpu")),
                          params, opt_cfg, grid, mdims)
    return params, tree_map(lambda t: t.to(dev), opt), state


def _train_rank(arch, steps, pods, data, model, seq, batch, comm, zero1,
                ckpt_dir, ckpt_every, fail_at, smoke, device, log_every,
                profile,
                log_json, bucket_mb, trace, digests, ef_trees, config,
                init_params, local_rank: int = 0) -> dict:
    """The training loop of one rank (of a grid whose process group is
    initialised, or alone)."""
    set_json(log_json)
    dev = resolve_device(device)
    if dev.type == "cuda" and pods * data * model > 1:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    grid = make_grid(pods, data, dev, model=model)
    tp = grid.tp
    me = dist.get_rank() if dist.is_initialized() else 0
    members = list(range(grid.size))      # the grid's global ranks
    orig_dp = grid.world
    events: list[dict] = []

    def info(*a, **k):
        if _lead(grid):
            log.info(*a, **k)

    def note(msg: str, **fields) -> None:
        """An elastic event: kept by every rank, logged by the lead."""
        events.append(fields)
        info(msg, **fields)

    cfg = config or get_config(arch, smoke=smoke)
    T.port_check(cfg)
    mdims = model_dims(cfg, model) if tp is not None else None
    bucket_bytes = bucket_mb * 2 ** 20 if bucket_mb > 0 else None
    if bucket_bytes and zero1 and comm != "flat":
        info("bucketed sync: forcing zero1=False (ZeRO-1 "
             "scatters per leaf)", event="config")
        zero1 = False
    opt_cfg = OptConfig(comm_mode=comm, zero1=zero1, lr=1e-3,
                        warmup_steps=20, total_steps=steps,
                        bucket_bytes=bucket_bytes)
    pipe = DataPipeline(cfg, ShapeSpec("custom", "train", seq, batch))
    injector = FailureInjector(fail_at or {})
    straggler = StragglerMonitor()
    ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    if init_params is None:
        m = 0 if tp is None else tp.index
        params = stack_runs(T.init_model(cfg, seed=0, device=dev,
                                         model=model, m=m), cfg, model, m)
    elif tp is None:
        params = from_numpy(init_params, device=dev)
    else:
        params = tree_map(lambda t: t.to(dev), shard_params(
            from_numpy(init_params, device="cpu"), cfg, model, tp.index))
    opt = shard_opt_state(init_opt_state(params, opt_cfg, n_slow=pods),
                          params, opt_cfg, grid, mdims)
    tracer = Tracer() if trace and me == 0 else None
    # every rank plans alike, so that each makes the same in-place or
    # restart decision and the same repair; on an in-place recovery the
    # SAME communicator is repaired (its members shrink, its cached plans
    # splice out the dead ranks)
    sim = Communicator(dp_topology(Grid.shape_only(pods, data), LEVELS),
                       policy="paper", backend="sim", tracer=tracer)

    def setup():
        est = _plan_estimates(cfg, sim, grid.world, bucket_bytes, model)
        info(f"{cfg.name} on {dev}: {steps} steps of {batch} x {seq} "
             f"tokens, comm '{comm}' over a {grid.pods}x{grid.data}"
             f"x{model} grid of {grid.size} rank(s)"
             + (f", backend {grid.backend}, collectives staged through "
                f"host memory: {'yes' if grid.staging == 'host' else 'no'}"
                if grid.size > 1 else "")
             + f"; grad sync est {est['est_ms']:.1f} ms/step, "
             f"{est['slow_crossings']} slow-link crossing(s)",
             event="setup", arch=cfg.name, device=str(dev),
             world=grid.world, model=model, mode=comm, backend=grid.backend,
             staging=grid.staging, est_ms=est["est_ms"],
             slow_crossings=est["slow_crossings"])
        if "bucketed" in est:
            b = est["bucketed"]
            info(f"bucketed sync ({bucket_mb:g} MiB x {b['n_buckets']} "
                 f"buckets): overlapped est {b['overlapped_s'] * 1e3:.1f} "
                 f"ms/step vs serial {b['serial_s'] * 1e3:.1f} ms "
                 f"({b['speedup']:.2f}x, balanced-compute model)",
                 event="bucketed_estimate", n_buckets=b["n_buckets"],
                 overlapped_ms=b["overlapped_s"] * 1e3,
                 serial_ms=b["serial_s"] * 1e3, speedup=b["speedup"])
        return make_train_step(cfg, opt_cfg, grid, dev), est

    step_fn, est = setup()
    start = 0
    ckpt_pods = pods          # the EF rows of the checkpoint a restore reads
    restored = []
    latest = ckpt.latest_step() if ckpt else None
    if latest is not None:
        params, opt, state = _restore(ckpt, latest, params, opt_cfg, grid,
                                      ckpt_pods, (), dev, cfg, mdims)
        if digests:
            restored.append({"step": latest, "digest": _digest(state)})
        start = latest + 1
        info(f"resumed from checkpoint step {latest}", event="resume",
             step=latest)

    before = launch_counts()
    losses: list[float] = []
    step_ms: list[float] = []
    tokens: list[int] = []
    wire: list[int] = []
    staged: list[int] = []
    tp_calls: list[dict] = []
    moe = {"syncs": [], "dropped": []} if cfg.moe is not None else None
    saves: list[dict] = []
    carried: list[dict] = []
    recovery_s: list[float] = []
    recoveries = repairs = 0
    accum = 1
    left_at = None
    prof = None
    step_i = start
    while step_i < steps:
        t0 = time.monotonic()
        # ---- failure injection / elastic recovery --------------------- #
        failed = injector.failed_pods_at(step_i)
        if failed:
            plan = plan_recovery((grid.pods, grid.data, model), AXES,
                                 failed)
            # the grid's dp ranks of the lost pods, translated to the
            # ORIGINAL rank ids the planning communicator still speaks
            dead = [sim.members[r] for r in
                    pod_member_ranks(plan.old_shape, plan.axis_names,
                                     list(plan.lost_pods))
                    if r < len(sim.members)]
            in_place = plan.changed and sim.has_quorum(dead)
            note(f"step {step_i}: pods {failed} failed -> grid "
                 f"{plan.old_shape} -> {plan.new_shape}, accum "
                 f"x{plan.accum_factor} "
                 f"({'in-place repair' if in_place else 'restart'})",
                 event="failure", step=step_i, failed=list(failed),
                 accum=plan.accum_factor, in_place=in_place)
            if ef_trees and plan.changed:
                ef_before = _global_ef(opt, params, opt_cfg, grid, cfg, mdims)
            if ckpt:
                # the newest checkpoint is whole before anyone leaves or
                # reads it
                ckpt.wait()
                grid.barrier()
            old_pods = grid.pods
            if plan.changed:
                keep = [p for p in range(old_pods)
                        if p not in plan.lost_pods] or [0]
                # the M ranks of each kept (pod, data) cell
                cells = grid.data * model
                members = [members[p * cells + i] for p in keep
                           for i in range(cells)]
                if me not in members:
                    left_at = step_i
                    break
                grid = make_grid(plan.new_shape[0], grid.data, dev, model,
                                 members=members)
                if in_place:
                    rep = sim.repair(failed=dead)
                    repairs += 1
                    note(f"repair: {rep.repaired} plan(s) spliced in "
                         f"place, {rep.evicted} evicted, {rep.kept} kept; "
                         f"{len(rep.members)} dp rank(s) remain",
                         event="repair", step=step_i,
                         repaired=rep.repaired, evicted=rep.evicted,
                         kept=rep.kept, survivors=len(rep.members))
                else:
                    # full restart: the old membership (and its rank
                    # translation) is void — re-plan on the new grid
                    sim = Communicator(dp_topology(Grid.shape_only(
                        grid.pods, grid.data), LEVELS), policy="paper",
                        backend="sim")
                step_fn, est = setup()
                accum = plan.accum_factor
            # quorum held: carry the LIVE state onto the shrunk grid — no
            # checkpoint rewind, no step replay.  Below quorum: restore
            # from the last durable checkpoint (live-carry only as the
            # no-checkpoint-yet fallback).
            carry_live = in_place
            if not in_place:
                recoveries += 1
                latest = ckpt.latest_step() if ckpt else None
                if latest is not None:
                    params, opt, state = _restore(
                        ckpt, latest, params, opt_cfg, grid, ckpt_pods,
                        plan.lost_pods, dev, cfg, mdims)
                    if digests:
                        restored.append({"step": latest,
                                         "digest": _digest(state)})
                    info(f"restart from checkpoint step {latest} on "
                         f"{grid.size} rank(s)", event="restore",
                         step=latest)
                    recovery_s.append(time.monotonic() - t0)
                    step_i = latest + 1
                    continue
                carry_live = plan.changed
            if carry_live:
                opt = _fit_ef_rows(opt, old_pods, plan.lost_pods, grid.pods)
                if ef_trees:
                    carried.append({"step": step_i,
                                    "lost": list(plan.lost_pods),
                                    "before": ef_before,
                                    "after": _global_ef(opt, params, opt_cfg,
                                                        grid, cfg, mdims)})
            recovery_s.append(time.monotonic() - t0)

        # ---- the step (with grad accumulation on a shrunk grid) ------- #
        if profile and _lead(grid) and step_i == start + 1:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        w0 = grid.slow.wire_bytes if grid.slow else 0
        s0 = grid.staged_bytes
        ts = time.monotonic()
        loss_acc, rows = 0.0, 0
        syncs0, L.moe_fwd.dropped = L.moe_fwd.host_syncs, []
        try:
            for micro in range(accum):
                hb = pipe.host_batch(step_i * accum + micro)
                # batch fitting is elastic-only: a healthy run keeps
                # rank_rows' loud error on a batch that does not split
                if grid.world != orig_dp:
                    hb = {k: _fit_batch(np.asarray(v), grid.world)
                          for k, v in hb.items()}
                params, opt, loss = step_fn(params, opt, hb)
                loss_acc += float(loss)  # waits for the step to finish
                rows += len(hb["tokens"])
            dropped = L.moe_fwd.dropped
        finally:
            L.moe_fwd.dropped = None
        if moe is not None:
            moe["syncs"].append(L.moe_fwd.host_syncs - syncs0)
            moe["dropped"].append(dropped)
        losses.append(loss_acc / accum)
        step_ms.append((time.monotonic() - ts) * 1e3)
        if tp is not None:
            tp_calls.append(dict(step_fn.tp_calls))
        tokens.append(rows * seq)
        wire.append((grid.slow.wire_bytes if grid.slow else 0) - w0)
        staged.append(grid.staged_bytes - s0)
        dt = time.monotonic() - t0
        if straggler.observe(step_i, dt):
            info(f"step {step_i}: straggler ({dt:.2f}s vs median "
                 f"{straggler.median:.2f}s)", event="straggler",
                 step=step_i, dt_s=dt, median_s=straggler.median)
        if ckpt and ckpt_every and step_i % ckpt_every == 0 \
                and step_i > start:
            saves.append(_save(ckpt, step_i, params, opt, opt_cfg, grid,
                               cfg, mdims, digests))
            ckpt_pods = grid.pods
        if step_i % log_every == 0:
            info(f"step {step_i:5d} loss {losses[-1]:.4f} "
                 f"({dt * 1e3:.0f} ms)", event="step", step=step_i,
                 loss=losses[-1], dt_ms=dt * 1e3)
        step_i += 1
    if ckpt:
        ckpt.wait()
    if tracer is not None:
        tracer.save(trace)
        log.info(f"trace: {tracer.n_events()} events -> {trace}",
                 event="trace", path=trace, events=tracer.n_events())
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    if left_at is not None:
        return {"left": True, "left_at": left_at, "losses": losses,
                "events": events, "launches": launches}
    if orig_dp * model > 1:
        # every surviving rank's, in rank order
        mine = (launches, moe, peak, tp_calls)
        every = [mine] * grid.size
        if len(every) > 1:
            dist.all_gather_object(every, mine, group=grid.group)
        launches, moe, peak, tp_ranks = ([e[i] for e in every]
                                         for i in range(4))
    else:
        tp_ranks = [tp_calls]
    steady = step_ms[1:]
    out = {"left": False, "rank": grid.rank, "losses": losses,
           "step_ms": step_ms,
           "tokens_per_s": (sum(tokens[1:]) / sum(steady) * 1e3
                            if steady else None),
           "stragglers": len(straggler.dropped_steps),
           "start_step": start,
           "final_loss": losses[-1] if losses else None,
           "recoveries": recoveries, "repairs": repairs, "events": events,
           "step_tokens": tokens, "recovery_s": recovery_s,
           "accum": accum, "pods": grid.pods,
           "saves": saves, "restored": restored, "carried": carried,
           "ckpt_writes": ckpt.writes if ckpt else [],
           "world": grid.world, "model": model,
           "model_rank": 0 if tp is None else tp.index, "mode": comm,
           "backend": grid.backend,
           "staging": grid.staging, "staged_bytes": staged,
           "slow_wire_bytes": wire,
           "slow_f32_bytes": _slow_f32_bytes(params, grid, mdims),
           "tp_calls": tp_calls, "tp_calls_ranks": tp_ranks, "moe": moe, "peak_mem_bytes": peak,
           "launches": launches, "plan": est}
    if prof is not None:
        prof.stop()
        out["profile"] = _write_profile(prof, dev, profile, sum(steady))
    return out


def _plan_estimates(cfg, sim, world: int, bucket_bytes: float | None,
                    model: int = 1) -> dict:
    """The reference's planning plane (``train.py:115-146``): the
    gradient sync's postal-model estimate on ``sim`` (the grid's
    data-parallel topology) for one model slice's share of the gradient
    (1/``model`` of it), its slow-link crossings and, with
    ``bucket_bytes``, the bucketed, overlapped estimate through the async
    engine at the communication-bound threshold (backward compute ~ sync
    time, spread over layers by gradient size)."""
    lbytes = layer_grad_bytes(cfg, model)
    slice_bytes = sum(lbytes)
    est_s = sim.allreduce(slice_bytes).time
    # rooted at the first member, as ``allreduce`` is: the reference's
    # root 0 raises once pod 0 has been repaired away
    out = {"est_ms": est_s * 1e3,
           "slow_crossings": sim.slow_crossings(
               "allreduce", root=sim.members[0], nbytes=slice_bytes)}
    if bucket_bytes and world > 1:       # one rank syncs nothing
        b = overlapped_step_times(
            sim, lbytes, [est_s * x / slice_bytes for x in lbytes],
            bucket_bytes=bucket_bytes)
        out["bucketed"] = {k: b[k] for k in (
            "n_buckets", "overlapped_s", "serial_s", "speedup",
            "overlap_efficiency")}
    return out


def _slow_f32_bytes(params, grid, mdims=None) -> int:
    """The bytes one rank would put on the slow axis per step with f32:
    its 1/|data| shard of every leaf of its model shard (the whole leaf
    where no dim divides); 0 with one pod."""
    if grid.slow is None:
        return 0
    axes = tree_leaves(scatter_axes(params, grid.data, mdims))
    return sum(4 * l.numel() // (1 if ax is None else grid.data)
               for l, ax in zip(tree_leaves(params), axes))


def _write_profile(prof, dev: torch.device, path: str,
                   wall_ms: float) -> dict:
    """Write the profile's op table to ``path``.  On the card, also sum
    the device kernels' times: the device's busy ms beside the wall ms the
    profile covers, split into the flash kernels, matrix products and the
    rest."""
    ops = prof.key_averages()
    key = "self_device_time_total" if dev.type == "cuda" \
        else "self_cpu_time_total"
    with open(path, "w") as f:
        f.write(ops.table(sort_by=key, row_limit=60))
    out = {"path": path, "wall_ms": wall_ms}
    if dev.type == "cuda":
        kinds = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
        for e in ops:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue                     # host ops; their kernels follow
            name = e.key.lower()
            kind = "flash" if "flash_" in name else \
                "matmul" if any(w in name for w in ("gemm", "nvjet",
                                                    "cutlass")) else "other"
            kinds[kind] += e.self_device_time_total / 1e3
        out.update(device_busy_ms=sum(kinds.values()), kernel_ms=kinds)
    log.info(f"profile: {path}; {out}", event="profile", **out)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="1x1x1",
                    help="pods x data x model (P*D*M ranks)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch rows, split over the ranks")
    ap.add_argument("--comm", default="multilevel",
                    choices=["flat", "multilevel", "multilevel_compress"])
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config instead of its "
                         "full width")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="collective backend of a grid: nccl needs a card "
                         "per rank, gloo takes shared cards and the CPU "
                         "(default: nccl where each rank has a card)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (resumes from its newest "
                         "checkpoint; the grid's first rank writes the "
                         "gathered global state); none by default")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--bucket-mb", type=float, default=0.0,
                    help="size-targeted gradient buckets (MiB); 0 = one "
                         "monolithic sync")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace of the planning plane "
                         "(open in chrome://tracing or Perfetto)")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="trace rank 0's steps after the first with "
                         "torch.profiler and write its op table to PATH")
    ap.add_argument("--log-json", action="store_true",
                    help="emit one JSON object per log line instead of the "
                         "human format")
    args = ap.parse_args()
    set_json(args.log_json)
    out = train(args.arch, args.steps, args.mesh, args.seq, args.batch,
                args.comm, not args.no_zero1, args.ckpt_dir,
                args.ckpt_every, smoke=args.smoke, device=args.device,
                log_every=args.log_every, profile=args.profile,
                dist_backend=args.dist_backend, log_json=args.log_json,
                bucket_mb=args.bucket_mb, trace=args.trace)
    if out["left"] or out["rank"] != 0 or out["model_rank"] != 0:
        return
    tps = out["tokens_per_s"]
    log.info(f"done: final_loss={out['final_loss']:.4f} "
             f"tokens/s={tps if tps is None else round(tps)} "
             f"recoveries={out['recoveries']} repairs={out['repairs']} "
             f"stragglers={out['stragglers']} world={out['world']} "
             f"slow_wire_bytes/step={out['slow_wire_bytes'][-1:]} "
             f"(f32: {out['slow_f32_bytes']})", event="done",
             final_loss=out["final_loss"], tokens_per_s=tps,
             recoveries=out["recoveries"], repairs=out["repairs"],
             stragglers=out["stragglers"], world=out["world"],
             slow_wire_bytes=out["slow_wire_bytes"],
             slow_f32_bytes=out["slow_f32_bytes"])


if __name__ == "__main__":
    main()
