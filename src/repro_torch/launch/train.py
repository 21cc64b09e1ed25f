"""Training entry point of the port: one rank or a (pod x data) grid of
ranks with the paper's multilevel gradient sync; checkpoint and resume on
one rank.

On the H100:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-100m \\
      --steps 5 --seq 1024 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.train --mesh 2x2x1 \\
      --comm multilevel_compress --dist-backend gloo --steps 3 --seq 1024
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --mesh 2x2x1 --dist-backend gloo
On the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --mesh 2x2x1 --comm multilevel_compress --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --mesh 2x2x1 --comm multilevel --bucket-mb 1 --trace /tmp/t.json \\
      --steps 2 --seq 32 --batch 4

Counterpart of ``repro/launch/train.py:79 train``.  ``--mesh PxDx1`` runs
P*D ranks: under ``torchrun`` each process is one rank (env rendezvous);
otherwise ``train`` spawns the ranks itself (``mesh.run_ranks``) and
returns rank 0's result.  Each step takes ``DataPipeline.host_batch`` (the
reference's tokens, bit for bit), this rank's rows of it, the loss and its
gradients, and ``apply_updates`` with the sync over the grid's groups.
The backend is NCCL where every rank has a card of its own and gloo where
ranks share one (NCCL refuses two ranks on one device) or run on the CPU;
gloo's collectives take host tensors, so the sync then stages the card's
tensors through host memory, and rank 0 says so.  Checkpoints hold the
reference's stacked layout and a one-rank run resumes from the newest one
in ``ckpt_dir``; a grid of more than one rank refuses ``ckpt_dir``
(``NotImplementedError``).  Rank 0 also runs the reference's planning
plane: a sim ``Communicator`` over the grid's data-parallel topology (the
generic link classes of ``core.discovery``) prices the gradient sync for
the setup log (``est_ms``, ``slow_crossings``), and with ``--bucket-mb``
the async engine prices the bucketed, overlapped sync
(``bucketed_estimate``); ``--trace`` writes that plane's Chrome trace.
Not ported yet: failure injection and elastic recovery.
"""
from __future__ import annotations

import argparse
import os
import time

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
from ..kernels.backend import resolve_device
from ..launch.mesh import dp_topology, make_grid, parse_mesh, run_ranks
from ..launch.step import layer_grad_bytes, make_train_step
from ..models import transformer as T
from ..models.convert import from_numpy, stack_runs, to_numpy
from ..obs import Tracer, get_logger, set_json
from ..optim.adamw import (OptConfig, init_opt_state, scatter_axes,
                           shard_opt_state)
from ..runtime.fault_tolerance import StragglerMonitor
from ..tree import tree_leaves

log = get_logger("train")

NOT_PORTED_CKPT = "ROADMAP.md, Queue 1 item 4: multi-rank checkpoints"
SPAWN_TIMEOUT_S = 3600.0
KERNELS = {"flash_fwd": fa.flash_attention_fwd,
           "flash_bwd_dq": fa.flash_bwd_dq,
           "flash_bwd_dkv": fa.flash_bwd_dkv,
           "quantize_int8": kq.quantize_int8,
           "dequantize_int8": kq.dequantize_int8,
           "quantize_ef_int8": kq.quantize_ef_int8}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    return {name: f.launches for name, f in KERNELS.items()}


def _backend(requested: str | None, dev: torch.device,
             local_world: int) -> str:
    """NCCL where every rank of this host has a card of its own, gloo
    where ranks share one or run on the CPU."""
    if dev.type == "cpu":
        if requested not in (None, "gloo"):
            raise ValueError(f"--dist-backend {requested} needs the card; "
                             f"the CPU takes gloo")
        return "gloo"
    cards = torch.cuda.device_count()
    if requested is None:
        return "nccl" if cards >= local_world else "gloo"
    if requested == "nccl" and cards < local_world:
        raise ValueError(f"NCCL refuses two ranks on one device: "
                         f"{local_world} ranks on {cards} card(s); pass "
                         f"--dist-backend gloo")
    if requested not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {requested!r}")
    return requested


def train(arch: str = "gpt-100m", steps: int = 100, mesh_spec: str = "1x1x1",
          seq: int = 128, batch: int = 8, comm: str = "multilevel",
          zero1: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 25, *, smoke: bool = False,
          device: str | torch.device = "cuda", log_every: int = 10,
          profile: str | None = None, dist_backend: str | None = None,
          log_json: bool = False, bucket_mb: float = 0.0,
          trace: str | None = None) -> dict:
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens
    (the global batch, split over the ranks) from random weights (seed 0),
    with lr 1e-3 and 20 warmup steps as the reference's driver.

    Returns rank 0's losses (the mean over the ranks), each step's wall ms
    (the host clock around a step that ends when its loss reaches the
    host), tokens per second over the steps after the first, and for the
    grid: ``world``, ``mode``, the backend and staging, the bytes this rank
    put on the slow axis per step beside what f32 would have sent, the
    host bytes staged per step, and each rank's kernel launches in this
    run.  One rank restarts from the newest checkpoint in ``ckpt_dir``.

    ``bucket_mb`` > 0 switches the gradient sync to size-targeted buckets
    (reverse-layer order, one fused collective per bucket); it forces
    ``zero1=False`` as the reference does, since ZeRO-1 scatters per leaf.
    ``trace`` writes a Chrome trace of rank 0's planning plane (simulated
    link occupancy, planner decisions, the engine's spans) to that path.
    ``profile`` traces rank 0's steps after the first with
    ``torch.profiler`` and writes its op table to that path
    (``_write_profile``)."""
    pods, data = parse_mesh(mesh_spec)
    world = pods * data
    if world > 1 and ckpt_dir:
        raise NotImplementedError(f"checkpoints of {world} ranks are not "
                                  f"ported yet ({NOT_PORTED_CKPT})")
    dev = resolve_device(device)
    kw = dict(arch=arch, steps=steps, pods=pods, data=data, seq=seq,
              batch=batch, comm=comm, zero1=zero1, ckpt_dir=ckpt_dir,
              ckpt_every=ckpt_every, smoke=smoke, device=str(dev),
              log_every=log_every, profile=profile, log_json=log_json,
              bucket_mb=bucket_mb, trace=trace)
    if world == 1:
        return _train_rank(**kw)
    if "WORLD_SIZE" in os.environ:          # torchrun: this process is a rank
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} "
                             f"ranks for mesh {mesh_spec}")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        dist.init_process_group(_backend(dist_backend, dev, local))
        try:
            return _train_rank(local_rank=int(os.environ.get("LOCAL_RANK",
                                                             0)), **kw)
        finally:
            dist.destroy_process_group()
    return run_ranks(_spawned_rank, world, _backend(dist_backend, dev, world),
                     (kw,), timeout=SPAWN_TIMEOUT_S)[0]


def _spawned_rank(rank: int, kw: dict) -> dict:
    return _train_rank(local_rank=rank, **kw)


def _train_rank(arch, steps, pods, data, seq, batch, comm, zero1, ckpt_dir,
                ckpt_every, smoke, device, log_every, profile, log_json,
                bucket_mb, trace, local_rank: int = 0) -> dict:
    """The training loop of one rank (of a grid whose process group is
    initialised, or alone)."""
    set_json(log_json)
    dev = resolve_device(device)
    if dev.type == "cuda" and pods * data > 1:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    grid = make_grid(pods, data, dev)
    lead = grid.rank == 0
    info = log.info if lead else (lambda *a, **k: None)
    cfg = get_config(arch, smoke=smoke)
    T.train_check(cfg)
    bucket_bytes = bucket_mb * 2 ** 20 if bucket_mb > 0 else None
    if bucket_bytes and zero1 and comm != "flat":
        info("bucketed sync: forcing zero1=False (ZeRO-1 "
             "scatters per leaf)", event="config")
        zero1 = False
    opt_cfg = OptConfig(comm_mode=comm, zero1=zero1, lr=1e-3,
                        warmup_steps=20, total_steps=steps,
                        bucket_bytes=bucket_bytes)
    pipe = DataPipeline(cfg, ShapeSpec("custom", "train", seq, batch))
    straggler = StragglerMonitor()
    ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    step_fn = make_train_step(cfg, opt_cfg, grid, dev)
    params = stack_runs(T.init_model(cfg, seed=0, device=dev), cfg)
    opt = shard_opt_state(init_opt_state(params, opt_cfg, n_slow=pods),
                          params, opt_cfg, grid)
    tracer = Tracer() if trace and lead else None
    est = _plan_estimates(cfg, grid, bucket_bytes, tracer) if lead else {}
    info(f"{cfg.name} on {dev}: {steps} steps of {batch} x {seq} tokens, "
         f"comm '{comm}' over a {pods}x{data} grid of {grid.world} rank(s)"
         + (f", backend {grid.backend}, collectives staged through host "
            f"memory: {'yes' if grid.staging == 'host' else 'no'}"
            if grid.world > 1 else "")
         + f"; grad sync est {est.get('est_ms', 0.0):.1f} ms/step, "
         f"{est.get('slow_crossings', 0)} slow-link crossing(s)",
         event="setup", arch=cfg.name, device=str(dev), world=grid.world,
         mode=comm, backend=grid.backend, staging=grid.staging,
         est_ms=est.get("est_ms"), slow_crossings=est.get("slow_crossings"))
    if "bucketed" in est:
        b = est["bucketed"]
        info(f"bucketed sync ({bucket_mb:g} MiB x {b['n_buckets']} "
             f"buckets): overlapped est {b['overlapped_s'] * 1e3:.1f} "
             f"ms/step vs serial {b['serial_s'] * 1e3:.1f} ms "
             f"({b['speedup']:.2f}x, balanced-compute model)",
             event="bucketed_estimate", n_buckets=b["n_buckets"],
             overlapped_ms=b["overlapped_s"] * 1e3,
             serial_ms=b["serial_s"] * 1e3, speedup=b["speedup"])

    start = 0
    latest = ckpt.latest_step() if ckpt else None
    if latest is not None:
        state = ckpt.restore(latest, {"params": to_numpy(params),
                                      "opt": to_numpy(opt)})
        params = from_numpy(state["params"], device=dev)
        opt = from_numpy(state["opt"], device=dev)
        start = latest + 1
        info(f"resumed from checkpoint step {latest}", event="resume",
             step=latest)

    before = launch_counts()
    losses: list[float] = []
    step_ms: list[float] = []
    wire: list[int] = []
    staged: list[int] = []
    prof = None
    for step_i in range(start, steps):
        if profile and lead and step_i == start + 1:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        w0 = grid.slow.wire_bytes if grid.slow else 0
        s0 = grid.staged_bytes
        t0 = time.monotonic()
        params, opt, loss = step_fn(params, opt, pipe.host_batch(step_i))
        losses.append(float(loss))       # waits for the step to finish
        dt = time.monotonic() - t0
        step_ms.append(dt * 1e3)
        wire.append((grid.slow.wire_bytes if grid.slow else 0) - w0)
        staged.append(grid.staged_bytes - s0)
        if straggler.observe(step_i, dt):
            info(f"step {step_i}: straggler ({dt:.2f}s vs median "
                 f"{straggler.median:.2f}s)", event="straggler",
                 step=step_i, dt_s=dt, median_s=straggler.median)
        if ckpt and ckpt_every and step_i % ckpt_every == 0 \
                and step_i > start:
            ckpt.save(step_i, {"params": to_numpy(params),
                               "opt": to_numpy(opt)})
        if step_i % log_every == 0:
            info(f"step {step_i:5d} loss {losses[-1]:.4f} "
                 f"({dt * 1e3:.0f} ms)", event="step", step=step_i,
                 loss=losses[-1], dt_ms=dt * 1e3)
    if ckpt:
        ckpt.wait()
    if tracer is not None:
        tracer.save(trace)
        info(f"trace: {tracer.n_events()} events -> {trace}",
             event="trace", path=trace, events=tracer.n_events())
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    if grid.world > 1:
        every = [None] * grid.world
        dist.all_gather_object(every, launches)
        launches = every
    steady = step_ms[1:]
    out = {"losses": losses, "step_ms": step_ms,
           "tokens_per_s": (batch * seq * len(steady) / sum(steady) * 1e3
                            if steady else None),
           "stragglers": len(straggler.dropped_steps),
           "start_step": start,
           "final_loss": losses[-1] if losses else None,
           "world": grid.world, "mode": comm, "backend": grid.backend,
           "staging": grid.staging, "staged_bytes": staged,
           "slow_wire_bytes": wire,
           "slow_f32_bytes": _slow_f32_bytes(params, grid),
           "launches": launches, "plan": est}
    if prof is not None:
        prof.stop()
        out["profile"] = _write_profile(prof, dev, profile, sum(steady))
    return out


def _plan_estimates(cfg, grid, bucket_bytes: float | None, tracer) -> dict:
    """The reference's planning plane (``train.py:115-146``): the
    gradient sync's postal-model estimate over the grid's data-parallel
    topology, with the generic link classes, its slow-link crossings and,
    with ``bucket_bytes``, the bucketed, overlapped estimate through the
    async engine at the communication-bound threshold (backward compute ~
    sync time, spread over layers by gradient size)."""
    sim = Communicator(dp_topology(grid, [GENERIC_LEVELS[0],
                                          GENERIC_LEVELS[-1]]),
                       policy="paper", backend="sim", tracer=tracer)
    lbytes = layer_grad_bytes(cfg)
    slice_bytes = sum(lbytes)
    est_s = sim.allreduce(slice_bytes).time
    out = {"est_ms": est_s * 1e3,
           "slow_crossings": sim.slow_crossings("allreduce",
                                                nbytes=slice_bytes)}
    if bucket_bytes and grid.world > 1:  # one rank syncs nothing
        b = overlapped_step_times(
            sim, lbytes, [est_s * x / slice_bytes for x in lbytes],
            bucket_bytes=bucket_bytes)
        out["bucketed"] = {k: b[k] for k in (
            "n_buckets", "overlapped_s", "serial_s", "speedup",
            "overlap_efficiency")}
    return out


def _slow_f32_bytes(params, grid) -> int:
    """The bytes one rank would put on the slow axis per step with f32:
    its 1/|data| shard of every leaf (the whole leaf where no dim
    divides); 0 with one pod."""
    if grid.slow is None:
        return 0
    axes = tree_leaves(scatter_axes(params, grid.data))
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
                    help="pods x data x model; the model axis must be 1")
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
                         "checkpoint); one rank only; none by default")
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
    if int(os.environ.get("RANK", 0)) != 0:
        return
    tps = out["tokens_per_s"]
    log.info(f"done: final_loss={out['final_loss']:.4f} "
             f"tokens/s={tps if tps is None else round(tps)} "
             f"stragglers={out['stragglers']} world={out['world']} "
             f"slow_wire_bytes/step={out['slow_wire_bytes'][-1:]} "
             f"(f32: {out['slow_f32_bytes']})", event="done",
             final_loss=out["final_loss"], tokens_per_s=tps,
             stragglers=out["stragglers"], world=out["world"],
             slow_wire_bytes=out["slow_wire_bytes"],
             slow_f32_bytes=out["slow_f32_bytes"])


if __name__ == "__main__":
    main()
