"""Training entry point of the port: one device, checkpoint and resume.

On the H100:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-100m \\
      --steps 5 --seq 1024 --batch 8
On the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke

Counterpart of ``repro/launch/train.py:79 train`` on a 1x1x1 mesh.  Each
step takes ``DataPipeline.host_batch`` (the reference's tokens, bit for
bit), the loss and its gradients, and the AdamW update.  The multilevel
gradient sync over a (pod x data) rank grid, its communicator and cost
estimates, bucketed sync, failure injection and elastic recovery need
more than one rank and come with ``ROADMAP.md`` Queue 1 item 2; any other
mesh raises.
Checkpoints hold the reference's stacked-run layout (``models/convert.py``)
and a run resumes from the newest one in ``ckpt_dir``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config
from ..configs.shapes import ShapeSpec
from ..data.pipeline import DataPipeline
from ..kernels.backend import resolve_device
from ..launch.step import make_train_step
from ..models import transformer as T
from ..models.convert import (opt_from_jax, opt_to_jax, params_from_jax,
                              params_to_jax)
from ..obs import get_logger, set_json
from ..optim.adamw import NOT_PORTED, OptConfig, init_opt_state
from ..runtime.fault_tolerance import StragglerMonitor

log = get_logger("train")


def train(arch: str = "gpt-100m", steps: int = 100, mesh_spec: str = "1x1x1",
          seq: int = 128, batch: int = 8, comm: str = "multilevel",
          zero1: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 25, *, smoke: bool = False,
          device: str | torch.device = "cuda", log_every: int = 10,
          profile: str | None = None) -> dict:
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens
    from random weights (seed 0), with lr 1e-3 and 20 warmup steps
    as the reference's driver.  Restarts from the newest checkpoint in
    ``ckpt_dir`` if there is one.  Returns the losses, each step's wall ms
    (the host clock around a step that ends when its loss reaches the
    host) and tokens per second over the steps after the first.

    ``profile`` traces the steps after the first with ``torch.profiler``
    and writes its table of ops by self device time (self CPU time on the
    CPU) to that path; the result then holds the device's busy ms beside
    the wall ms of those steps (``_write_profile``)."""
    dev = resolve_device(device)
    if mesh_spec != "1x1x1":
        raise NotImplementedError(f"mesh {mesh_spec}: the port trains on one "
                                  f"device so far ({NOT_PORTED})")
    cfg = get_config(arch, smoke=smoke)
    T.port_check(cfg)
    opt_cfg = OptConfig(comm_mode=comm, zero1=zero1, lr=1e-3,
                        warmup_steps=20, total_steps=steps)
    pipe = DataPipeline(cfg, ShapeSpec("custom", "train", seq, batch))
    straggler = StragglerMonitor()
    ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    step_fn = make_train_step(cfg, opt_cfg, dev)
    params = T.init_model(cfg, seed=0, device=dev)
    opt = init_opt_state(params, opt_cfg)
    log.info(f"{cfg.name} on {dev}: {steps} steps of {batch} x {seq} "
             f"tokens, comm '{comm}' on one rank (identity sync)",
             event="setup", arch=cfg.name, device=str(dev))

    start = 0
    latest = ckpt.latest_step() if ckpt else None
    if latest is not None:
        like = {"params": params_to_jax(params, cfg),
                "opt": opt_to_jax(opt, cfg)}
        state = ckpt.restore(latest, like)
        params = params_from_jax(state["params"], cfg, device=dev)
        opt = opt_from_jax(state["opt"], cfg, device=dev)
        start = latest + 1
        log.info(f"resumed from checkpoint step {latest}",
                 event="resume", step=latest)

    losses: list[float] = []
    step_ms: list[float] = []
    prof = None
    for step_i in range(start, steps):
        if profile and step_i == start + 1:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        t0 = time.monotonic()
        params, opt, loss = step_fn(params, opt, pipe.host_batch(step_i))
        losses.append(float(loss))       # waits for the step to finish
        dt = time.monotonic() - t0
        step_ms.append(dt * 1e3)
        if straggler.observe(step_i, dt):
            log.info(f"step {step_i}: straggler ({dt:.2f}s vs median "
                     f"{straggler.median:.2f}s)", event="straggler",
                     step=step_i, dt_s=dt, median_s=straggler.median)
        if ckpt and ckpt_every and step_i % ckpt_every == 0 \
                and step_i > start:
            ckpt.save(step_i, {"params": params_to_jax(params, cfg),
                               "opt": opt_to_jax(opt, cfg)})
        if step_i % log_every == 0:
            log.info(f"step {step_i:5d} loss {losses[-1]:.4f} "
                     f"({dt * 1e3:.0f} ms)", event="step", step=step_i,
                     loss=losses[-1], dt_ms=dt * 1e3)
    if ckpt:
        ckpt.wait()
    steady = step_ms[1:]
    out = {"losses": losses, "step_ms": step_ms,
           "tokens_per_s": (batch * seq * len(steady) / sum(steady) * 1e3
                            if steady else None),
           "stragglers": len(straggler.dropped_steps),
           "start_step": start,
           "final_loss": losses[-1] if losses else None}
    if prof is not None:
        prof.stop()
        out["profile"] = _write_profile(prof, dev, profile, sum(steady))
    return out


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
                    help="pods x data x model; only 1x1x1 is ported")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--comm", default="multilevel",
                    choices=["flat", "multilevel", "multilevel_compress"])
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config instead of its "
                         "full width")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (resumes from its newest "
                         "checkpoint); none by default")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="trace the steps after the first with "
                         "torch.profiler and write its op table to PATH")
    ap.add_argument("--log-json", action="store_true",
                    help="emit one JSON object per log line instead of the "
                         "human format")
    args = ap.parse_args()
    set_json(args.log_json)
    out = train(args.arch, args.steps, args.mesh, args.seq, args.batch,
                args.comm, not args.no_zero1, args.ckpt_dir,
                args.ckpt_every, smoke=args.smoke, device=args.device,
                log_every=args.log_every, profile=args.profile)
    tps = out["tokens_per_s"]
    log.info(f"done: final_loss={out['final_loss']:.4f} "
             f"tokens/s={tps if tps is None else round(tps)} "
             f"stragglers={out['stragglers']}", event="done",
             final_loss=out["final_loss"], tokens_per_s=tps,
             stragglers=out["stragglers"])


if __name__ == "__main__":
    main()
