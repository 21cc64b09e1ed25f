"""Serving entry point of the port: continuous batching over a paged KV cache,
real greedy decoding on one device or on the ranks of one model group,
with the multilevel engine pricing per-request collectives against weight
broadcasts.

On the H100:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-100m \\
      --requests 8 --prompt-len 512 --gen-len 16 --mesh 2x2x1 --monitor
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-100m \\
      --requests 8 --prompt-len 512 --gen-len 16 --mesh 1x1x2
On the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --mesh 2x2x1 --monitor
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --mesh 1x1x2

Counterpart of ``repro/launch/serve.py``.  With ``--mesh PxDxM`` the
network plane is the reference's: the weight-broadcast plan over the
multilevel topology of that grid (``launch.mesh.grid_communicator``, the
generic link classes of ``core.discovery``), a fifo-vs-priority engine
demo, and an :class:`~repro_torch.core.engine.Engine` that prices each
step's decode gathers against the periodic weight broadcast on the
scheduler's simulated clock; ``--monitor`` attaches a
:class:`~repro_torch.obs.monitor.HealthMonitor` to it.  The engine moves
only the simulated clock, never the tokens.  Without ``--mesh`` there is
no network plane (``engine=None``): the simulated clock prices compute
only.

With M > 1 the model runs tensor-parallel on the M ranks of one model
group (the replicas of the P x D cells would run the same requests, so
one group runs them): ``serve`` spawns them (``mesh.run_ranks``; gloo,
staged through host memory where they share one card, which NCCL
refuses).  Each rank holds its shard of the weights
(``transformer.init_model(model=, m=)``), every rank runs the same
deterministic scheduler, and their tokens must be equal; rank 0's result
is returned, with the model axis's collectives a prefill and a decode
step, the bytes each rank staged, and each rank's flash launches.  This
launcher reports the host's wall clock beside the simulated one: wall
time, tokens per second, and the time from the start of the run to each
request's first token.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.discovery import GENERIC_LEVELS
from ..core.engine import Engine
from ..kernels import flash_attention as fa
from ..kernels.backend import resolve_device
from ..launch.mesh import (Grid, choose_backend, grid_communicator,
                           make_grid, parse_mesh, run_ranks)
from ..models import transformer as T
from ..obs import (HealthMonitor, MetricsRegistry, Tracer, get_logger,
                   set_json)
from ..obs.metrics import percentile
from ..serving import (SLO, Scheduler, TorchExecutor, default_compute_model,
                       make_requests, poisson_arrivals)
from ..tree import tree_leaves

log = get_logger("serve")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _weight_bytes(cfg) -> float:
    """The whole model's parameter bytes (``init_model`` under a
    fake-tensor mode allocates nothing)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = T.init_model(cfg, seed=0, device="cpu")
    return float(sum(l.numel() * l.element_size()
                     for l in tree_leaves(params)))


class _Silent:
    """The logger of a model group's ranks after the first."""

    def info(self, msg: str, **fields) -> None:
        pass


def _engine_demo(wcomm, wbytes: float, cfg, prompt_len: int, model: int,
                 replicas: list, n_requests: int) -> dict:
    """Price 1 weight bcast + N request gathers under fifo vs priority
    (the reference's ``_engine_demo``); returns the logged numbers."""
    act_itemsize = getattr(torch, cfg.dtype).itemsize
    req_bytes = float(prompt_len * cfg.d_model * act_itemsize)
    lat = {}
    for policy in ("fifo", "priority"):
        eng = Engine(wcomm, policy=policy, age_rate=wbytes)
        eng.issue("bcast", wbytes, root=0)
        issue_t = eng.now
        reqs = [eng.issue("allgather", req_bytes / model,
                          members=replicas[r % len(replicas)], priority=1.0)
                for r in range(n_requests)]
        eng.wait_all()
        mean_lat = (sum(h.finished - issue_t for h in reqs)
                    / max(len(reqs), 1))
        lat[policy] = (eng.now, mean_lat)
    serial = wcomm.bcast(wbytes, root=0).time + sum(
        Engine(wcomm).issue("allgather", req_bytes / model,
                            members=replicas[r % len(replicas)]).wait().time
        for r in range(n_requests))
    out = {"makespan_ms": lat["priority"][0] * 1e3,
           "makespan_fifo_ms": lat["fifo"][0] * 1e3,
           "serial_ms": serial * 1e3,
           "mean_latency_priority_ms": lat["priority"][1] * 1e3,
           "mean_latency_fifo_ms": lat["fifo"][1] * 1e3}
    log.info(f"engine batch (1 weight bcast + {n_requests} request "
             f"gathers): makespan {lat['priority'][0]*1e3:.2f} ms vs "
             f"{serial*1e3:.2f} ms serialized; mean request latency "
             f"{lat['priority'][1]*1e3:.3f} ms (priority) vs "
             f"{lat['fifo'][1]*1e3:.3f} ms (fifo)",
             event="engine_demo", **out)
    return out


def _network_plane(cfg, mesh: str, dev, policy: str, prompt_len: int,
                   n_requests: int, tracer, registry, monitor: bool):
    """The reference's network plane on the topology of a ``mesh`` grid:
    the weight-broadcast plan and its log event, the engine demo, and the
    engine (plus its health monitor) the scheduler prices each step with.
    Returns (engine, monitor, the scheduler's network kwargs, the plan's
    numbers for the result)."""
    pods, data, model = parse_mesh(mesh)
    wbytes = _weight_bytes(cfg)
    # Weight-distribution plan through the single collectives entry point:
    # the multilevel tree broadcast of updated params crosses each slow link
    # exactly once (paper §3.2); one model group serves, so the plan and
    # its postal-model estimate are surfaced rather than shipped.
    wcomm = grid_communicator(Grid.shape_only(pods, data, model),
                              list(GENERIC_LEVELS), backend="sim",
                              policy="paper")
    if tracer is not None:
        wcomm.tracer = tracer
    bcast_est = wcomm.bcast(wbytes, root=0).time
    crossings = wcomm.slow_crossings("bcast", nbytes=wbytes)
    log.info(f"{cfg.name} on {dev}; {wcomm.describe()}; weight bcast "
             f"({wbytes/1e6:.1f} MB): est {bcast_est*1e3:.2f} ms, "
             f"{crossings} slow-link crossing(s)",
             event="setup", arch=cfg.name, device=str(dev), mesh=mesh,
             weight_mb=wbytes / 1e6, bcast_est_ms=bcast_est * 1e3,
             slow_crossings=crossings)
    replicas = [tuple(range(g * model, (g + 1) * model))
                for g in range(pods * data)]
    demo = _engine_demo(wcomm, wbytes, cfg, prompt_len, model, replicas,
                        n_requests)
    # each step's decode gathers are priced against the periodic weight
    # broadcast by the priority engine
    eng = Engine(wcomm, policy="fifo" if policy == "fifo" else "priority",
                 age_rate=wbytes, metrics=registry)
    mon = (HealthMonitor(engine=eng, metrics=registry, log_every=4)
           if monitor else None)
    act_itemsize = getattr(torch, cfg.dtype).itemsize
    net = {"engine": eng, "replicas": replicas, "weight_bytes": wbytes,
           "gather_bytes": float(cfg.d_model * act_itemsize) / model,
           "bcast_every": 16,
           "compute_model": default_compute_model(cfg.active_param_count(),
                                                  model_size=model)}
    plane = {"setup": {"weight_bytes": wbytes,
                       "bcast_est_ms": bcast_est * 1e3,
                       "slow_crossings": crossings},
             "engine_demo": demo}
    return eng, mon, net, plane


def serve(arch: str = "gpt-100m", n_requests: int = 4, prompt_len: int = 32,
          gen_len: int = 16, mesh: str | None = None, *,
          smoke: bool = False,
          device: str | torch.device = "cuda", policy: str = "priority",
          block_size: int = 8, rate: float | None = None,
          trace: str | None = None, monitor: bool = False,
          metrics_out: str | None = None, config=None) -> dict:
    """Run ``n_requests`` through the continuous-batching scheduler with
    the model on ``device`` (random weights from seed 0) and, given a
    ``mesh`` ("PxDxM"), the network plane on the topology of that grid
    (None: no network plane; the simulated clock prices compute only) and
    the model on the M ranks of one model group (NCCL where each rank has
    a card of its own, else gloo).

    ``rate``: open-loop Poisson arrival rate (req/s of *simulation* time);
    default: all requests arrive at t=0 (closed batch).  ``trace`` writes a
    Chrome trace (request lifecycles, engine spans, link occupancy).
    ``monitor`` attaches a :class:`~repro_torch.obs.HealthMonitor` to the
    engine (drift detection + auto-refit, periodic health snapshots in the
    log); ``metrics_out`` writes the run's Prometheus text exposition.
    ``config`` (a ``ModelConfig``) stands in for ``arch``'s."""
    if mesh is None and monitor:
        raise ValueError("the monitor watches the network plane: give a "
                         "mesh")
    model = parse_mesh(mesh)[2] if mesh is not None else 1
    cfg = config or get_config(arch, smoke=smoke)
    T.paged_arch_check(cfg)
    kw = dict(arch=arch, n_requests=n_requests, prompt_len=prompt_len,
              gen_len=gen_len, mesh=mesh, smoke=smoke, device=str(device),
              policy=policy, block_size=block_size, rate=rate, trace=trace,
              monitor=monitor, metrics_out=metrics_out, config=config)
    if model == 1:
        return _serve(grid=None, **kw)
    outs = run_ranks(_serve_rank, model,
                     choose_backend(None, resolve_device(device), model),
                     args=(kw,))
    for r, o in enumerate(outs[1:], 1):
        if not np.array_equal(o["generated"], outs[0]["generated"]):
            raise RuntimeError(f"rank {r} of the model group generated "
                               f"other tokens than rank 0")
    out = outs[0]
    out["model_axis"]["flash_fwd_launches"] = [
        o["model_axis"]["flash_fwd_launches"][0] for o in outs]
    out["model_axis"]["staged_bytes"] = [
        o["model_axis"]["staged_bytes"][0] for o in outs]
    return out


def _serve_rank(rank: int, kw: dict) -> dict:
    """One rank of a model group (spawned by :func:`serve`) on its card,
    the host's ``rank % cards``-th (the one card where the ranks share
    it): only rank 0 logs and writes the trace and metrics files."""
    global log
    if rank:
        log = _Silent()
        kw = dict(kw, trace=None, metrics_out=None)
    dev = resolve_device(kw["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    grid = make_grid(1, 1, dev, model=parse_mesh(kw["mesh"])[2])
    return _serve(grid=grid, **dict(kw, device=str(dev)))


def _serve(arch: str, n_requests: int, prompt_len: int, gen_len: int,
           mesh: str | None, *, smoke: bool, device: str, policy: str,
           block_size: int, rate: float | None, trace: str | None,
           monitor: bool, metrics_out: str | None, grid: Grid | None,
           config=None) -> dict:
    """:func:`serve` on this process: the whole model (``grid`` None) or
    this rank's shard of it on ``grid``'s model axis."""
    dev = resolve_device(device)
    cfg = config or get_config(arch, smoke=smoke)
    tp = grid.tp if grid is not None else None
    tracer = Tracer() if trace else None
    s_max = prompt_len + gen_len
    s_max += (-s_max) % block_size

    params = T.init_model(cfg, seed=0, device=dev) if tp is None else \
        T.init_model(cfg, seed=0, device=dev, model=tp.size, m=tp.index)
    # one registry spans engine + scheduler + monitor when scraping: the
    # exposition file must read as ONE process, not three
    registry = MetricsRegistry() if metrics_out or monitor else None
    eng = mon = None
    if mesh is None:
        log.info(f"{cfg.name} on {dev}; no mesh: no network plane, the "
                 f"simulated clock prices compute only", event="setup",
                 arch=cfg.name, device=str(dev))
        net, plane = {"tracer": tracer, "compute_model": default_compute_model(
            cfg.active_param_count())}, {}
    else:
        eng, mon, net, plane = _network_plane(
            cfg, mesh, dev, policy, prompt_len, n_requests, tracer,
            registry, monitor)
    # Continuous batching: requests join/leave the running batch per step;
    # KV lives in on-demand blocks.
    max_slots = min(n_requests, 8)
    n_blocks = 1 + max_slots * (s_max // block_size)
    ex = TorchExecutor(cfg, params, n_blocks=n_blocks, block_size=block_size,
                       max_slots=max_slots, max_blocks=s_max // block_size,
                       tp=tp)
    sch = Scheduler(
        ex, n_blocks=n_blocks, block_size=block_size, max_slots=max_slots,
        s_max=s_max, policy=policy, prefill_token_budget=4 * prompt_len,
        metrics=registry, **net)

    if rate is None:
        arrivals = [0.0] * n_requests
    else:
        arrivals = poisson_arrivals(rate, n_requests / rate, seed=0)[:n_requests]
        arrivals += [n_requests / rate] * (n_requests - len(arrivals))
    reqs = make_requests(arrivals, vocab=cfg.vocab, prompt_len=prompt_len,
                         gen_len=gen_len, slo=SLO(), seed=0)

    flash0 = fa.flash_attention_fwd.launches
    _sync(dev)
    t0 = time.perf_counter()
    report = sch.run(reqs)
    _sync(dev)
    dt = time.perf_counter() - t0
    gen = np.stack([np.asarray(r.tokens, np.int32)
                    for r in sorted(reqs, key=lambda r: r.rid)])
    n_tokens = sum(len(r.tokens) for r in reqs)
    ttft_wall = [t - t0 for t in ex.prefill_done_s]
    s = report.summary()
    out = {"generated": gen, "requests": reqs, "seconds": dt,
           "tokens_per_s": n_tokens / dt,
           "ttft_wall_p50_s": percentile(ttft_wall, 50),
           "ttft_wall_p99_s": percentile(ttft_wall, 99),
           "prefills": len(ex.prefill_done_s), "report": s,
           "first_logits": ex.first_logits, **plane}
    if tp is not None:
        mean = lambda xs: sum(xs) / len(xs) if xs else 0.0
        out["model_axis"] = {
            "model": tp.size,
            "collectives_per_prefill": mean(ex.tp_calls["prefill"]),
            "collectives_per_decode_step": mean(ex.tp_calls["decode"]),
            "staged_bytes": [grid.staged_bytes],
            "flash_fwd_launches": [fa.flash_attention_fwd.launches - flash0],
            "moe_dropped_per_layer": ex.moe_dropped.tolist()
            if cfg.moe else None,
            "moe_dropped_first_prefill": ex.first_prefill_dropped}
    if eng is not None:
        st = eng.stats()
        out["engine"] = {"issued": st.issued, "completed": st.completed,
                         "batches": st.batches, "now_s": st.now}
    log.info(f"{s['n_done']}/{s['n_requests']} done ({s['n_shed']} shed) in "
             f"{report.steps} steps; wall {dt:.3f} s, "
             f"{out['tokens_per_s']:.1f} tok/s, wall TTFT p50 "
             f"{out['ttft_wall_p50_s'] * 1e3:.2f} ms p99 "
             f"{out['ttft_wall_p99_s'] * 1e3:.2f} ms; simulated "
             f"{report.now * 1e3:.2f} ms, TTFT p50 "
             f"{s['ttft_p50_s'] * 1e3:.2f} ms p99 {s['ttft_p99_s'] * 1e3:.2f} "
             f"ms; max concurrent {report.max_concurrent}",
             event="report", n_done=s["n_done"], n_shed=s["n_shed"],
             steps=report.steps, wall_s=dt, tokens_per_s=out["tokens_per_s"],
             ttft_wall_p50_ms=out["ttft_wall_p50_s"] * 1e3,
             ttft_wall_p99_ms=out["ttft_wall_p99_s"] * 1e3,
             simulated_ms=report.now * 1e3,
             ttft_p50_ms=s["ttft_p50_s"] * 1e3,
             ttft_p99_ms=s["ttft_p99_s"] * 1e3,
             max_concurrent=report.max_concurrent)
    if mon is not None:
        snap = mon.snapshot()
        out["health"] = snap
        log.info(f"health: {snap['refits']} refit(s), "
                 f"{len(snap['stragglers'])} straggler(s), worst drift "
                 f"{snap['worst_drift']:.3f} over {snap['checks']} checks",
                 event="health", **{k: snap[k] for k in
                                    ("refits", "worst_drift", "checks",
                                     "stragglers", "links")})
    if metrics_out:
        with open(metrics_out, "w") as f:
            f.write(registry.to_prometheus())
        log.info(f"metrics: {len(registry.names())} series -> {metrics_out}",
                 event="metrics", path=metrics_out,
                 series=len(registry.names()))
    if tracer is not None:
        tracer.save(trace)
        log.info(f"trace: {tracer.n_events()} events -> {trace}",
                 event="trace", path=trace, events=tracer.n_events())
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-100m")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--mesh", default=None,
                    help="pods x data x model: the network plane's "
                         "topology, and a model axis > 1 serves on the "
                         "ranks of one model group; default: no network "
                         "plane, one device")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config instead of its "
                         "full width")
    ap.add_argument("--policy", default="priority",
                    choices=("fifo", "priority", "slo"))
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop arrival rate (req/s); default: closed batch")
    ap.add_argument("--log-json", action="store_true",
                    help="emit one JSON object per log line instead of the "
                         "human format")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace of the serving run "
                         "(open in chrome://tracing or Perfetto)")
    ap.add_argument("--monitor", action="store_true",
                    help="attach a HealthMonitor to the engine: drift "
                         "detection, straggler scoring, auto-refit, "
                         "periodic health snapshots in the log")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the run's metrics as Prometheus text "
                         "exposition (no tracer needed)")
    args = ap.parse_args()
    set_json(args.log_json)
    out = serve(args.arch, args.requests, args.prompt_len, args.gen_len,
                args.mesh, smoke=args.smoke, device=args.device,
                policy=args.policy, rate=args.rate, trace=args.trace,
                monitor=args.monitor, metrics_out=args.metrics_out)
    log.info(f"first request: {out['generated'][0][:16]}",
             event="sample", tokens=out["generated"][0][:16].tolist())


if __name__ == "__main__":
    main()
