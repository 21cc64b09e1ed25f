"""Serving entry point of the port: continuous batching over a paged KV cache,
real greedy decoding on one device.

On the H100:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-100m \\
      --requests 8 --prompt-len 512 --gen-len 16
On the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke

The JAX launcher (``repro.launch.serve``) also plans the weight broadcast
over the multilevel topology and prices each step's collectives with the
engine.  That network plane comes with the planning-plane slice; until then
the scheduler runs with ``engine=None`` on one device, and its simulated
clock prices compute only.  This launcher reports the host's wall clock beside
it: wall time, tokens per second, and the time from the start of the run to
each request's first token.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..kernels.backend import resolve_device
from ..models import transformer as T
from ..obs import MetricsRegistry, Tracer, get_logger, set_json
from ..obs.metrics import percentile
from ..serving import (SLO, Scheduler, TorchExecutor, default_compute_model,
                       make_requests, poisson_arrivals)

log = get_logger("serve")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str = "gpt-100m", n_requests: int = 4, prompt_len: int = 32,
          gen_len: int = 16, *, smoke: bool = False,
          device: str | torch.device = "cuda", policy: str = "priority",
          block_size: int = 8, rate: float | None = None,
          trace: str | None = None,
          metrics_out: str | None = None) -> dict:
    """Run ``n_requests`` through the continuous-batching scheduler with
    the model on ``device`` (random weights from seed 0).

    ``rate``: open-loop Poisson arrival rate (req/s of *simulation* time);
    default: all requests arrive at t=0 (closed batch).  ``trace`` writes a
    Chrome trace of the request lifecycles; ``metrics_out`` the run's
    Prometheus text exposition."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    T.paged_arch_check(cfg)
    tracer = Tracer() if trace else None
    s_max = prompt_len + gen_len
    s_max += (-s_max) % block_size
    log.info(f"{cfg.name} on {dev}; the network plane (weight-broadcast "
             f"plan, engine pricing, --monitor) lands with the "
             f"planning-plane slice, so the simulated clock prices compute "
             f"only", event="setup", arch=cfg.name, device=str(dev))

    params = T.init_model(cfg, seed=0, device=dev)
    max_slots = min(n_requests, 8)
    n_blocks = 1 + max_slots * (s_max // block_size)
    ex = TorchExecutor(cfg, params, n_blocks=n_blocks, block_size=block_size,
                       max_slots=max_slots, max_blocks=s_max // block_size)
    registry = MetricsRegistry() if metrics_out else None
    sch = Scheduler(
        ex, n_blocks=n_blocks, block_size=block_size, max_slots=max_slots,
        s_max=s_max, policy=policy, prefill_token_budget=4 * prompt_len,
        compute_model=default_compute_model(cfg.active_param_count()),
        tracer=tracer, metrics=registry)

    if rate is None:
        arrivals = [0.0] * n_requests
    else:
        arrivals = poisson_arrivals(rate, n_requests / rate, seed=0)[:n_requests]
        arrivals += [n_requests / rate] * (n_requests - len(arrivals))
    reqs = make_requests(arrivals, vocab=cfg.vocab, prompt_len=prompt_len,
                         gen_len=gen_len, slo=SLO(), seed=0)

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
           "prefills": len(ex.prefill_done_s), "report": s}
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
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the run's metrics as Prometheus text "
                         "exposition")
    args = ap.parse_args()
    set_json(args.log_json)
    out = serve(args.arch, args.requests, args.prompt_len, args.gen_len,
                smoke=args.smoke, device=args.device, policy=args.policy,
                rate=args.rate, trace=args.trace,
                metrics_out=args.metrics_out)
    log.info(f"first request: {out['generated'][0][:16]}",
             event="sample", tokens=out["generated"][0][:16].tolist())


if __name__ == "__main__":
    main()
