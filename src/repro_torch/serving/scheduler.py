"""Continuous-batching scheduler with paged KV memory and SLO-aware admission.

Requests join and leave the running batch every step (no lock-step batches):
each step admits waiting requests under a prefill token budget, decodes one
token for every running request, and retires finished ones — the per-request
state machine is WAITING -> PREFILL -> DECODE -> DONE (or SHED).

Time is a virtual clock: each step costs ``max(compute_s, network_s)`` —
compute from a roofline-style model over the tokens processed, network from
an engine pricing the step's per-request decode gathers against the periodic
fat weight broadcast on the shared multilevel topology (the priority
:class:`~repro_torch.core.engine.Engine`; ``launch.serve`` builds it).
With ``engine=None`` a step costs its compute only.  This module is a copy
of ``repro/serving/scheduler.py`` with ``TorchExecutor`` in place of the
JAX executor.

Memory is paged (``serving.kv_cache``): KV lives in fixed-size blocks handed
out on demand and freed on finish.  ``mode="dense"`` keeps the same
scheduler but reserves every request's worst-case ceil(s_max/block)
blocks at admission — the dense B x s_max allocation expressed in block
units, which is what makes paged-vs-dense capacity comparable at an equal
byte budget.

Policies:

``"fifo"``      FCFS admission, fair-shared network.
``"priority"``  FCFS admission, priority network (decode gathers preempt).
``"slo"``       Earliest-TTFT-deadline-first admission + shed-on-overload
                (a request whose TTFT deadline already passed is dropped
                instead of poisoning the queue behind it), priority network.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Protocol, Sequence

import numpy as np

from ..obs.metrics import MetricsRegistry, percentile
from ..obs.trace import PID_REQUESTS
from .kv_cache import BlockAllocator, blocks_needed
from .loadgen import Request, ReqState

__all__ = ["SchedPolicy", "Executor", "SimExecutor", "TorchExecutor",
           "Scheduler", "ServeReport", "summarize", "default_compute_model"]

SchedPolicy = ("fifo", "priority", "slo")


def default_compute_model(n_params: float, *, flops_per_s: float = 50e12,
                          model_size: int = 1):
    """Roofline step-time model: 2*N FLOPs per token forward, split over the
    tensor-parallel group."""

    def step_s(prefill_tokens: int, decode_tokens: int) -> float:
        tok = prefill_tokens + decode_tokens
        return 2.0 * n_params * tok / (flops_per_s * model_size)

    return step_s


class Executor(Protocol):
    """Model-side of a serve step.  The scheduler owns time, memory, and
    ordering; the executor owns tokens (and, for the torch one, the device
    state behind them)."""

    block_size: int

    def prefill(self, slot: int, blocks: Sequence[int],
                tokens: np.ndarray) -> int:
        """Run the prompt for one request, populate its KV blocks, return
        the greedy first token."""
        ...

    def extend(self, slot: int, block: int) -> None:
        """Append a newly allocated physical block to a slot's table."""
        ...

    def decode(self, slots: Sequence[int], tokens: Sequence[int],
               pos: Sequence[int]) -> list[int]:
        """One decode token for each listed slot (cache already holds
        ``pos[i]`` tokens); returns the greedy next tokens."""
        ...

    def release(self, slot: int) -> None:
        """Forget a finished request's slot (its blocks go back to the
        allocator on the scheduler side)."""
        ...


class SimExecutor:
    """Token-fabricating executor for scale sweeps: no device work, fully
    deterministic tokens — the bench sweeps schedulers and memory policies,
    not model quality."""

    def __init__(self, vocab: int = 512, block_size: int = 16):
        self.vocab = vocab
        self.block_size = block_size

    def prefill(self, slot, blocks, tokens):
        return int((int(tokens[-1]) * 2654435761 + len(tokens)) % self.vocab)

    def extend(self, slot, block):
        pass

    def decode(self, slots, tokens, pos):
        return [int((int(t) * 2654435761 + p) % self.vocab)
                for t, p in zip(tokens, pos)]

    def release(self, slot):
        pass


class TorchExecutor:
    """Real greedy decoding over the paged pools on one device; the
    counterpart of the JAX package's ``JaxExecutor``.

    Prefill runs per request at its block-aligned padded length with
    ``full_local_cache=True`` and the dense result is scattered into the
    request's physical blocks; decode is one ``decode_step_paged`` over the
    whole slot table with per-slot positions — idle slots write to the null
    block and are ignored.  The pools live on the parameters' device and
    are updated in place.  ``prefill_done_s`` keeps the host clock
    (``time.perf_counter``) at the end of each prefill, once its first
    token is on the host; ``first_logits`` the first prefill's last-token
    logits (numpy f32).

    On a model axis ``tp`` (a ``launch.mesh.Axis``), ``params`` are this
    rank's shard and the pools hold its KV heads; every rank of the model
    group runs the same scheduler and takes the same greedy tokens (the
    logits are all-gathered).  ``tp_calls`` keeps the axis's collectives
    of each prefill and of each decode step; for an MoE, ``moe_dropped``
    the slots this rank's expert-parallel blocks dropped, per layer, and
    ``first_prefill_dropped`` those of the first prefill."""

    def __init__(self, cfg, params, *, n_blocks: int, block_size: int,
                 max_slots: int, max_blocks: int, tp=None):
        import torch

        from ..models import layers as L
        from ..models import transformer as T
        self._torch = torch
        self._L = L
        self._T = T
        T.paged_arch_check(cfg)
        self.cfg = cfg
        self.params = params
        self.tp = tp
        self.device = params["embed"].device
        self.block_size = block_size
        self.max_slots = max_slots
        self.pools = T.init_paged_pools(cfg, n_blocks, block_size,
                                        device=self.device, tp=tp)
        self.tables = np.zeros((max_slots, max_blocks), np.int64)
        self.prefill_done_s: list[float] = []
        self.first_logits = None
        self.tp_calls: dict[str, list[int]] = {"prefill": [], "decode": []}
        self.moe_dropped = np.zeros(cfg.n_layers, np.int64) \
            if tp is not None and cfg.moe else None
        self.first_prefill_dropped = None

    def _forward(self, kind: str, fn, *args, **kw):
        """``fn(*args, **kw)``, one forward of the model, counting the
        model axis's collectives and the dropped expert slots: the
        forward's expert-parallel blocks come layer by layer, each layer
        in equally many token blocks."""
        L = self._L
        calls0 = self.tp.calls if self.tp is not None else 0
        if self.moe_dropped is not None:
            L.moe_fwd.dropped = []
        try:
            out = fn(*args, **kw)
        finally:
            blocks, L.moe_fwd.dropped = L.moe_fwd.dropped, None
        if self.tp is not None:
            self.tp_calls[kind].append(self.tp.calls - calls0)
        if self.moe_dropped is not None:
            per = len(blocks) // self.cfg.n_layers
            for j, n in enumerate(blocks):
                self.moe_dropped[j // per] += n
            if kind == "prefill" and self.first_prefill_dropped is None:
                self.first_prefill_dropped = sum(blocks)
        return out

    def _tensor(self, a: np.ndarray):
        return self._torch.from_numpy(a).to(self.device)

    def prefill(self, slot, blocks, tokens):
        L = int(tokens.shape[0])
        S_p = len(blocks) * self.block_size
        padded = np.zeros((1, S_p), np.int64)
        padded[0, :L] = tokens
        T = self._T
        logits, cache, _ = self._forward(
            "prefill", T.prefill, self.params, self.cfg,
            {"tokens": self._tensor(padded)}, S_p,
            last_pos=self._tensor(np.asarray([L - 1])),
            full_local_cache=True, tp=self.tp, seq_shard=False)
        T.scatter_prefill_cache(self.pools, cache, list(blocks),
                                self.block_size, row=0)
        self.tables[slot, :] = 0
        self.tables[slot, :len(blocks)] = blocks
        tok = int(self._torch.argmax(logits[0, -1]))
        self.prefill_done_s.append(time.perf_counter())
        if self.first_logits is None:
            self.first_logits = logits[0, -1].cpu().numpy()
        return tok

    def extend(self, slot, block):
        row = self.tables[slot]
        free = np.nonzero(row == 0)[0]
        if not len(free):
            raise ValueError(f"slot {slot} block table full")
        row[free[0]] = block

    def decode(self, slots, tokens, pos):
        tok = np.zeros((self.max_slots, 1), np.int64)
        posv = np.zeros((self.max_slots,), np.int64)
        for s, t, p in zip(slots, tokens, pos):
            tok[s, 0] = t
            posv[s] = p
        logits, self.pools = self._forward(
            "decode", self._T.decode_step_paged, self.params, self.cfg,
            self.pools, self._tensor(self.tables), self._tensor(tok),
            self._tensor(posv), tp=self.tp)
        out = self._torch.argmax(logits[:, 0], -1).cpu().numpy()
        return [int(out[s]) for s in slots]

    def release(self, slot):
        self.tables[slot, :] = 0


@dataclasses.dataclass
class ServeReport:
    """Outcome of one :meth:`Scheduler.run`."""

    requests: list[Request]
    steps: int
    now: float
    max_concurrent: int
    stalled_steps: int

    def summary(self) -> dict:
        return summarize(self.requests) | {
            "steps": self.steps, "sim_s": self.now,
            "max_concurrent": self.max_concurrent,
            "stalled_steps": self.stalled_steps,
        }


def _pct(xs: list[float], q: float) -> float:
    # one percentile rule repo-wide: the obs registry's (numpy linear
    # interpolation, NaN on empty) — summarize() keys are schema-guarded,
    # so the delegation must not change values, only their provenance
    return percentile(xs, q)


def summarize(requests: list[Request]) -> dict:
    done = [r for r in requests if r.state is ReqState.DONE]
    shed = [r for r in requests if r.state is ReqState.SHED]
    ttft = [r.ttft for r in done if r.ttft is not None]
    tpot = [r.tpot for r in done if r.tpot is not None]
    tokens = sum(len(r.tokens) for r in done)
    span = max((r.finish_s for r in done), default=0.0)
    out = {
        "n_requests": len(requests), "n_done": len(done), "n_shed": len(shed),
        "ttft_p50_s": _pct(ttft, 50), "ttft_p99_s": _pct(ttft, 99),
        "tpot_p50_s": _pct(tpot, 50), "tpot_p99_s": _pct(tpot, 99),
        "throughput_tok_s": tokens / span if span > 0 else 0.0,
    }
    slo_reqs = [r for r in done if r.slo is not None]
    if slo_reqs:
        ok = [r for r in slo_reqs
              if r.ttft <= r.slo.ttft_s and (r.tpot or 0) <= r.slo.tpot_s]
        out["slo_attainment"] = len(ok) / len(requests)
    return out


class Scheduler:
    """See module docstring.  One instance runs one trace via :meth:`run`.

    ``engine``/``replicas``/``weight_bytes``/``gather_bytes`` wire the
    network plane: each step issues one small per-request collective
    (``gather_op``: "allgather" models column-parallel activation
    gathering, "allreduce" row-parallel output reduction) on the request's
    tensor-parallel replica group at priority 1.0 and, every
    ``bcast_every`` steps, the fat weight broadcast over all ranks (default
    priority ``-nbytes`` — it only wins a link when nothing small wants it,
    aged so it cannot starve).  Without an engine the step cost is pure
    compute."""

    def __init__(self, executor, *, n_blocks: int, block_size: int,
                 max_slots: int, s_max: int, policy: str = "fifo",
                 mode: str = "paged", prefill_token_budget: int = 512,
                 compute_model=None, engine=None,
                 replicas: Sequence[tuple[int, ...]] | None = None,
                 weight_bytes: float = 0.0, gather_bytes: float = 1.0,
                 gather_op: str = "allgather", bcast_every: int = 0,
                 tracer=None, metrics: MetricsRegistry | None = None,
                 monitor=None):
        if policy not in SchedPolicy:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {SchedPolicy}")
        if mode not in ("paged", "dense"):
            raise ValueError(f"unknown mode {mode!r}")
        if gather_op not in ("allgather", "allreduce"):
            raise ValueError(f"unknown gather_op {gather_op!r}")
        if s_max % block_size:
            raise ValueError("s_max must be a multiple of block_size")
        self.ex = executor
        self.alloc = BlockAllocator(n_blocks, block_size)
        self.block_size = block_size
        self.max_slots = max_slots
        self.s_max = s_max
        self.max_blocks = s_max // block_size
        self.policy = policy
        self.mode = mode
        self.budget = prefill_token_budget
        self.compute_model = compute_model or (lambda pre, dec: 0.0)
        self.engine = engine
        self.replicas = list(replicas or [])
        self.weight_bytes = float(weight_bytes)
        self.gather_bytes = float(gather_bytes)
        self.gather_op = gather_op
        self.bcast_every = bcast_every
        # a traced engine traces its scheduler too (one trace per serve run)
        self.tracer = tracer if tracer is not None \
            else getattr(engine, "tracer", None)
        # a monitored engine monitors its scheduler too (request outcomes
        # and the per-step health check ride the same object)
        self.monitor = monitor if monitor is not None \
            else getattr(engine, "monitor", None)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_done = self.metrics.counter("serve.done")
        self._m_shed = self.metrics.counter("serve.shed")
        self._m_stalled = self.metrics.counter("serve.stalled_steps")
        self._m_ttft = self.metrics.histogram("serve.ttft_s")
        self._m_tpot = self.metrics.histogram("serve.tpot_s")

    # -- admission ------------------------------------------------------- #
    def _padded_len(self, req: Request) -> int:
        n = blocks_needed(req.prompt_len, self.block_size)
        return n * self.block_size

    def _admit_blocks(self, req: Request) -> int:
        """Blocks to reserve at admission: paged = just the prompt (grow on
        demand), dense = the full worst-case s_max footprint."""
        if self.mode == "dense":
            return self.max_blocks
        return blocks_needed(req.prompt_len, self.block_size)

    def _admit(self, waiting: deque, running: list, now: float):
        """Admit under the token budget (mutates ``waiting``/``running``);
        returns (prefill tokens spent, admitted requests)."""
        q = list(waiting)
        waiting.clear()
        if self.policy == "slo":
            q.sort(key=lambda r: (r.slo.ttft_deadline(r.arrival_s)
                                  if r.slo else float("inf")))
        budget = self.budget
        admitted, keep = [], []
        free_slots = sorted(set(range(self.max_slots))
                            - {r.slot for r in running})
        for i, r in enumerate(q):
            if (self.policy == "slo" and r.slo is not None
                    and now > r.slo.ttft_deadline(r.arrival_s)):
                r.state = ReqState.SHED
                r.finish_s = now
                self._m_shed.inc()
                if self.monitor is not None:
                    self.monitor.observe_request(r)
                if self.tracer is not None:
                    self.tracer.instant(PID_REQUESTS, f"req{r.rid}", "shed",
                                        now, {"reason": "ttft deadline past",
                                              "waited_s": now - r.arrival_s})
                continue
            need = self._admit_blocks(r)
            S_p = self._padded_len(r)
            # an over-budget prompt still enters on an otherwise-idle step,
            # else it could never be admitted at all
            over = S_p > budget and admitted
            # paged watermark: keep one growth block in reserve per running
            # request so admission doesn't immediately OOM-stall the batch
            headroom = 0 if self.mode == "dense" \
                else len(running) + len(admitted)
            fits = need + headroom <= self.alloc.n_free
            if not free_slots or over or not fits:
                keep.append(r)
                # FCFS head-of-line blocking is the point of fifo; EDF keeps
                # scanning so a small late-deadline request can't block an
                # urgent one behind it
                if self.policy != "slo":
                    keep.extend(q[i + 1:])
                    break
                continue
            budget -= S_p
            r.slot = free_slots.pop(0)
            r.blocks = self.alloc.alloc(need)
            r.state = ReqState.PREFILL
            admitted.append(r)
            running.append(r)
        waiting.extend(keep)
        return self.budget - budget, admitted

    # -- network --------------------------------------------------------- #
    def _network_step(self, running: list, now: float, step: int) -> float:
        if self.engine is None or not running:
            return 0.0
        handles = []
        for r in running:
            members = (self.replicas[r.slot % len(self.replicas)]
                       if self.replicas else None)
            handles.append(self.engine.issue(
                self.gather_op, self.gather_bytes, members=members,
                at=now, priority=1.0))
        if (self.bcast_every and self.weight_bytes
                and step % self.bcast_every == 0):
            # fat broadcast: default priority -nbytes ranks below every
            # request gather; its completion is NOT on the step's critical
            # path (it trails across steps), only its contention is priced
            self.engine.issue("bcast", self.weight_bytes, at=now)
        self.engine.wait_all()
        return max(h.finished for h in handles) - now

    # -- main loop ------------------------------------------------------- #
    def run(self, requests: list[Request]) -> ServeReport:
        pending = deque(sorted(requests, key=lambda r: r.arrival_s))
        waiting: deque[Request] = deque()
        running: list[Request] = []
        now, step, max_conc, stalls = 0.0, 0, 0, 0
        tr = self.tracer
        admit_s: dict[int, float] = {}  # rid -> admission time (spans)

        while pending or waiting or running:
            while pending and pending[0].arrival_s <= now:
                waiting.append(pending.popleft())
            if not waiting and not running:
                now = pending[0].arrival_s
                continue

            prefill_tokens, admitted = self._admit(waiting, running, now)
            if tr is not None:
                for r in admitted:
                    admit_s[r.rid] = now
                    if now > r.arrival_s:
                        tr.span(PID_REQUESTS, f"req{r.rid}", "waiting",
                                r.arrival_s, now)
            if not running and waiting:
                # nothing runs and the head request can't ever be admitted
                # (every block is free right now): fail loudly, don't spin
                raise RuntimeError(
                    f"request {waiting[0].rid} needs more memory/slots than "
                    f"the scheduler has (capacity {self.alloc.capacity} "
                    f"blocks, {self.max_slots} slots)")
            max_conc = max(max_conc, len(running))

            # decode plane: requests already holding a first token
            deciding, stalled = [], []
            for r in running:
                if r.state is not ReqState.DECODE:
                    continue
                need = blocks_needed(r.pos + 1, self.block_size)
                if need > len(r.blocks):
                    if need > self.max_blocks:
                        raise RuntimeError(f"request {r.rid} overran s_max")
                    if self.alloc.can_alloc(1):
                        blk = self.alloc.alloc(1)[0]
                        r.blocks.append(blk)
                        self.ex.extend(r.slot, blk)
                    else:
                        stalled.append(r)   # OOM: skip this step, retry
                        r.stalled_steps += 1
                        continue
                deciding.append(r)
            stalls += len(stalled)
            if stalled:
                self._m_stalled.inc(len(stalled))
            if stalled and not deciding and not admitted:
                # every live request is OOM-stalled: nobody will ever free a
                # block.  Evict the youngest to break the deadlock (its
                # blocks recycle into the survivors).
                victim = max(stalled, key=lambda r: r.arrival_s)
                victim.state = ReqState.SHED
                victim.finish_s = now
                self._m_shed.inc()
                if self.monitor is not None:
                    self.monitor.observe_request(victim, evicted=True)
                if tr is not None:
                    tr.instant(PID_REQUESTS, f"req{victim.rid}", "evicted",
                               now, {"reason": "OOM deadlock, youngest "
                                               "victim recycled"})
                self.alloc.free(victim.blocks)
                victim.blocks = []
                self.ex.release(victim.slot)
                victim.slot = -1
                running.remove(victim)
                continue

            compute_s = self.compute_model(prefill_tokens, len(deciding))
            net_s = self._network_step(running, now, step)
            now += max(compute_s, net_s)

            # commit tokens at the step's completion time
            for r in admitted:
                tok = self.ex.prefill(r.slot, r.blocks, r.prompt)
                r.pos = r.prompt_len
                r.tokens.append(tok)
                r.first_token_s = now
                r.state = ReqState.DECODE
                if tr is not None:
                    tr.span(PID_REQUESTS, f"req{r.rid}", "prefill",
                            admit_s[r.rid], now,
                            {"prompt_len": r.prompt_len,
                             "ttft_s": now - r.arrival_s})
            if deciding:
                toks = self.ex.decode([r.slot for r in deciding],
                                      [r.tokens[-1] for r in deciding],
                                      [r.pos for r in deciding])
                for r, t in zip(deciding, toks):
                    r.tokens.append(int(t))
                    r.pos += 1

            for r in list(running):
                if len(r.tokens) >= r.max_new_tokens:
                    r.state = ReqState.DONE
                    r.finish_s = now
                    self._m_done.inc()
                    if r.ttft is not None:
                        self._m_ttft.observe(r.ttft)
                    if r.tpot is not None:
                        self._m_tpot.observe(r.tpot)
                    if self.monitor is not None:
                        self.monitor.observe_request(r)
                    if tr is not None:
                        tr.span(PID_REQUESTS, f"req{r.rid}", "decode",
                                r.first_token_s, now,
                                {"tokens": len(r.tokens),
                                 "ttft_s": r.ttft, "tpot_s": r.tpot})
                    self.alloc.free(r.blocks)
                    r.blocks = []
                    self.ex.release(r.slot)
                    r.slot = -1
                    running.remove(r)
            step += 1
            if self.monitor is not None:
                self.monitor.on_step(now, step)

        return ServeReport(requests, step, now, max_conc, stalls)
