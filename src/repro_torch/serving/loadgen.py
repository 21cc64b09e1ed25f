"""Open-loop traffic generation + SLO definitions.

Open-loop means arrivals do NOT wait for the server: timestamps are drawn
from an arrival process at a configured offered load and the scheduler must
absorb (or shed) whatever lands.  This is the regime where closed-loop
benchmarks silently understate tail latency (coordinated omission), and the
regime the SLO policy is built for.

Two processes:

``poisson_arrivals``
    Homogeneous Poisson: exponential i.i.d. gaps at ``rate`` req/s.
``bursty_arrivals``
    Markov-modulated Poisson: ON windows at ``burst_factor`` x the base
    rate, OFF windows quiet, duty-cycled so the *mean* offered load still
    equals ``rate`` — same average load as the Poisson stream but with the
    burst structure that actually breaks fifo schedulers.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

__all__ = ["SLO", "ReqState", "Request", "poisson_arrivals",
           "bursty_arrivals", "make_requests"]


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request deadlines: first token within ``ttft_s`` of arrival,
    then ``tpot_s`` per additional output token."""

    ttft_s: float = 0.5
    tpot_s: float = 0.1

    def ttft_deadline(self, arrival_s: float) -> float:
        return arrival_s + self.ttft_s


class ReqState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    SHED = "shed"


@dataclasses.dataclass
class Request:
    """One serving request plus its runtime bookkeeping.

    The generator fills the identity fields; the scheduler drives ``state``
    through WAITING -> PREFILL -> DECODE -> DONE (or SHED) and stamps the
    timing fields on the virtual clock."""

    rid: int
    arrival_s: float
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int
    slo: SLO | None = None

    # runtime (scheduler-owned)
    state: ReqState = ReqState.WAITING
    slot: int = -1
    blocks: list[int] = dataclasses.field(default_factory=list)
    pos: int = 0                        # tokens in cache (prompt + generated)
    tokens: list[int] = dataclasses.field(default_factory=list)
    first_token_s: float | None = None
    finish_s: float | None = None
    stalled_steps: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def ttft(self) -> float | None:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot(self) -> float | None:
        """Mean per-token latency after the first token."""
        if self.finish_s is None or self.first_token_s is None:
            return None
        n = len(self.tokens) - 1
        if n <= 0:
            return 0.0
        return (self.finish_s - self.first_token_s) / n


def poisson_arrivals(rate: float, horizon_s: float,
                     seed: int = 0) -> list[float]:
    """Arrival timestamps of a Poisson process at ``rate`` req/s on
    [0, horizon_s)."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= horizon_s:
            return out
        out.append(t)


def bursty_arrivals(rate: float, horizon_s: float, seed: int = 0, *,
                    burst_factor: float = 8.0, duty: float = 0.125,
                    period_s: float = 2.0) -> list[float]:
    """ON/OFF modulated Poisson with mean offered load == ``rate``.

    Each ``period_s`` window starts with an ON phase of ``duty`` fraction at
    ``burst_factor * rate``; the OFF phase runs at the residual rate that
    keeps the average at ``rate`` (requires burst_factor * duty <= 1)."""
    if not 0 < duty < 1:
        raise ValueError("duty must be in (0, 1)")
    if burst_factor * duty > 1.0:
        raise ValueError("burst_factor * duty must be <= 1 to keep the "
                         "mean offered load at `rate`")
    off_rate = rate * (1.0 - burst_factor * duty) / (1.0 - duty)
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while t < horizon_s:
        phase = (t % period_s) / period_s
        r = burst_factor * rate if phase < duty else off_rate
        if r <= 0:  # skip to the next ON edge
            t = (t // period_s + 1) * period_s
            continue
        t += rng.exponential(1.0 / r)
        if t < horizon_s:
            out.append(t)
    return out


def make_requests(arrivals: list[float], *, vocab: int,
                  prompt_len: int | tuple[int, int] = 32,
                  gen_len: int | tuple[int, int] = 16,
                  slo: SLO | None = None, seed: int = 0) -> list[Request]:
    """Attach prompts/output lengths to arrival timestamps.

    ``prompt_len`` / ``gen_len`` may be (lo, hi) ranges (inclusive) for
    variable-length traffic — the continuous-batching case that lock-step
    batching handles worst."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if isinstance(spec, tuple):
            return int(rng.integers(spec[0], spec[1] + 1))
        return int(spec)

    reqs = []
    for i, t in enumerate(arrivals):
        L = max(1, draw(prompt_len))
        reqs.append(Request(
            rid=i, arrival_s=float(t),
            prompt=rng.integers(0, vocab, (L,)).astype(np.int32),
            max_new_tokens=max(1, draw(gen_len)), slo=slo))
    return reqs
