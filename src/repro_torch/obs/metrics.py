"""Process-local metrics registry: counters, gauges, histograms.

Before this module every layer kept its own ad-hoc tallies — plain ints on
``PlanCache``, ``Engine._issued``-style privates, ``np.percentile`` calls
inlined in the serving summary.  The registry is the single sink those
layers now publish through: in the JAX package the communicator backs its
plan-cache/tree-build/repair counters here, the async engine its
issue/complete/batch counters and wait-latency histogram, and
:class:`repro_torch.serving.scheduler.Scheduler` its
request-lifecycle counters and TTFT/TPOT digests — while the frozen
``CommStats`` / ``EngineStats`` / summary-dict surfaces those layers expose
stay exactly as they were (they are *views* over the registry now).

Design constraints, in priority order:

1. **Cheap on the hot path.**  ``Counter.inc`` is one attribute add;
   ``Histogram.observe`` one list append.  Digests (p50/p95/p99) are
   computed at read time, never at write time.
2. **Monotonic counters.**  ``inc`` rejects negative deltas, so a counter
   can only move forward — what lets tests *assert* accounting identities
   (hits + misses = lookups, tree_builds only grows) instead of spot
   checking.  ``reset`` exists for explicit cache-clear semantics and is
   the only way down.
3. **No global state.**  Each registry is an object; layers create their
   own by default and accept a shared one for cross-layer dashboards.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Iterable

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "percentile"]


def percentile(xs: Iterable[float], q: float) -> float:
    """The ONE percentile rule every digest in the repo uses (linear
    interpolation, numpy semantics); empty input reads as NaN so summary
    tables stay total without special-casing."""
    xs = list(xs)
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=float), q))


def _prom_num(v: float) -> str:
    """Prometheus number rendering: integers stay integral, NaN is the
    literal ``NaN`` the exposition format defines (empty histograms)."""
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc by {n})")
        self._value += n

    @property
    def value(self):
        return self._value

    def reset(self) -> None:
        """Explicit zeroing (cache clear / test isolation) — the only
        non-monotonic move, and it is deliberate, never incidental."""
        self._value = 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Last-write-wins instantaneous value (queue depth, clock, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Windowed sample store with read-time percentile digests.

    ``window`` bounds memory for long serving runs: samples live in a
    ``deque(maxlen=window)``, so once ``count`` exceeds the window the
    oldest samples roll off and the digests become *rolling-window*
    percentiles (what a live monitor wants anyway).  Below the bound the
    behavior is exactly the old unbounded list's — same samples, same
    digests.  ``window=None`` keeps every sample (the pre-bound
    behavior), for short analytical runs that digest the full population.
    """

    __slots__ = ("name", "samples", "window")

    #: default rolling window — generous enough that every bounded
    #: benchmark/test population fits (identical digests), small enough
    #: that an open-ended serving run cannot grow without limit
    DEFAULT_WINDOW = 8192

    def __init__(self, name: str, window: int | None = DEFAULT_WINDOW):
        if window is not None and window <= 0:
            raise ValueError(f"histogram window must be positive or None, "
                             f"got {window}")
        self.name = name
        self.window = window
        self.samples: deque[float] = deque(maxlen=window)

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)

    def summary(self) -> dict:
        s = self.samples
        return {
            "count": len(s),
            "mean": float(np.mean(s)) if s else float("nan"),
            "p50": percentile(s, 50),
            "p95": percentile(s, 95),
            "p99": percentile(s, 99),
            "max": max(s) if s else float("nan"),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Histogram({self.name}, n={len(self.samples)})"


class MetricsRegistry:
    """Get-or-create namespace of metrics.  Asking for an existing name
    with a different kind is an error — two layers can share a registry
    without silently aliasing each other's instruments."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name)
            self._metrics[name] = m
        elif type(m) is not cls:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, *,
                  window: int | None = None) -> Histogram:
        """Get-or-create a histogram.  ``window`` applies at creation
        (``None`` = the class default); asking for an existing histogram
        with a *different* explicit window is an error — the window is
        part of the metric's meaning, two layers must not silently
        disagree on it."""
        m = self._metrics.get(name)
        if m is None:
            m = Histogram(name) if window is None \
                else Histogram(name, window=window)
            self._metrics[name] = m
        elif type(m) is not Histogram:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}, not Histogram")
        elif window is not None and m.window != window:
            raise ValueError(f"histogram {name!r} already registered with "
                             f"window={m.window}, not {window}")
        return m

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Flat JSON-able view: counters/gauges as numbers, histograms as
        digest dicts — what a dashboard or benchmark persists."""
        out: dict = {}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = m.value
            else:
                out[name] = m.summary()  # type: ignore[union-attr]
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every metric.

        Counters and gauges expose their value; histograms expose the
        summary type (quantiles over the current window plus ``_sum`` /
        ``_count``).  Dots in metric names become underscores — the only
        transform needed to satisfy the exposition grammar, and it is
        reversible for every name the repo registers (none contain
        underscore/dot collisions)."""
        lines: list[str] = []
        for name in self.names():
            m = self._metrics[name]
            pname = name.replace(".", "_")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_prom_num(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_num(m.value)}")
            else:
                lines.append(f"# TYPE {pname} summary")
                for q in (0.5, 0.95, 0.99):
                    lines.append(f'{pname}{{quantile="{q}"}} '
                                 f"{_prom_num(m.percentile(q * 100.0))}")
                lines.append(f"{pname}_sum {_prom_num(sum(m.samples))}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"MetricsRegistry({len(self._metrics)} metrics)"
