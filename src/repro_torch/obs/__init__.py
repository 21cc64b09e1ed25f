"""Observability for the port: request tracing, metrics, structured logs.

Copies of ``repro/obs/trace.py``, ``metrics.py`` and ``log.py``, which the
scheduler and the serve launcher use.  The measured-cost feedback and the
health monitor drive the planning plane and come with it."""
from __future__ import annotations

from .log import get_logger, set_json
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, percentile
from .trace import (PID_LINKS, PID_PLANNER, PID_PROGRAMS, PID_REQUESTS,
                    Tracer)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "percentile",
    "Tracer",
    "PID_LINKS",
    "PID_PROGRAMS",
    "PID_REQUESTS",
    "PID_PLANNER",
    "get_logger",
    "set_json",
]
