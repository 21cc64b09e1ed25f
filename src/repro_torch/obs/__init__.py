"""Observability: tracing, metrics, structured logs, measured-cost feedback,
contention deconvolution and the online health monitor.

A copy of ``repro/obs/__init__.py``.  ``repro_torch.core`` imports
:mod:`repro_torch.obs.metrics` (the registry backs
``Communicator.stats()``), and :mod:`repro_torch.obs.feedback` imports
``repro_torch.core`` (it drives ``discovery.refit_levels``).  To keep that pair
acyclic this package eagerly exposes only the leaf modules — ``feedback``
and ``monitor`` (which also imports ``repro_torch.core``) are loaded on first
attribute access.
"""
from __future__ import annotations

from .contention import deconvolve, occupancy
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
    "deconvolve",
    "occupancy",
    "FeedbackLoop",
    "FeedbackReport",
    "HealthMonitor",
    "HealthEvent",
]

_LAZY = {"FeedbackLoop": "feedback", "FeedbackReport": "feedback",
         "feedback": "feedback",
         "HealthMonitor": "monitor", "HealthEvent": "monitor",
         "monitor": "monitor"}


def __getattr__(name):
    modname = _LAZY.get(name)
    if modname is not None:
        # importlib, not `from . import`: the latter re-enters this hook
        # through importlib's hasattr check and recurses
        import importlib

        mod = importlib.import_module(f".{modname}", __name__)
        if name == modname:
            return mod
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
