"""Static analysis for the collective stack: plan verification, engine
hazard detection, and repo lint.

A copy of ``repro/analysis/__init__.py``.  Three passes, one CLI
(``python -m repro_torch.analysis``):

* :mod:`repro_torch.analysis.verify` — machine-check any lowered collective
  program (semantics, byte conservation, DAG/FIFO feasibility, member
  closure).  Wired into :meth:`Communicator.verify_plans
  <repro_torch.core.Communicator.verify_plans>` and the simulator's
  ``sanitize=True`` mode.
* :mod:`repro_torch.analysis.hazards` — static wait-for analysis of an Engine's
  pending batch (deadlock cycles, foreign/dangling deps, interleaving
  races, starvation risk).  Wired into ``Engine(check=True)``.
* :mod:`repro_torch.analysis.lint` — AST rules for this repo's recurring bug
  classes (bare asserts, device ops / wall-clock in deterministic modules,
  mutable defaults).  The gate is ``python -m repro_torch.analysis --all``.
"""
from .hazards import (Hazard, HazardError, HazardWarning, analyze_engine,
                      check_hazards)
from .lint import LintFinding, lint_file, lint_source, lint_tree
from .verify import (Finding, VerificationError, check_lowered, quick_check,
                     verify_lowered)

__all__ = [
    "Finding", "VerificationError", "verify_lowered", "check_lowered",
    "quick_check",
    "Hazard", "HazardError", "HazardWarning", "analyze_engine",
    "check_hazards",
    "LintFinding", "lint_source", "lint_file", "lint_tree",
]
