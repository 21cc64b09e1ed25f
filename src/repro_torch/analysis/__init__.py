"""Static analysis for the collective stack: the plan verifier.

A copy of ``repro/analysis/verify.py`` (:mod:`repro_torch.analysis.verify`):
machine-check any lowered collective program (semantics, byte
conservation, DAG/FIFO feasibility, member closure).  Wired into
:meth:`Communicator.verify_plans
<repro_torch.core.Communicator.verify_plans>` and the simulator's
``sanitize=True`` mode.  The engine hazard pass and the repo lint come with
the engine (ROADMAP.md, Queue 1 item 3).
"""
from .verify import (Finding, VerificationError, check_lowered, quick_check,
                     verify_lowered)

__all__ = ["Finding", "VerificationError", "verify_lowered", "check_lowered",
           "quick_check"]
