"""``python -m repro_torch.analysis`` — the port's static-analysis gate.

``--verify``   lower every registered op × algorithm × segmentation over the
               paper's fig8 grid and 512 ranks in the strata of 2 pods x 16
               boards x 16 ranks and machine-check each program; then warm
               a plan cache, kill ranks, and re-verify every spliced plan
               (``Communicator.verify_plans``).
``--hazards``  run the hazard analyzer over canned engine scenarios: the
               legitimate ones (bucketed gradient stream, ordered cross-set
               traffic, aged priority serving) must be hazard-free, and the
               seeded defects (an ``after=`` cycle, a foreign handle, an
               unaged priority pile-up) must each be caught.
``--lint``     lint ``src/repro_torch`` with the repo rules (RA001-RA004).
``--all``      all three.  Exit status 1 on any finding, 0 when clean.

A copy of ``repro/analysis/__main__.py``.  The reference's 512-chip pod,
``tpu_v5e_multipod``, carries rates modelled for a TPU and is not ported;
:func:`strata_512` builds the same coordinates with discovery's
:data:`~repro_torch.core.discovery.GENERIC_LEVELS`.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import warnings

import numpy as np

from ..core import rounds as R
from ..core.communicator import Communicator
from ..core.discovery import GENERIC_LEVELS
from ..core.engine import Engine
from ..core.topology import Topology, paper_fig8_topology
from ..core.trees import PAPER_POLICY, build_multilevel_tree
from .hazards import HazardWarning, analyze_engine
from .lint import lint_tree
from .verify import verify_lowered

ALL_OPS = ("bcast", "reduce", "allreduce", "barrier",
           "gather", "scatter", "allgather")


def strata_512(pods: int = 2, boards: int = 16,
               ranks_per_board: int = 16) -> Topology:
    """512 ranks in the reference's multipod strata, [pod, board] over the
    rank order, with the generic link classes (slowest first)."""
    idx = np.arange(pods * boards * ranks_per_board)
    coords = np.stack([idx // (boards * ranks_per_board),
                       idx // ranks_per_board], axis=1)
    return Topology(coords, GENERIC_LEVELS)


def _matrix(topo, label: str, sizes) -> tuple[int, list[str]]:
    """Verify every lowering the planner can emit on ``topo``; returns
    (programs checked, failure messages)."""
    members = tuple(range(topo.nprocs))
    tree = build_multilevel_tree(topo, 0, members, PAPER_POLICY)
    checked, failures = 0, []

    def run(desc: str, fn):
        nonlocal checked
        try:
            low = fn()
        except ValueError:
            return  # algorithm rejects this shape (e.g. rsag non-uniform)
        findings = verify_lowered(low)
        checked += 1
        for f in findings:
            failures.append(f"{label} {desc}: {f}")

    for nbytes in sizes:
        for seg in (None, "bdp"):
            for op in ALL_OPS:
                run(f"{op}/tree nb={nbytes:g} seg={seg}",
                    lambda op=op, nb=nbytes, s=seg:
                    R.lower_tree(op, tree, topo, nb, s))
            run(f"bcast/sag nb={nbytes:g} seg={seg}",
                lambda nb=nbytes, s=seg:
                R.lower_sag_bcast(topo, 0, members, nb, s))
            run(f"allreduce/rsag nb={nbytes:g} seg={seg}",
                lambda nb=nbytes, s=seg:
                R.lower_rsag_allreduce(topo, members, nb, s))
    return checked, failures


def _post_repair(topo, label: str, failed, sizes) -> tuple[int, list[str]]:
    """Warm a plan cache, splice ranks out, and verify every surviving
    plan at every size it ever lowered."""
    comm = Communicator(topo, policy="auto")
    for op in ALL_OPS:
        for nb in sizes:
            comm.plan(op, nbytes=nb).lower(nb)
    try:
        comm.repair(failed)  # repair re-verifies automatically...
        n = comm.verify_plans()  # ...and the explicit call re-proves it
    except ValueError as e:
        return 0, [f"{label} post-repair: {e}"]
    return n, []


def cmd_verify() -> int:
    t0 = time.perf_counter()
    total, failures = 0, []
    fig8 = paper_fig8_topology()
    big = strata_512()
    for topo, label, sizes, failed in (
            (fig8, "fig8", (float(1 << 20), float(1 << 24)), [3, 17, 40]),
            (big, "512-rank", (float(1 << 20),), [7, 100, 300, 511])):
        n, f = _matrix(topo, label, sizes)
        total += n
        failures += f
        n, f = _post_repair(topo, label, failed, sizes)
        total += n
        failures += f
    dt = time.perf_counter() - t0
    for msg in failures:
        print(f"VERIFY FAIL {msg}")
    print(f"# verify: {total} lowered programs checked, "
          f"{len(failures)} finding(s), {dt:.1f}s")
    return 1 if failures else 0


def _clean_scenarios(comm) -> list[str]:
    """Legitimate engine programs must analyze hazard-free."""
    failures = []
    # bucketed gradient stream: same member set -> implicit FIFO orders it
    eng = Engine(comm)
    hs = [eng.issue("allreduce", 1e6) for _ in range(6)]
    # cross-set traffic explicitly ordered behind the stream
    eng.issue("bcast", 1e5, members=comm.members[:8], after=[hs[-1]])
    for h in analyze_engine(eng):
        failures.append(f"clean bucketed stream flagged: {h}")
    eng.wait_all()
    # serve-like: aged priority, fat bcast under small gathers -> the
    # age_rate escape hatch means no starvation hazard
    eng = Engine(comm, policy="priority", age_rate=1e6)
    eng.issue("bcast", 1e8)
    for _ in range(5):
        eng.issue("gather", 1e4, after=[eng.issue("barrier")])
    for h in analyze_engine(eng):
        if h.severity == "error":
            failures.append(f"clean serving scenario flagged: {h}")
    eng.wait_all()
    return failures


def _seeded_scenarios(comm) -> list[str]:
    """Seeded defects the analyzer MUST catch."""
    failures = []
    # after= cycle (only constructible by post-issue mutation)
    eng = Engine(comm)
    a = eng.issue("bcast", 1e6, members=comm.members[:4])
    b = eng.issue("reduce", 1e6, members=comm.members[4:8], after=[a])
    a.after = (b,)
    hz = analyze_engine(eng)
    if not any(h.kind == "deadlock-cycle" for h in hz):
        failures.append("seeded after= cycle not flagged")
    eng._pending.clear()  # never execute the poisoned batch
    # unaged strict priority: a fat full-set bcast under a stream of small
    # high-priority subset ops sharing its links
    eng = Engine(comm, policy="priority")
    eng.issue("bcast", 1e8)
    for _ in range(4):
        eng.issue("barrier", members=comm.members[:8])
    if not any(h.kind == "starvation" for h in analyze_engine(eng)):
        failures.append("seeded starvation risk not flagged")
    eng.wait_all()
    return failures


def cmd_hazards() -> int:
    comm = Communicator(paper_fig8_topology(), policy="auto")
    failures = _clean_scenarios(comm) + _seeded_scenarios(comm)
    for msg in failures:
        print(f"HAZARDS FAIL {msg}")
    print(f"# hazards: {len(failures)} failure(s)")
    return 1 if failures else 0


def cmd_lint() -> int:
    # the package root: the directory above this one
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings = lint_tree(root)
    for f in findings:
        print(f"LINT {f}")
    print(f"# lint: {len(findings)} finding(s) over {root}")
    return 1 if findings else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static-analysis gate: plan verifier, engine hazard "
                    "analyzer, repo lint")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--hazards", action="store_true")
    ap.add_argument("--lint", action="store_true")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        args.verify = args.hazards = args.lint = True
    if not (args.verify or args.hazards or args.lint):
        ap.error("nothing to do: pass --verify, --hazards, --lint or --all")
    rc = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", HazardWarning)
        if args.verify:
            rc |= cmd_verify()
        if args.hazards:
            rc |= cmd_hazards()
        if args.lint:
            rc |= cmd_lint()
    return rc


if __name__ == "__main__":
    sys.exit(main())
