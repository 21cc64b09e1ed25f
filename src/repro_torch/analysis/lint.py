"""Repo lint: AST rules for this codebase's recurring bug classes.

Generic linters don't know which of our modules must be deterministic or
device-free; these rules encode that repo-specific knowledge:

``RA001`` bare ``assert`` in library code.  ``python -O`` strips asserts,
          so a load-bearing assert silently stops checking.  Library
          invariants raise real exceptions; ``assert`` belongs in tests.
``RA002`` an import of ``torch`` in a deterministic hot path.  The
          simulator, engine, rounds IR, and scheduler core are pure-Python
          by design (they must run identically with no accelerator
          present); a device op there is a silent 1000x slowdown and an
          import-time torch dependency.  Backend classes that legitimately
          touch devices are allow-listed per module; a module-level import
          is outside every class, so it is a finding even in a module that
          has such a class.  (``jax`` cannot appear in this package at all:
          ``tests/test_torch_isolation.py`` guards that.)
``RA003`` wall-clock / nondeterminism in a deterministic component:
          ``time.time``-family, ``datetime.now``-family, the global
          ``random`` module, legacy ``np.random.*`` (seeded
          ``default_rng`` is fine), ``os.urandom``, ``uuid.uuid4``.  The
          simulation plane must be bit-reproducible; measurement modules
          (discovery, obs) are outside the deterministic set on purpose.
``RA004`` mutable default argument (``def f(x=[])``) — anywhere.

Suppress a true-but-intended finding by putting ``# lint: allow`` on the
flagged line.  :func:`lint_tree` walks ``src/repro_torch`` (skipping
nothing — the package ships lint-clean).

A copy of ``repro/analysis/lint.py`` whose deterministic modules are the
port's paths, whose device root is ``torch`` and whose allow-list names
the port's device classes.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable

__all__ = ["LintFinding", "lint_source", "lint_file", "lint_tree",
           "DETERMINISTIC_MODULES"]

_SUPPRESS = "lint: allow"

# Modules that must stay deterministic and device-free, keyed by path
# relative to the package root (``src/repro_torch``).  The value is the set
# of class/function names INSIDE which torch/device use is allowed (the
# explicitly-device-facing backends living in an otherwise pure module).
DETERMINISTIC_MODULES: dict[str, tuple[str, ...]] = {
    "core/rounds.py": (),
    "core/trees.py": (),
    "core/schedule.py": (),
    "core/simulator.py": (),
    "core/engine.py": (),
    "core/topology.py": (),
    "core/costmodel.py": (),
    "core/communicator.py": ("P2PBackend", "TorchBackend"),
    "serving/scheduler.py": ("TorchExecutor",),
    "serving/kv_cache.py": (),
}

_DEVICE_ROOTS = ("torch",)

# dotted-call patterns that read clocks or unseeded entropy
_WALLCLOCK = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.sleep", "time.process_time",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
    "os.urandom", "uuid.uuid1", "uuid.uuid4",
}
_RANDOM_ROOTS = ("random",)          # the stdlib global-state module
_NP_RANDOM_OK = ("default_rng",)     # np.random.default_rng(seed) is seeded


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One lint violation at ``path:line``."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` attribute chain as a string, or None for anything fancier."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, relmod: str | None,
                 suppressed: set[int]):
        self.path = path
        self.suppressed = suppressed
        self.findings: list[LintFinding] = []
        # RA002/RA003 apply only inside the deterministic set
        self.det = relmod in DETERMINISTIC_MODULES
        self.allowed_scopes = (DETERMINISTIC_MODULES.get(relmod or "", ())
                               if self.det else ())
        self.scope: list[str] = []

    # -- helpers --------------------------------------------------------- #
    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if line in self.suppressed:
            return
        self.findings.append(LintFinding(rule, self.path, line, message))

    def _in_allowed_scope(self) -> bool:
        return any(s in self.allowed_scopes for s in self.scope)

    def _scoped(self, node) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scoped(node)

    # -- RA001: bare assert ---------------------------------------------- #
    def visit_Assert(self, node: ast.Assert) -> None:
        self._emit(
            "RA001", node,
            "bare assert in library code — stripped under python -O; "
            "raise a real exception (or add '# lint: allow')")
        self.generic_visit(node)

    # -- RA002: device imports in deterministic modules ------------------ #
    def visit_Import(self, node: ast.Import) -> None:
        if self.det and not self._in_allowed_scope():
            for alias in node.names:
                root = alias.name.split(".")[0]
                if root in _DEVICE_ROOTS:
                    self._emit(
                        "RA002", node,
                        f"import of {alias.name!r} in a deterministic "
                        f"module — device code belongs in an allow-listed "
                        f"backend class")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if self.det and not self._in_allowed_scope() and node.module:
            if node.module.split(".")[0] in _DEVICE_ROOTS:
                self._emit(
                    "RA002", node,
                    f"import from {node.module!r} in a deterministic "
                    f"module — device code belongs in an allow-listed "
                    f"backend class")
        self.generic_visit(node)

    # -- RA003: wall clock / entropy in deterministic modules ------------ #
    def visit_Call(self, node: ast.Call) -> None:
        if self.det and not self._in_allowed_scope():
            name = _dotted(node.func)
            if name is not None:
                root = name.split(".")[0]
                if name in _WALLCLOCK:
                    self._emit(
                        "RA003", node,
                        f"{name}() in a deterministic module — the "
                        f"simulation plane must be reproducible; take "
                        f"time as a parameter")
                elif root in _RANDOM_ROOTS and "." in name:
                    self._emit(
                        "RA003", node,
                        f"{name}() uses global random state — use a "
                        f"seeded np.random.default_rng / random.Random")
                elif root in ("np", "numpy") and ".random." in f".{name}.":
                    leaf = name.split(".")[-1]
                    if leaf not in _NP_RANDOM_OK and name.split(".")[1] \
                            == "random" and len(name.split(".")) > 2:
                        self._emit(
                            "RA003", node,
                            f"legacy {name}() draws from global numpy "
                            f"state — use np.random.default_rng(seed)")
        self.generic_visit(node)

    # -- RA004: mutable default args (everywhere) ------------------------ #
    def _check_defaults(self, node) -> None:
        args = node.args
        for d in list(args.defaults) + [d for d in args.kw_defaults if d]:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(d, ast.Call)
                    and _dotted(d.func) in ("list", "dict", "set")):
                self._emit(
                    "RA004", d,
                    "mutable default argument — evaluated once at def "
                    "time and shared across calls; default to None")

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_defaults(node)
        self._scoped(node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._check_defaults(node)
        self._scoped(node)


def _suppressed_lines(source: str) -> set[int]:
    return {i for i, line in enumerate(source.splitlines(), start=1)
            if _SUPPRESS in line}


def lint_source(source: str, path: str = "<string>",
                relmod: str | None = None) -> list[LintFinding]:
    """Lint one module's source.  ``relmod`` is its path relative to the
    package root (selects the deterministic-module rules); None applies
    only the everywhere-rules (RA001, RA004)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:  # a broken file IS a finding, not a crash
        return [LintFinding("RA000", path, e.lineno or 0,
                            f"syntax error: {e.msg}")]
    v = _Visitor(path, relmod, _suppressed_lines(source))
    v.visit(tree)
    return sorted(v.findings, key=lambda f: (f.path, f.line, f.rule))


def lint_file(path: str, root: str | None = None) -> list[LintFinding]:
    """Lint one file.  ``root`` is the package root used to derive the
    deterministic-module key (defaults to the enclosing ``repro_torch``
    dir if the path contains one)."""
    relmod = _relmod(path, root)
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path, relmod)


def _relmod(path: str, root: str | None) -> str | None:
    p = os.path.abspath(path).replace(os.sep, "/")
    if root is not None:
        r = os.path.abspath(root).replace(os.sep, "/")
        return p[len(r):].lstrip("/") if p.startswith(r) else None
    marker = "/repro_torch/"
    i = p.rfind(marker)
    return p[i + len(marker):] if i >= 0 else None


def lint_tree(root: str) -> list[LintFinding]:
    """Lint every ``.py`` file under ``root`` (the package root, e.g.
    ``src/repro_torch``)."""
    findings: list[LintFinding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__",))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                findings.extend(lint_file(os.path.join(dirpath, fn), root))
    return findings


def format_findings(findings: Iterable[LintFinding]) -> str:
    return "\n".join(str(f) for f in findings)
