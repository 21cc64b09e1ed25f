"""The port's static analysis against the reference's: the engine hazard
analyzer, the repo lint and the ``python -m repro_torch.analysis`` gate.

The hazard analyzer is deterministic Python in both packages: the same
engine batch gives equal ``Hazard`` lists (kind, severity, message,
handle ids), and ``Engine(check=True)`` raises ``HazardError`` at the same
issue with the same message.  The lint rules are the reference's with
``torch`` as the device root: seeded snippets give the reference's
findings rule for rule and line for line, and the port itself lints clean.
"""
import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import pytest

import repro.core as J
from repro.analysis import __main__ as JM
from repro.analysis import hazards as JH
from repro.analysis import lint as JL
from repro.core import engine as JE

import repro_torch.core as T
from repro_torch.analysis import __main__ as TM
from repro_torch.analysis import hazards as TH
from repro_torch.analysis import lint as TL
from repro_torch.core import engine as TE

REPO = Path(__file__).resolve().parents[1]
PORT_ROOT = REPO / "src" / "repro_torch"
REF = types.SimpleNamespace(core=J, engine=JE, hazards=JH)
PORT = types.SimpleNamespace(core=T, engine=TE, hazards=TH)


def _comm(ns):
    return ns.core.Communicator(ns.core.paper_fig8_topology(), policy="auto")


def _hz(hazards):
    return [(h.kind, h.severity, h.message, h.handles) for h in hazards]


def _bucketed_stream(ns):
    """The reference gate's clean scenario: a bucketed gradient stream, a
    cross-set bcast ordered behind it."""
    eng = ns.engine.Engine(_comm(ns))
    hs = [eng.issue("allreduce", 1e6) for _ in range(6)]
    eng.issue("bcast", 1e5, members=eng.comm.members[:8], after=[hs[-1]])
    return eng


def _aged_serving(ns):
    """Clean: aged priority, a fat bcast under small ordered gathers."""
    eng = ns.engine.Engine(_comm(ns), policy="priority", age_rate=1e6)
    eng.issue("bcast", 1e8)
    for _ in range(5):
        eng.issue("gather", 1e4, after=[eng.issue("barrier")])
    return eng


def _after_cycle(ns):
    """Seeded: an ``after=`` cycle, made by post-issue mutation."""
    eng = ns.engine.Engine(_comm(ns))
    a = eng.issue("bcast", 1e6, members=eng.comm.members[:4])
    b = eng.issue("reduce", 1e6, members=eng.comm.members[4:8], after=[a])
    a.after = (b,)
    return eng


def _unaged_priority(ns):
    """Seeded: strict priority without ageing, a fat full-set bcast under
    a stream of small subset barriers sharing its links."""
    eng = ns.engine.Engine(_comm(ns), policy="priority")
    eng.issue("bcast", 1e8)
    for _ in range(4):
        eng.issue("barrier", members=eng.comm.members[:8])
    return eng


def _races_and_foreign(ns):
    """Overlapping unequal member sets with no ordering (races), and a
    dependency on another engine's handle (made by mutation)."""
    comm = _comm(ns)
    eng, other = ns.engine.Engine(comm), ns.engine.Engine(comm)
    a = eng.issue("allgather", 1e4, members=comm.members[:20])
    eng.issue("reduce", 1e5, members=comm.members[10:30], root=12)
    eng.issue("bcast", 1e5, members=comm.members[25:48], root=30)
    a.after = (other.issue("barrier"),)
    return eng


SCENARIOS = (_bucketed_stream, _aged_serving, _after_cycle,
             _unaged_priority, _races_and_foreign)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_analyze_engine_equals_reference(scenario):
    got = _hz(TH.analyze_engine(scenario(PORT)))
    assert got == _hz(JH.analyze_engine(scenario(REF)))
    caught = {"_bucketed_stream": set(), "_aged_serving": set(),
              "_after_cycle": {"deadlock-cycle"},
              "_unaged_priority": {"starvation"},
              "_races_and_foreign": {"cross-engine-dep",
                                     "interleaving-race"}}
    assert caught[scenario.__name__] <= {k for k, *_ in got}
    if scenario.__name__ == "_bucketed_stream":
        assert got == []
    if scenario.__name__ == "_aged_serving":
        assert "error" not in {sev for _, sev, *_ in got}


def _check_true(ns):
    """``check=True``: the issue that closes a cycle raises; the batch is
    left as it was before that issue; the flush-time check warns."""
    comm = _comm(ns)
    eng = ns.engine.Engine(comm, check=True)
    a = eng.issue("bcast", 1e6, members=comm.members[:4])
    b = eng.issue("reduce", 1e6, members=comm.members[4:8], after=[a])
    a.after = (b,)
    with pytest.raises(ns.hazards.HazardError) as err:
        eng.issue("barrier", members=comm.members[8:12])
    pending = [h.hid for h in eng._pending]
    a.after = ()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng.issue("allgather", 1e3, members=comm.members[2:6])
        res = eng.wait_all()
    return (str(err.value), _hz(err.value.hazards), pending,
            [str(w.message) for w in caught], [r.time for r in res])


def test_check_true_raises_at_the_same_issue_as_reference():
    got = _check_true(PORT)
    assert got == _check_true(REF)
    assert "deadlock-cycle" in got[0] and got[2] == [0, 1]
    assert any("interleaving-race" in w for w in got[3])


# one snippet per rule; RA002 seeds each package's device root
SNIPPETS = {
    "RA001": "def f(x):\n    assert x > 0\n    return x\n",
    "RA002": ("import os\n\nclass Backend:\n    def run(self):\n"
              "        import {dev}\n\nimport {dev}.nn\n"
              "from {dev} import zeros\n"),
    "RA003": ("import time, random\nimport numpy as np\n\n"
              "def f():\n    t = time.perf_counter()\n"
              "    r = random.random()\n"
              "    a = np.random.rand(3)\n"
              "    g = np.random.default_rng(0)\n    return t, r, a, g\n"),
    "RA004": "def f(x=[], *, y={}, z=None):\n    return x, y, z\n",
}
RELMOD = {"RA001": None, "RA002": "core/simulator.py",
          "RA003": "core/engine.py", "RA004": None}


def _findings(f):
    return [(x.rule, x.path, x.line, x.message) for x in f]


@pytest.mark.parametrize("rule", sorted(SNIPPETS))
def test_lint_source_gives_the_reference_findings(rule):
    src = SNIPPETS[rule]
    port = TL.lint_source(src.replace("{dev}", "torch"), "m.py",
                          RELMOD[rule])
    ref = JL.lint_source(src.replace("{dev}", "jax"), "m.py", RELMOD[rule])
    assert port and {f.rule for f in port} == {rule}
    # RA002: the same findings, each message naming its own device root
    assert [(r, p, n, m.replace("torch", "jax"))
            for r, p, n, m in _findings(port)] == _findings(ref)


def test_lint_suppression_and_allow_listed_backends():
    src = ("import torch  # lint: allow\n\nclass P2PBackend:\n"
           "    def run(self):\n        import torch\n"
           "        return torch.zeros(1)\n\nclass Other:\n"
           "    def run(self):\n        import torch.distributed\n")
    got = TL.lint_source(src, "c.py", "core/communicator.py")
    assert [(f.rule, f.line) for f in got] == [("RA002", 10)]
    sched = ("import time\n\nclass TorchExecutor:\n    def f(self):\n"
             "        return time.perf_counter()\n\ndef g():\n"
             "    return time.perf_counter()\n")
    got = TL.lint_source(sched, "s.py", "serving/scheduler.py")
    assert [(f.rule, f.line) for f in got] == [("RA003", 8)]


def test_lint_tree_finds_nothing_in_the_port():
    assert TL.lint_tree(str(PORT_ROOT)) == []
    assert set(TL.DETERMINISTIC_MODULES) == set(JL.DETERMINISTIC_MODULES)
    for rel in TL.DETERMINISTIC_MODULES:
        assert (PORT_ROOT / rel).is_file(), rel


def test_analysis_gate_hazards_and_lint_in_process(capsys):
    assert TM.main(["--hazards", "--lint"]) == 0
    out = capsys.readouterr().out
    assert "# hazards: 0 failure(s)" in out
    assert "# lint: 0 finding(s)" in out
    assert TM._clean_scenarios(_comm(PORT)) == []
    assert TM._seeded_scenarios(_comm(PORT)) == []


def test_analysis_gate_verify_fig8_equals_reference():
    """The verify pass on the Fig. 8 grid, in process: the same programs
    checked as the reference's gate, no finding, and the post-repair
    re-verification of every spliced plan."""
    sizes = (float(1 << 20), float(1 << 24))
    port = TM._matrix(T.paper_fig8_topology(), "fig8", sizes)
    assert port == JM._matrix(J.paper_fig8_topology(), "fig8", sizes)
    assert port[0] > 0 and port[1] == []
    rep = TM._post_repair(T.paper_fig8_topology(), "fig8", [3, 17, 40],
                          sizes)
    assert rep == JM._post_repair(J.paper_fig8_topology(), "fig8",
                                  [3, 17, 40], sizes)
    assert rep[0] > 0 and rep[1] == []


def test_analysis_cli_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--hazards", "--lint"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 2 and "nothing to do" in res.stderr


def test_every_roadmap_pointer_of_the_port_is_checked():
    """The port points into ROADMAP.md's Queue 1 nowhere: the last item
    it pointed to (the cuts inside a unit on a model axis) is ported."""
    found = set()
    for path in PORT_ROOT.rglob("*.py"):
        for m in path.read_text().split("Queue 1 item ")[1:]:
            found.add((str(path.relative_to(PORT_ROOT)),
                       int(m.split()[0].rstrip(":).,"))))
    assert found == set()
