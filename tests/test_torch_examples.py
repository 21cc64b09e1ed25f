"""The port's counterparts of the reference's three examples, run at the
smoke size on the CPU in subprocesses (all five at once: the port's three
and the reference's quickstart and tree collectives, whose output the
port's must print):

* ``examples/torch_quickstart.py``: the planning plane is exact against
  the reference, so its stdout is ``examples/quickstart.py``'s line for
  line after its title;
* ``examples/torch_tree_collectives_on_mesh.py``: the plan's rounds and
  their link classes, bcast, reduce and allreduce from rank 3 on 8 gloo
  ranks, the crossings of the slowest link and the plan cache, each line
  ``examples/tree_collectives_on_mesh.py``'s after the title (the
  reference's on 8 host devices);
* ``examples/torch_serve_batch.py``: qwen3-4b's smoke config served on
  1x1x2 generates the requested tokens.

Each imports ``repro_torch`` only.
"""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
EX = REPO / "examples"
TIMEOUT = 240
PORT = ("torch_quickstart.py", "torch_tree_collectives_on_mesh.py",
        "torch_serve_batch.py")
RUNS = {
    "port_quickstart": ["torch_quickstart.py"],
    "ref_quickstart": ["quickstart.py"],
    "port_tree": ["torch_tree_collectives_on_mesh.py", "--device", "cpu",
                  "--smoke"],
    "ref_tree": ["tree_collectives_on_mesh.py"],
    "port_serve": ["torch_serve_batch.py", "--device", "cpu", "--smoke",
                   "--requests", "3", "--gen-len", "5"],
}


@pytest.fixture(scope="module")
def outs():
    """Every run's (return code, stdout lines, stderr), started together."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {k: subprocess.Popen([sys.executable, str(EX / v[0]), *v[1:]],
                                 cwd=REPO, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, v in RUNS.items()}
    res = {}
    try:
        for k, p in procs.items():
            out, err = p.communicate(timeout=TIMEOUT)
            res[k] = (p.returncode, out.splitlines(), err)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _ok(outs, key):
    rc, lines, err = outs[key]
    assert rc == 0, err[-3000:]
    return lines


def test_the_quickstart_prints_the_reference_examples_numbers(outs):
    port, ref = _ok(outs, "port_quickstart"), _ok(outs, "ref_quickstart")
    assert port[0].startswith("repro_torch quickstart")
    assert len(ref) == 20 and port[1:] == ref


def test_the_tree_collectives_print_the_reference_values(outs):
    port, ref = _ok(outs, "port_tree"), _ok(outs, "ref_tree")
    assert port[0].startswith("tree rounds") and ref[0].startswith(
        "tree rounds")
    assert port[1:] == ref[1:]
    assert "bcast from rank 3: [3. 3. 3. 3. 3. 3. 3. 3.]" in port
    assert "DCN crossings in the whole broadcast: 1" in port


def test_serve_batch_generates_the_requested_tokens(outs):
    lines = _ok(outs, "port_serve")
    head = [l for l in lines if l.startswith("[serve] qwen3-4b:")]
    assert len(head) == 1 and " 3 requests x 5 tokens" in head[0]
    rows = [l for l in lines if l.startswith("  req")]
    assert len(rows) == 2 and all(r.count(",") == 4 for r in rows)
    assert any("model axis of 2" in l for l in lines)


@pytest.mark.parametrize("name", PORT)
def test_the_examples_import_the_port_only(name):
    src = (EX / name).read_text()
    imports = [l.split()[1] for l in src.splitlines()
               if l.startswith(("import ", "from "))]
    assert "repro_torch" in {i.split(".")[0] for i in imports}
    assert not any(i.split(".")[0] in ("repro", "jax") for i in imports)
