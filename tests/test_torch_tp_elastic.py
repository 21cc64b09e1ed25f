"""Elastic recovery (``fail_at``) of training on a model axis, against the
JAX package on the CPU.

The reference's own model-axis training does not run on this toolchain
(its first step raises ``ShardingTypeError``; ROADMAP Queue 3 F), but its
decisions do not depend on the model axis: quorum, repair and
accumulation read only the data-parallel ranks.  So the oracle is split:

* the decisions of the port's 3x1x2 run (``failure`` and ``repair``
  events field for field, ``repairs``, ``recoveries``, the number of
  losses) are the reference's ``train()`` on 3x1x1 with the same
  ``fail_at``, in ``multilevel_compress`` and in ``multilevel``: pod 1 of
  3 lost before step 2 keeps a quorum and is repaired in place; pod 1 of
  the 2 left, lost before step 4, is below it, and training restarts from
  the step-2 checkpoint (written on the shrunk grid) with accum 2;
* the values: from the reference's weights in f32, ``multilevel``, the
  port's 3x1x1 losses within 1e-4 relative of the reference's, step by
  step (``tests/test_torch_elastic.py``'s tolerance), and the port's
  3x1x2 losses within 1e-4 relative of its 3x1x1 ones
  (``tests/test_torch_tp_train.py``'s ``TRAJ_TOL``);
* the state: the step-2 restore equals its save bit for bit (SHA-256),
  each checkpoint's EF leaves lead with the pods of the grid that wrote
  it, and the EF rows the survivors carry through the in-place repair
  are, bit for bit, the reference's ``_fit_ef`` of the global EF rows
  gathered just before it; recurrentgemma's smoke config on 2x1x2 (its
  ``w_out`` on the run dim, its one KV head split) restarts from a
  checkpoint it restores bit for bit.

The reference runs in a subprocess (3 host devices, JSON logs) while the
port's ranks run, once for the module.
"""
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import forked_ranks, jax_to_numpy
from repro import configs as jconfigs
from repro.launch import train as JTRAIN
from repro.models import transformer as JT
from repro_torch.launch.train import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-4      # relative, step by step
CASE = dict(steps=6, seq=32, batch=6, zero1=True, ckpt_every=2,
            fail_at={2: [1], 4: [1]})
MODES = {"compress": "multilevel_compress", "multilevel": "multilevel"}
EVENT_KEYS = ("event", "step", "failed", "accum", "in_place", "repaired",
              "evicted", "kept", "survivors")
RG = dict(steps=5, seq=32, batch=2, comm="multilevel_compress",
          ckpt_every=2, fail_at={3: [1]})

REF_SCRIPT = r"""
import json, sys, tempfile
import jax, jax.numpy as jnp
import repro.launch.train as RT
from repro.checkpoint.manager import CheckpointManager
from repro.obs import set_json

set_json(True)
# written synchronously: the reference asks for the newest checkpoint
# before it joins its writer
RT.CheckpointManager = lambda d, keep: CheckpointManager(
    d, keep=keep, async_write=False)
init = RT.T.init_model
for name, kw in json.loads(sys.argv[1]).items():
    fail_at = {int(k): v for k, v in kw.pop("fail_at").items()}
    RT.T.init_model = (lambda key, cfg: jax.tree.map(
        lambda a: a.astype(jnp.float32), init(key, cfg))) \
        if kw.pop("f32") else init
    print(json.dumps({"case": name}), flush=True)
    out = RT.train("gpt-100m", mesh_spec="3x1x1", fail_at=fail_at,
                   ckpt_dir=tempfile.mkdtemp(), smoke=True, log_every=1000,
                   **kw)
    print(json.dumps({"result": name, **{k: out[k] for k in (
        "losses", "repairs", "recoveries")}}), flush=True)
"""


def _start_reference():
    """compress: bf16 weights; multilevel: f32 weights (its losses are
    the values' oracle)."""
    cases = {name: {**CASE, "comm": comm, "f32": name == "multilevel",
                    "fail_at": {str(s): p for s, p in
                                CASE["fail_at"].items()}}
             for name, comm in MODES.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=3",
               PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             json.dumps(cases)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _parse_reference(stdout: str) -> dict:
    out, case = {}, None
    for line in stdout.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if "case" in rec:
            case = rec["case"]
            out[case] = {"events": []}
        elif "result" in rec:
            out[rec.pop("result")].update(rec)
        elif rec.get("event") in ("failure", "repair"):
            out[case]["events"].append(
                {k: rec[k] for k in EVENT_KEYS if k in rec})
    return out


@functools.lru_cache(maxsize=None)
def _f32_params():
    cfg = jconfigs.get_config("gpt_100m", smoke=True)
    params = jax.jit(lambda k: JT.init_model(k, cfg))(jax.random.PRNGKey(0))
    return jax_to_numpy(jax.tree.map(lambda a: a.astype(jnp.float32),
                                     params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's two 3x1x1 runs in a subprocess; the port's
    meanwhile: 3x1x2 compress (bf16, digests, the carried EF rows), 3x1x2
    and 3x1x1 multilevel from the reference's f32 weights, and
    recurrentgemma on 2x1x2."""
    proc = _start_reference()
    try:
        ours, dirs = {}, {}
        for name, mesh, kw in (
                ("compress", "3x1x2", dict(comm=MODES["compress"],
                                           digests=True, ef_trees=True)),
                ("multilevel", "3x1x2", dict(comm=MODES["multilevel"],
                                             init_params=_f32_params())),
                ("multilevel_1", "3x1x1", dict(comm=MODES["multilevel"],
                                               init_params=_f32_params()))):
            dirs[name] = str(tmp_path_factory.mktemp(name))
            ours[name] = train("gpt-100m", mesh_spec=mesh, **{**CASE, **kw},
                               smoke=True, device="cpu", log_every=1000,
                               ckpt_dir=dirs[name])
        dirs["rg"] = str(tmp_path_factory.mktemp("rg"))
        ours["rg"] = train("recurrentgemma-2b", mesh_spec="2x1x2", **RG,
                           smoke=True, device="cpu", log_every=1000,
                           digests=True, ckpt_dir=dirs["rg"])
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    return _parse_reference(stdout), ours, dirs


@pytest.mark.parametrize("mode", list(MODES))
def test_decisions_on_a_model_axis_are_the_reference_ones(runs, mode):
    """An in-place repair (2 of 3 pods), then a restart below quorum from
    the step-2 checkpoint with accum 2: the reference's 3x1x1 events,
    counts and number of losses; the final grid is one pod of one model
    group of 2."""
    ref, ours, _ = runs
    want, got = ref[mode], ours[mode]
    assert got["events"] == want["events"]
    assert [e.get("in_place") for e in got["events"]] == [True, None, False]
    assert (got["repairs"], got["recoveries"]) == \
        (want["repairs"], want["recoveries"]) == (1, 1)
    assert len(got["losses"]) == len(want["losses"]) == 7
    assert np.isfinite(got["losses"]).all()
    assert (got["accum"], got["pods"], got["world"], got["model"]) == \
        (2, 1, 1, 2)
    assert got["step_tokens"] == [CASE["batch"] * CASE["seq"]] * 4 \
        + [2 * CASE["batch"] * CASE["seq"]] * 3
    assert len(got["launches"]) == len(got["tp_calls_ranks"]) == 2
    a, b = got["tp_calls_ranks"]
    assert a == b and len(a) == 7 and min(a[0].values()) > 0


def test_f32_losses_on_one_model_rank_match_reference(runs):
    """The port's 3x1x1 run from the reference's f32 weights, through
    the repair and the restart: the reference's decisions, its losses
    within 1e-4 relative."""
    ref, ours, _ = runs
    want, got = ref["multilevel"], ours["multilevel_1"]
    assert got["events"] == want["events"]
    assert len(got["losses"]) == len(want["losses"]) == 7
    for g, w in zip(got["losses"], want["losses"]):
        assert abs(g - w) <= LOSS_TOL * abs(w)


def test_f32_losses_on_a_model_axis_match_one_model_rank(runs):
    _, ours, _ = runs
    got, want = ours["multilevel"], ours["multilevel_1"]
    assert len(got["losses"]) == len(want["losses"]) == 7
    for g, w in zip(got["losses"], want["losses"]):
        assert abs(g - w) <= LOSS_TOL * abs(w)


def _ef_rows(path: str, step: int) -> set:
    """The leading dims of a checkpoint's EF leaves."""
    with open(f"{path}/step_{step:09d}/manifest.json") as f:
        leaves = json.load(f)["leaves"]
    return {m["shape"][0] for k, m in leaves.items() if k.startswith("opt_ef_")}


def test_restart_restores_its_save_bit_for_bit(runs):
    """Saves at step 2 (2 pods, after the repair) and step 4 (1 pod,
    after the restart), their EF leaves leading with those pods; the
    restart restores step 2 with the SHA-256 of its save."""
    _, ours, dirs = runs
    got = ours["compress"]
    assert [(s["step"], s["pods"]) for s in got["saves"]] == [(2, 2), (4, 1)]
    assert _ef_rows(dirs["compress"], 2) == {2}
    assert _ef_rows(dirs["compress"], 4) == {1}
    assert got["restored"] == [{"step": 2,
                                "digest": got["saves"][0]["digest"]}]


def test_carried_ef_rows_are_the_reference_fit_ef(runs):
    """The EF rows the survivors carry through the in-place repair,
    gathered on the 2-pod grid, are the reference's ``_fit_ef`` of the
    3-pod rows gathered just before it: pods 0 and 2 kept, bit for
    bit."""
    _, ours, _ = runs
    (carry,) = ours["compress"]["carried"]
    assert carry["step"] == 2 and carry["lost"] == [1]
    before = jax.tree.leaves(carry["before"])
    assert before and all(a.shape[0] == 3 for a in before)
    assert any(np.abs(a[[0, 2]]).max() > 0 for a in before)
    want = JTRAIN._fit_ef({"ef": carry["before"]}, [1], 2)["ef"]
    assert jax.tree.structure(carry["after"]) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(carry["after"]), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_run_dim_and_split_kv_leaves_restore_bit_for_bit(runs):
    """recurrentgemma on 2x1x2, pod 1 lost before step 3: below quorum, a
    restart from step 2's checkpoint (its ``w_out`` gathered along the
    run dim, ``wk``/``wv`` along their columns) restored bit for bit onto
    1x1x2 with accum 2, and finite losses."""
    _, ours, _ = runs
    got = ours["rg"]
    assert (got["recoveries"], got["repairs"], got["accum"]) == (1, 0, 2)
    assert (got["pods"], got["model"]) == (1, 2)
    assert [s["step"] for s in got["saves"]] == [2, 4]
    assert got["restored"] == [{"step": 2,
                                "digest": got["saves"][0]["digest"]}]
    assert len(got["losses"]) == RG["steps"] and all(
        map(math.isfinite, got["losses"]))
