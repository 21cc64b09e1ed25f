"""The port's elastic recovery and grid checkpoints against the JAX
package on the CPU.

* The copies, exactly: ``plan_recovery``, ``plan_expansion``,
  ``pod_member_ranks`` and ``has_quorum`` over a sweep of grids and
  failure sets, ``FailureInjector``'s consumption, ``HeartbeatTracker``
  with an injected clock, the train driver's ``_fit_ef`` and
  ``_fit_batch``; ``apply_error_feedback`` at ragged lengths, both paths,
  bit for bit with the reference's eager one.
* Grids over a subset of the ranks, on 4 spawned gloo ranks: the
  survivors' psum, psum_scatter and all_gather equal the sums, also after
  the lost ranks have left; a survivor's live state after an in-place
  repair gathers to the reference's ``_fit_ef`` of the global state.
* Grid checkpoints across packages: the reference's global checkpoint
  restores on each rank to its cut of the state (and gathers back whole);
  a 2x2x1 ZeRO-1 ``multilevel_compress`` checkpoint of the port restores
  through the reference's ``CheckpointManager`` to the state the port
  gathered, bit for bit; a stopped 2x2x1 run resumes at the same losses.
* The control plane against the reference's ``train()`` (a subprocess
  with 4 host devices and JSON logs, run once for the module beside the
  port's runs): ``repairs``, ``recoveries``, the number of losses and the
  ``failure`` and ``repair`` events field for field, on the reference's
  three elastic oracles, one rank, two failures in a row, and pod 0
  failing in place (where the reference raises after the repair: its
  setup estimate roots a plan at the lost rank 0; the port roots it at
  the first survivor).  The reference writes its checkpoints
  synchronously there: it asks for the newest one before it joins its
  writer, so an unfinished write would make its restart read an older one
  by chance.  In f32, from the reference's weights, the port's losses
  through a failure are within 1e-4 relative of the reference's.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_bridge import forked_ranks, jax_to_numpy, rank_opt
from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JaxCheckpoints
from repro.core import Communicator as JComm
from repro.core import compression as JC
from repro.core.topology import DCN, ICI, Topology as JTopology
from repro.launch import train as JTRAIN
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.runtime import fault_tolerance as JFT
from repro_torch.core import Communicator
from repro_torch.core import compression as C
from repro_torch.core.discovery import GENERIC_LEVELS
from repro_torch.launch import train as TRAIN
from repro_torch.launch.mesh import Grid, dp_topology, run_ranks
from repro_torch.launch.train import train
from repro_torch.runtime import fault_tolerance as FT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("pod", "data", "model")
SHAPES = [(4, 1, 1), (2, 2, 1), (1, 1, 1), (3, 2, 1), (2, 16, 16),
          (4, 16, 16), (1, 2)]
FAILED = [[], [0], [1], [2], [0, 1], [1, 1, 3], [5], [0, 1, 2, 3]]


def _axes(shape):
    return AXES if len(shape) == 3 else ("data", "model")


# ---------------------------------------------------------------- copies


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("failed", FAILED, ids=str)
def test_plan_recovery_and_members_match_reference(shape, failed):
    got = FT.plan_recovery(shape, _axes(shape), failed)
    want = JFT.plan_recovery(shape, _axes(shape), failed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.changed == want.changed
    assert FT.pod_member_ranks(shape, _axes(shape), failed) == \
        JFT.pod_member_ranks(shape, _axes(shape), failed)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("available", [0, 1, 2, 5])
def test_plan_expansion_matches_reference(shape, available):
    got = FT.plan_expansion(shape, _axes(shape), available)
    want = JFT.plan_expansion(shape, _axes(shape), available)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.changed == want.changed


@pytest.mark.parametrize("pods,data", [(4, 1), (2, 2), (3, 2), (1, 4)])
def test_has_quorum_matches_reference(pods, data):
    """The rule on its own over every failure count and three quorums,
    and on the planning communicators of the grid for every pod lost."""
    total = pods * data
    for n in range(total + 1):
        for q in (0.25, 0.5, 0.75):
            assert FT.has_quorum(total, n, q) == JFT.has_quorum(total, n, q)
    ours = Communicator(dp_topology(Grid.shape_only(pods, data),
                                    [GENERIC_LEVELS[0], GENERIC_LEVELS[-1]]),
                        policy="paper", backend="sim")
    ref = JComm(JTopology((np.arange(total) // data)[:, None], [DCN, ICI]),
                policy="paper", backend="sim")
    for p in range(pods + 1):
        dead = list(range(p * data))
        assert ours.has_quorum(dead) == ref.has_quorum(dead)


def test_failure_injector_consumes_like_reference():
    schedule = {2: [1], 5: [0, 2], 7: []}
    ours, ref = FT.FailureInjector(schedule), JFT.FailureInjector(schedule)
    for step in (0, 2, 2, 5, 7, 5, 9, 2):
        assert ours.failed_pods_at(step) == ref.failed_pods_at(step)
    assert ours.schedule == ref.schedule == {}
    assert schedule == {2: [1], 5: [0, 2], 7: []}


def test_heartbeat_tracker_matches_reference():
    clock = [0.0]
    hosts = ["h0", "h1", "h2"]
    ours = FT.HeartbeatTracker(hosts, timeout_s=10, clock=lambda: clock[0])
    ref = JFT.HeartbeatTracker(hosts, timeout_s=10, clock=lambda: clock[0])
    for t, ping in [(5.0, "h0"), (9.0, "h2"), (12.0, None), (15.5, "h2"),
                    (19.0, None), (26.0, None), (40.0, "h1")]:
        clock[0] = t
        if ping:
            ours.ping(ping)
            ref.ping(ping)
        assert ours.dead_hosts() == ref.dead_hosts()
    assert FT.__all__ == JFT.__all__


def _ef_tree(rows, seed=0):
    rng = np.random.default_rng(seed)
    return {"ef": {"a": rng.standard_normal((rows, 3, 4)).astype(np.float32),
                   "b": [rng.standard_normal((rows, 5)).astype(np.float32)]},
            "m": {"a": np.ones((3, 4), np.float32)}}


@pytest.mark.parametrize("rows,lost,new_pods", [
    (4, [1], 3), (4, [0, 3], 2), (2, [1], 1), (2, [0, 1], 1), (3, [], 3),
    (3, [2], 1), (1, [0], 1)])
def test_fit_ef_matches_reference(rows, lost, new_pods):
    tree = _ef_tree(rows)
    got = TRAIN._fit_ef(tree, lost, new_pods)
    want = JTRAIN._fit_ef(tree, lost, new_pods)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert TRAIN._fit_ef({"m": 1}, lost, new_pods) == {"m": 1}


@pytest.mark.parametrize("rows,dp", [(8, 3), (8, 4), (4, 3), (2, 3), (1, 4),
                                     (5, 5), (3, 8)])
def test_fit_batch_matches_reference(rows, dp):
    arr = np.arange(rows * 3, dtype=np.int32).reshape(rows, 3)
    got, want = TRAIN._fit_batch(arr, dp), JTRAIN._fit_batch(arr, dp)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _x(n, seed):
    return (3.0 * np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, C.QTILE,
                               C.QTILE + 3, 3 * C.QTILE - 100])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_error_feedback_bit_exact_with_eager_reference(n, use_kernel):
    """The plain path and the kernel path (its plain versions on the CPU,
    padded to QTILE) against the reference's eager plain path."""
    g, ef = _x(n, 0), 0.05 * _x(n, 1)
    got, new = C.apply_error_feedback(torch.from_numpy(g),
                                      torch.from_numpy(ef),
                                      use_kernel=use_kernel)
    want, jnew = JC.apply_error_feedback(jnp.asarray(g), jnp.asarray(ef),
                                         use_kernel=False)
    assert new.shape == (n,) and new.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(want).view(np.uint32))
    assert np.array_equal(new.numpy().view(np.uint32),
                          np.asarray(jnew).view(np.uint32))


# ------------------------------------------------- grids and checkpoints


def _cfg():
    return jconfigs.get_config("gpt_100m", smoke=True)


@functools.lru_cache(maxsize=None)
def _jparams():
    return jax.jit(lambda k: JT.init_model(k, _cfg()))(jax.random.PRNGKey(0))


def _opt_global(n_slow, seed):
    """The reference's compressed ZeRO-1 state with n_slow EF rows, filled
    with distinct values."""
    opt = jax_to_numpy(jadamw.init_opt_state(
        _jparams(), jadamw.OptConfig(comm_mode="multilevel_compress"),
        n_slow=n_slow))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + rng.integers(
        1, 9, a.shape).astype(a.dtype), opt)


# (pods, data, lost): a pod of 2 either way, pod 1 of 4, every pod of 4.
# In this order each grid's members made the same number of groups before
# it, as ``make_grid(members=)`` needs: in training a rank that is not a
# member leaves for good
CASES = [(2, 2, [1]), (2, 2, [0]), (4, 1, [1]), (4, 1, [0, 1, 2, 3])]
XS = np.random.default_rng(7).standard_normal((4, 12)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _grid_state(tmp):
    JaxCheckpoints(tmp, async_write=False).save(
        5, {"params": _jparams(), "opt": _opt_global(2, 11)})
    cases = [(p, d, lost, _opt_global(p, 20 + i))
             for i, (p, d, lost) in enumerate(CASES)]
    return run_ranks(ranks.grid_state, 4, "gloo", (
        jax_to_numpy(_jparams()), tmp, cases, XS), timeout=300.0)


@pytest.fixture(scope="module")
def grid_state(tmp_path_factory):
    return _grid_state(str(tmp_path_factory.mktemp("grid_state")))


def _survivors(pods, data, lost):
    keep = [q for q in range(pods) if q not in lost] or [0]
    return keep, [q * data + d for q in keep for d in range(data)]


def _same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.array_equal(x, y)


def _check_sums(res, members, data):
    """A survivor's collectives against the sums in one process."""
    me = res["rank"]
    pod, d = divmod(int(me), data)
    xs = XS[members]
    assert res["world"] == len(members)
    np.testing.assert_allclose(res["dp_psum"], xs.sum(0), rtol=1e-6)
    n = XS.shape[1] // len(members)
    np.testing.assert_allclose(res["dp_scatter"],
                               xs.sum(0)[me * n:(me + 1) * n], rtol=1e-6)
    assert np.array_equal(res["dp_gather"], xs.reshape(-1))
    same_pod = [i for i in range(len(members)) if i // data == pod]
    same_d = [i for i in range(len(members)) if i % data == d]
    np.testing.assert_allclose(res["fast_psum"], xs[same_pod].sum(0),
                               rtol=1e-6)
    np.testing.assert_allclose(res["slow_psum"], xs[same_d].sum(0),
                               rtol=1e-6)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_subset_grid_collectives_equal_the_sums(grid_state, case):
    pods, data, lost = CASES[case]
    _, members = _survivors(pods, data, lost)
    for rank, res in enumerate(grid_state):
        if rank not in members:
            assert res[case] is None
            continue
        assert res[case]["rank"] == members.index(rank)
        _check_sums(res[case], members, data)


def test_survivors_go_on_after_the_lost_ranks_left(grid_state):
    """4x1: pod 1's rank returns, the 3 survivors make their groups
    without it; then pod 0 of those leaves and the last 2 go on."""
    steps = [[0, 2, 3], [2, 3]]
    for rank, res in enumerate(grid_state):
        seen = [m for m in steps if rank in m]
        assert len(res["leave"]) == len(seen)
        for members, got in zip(seen, res["leave"]):
            _check_sums(got, members, 1)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_live_state_after_repair_is_the_reference_fit_ef(grid_state, case):
    """Each survivor keeps its shards and EF row; gathered on the
    survivors' grid they are the reference's ``_fit_ef`` of the global
    state (zeros where every pod was lost)."""
    pods, data, lost = CASES[case]
    keep, members = _survivors(pods, data, lost)
    want = JTRAIN._fit_ef(_opt_global(pods, 20 + case), lost, len(keep))
    for rank in members:
        _same_tree(grid_state[rank][case]["state"], want)


def test_reference_checkpoint_restores_to_each_ranks_shard(grid_state):
    """The reference's global checkpoint (EF rows of 2 pods) restored on
    each rank of 2x2 is the reference's own cut of the state for that
    rank, and gathers back to the whole state."""
    g = _opt_global(2, 11)
    cut = rank_opt(jax.tree.map(jnp.asarray, g), _jparams(),
                   jadamw.OptConfig(comm_mode="multilevel_compress"), 2, 2)
    for rank, res in enumerate(grid_state):
        pod, d = divmod(rank, 2)
        _same_tree(res["restored"],
                   jax.tree.map(lambda a: np.asarray(a[pod, d]), cut))
        _same_tree(res["gathered"], g)


@functools.lru_cache(maxsize=None)
def _port_resume(tmp):
    run = functools.partial(train, "gpt-100m", 4, mesh_spec="2x2x1", seq=32,
                            batch=4, comm="multilevel_compress", smoke=True,
                            device="cpu", ckpt_every=2, ckpt_dir=tmp,
                            digests=True)
    return run(), run()


@pytest.fixture(scope="module")
def port_resume(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("resume"))
    return tmp, _port_resume(tmp)


def test_grid_checkpoint_restores_through_the_reference(port_resume):
    """The port's 2x2x1 checkpoint of step 2, read by the reference's
    manager into its own global tree, is the state the port's ranks
    gathered at the save, bit for bit (equal SHA-256)."""
    tmp, (first, _) = port_resume
    assert [(s["step"], s["pods"]) for s in first["saves"]] == [(2, 2)]
    like = {"params": _jparams(), "opt": jadamw.init_opt_state(
        _jparams(), jadamw.OptConfig(comm_mode="multilevel_compress"),
        n_slow=2)}
    got = jax_to_numpy(JaxCheckpoints(tmp).restore(2, like))
    assert TRAIN._digest(got) == first["saves"][0]["digest"]
    assert first["saves"][0]["bytes"] == sum(
        a.nbytes for a in jax.tree.leaves(got))


def test_stopped_grid_run_resumes_at_the_same_losses(port_resume):
    _, (first, again) = port_resume
    assert first["start_step"] == 0 and len(first["losses"]) == 4
    assert again["start_step"] == 3 and again["world"] == 4
    assert again["losses"] == first["losses"][3:]


# --------------------------------------------- the control plane vs train


COMMON = dict(seq=32, batch=4, zero1=True)
PLANE = {
    # tests/test_elastic.py:402 and :420
    "in_place": dict(steps=6, mesh_spec="4x1x1", comm="multilevel",
                     ckpt_every=3, fail_at={2: [1]}),
    "in_place_ef": dict(steps=6, mesh_spec="4x1x1",
                        comm="multilevel_compress", ckpt_every=3,
                        fail_at={2: [1]}),
    # tests/test_substrate.py:150
    "restart": dict(steps=10, mesh_spec="2x2x1", comm="multilevel",
                    ckpt_every=4, fail_at={7: [1]}),
    "one_rank": dict(steps=6, mesh_spec="1x1x1", comm="multilevel",
                     ckpt_every=2, fail_at={4: [0]}),
    "two_failures": dict(steps=5, mesh_spec="4x1x1",
                         comm="multilevel_compress", ckpt_every=2,
                         fail_at={1: [1], 3: [2]}),
    "pod0_in_place": dict(steps=4, mesh_spec="4x1x1", comm="multilevel",
                          ckpt_every=2, fail_at={1: [0]}),
}
F32 = dict(steps=5, mesh_spec="4x1x1", comm="multilevel_compress",
           ckpt_every=0, fail_at={2: [1]}, f32=True)
EVENT_KEYS = ("event", "step", "failed", "accum", "in_place", "repaired",
              "evicted", "kept", "survivors")

REF_SCRIPT = r"""
import json, sys, tempfile
import jax, jax.numpy as jnp
import repro.launch.train as RT
from repro.checkpoint.manager import CheckpointManager
from repro.obs import set_json

set_json(True)
# the reference asks for the newest checkpoint before it joins the writer,
# so a write still running is missed; the port joins it first: written
# synchronously here, the reference reads what the port reads
RT.CheckpointManager = lambda d, keep: CheckpointManager(
    d, keep=keep, async_write=False)
init = RT.T.init_model
for name, kw in json.loads(sys.argv[1]).items():
    fail_at = {int(k): v for k, v in kw.pop("fail_at").items()}
    RT.T.init_model = (lambda key, cfg: jax.tree.map(
        lambda a: a.astype(jnp.float32), init(key, cfg))) \
        if kw.pop("f32", False) else init
    print(json.dumps({"case": name}), flush=True)
    try:
        out = RT.train("gpt-100m", ckpt_dir=tempfile.mkdtemp(),
                       fail_at=fail_at, smoke=True, log_every=1000, **kw)
        res = {k: out[k] for k in ("losses", "repairs", "recoveries")}
    except ValueError as e:
        res = {"raised": str(e)}
    print(json.dumps({"result": name, **res}), flush=True)
"""


def _start_reference(cache_dir):
    """The reference's runs of every case in one subprocess; its compiled
    programs go to ``cache_dir``, new for the run, so that a case whose
    programs an earlier case compiled loads them (on jax 0.4.x the cache
    stays off, as ``conftest.run_with_devices`` keeps it)."""
    cases = {**PLANE, "f32": F32}
    cases = {k: {**COMMON, **v, "fail_at": {str(s): p for s, p in
                                            v["fail_at"].items()}}
             for k, v in cases.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    if hasattr(jax, "shard_map"):
        env.update(JAX_COMPILATION_CACHE_DIR=cache_dir,
                   JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
                   JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
    return subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             json.dumps(cases)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _parse_reference(stdout: str) -> dict:
    """Per case: the reference's result and its failure and repair
    events, from its JSON log lines."""
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


def _f32_params():
    return jax_to_numpy(jax.tree.map(lambda a: a.astype(jnp.float32),
                                     _jparams()))


@pytest.fixture(scope="module")
def control_plane(tmp_path_factory):
    """The reference's runs in a subprocess, the port's meanwhile."""
    proc = _start_reference(str(tmp_path_factory.mktemp("jax_cache")))
    try:
        ours = {}
        for name, kw in PLANE.items():
            ours[name] = train(
                "gpt-100m", **COMMON, **kw, smoke=True, device="cpu",
                log_every=1000,
                ckpt_dir=str(tmp_path_factory.mktemp(name)))
        kw = {k: v for k, v in F32.items() if k != "f32"}
        ours["f32"] = train("gpt-100m", **COMMON, **kw, smoke=True,
                            device="cpu", log_every=1000,
                            init_params=_f32_params())
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    return _parse_reference(stdout), ours


@pytest.mark.parametrize("case", list(PLANE))
def test_control_plane_decides_as_the_reference(control_plane, case):
    ref, ours = control_plane
    want, got = ref[case], ours[case]
    assert got["events"] == want["events"]
    assert len(got["events"]) >= 1
    if case == "pod0_in_place":
        # the reference raises after the repair; the port goes on
        assert want["raised"] == "root 0 is not a member"
        assert got["repairs"] == 1 and got["recoveries"] == 0
        assert len(got["losses"]) == PLANE[case]["steps"]
        return
    assert (got["repairs"], got["recoveries"]) == \
        (want["repairs"], want["recoveries"])
    assert len(got["losses"]) == len(want["losses"])
    assert np.isfinite(got["losses"]).all()


def test_f32_losses_through_a_failure_match_reference(control_plane):
    """4x1x1 ``multilevel_compress``, pod 1 lost before step 2, from the
    reference's weights in f32: within 1e-4 relative, step by step (the
    tolerance of ``test_grid_trajectory_matches_reference``)."""
    ref, ours = control_plane
    want, got = ref["f32"], ours["f32"]
    assert (got["repairs"], want["repairs"]) == (1, 1)
    assert len(got["losses"]) == len(want["losses"]) == F32["steps"]
    for g, w in zip(got["losses"], want["losses"]):
        assert abs(g - w) <= 1e-4 * abs(w)
