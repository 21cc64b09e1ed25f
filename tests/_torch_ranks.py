"""Rank bodies for the port's multi-rank tests.

``repro_torch.launch.mesh.run_ranks`` spawns the ranks and pickles the
function by its module path, so the bodies live here, in a module that
imports neither JAX nor pytest: each spawned rank imports only torch and
the port.  Every body takes the inputs of all ranks as numpy arrays,
picks its own by rank (rank = pod * data + d), and returns numpy.
"""
import numpy as np
import torch

from repro_torch.core import Communicator
from repro_torch.core import collectives as C
from repro_torch.core import compression
from repro_torch.core.topology import Level, Topology
from repro_torch.launch.mesh import grid_communicator, make_grid
from repro_torch.launch.step import make_train_step
from repro_torch.models.convert import from_numpy, to_numpy
from repro_torch.optim import adamw
from repro_torch.tree import tree_map

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def collectives(rank, pods, data, x, ef, tree):
    """Each collective of ``core.collectives`` on this rank's inputs:
    ``x`` (pods, data, N), ``ef`` (pods, data, N / data), ``tree`` a dict
    of (pods, data, ...) leaves."""
    grid = make_grid(pods, data, CPU)
    pod, d = divmod(rank, data)
    xr, er = _t(x[pod, d]), _t(ef[pod, d])
    tr = {k: _t(v[pod, d]) for k, v in tree.items()}
    slow_bytes = lambda: grid.slow.wire_bytes if grid.slow else 0
    out = {"flat": C.flat_psum(xr, grid.dp)}
    w0 = slow_bytes()
    out["multilevel"] = C.multilevel_psum(xr, grid.slow, grid.fast)
    out["slow_bytes_multilevel"] = np.array(slow_bytes() - w0)
    if grid.slow is not None:
        w0 = slow_bytes()
        out["compressed"] = C.multilevel_psum(xr, grid.slow, grid.fast, True)
        out["slow_bytes_compressed"] = np.array(slow_bytes() - w0)
        out["compressed_ef"], out["compressed_ef_new"] = C.multilevel_psum(
            xr, grid.slow, grid.fast, True, er)
        # the kernel path's padding (QTILE) through the plain versions on
        # the CPU: the same values, more wire bytes
        out["kernel_path_ef"], out["kernel_path_ef_new"] = \
            compression.compressed_psum(
                grid.fast.psum_scatter(xr), grid.slow, ef=er,
                use_kernel=True)
    for mode in ("flat", "multilevel", "multilevel_compress"):
        res = C.multilevel_psum_tree(tr, grid, mode=mode, mean_over=4)
        out.update({f"tree_{mode}_{k}": v for k, v in res.items()})
    ef0 = C.compress_ef_zeros(tr, data, tile=compression.QTILE)
    out["ef_zeros_size"] = np.array(ef0.numel())
    res, new_ef = C.multilevel_psum_tree(tr, grid, mode="multilevel_compress",
                                         ef=ef0 + 0.01)
    out.update({f"tree_ef_{k}": v for k, v in res.items()})
    out["tree_ef_new"] = new_ef
    for mode in ("flat", "multilevel"):
        res = C.bucketed_psum_tree(tr, grid, bucket_bytes=300.0, mode=mode,
                                   mean_over=2)
        out.update({f"bucketed_{mode}_{k}": v for k, v in res.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def updates(rank, pods, data, cases, params, opt, grads):
    """``apply_updates`` for each case, a dict of ``OptConfig`` fields and
    a gradient scale: three steps from the global state ``opt[case]`` with
    this rank's gradients ``scale * grads[step]`` (leaves (pods, data,
    ...)); returns the params and this rank's opt shard after the last
    step, per case."""
    grid = make_grid(pods, data, CPU)
    pod, d = divmod(rank, data)
    out = []
    for i, (kw, scale) in enumerate(cases):
        cfg = adamw.OptConfig(**kw)
        p = from_numpy(params, device=CPU)
        o = adamw.shard_opt_state(from_numpy(opt[i], device=CPU), p, cfg,
                                  grid)
        for g in grads:
            mine = from_numpy(tree_map(lambda a: np.float32(scale)
                                       * a[pod, d], g), device=CPU)
            p, o = adamw.apply_updates(p, mine, o, cfg, grid)
        out.append(to_numpy({"params": p, "opt": o}))
    return out


def trajectory(rank, pods, data, cfg, modes, params, batches):
    """The train step of ``cfg`` for each comm mode: three steps from
    ``params`` (the reference's stacked layout, numpy) on the global host
    batches; returns the losses per mode."""
    grid = make_grid(pods, data, CPU)
    out = {}
    for mode in modes:
        opt_cfg = adamw.OptConfig(comm_mode=mode, lr=1e-3, warmup_steps=20,
                                  total_steps=len(batches))
        p = from_numpy(params, device=CPU)
        o = adamw.shard_opt_state(
            adamw.init_opt_state(p, opt_cfg, n_slow=pods), p, opt_cfg, grid)
        step = make_train_step(cfg, opt_cfg, grid, device=CPU)
        losses = []
        for b in batches:
            p, o, loss = step(p, o, b)
            losses.append(loss.item())
        out[mode] = losses
    return out


def _tree_ops(run, comm, roots, x, g, sc):
    """The seven collectives of ``comm`` on this rank's inputs, recorded by
    ``run(name, comm, thunk)``."""
    for root in roots:
        run(f"bcast_{root}", comm, lambda: comm.bcast(x, root=root))
        run(f"reduce_{root}", comm, lambda: comm.reduce(x, root=root))
        run(f"gather_{root}", comm, lambda: comm.gather(g, root=root))
        run(f"scatter_{root}", comm, lambda: comm.scatter(sc, root=root))
    run("allreduce", comm, lambda: comm.allreduce(x))
    run("allgather", comm, lambda: comm.allgather(g))
    run("barrier", comm, lambda: comm.barrier())


def tree_p2p(rank, coords, levels, roots, xs, gs, sc):
    """The seven collectives by tree on the ``"p2p"`` backend over the
    default group, with the ``sag`` broadcast and the ``rsag`` all-reduce
    besides; returns this rank's outputs, the bytes it sent on each link
    class per case, and the bytes it staged."""
    topo = Topology(coords, [Level(*l) for l in levels])
    comms = {a: Communicator(topo, policy="paper", backend="p2p",
                             algorithm=a) for a in (None, "sag", "rsag")}
    x, g = _t(xs[rank]), _t(gs[rank])
    out, links = {}, {}

    def run(name, comm, thunk):
        before = dict(comm.backend.peers.link_bytes)
        out[name] = thunk()
        links[name] = {k: v - before[k]
                       for k, v in comm.backend.peers.link_bytes.items()}

    _tree_ops(run, comms[None], roots, x, g, _t(sc))
    run("bcast_sag_3", comms["sag"], lambda: comms["sag"].bcast(x, root=3))
    run("allreduce_rsag", comms["rsag"],
        lambda: comms["rsag"].allreduce(x))
    again = comms[None].bcast(x, root=3)
    return {"out": {k: np.asarray(v) for k, v in out.items()},
            "links": links,
            "repeat_equal": bool(torch.equal(again, out["bcast_3"])),
            "cache": tuple(comms[None].cache_info()),
            "staged": sum(c.backend.peers.staged_bytes
                          for c in comms.values())}


def tree_torch(rank, pods, data, levels, roots, xs, gs, sc, tree):
    """The seven collectives on the ``"torch"`` backend of a ``pods x
    data`` grid, the ``rsag`` all-reduce, and ``allreduce_tree`` beside
    the direct ``multilevel_psum_tree`` / ``bucketed_psum_tree`` calls it
    stands for; returns this rank's outputs."""
    grid = make_grid(pods, data, CPU)
    lv = [Level(*l) for l in levels]
    comm = grid_communicator(grid, lv)
    rsag = grid_communicator(grid, lv, algorithm="rsag")
    x, g = _t(xs[rank]), _t(gs[rank])
    out = {}

    def run(name, comm, thunk):
        out[name] = thunk()

    _tree_ops(run, comm, roots, x, g, _t(sc))
    out["allreduce_rsag"] = rsag.allreduce(x)
    tr = {k: _t(v[rank]) for k, v in tree.items()}
    ef = C.compress_ef_zeros(tr, grid.fast.size, tile=compression.QTILE)
    cases = {"multilevel": dict(mode="multilevel", mean_over=8),
             "compress": dict(mode="multilevel_compress"),
             "compress_ef": dict(mode="multilevel_compress", ef=ef + 0.01)}
    for name, kw in cases.items():
        got, want = (comm.allreduce_tree(tr, **kw),
                     C.multilevel_psum_tree(tr, grid, **kw))
        if "ef" in kw:
            (got, out[f"tree_{name}_ef"]), (want, out[f"direct_{name}_ef"]) \
                = got, want
        out.update({f"tree_{name}_{k}": v for k, v in got.items()})
        out.update({f"direct_{name}_{k}": v for k, v in want.items()})
    got = comm.allreduce_tree(tr, bucket_bytes=300.0)
    want = C.bucketed_psum_tree(tr, grid, bucket_bytes=300.0)
    out.update({f"tree_bucketed_{k}": v for k, v in got.items()})
    out.update({f"direct_bucketed_{k}": v for k, v in want.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def discovery(rank, tmp, envs, xs):
    """Discovery on this rank: the environment's topology (as spawned, and
    under torchrun-style variables ``envs[rank]``), the timed probes, the
    topology ``discover("device", path=)`` fits and persists, a second
    ``discover`` that must load it without probing, and the ``"p2p"``
    bcast of ``xs[rank]`` from rank 3 on the probes' topology."""
    import os

    from repro_torch.core import discovery as D

    out = {"env_spawned": D.environment_topology().to_json()}
    os.environ.update(envs[rank])
    out["env"] = D.discover("env").to_json()
    probes = D.device_probes(device="cpu")
    out["times"] = probes.times
    out["sizes"] = probes.sizes
    path = f"{tmp}/rank{rank}.json"
    out["topo"] = D.discover("device", path=path, device="cpu").to_json()
    probe = D.device_probes

    def no_probing(**kw):
        raise AssertionError("discover probed although its file exists")

    D.device_probes = no_probing
    try:
        out["again"] = D.discover("device", path=path).to_json()
    finally:
        D.device_probes = probe
    comm = Communicator.from_probes(probes, backend="p2p", policy="auto")
    out["probes_topo"] = comm.topo.to_json()
    out["bcast"] = comm.bcast(_t(xs[rank]), root=3).numpy()
    return out


def _axis_sums(grid, x):
    """The grid's collectives on ``x``: psum, psum_scatter and all_gather
    over dp, psum over the fast and slow axes."""
    out = {"rank": grid.rank, "world": grid.world,
           "dp_psum": grid.dp.psum(x), "dp_scatter": grid.dp.psum_scatter(x),
           "dp_gather": grid.dp.all_gather(x),
           "fast_psum": grid.fast.psum(x),
           "slow_psum": x if grid.slow is None else grid.slow.psum(x)}
    return {k: np.asarray(v) for k, v in out.items()}


def grid_state(rank, params, ckpt_dir, cases, xs):
    """The optimiser state of a grid across checkpoints and failures.

    First, on 2x2: the reference's checkpoint of step 5 in ``ckpt_dir``
    restored on this rank (``train._restore``, EF rows of 2 pods), and
    its shards gathered back (``gather_opt_state``).  Then for each case
    ``(pods, data, lost, opt)``: this rank's shard of the global ``opt``
    on a grid over all ranks, pods ``lost`` failing; a survivor keeps its
    live shard (``train._fit_ef_rows``) on the survivors' grid
    (``make_grid(members=)``), runs the grid's collectives on ``xs[rank]``
    and gathers the state.  Last, two failures in a row on 4x1 where the
    lost ranks really leave (return) before the survivors make their
    groups: pod 1, then pod 0 of the three left."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as TR

    cfg = adamw.OptConfig(comm_mode="multilevel_compress")
    p = from_numpy(params, device=CPU)
    x = _t(xs[rank])
    out = {}
    grid = make_grid(2, 2, CPU)
    _, opt, _ = TR._restore(CheckpointManager(ckpt_dir), 5, p, cfg, grid,
                            2, (), CPU)
    out["restored"] = to_numpy(opt)
    out["gathered"] = to_numpy(adamw.gather_opt_state(opt, p, cfg, grid))
    for i, (pods, data, lost, opt_global) in enumerate(cases):
        grid = make_grid(pods, data, CPU)
        opt = adamw.shard_opt_state(from_numpy(opt_global, device=CPU), p,
                                    cfg, grid)
        keep = [q for q in range(pods) if q not in lost] or [0]
        members = [q * data + d for q in keep for d in range(data)]
        if rank not in members:
            out[i] = None
            continue
        sub = make_grid(len(keep), data, CPU, members=members)
        opt = TR._fit_ef_rows(opt, pods, lost, len(keep))
        res = _axis_sums(sub, x)
        res["state"] = to_numpy(adamw.gather_opt_state(opt, p, cfg, sub))
        sub.barrier()
        out[i] = res
    make_grid(4, 1, CPU)
    members = list(range(4))
    out["leave"] = []
    for lost in (1, 0):          # pod 1 of 4, then pod 0 of the 3 left
        members = [m for i, m in enumerate(members) if i != lost]
        if rank not in members:
            return out
        grid = make_grid(len(members), 1, CPU, members=members)
        out["leave"].append(_axis_sums(grid, x))
        grid.barrier()
    return out
