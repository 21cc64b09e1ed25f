"""Rank bodies for the port's multi-rank tests.

``repro_torch.launch.mesh.run_ranks`` spawns the ranks and pickles the
function by its module path, so the bodies live here, in a module that
imports neither JAX nor pytest: each spawned rank imports only torch and
the port.  Every body takes the inputs of all ranks as numpy arrays,
picks its own by rank (rank = pod * data + d, or (pod * data + d) *
model + m on a model axis), and returns numpy.
"""
import numpy as np
import torch

from repro_torch.core import Communicator
from repro_torch.core import collectives as C
from repro_torch.core import compression
from repro_torch.core.topology import Level, Topology
from repro_torch.launch import mesh
from repro_torch.launch.mesh import grid_communicator, make_grid
from repro_torch.launch.step import (device_batch, loss_and_grads,
                                    make_train_step)
from repro_torch.models.convert import (from_numpy, model_dims,
                                        shard_params, stack_runs, to_numpy,
                                        unstack_runs)
from repro_torch.models.sharding import cut_shard, layer_model_dims
from repro_torch.optim import adamw
from repro_torch.tree import tree_map

CPU = torch.device("cpu")
# what the ranks' fork server imports once: the rank bodies below and the
# port, torch._dynamo (a rank plans its sync under a fake-tensor mode) and
# the train and serve entry points, which spawn ranks themselves
PRELOAD = ("numpy", "torch._dynamo", "_torch_ranks",
           "repro_torch.launch.train", "repro_torch.launch.serve")


def fork_ranks() -> None:
    """Fork the ranks of every later ``mesh.run_ranks`` of this process
    (``train`` and ``serve`` on a grid included) from one server that
    imported ``PRELOAD`` once, instead of spawning an interpreter a rank
    that imports them all again (seconds a rank).  ``_torch_bridge``'s
    fixture ``forked_ranks`` calls it for each test module that starts
    ranks; the choice holds for the rest of the process."""
    mesh.preload_ranks(*PRELOAD)


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


def updates(rank, pods, data, cases, params, opt, grads, model=1,
            mdims=None):
    """``apply_updates`` for each case, a dict of ``OptConfig`` fields and
    a gradient scale: three steps from the global state ``opt[case]`` with
    this rank's gradients ``scale * grads[step]`` (leaves (pods, data,
    ...), or (pods, data, model, ...) of the model shards); returns the
    params and this rank's opt shard after the last step, per case.  On a
    model axis (``model`` > 1) the params and state are cut to this
    rank's model shard first, along ``mdims``."""
    grid = make_grid(pods, data, CPU, model=model)
    cell, m = divmod(rank, model)
    pod, d = divmod(cell, data)
    mine = (lambda a: a[pod, d]) if model == 1 else (lambda a: a[pod, d, m])
    if mdims is None:
        mdims = tree_map(lambda _: -1, params)

    def mcut(tree, lead=0):
        return tree_map(lambda t, md: cut_shard(
            t, md + lead if md >= 0 else -1, model, m), tree, mdims)
    out = []
    for i, (kw, scale) in enumerate(cases):
        cfg = adamw.OptConfig(**kw)
        p = mcut(from_numpy(params, device=CPU))
        o = from_numpy(opt[i], device=CPU)
        o = dict(o, **{k: mcut(o[k]) for k in ("m", "v", "master")})
        if "ef" in o:
            o["ef"] = mcut(o["ef"], 1)
        o = adamw.shard_opt_state(o, p, cfg, grid, mdims)
        for g in grads:
            gr = from_numpy(tree_map(lambda a: np.float32(scale) * mine(a),
                                     g), device=CPU)
            p, o = adamw.apply_updates(p, gr, o, cfg, grid, mdims)
        out.append(to_numpy({"params": p, "opt": o}))
    return out


def _trajectory(grid, cfg, modes, params, batches, opt_kw=None):
    """The losses of the train step on ``grid`` for each comm mode (ZeRO-1
    where the mode is not flat), from ``params`` (the global stacked layout,
    numpy, cut to this rank's model shard) on the global host batches."""
    tp = grid.tp
    out = {}
    for mode in modes:
        opt_cfg = adamw.OptConfig(**{
            "comm_mode": mode, "lr": 1e-3,
            "warmup_steps": 20, "total_steps": len(batches),
            **(opt_kw or {})})
        p = from_numpy(params, device=CPU)
        if tp is not None:
            p = shard_params(p, cfg, tp.size, tp.index)
        step = make_train_step(cfg, opt_cfg, grid, device=CPU)
        mdims = None if tp is None else model_dims(cfg, tp.size)
        o = adamw.shard_opt_state(adamw.init_opt_state(
            p, opt_cfg, n_slow=grid.pods), p, opt_cfg, grid, mdims)
        losses = []
        for b in batches:
            p, o, loss = step(p, o, b)
            losses.append(loss.item())
        out[mode] = losses
    return out


def trajectory(rank, pods, data, cfg, modes, params, batches):
    """The train step of ``cfg`` for each comm mode: three steps from
    ``params`` (the reference's stacked layout, numpy) on the global host
    batches; returns the losses per mode."""
    return _trajectory(make_grid(pods, data, CPU), cfg, modes, params,
                       batches)


def family_trajectories(rank, pods, data, cases, modes):
    """``trajectory`` for each (cfg, params, batches) of ``cases`` on one
    grid: {config name: {mode: losses}}."""
    grid = make_grid(pods, data, CPU)
    return {cfg.name: _trajectory(grid, cfg, modes, params, batches)
            for cfg, params, batches in cases}


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


# ---------------------------------------------------------------------- #
# A model axis: tensor parallelism, the sequence-parallel decode, EP
# ---------------------------------------------------------------------- #

def _from_full(t, like, tp, first=None, at=3):
    """This rank's part of an unsharded cache or pool leaf ``t`` (numpy)
    in the layout of ``like``: cut along the one dim where they differ
    (the sequence where ``like`` holds every KV head, else the KV heads,
    from ``first`` where given: the first KV head that the rank's query
    heads read, or with ``at`` 2 the first RWKV-6 head that its columns
    meet; the RG-LRU's channels), or whole (RWKV-6's carried rows), as
    chip_smoke.py's ``tp_cut``."""
    t = torch.from_numpy(np.array(t)).to(like.dtype)
    dims = [d for d in range(t.dim()) if t.shape[d] != like.shape[d]]
    if not dims:
        return t
    n = like.shape[dims[0]]
    start = tp.index * n if first is None or dims[0] != at else first
    return t.narrow(dims[0], start, n).contiguous()


def _cut_state(ins, key, i, state, cfg, tp):
    """This rank's part of ``ins[key][i]``, the unsharded run's cache or
    pools before step ``i``, in the layout of ``state``."""
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import rwkv_heads

    first = L.heads(cfg, tp).kv0
    h0 = rwkv_heads(cfg, tp.size, tp.index).h0
    cut = lambda k, v, t: _from_full(t, v, tp, h0, 2) if k == "S" else \
        _from_full(t, v, tp, first if k in ("k", "v", "xk", "xv") else None)
    return [{k: cut(k, v, ins[key][i][r][k]) for k, v in ent.items()}
            for r, ent in enumerate(state)]


def model_paths(params, cfg, ins, tp=None):
    """One model's serving paths on ``params`` (the whole model, or this
    rank's shard on the model axis ``tp``): the paged path (a right-padded
    prefill at ``ins["S_p"]`` with ``last_pos``, its cache scattered into
    paged pools, then ``ins["forced"]`` decode steps of given tokens), the
    dense path (a prefill of ``ins["dense"]`` into a cache for
    ``ins["s_max"]`` tokens, then the steps of ``ins["dense_forced"]``,
    the ring of windowed layers wrapping), and the full forward
    (``model_fwd`` of ``ins["dense"]``).  Each decode step starts from the
    cache of ``ins["pools_before"][i]`` / ``ins["caches_before"][i]``
    (the unsharded run's, cut for this rank) where the inputs have them,
    so that a bf16 cache entry rounded the other way in an earlier step
    does not carry over.  Returns numpy logits, the caches before each
    step (unsharded runs only: the ``*_before`` inputs), the dense cache
    after the last step, and the axis's collectives of each call."""
    from repro_torch.models import transformer as T

    calls = (lambda: tp.calls) if tp is not None else (lambda: 0)
    start = lambda kind, i, cache: cache if f"{kind}_before" not in ins \
        else _cut_state(ins, f"{kind}_before", i, cache, cfg, tp)
    keep = lambda cache: [{k: v.float().numpy() for k, v in ent.items()}
                          for ent in cache]
    out = {"pools_before": [], "caches_before": []}
    BS, L = ins["BS"], ins["L"]
    toks = _t(ins["toks"]).long()
    c0 = calls()
    lg, cache, _ = T.prefill(params, cfg, {"tokens": toks}, ins["S_p"],
                             last_pos=torch.tensor([L - 1]),
                             full_local_cache=True, tp=tp, seq_shard=False)
    out["paged_prefill_calls"] = np.array(calls() - c0)
    out["paged_prefill"] = lg.numpy()
    nb = ins["S_p"] // BS
    pools = T.init_paged_pools(cfg, 2 + ins["max_blocks"], BS, device=CPU,
                               tp=tp)
    T.scatter_prefill_cache(pools, cache, list(range(1, nb + 1)), BS)
    tables = torch.arange(1, ins["max_blocks"] + 1)[None]
    steps = []
    for i, t in enumerate(ins["forced"]):
        pools = start("pools", i, pools)
        out["pools_before"].append(keep(pools))
        lg, pools = T.decode_step_paged(params, cfg, pools, tables,
                                        _t(t).long()[None],
                                        torch.tensor([L + i]), tp=tp)
        steps.append(lg.numpy())
    out["paged_steps"] = np.stack(steps)
    dense = _t(ins["dense"]).long()
    c0 = calls()
    lg, cache, S = T.prefill(params, cfg, {"tokens": dense}, ins["s_max"],
                             tp=tp)
    out["dense_prefill_calls"] = np.array(calls() - c0)
    out["dense_prefill"] = lg.numpy()
    steps = []
    for i, t in enumerate(ins["dense_forced"]):
        cache = start("caches", i, cache)
        out["caches_before"].append(keep(cache))
        c0 = calls()
        lg, cache = T.decode_step(params, cfg, cache, _t(t).long(), S + i,
                                  tp=tp, s_max=ins["s_max"])
        out["dense_step_calls"] = np.array(calls() - c0)
        steps.append(lg.numpy())
    out["dense_steps"] = np.stack(steps)
    for r, ent in enumerate(cache):
        for name in ("k", "v"):
            out[f"cache{r}_{name}"] = ent[name].float().numpy()
    with torch.no_grad():
        c0 = calls()
        out["fwd"] = T.model_fwd(params, cfg, {"tokens": dense}, tp).numpy()
        out["fwd_calls"] = np.array(calls() - c0)
    if tp is not None:
        del out["pools_before"], out["caches_before"]
    return out


def tp_ranks(rank, model, cases, sp_cases):
    """This rank of a model group of ``model`` gloo ranks on the CPU.

    With 4 ranks, first a 1x2x2 grid: each rank's axis indices and the
    sums of its rank id over the model and dp axes.  Then, for each case
    ``(name, cfg, params)`` (the reference's parameters, numpy) with the
    inputs ``ins``, :func:`model_paths` on this rank's shard of them
    (``shard_params``).  Then for each of ``sp_cases`` the
    sequence-parallel combine alone (``layers._cache_attend_sp``) on this
    rank's slice of a cache; returns its o and the slice after the write."""
    from repro_torch.models import layers as L
    from repro_torch.models.convert import params_from_jax, shard_params

    out = {}
    if model == 4:
        g = make_grid(1, 2, CPU, model=2)
        x = torch.tensor([float(rank)])
        out["grid122"] = np.array([g.rank, g.tp.index, g.dp.index,
                                   g.tp.psum(x).item(), g.dp.psum(x).item(),
                                   g.fast.psum(x).item()])
    grid = make_grid(1, 1, CPU, model=model)
    tp = grid.tp
    for name, cfg, params, ins in cases:
        p = shard_params(params_from_jax(params, cfg, device=CPU), cfg,
                         model, rank)
        res = model_paths(p, cfg, ins, tp)
        out.update({f"{name}/{k}": v for k, v in res.items()})
    for i, (q, kn, vn, ck, cv, pos, windowed) in enumerate(sp_cases):
        n = ck.shape[1] // model
        cut = lambda a: torch.from_numpy(
            np.array(a[:, rank * n:(rank + 1) * n])).to(torch.bfloat16)
        k_loc, v_loc = cut(ck), cut(cv)
        o = L._cache_attend_sp(_t(q), _t(kn), _t(vn), k_loc, v_loc, pos,
                               windowed, tp)
        out[f"sp{i}/o"] = o.numpy()
        out[f"sp{i}/k"] = k_loc.float().numpy()
    out["staged_bytes"] = np.array(grid.staged_bytes)
    return out


# ---------------------------------------------------------------------- #
# Training on a model axis
# ---------------------------------------------------------------------- #

def _pair_ops(tp, xs, cs):
    """``copy_to`` and ``reduce_from`` on this rank's inputs, each through
    a backward: ``reduce_from(xs[m])`` against the shared weights
    ``cs[0]``, and ``copy_to`` of the shared ``xs[0]`` against this rank's
    weights ``cs[m]``; returns the forwards, the gradients and the axis's
    counters."""
    m = tp.index
    c0 = (tp.calls, tp.bwd_calls)
    x = _t(xs[m]).requires_grad_(True)
    y = tp.reduce_from(x)
    (y * _t(cs[0])).sum().backward()
    u = _t(xs[0]).requires_grad_(True)
    z = tp.copy_to(u)
    (z * _t(cs[m])).sum().backward()
    return {"reduce_y": y.detach().numpy(), "reduce_grad": x.grad.numpy(),
            "copy_z": z.detach().numpy(), "copy_grad": u.grad.numpy(),
            "calls": np.array([tp.calls - c0[0], tp.bwd_calls - c0[1]])}


def _ce(tp, x, labels, head):
    """The vocab-parallel cross-entropy (``transformer._ce_chunk``) of
    this rank's head columns and its gradients: the nll sum, the count,
    the input's gradient and this rank's columns' gradient."""
    from repro_torch.models import transformer as T

    n = head.shape[1] // tp.size
    xt = _t(x).requires_grad_(True)
    h = _t(head[:, tp.index * n:(tp.index + 1) * n]).requires_grad_(True)
    nll, cnt = T._ce_chunk(tp.copy_to(xt), torch.from_numpy(labels), h, tp)
    (nll / cnt).backward()
    return {"nll": nll.detach().numpy(), "cnt": cnt.numpy(),
            "x_grad": xt.grad.numpy(), "head_grad": h.grad.numpy()}


def tp_train(rank, pods, data, model, pair, ce, cases, traj=None):
    """This rank of a (pods x data x model) grid of gloo ranks on the CPU.

    ``pair`` (xs, cs) for :func:`_pair_ops`, ``ce`` (x, labels, head) for
    :func:`_ce`; on the first model group, for each case ``(name, cfg,
    params, batch)`` (the full f32 parameters in the stacked layout,
    numpy) the loss and gradients of this rank's model shard
    (``loss_and_grads``) and the model axis's collectives; with ``traj``
    (cfg, runs, batches): for each run ``(name, modes, opt_kw, params,
    again)`` the losses of the train step on this grid, then the runs
    marked ``again`` on a (pods x data x 1) grid of the model index 0
    ranks (``make_grid(members=)``), under ``"grid1/" + name``."""
    grid = make_grid(pods, data, CPU, model=model)
    tp = grid.tp
    out = {"pair": _pair_ops(tp, *pair), "ce": _ce(tp, *ce)}
    for name, cfg, params, batch in cases if grid.rank == 0 else ():
        p = shard_params(unstack_runs(from_numpy(params, device=CPU), cfg),
                         cfg, model, tp.index)
        calls = {}
        loss, grads = loss_and_grads(p, cfg, device_batch(batch, CPU), tp,
                                     calls)
        out[name] = {"loss": loss.numpy(),
                     "grads": to_numpy(stack_runs(grads, cfg)),
                     "calls": calls}
    if traj is not None:
        cfg, runs, batches = traj
        for name, modes, opt_kw, params, _ in runs:
            out[name] = _trajectory(grid, cfg, modes, params, batches,
                                    opt_kw)
        members = [r for r in range(pods * data * model) if r % model == 0]
        if rank in members:
            sub = make_grid(pods, data, CPU, members=members)
            for name, modes, opt_kw, params, again in runs:
                if again:
                    out["grid1/" + name] = _trajectory(
                        sub, cfg, modes, params, batches, opt_kw)
            sub.barrier()
    return out


def _moe_blocks(tp, cfg, layer, x, ct, chunk):
    """``moe_fwd`` of one layer's MoE shard ``layer`` on the replicated
    ``x`` (which it takes through ``copy_to``) with token blocks of
    ``chunk``, and the
    gradients of ``<ct, y>`` for the input and every leaf; the slots
    this rank dropped (``moe_fwd.dropped``) and the routings read on the
    host."""
    from repro_torch.models import layers as L
    from repro_torch.tree import tree_leaves as leaves_of
    from repro_torch.tree import tree_unflatten

    leaves = [t.detach().requires_grad_(True) for t in leaves_of(layer)]
    xt = _t(x).requires_grad_(True)
    dropped, s0 = [], L.moe_fwd.host_syncs
    L.moe_fwd.dropped = dropped
    try:
        y = L.moe_fwd(tree_unflatten(layer, leaves), cfg, xt, chunk=chunk,
                      tp=tp)
        grads = torch.autograd.grad((y * _t(ct)).sum(), [xt] + leaves)
    finally:
        L.moe_fwd.dropped = None
    return {"y": y.detach().numpy(), "grads": [g.numpy() for g in grads],
            "dropped": dropped, "syncs": L.moe_fwd.host_syncs - s0}


def tp_moe(rank, cases, blocks):
    """This rank of four gloo ranks on the CPU, first on a 1x1x4 grid,
    then on 2x1x2.  On each grid's first model group: for each case
    ``(name, cfg, params, batch)`` (the full f32 parameters in the stacked
    layout, numpy) the loss and gradients of this rank's model shard, the
    model axis's collectives, the slots each expert-parallel block dropped
    and the routings read on the host; and with ``blocks`` (cfg, params
    of one MoE layer, x, cotangent, chunk), :func:`_moe_blocks` of this
    rank's shard of the layer in token blocks and in one block.  Results
    under ``(model, name)``."""
    from repro_torch.models import layers as L

    out = {}
    for pods, data, model in ((1, 1, 4), (2, 1, 2)):
        grid = make_grid(pods, data, CPU, model=model)
        tp = grid.tp
        if grid.rank != 0:
            continue
        for name, cfg, params, batch in cases:
            p = shard_params(unstack_runs(from_numpy(params, device=CPU),
                                          cfg), cfg, model, tp.index)
            calls, dropped, s0 = {}, [], L.moe_fwd.host_syncs
            L.moe_fwd.dropped = dropped
            try:
                loss, grads = loss_and_grads(p, cfg, device_batch(batch, CPU),
                                             tp, calls)
            finally:
                L.moe_fwd.dropped = None
            out[model, name] = {
                "loss": loss.numpy(), "calls": calls, "dropped": dropped,
                "syncs": L.moe_fwd.host_syncs - s0,
                "grads": to_numpy(stack_runs(grads, cfg))}
        cfg, layer, x, ct, chunk = blocks
        full = from_numpy(layer, device=CPU)
        dims = layer_model_dims({"mlp": full}, model)["mlp"]
        mine = tree_map(lambda t, d: cut_shard(t, d, model, tp.index), full,
                        dims)
        out[model, "blocks"] = [_moe_blocks(tp, cfg, mine, x, ct, c)
                                for c in (chunk, L.MOE_CHUNK)]
    return out


# ---------------------------------------------------------------------- #
# RWKV-6 and the enc-dec config on a model axis
# ---------------------------------------------------------------------- #

def family_paths(params, cfg, ins, tp=None):
    """The dense serving path of ``params`` (the whole model, or this
    rank's shard on the model axis ``tp``): a prefill of ``ins["tokens"]``
    (and the encoder's ``ins["src_embeds"]``) into a cache for
    ``ins["s_max"]`` tokens, then one decode step for each of
    ``ins["forced"]``, each from ``ins["caches_before"][i]`` (the
    unsharded run's cache of that step, cut for this rank) where the
    inputs have them, and the full forward.  Returns numpy logits, the
    prefill's cache beside ``init_cache(tp=)``'s shapes, the caches before
    each step (unsharded runs only), and the axis's collectives of the
    prefill and of each step."""
    from repro_torch.models import transformer as T

    calls = (lambda: tp.calls) if tp is not None else (lambda: 0)
    inputs = {k: _t(ins[k]) for k in ("tokens", "src_embeds") if k in ins}
    inputs["tokens"] = inputs["tokens"].long()
    keep = lambda cache: [{k: v.float().numpy().copy()
                           for k, v in ent.items()} for ent in cache]
    B = inputs["tokens"].shape[0]
    src = inputs["src_embeds"].shape[1] if "src_embeds" in inputs else 0
    c0 = calls()
    lg, cache, S = T.prefill(params, cfg, inputs, ins["s_max"], tp=tp)
    out = {"prefill_calls": np.array(calls() - c0), "prefill": lg.numpy(),
           "cache": keep(cache), "caches_before": [], "step_calls": [],
           "init_shapes": [{k: tuple(v.shape) for k, v in ent.items()}
                           for ent in T.init_cache(cfg, B, ins["s_max"], src,
                                                   device=CPU, tp=tp)]}
    steps = []
    for i, t in enumerate(ins["forced"]):
        if "caches_before" in ins:
            cache = _cut_state(ins, "caches_before", i, cache, cfg, tp)
        else:
            out["caches_before"].append(keep(cache))
        c0 = calls()
        lg, cache = T.decode_step(params, cfg, cache, _t(t).long(), S + i,
                                  tp=tp, s_max=ins["s_max"])
        out["step_calls"].append(calls() - c0)
        steps.append(lg.numpy())
    out["steps"] = np.stack(steps)
    with torch.no_grad():
        out["fwd"] = T.model_fwd(params, cfg, inputs, tp).numpy()
    if tp is not None:
        del out["caches_before"]
    return out


def _gather_ops(tp, xs, c):
    """``gather_from`` of this rank's slice ``xs[m]`` (n, k) along its
    last dim, through a backward against the weights ``c`` (n, M k) that
    every rank shares; returns the forward, the slice's gradient and the
    axis's counters (forward, backward)."""
    c0 = (tp.calls, tp.bwd_calls)
    x = _t(xs[tp.index]).requires_grad_(True)
    y = tp.gather_from(x, -1)
    (y * _t(c)).sum().backward()
    return {"y": y.detach().numpy(), "grad": x.grad.numpy(),
            "calls": np.array([tp.calls - c0[0], tp.bwd_calls - c0[1]])}


def tp_families(rank, cases, gather):
    """This rank of four gloo ranks on the CPU, on a 1x1x4 grid, then on
    1x2x2.  On each grid's first model group, for each case ``(name,
    cfg, models, params, ins, batch)`` whose ``models`` hold the grid's
    model size: :func:`family_paths` of this rank's shard of the
    reference's f32 weights ``params`` (numpy, the reference's layout),
    and where ``batch`` is given the loss and gradients of the same shard
    (in the stacked layout) with the model axis's collectives; and
    :func:`_gather_ops` of ``gather[model]``.  Results under ``(model,
    name)``."""
    from repro_torch.models.convert import params_from_jax

    out = {}
    for pods, data, model in ((1, 1, 4), (1, 2, 2)):
        grid = make_grid(pods, data, CPU, model=model)
        tp = grid.tp
        if grid.rank != 0:
            continue
        out[model, "gather"] = _gather_ops(tp, *gather[model])
        for name, cfg, models, params, ins, batch in cases:
            if model not in models:
                continue
            p = shard_params(params_from_jax(params, cfg, device=CPU), cfg,
                             model, tp.index)
            res = family_paths(p, cfg, ins, tp)
            if batch is not None:
                calls = {}
                loss, grads = loss_and_grads(p, cfg, device_batch(batch, CPU),
                                             tp, calls)
                res.update(loss=loss.numpy(), calls=calls,
                           grads=to_numpy(stack_runs(grads, cfg)))
            out[model, name] = res
    return out


def family_prefill_on_card(rank, name, ins, s_max):
    """This rank of 1x1x2 gloo ranks sharing the card: the smoke config
    of ``name`` in f32 (seed 0), this rank's shard on the card, the dense
    prefill of ``ins`` (numpy tokens, and an enc-dec config's
    ``src_embeds``) through ``make_prefill_fn``; returns the logits and
    the cache (numpy f32) and this process's flash and WKV launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv as kw
    from repro_torch.launch.step import make_prefill_fn
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    grid = make_grid(1, 1, dev, model=2)
    cfg = get_config(name, smoke=True)
    params = tree_map(lambda t: t.float().to(dev), shard_params(
        T.init_model(cfg, seed=0, device="cpu"), cfg, 2, rank))
    inputs = {k: _t(v).to(dev) for k, v in ins.items()}
    inputs["tokens"] = inputs["tokens"].long()
    f0, w0 = fa.flash_attention_fwd.launches, kw.wkv_chunked.launches
    lg, cache, _ = make_prefill_fn(cfg, s_max, grid)(params, inputs)
    return {"logits": lg.cpu().numpy(),
            "cache": [{k: v.float().cpu().numpy() for k, v in e.items()}
                      for e in cache],
            "flash_fwd": fa.flash_attention_fwd.launches - f0,
            "wkv": kw.wkv_chunked.launches - w0}


# ---------------------------------------------------------------------- #
# The RG-LRU family and the KV-head split on a model axis
# ---------------------------------------------------------------------- #

def _gather_to_ops(tp, xs, ws, c):
    """``gather_to`` of this rank's slice ``xs[m]`` (n, k) along its last
    dim, read by a consumer of this rank's own, ``gathered @ ws[m]``,
    through a backward against ``c``; returns the forward, the slice's
    gradient and the axis's counters (forward, backward)."""
    c0 = (tp.calls, tp.bwd_calls)
    x = _t(xs[tp.index]).requires_grad_(True)
    y = tp.gather_to(x, -1)
    ((y @ _t(ws[tp.index])) * _t(c)).sum().backward()
    return {"y": y.detach().numpy(), "grad": x.grad.numpy(),
            "calls": np.array([tp.calls - c0[0], tp.bwd_calls - c0[1]])}


def _tp_step(grid, cfg, params, batch, opt_kw):
    """One train step (``make_train_step``) of this rank's shard of the
    stacked f32 ``params`` (numpy) on ``grid``, with the gradients it
    syncs (``loss_and_grads``, the same computation) and the stacked
    layout's model dims; numpy."""
    tp = grid.tp
    p = shard_params(from_numpy(params, device=CPU), cfg, tp.size, tp.index)
    _, grads = loss_and_grads(p, cfg, device_batch(batch, CPU), tp)
    opt_cfg = adamw.OptConfig(**opt_kw)
    mdims = model_dims(cfg, tp.size)
    opt = adamw.shard_opt_state(adamw.init_opt_state(p, opt_cfg), p,
                                opt_cfg, grid, mdims)
    new_p, new_opt, loss = make_train_step(cfg, opt_cfg, grid, CPU)(
        p, opt, batch)
    return {"grads": to_numpy(grads), "params": to_numpy(new_p),
            "opt": to_numpy(new_opt), "loss": loss.numpy(),
            "mdims": mdims}


def _group_cases(tp, cases):
    """For each case ``(name, cfg, models, paths, params, ins, batch)``
    whose ``models`` hold the size of the model axis ``tp``: this rank's
    shard of the reference's f32 weights ``params`` (numpy, the stacked
    layout), cut per layer, through ``paths`` (:func:`family_paths`, the
    dense path, or :func:`model_paths`, the paged and the dense paths)
    and, where ``batch`` is given, the loss and gradients of the stacked
    shard (``loss_and_grads``) with the model axis's collectives.
    Results under ``(M, name)``."""
    out = {}
    for name, cfg, models, paths, params, ins, batch in cases:
        if tp.size not in models:
            continue
        full = from_numpy(params, device=CPU)
        fn = family_paths if paths == "family" else model_paths
        res = fn(shard_params(unstack_runs(full, cfg), cfg, tp.size,
                              tp.index), cfg, ins, tp)
        if batch is not None:
            calls = {}
            stacked = shard_params(full, cfg, tp.size, tp.index)
            loss, grads = loss_and_grads(stacked, cfg,
                                         device_batch(batch, CPU), tp, calls)
            res.update(loss=loss.numpy(), calls=calls, grads=to_numpy(grads))
        out[tp.size, name] = res
    return out


def tp_rglru(rank, cases, gather, step):
    """This rank of four gloo ranks on the CPU, on a 1x1x4 grid, then on
    1x2x2, whose first model group computes.  For each case ``(name, cfg,
    models, paths, params, ins, batch)`` whose ``models`` hold the grid's
    model size: this rank's shard of the reference's f32 weights
    ``params`` (numpy, the stacked layout), cut per layer, through
    ``paths`` (:func:`family_paths`, the dense path, or
    :func:`model_paths`, the paged and the dense paths) and, where
    ``batch`` is given, the loss and gradients of the stacked shard
    (``loss_and_grads``, which gathers the RG-LRU's ``w_out`` along its
    run dim where the axis splits the run) with the model axis's
    collectives; :func:`_gather_to_ops` of ``gather[model]``.  On the
    first model group of 1x2x2, as a 1x1x2 grid, :func:`_tp_step` of
    ``step`` (cfg, params, batch, opt_kw).  Results under ``(model,
    name)``."""
    import dataclasses

    from repro_torch.launch.mesh import Grid

    out = {}
    for pods, data, model in ((1, 1, 4), (1, 2, 2)):
        grid = make_grid(pods, data, CPU, model=model)
        tp = grid.tp
        if grid.rank != 0:
            continue
        out[model, "gather"] = _gather_to_ops(tp, *gather[model])
        out.update(_group_cases(tp, cases))
        if model == 2:
            one = dataclasses.replace(Grid.single(), model=2, tp=tp)
            out["step"] = _tp_step(one, *step)
    return out


# ---------------------------------------------------------------------- #
# A model axis that cuts inside a head, and a replicated vocabulary
# ---------------------------------------------------------------------- #

def tp_headcut(rank, cases, steps):
    """This rank of four gloo ranks on the CPU, on a 1x1x4 grid:
    :func:`_group_cases` of ``cases``, and for each of ``steps`` (name ->
    cfg, params, batch, opt_kw) one train step, :func:`_tp_step`, under
    ``(4, name, "step")``."""
    grid = make_grid(1, 1, CPU, model=4)
    out = _group_cases(grid.tp, cases)
    for name, step in steps.items():
        out[4, name, "step"] = _tp_step(grid, *step)
    return out


def headcut_on_card(rank, cfg, ins, s_max, batch, before):
    """This rank of 1x1x4 gloo ranks sharing the card: the f32 seed-0
    weights of ``cfg`` (drawn on the CPU), this rank's shard on the card:
    the dense prefill of ``ins["tokens"]`` into a cache for ``s_max``
    tokens, a decode step of each of ``ins["forced"]`` from ``before[i]``
    (the one-rank cache of that step, numpy, cut for the rank), and the
    loss and gradients of ``batch`` on the stacked shard.  Returns them in
    numpy, with this process's flash launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tp = make_grid(1, 1, dev, model=4).tp
    full = tree_map(lambda t: t.float(), T.init_model(cfg, seed=0,
                                                      device=CPU))
    p = tree_map(lambda t: t.to(dev), shard_params(full, cfg, 4, rank))
    kernels = (fa.flash_attention_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for f in kernels:
        f.launches = 0
    lg, cache, S = T.prefill(p, cfg, {"tokens": _t(ins["tokens"]).long()
                                      .to(dev)}, s_max, tp=tp)
    out = {"prefill": lg.cpu().numpy(), "steps": []}
    for i, t in enumerate(ins["forced"]):
        cache = [{k: v.to(dev) for k, v in ent.items()} for ent in
                 _cut_state({"b": before}, "b", i, cache, cfg, tp)]
        lg, cache = T.decode_step(p, cfg, cache, _t(t).long().to(dev),
                                  S + i, tp=tp, s_max=s_max)
        out["steps"].append(lg.cpu().numpy())
    stacked = tree_map(lambda t: t.to(dev), shard_params(
        stack_runs(full, cfg), cfg, 4, rank))
    loss, grads = loss_and_grads(stacked, cfg, device_batch(batch, dev), tp)
    out.update(loss=loss.item(), grads=to_numpy(grads),
               launches=[f.launches for f in kernels])
    return out


def _axis_counts(grid) -> dict:
    return {a.name: [a.calls, a.bwd_calls, a.wire_bytes]
            for a in grid.axes()}


def dry_counts(rank, cases):
    """The real counterpart of the dry run (``launch.dryrun.run_rank``):
    for each case ``(name, cfg, mesh, S, B, comm_mode, zero1)`` on the
    4-rank 2x1x2 grid or this rank's 1x1x2 pair (ranks 0-1, 2-3), one
    train step of an int32 (B, S) batch, a prefill of this rank's rows
    (``s_max`` S) and a decode step after a prefill with ``s_max`` 2 S,
    each under a ``WorkCounter`` with the grid's counters from 0.
    Returns each one's axis counters (calls, bwd_calls, wire_bytes),
    FLOPs, bytes and kernels, by case name."""
    from repro_torch.kernels.work import WorkCounter
    from repro_torch.launch.step import make_decode_fn, make_prefill_fn
    from repro_torch.models import transformer as T

    grids = {(2, 1, 2): make_grid(2, 1, CPU, model=2)}
    grids[1, 1, 2] = make_grid(1, 1, CPU, model=2,
                               members=[0, 1] if rank < 2 else [2, 3])
    out = {}
    for name, cfg, mesh, S, B, comm, zero1 in cases:
        grid = grids[mesh]
        m, res = grid.tp.index, {}

        def measure(key, fn):
            for a in grid.axes():
                a.calls = a.bwd_calls = a.wire_bytes = 0
            with WorkCounter() as wc:
                fn()
            res[key] = {"calls": _axis_counts(grid), "flops": wc.flops,
                        "bytes": wc.bytes, "kernels": wc.kernels}

        # the compressed exchange on the card's path (the kernels'
        # wrappers, padded to QTILE), which meta takes
        opt_cfg = adamw.OptConfig(comm_mode=comm, zero1=zero1, quant_kernel=(
            True if comm == "multilevel_compress" else None))
        params = stack_runs(T.init_model(cfg, seed=0, device=CPU, model=2,
                                         m=m), cfg, 2, m)
        opt = adamw.shard_opt_state(
            adamw.init_opt_state(params, opt_cfg, n_slow=mesh[0]), params,
            opt_cfg, grid, model_dims(cfg, 2))
        step = make_train_step(cfg, opt_cfg, grid, CPU)
        rng = np.random.default_rng(0)
        batch = {k: rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
                 for k in ("tokens", "labels")}
        measure("train", lambda: step(params, opt, batch))
        layers = T.init_model(cfg, seed=0, device=CPU, model=2, m=m)
        rows = B // grid.world
        toks = torch.from_numpy(batch["tokens"][:rows]).long()
        with torch.inference_mode():
            measure("prefill", lambda: make_prefill_fn(cfg, S, grid)(
                layers, {"tokens": toks}))
            _, cache, n = make_prefill_fn(cfg, 2 * S, grid)(
                layers, {"tokens": toks})
            dec = make_decode_fn(cfg, grid, s_max=2 * S)
            measure("decode", lambda: dec(layers, cache, toks[:, -1:], n))
        out[name] = res
    return out


# ---------------------------------------------------------------------- #
# The reference's fallback placements: leaves moved to their other
# matmul dim, or replicated
# ---------------------------------------------------------------------- #

def tp_fallback(rank, cases):
    """This rank of three gloo ranks on the CPU, a 1x1x3 grid:
    :func:`_group_cases` of ``cases``."""
    return _group_cases(make_grid(1, 1, CPU, model=3).tp, cases)
