"""The port's training path against the JAX package on the CPU.

gpt-100m at its smoke size (4 layers, d 64, 4 heads of 16, vocab 512) with
the reference's ``init_model(PRNGKey(0))`` weights carried over by
``params_from_jax``; the gradient check also at the smoke sizes of
gemma3-12b, the MoE (olmoe-1b-7b, llama4-scout-17b-a16e with its shared
expert), recurrentgemma-2b, seamless-m4t-medium and pixtral-12b.  Each
check runs in both packages on the same inputs:

* loss and every gradient leaf against ``jax.value_and_grad(loss_fn)``:
  f32 to 1e-5 (loss, relative) and 1e-4 x max|g| (each leaf); bf16 to 1e-2
  and a relative L2 error of 5e-2 per leaf, because every op rounds to bf16
  and the tied embedding's gradient is a scatter-add whose bf16 result
  depends on the order of its sums.  S 1024 runs the flash path and the
  chunked cross-entropy; S 100 the naive path.  The MoE in bf16 first
  routes alike in both (a token may route apart only where its k-th and
  (k+1)-th logits are within twice the two packages' largest logit
  difference); llama4-scout's router, whose top-1 gate renormalises to
  1, has a zero gradient but for rounding, held under 1e-6 of the
  largest gradient entry in both; seamless in f32 takes the reference's
  encoder through ``_torch_bridge.ref_encoder_f32``;
* ``apply_updates`` fed identical f32 gradients against the reference's
  inside a one-device ``shard_map``, to 1e-6 x max|ref| per leaf (Adam
  would amplify sign noise on near-zero gradients, so the optimiser is
  compared on the same gradients, and training on loss trajectories);
* ``host_batch`` bit for bit; a 4-step f32 loss trajectory against
  ``make_train_step`` on a 1x1x1 mesh to 1e-4 relative; checkpoints that
  resume at the same loss and that each package reads from the other;
* a 3-step f32 loss trajectory on a 2x2x1 grid of four spawned gloo ranks
  under flat, multilevel and multilevel_compress against the reference
  composed per rank (``value_and_grad(loss_fn)`` on each rank's rows, then
  ``apply_updates`` under nested ``jax.vmap`` over (pod, data)), to 1e-4
  relative; and ``train`` on that grid and on a model axis.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_ranks as ranks
from _torch_bridge import (forked_ranks, jax_to_numpy, rank_opt,
                           ref_encoder_f32, vmap_ranks)
from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JaxCheckpoints
from repro.compat import shard_map
from repro.configs.shapes import ShapeSpec as JaxShape
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.launch import step as JSTEP
from repro.launch.mesh import make_test_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.step import device_batch, loss_and_grads
from repro_torch.launch.step import make_train_step
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import (from_numpy, params_from_jax,
                                        params_to_jax, stack_runs, to_numpy,
                                        unstack_runs)
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

ARCH = "gpt_100m"


def _cfg(arch=ARCH, **kw):
    return dataclasses.replace(configs.get_config(arch, smoke=True), **kw)


@functools.lru_cache(maxsize=None)
def _jax_init(cfg):
    """``init_model(PRNGKey(0), cfg)``, jitted (eager init takes seconds)
    and shared between tests (JAX arrays are immutable)."""
    return jax.jit(lambda key: JT.init_model(key, cfg))(jax.random.PRNGKey(0))


def _jax_params(cfg, dtype):
    """Fresh copies (a train step donates its inputs), cast to f32 or as
    initialised (bf16 weights, f32 norms)."""
    return jax.tree.map(lambda a: jnp.array(
        a, jnp.float32 if dtype == "float32" else a.dtype, copy=True),
        _jax_init(cfg))


def _f32(a):
    """A numpy leaf (bf16 as uint16 bits) as float32."""
    a = np.asarray(a)
    return (a.astype(np.uint32) << 16).view(np.float32) \
        if a.dtype == np.uint16 else a.astype(np.float32)


def _batch(cfg, S, B=2, step=0):
    return JaxPipeline(cfg, JaxShape("test", "train", S, B)).host_batch(step)


def _routes(monkeypatch, cfg, params, jparams, batch):
    """Every MoE call of one forward, in layer order, in each package:
    (the top-k expert ids, the f32 router logits), the reference's taken
    by a ``jax.debug.callback`` in its ``_moe_block``."""
    port, ref = [], []
    route, block = L._moe_route, JL._moe_block

    def port_route(p, m, xt):
        gates, order, sizes = route(p, m, xt)
        eidx = torch.empty_like(order)
        eidx[order] = torch.repeat_interleave(
            torch.arange(m.n_experts), torch.tensor(sizes))
        port.append((eidx.reshape(-1, m.top_k).numpy(),
                     L._mm(xt.float(), p["router"]).numpy()))
        return gates, order, sizes

    def ref_block(p, m, xt):
        logits = xt.astype(jnp.float32) @ p["router"]
        _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
        jax.debug.callback(lambda e, lg: ref.append(
            (np.asarray(e), np.asarray(lg))), eidx, logits)
        return block(p, m, xt)

    with monkeypatch.context() as mp:
        mp.setattr(L, "_moe_route", port_route)
        mp.setattr(JL, "_moe_block", ref_block)
        with torch.no_grad():
            T.loss_fn(params, cfg, batch)
        jax.block_until_ready(jax.jit(lambda p, b: JT.loss_fn(p, cfg, b))(
            jparams, {k: jnp.asarray(v) for k, v in _np(batch).items()}))
    return port, ref


def assert_same_routing(port, ref, k):
    """Equal top-k expert ids, but where a token's k-th and (k+1)-th
    logits in the reference are within twice the largest difference
    between the two packages' logits for it: only there can bf16
    roundings upstream of the router (a few ulps of its input after a
    few layers) swap two experts."""
    assert len(port) == len(ref)
    for (e, lg), (je, jlg) in zip(port, ref):
        bad = np.nonzero((e != je).any(-1))[0]
        srt = -np.sort(-jlg[bad], -1)
        gap = srt[:, k - 1] - srt[:, k]
        assert np.all(gap <= 2 * np.abs(lg[bad] - jlg[bad]).max(-1)), \
            f"tokens {bad} route apart with logit gaps {gap}"


def _np(batch):
    return {k: v.numpy() for k, v in batch.items()}


@pytest.mark.parametrize("arch,dtype,S,parallel_block", [
    (ARCH, "float32", 1024, False), (ARCH, "bfloat16", 1024, False),
    (ARCH, "float32", 100, True), (ARCH, "bfloat16", 100, False),
    # local and global layers (each remat recomputes with its own window),
    # q/k norm, geglu
    ("gemma3_12b", "float32", 100, False),
    # the MoE (router, renormalised top-k gates, per-expert products),
    # llama4-scout's shared expert; RG-LRU's scan beside windowed layers
    # on the flash path (S 1024) and the naive one; enc-dec (the cross
    # attention's gradient into the encoder); pixtral's image prefix
    ("olmoe_1b_7b", "float32", 100, False),
    ("olmoe_1b_7b", "bfloat16", 100, False),
    ("llama4_scout_17b_a16e", "float32", 100, False),
    ("llama4_scout_17b_a16e", "bfloat16", 100, False),
    ("recurrentgemma_2b", "float32", 1024, False),
    ("recurrentgemma_2b", "bfloat16", 100, False),
    ("seamless_m4t_medium", "float32", 100, False),
    ("seamless_m4t_medium", "bfloat16", 100, False),
    ("pixtral_12b", "float32", 100, False),
    ("pixtral_12b", "bfloat16", 100, False)])
def test_loss_and_grads_match_reference(arch, dtype, S, parallel_block,
                                        monkeypatch):
    cfg = _cfg(arch, parallel_block=parallel_block)
    if cfg.enc_dec is not None and dtype == "float32":
        monkeypatch.setattr(JT, "encoder_fwd", ref_encoder_f32)
    jparams = _jax_params(cfg, dtype)
    batch = _batch(cfg, S)
    params = params_from_jax(jax_to_numpy(jparams), cfg, device="cpu")
    tbatch = device_batch(batch, "cpu")
    if cfg.moe is not None and dtype == "bfloat16":
        # the gradients compare where both route alike
        port, ref = _routes(monkeypatch, cfg, params, jparams, tbatch)
        assert len(port) == cfg.n_layers
        assert_same_routing(port, ref, cfg.moe.top_k)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, cfg, b)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(params, cfg, tbatch)

    assert loss.dtype == torch.float32
    rel = abs(loss.item() - float(jloss)) / abs(float(jloss))
    assert rel <= (1e-5 if dtype == "float32" else 1e-2)
    got = tree_leaves(params_to_jax(grads, cfg))
    want, _ = jax.tree_util.tree_flatten_with_path(jax_to_numpy(jgrads))
    assert len(got) == len(want)
    top = max(np.abs(_f32(w)).max() for _, w in want)
    for g, (path, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        g, w = _f32(g), _f32(w)
        if cfg.moe is not None and cfg.moe.top_k == 1 \
                and "router" in jax.tree_util.keystr(path):
            # one expert a token: its renormalised gate is 1, so the
            # router's gradient is zero but for rounding in both
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top
        elif dtype == "float32":
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        else:
            assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)


@pytest.mark.parametrize("S", [100, 512])
def test_model_fwd_matches_reference(S):
    """Full-sequence f32 logits, the forward without gradients (no remat),
    against ``JT.model_fwd``: naive and flash paths."""
    cfg = _cfg()
    jparams = _jax_params(cfg, "float32")
    toks = _batch(cfg, S)["tokens"]
    want = np.asarray(jax.jit(lambda p, t: JT.model_fwd(
        p, cfg, {"tokens": t}))(jparams, jnp.asarray(toks)))
    params = params_from_jax(jax_to_numpy(jparams), cfg, device="cpu")
    with torch.no_grad():
        got = T.model_fwd(params, cfg, device_batch({"tokens": toks}, "cpu"))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _ref_update(opt_cfg):
    mesh = make_test_mesh(1, 1, 1)
    fn = shard_map(lambda p, g, o: jadamw.apply_updates(p, g, o, opt_cfg,
                                                        None, 1, 1),
                   mesh=mesh, in_specs=(P(), P(), P()),
                   out_specs=(P(), P()), axis_names={"data"},
                   check_vma=False)
    return jax.jit(fn)


def _ref_math(opt_cfg):
    """The reference's update math (``lr_at``, the clip, ``_adamw_math``)
    with the global norm summed in f64.  On this CPU the reference's own
    f32 ``vdot`` sum is off by about 1e-5 relative, which a clipped update
    carries to every leaf; the port's sum is within 1e-9."""
    @jax.jit
    def scaled(params, grads, opt, scale):
        t, lr = opt["step"] + 1, jadamw.lr_at(opt_cfg, opt["step"])
        res = jax.tree.map(lambda m, v, g, w: jadamw._adamw_math(
            m, v, g * scale, w, opt_cfg, lr, t),
            opt["m"], opt["v"], grads, opt["master"])
        m, v, w = (jax.tree.map(lambda _, r: r[i], grads, res,
                                is_leaf=lambda x: isinstance(x, tuple))
                   for i in range(3))
        return (jax.tree.map(lambda w, p: w.astype(p.dtype), w, params),
                dict(opt, m=m, v=v, master=w, step=t))

    def update(params, grads, opt):
        gn = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                         for g in jax.tree.leaves(grads)))
        scale = np.float32(min(1.0, opt_cfg.clip_norm / max(gn, 1e-12)))
        return scaled(params, grads, opt, scale)
    return update


@pytest.mark.parametrize("comm,zero1", [("multilevel", True),
                                        ("flat", False),
                                        ("multilevel_compress", True)])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])     # unclipped, clipped
def test_apply_updates_matches_reference(comm, zero1, grad_scale):
    """Unclipped: the reference's ``apply_updates`` itself.  Clipped: its
    math with an exact norm (``_ref_math``)."""
    cfg = _cfg()
    kw = dict(comm_mode=comm, zero1=zero1, lr=1e-3, warmup_steps=2,
              total_steps=5)
    jopt_cfg, opt_cfg = jadamw.OptConfig(**kw), adamw.OptConfig(**kw)
    jparams = _jax_params(cfg, "bfloat16")
    jopt = jadamw.init_opt_state(jparams, jopt_cfg)
    params = from_numpy(jax_to_numpy(jparams), device="cpu")
    opt = adamw.init_opt_state(params, opt_cfg)
    ref = _ref_update(jopt_cfg) if grad_scale < 1 else _ref_math(jopt_cfg)
    rng = np.random.default_rng(0)
    for _ in range(3):          # warmup, then the cosine part of lr_at
        g_np = jax.tree.map(lambda a: grad_scale * rng.standard_normal(
            a.shape).astype(np.float32), jax_to_numpy(jparams))
        jparams, jopt = ref(jparams, jax.tree.map(jnp.asarray, g_np), jopt)
        params, opt = adamw.apply_updates(
            params, from_numpy(g_np, device="cpu"), opt, opt_cfg)
    assert int(opt["step"]) == int(jopt["step"]) == 3
    got = to_numpy({"params": params, "opt": opt})
    want = jax_to_numpy({"params": jparams, "opt": jopt})
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda a: 0, got))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == np.int32:                         # step
            assert np.array_equal(g, w)
        elif w.dtype == np.uint16:
            # bf16 params: the f32 masters agree to 1e-6, so a cast may
            # round to the neighbouring bf16 value (one ulp) at most
            g, w = _f32(g), _f32(w)
            assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w))
        else:
            assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("step", [0, 1, 19, 20, 57, 99])
def test_lr_schedule_matches_reference(step):
    kw = dict(lr=1e-3, warmup_steps=20, total_steps=100)
    want = jadamw.lr_at(jadamw.OptConfig(**kw), jnp.int32(step))
    got = adamw.lr_at(adamw.OptConfig(**kw),
                      torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.item() == float(want)


@pytest.mark.parametrize("kw", [
    dict(quant_kernel=True), dict(bucket_bytes=-1.0, zero1=False),
    dict(bucket_bytes=1.0, comm_mode="multilevel_compress", zero1=False),
    dict(bucket_bytes=1.0)])
def test_opt_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        jadamw.OptConfig(**kw)
    with pytest.raises(ValueError):
        adamw.OptConfig(**kw)


def test_opt_state_crosses_both_ways():
    """The compressed mode's state (m, v, master, step and the EF residual
    with its leading slow-axis dim) from the reference, into the port and
    back, bit for bit; the port's own init on the stacked parameters gives
    the same values, and per-layer parameters stack to the reference's."""
    cfg = _cfg()
    opt_cfg = jadamw.OptConfig(comm_mode="multilevel_compress")
    jparams = _jax_params(cfg, "bfloat16")
    jopt = jax_to_numpy(jadamw.init_opt_state(jparams, opt_cfg, n_slow=2))
    jopt = jax.tree.map(lambda a: a + np.arange(a.size, dtype=a.dtype)
                        .reshape(a.shape) % 7, jopt)       # no all-zeros
    back = to_numpy(from_numpy(jopt, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jopt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jopt)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    params = stack_runs(params_from_jax(jax_to_numpy(jparams), cfg,
                                        device="cpu"), cfg)
    ours = to_numpy(adamw.init_opt_state(
        params, adamw.OptConfig(comm_mode="multilevel_compress"), n_slow=2))
    ref = jax_to_numpy(jadamw.init_opt_state(jparams, opt_cfg, n_slow=2))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arch,host_id,num_hosts", [
    ("gpt_100m", 0, 1), ("gpt_100m", 1, 2), ("pixtral_12b", 0, 1),
    ("seamless_m4t_medium", 1, 2)])
def test_host_batch_bit_exact(arch, host_id, num_hosts):
    cfg = configs.get_config(arch, smoke=True)
    ours = DataPipeline(cfg, ShapeSpec("t", "train", 96, 4), host_id,
                        num_hosts)
    ref = JaxPipeline(jconfigs.get_config(arch, smoke=True),
                      JaxShape("t", "train", 96, 4), host_id, num_hosts)
    for step in (0, 7):
        got, want = ours.host_batch(step), ref.host_batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


def test_train_trajectory_matches_reference():
    """Four f32 steps at S 512 (the flash path): the port's train step
    against the reference's on a 1x1x1 mesh, the same weights and
    batches."""
    cfg = _cfg()
    kw = dict(lr=1e-3, warmup_steps=20, total_steps=4)
    jparams = _jax_params(cfg, "float32")
    params = from_numpy(jax_to_numpy(jparams), device="cpu")
    jopt = jadamw.init_opt_state(jparams, jadamw.OptConfig(**kw))
    opt = adamw.init_opt_state(params, adamw.OptConfig(**kw))
    mesh = make_test_mesh(1, 1, 1)
    jstep = JSTEP.make_train_step(cfg, jadamw.OptConfig(**kw), mesh)
    # placed as the step returns them, so the second step does not retrace
    p_sh, o_sh, _ = JSTEP.train_in_shardings(cfg, jadamw.OptConfig(**kw),
                                             mesh)
    jparams, jopt = jax.device_put(jparams, p_sh), jax.device_put(jopt, o_sh)
    step = make_train_step(cfg, adamw.OptConfig(**kw), device="cpu")
    for i in range(4):
        batch = _batch(cfg, 512, step=i)
        jparams, jopt, jloss = jstep(
            jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, loss = step(params, opt, batch)
        assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))


def test_checkpoint_resumes_and_crosses_packages(tmp_path):
    """A run that stops after a checkpoint resumes at the same loss; its
    checkpoint restores into the reference's own tree, and a reference
    checkpoint restores into the port, bit for bit."""
    run = functools.partial(train, "gpt-100m", 4, seq=64, batch=2,
                            smoke=True, device="cpu", ckpt_every=2,
                            ckpt_dir=str(tmp_path / "port"))
    first = run()
    assert first["start_step"] == 0 and len(first["losses"]) == 4
    again = run()                                  # resumes after step 2
    assert again["start_step"] == 3
    assert again["losses"] == first["losses"][3:]

    cfg = _cfg()
    jparams = _jax_init(cfg)
    jopt = jadamw.init_opt_state(jparams, jadamw.OptConfig())
    like = {"params": jparams, "opt": jopt}
    got = JaxCheckpoints(str(tmp_path / "port")).restore(2, like)
    ours = CheckpointManager(str(tmp_path / "port")).restore(
        2, jax_to_numpy(like))
    for a, b in zip(jax.tree.leaves(jax_to_numpy(got)),
                    jax.tree.leaves(ours)):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    JaxCheckpoints(str(tmp_path / "ref"), async_write=False).save(5, like)
    back = CheckpointManager(str(tmp_path / "ref")).restore(
        5, jax_to_numpy(like))
    params = params_from_jax(back["params"], cfg, device="cpu")
    for a, b in zip(tree_leaves(params_to_jax(params, cfg)),
                    jax.tree.leaves(jax_to_numpy(jparams))):
        assert np.array_equal(a, b)


def test_train_cli_runs_and_profiles(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.train --device cpu --smoke`` with a
    profile of the steps after the first."""
    path = tmp_path / "profile.txt"
    monkeypatch.setattr("sys.argv", [
        "train", "--device", "cpu", "--smoke", "--steps", "3", "--seq", "32",
        "--batch", "2", "--profile", str(path)])
    train_mod.main()
    assert "aten::mm" in path.read_text()


def _rank_rows(batch, r, world):
    n = batch["tokens"].shape[0] // world
    return {k: jnp.asarray(v[r * n:(r + 1) * n]) for k, v in batch.items()}


def _ref_grid_trajectory(cfg, mode, jparams, batches, pods=2, data=2):
    """The reference's train step composed per rank: the loss and grads of
    each rank's rows (``value_and_grad(loss_fn)``), then ``apply_updates``
    on each rank's opt shard under nested vmap; the loss is the mean over
    the ranks (``lax.pmean``)."""
    world = pods * data
    opt_cfg = jadamw.OptConfig(comm_mode=mode, lr=1e-3, warmup_steps=20,
                               total_steps=len(batches))
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, cfg, b)))
    update = vmap_ranks(lambda p, g, o: jadamw.apply_updates(
        p, g, o, opt_cfg, "pod", data, world))
    if not opt_cfg.error_feedback:
        update = jax.jit(update)
    opt = rank_opt(jadamw.init_opt_state(jparams, opt_cfg, n_slow=pods),
                    jparams, opt_cfg, pods, data)
    params = jax.tree.map(lambda a: jnp.broadcast_to(
        a, (pods, data) + a.shape), jparams)
    losses = []
    for b in batches:
        one = jax.tree.map(lambda a: a[0, 0], params)
        res = [grad_fn(one, _rank_rows(b, r, world)) for r in range(world)]
        losses.append(float(np.mean([float(l) for l, _ in res])))
        grads = jax.tree.map(lambda *g: jnp.stack(g).reshape(
            (pods, data) + g[0].shape), *[g for _, g in res])
        params, opt = update(params, grads, opt)
    return losses


MODES = ("flat", "multilevel", "multilevel_compress")


@functools.lru_cache(maxsize=None)
def _port_grid_trajectory():
    cfg = _cfg()
    batches = [_batch(cfg, 64, B=4, step=i) for i in range(3)]
    return run_ranks(ranks.trajectory, 4, "gloo", (
        2, 2, cfg, MODES, jax_to_numpy(_jax_params(cfg, "float32")),
        batches), timeout=300.0)


@pytest.mark.parametrize("mode", MODES)
def test_grid_trajectory_matches_reference(mode):
    """gpt-100m smoke, f32, 3 steps of 4 x 64 tokens (one row per rank) on
    2x2x1: every rank reports the same loss, within 1e-4 of the
    reference's."""
    cfg = _cfg()
    got = [r[mode] for r in _port_grid_trajectory()]
    assert all(g == got[0] for g in got)
    want = _ref_grid_trajectory(
        cfg, mode, _jax_params(cfg, "float32"),
        [_batch(cfg, 64, B=4, step=i) for i in range(3)])
    for g, w in zip(got[0], want):
        assert abs(g - w) <= 1e-4 * abs(w)


def test_grid_and_a_model_axis_train():
    """``train`` on a 2x2x1 grid spawns four gloo ranks on the CPU: finite
    losses, the int8 slow hop at about a quarter of the f32 bytes, and no
    kernel launch (the CPU takes the plain versions).  On 1x2x2 it trains
    too, four ranks of two model groups, with finite losses; ``fail_at``
    on its one pod makes the reference's one-pod decision, a restart that
    carries on with no checkpoint."""
    out = train("gpt-100m", 2, mesh_spec="2x2x1", seq=32, batch=4,
                smoke=True, device="cpu", comm="multilevel_compress")
    assert out["world"] == 4 and out["backend"] == "gloo"
    assert out["staging"] == "none" and out["staged_bytes"] == [0, 0]
    assert len(out["losses"]) == 2 and all(map(math.isfinite, out["losses"]))
    f32 = out["slow_f32_bytes"]
    assert all(0.25 * f32 < w < 0.27 * f32 for w in out["slow_wire_bytes"])
    assert len(out["launches"]) == 4
    assert all(n == 0 for rank in out["launches"] for n in rank.values())
    out = train("gpt-100m", 2, mesh_spec="1x2x2", seq=32, batch=4,
                smoke=True, device="cpu")
    assert out["world"] == 2 and out["model"] == 2
    assert len(out["losses"]) == 2 and all(map(math.isfinite, out["losses"]))
    assert len(out["launches"]) == 4
    out = train("gpt-100m", 2, mesh_spec="1x2x2", smoke=True, device="cpu",
                fail_at={1: [0]})
    assert (out["recoveries"], out["repairs"]) == (1, 0)
    assert len(out["losses"]) == 2 and all(map(math.isfinite, out["losses"]))


def test_stacked_params_unstack_to_views():
    """``unstack_runs`` of the stacked layout gives the port's per-layer
    tree as views, and ``stack_runs`` takes it back bit for bit."""
    cfg = _cfg()
    stacked = from_numpy(jax_to_numpy(_jax_params(cfg, "bfloat16")),
                         device="cpu")
    layers = unstack_runs(stacked, cfg)
    assert len(layers["layers"]) == cfg.n_layers
    wq = layers["layers"][1]["attn"]["wq"]
    assert wq.data_ptr() == stacked["runs"][0]["attn"]["wq"][1].data_ptr()
    back = stack_runs(layers, cfg)
    for a, b in zip(tree_leaves(back), tree_leaves(stacked)):
        assert torch.equal(a, b)
