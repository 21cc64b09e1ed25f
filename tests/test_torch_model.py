"""The port's model against ``repro.models.transformer`` on the same
weights: configs, the parameter trees, prefill logits and caches, the
dense and the paged decode, the reference's own prefill + decode oracle
held to the port's full forward, and the paged serve of olmoe against the
reference's executor.

Weights are the reference's ``init_model(PRNGKey(0), cfg)``, carried over
by ``params_from_jax``.  Two precisions:

* f32 (every weight cast to f32, so only the bf16 KV cache rounds):
  logits within 1e-4, which catches any algorithmic difference;
* bf16 (the models as shipped): every op rounds to bf16, and the two
  frameworks round a value to the neighbouring bf16 number now and then;
  over four layers that moves logits by up to a few bf16 ulps, so the
  tolerance is 5e-2 absolute on logits of magnitude ~1, and caches agree
  to 2e-2 (one ulp of a cache value near 2).

seamless-m4t-medium runs in bf16 only: the reference's encoder casts its
input to bf16, and with f32 weights its layer scan refuses the carry that
the first layer promotes to f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_f32, cast_tree, jax_to_numpy
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax, stack_runs, to_numpy)
from repro_torch.tree import tree_leaves

LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
CACHE_TOL = {"float32": 1e-2, "bfloat16": 2e-2}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_equal_reference(arch, smoke):
    ours, ref = configs.get_config(arch, smoke=smoke), \
        jconfigs.get_config(arch, smoke=smoke)
    assert type(ours).__name__ == type(ref).__name__ == "ModelConfig"
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()


NEW_ARCHS = ["llama4_scout_17b_a16e", "olmoe_1b_7b", "pixtral_12b",
             "recurrentgemma_2b", "seamless_m4t_medium"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_model_builds_reference_tree(arch):
    """MoE, RG-LRU, enc-dec (encoder and per-layer cross-attention) and
    the frontends' configs: once stacked per run, the reference's tree
    structure, leaf shapes and dtypes."""
    cfg = configs.get_config(arch, smoke=True)
    ours = to_numpy(stack_runs(T.init_model(cfg, device="cpu"), cfg))
    ref = jax_to_numpy(JT.init_model(jax.random.PRNGKey(0), cfg))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_init_model_builds_rwkv6_with_reference_leaves():
    """rwkv6 layers carry the reference's ``rwkv`` sub-tree and no MLP:
    the same leaf names, shapes and dtypes once stacked per run."""
    cfg = configs.get_config("rwkv6_1p6b", smoke=True)
    ours = to_numpy(stack_runs(T.init_model(cfg, device="cpu"), cfg))
    ref = jax_to_numpy(JT.init_model(jax.random.PRNGKey(0), cfg))
    assert "mlp" not in ours["runs"][0]
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype


def _close(got, want, tol):
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=0)


# gemma3-12b (windowed layers) in f32 only: in bf16 the two frameworks'
# roundings compound through its layers to k-cache entries several ulps
# apart (0.031 at |k| up to 2.7 from layer 1 on), above CACHE_TOL's 2e-2
@pytest.mark.parametrize("arch,dtype", [
    (a, d) for d in ("float32", "bfloat16")
    for a in ("gpt_100m", "tinyllama_1p1b", "qwen3_4b", "olmoe_1b_7b",
              "pixtral_12b")]
    + [("gemma3_12b", "float32")])
def test_prefill_and_paged_decode_match_reference(arch, dtype):
    """Right-padded prefill (logits at last_pos, caches), the scatter into
    paged pools, then greedy paged decode steps across block boundaries:
    logits per step against the reference fed the same tokens."""
    cfg = configs.get_config(arch, smoke=True)
    jparams = cast_tree(JT.init_model(jax.random.PRNGKey(0), cfg),
                        getattr(jnp, dtype))
    params = params_from_jax(jax_to_numpy(jparams), cfg, device="cpu")

    BS, L, n_steps = 4, 6, 5
    S_p = 8                                  # two blocks; pads at 6, 7
    n_blocks, max_blocks = 8, 4
    toks = np.zeros((1, S_p), np.int32)
    toks[0, :L] = np.random.default_rng(0).integers(0, cfg.vocab, L)

    logits, cache, _ = T.prefill(params, cfg,
                                 {"tokens": torch.from_numpy(toks).long()},
                                 S_p, last_pos=torch.tensor([L - 1]),
                                 full_local_cache=True)
    jlogits, jcache, _ = jax.jit(lambda p, t, last: JT.prefill(
        p, cfg, {"tokens": t}, S_p, last_pos=last, full_local_cache=True))(
        jparams, jnp.asarray(toks), jnp.asarray([L - 1]))
    _close(logits, jlogits, LOGIT_TOL[dtype])
    for ent, jent in zip(cache, jcache):
        for name in ("k", "v"):
            assert ent[name].shape == jent[name].shape
            _close(ent[name], jent[name], CACHE_TOL[dtype])

    blocks = [3, 5]
    pools = T.init_paged_pools(cfg, n_blocks, BS, device="cpu")
    pools = T.scatter_prefill_cache(pools, cache, blocks, BS)
    jpools = JT.scatter_prefill_cache(
        JT.init_paged_pools(cfg, n_blocks, BS), jcache, blocks, BS)
    table = np.zeros((2, max_blocks), np.int32)   # slot 1 stays idle
    table[0, :2] = blocks
    step = jax.jit(lambda p, pl, bt, t, pos: JT.decode_step_paged(
        p, cfg, pl, bt, t, pos))
    tok = int(np.argmax(as_f32(jlogits)[0, -1]))
    for i in range(n_steps):
        pos = L + i
        if pos == 2 * BS:
            table[0, 2] = 6                      # grow into a third block
        t = np.array([[tok], [0]], np.int32)
        p = np.array([pos, 0], np.int32)
        lg, pools = T.decode_step_paged(
            params, cfg, pools, torch.from_numpy(table).long(),
            torch.from_numpy(t).long(), torch.from_numpy(p).long())
        jlg, jpools = step(jparams, jpools, jnp.asarray(table),
                           jnp.asarray(t), jnp.asarray(p))
        _close(lg[0], jlg[0], LOGIT_TOL[dtype])
        tok = int(np.argmax(as_f32(jlg)[0, 0]))
    assert table[0, 2] == 6


def _inputs(cfg, B, S, seed=0):
    """Prompt inputs from numpy: tokens, and 4 patch embeds (vision) or 6
    source frames (enc-dec), bf16, as (jax, torch) dicts."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jin = {"tokens": jnp.asarray(toks)}
    tin = {"tokens": torch.from_numpy(toks).long()}
    n = 4 if cfg.frontend == "vision" else 6 if cfg.enc_dec else 0
    if n:
        e = jnp.asarray(rng.standard_normal((B, n, cfg.d_model)),
                        jnp.bfloat16)
        key = "src_embeds" if cfg.enc_dec else "embeds"
        jin[key] = e
        tin[key] = torch.tensor(as_f32(e)).to(torch.bfloat16)
    return jin, tin


def _dense_cases():
    """Both dtypes, but seamless in bf16 only (see the module docstring)
    and llama4-scout in f32 only: its bf16 logits reach 8.7, where one
    bf16 ulp is 0.0625, above LOGIT_TOL's 5e-2, and the two frameworks'
    roundings leave decode logits 1-2 ulps apart (0.0625 at |logit| 6.7
    and 8.6); its bf16 MoE is held to the reference layer by layer in
    ``test_torch_moe``."""
    cases = []
    for a in NEW_ARCHS:
        for d in ("float32", "bfloat16"):
            if (a, d) not in (("seamless_m4t_medium", "float32"),
                              ("llama4_scout_17b_a16e", "bfloat16")):
                cases.append((a, d))
    return cases


@pytest.mark.parametrize("arch,dtype", _dense_cases())
def test_prefill_and_dense_decode_match_reference(arch, dtype):
    """Prefill logits and every cache leaf (k/v, the cross K/V, the RG-LRU
    state and conv rows), then 4 greedy dense decode steps, each step's
    logits against the reference fed the same token.  recurrentgemma's
    8-token prompt fills its 8-slot window, so the decode wraps the
    ring."""
    cfg = configs.get_config(arch, smoke=True)
    jparams = cast_tree(JT.init_model(jax.random.PRNGKey(0), cfg),
                        getattr(jnp, dtype))
    params = params_from_jax(jax_to_numpy(jparams), cfg, device="cpu")
    jin, tin = _inputs(cfg, 2, 8)
    s_max = 24
    jlg, jcache, jS = jax.jit(lambda p, i: JT.prefill(p, cfg, i, s_max))(
        jparams, jin)
    lg, cache, S = T.prefill(params, cfg, tin, s_max)
    assert S == jS
    _close(lg, jlg, LOGIT_TOL[dtype])
    # the reference's cache carried across and back bit for bit
    back = cache_to_numpy(cache_from_jax(jax_to_numpy(jcache), cfg,
                                         device="cpu"))
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(jax_to_numpy(jcache))):
        np.testing.assert_array_equal(a, b)
    for ent, jent in zip(cache, jcache):
        assert set(ent) == set(jent)
        for name in ent:
            assert ent[name].shape == jent[name].shape, name
            assert ent[name].dtype == getattr(torch, str(jent[name].dtype))
            _close(ent[name], jent[name], CACHE_TOL[dtype])
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
    tok = np.argmax(as_f32(jlg)[:, -1], -1)[:, None].astype(np.int32)
    for i in range(4):
        jlg, jcache = step(jparams, jcache, jnp.asarray(tok),
                           jnp.int32(S + i))
        lg, cache = T.decode_step(params, cfg, cache,
                                  torch.from_numpy(tok).long(), S + i)
        _close(lg, jlg, LOGIT_TOL[dtype])
        tok = np.argmax(as_f32(jlg)[:, -1], -1)[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_matches_own_full_forward(arch):
    """The reference's oracle (``tests/test_models.py:48``) on the port:
    prefill(S) + decode(1) against the port's full forward over S + 1
    tokens, at the oracle's tolerance (atol 0.08, rtol 0.05)."""
    cfg = configs.get_config(arch, smoke=True)
    params = T.init_model(cfg, device="cpu")
    B, S = 2, 8
    _, full_in = _inputs(cfg, B, S + 1, seed=1)
    pre = dict(full_in, tokens=full_in["tokens"][:, :S])
    prefix = 4 if cfg.frontend == "vision" else 0
    with torch.no_grad():
        full = T.model_fwd(params, cfg, full_in)
    lg, cache, pos = T.prefill(params, cfg, pre, S + prefix + 4)
    ld, _ = T.decode_step(params, cfg, cache,
                          full_in["tokens"][:, S:S + 1], pos)
    np.testing.assert_allclose(lg[:, 0].numpy(),
                               full[:, prefix + S - 1].numpy(),
                               atol=0.08, rtol=0.05)
    np.testing.assert_allclose(ld[:, 0].numpy(), full[:, prefix + S].numpy(),
                               atol=0.08, rtol=0.05)


def test_serve_olmoe_smoke_matches_jax_executor(monkeypatch):
    """``serve("olmoe-1b-7b", smoke=True)`` on the CPU with the
    reference's weights (seed 0) against Scheduler + ``JaxExecutor`` on
    the same requests: the greedy tokens of every request are equal, or
    the first divergence is a bf16 near-tie of the reference's logits:
    a top-2 margin under 0.05, ``test_torch_serving``'s ``TIE_MARGIN``."""
    from repro import serving as jserving
    from repro.serving.scheduler import JaxExecutor
    from repro_torch.launch import serve as torch_serve

    cfg = configs.get_config("olmoe_1b_7b", smoke=True)
    n, L, gen = 3, 10, 5
    s_max = L + gen + (-(L + gen)) % 8
    kw = dict(n_blocks=1 + n * (s_max // 8), block_size=8, max_slots=n,
              max_blocks=s_max // 8)
    jex = JaxExecutor(cfg, None, seed=0, **kw)
    reqs = jserving.make_requests([0.0] * n, vocab=cfg.vocab, prompt_len=L,
                                  gen_len=gen, slo=jserving.SLO(), seed=0)
    jserving.Scheduler(jex, n_blocks=kw["n_blocks"], block_size=8,
                       max_slots=n, s_max=s_max,
                       prefill_token_budget=4 * L).run(reqs)
    jparams = jex.params
    monkeypatch.setattr(T, "init_model", lambda cfg, seed, device:
                        params_from_jax(jax_to_numpy(jparams), cfg,
                                        device=device))
    out = torch_serve.serve("olmoe-1b-7b", n, L, gen, smoke=True,
                            device="cpu")
    assert all(r.state.name == "DONE" for r in out["requests"])
    for jr, tokens in zip(reqs, out["generated"].tolist()):
        assert jr.state.name == "DONE"
        if jr.tokens == tokens:
            continue
        i = next(i for i, (a, b) in enumerate(zip(jr.tokens, tokens))
                 if a != b)
        logits, cache, pos = JT.prefill(jparams, cfg,
                                        {"tokens": jr.prompt[None]},
                                        s_max=s_max)
        for t in jr.tokens[:i]:
            logits, cache = JT.decode_step(jparams, cfg, cache,
                                           np.array([[t]], np.int32), pos)
            pos += 1
        top2 = np.sort(as_f32(logits)[0, -1])[-2:]
        assert top2[1] - top2[0] < 0.05, \
            f"request {jr.rid} diverged at token {i} without a near-tie"


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_training_new_archs_raises_naming_roadmap(arch):
    """Trained on one rank: the loss, its gradient and the full forward
    run.  Training runs on a model axis of every size (the smoke
    config's one KV head split over 2 ranks, 8 heads on 4 KV heads, the
    RG-LRU's channels; ``tests/test_torch_tp_rglru.py``,
    ``tests/test_torch_tp_train_moe.py`` and
    ``tests/test_torch_tp_families.py`` train them there), the cuts inside
    a unit too: an untied head cut by rows (a 510-row vocabulary at M 4,
    which divides the 64 rows) and an expert cut inside (the MoE's 4
    experts of 32 features at M 8; ``tests/test_torch_tp_inside.py``
    trains both cuts), whose ``loss_fn`` runs on a rank's shard over a
    stand-in axis (a ``DryAxis``: the collectives keep their shapes and
    move no data).  A model axis of 3, which divides neither the 64
    query columns nor the MLP's features, passes: the reference's
    fallbacks replicate those leaves (``tests/test_torch_tp_fallback.py``
    computes them)."""
    from repro_torch.launch.mesh import DryAxis
    from repro_torch.launch.step import loss_and_grads

    cfg = configs.get_config(arch, smoke=True)
    T.port_check(cfg)
    params = T.init_model(cfg, device="cpu")
    _, batch = _inputs(cfg, 1, 8)
    batch["labels"] = batch["tokens"]
    untied = dataclasses.replace(cfg, tie_embeddings=False, vocab=510)
    heads = dataclasses.replace(cfg, n_heads=8, n_kv_heads=4)
    cases = [(heads, 2), (cfg, 2), (cfg, 3), (untied, 4)] + \
        [(cfg, 8)] * (cfg.moe is not None)
    for c, model in cases:
        shard = T.init_model(c, device="cpu", model=model, m=1)
        loss = T.loss_fn(shard, c, batch, tp=DryAxis(
            "model", list(range(model)), 1))
        assert loss.shape == () and loss.dtype == torch.float32
    loss, grads = loss_and_grads(params, cfg, batch)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g.float()).all() for g in tree_leaves(grads))
    with torch.no_grad():
        assert torch.isfinite(T.model_fwd(params, cfg, batch)).all()
