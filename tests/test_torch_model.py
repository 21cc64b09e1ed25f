"""The port's model against ``repro.models.transformer`` on the same
weights: configs, prefill logits and caches, and paged decode.

Weights are the reference's ``init_model(PRNGKey(0), cfg)``, carried over
by ``params_from_jax``.  Two precisions:

* f32 (every weight cast to f32, so only the bf16 KV cache rounds):
  logits within 1e-4, which catches any algorithmic difference;
* bf16 (the models as shipped): every op rounds to bf16, and the two
  frameworks round a value to the neighbouring bf16 number now and then;
  over four layers that moves logits by up to a few bf16 ulps, so the
  tolerance is 5e-2 absolute on logits of magnitude ~1, and caches agree
  to 2e-2 (one ulp of a cache value near 2).
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
from repro_torch.models.convert import params_from_jax, stack_runs, to_numpy

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


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "olmoe_1b_7b",
                                  "pixtral_12b", "recurrentgemma_2b",
                                  "seamless_m4t_medium"])
def test_unported_archs_raise(arch):
    cfg = configs.get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_model(cfg, device="cpu")


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
    for a in ("gpt_100m", "tinyllama_1p1b", "qwen3_4b")]
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
