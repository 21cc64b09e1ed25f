"""Serving on a model axis: the port's tensor parallelism, its
sequence-parallel dense decode and its expert parallelism, on 2 and 4
gloo ranks on the CPU, against the port's unsharded model and against the
reference.

Each model group runs once per module (a fixture): the ranks
(``_torch_ranks.tp_ranks``) take the reference's f32 weights, cut their
shard (``shard_params``), and run ``_torch_ranks.model_paths`` (the paged
serving path, the dense path whose cache is split over the sequence, the
full forward); this process runs the same function on the whole model
first, and the reference's ``prefill``/``decode_step``/
``decode_step_paged``/``model_fwd`` on the same weights and tokens.  The
models are f32, their caches bf16, as the reference's: a k or v whose f32
value lands a rounding order away from the unsharded one (the row-parallel
sums add in another order) may round to the neighbouring bf16 number, and
one such entry moves a smoke model's logits by up to about 1e-4.  So each
rank's decode step starts from the unsharded run's cache of that step,
cut for the rank, and so does each of the reference's decode steps.  The
prefill and forward logits agree within 1e-5 of the unsharded port and of
the reference; a decode step's logits also read the k and v it writes,
which may round apart, so they agree within ``tests/test_torch_model.py``'s
f32 ``LOGIT_TOL`` (1e-4; 4.4e-5 at most when measured).  The combine
alone
(``_cache_attend_sp``) is held to the reference's under ``jax.vmap`` over
a ``model`` axis, and the expert-parallel block (``_moe_block_ep``), rank
by rank, to the reference's with its sum over the axis taken out, so that
each rank's kept slots are compared, at ``capacity_factor`` 1.25 (slots
dropped) and 4.0 (none: the dense block), within 2e-4 as
``tests/test_parallel_paths.py:36``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from _torch_bridge import cast_tree, forked_ranks, jax_to_numpy, numpy_to_torch
from jax import lax
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.serve import serve
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax, shard_params

TOL = 1e-5           # f32 logits, sharded against unsharded and reference
DECODE_TOL = 1e-4    # a decode step's logits: LOGIT_TOL["float32"]
EP_TOL = 2e-4        # tests/test_parallel_paths.py:36
CACHE_TOL = 1e-2     # bf16 caches (tests/test_torch_model.py's f32 one)


def _cfg(name):
    if name == "gpt_window":        # windowed layers, KV heads M=4 divides
        return dataclasses.replace(configs.get_config("gpt_100m", smoke=True),
                                   pattern=("local", "local", "local",
                                            "attn"))
    if name == "gpt_parallel":
        return dataclasses.replace(configs.get_config("gpt_100m", smoke=True),
                                   parallel_block=True)
    if name == "llama4_kv4":        # the shared expert, top-1
        cfg = configs.get_config("llama4_scout_17b_a16e", smoke=True)
        return dataclasses.replace(cfg, n_kv_heads=4, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    cfg = configs.get_config(name, smoke=True)
    if cfg.moe is not None:         # room for every slot: EP == dense
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    return cfg


CASES = {2: ["gpt_100m", "gpt_parallel", "gemma3_12b", "olmoe_1b_7b",
             "llama4_kv4"],
         4: ["gpt_100m", "gpt_parallel", "gpt_window", "olmoe_1b_7b"]}


def _inputs(cfg):
    rng = np.random.default_rng(7)
    S_p, L_ = 8, 6
    toks = np.zeros((1, S_p), np.int64)
    toks[0, :L_] = rng.integers(0, cfg.vocab, L_)
    return {"BS": 4, "L": L_, "S_p": S_p, "max_blocks": 4, "toks": toks,
            "forced": rng.integers(0, cfg.vocab, (5, 1)),
            # 16 prompt tokens fill a window of 8 twice; 6 steps wrap it
            "dense": rng.integers(0, cfg.vocab, (2, 16)), "s_max": 24,
            "dense_forced": rng.integers(0, cfg.vocab, (6, 2, 1))}


def _sp_cases():
    """The combine alone: (q, k_new, v_new, cache_k, cache_v, pos,
    windowed), caches of 16 slots, bf16 values, one position inside the
    cache, one that wraps the ring."""
    rng = np.random.default_rng(11)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    out = []
    for pos, windowed in ((9, False), (21, True)):
        q = rng.standard_normal((2, 2, 2, 16)).astype(np.float32)
        kn, vn = (rng.standard_normal((2, 1, 2, 16)).astype(np.float32)
                  for _ in range(2))
        ck, cv = (bf(rng.standard_normal((2, 16, 2, 16)).astype(np.float32))
                  for _ in range(2))
        out.append((q, kn, vn, ck, cv, pos, windowed))
    return out


@pytest.fixture(scope="module")
def runs():
    """Per model size: the configs, their reference weights (f32, numpy),
    the inputs (with the unsharded run's cache before each decode step),
    the unsharded run's results and the ranks'."""
    out, done = {}, {}      # a config of both sizes is set up once
    for model, names in CASES.items():
        cases, whole = [], {}
        for name in names:
            if name not in done:
                cfg = _cfg(name)
                jp = jax_to_numpy(cast_tree(
                    JT.init_model(jax.random.PRNGKey(0), cfg), jnp.float32))
                ins = _inputs(cfg)
                paths = _torch_ranks.model_paths(
                    params_from_jax(jp, cfg, device="cpu"), cfg, ins)
                ins.update(pools_before=paths.pop("pools_before"),
                           caches_before=paths.pop("caches_before"))
                done[name] = (name, cfg, jp, ins), paths
            case, whole[name] = done[name]
            cases.append(case)
        res = run_ranks(_torch_ranks.tp_ranks, model, "gloo",
                        args=(model, cases, _sp_cases()), timeout=600)
        out[model] = {"cases": {c[0]: c for c in cases}, "ranks": res,
                      "unsharded": whole}
    return out


def _jcache(cache):
    """A cache kept by ``model_paths`` (f32 numpy of bf16 values) as the
    reference's (bf16)."""
    return [{k: jnp.asarray(v, jnp.bfloat16) for k, v in ent.items()}
            for ent in cache]


_REFS = {}


def _reference(case):
    """The reference's paged path, dense path and full forward on the same
    weights and tokens, one device; each decode step from the unsharded
    port's cache of that step.  A config of both model sizes has the same
    weights, inputs and unsharded caches on both, so it is computed once."""
    name, cfg, params, ins = case
    if name not in _REFS:
        _REFS[name] = _reference_paths(cfg, params, ins)
    return _REFS[name]


def _reference_paths(cfg, params, ins):
    """``_reference``'s paths, each jitted once for its config (a decode
    step compiles once for all its steps)."""
    jp = jax.tree.map(jnp.asarray, params)
    out = {}
    S_p, L_, BS = ins["S_p"], ins["L"], ins["BS"]
    lg, cache, _ = jax.jit(lambda p, t, last: JT.prefill(
        p, cfg, {"tokens": t}, S_p, last_pos=last, full_local_cache=True))(
        jp, jnp.asarray(ins["toks"]), jnp.asarray([L_ - 1]))
    out["paged_prefill"] = np.asarray(lg)
    tables = jnp.arange(1, ins["max_blocks"] + 1)[None]
    paged = jax.jit(lambda p, pools, tb, t, pos: JT.decode_step_paged(
        p, cfg, pools, tb, t, pos))
    steps = []
    for i, t in enumerate(ins["forced"]):
        lg, _ = paged(jp, _jcache(ins["pools_before"][i]), tables,
                      jnp.asarray(t)[None], jnp.asarray([L_ + i]))
        steps.append(np.asarray(lg))
    out["paged_steps"] = np.stack(steps)
    dense = jnp.asarray(ins["dense"])
    lg, cache, S = jax.jit(lambda p, t: JT.prefill(
        p, cfg, {"tokens": t}, ins["s_max"]))(jp, dense)
    out["dense_prefill"] = np.asarray(lg)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
    steps = []
    for i, t in enumerate(ins["dense_forced"]):
        lg, _ = step(jp, _jcache(ins["caches_before"][i]), jnp.asarray(t),
                     jnp.int32(S + i))
        steps.append(np.asarray(lg))
    out["dense_steps"] = np.stack(steps)
    out["fwd"] = np.asarray(jax.jit(lambda p, t: JT.model_fwd(
        p, cfg, {"tokens": t}))(jp, dense))
    return out


ALL = [(m, n) for m, ns in CASES.items() for n in ns]


@pytest.mark.parametrize("model,name", ALL, ids=[f"{m}-{n}" for m, n in ALL])
def test_tp_paths_match_unsharded_and_reference(runs, model, name):
    """Every rank's logits of the paged path (prefill and 5 decode steps
    across a block boundary), the dense path (prefill, 6 decode steps on
    the sequence-split cache, the windowed ring wrapping) and the full
    forward: equal across the ranks, within 1e-5 of the unsharded port
    and of the reference (a decode step, from the unsharded port's cache,
    within 1e-4)."""
    case = runs[model]["cases"][name]
    ranks = runs[model]["ranks"]
    want = runs[model]["unsharded"][name]
    ref = _reference(case)
    for key in ("paged_prefill", "paged_steps", "dense_prefill",
                "dense_steps", "fwd"):
        got = ranks[0][f"{name}/{key}"]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{name}/{key}"], got)
        assert got.shape == want[key].shape == ref[key].shape, key
        tol = DECODE_TOL if key.endswith("_steps") else TOL
        np.testing.assert_allclose(got, want[key], atol=tol, rtol=0,
                                   err_msg=key)
        np.testing.assert_allclose(got, ref[key], atol=tol, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("model,name", ALL, ids=[f"{m}-{n}" for m, n in ALL])
def test_sp_cache_is_the_unsharded_cache_split_over_the_sequence(
        runs, model, name):
    """The dense cache after the last decode step: rank m holds slots
    [m S/M, (m+1) S/M) of every KV head (every run's length divides by
    M here), and together they are the unsharded cache."""
    ranks = runs[model]["ranks"]
    want = runs[model]["unsharded"][name]
    for key in want:
        if not key.startswith("cache"):
            continue
        parts = [r[f"{name}/{key}"] for r in ranks]
        assert all(p.shape[2] * model == want[key].shape[2] for p in parts)
        assert all(p.shape[3] == want[key].shape[3] for p in parts)
        np.testing.assert_allclose(np.concatenate(parts, 2), want[key],
                                   atol=CACHE_TOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("model", sorted(CASES))
def test_parallel_block_makes_one_allreduce_a_layer(runs, model):
    """The full forward's collectives on the model axis: the embedding's
    one, the logits' all-gather, and per layer one all-reduce for the
    parallel-residual block (both partial sums added first,
    transformer.py:84-91) against two for the sequential one.  The serving
    paths: a prefill has one a sublayer (two a layer) plus the embedding's
    and the head's; a sequence-parallel decode step adds the gather of
    q/k/v and the combine's max and two sums a layer."""
    r0 = runs[model]["ranks"][0]
    n = _cfg("gpt_100m").n_layers
    assert int(r0["gpt_parallel/fwd_calls"]) == 1 + n + 1
    assert int(r0["gpt_100m/fwd_calls"]) == 1 + 2 * n + 1
    assert int(r0["gpt_100m/paged_prefill_calls"]) == 1 + 2 * n + 1
    # the dense prefill gathers each run's k and v once to split them
    assert int(r0["gpt_100m/dense_prefill_calls"]) == 1 + 2 * n + 1 + 2
    assert int(r0["gpt_100m/dense_step_calls"]) == 1 + (2 + 4) * n + 1


def test_grid_122_axes_on_four_ranks(runs):
    """A 1x2x2 grid of the 4 ranks: rank = d * 2 + m; the model axis sums
    the two ranks of a cell, the dp (and fast) axis the two that share m."""
    for rank, r in enumerate(runs[4]["ranks"]):
        d, m = divmod(rank, 2)
        g = r["grid122"]
        assert list(g[:3]) == [d, m, d]
        assert g[3] == 2 * d * 2 + 1          # (2d) + (2d + 1)
        assert g[4] == g[5] == m + (m + 2)


@pytest.mark.parametrize("model", sorted(CASES))
@pytest.mark.parametrize("case", [0, 1], ids=["dense", "windowed-wrap"])
def test_cache_attend_sp_matches_reference(runs, model, case):
    """``_cache_attend_sp`` on each rank's slice of the cache against the
    reference's under ``jax.vmap`` over a ``model`` axis: o within 1e-5,
    and the slice after the write equal (only the owning rank writes)."""
    q, kn, vn, ck, cv, pos, windowed = _sp_cases()[case]
    n = ck.shape[1] // model
    sl = lambda a: jnp.asarray(a).reshape(2, model, n, 2, 16).swapaxes(0, 1)
    f = jax.vmap(lambda k_, v_: JL._cache_attend_sp(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        k_.astype(jnp.bfloat16), v_.astype(jnp.bfloat16), jnp.int32(pos),
        windowed), axis_name="model")
    o, k_out, _ = f(sl(ck), sl(cv))
    for r, res in enumerate(runs[model]["ranks"]):
        np.testing.assert_allclose(res[f"sp{case}/o"], np.asarray(o[r]),
                                   atol=TOL, rtol=0)
        np.testing.assert_array_equal(
            res[f"sp{case}/k"], np.asarray(k_out[r].astype(jnp.float32)))


class _Rank:
    """One rank of a model axis whose sum is left out: the rank's own
    partial result."""

    def __init__(self, size, index):
        self.size, self.index, self.calls = size, index, 0

    def psum(self, x):
        return x

    reduce_from = psum

    @staticmethod
    def copy_to(x):
        return x


class _LaxNoSum:
    """``jax.lax`` with ``psum`` of an array left out (``psum(1, axis)``,
    the axis size, kept)."""

    def __getattr__(self, name):
        return getattr(lax, name)

    @staticmethod
    def psum(x, axis):
        return lax.psum(x, axis) if isinstance(x, int) else x


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("model", [2, 4])
def test_ep_block_matches_reference_rank_by_rank(monkeypatch, model, cf):
    """The port's ``_moe_block_ep`` on each rank's experts against the
    reference's, both without their sum over the axis: each rank's output
    from the slots it kept (a slot kept on one side and dropped on the
    other moves a token by a whole expert output).  Tokens lean towards
    the first two experts, so at 1.25 slots are dropped; at 4.0 none are,
    and the sum over the ranks is the dense block's."""
    cfg = configs.get_config("olmoe_1b_7b", smoke=True)
    m = dataclasses.replace(cfg.moe, capacity_factor=cf)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JL.init_moe(jax.random.PRNGKey(0), cfg))
    E = m.n_experts
    lean = jp["router"][:, 0] + jp["router"][:, 1]
    xt = jax.random.normal(jax.random.PRNGKey(1), (64, cfg.d_model)) \
        + 4.0 * lean / jnp.linalg.norm(lean)
    experts = ("w_in", "w_gate", "w_out")
    sl = {k: jp[k].reshape(model, E // model, *jp[k].shape[1:])
          for k in experts}
    run = lambda: jax.vmap(lambda s: JL._moe_block_ep(
        dict(s, router=jp["router"]), m, xt, "model"), axis_name="model")(sl)
    want_sum = np.asarray(run()[0])
    monkeypatch.setattr(JL, "lax", _LaxNoSum())
    want = np.asarray(run())
    monkeypatch.undo()

    p = numpy_to_torch(jax_to_numpy(jp))
    x = torch.from_numpy(np.array(xt))
    dropped = []
    monkeypatch.setattr(L.moe_fwd, "dropped", dropped)
    parts = []
    for r in range(model):
        pr = dict(p, **{k: p[k].reshape(model, E // model,
                                        *p[k].shape[1:])[r]
                        for k in experts})
        parts.append(L._moe_block_ep(pr, m, x, _Rank(model, r)).numpy())
        np.testing.assert_allclose(parts[-1], want[r], atol=EP_TOL, rtol=0)
    np.testing.assert_allclose(sum(parts), want_sum, atol=EP_TOL, rtol=0)
    assert len(dropped) == model
    if cf == 4.0:
        assert dropped == [0] * model
        dense = L._moe_block(p, m, x).numpy()
        np.testing.assert_allclose(sum(parts), dense, atol=EP_TOL, rtol=0)
        np.testing.assert_allclose(
            dense, np.asarray(JL._moe_block(jp, m, xt)), atol=EP_TOL, rtol=0)
    else:
        assert sum(dropped) > 0


def test_executor_counts_dropped_expert_slots_per_layer():
    """``TorchExecutor`` folds one forward's expert-parallel blocks (layer
    by layer, equally many a layer) into its per-layer drops, keeps the
    first prefill's, and takes the list back after every forward, so the
    counter never grows."""
    from repro_torch.serving import TorchExecutor

    cfg = configs.get_config("olmoe_1b_7b", smoke=True)
    n = cfg.n_layers
    ex = TorchExecutor(cfg, {"embed": torch.zeros(1)}, n_blocks=2,
                       block_size=8, max_slots=1, max_blocks=1,
                       tp=_Rank(2, 0))

    def fwd(blocks):
        L.moe_fwd.dropped.extend(blocks)
        return "out"

    two = list(range(2 * n))                   # two token blocks a layer
    assert ex._forward("prefill", fwd, two) == "out"
    assert L.moe_fwd.dropped is None
    ex._forward("decode", fwd, [1] * n)
    ex._forward("prefill", fwd, [5] * n)
    want = [4 * i + 1 + 1 + 5 for i in range(n)]
    assert ex.moe_dropped.tolist() == want
    assert ex.first_prefill_dropped == sum(two)
    assert ex.tp_calls == {"prefill": [0, 0], "decode": [0]}
    assert L.moe_fwd.dropped is None


def test_serve_reports_the_moe_drops_of_a_model_group():
    """``serve`` of olmoe on ``1x1x2`` (expert parallel at its capacity
    factor 1.25): every request done, and rank 0's dropped slots reported
    per layer, the first prefill's among them."""
    cfg = configs.get_config("olmoe_1b_7b", smoke=True)
    out = serve("olmoe-1b-7b", 3, 16, 4, "1x1x2", smoke=True, device="cpu")
    assert out["report"]["n_done"] == 3
    ax = out["model_axis"]
    per = ax["moe_dropped_per_layer"]
    assert len(per) == cfg.n_layers and min(per) >= 0
    assert 0 <= ax["moe_dropped_first_prefill"] <= sum(per)


def test_serve_on_a_model_axis_gives_the_one_rank_tokens():
    """``serve --mesh 1x1x2`` (two gloo ranks, each its shard) generates
    the tokens of the one-rank serve, request by request, and reports the
    model axis's collectives; the network plane prices a 1x1x2
    topology."""
    kw = dict(smoke=True, device="cpu")
    one = serve("gpt-100m", 5, 20, 12, "1x1x1", **kw)
    two = serve("gpt-100m", 5, 20, 12, "1x1x2", **kw)
    np.testing.assert_array_equal(two["generated"], one["generated"])
    ax = two["model_axis"]
    n = configs.get_config("gpt_100m", smoke=True).n_layers
    assert ax["model"] == 2 and ax["collectives_per_prefill"] == 2 * n + 2
    assert ax["collectives_per_decode_step"] == 2 * n + 2
    assert ax["staged_bytes"] == [0, 0]          # CPU tensors: no staging
    assert "model_axis" not in one


def test_shard_params_of_reference_weights_feed_the_ranks():
    """``params_from_jax`` then ``shard_params``: rank m's wq columns are
    the reference's columns of its heads."""
    cfg = _cfg("gpt_100m")
    jp = JT.init_model(jax.random.PRNGKey(0), cfg)
    full = params_from_jax(jax_to_numpy(jp), cfg, device="cpu")
    q = cfg.q_dim // 2
    for m in range(2):
        wq = shard_params(full, cfg, 2, m)["layers"][1]["attn"]["wq"]
        np.testing.assert_array_equal(
            wq.view(torch.int16).numpy(),
            np.asarray(jax.lax.bitcast_convert_type(
                jp["runs"][0]["attn"]["wq"][1][:, m * q:(m + 1) * q],
                jnp.int16)))


# (config, a path of the reference's tree to a stacked leaf, the port's
# path in layer 1, the split: columns "col", rows "row", or whole)
FAMILY_LEAVES = [
    ("rwkv6_1p6b", ("runs", 0, "rwkv", "w_r"), ("rwkv", "w_r"), "col"),
    ("rwkv6_1p6b", ("runs", 0, "rwkv", "w_o"), ("rwkv", "w_o"), "row"),
    ("rwkv6_1p6b", ("runs", 0, "rwkv", "cm_r"), ("rwkv", "cm_r"), "col"),
    ("rwkv6_1p6b", ("runs", 0, "rwkv", "u"), ("rwkv", "u"), None),
    ("seamless_m4t_medium", ("runs", 0, "xattn", "wk"), ("xattn", "wk"),
     "col"),
    ("seamless_m4t_medium", ("runs", 0, "xattn", "wo"), ("xattn", "wo"),
     "row"),
    ("seamless_m4t_medium", ("enc", "runs", 0, "attn", "wq"),
     ("enc", "attn", "wq"), "col"),
]


@pytest.mark.parametrize("arch,ref,ours,split", FAMILY_LEAVES,
                         ids=[f"{a}-{'/'.join(map(str, r))}"
                              for a, r, _, _ in FAMILY_LEAVES])
def test_shard_params_of_reference_weights_feed_the_families(arch, ref,
                                                            ours, split):
    """``params_from_jax`` then ``shard_params`` for RWKV-6 and enc-dec:
    rank m's leaf of layer 1 is the reference's columns or rows of its
    heads (``w_o`` and the cross attention's ``wo`` by rows), or the
    whole leaf (``u``), bit for bit; the encoder's layers as the
    decoder's."""
    cfg = configs.get_config(arch, smoke=True)
    jp = jax_to_numpy(JT.init_model(jax.random.PRNGKey(0), cfg))
    full = params_from_jax(jp, cfg, device="cpu")
    want = jp
    for k in ref:
        want = want[k]
    want = np.asarray(want[1])
    for m in range(2):
        got = shard_params(full, cfg, 2, m)
        if ours[0] == "enc":
            got = got["enc"]["layers"][1][ours[1]][ours[2]]
        else:
            got = got["layers"][1][ours[0]][ours[1]]
        got = got.view(torch.int16).numpy() if got.dtype == torch.bfloat16 \
            else got.numpy()
        w = want.view(np.int16) if want.dtype == np.uint16 else want
        if split == "col":
            n = w.shape[1] // 2
            w = w[:, m * n:(m + 1) * n]
        elif split == "row":
            n = w.shape[0] // 2
            w = w[m * n:(m + 1) * n]
        np.testing.assert_array_equal(got, w)
