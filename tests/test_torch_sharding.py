"""The model axis's placement in the port against ``repro.models.sharding``
and ``repro.launch.mesh``: which dim of each parameter a model axis shards
(exactly the reference's ``param_pspecs``, all 11 configs at their full
shapes), the cut and its inverse, the sharded init, the cuts inside a
unit, and the rank grid's groups (the model group innermost, never across
a pod).
"""
import dataclasses
import functools
import types

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.launch.mesh import (Grid, grid_groups, grid_topology,
                                     parse_mesh)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import (shard_params, stack_runs,
                                        unshard_params)
from repro_torch.launch.mesh import DryAxis
from repro_torch.models.sharding import (RUN_DIM, batch_pspec, dp_axes,
                                         param_model_dims, rank_heads,
                                         rwkv_heads)
from repro_torch.tree import tree_leaves

ARCHS = jconfigs.list_archs()


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(the reference's abstract params, the port's fake params) at full
    size: nothing is allocated."""
    cfg = configs.get_config(arch)
    ref = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                               jconfigs.get_config(arch)))
    with FakeTensorMode():
        ours = T.init_model(cfg, device="cpu")
    return cfg, ref, ours


def _ref_dims(spec_tree, cfg):
    """The reference's PartitionSpec tree -> the port's dims tree: the
    index of "model" (or -1), per layer without the run dim (``RUN_DIM``
    where "model" is on the run dim)."""
    def dim(spec, lead=0):
        spec = tuple(spec)
        if "model" not in spec:
            return -1
        return RUN_DIM if lead and spec.index("model") == 0 \
            else spec.index("model") - lead

    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)

    def layers(runs, kinds):
        out = []
        for run, (_, n) in zip(runs, kinds):
            per = jax.tree.map(lambda s: dim(s, 1), run, is_leaf=is_spec)
            out += [per] * n
        return out

    out = {k: dim(v) for k, v in spec_tree.items()
           if k not in ("runs", "enc")}
    out["layers"] = layers(spec_tree["runs"], cfg.runs())
    if "enc" in spec_tree:
        out["enc"] = {"layers": layers(spec_tree["enc"]["runs"],
                                       [("attn", cfg.enc_dec.n_enc_layers)]),
                      "final_norm": dim(spec_tree["enc"]["final_norm"])}
    return out


@pytest.mark.parametrize("model", [2, 3, 4, 5, 6, 8, 12, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_model_dims_equal_reference_pspecs(arch, model):
    """The dim of every leaf, decided on the full config's shapes, is the
    reference's, its fallbacks (a leaf moved to its other matmul dim, or
    replicated: M 3, 5, 6 and 12) and the MoE/RG-LRU ``w_gate`` split
    included."""
    cfg, ref, ours = _shapes(arch)
    want = _ref_dims(JS.param_pspecs(ref, model), cfg)
    assert param_model_dims(ours, model, cfg) == want


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_then_unshard_is_bit_for_bit(arch, model):
    cfg = configs.get_config(arch, smoke=True)
    params = T.init_model(cfg, seed=3, device="cpu")
    shards = [shard_params(params, cfg, model, m) for m in range(model)]
    dims = param_model_dims(params, model, cfg)
    for s, d, full in zip(tree_leaves(shards[0]), tree_leaves(dims),
                          tree_leaves(params)):
        want = list(full.shape)
        if d >= 0:
            want[d] //= model           # RUN_DIM leaves stay whole
        assert list(s.shape) == want
    back = unshard_params(shards, cfg)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


LLAMA4_KV4 = "llama4 smoke, 4 KV heads"


def _tp_config(name):
    if name == LLAMA4_KV4:
        return dataclasses.replace(configs.get_config(
            "llama4_scout_17b_a16e", smoke=True), n_kv_heads=4)
    return configs.get_config(name, smoke=True)


@pytest.mark.parametrize("name,model", [
    ("gpt_100m", 2), ("gpt_100m", 4), ("olmoe_1b_7b", 4),
    ("gemma3_12b", 2), (LLAMA4_KV4, 2), ("recurrentgemma_2b", 2),
    ("recurrentgemma_2b", 4), ("qwen3_4b", 4)])
def test_sharded_init_is_the_shard_of_the_full_init(name, model):
    """``init_model(model=, m=)`` cuts each layer as it is drawn: the same
    numbers as ``shard_params`` of the whole model, bit for bit (the
    RG-LRU's ``w_out`` decided on its run's stacked shape: whole at M 2,
    ``RUN_DIM``, by columns at M 4; one KV head's ``wk`` cut inside it)."""
    cfg = _tp_config(name)
    full = T.init_model(cfg, seed=5, device="cpu")
    for m in range(model):
        got = T.init_model(cfg, seed=5, device="cpu", model=model, m=m)
        want = shard_params(full, cfg, model, m)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


# the leaves (of the first layer; top-level ones by name) that each cut
# inside a unit, and their dim in the per-layer tree
INSIDE_DIMS = {
    "rwkv6_1p6b": {"rwkv/w_r": 1, "rwkv/w_w": 1, "rwkv/w_o": 0,
                   "rwkv/u": -1},
    "llama4_scout_17b_a16e": {"mlp/w_in": 2, "mlp/w_gate": 2,
                              "mlp/w_out": 2, "mlp/router": -1},
    "tinyllama_1p1b": {"lm_head": 0, "embed": -1},
    "olmoe_1b_7b": {"mlp/w_in": 2, "mlp/w_gate": 2, "mlp/w_out": 2},
}


@pytest.mark.parametrize("arch,model,match", [
    ("rwkv6_1p6b", 64, "32 heads"),
    ("llama4_scout_17b_a16e", 32, "16 experts"),
    ("tinyllama_1p1b", 512, "32000 vocabulary rows"),
    ("olmoe_1b_7b", 128, "64 experts"),
])
def test_model_axis_refusals_name_roadmap_item_5(arch, model, match):
    """The cuts inside a unit, once refused, are admitted and placed as
    the reference places them: RWKV-6's 2048 columns inside its 32 heads
    at M 64 (32 columns a rank, each head met by two ranks, from offset 0
    and 32), an expert's features where M does not divide the experts
    (llama4-scout's 16 at M 32, olmoe's 64 at M 128: ``w_in``/``w_gate``
    by features, ``w_out`` by the columns of its output), an untied head
    by rows where M does not divide the vocabulary (tinyllama's 32,000
    rows at M 512, its 2048 rows cut, the embedding whole); the sharded
    init builds every leaf at its shard's shape."""
    cfg, _, ours = _shapes(arch)
    dims = param_model_dims(ours, model, cfg)
    for path, want in INSIDE_DIMS[arch].items():
        d = dims
        for k in (path.split("/") if "/" in path else [path]):
            d = d[0][k] if isinstance(d, list) else d[k] if k in d \
                else d["layers"][0][k]
        assert d == want, path
    if arch == "rwkv6_1p6b":
        D, hd = cfg.d_model, cfg.rwkv_head_dim
        spans = [rwkv_heads(cfg, model, m) for m in range(model)]
        assert all(s.cols == D // model and s.nh == 1 for s in spans)
        assert [(s.h0, s.off) for s in spans] == [
            (m // 2, (m % 2) * hd // 2) for m in range(model)]
    with FakeTensorMode():
        got = T.init_model(cfg, device="cpu", model=model, m=model - 1)
    for t, d, full in zip(tree_leaves(got), tree_leaves(dims),
                          tree_leaves(ours)):
        want = list(full.shape)
        if d >= 0:
            want[d] //= model
        assert list(t.shape) == want


# (arch, smoke config?, model-axis size): a rank's query heads inside one
# KV head, the RG-LRU's, and the cuts inside a head (recurrentgemma's 10
# heads of 256 at M 4: 640 columns; gemma3's 16 at M 32: 128) and a
# vocabulary that the axis does not divide under a tied head (seamless's
# 256,206 rows at M 4)
ADMITTED = [("recurrentgemma_2b", False, 3), ("tinyllama_1p1b", False, 3),
            ("phi4_mini_3p8b", False, 12),
            ("recurrentgemma_2b", False, 2), ("recurrentgemma_2b", False, 5),
            ("recurrentgemma_2b", False, 10), ("tinyllama_1p1b", False, 8),
            ("tinyllama_1p1b", False, 16), ("qwen3_4b", False, 16),
            ("gemma3_12b", False, 16), ("pixtral_12b", False, 16),
            ("recurrentgemma_2b", True, 2), ("recurrentgemma_2b", True, 4),
            ("qwen3_4b", True, 2), ("qwen3_4b", True, 4),
            ("tinyllama_1p1b", True, 4), ("recurrentgemma_2b", False, 4),
            ("seamless_m4t_medium", False, 4), ("gemma3_12b", False, 32)]


@pytest.mark.parametrize("arch,smoke,model", ADMITTED,
                         ids=[f"{a}{'-smoke' * s}-{m}"
                              for a, s, m in ADMITTED])
def test_model_axis_admits_the_kv_head_split_and_the_rglru(arch, smoke,
                                                          model):
    """Each rank's share
    (``sharding.rank_heads``, which ``layers.heads`` gives the rank of a
    model axis) holds its cut of ``wq``, from
    ``off`` inside its first query head, and the KV heads those heads
    read; where M divides the heads, ``H / M`` heads from ``m H / M`` and
    ``max(Hkv / M, 1)`` KV heads (two where its heads straddle a KV
    group: phi4-mini's 2 of G 3 at M 12); where M does not divide ``wq``'s
    columns (recurrentgemma's 2560 at M 3), every head and every KV head.
    A vocabulary that M does not divide leaves the embedding
    replicated."""
    cfg = configs.get_config(arch, smoke=smoke)
    H, hd, G = cfg.n_heads, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    c = cfg.q_dim // model
    for m in range(model):
        sh = rank_heads(cfg, model, m)
        assert L.heads(cfg, types.SimpleNamespace(size=model, index=m)) \
            == sh
        if cfg.q_dim % model:
            assert sh == rank_heads(cfg)
            continue
        assert sh.q0 * hd + sh.off == m * c and 0 <= sh.off < hd
        assert (sh.q0 + sh.nq - 1) * hd < (m + 1) * c <= (sh.q0 + sh.nq) * hd
        heads = range(sh.q0, sh.q0 + sh.nq)
        assert sorted({h // G for h in heads}) == list(
            range(sh.kv0, sh.kv0 + sh.nkv))
        if H % model == 0:
            assert (sh.q0, sh.nq, sh.off) == (m * H // model, H // model, 0)
            if (H // model) % G == 0 or G % (H // model) == 0:
                assert sh.nkv == max(cfg.n_kv_heads // model, 1)
    dims = param_model_dims({"embed": types.SimpleNamespace(
        shape=(cfg.vocab, cfg.d_model))}, model)
    assert (dims["embed"] == -1) == (cfg.vocab % model != 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_is_admitted_at_every_model_axis_below_32(arch):
    """Each full config is placed at every M from 2 to 64 and at 128, 256
    and 512, the reference's fallbacks and the cuts inside a unit
    included: every leaf's dim divides by M (or the leaf is whole), and
    ``rank_heads`` gives every head on every rank exactly where M does not
    divide ``wq``'s columns; RWKV-6's ranks' columns cover ``d_model``
    once, each inside the heads it meets."""
    cfg, _, ours = _shapes(arch)
    for model in list(range(2, 65)) + [128, 256, 512]:
        dims = param_model_dims(ours, model, cfg)
        for t, d in zip(tree_leaves(ours), tree_leaves(dims)):
            assert d == -1 or d == RUN_DIM or t.shape[d] % model == 0, model
        assert (rank_heads(cfg, model, model - 1) == rank_heads(cfg)) == \
            (cfg.q_dim % model != 0), model
        if "rwkv6" in cfg.pattern:
            hd, cols = cfg.rwkv_head_dim, []
            for m in range(model):
                sh = rwkv_heads(cfg, model, m)
                assert sh.off + sh.cols <= sh.nh * hd and sh.off < hd
                cols += range(sh.h0 * hd + sh.off,
                              sh.h0 * hd + sh.off + sh.cols)
            assert cols == list(range(cfg.d_model)) * (
                1 if cfg.d_model % model == 0 else model)


def test_a_gradient_through_the_model_axis_is_refused():
    """Training on a model axis is ported for every family and every cut
    (``tests/test_torch_tp_train.py``, ``tests/test_torch_tp_train_moe.py``,
    ``tests/test_torch_tp_families.py``, ``tests/test_torch_tp_rglru.py``,
    ``tests/test_torch_tp_fallback.py``, ``tests/test_torch_tp_inside.py``);
    the forward of the cuts inside a unit, once refused, runs on a
    stand-in axis (a ``DryAxis``: its collectives keep their shapes and
    move no data): RWKV-6's smoke config, 4 heads of 16 columns, at M 8;
    olmoe's 4 experts of 32 features at M 8; tinyllama's untied head over
    510 rows at M 4, its 64 rows cut; each a rank's hidden states of the
    whole model's shape, with the collectives of the cut made."""
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    for arch, kw, model in (("rwkv6_1p6b", {}, 8), ("olmoe_1b_7b", {}, 8),
                            ("tinyllama_1p1b", dict(vocab=510), 4)):
        cfg = dataclasses.replace(configs.get_config(arch, smoke=True), **kw)
        params = T.init_model(cfg, device="cpu", model=model, m=1)
        tp = DryAxis("model", list(range(model)), 1)
        x = T.trunk_fwd(params, cfg, toks, tp)
        assert x.shape == (1, 4, cfg.d_model)
        kinds = [r["kind"] for r in tp.records]
        assert "all-gather" in kinds or arch == "tinyllama_1p1b"
        if arch == "tinyllama_1p1b":
            n = len(tp.records)
            assert T.model_fwd(params, cfg, toks, tp).shape == \
                (1, 4, cfg.vocab)
            assert tp.records[-1]["kind"] == "all-reduce" and \
                tp.records[-1]["bytes"] == 4 * cfg.vocab * 4
            assert len(tp.records) == 2 * n + 1


def test_parse_mesh_gives_the_model_axis_and_dp_names_are_the_reference():
    assert parse_mesh("2x4x8") == (2, 4, 8)
    with pytest.raises(ValueError):
        parse_mesh("1x0x2")
    # the reference names the axes a mesh has: "pod" only on a multi-pod
    # mesh (make_production_mesh)
    for pods, mesh in ((1, jax.make_mesh((1, 1), ("data", "model"))),
                       (2, jax.make_mesh((1, 1, 1),
                                         ("pod", "data", "model")))):
        assert dp_axes(pods) == JS.dp_axes(mesh)
        assert batch_pspec(pods) == tuple(JS.batch_pspec(mesh))


@pytest.mark.parametrize("pods,data,model", [
    (1, 1, 4), (1, 2, 2), (2, 2, 2), (2, 1, 4), (3, 2, 2)])
def test_model_groups_are_innermost_and_never_span_a_pod(pods, data,
                                                          model):
    """rank = (pod * data + d) * model + m: a model group is M
    neighbouring ranks of one (pod, data) cell; the fast, slow and dp
    groups hold the ranks of one m, as the reference's mesh places its
    innermost ``model`` axis (``mesh_topology``'s strata)."""
    groups = grid_groups(pods, data, model)
    topo = grid_topology(Grid.shape_only(pods, data, model),
                         ["dcn", "host", "local"])
    pod_of = topo.coords[:, 0]
    cell_of = topo.coords[:, 1]
    assert groups["tp"] == [list(range(c * model, (c + 1) * model))
                            for c in range(pods * data)]
    for g in groups["tp"]:
        assert len({pod_of[r] for r in g}) == 1
        assert len({cell_of[r] for r in g}) == 1
    for kind, size in (("fast", data), ("slow", pods), ("dp", pods * data)):
        assert all(len(g) == size for g in groups[kind])
        for g in groups[kind]:
            assert len({r % model for r in g}) == 1
    for g in groups["fast"]:
        assert len({pod_of[r] for r in g}) == 1
    every = sorted(r for g in groups["tp"] for r in g)
    assert every == list(range(pods * data * model))
    shape = Grid.shape_only(pods, data, model)
    assert (shape.world, shape.model) == (pods * data, model)
    assert (shape.tp is None) == (model == 1)


@pytest.mark.parametrize("model", [2, 4])
def test_stacked_shard_of_a_sharded_init_is_the_shard_of_the_stacked(model):
    """``stack_runs(init_model(model=, m=), cfg, model, m)``, the train
    driver's start on a model axis, is ``shard_params`` of the whole
    model's stacked layout, bit for bit: the RG-LRU's ``w_out``, whole in
    a per-layer shard, holds the rank's layers of its run at M 2."""
    cfg = configs.get_config("recurrentgemma_2b", smoke=True)
    full = stack_runs(T.init_model(cfg, seed=5, device="cpu"), cfg)
    for m in range(model):
        got = stack_runs(T.init_model(cfg, seed=5, device="cpu",
                                      model=model, m=m), cfg, model, m)
        want = shard_params(full, cfg, model, m)
        assert got["runs"][0]["rec"]["w_out"].shape[0] == {2: 1, 4: 2}[model]
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)
