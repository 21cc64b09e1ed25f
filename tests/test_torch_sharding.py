"""The model axis's placement in the port against ``repro.models.sharding``
and ``repro.launch.mesh``: which dim of each parameter a model axis shards
(exactly the reference's ``param_pspecs``, all 11 configs at their full
shapes), the cut and its inverse, the sharded init, the refusals, and the
rank grid's groups (the model group innermost, never across a pod).
"""
import dataclasses
import functools

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
from repro_torch.models import transformer as T
from repro_torch.models.convert import shard_params, unshard_params
from repro_torch.models.sharding import (RUN_DIM, batch_pspec, dp_axes,
                                         param_model_dims, tp_check)
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


@pytest.mark.parametrize("model", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_model_dims_equal_reference_pspecs(arch, model):
    """The dim of every leaf, decided on the full config's shapes, is the
    reference's, its fallbacks and the MoE/RG-LRU ``w_gate`` split
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
    ("gemma3_12b", 2), (LLAMA4_KV4, 2)])
def test_sharded_init_is_the_shard_of_the_full_init(name, model):
    """``init_model(model=, m=)`` cuts each layer as it is drawn: the same
    numbers as ``shard_params`` of the whole model, bit for bit."""
    cfg = _tp_config(name)
    full = T.init_model(cfg, seed=5, device="cpu")
    for m in range(model):
        got = T.init_model(cfg, seed=5, device="cpu", model=model, m=m)
        want = shard_params(full, cfg, model, m)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch,model,match", [
    ("rwkv6_1p6b", 64, "32 heads"),
    ("recurrentgemma_2b", 2, "recurrent and enc-dec families"),
    ("seamless_m4t_medium", 4, "vocabulary rows"),
    ("tinyllama_1p1b", 8, "4 KV heads"),
    ("gemma3_12b", 32, "16 heads"),
    ("olmoe_1b_7b", 128, "64 experts"),
])
def test_model_axis_refusals_name_roadmap_item_5(arch, model, match):
    with pytest.raises(NotImplementedError, match="Queue 1 item 5") as e:
        tp_check(configs.get_config(arch), model)
    assert match in str(e.value)


def test_a_gradient_through_the_model_axis_is_refused():
    """Training on a model axis is ported for the attention stacks, with
    an MLP or a MoE (``tests/test_torch_tp_train.py``,
    ``tests/test_torch_tp_train_moe.py``), RWKV-6 and enc-dec
    (``tests/test_torch_tp_families.py``); the forward with a model axis
    still refuses autograd where the axis does not divide the config's KV
    heads (qwen3's smoke config has one) and for RG-LRU, naming the item
    that brings them."""
    import types

    tp = types.SimpleNamespace(size=2, index=0)
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    for arch in ("qwen3_4b", "recurrentgemma_2b"):
        cfg = configs.get_config(arch, smoke=True)
        params = T.init_model(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            T.trunk_fwd(params, cfg, toks, tp)


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
