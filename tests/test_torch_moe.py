"""The port's dense MoE against ``repro.models.layers`` on the same inputs:
the leaves of ``init_moe``, the routing (the top-k expert ids, the stable
dispatch order and the group sizes), ``moe_fwd`` with and without token
blocks, and llama4-scout's shared expert.

Weights come from the reference's ``init_moe`` and inputs from numpy with
a seed.  Tolerances are ``test_torch_layers``': f32 1e-5 relative and
absolute (the per-expert products sum in another order than
``lax.ragged_dot``); bf16 2e-2 absolute plus 2e-2 relative, the bf16
tolerance of the JAX tests (each product and ``silu(g) * h`` round to
bf16, and the frameworks may round a value to the neighbouring number).
The routing is compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from _torch_bridge import as_f32, cast_tree, to_torch
from repro.configs import get_config
from repro.models import layers as JL
from repro_torch.models import layers as L

KEY = jax.random.PRNGKey(3)
DTYPES = ["float32", "bfloat16"]
ARCHS = ["olmoe_1b_7b", "llama4_scout_17b_a16e"]


def _close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _moe(arch, dtype):
    cfg = get_config(arch, smoke=True)
    jp = cast_tree(JL.init_moe(KEY, cfg), getattr(jnp, dtype))
    return cfg, jp, to_torch(jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_leaves_match_reference(arch):
    """Leaf names, shapes and dtypes: router f32, experts bf16, and the
    shared MLP where the config has one."""
    cfg = get_config(arch, smoke=True)
    ours = L.init_moe(torch.Generator().manual_seed(0), cfg)
    ref = JL.init_moe(KEY, cfg)
    assert ("shared" in ours) == cfg.moe.shared_expert == ("shared" in ref)
    o, r = _flat(ours), _flat(ref)
    assert set(o) == set(r)
    for name, a in o.items():
        assert tuple(a.shape) == r[name].shape, name
        assert str(a.dtype) == f"torch.{r[name].dtype}", name
    # the router's values are bf16 numbers, as the reference's
    rt = ours["router"]
    assert torch.equal(rt, rt.to(torch.bfloat16).float())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_reference(arch, dtype):
    """The top-k expert ids of every token, the stable sort's dispatch
    order and the group sizes equal the reference's; the renormalised
    gates agree within the layer tolerance."""
    cfg, jp, tp = _moe(arch, dtype)
    m = cfg.moe
    jx, tx = _x((24, cfg.d_model), dtype)

    @jax.jit
    def ref(p, xt):
        logits = xt.astype(jnp.float32) @ p["router"]
        gates, eidx = lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
        gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
        flat_e = eidx.reshape(-1)
        return (gates, eidx, jnp.argsort(flat_e),
                jnp.bincount(flat_e, length=m.n_experts))

    jg, je, jorder, jsizes = ref(jp, jx)
    gates, order, sizes = L._moe_route(tp, m, tx)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert sizes == np.asarray(jsizes).tolist()
    # the expert ids, recovered from the dispatch: slot order[j] goes to
    # the expert whose group holds position j
    eidx = torch.empty_like(order)
    eidx[order] = torch.repeat_interleave(torch.arange(m.n_experts),
                                          torch.tensor(sizes))
    np.testing.assert_array_equal(eidx.reshape(-1, m.top_k).numpy(),
                                  np.asarray(je))
    _close(gates, jg, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_fwd_matches_reference(arch, dtype):
    """``moe_fwd`` on (2, 6, D): the routed sum, and for llama4-scout the
    shared expert added after it."""
    cfg, jp, tp = _moe(arch, dtype)
    jx, tx = _x((2, 6, cfg.d_model), dtype)
    want = jax.jit(lambda p, x: JL.moe_fwd(p, cfg, x))(jp, jx)
    got = L.moe_fwd(tp, cfg, tx)
    assert got.dtype == getattr(torch, dtype) and got.shape == tx.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_token_blocks(arch, dtype):
    """T a multiple of ``chunk`` and above it: blocks of ``chunk`` tokens,
    one host read of the group sizes each, against the reference's
    scanned blocks and against the port's single block."""
    cfg, jp, tp = _moe(arch, dtype)
    jx, tx = _x((2, 8, cfg.d_model), dtype, seed=1)
    want = jax.jit(lambda p, x: JL.moe_fwd(p, cfg, x, chunk=4))(jp, jx)
    n0 = L.moe_fwd.host_syncs
    blocks = L.moe_fwd(tp, cfg, tx, chunk=4)
    assert L.moe_fwd.host_syncs - n0 == 4
    whole = L.moe_fwd(tp, cfg, tx)
    assert L.moe_fwd.host_syncs - n0 == 5
    _close(blocks, want, dtype)
    # a token's experts and products do not depend on the block it is in
    torch.testing.assert_close(blocks, whole, atol=1e-6, rtol=1e-6)
    # not a multiple of the chunk: one block, as the reference
    n0 = L.moe_fwd.host_syncs
    L.moe_fwd(tp, cfg, tx, chunk=5)
    assert L.moe_fwd.host_syncs - n0 == 1


def test_moe_skips_empty_experts():
    """A token block that routes to few experts computes only those: the
    result still equals the reference's where most groups are empty."""
    cfg, jp, tp = _moe("olmoe_1b_7b", "float32")
    jx, tx = _x((1, 1, cfg.d_model), "float32", seed=2)
    sizes = L._moe_route(tp, cfg.moe, tx[0])[2]
    assert sizes.count(0) == cfg.moe.n_experts - cfg.moe.top_k
    want = jax.jit(lambda p, x: JL.moe_fwd(p, cfg, x))(jp, jx)
    _close(L.moe_fwd(tp, cfg, tx), want, "float32")
