"""Move arrays between the JAX package and the PyTorch port through numpy,
run the reference per rank of a (pod, data) or (pod, data, model) grid,
run its encoder on an f32 model, and fork the port's ranks from one
server (``forked_ranks``, a fixture for the modules that start ranks).

bf16 crosses as its uint16 bit pattern (numpy has no bf16), so values
arrive bit for bit.  TF32 is switched off for the port's f32 products, so
a reference check never runs at TF32 precision.
"""
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.optim.adamw import scatter_axes

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def forked_ranks():
    """Autouse in every test module that imports it: the ranks that its
    tests start (``run_ranks``, and ``train`` or ``serve`` on a grid) fork
    from one preloaded server (``_torch_ranks.fork_ranks``)."""
    _torch_ranks.fork_ranks()


def jax_to_numpy(tree):
    """JAX tree -> numpy tree, bf16 leaves as uint16 bits."""
    def leaf(a):
        if a.dtype == jnp.bfloat16:
            return np.asarray(jax.lax.bitcast_convert_type(a, jnp.uint16))
        return np.asarray(a)
    return jax.tree.map(leaf, tree)


def numpy_to_torch(tree):
    """numpy tree (bf16 as uint16 bits) -> torch tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: numpy_to_torch(v) for k, v in tree.items()}
    a = np.array(tree)       # a writable copy
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_torch(tree):
    return numpy_to_torch(jax_to_numpy(tree))


def ref_encoder_f32(params, cfg, src_embeds):
    """The reference's ``encoder_fwd`` for an f32 enc-dec model: its bf16
    input promoted to f32 before its layer scan (``_run_fwd``), whose
    carry must keep one dtype, as the port's encoder promotes it.  Tests
    set it in place of ``repro.models.transformer.encoder_fwd``, which
    refuses an f32 model."""
    from repro.models import layers as JL
    from repro.models import transformer as JT
    x = src_embeds.astype(jnp.bfloat16).astype(jnp.float32)
    for stacked in params["enc"]["runs"]:
        x = JT._run_fwd(stacked, cfg, "attn", x, None, causal=False)
    return JL.rmsnorm(x, params["enc"]["final_norm"])


def as_f32(x):
    """Either framework's array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def cast_tree(tree, dtype):
    """Every floating leaf of a JAX tree cast to ``dtype``."""
    return jax.tree.map(lambda a: a.astype(dtype), tree)


def vmap_ranks(fn, model: bool = False):
    """``fn`` per rank of a (pod, data) grid: inputs lead with (pods,
    data) dims, and the collectives see axes "pod" and "data"; with
    ``model``, of a (pod, data, model) grid, inputs leading with (pods,
    data, model) and a third axis "model"."""
    if model:
        fn = jax.vmap(fn, axis_name="model")
    return jax.vmap(jax.vmap(fn, axis_name="data"), axis_name="pod")


def model_cut(a, dim, model, m, lead=0):
    """Rank ``m``'s slice of ``a`` along its model dim ``dim`` (after
    ``lead`` leading dims; ``dim`` < 0: replicated, ``a`` itself)."""
    if dim < 0:
        return a
    n = a.shape[dim + lead] // model
    return lax.slice_in_dim(a, m * n, (m + 1) * n, axis=dim + lead)


def ref_cut(tree, specs, model, m):
    """Rank ``m``'s slice of each leaf of ``tree`` (numpy) along the dim
    its PartitionSpec in ``specs`` gives ``"model"``."""
    def cut(a, spec):
        for i, s in enumerate(spec):
            if s == "model":
                n = a.shape[i] // model
                return np.take(a, np.arange(m * n, (m + 1) * n), axis=i)
        return a
    return jax.tree.map(cut, tree, specs,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))


def rank_opt(opt, params, cfg, pods, data, model=1, mdims=None):
    """The reference's global opt state cut per rank, stacked (pods, data,
    ...) for the vmap: the shard_map in-specs of ``opt_manual_specs``.
    With ``model`` > 1, each rank's model shard first (``mdims``, the
    reference's ``model_dims_of``; the EF rows' leading dim shifts it),
    stacked (pods, data, model, ...); the scatter axes are decided on the
    model shards, as the reference's update decides them."""
    if mdims is None:
        mdims = jax.tree.map(lambda _: -1, params)
    local = jax.tree.map(lambda a, md: model_cut(a, md, model, 0), params,
                         mdims)
    axes = scatter_axes(local, data, mdims)

    def cut(a, ax, d, lead=0):
        if ax is None:
            return a
        n = a.shape[ax + lead] // data
        return lax.slice_in_dim(a, d * n, (d + 1) * n, axis=ax + lead)

    def per_rank(p, d, m):
        mc = lambda t, lead=0: jax.tree.map(
            lambda a, md: model_cut(a, md, model, m, lead), t, mdims)
        o = dict(opt)
        for k in ("m", "v", "master"):
            o[k] = mc(opt[k])
            if cfg.sharded_state:
                o[k] = jax.tree.map(lambda a, ax: cut(a, ax, d), o[k], axes)
        if cfg.error_feedback:
            o["ef"] = jax.tree.map(lambda a, ax: cut(a[p:p + 1], ax, d, 1),
                                   mc(opt["ef"], 1), axes)
        return o
    ranks = [per_rank(p, d, m) for p in range(pods) for d in range(data)
             for m in range(model)]
    lead = (pods, data) if model == 1 else (pods, data, model)
    return jax.tree.map(lambda *a: jnp.stack(a).reshape(lead + a[0].shape),
                        *ranks)
