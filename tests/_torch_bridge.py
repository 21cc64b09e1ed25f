"""Move arrays between the JAX package and the PyTorch port through numpy,
and run the reference per rank of a (pod, data) grid.

bf16 crosses as its uint16 bit pattern (numpy has no bf16), so values
arrive bit for bit.  TF32 is switched off for the port's f32 products, so
a reference check never runs at TF32 precision.
"""
import jax
import jax.numpy as jnp
from jax import lax
import numpy as np
import torch

from repro.optim.adamw import scatter_axes

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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


def as_f32(x):
    """Either framework's array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def cast_tree(tree, dtype):
    """Every floating leaf of a JAX tree cast to ``dtype``."""
    return jax.tree.map(lambda a: a.astype(dtype), tree)


def vmap_ranks(fn):
    """``fn`` per rank of a (pod, data) grid: inputs lead with (pods,
    data) dims, and the collectives see axes "pod" and "data"."""
    return jax.vmap(jax.vmap(fn, axis_name="data"), axis_name="pod")


def rank_opt(opt, params, cfg, pods, data):
    """The reference's global opt state cut per rank, stacked (pods, data,
    ...) for the vmap: the shard_map in-specs of ``opt_manual_specs``."""
    axes = scatter_axes(params, data)

    def cut(a, ax, d, lead=0):
        if ax is None:
            return a
        n = a.shape[ax + lead] // data
        return lax.slice_in_dim(a, d * n, (d + 1) * n, axis=ax + lead)

    def per_rank(p, d):
        o = dict(opt)
        if cfg.sharded_state:
            for k in ("m", "v", "master"):
                o[k] = jax.tree.map(lambda a, ax: cut(a, ax, d), opt[k], axes)
        if cfg.error_feedback:
            o["ef"] = jax.tree.map(lambda a, ax: cut(a[p:p + 1], ax, d, 1),
                                   opt["ef"], axes)
        return o
    rows = [[per_rank(p, d) for d in range(data)] for p in range(pods)]
    return jax.tree.map(lambda *a: jnp.stack(a).reshape(
        (pods, data) + a[0].shape), *[r for row in rows for r in row])
