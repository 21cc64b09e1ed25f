"""Move arrays between the JAX package and the PyTorch port through numpy.

bf16 crosses as its uint16 bit pattern (numpy has no bf16), so values
arrive bit for bit.  TF32 is switched off for the port's f32 products, so
a reference check never runs at TF32 precision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

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
