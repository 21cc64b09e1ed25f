"""The paper's multilevel all-reduce over the process groups of a rank grid.

Counterpart of ``repro/core/collectives.py``.  The reference's axis names
become the ``Axis`` objects of a ``launch.mesh.Grid``: ``fast`` (the ranks
of one pod, the reference's ``data``), ``slow`` (one rank per pod,
``pod``; None for one pod) and ``dp`` (all ranks).  For a data-parallel
gradient all-reduce:

  flat        :  dp.psum(g)                     # |g| bytes cross pods
  multilevel  :  s = fast.psum_scatter(g)       # inside the pod
                 s = slow.psum(s)               # |g|/|data| bytes cross
                 g = fast.all_gather(s)         # inside the pod

and ``multilevel_compress`` sends the slow hop as int8 + scales
(``compression.compressed_psum``).  Each function runs on every rank of
the grid, as the reference's run inside ``shard_map``.  The reference
takes a sequence of fast axes; the grid has one.
"""
from __future__ import annotations

from typing import Any

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten
from . import compression
from .engine import partition_buckets

__all__ = ["flat_psum", "multilevel_psum", "multilevel_psum_tree",
           "bucketed_psum_tree", "compress_ef_zeros", "flatten_tree",
           "unflatten_tree"]


def flat_psum(x: torch.Tensor, dp) -> torch.Tensor:
    """Topology-unaware baseline: one all-reduce over every rank."""
    return dp.psum(x)


def multilevel_psum(x: torch.Tensor, slow, fast, compress_slow: bool = False,
                    ef: torch.Tensor | None = None):
    """Multilevel all-reduce of a 1-D buffer whose length divides by the
    fast axis: reduce-scatter in the pod, the (optionally int8) exchange
    across pods, all-gather in the pod.

    ``ef``, the residual of the compressed slow hop, matches the
    post-reduce-scatter shard and makes the call return ``(result,
    new_ef)``; the uncompressed path returns it unchanged."""
    if x.dim() != 1:
        raise ValueError("multilevel_psum operates on flat 1-D buffers")
    x = fast.psum_scatter(x)
    new_ef = ef
    if slow is not None:
        if compress_slow and ef is not None:
            x, new_ef = compression.compressed_psum(x, slow, ef=ef)
        elif compress_slow:
            x = compression.compressed_psum(x, slow)
        else:
            x = slow.psum(x)
    x = fast.all_gather(x)
    return x if ef is None else (x, new_ef)


def compress_ef_zeros(grads: Any, fast_degree: int,
                      tile: int = 1) -> torch.Tensor:
    """Zero error-feedback residual for ``multilevel_psum_tree(...,
    mode="multilevel_compress", ef=...)``: this rank's post-reduce-scatter
    shard of the fused flat buffer, rounded up to a multiple of ``tile``
    (``compression.QTILE`` keeps the kernel path pad-free)."""
    leaves = tree_leaves(grads)
    total = sum(l.numel() for l in leaves)
    fd = max(fast_degree, 1)
    padded = total + (-total) % (fd * max(tile, 1))
    return torch.zeros((padded // fd,), dtype=torch.float32,
                       device=leaves[0].device)


def flatten_tree(tree: Any, pad_multiple: int):
    """Ravel + concat all leaves as f32 and zero-pad to a multiple.
    Returns (flat, spec) for :func:`unflatten_tree`."""
    leaves = tree_leaves(tree)
    flat = torch.cat([l.reshape(-1).float() for l in leaves])
    pad = (-flat.numel()) % pad_multiple
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, (tree, [l.shape for l in leaves], [l.dtype for l in leaves],
                  [l.numel() for l in leaves], pad)


def unflatten_tree(flat: torch.Tensor, spec: Any) -> Any:
    like, shapes, dtypes, sizes, pad = spec
    if pad:
        flat = flat[:flat.numel() - pad]
    out, off = [], 0
    for shape, dtype, size in zip(shapes, dtypes, sizes):
        out.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    return tree_unflatten(like, out)


def multilevel_psum_tree(grads: Any, grid, mode: str = "multilevel",
                         mean_over: int | None = None,
                         ef: torch.Tensor | None = None) -> Any:
    """All-reduce a gradient tree over the ``grid``'s ranks.

    mode: "flat" (each leaf over ``dp``) | "multilevel" |
    "multilevel_compress" (all leaves fused into one flat f32 buffer).
    ``mean_over`` divides the result; ``ef`` (see
    :func:`compress_ef_zeros`) makes the call return ``(grads, new_ef)``."""
    new_ef = ef
    if mode == "flat":
        out = tree_map(grid.dp.psum, grads)
    else:
        pad_mult = grid.fast.size
        flat, spec = flatten_tree(grads, pad_mult)
        if ef is not None:
            # the residual's size defines the shard: grow the flat buffer
            # to match and fold the extra zeros into the spec's pad
            want = ef.numel() * pad_mult
            if flat.numel() > want:
                raise ValueError(
                    f"ef residual too small for this tree: shard is "
                    f"{ef.numel()} elements but the padded flat buffer "
                    f"needs {flat.numel() // pad_mult} (see "
                    f"compress_ef_zeros)")
            if flat.numel() < want:
                extra = want - flat.numel()
                flat = torch.nn.functional.pad(flat, (0, extra))
                spec = spec[:4] + (spec[4] + extra,)
        flat = multilevel_psum(flat, grid.slow, grid.fast,
                               compress_slow=mode == "multilevel_compress",
                               ef=ef)
        if ef is not None:
            flat, new_ef = flat
        out = unflatten_tree(flat, spec)
    if mean_over:
        out = tree_map(lambda g: g / mean_over, out)
    return out if ef is None else (out, new_ef)


def bucketed_psum_tree(grads: Any, grid, *, bucket_bytes: float,
                       mode: str = "multilevel",
                       mean_over: int | None = None) -> Any:
    """All-reduce a gradient tree as size-targeted buckets: leaves in
    reverse order (the order backward produces them), greedily grouped
    into buckets of at least ``bucket_bytes`` f32 bytes, each synced as one
    fused flat buffer.  mode "flat" | "multilevel", numerics as
    :func:`multilevel_psum_tree`; the compressed mode is refused (its EF
    residual is shaped by the exchange)."""
    if mode not in ("flat", "multilevel"):
        raise ValueError(f"bucketed sync supports modes 'flat'/'multilevel',"
                         f" got {mode!r}")
    leaves = tree_leaves(grads)
    buckets = partition_buckets([4.0 * l.numel() for l in leaves],
                                float(bucket_bytes))
    pad_mult = grid.fast.size if mode == "multilevel" else 1
    out: list[Any] = [None] * len(leaves)
    for idx in buckets:
        flat, spec = flatten_tree([leaves[i] for i in idx], pad_mult)
        if mode == "flat":
            flat = grid.dp.psum(flat)
        else:
            flat = multilevel_psum(flat, grid.slow, grid.fast)
        for i, leaf in zip(idx, unflatten_tree(flat, spec)):
            out[i] = leaf
    res = tree_unflatten(grads, out)
    if mean_over:
        res = tree_map(lambda g: g / mean_over, res)
    return res
