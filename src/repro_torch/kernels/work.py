"""The work counter: the FLOPs and HBM bytes of every op a program runs,
each hand-written kernel counted by its own work, and the peak of the
bytes the program holds.

:class:`WorkCounter` is a ``TorchDispatchMode``: every aten op that runs
under it, autograd's backward included, adds its FLOPs (the formulas of
``torch.utils.flop_counter``, which ``FlopCounterMode`` uses: products,
convolutions, attention; elementwise ops count none) and its bytes (each
tensor input read once, each output written once; a view or an
allocation moves none).  A collective runs under :func:`quiet`
(``launch.mesh.Axis``): its bytes go on the wire, which the census
counts (``launch.census``).  A kernel wrapper calls :func:`count` with the
kernel's work (``fwd_work``, ``quant.work``, ``wkv.work``) on every
device while a counter is active, and runs its plain version (on a CPU
tensor) or makes its outputs (on a ``meta`` tensor) under :func:`quiet`,
which the counter does not see: so the FLOPs are the kernel's, whatever
computes them, and a ``meta`` run counts what the card would.

With ``track_memory`` the counter also keeps the live bytes: each
storage once (views share one), added when an op makes it or
:meth:`WorkCounter.hold` registers it, dropped when it is freed.  A
``meta`` storage has no address, so a storage is known by its Python
object, which lives as long as the storage does.

On ``meta`` tensors most ops' shape functions are Python, slow beside
the op they stand for (a step of RWKV-6 differentiates a scan of
thousands of small ops).  A functional op (one that neither mutates nor
returns a view) gives outputs whose shapes, strides and dtypes follow
from its inputs' and its other arguments alone, so the counter keeps them
with the op's FLOPs and bytes, and the next call with the same signature
gets fresh empty tensors of those, without the shape function.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["WorkCounter", "count", "quiet"]

_aten = torch.ops.aten
# ops that allocate and move no bytes
_ALLOC = {_aten.empty.memory_format, _aten.empty_strided.default,
          _aten.empty_like.default, _aten.new_empty.default,
          _aten.new_empty_strided.default}

_STACK: list["WorkCounter"] = []     # active counters, innermost last
_QUIET = [0]                         # depth of quiet() regions
_FUNCTIONAL: dict = {}               # op -> neither mutates nor aliases


def _functional(func) -> bool:
    ok = _FUNCTIONAL.get(func)
    if ok is None:
        sch = func._schema
        ok = _FUNCTIONAL[func] = not sch.is_mutable and all(
            r.alias_info is None for r in sch.returns) and bool(sch.returns)
    return ok


def _sig(a):
    """A hashable signature of an op argument: a tensor by its metadata,
    a sequence by its items; None where it holds a non-meta tensor."""
    if isinstance(a, torch.Tensor):
        if not a.is_meta:
            return None
        return (a.shape, a.stride(), a.dtype)   # the offset moves nothing
    if isinstance(a, (list, tuple)):
        out = tuple(_sig(x) for x in a)
        return None if None in out and any(
            isinstance(x, torch.Tensor) for x in a) else (type(a), out)
    return type(a), a           # 1, 1.0 and True are equal keys otherwise


class WorkCounter(TorchDispatchMode):
    """Counts ``flops``, ``bytes`` and, per kernel, ``kernels[name] =
    {"launches", "flops", "bytes"}`` of what runs under it; with
    ``track_memory``, ``live_bytes`` and ``peak_bytes``."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: dict[str, dict] = {}
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()
        self._memo: dict = {}

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        return super().__exit__(*exc)

    def hold(self, *trees) -> int:
        """Track the storages of the tensors in ``trees`` (made before the
        counter: parameters, optimiser state, a batch, a cache); returns
        the bytes newly tracked."""
        return sum(self._track(t) for t in tree_leaves(trees)
                   if isinstance(t, torch.Tensor))

    def exclude(self, *trees) -> None:
        """Never count the storages of the tensors in ``trees``: memory the
        card does not hold (a host batch the step takes its rows of)."""
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor):
                self._seen[t.untyped_storage()] = 0

    def _track(self, t: torch.Tensor) -> int:
        if not self.track_memory:
            return 0
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        nbytes = st.nbytes()
        self._seen[st] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, nbytes)
        return nbytes

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _QUIET[0]:
            return func(*args, **kwargs)
        key = None
        if _functional(func):
            key = _sig((func, args, tuple(sorted(kwargs.items()))))
            hit = self._memo.get(key) if key is not None else None
            if hit is not None:
                specs, tree, flops, nbytes = hit
                outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                        for sh, st, dt in specs]
                out = tree_unflatten(outs, tree)
                self._count(flops, nbytes, outs)
                return out
        out = func(*args, **kwargs)
        flop = flop_registry.get(func._overloadpacket)
        flops = flop(*args, **kwargs, out_val=out) if flop else 0
        leaves, tree = tree_flatten(out)
        outs = [t for t in leaves if isinstance(t, torch.Tensor)]
        nbytes = 0
        if func not in _ALLOC and not func.is_view:
            nbytes = sum(t.nbytes for t in tree_leaves((args, kwargs))
                         if isinstance(t, torch.Tensor)) \
                + sum(t.nbytes for t in outs)
        if key is not None and len(outs) == len(leaves) and all(
                t.is_meta for t in outs):
            self._memo[key] = ([(t.shape, t.stride(), t.dtype)
                                for t in outs], tree, flops, nbytes)
        self._count(flops, nbytes, outs)
        return out

    def _count(self, flops, nbytes, outs) -> None:
        self.flops += flops
        self.bytes += nbytes
        for t in outs:
            self._track(t)


@contextlib.contextmanager
def quiet():
    """A region no counter sees: a kernel's plain version, or its outputs
    made on ``meta``."""
    _QUIET[0] += 1
    try:
        yield
    finally:
        _QUIET[0] -= 1


def count(name: str, flops: float, nbytes: float, *outs) -> None:
    """One launch of kernel ``name`` doing ``flops`` and moving
    ``nbytes``, whose outputs are ``outs``, on every active counter."""
    for c in _STACK:
        k = c.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                        "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        c.flops += flops
        c.bytes += nbytes
        for t in outs:
            if isinstance(t, torch.Tensor):
                c._track(t)
