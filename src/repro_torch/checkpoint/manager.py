"""Checkpointing with atomic commits and an async writer thread.

Copy of ``repro/checkpoint/manager.py`` without jax or ``ml_dtypes``,
always writing asynchronously, and keeping each write's bytes and seconds
(``writes``).

Layout:  <dir>/step_<N>/   one .npy per leaf + manifest.json
Commit protocol: write into ``step_<N>.tmp``, fsync, atomic rename — a crash
mid-write can never corrupt the latest durable checkpoint (restore scans for
the newest *committed* directory).  ``keep`` bounds disk usage.

Leaves are torch tensors or numpy arrays; a numpy ``uint16`` leaf is a bf16
bit pattern, the port's convention at the numpy boundary
(``models/convert.py``).  bf16 is stored as those bits with ``bfloat16`` in
the manifest, so a save and restore is bit-exact.  Leaf files are named by
their tree paths as the reference names them, so either package restores
the other's checkpoints of the same tree.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..tree import tree_map, tree_paths, tree_unflatten

__all__ = ["CheckpointManager"]


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host (bf16 as uint16 bits), a copy
    of it: the train step updates its state in place, and the writer reads
    the snapshot after the next step has begun."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
        if leaf.device.type == "cpu":       # .cpu() made no copy
            a = a.copy()
        return a.view(np.uint16) if leaf.dtype == torch.bfloat16 else a
    return np.asarray(leaf)


def _dtype_str(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.uint16 else str(arr.dtype)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        # each finished write: step, bytes on disk, seconds of the write
        self.writes: list[dict] = []

    # ------------------------------------------------------------------ #
    def save(self, step: int, state: Any) -> None:
        """Snapshot to host memory synchronously (consistent point), write
        to disk asynchronously (``wait`` joins the writer)."""
        host_state = tree_map(_host, state)  # device -> host copy
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host_state), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_state: Any) -> None:
        t0 = time.monotonic()
        final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for name, arr in tree_paths(host_state):
            fn = f"{name}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][fn] = {"shape": list(arr.shape),
                                      "dtype": _dtype_str(arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()
        self.writes.append({"step": step, "bytes": sum(
            a.nbytes for _, a in tree_paths(host_state)),
            "s": time.monotonic() - t0})

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------ #
    def list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.directory, d,
                                                    "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Load checkpoint ``step`` into the structure of ``like``: numpy
        arrays, bf16 leaves as uint16 bits."""
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        for name, leaf in tree_paths(like):
            arr = np.load(os.path.join(d, f"{name}.npy"))
            if manifest["leaves"][f"{name}.npy"]["dtype"] == "bfloat16":
                arr = arr.view(np.uint16)
            if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {leaf.shape}")
            leaves.append(arr)
        return tree_unflatten(like, leaves)
