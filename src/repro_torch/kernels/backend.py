"""Device checks and the build of the hand-written CUDA kernels.

Counterpart of ``repro/kernels/backend.py``, which decides between Pallas
interpret mode and a TPU compile.  Here the decision is by tensor: a CPU
tensor takes a kernel's plain PyTorch version, a CUDA tensor takes the
kernel, which needs a Hopper card (compute capability 9.0) because it is
compiled for ``sm_90a`` only.  A ``meta`` tensor, which holds no data, is
the dry run's (``launch.dryrun``): it takes the path the card takes
(:func:`on_card`), and a wrapper gives it outputs of the kernel's shapes
and counts the kernel's work, launching and building nothing.

Kernels live in ``csrc/<name>.cu`` with a plain C interface; building
blocks shared between sources live in ``csrc/*.cuh``.  They are compiled
with ``nvcc`` at first use into ``build/`` next to this file (a directory
git ignores), one shared library per source, named by a hash of the
source, every header and the flags so an edited source or header is never
served stale, and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD", "NVCC_FLAGS", "resolve_device", "on_card",
           "on_hopper", "build", "sass", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
# --split-compile 0: each nvcc optimises its kernels on every core (the
# flash sources hold many instances; the code is the same)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0")
HOPPER = (9, 0)

_LIBS: dict[str, ctypes.CDLL] = {}


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on: cuda, cpu, or meta for the dry
    run.  Asking for CUDA where there is none raises: an entry point
    never quietly drops to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda."
                           f"is_available() is False")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be cuda, cpu or meta, got {dev}")
    return dev


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's path: a CUDA tensor, or a ``meta``
    one in the dry run."""
    return t.is_cuda or t.is_meta


def on_hopper(device: torch.device | None = None) -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(device) == HOPPER)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, str]:
    """Compile the named kernels (all ``csrc/*.cu`` if none are named), one
    ``nvcc`` per source, all started together.  Returns each kernel's
    compiler log (``-Xptxas -v``: registers, shared memory, spills); an
    already built library returns an empty log."""
    names = names or tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def sass(name: str) -> str:
    """The SASS of kernel library ``name``, built first, as ``cuobjdump
    -sass`` from the toolkit beside ``nvcc`` prints it."""
    build(name)
    return subprocess.run(
        [str(Path(_nvcc()).parent / "cuobjdump"), "-sass",
         str(_target(name))], capture_output=True, text=True,
        check=True).stdout


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        if not on_hopper():
            raise RuntimeError(f"kernel {name} is compiled for sm_90a and "
                               f"needs a Hopper card (capability {HOPPER})")
        build(name)
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
