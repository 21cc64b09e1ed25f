"""PyTorch/CUDA port of ``repro`` for the NVIDIA H100.

The JAX package ``repro`` stays the reference; this package uses its
subpackage and function names so each module's counterpart is easy to
find, and imports neither JAX nor anything of ``repro``.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""
