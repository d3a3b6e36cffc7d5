"""The port's persistent build cache (counterpart of
``srt_tpu/utils/cache.py``).

The JAX package caches compiled XLA executables on disk. What the port
compiles is its hand-written code: ``nvcc``'s kernel library
(:mod:`srt_tpu_torch.kernels.build`) and ``g++``'s BVH builder
(:mod:`srt_tpu_torch.native`). Each lands in the directory named here,
under a file name that hashes its sources and flags, so a later process
loads it instead of compiling. The default is ``build/srt_tpu_torch/`` in
the repository, a directory git ignores.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "srt_tpu_torch")

_dir = DEFAULT_DIR


def enable(cache_dir: str | None = None) -> str:
    """Build and load the compiled code under ``cache_dir``
    (:data:`DEFAULT_DIR` when None) from now on; returns the directory. A
    library already loaded stays loaded."""
    global _dir
    _dir = os.path.abspath(cache_dir) if cache_dir else DEFAULT_DIR
    return _dir


def build_dir() -> str:
    """The directory the compiled code is built into and loaded from."""
    return _dir
