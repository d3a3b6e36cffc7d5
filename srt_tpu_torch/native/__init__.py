"""The native BVH builder (``bvh_builder.cpp``), compiled at first use and
loaded with ``ctypes``.

``g++ -O3 -std=c++17 -shared -fPIC`` builds the source into ``native/``
under the cache directory (:func:`srt_tpu_torch.utils.cache.build_dir`,
by default ``build/srt_tpu_torch/`` in the repository, which git ignores),
under a file name that carries a hash of the source and the
flags, so an edit rebuilds. A failed compile raises with the compiler's
output: the caller never falls back to the numpy builder, which takes
minutes at mesh scale.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

from srt_tpu_torch.utils import cache

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "bvh_builder.cpp")
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(cache.build_dir(), "native",
                        f"libsrt_bvh_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the builder if this hash has no library yet; returns its
    path. Raises with g++'s output if the compile fails."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True,
                                  timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError("the native BVH builder needs g++") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)      # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded builder with ``srt_build_bvh`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.srt_build_bvh.restype = ctypes.c_int64
            lib.srt_build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
            _lib = lib
    return _lib
