"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``srt_tpu_torch/csrc/*.cu`` for ``sm_90a`` into an
object, all sources at once in parallel, and links them into one shared
library with a plain C interface, at first use, under the cache directory
(:func:`srt_tpu_torch.utils.cache.build_dir`, by default
``build/srt_tpu_torch/`` in the repository, a directory git ignores). The
file name carries a hash of the sources, the headers (``csrc/*.cuh``) and
the flags, so an edit to any of them rebuilds. The library is loaded with
``ctypes``; every pointer and the stream are ``c_void_p``.

Flags: no ``--use_fast_math`` (approximate ``expf``/``sqrtf``/division
would flip near-tie branches against the plain PyTorch version), and
``--fmad=false`` so products and sums round one operation at a time, as
the plain version's separate tensor operations do.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from srt_tpu_torch.utils import cache

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
HEADERS = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: C entry points, each ``int f(const Args*, cudaStream_t)`` returning the
#: launch's cudaError_t
ENTRY_POINTS = ("srt_regen_bounce", "srt_bounce", "srt_bounce_bwd",
                "srt_intersect_tris", "srt_intersect_big",
                "srt_sphere_winner", "srt_film_sum", "srt_segment_sum")

_LIB = None


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(cache.build_dir(),
                        f"libsrt_tpu_torch_{h.hexdigest()[:16]}.so")


def _report_path() -> str:
    return library_path()[:-3] + ".ptxas.txt"


def ptxas_report() -> str:
    """nvcc's ``-Xptxas -v`` output (registers, spills) for the build."""
    with open(_report_path()) as f:
        return f.read()


def build() -> str:
    """Compile the sources if this hash has no library yet; returns its
    path. Raises with nvcc's output if a compile or the link fails."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    work = tempfile.mkdtemp(dir=os.path.dirname(path))
    try:
        nvcc = _nvcc()
        objs = [os.path.join(work, os.path.basename(s)[:-3] + ".o")
                for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        report, failed = [], []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            report.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(report))
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n"
                               f"{link.stderr}")
        with open(_report_path(), "w") as f:
            f.write("\n".join(report))
        os.replace(tmp, path)      # atomic: concurrent builders agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path


def load_library() -> ctypes.CDLL:
    """The built library with its C entry points declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.srt_film_sum_words.argtypes = [ctypes.c_int]
        lib.srt_film_sum_words.restype = ctypes.c_int
        lib.srt_film_sum_slots.argtypes = []
        lib.srt_film_sum_slots.restype = ctypes.c_int
        lib.srt_film_sum_tile.argtypes = []
        lib.srt_film_sum_tile.restype = ctypes.c_int
        lib.srt_bounce_bwd_scratch.argtypes = []
        lib.srt_bounce_bwd_scratch.restype = ctypes.c_int
        lib.srt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.srt_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(name: str, args: ctypes.Structure, device) -> None:
    """Call entry point ``name`` with ``args`` on ``device``'s current
    stream; raises if the launch is refused."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(ctypes.addressof(args), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.srt_cuda_error_string(err).decode()}")
